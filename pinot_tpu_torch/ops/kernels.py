"""The port's hand-written CUDA kernels: build, ctypes binding, wrappers,
plain PyTorch versions and launch counts.

K1 ``group_plane_sums`` (csrc/group_plane_sums.cu) and K2
``group_minmax`` (csrc/group_minmax.cu) are compiled with ``nvcc`` for
``sm_90a`` into one shared library each, with a plain C interface, under
``pinot_tpu_torch/_build/`` at first use — one ``nvcc`` process per
source, all started together — and bound with ``ctypes``. Nothing is
built when the module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch, launches on the current CUDA stream, raises when the
launch reports an error, and adds one to ``launches[name]``. A wrapper
given CPU tensors runs the kernel's plain PyTorch version instead (the
CPU tests); given CUDA tensors it launches the kernel or raises. The
plain versions are also what ``chip_smoke.py`` holds the kernels to on
the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = {
    "group_plane_sums": "group_plane_sums.cu",
    "group_minmax": "group_minmax.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# dynamic shared memory a block may take (of the H100's 227 KB per block)
SMEM_BYTES = 200 * 1024

# launches per kernel, counted where the wrapper launches it and nowhere
# else (chip_smoke.py zeroes them before driving the main path)
launches = {name: 0 for name in SOURCES}

_libs: dict = {}
_lock = threading.Lock()


# ---------------------------------------------------------------------------
# build + binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> float:
    """Compile every kernel library not built yet, one ``nvcc`` per source
    started together; returns the seconds spent. Raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src in SOURCES.items():
        dst = _lib_path(name)
        if os.path.exists(dst):
            continue
        tmp = f"{dst}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs.append((name, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, dst, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            fn = getattr(lib, name)
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            if name == "group_plane_sums":
                fn.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp]
            else:
                fn.argtypes = [vp, vp, i64, i32, i32, i32, ctypes.c_int32,
                               ctypes.c_int32, vp, vp, vp]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# K1: group plane sums
# ---------------------------------------------------------------------------


def plane_span(n_channels: int) -> int:
    """Groups per partition: the partition's f32 accumulators for every
    channel fit SMEM_BYTES."""
    return SMEM_BYTES // (4 * n_channels)


def group_plane_sums_plain(gid, channels, num_groups: int,
                           first_channel_ones: bool = False):
    """Plain version of K1: (A, num_groups) f64 sums of the channels over
    rows whose id lies in [0, num_groups), exact in f64."""
    g = gid.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    ch = channels.to(torch.float64, copy=True)
    if first_channel_ones:
        ch[0] = 1.0
    out = torch.zeros((channels.shape[0], num_groups + 1),
                      dtype=torch.float64, device=channels.device)
    out.index_add_(1, g, ch)
    return out[:, :num_groups]


def group_plane_sums(gid, channels, num_groups: int,
                     first_channel_ones: bool = False,
                     span: int | None = None):
    """K1. gid: (n,) int32, id ``num_groups`` = overflow slot; channels:
    (A, n) bf16; ``first_channel_ones``: channels[0] is all ones and is
    not read. ``span`` overrides the groups per partition (tests force
    several partitions). Returns (A, num_groups) float64."""
    if gid.device.type == "cpu" and channels.device.type == "cpu":
        return group_plane_sums_plain(gid, channels, num_groups,
                                      first_channel_ones)
    _check_cuda("group_plane_sums", gid, channels)
    if gid.dtype != torch.int32 or channels.dtype != torch.bfloat16:
        raise TypeError("group_plane_sums takes int32 ids and bf16 channels, "
                        f"got {gid.dtype} and {channels.dtype}")
    if channels.dim() != 2 or gid.shape != (channels.shape[1],):
        raise ValueError(f"group_plane_sums shapes: gid {tuple(gid.shape)}, "
                         f"channels {tuple(channels.shape)}")
    A, n = channels.shape
    out = torch.zeros((A, num_groups), dtype=torch.float64,
                      device=channels.device)
    if n == 0 or num_groups == 0 or A == 0:
        return out
    span = min(span or plane_span(A), plane_span(A))
    rc = _lib("group_plane_sums").group_plane_sums(
        gid.data_ptr(), channels.data_ptr(), n, A, num_groups,
        int(first_channel_ones), span, out.data_ptr(), _stream(gid.device))
    _raise_on("group_plane_sums", rc)
    launches["group_plane_sums"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: group min/max
# ---------------------------------------------------------------------------

MINMAX_SPAN = SMEM_BYTES // 8   # groups per partition: int32 min + max


def _order_keys(v):
    """int32 keys whose signed order is the float order of ``v``'s bits
    (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN); the map is its
    own inverse. Integer values are their own keys."""
    if not v.is_floating_point():
        return v
    b = v.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _from_keys(k, dtype):
    if not dtype.is_floating_point:
        return k
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _fill_key(fill, dtype) -> int:
    if dtype.is_floating_point:
        b = int(np.array(fill, dtype=np.float32).view(np.int32))
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    return int(fill)


def _default_fills(ops, dtype):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return tuple(info.max if op == "min" else info.min for op in ops)


def group_minmax_plain(gid, values, num_groups: int, ops: tuple,
                       fills: tuple | None = None):
    """Plain version of K2: per-op (num_groups,) min/max over rows whose id
    lies in [0, num_groups), seeded with the fills, on the same order
    keys as the kernel."""
    fills = fills or _default_fills(ops, values.dtype)
    g = gid.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    keys = _order_keys(values.reshape(-1))
    res = []
    for op, fill in zip(ops, fills):
        out = torch.full((num_groups + 1,), _fill_key(fill, values.dtype),
                         dtype=torch.int32, device=values.device)
        out.scatter_reduce_(0, g, keys, reduce="amin" if op == "min"
                            else "amax", include_self=True)
        res.append(_from_keys(out[:num_groups], values.dtype))
    return tuple(res)


def group_minmax(gid, values, num_groups: int, ops: tuple,
                 fills: tuple | None = None):
    """K2. gid: (n,) int32; values: (n,) int32 or float32; ``ops`` ⊆
    ("min", "max"); ``fills``: per-op empty-group fill (default: the
    dtype's extremes). Returns one (num_groups,) tensor per op in the
    values' dtype."""
    if gid.device.type == "cpu" and values.device.type == "cpu":
        return group_minmax_plain(gid, values, num_groups, ops, fills)
    _check_cuda("group_minmax", gid, values)
    if gid.dtype != torch.int32 or values.dtype not in (torch.int32,
                                                        torch.float32):
        raise TypeError("group_minmax takes int32 ids and int32/float32 "
                        f"values, got {gid.dtype} and {values.dtype}")
    if values.dim() != 1 or gid.shape != values.shape:
        raise ValueError(f"group_minmax shapes: gid {tuple(gid.shape)}, "
                         f"values {tuple(values.shape)}")
    if not set(ops) <= {"min", "max"} or not ops:
        raise ValueError(f"group_minmax ops {ops}")
    fills = fills or _default_fills(ops, values.dtype)
    keyed = {op: _fill_key(f, values.dtype) for op, f in zip(ops, fills)}
    outs = {op: torch.full((num_groups,), k, dtype=torch.int32,
                           device=values.device) for op, k in keyed.items()}
    n = values.shape[0]
    if n and num_groups:
        rc = _lib("group_minmax").group_minmax(
            gid.data_ptr(), values.data_ptr(), n, num_groups, MINMAX_SPAN,
            int(values.is_floating_point()), keyed.get("min", 0),
            keyed.get("max", 0),
            outs["min"].data_ptr() if "min" in outs else None,
            outs["max"].data_ptr() if "max" in outs else None,
            _stream(gid.device))
        _raise_on("group_minmax", rc)
        launches["group_minmax"] += 1
    return tuple(_from_keys(outs[op], values.dtype) for op in ops)
