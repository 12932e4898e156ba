"""The port's hand-written CUDA kernels: build, ctypes binding, wrappers,
plain PyTorch versions and launch counts.

K1 ``group_plane_sums`` (csrc/group_plane_sums.cu), K2 ``group_minmax``
(csrc/group_minmax.cu), K3 ``hll_register_max``
(csrc/hll_register_max.cu) and K4 ``fused_filter_agg``
(csrc/fused_filter_agg.cu) are compiled with ``nvcc`` for ``sm_90a``
into one shared library each, with a plain C interface, under
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

from pinot_tpu_torch.ops.blockskip import gather_blocks

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = {
    "group_plane_sums": "group_plane_sums.cu",
    "group_minmax": "group_minmax.cu",
    "hll_register_max": "hll_register_max.cu",
    "fused_filter_agg": "fused_filter_agg.cu",
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

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {  # the C signatures at the end of each csrc/*.cu
    "group_plane_sums": [_vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp, _vp],
    "group_minmax": [_vp, _vp, _i64, _i32, _i32, _i32, ctypes.c_int32,
                     ctypes.c_int32, _vp, _vp, _vp],
    "hll_register_max": [_vp, _vp, _i64, _i32, _i32, _vp, _vp],
    "fused_filter_agg": [_vp, _vp, _i32, _i32, _vp, _vp, _vp, _vp],
}


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
            fn.argtypes = _ARGTYPES[name]
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


def count_entry(table: dict, entry: str, kernel: str, fn, *args, **kwargs):
    """Call ``fn`` and add to ``table[entry]`` the launches of ``kernel``
    it made: the per-entry counts of ops/group_scatter.py and
    ops/groupby_mm.py, which tell apart the TPU kernels one CUDA kernel
    replaces. CPU calls launch nothing and so count nothing."""
    before = launches[kernel]
    out = fn(*args, **kwargs)
    table[entry] += launches[kernel] - before
    return out


# ---------------------------------------------------------------------------
# K3: HLL register max
# ---------------------------------------------------------------------------

HLL_SPAN = SMEM_BYTES // 4   # slots per partition: int32 registers


def hll_partitions(nslots: int, span: int | None = None) -> int:
    span = min(span or HLL_SPAN, HLL_SPAN)
    return max(1, -(-nslots // span))


def hll_register_max_plain(slot, rho, nslots: int):
    """Plain version of K3: (nslots,) int32 per-slot max of rho over rows
    whose slot lies in [0, nslots), 0 where no row lands."""
    s = slot.reshape(-1).to(torch.int64)
    s = torch.where((s >= 0) & (s < nslots), s, nslots)
    out = torch.zeros(nslots + 1, dtype=torch.int32, device=rho.device)
    out.scatter_reduce_(0, s, rho.reshape(-1).to(torch.int32), reduce="amax",
                        include_self=True)
    return out[:nslots]


def hll_register_max(slot, rho, nslots: int, span: int | None = None):
    """K3. slot: (n,) int32, slot ``nslots`` = overflow; rho: (n,) int32
    in [1, 33 - log2m] (0 on padding adds nothing). ``span`` overrides the
    slots per partition (tests force several partitions). Returns
    (nslots,) int32 registers."""
    if slot.device.type == "cpu" and rho.device.type == "cpu":
        return hll_register_max_plain(slot, rho, nslots)
    _check_cuda("hll_register_max", slot, rho)
    if slot.dtype != torch.int32 or rho.dtype != torch.int32:
        raise TypeError("hll_register_max takes int32 slots and rho, got "
                        f"{slot.dtype} and {rho.dtype}")
    if slot.dim() != 1 or slot.shape != rho.shape:
        raise ValueError(f"hll_register_max shapes: slot {tuple(slot.shape)}, "
                         f"rho {tuple(rho.shape)}")
    out = torch.zeros(nslots, dtype=torch.int32, device=slot.device)
    n = slot.shape[0]
    if n and nslots:
        span = min(span or HLL_SPAN, HLL_SPAN)
        rc = _lib("hll_register_max").hll_register_max(
            slot.data_ptr(), rho.data_ptr(), n, nslots, span, out.data_ptr(),
            _stream(slot.device))
        _raise_on("hll_register_max", rc)
        launches["hll_register_max"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: fused filter + gather + aggregate over candidate blocks
# ---------------------------------------------------------------------------

# the filter program's opcodes, range flags and aggregate ops; the same
# numbers as csrc/fused_filter_agg.cu
OP_TRUE, OP_FALSE, OP_AND, OP_OR, OP_NOT, OP_IN, OP_RANGE = range(7)
RANGE_HAS_LO, RANGE_HAS_HI, RANGE_LO_INC, RANGE_HI_INC = 1, 2, 4, 8
AGG_OPS = {"sum": 0, "min": 1, "max": 2}

# the bounds of the descriptor K4 takes by value; ops/group_scatter.py
# plans past them take the generic gather branch
FUSED_MAX_COLS = 8
FUSED_MAX_PROG = 32
FUSED_MAX_STACK = 32   # the program's bit stack is one uint32
FUSED_MAX_AGGS = 8
FUSED_MAX_LITS = 64

_FUSED_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.int8: 2,
                 torch.int16: 3, torch.int32: 4, torch.float32: 5}


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int32), ("col", ctypes.c_int32),
                ("a", ctypes.c_int32), ("b", ctypes.c_int32),
                ("flags", ctypes.c_int32)]


class _Agg(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int32), ("col", ctypes.c_int32),
                ("is_float", ctypes.c_int32), ("slot", ctypes.c_int32),
                ("fill", ctypes.c_int32)]


class _FusedDesc(ctypes.Structure):
    """struct FusedDesc of csrc/fused_filter_agg.cu, field for field."""
    _fields_ = [("cols", ctypes.c_void_p * FUSED_MAX_COLS),
                ("dtypes", ctypes.c_int32 * FUSED_MAX_COLS),
                ("lits", ctypes.c_void_p),
                ("n_cols", ctypes.c_int32), ("n_prog", ctypes.c_int32),
                ("n_aggs", ctypes.c_int32), ("n_lits", ctypes.c_int32),
                ("ki", ctypes.c_int32), ("kf", ctypes.c_int32),
                ("prog", _Instr * FUSED_MAX_PROG),
                ("aggs", _Agg * FUSED_MAX_AGGS)]


def fused_filter_agg_plain(cand, rows_in, cols, lits, prog, aggs,
                           ki: int, kf: int):
    """Plain version of K4, over the same lowered program: gather the
    candidates' rows with ``index_select``, run the postfix filter as
    torch ops, mask rows past ``rows_in``, reduce per candidate (int32
    sums, min/max on K2's order keys). Returns (ints (B, ki) int32, flts
    (B, kf) float32 or None)."""
    B = cand.shape[0]
    R = cols[0].shape[1]
    dev = cand.device
    # candidate rows widened to int32 (float32 stays), as K4 loads them
    vals = []
    for c in cols:
        rows = gather_blocks(c, cand, 1, R)
        vals.append(rows if rows.dtype == torch.float32
                    else rows.to(torch.int32))
    stack = []
    for op, col, a, b, flags in prog:
        if op in (OP_TRUE, OP_FALSE):
            stack.append(torch.full((B, R), op == OP_TRUE, device=dev))
        elif op in (OP_AND, OP_OR):
            y, x = stack.pop(), stack.pop()
            stack.append((x & y) if op == OP_AND else (x | y))
        elif op == OP_NOT:
            stack.append(~stack.pop())
        elif op == OP_IN:
            v = vals[col]
            m = torch.zeros((B, R), dtype=torch.bool, device=dev)
            for k in range(b):
                m |= v == lits[a + k]
            stack.append(m)
        else:  # OP_RANGE
            v = vals[col]
            m = torch.ones((B, R), dtype=torch.bool, device=dev)
            if flags & RANGE_HAS_LO:
                m &= (v >= lits[a]) if flags & RANGE_LO_INC else (v > lits[a])
            if flags & RANGE_HAS_HI:
                m &= (v <= lits[b]) if flags & RANGE_HI_INC else (v < lits[b])
            stack.append(m)
    rowid = torch.arange(R, dtype=torch.int32, device=dev)
    mask = stack.pop() & (rowid[None, :] < rows_in[:, None])
    ints = torch.zeros((B, ki), dtype=torch.int32, device=dev)
    flts = torch.zeros((B, kf), dtype=torch.float32, device=dev) \
        if kf else None
    ints[:, 0] = mask.sum(dim=1, dtype=torch.int32)
    for op, col, is_float, slot, fill in aggs:
        v = vals[col]
        if op == AGG_OPS["sum"]:
            ints[:, slot] = torch.where(mask, v, 0).sum(dim=1,
                                                        dtype=torch.int32)
            continue
        dt = torch.float32 if is_float else torch.int32
        keys = torch.where(mask, _order_keys(v), _fill_key(fill, dt))
        red = keys.amin(dim=1) if op == AGG_OPS["min"] else keys.amax(dim=1)
        if is_float:
            flts[:, slot] = _from_keys(red, dt)
        else:
            ints[:, slot] = red
    return ints, flts


def fused_filter_agg(cand, rows_in, cols, lits, prog, aggs, ki: int,
                     kf: int):
    """K4. cand, rows_in: (B,) int32 candidate block ids and their valid
    rows (0 on padding candidates); cols: (NBLK, R) planes of uint8 /
    uint16 / int8 / int16 / int32 / float32; lits: (P,) int32 literal
    table; prog: postfix (op, col, a, b, flags) instructions; aggs: (op,
    col, is_float, slot, fill). Returns (ints (B, ki) int32, flts (B, kf)
    float32 or None): matched rows in int slot 0, each aggregate in its
    slot, zeros in unused slots."""
    if cand.device.type == "cpu":
        return fused_filter_agg_plain(cand, rows_in, cols, lits, prog, aggs,
                                      ki, kf)
    _check_cuda("fused_filter_agg", cand, rows_in, lits, *cols)
    if cand.dtype != torch.int32 or rows_in.dtype != torch.int32 \
            or lits.dtype != torch.int32:
        raise TypeError("fused_filter_agg takes int32 candidates, rows and "
                        "literals")
    if any(c.dtype not in _FUSED_DTYPES for c in cols):
        raise TypeError("fused_filter_agg planes: "
                        f"{[str(c.dtype) for c in cols]}")
    R = cols[0].shape[1] if cols else 0
    if cand.dim() != 1 or rows_in.shape != cand.shape \
            or any(c.dim() != 2 or c.shape[1] != R for c in cols):
        raise ValueError("fused_filter_agg shapes: cand "
                         f"{tuple(cand.shape)}, rows {tuple(rows_in.shape)},"
                         f" planes {[tuple(c.shape) for c in cols]}")
    if not cols or len(cols) > FUSED_MAX_COLS or len(prog) > FUSED_MAX_PROG \
            or len(aggs) > FUSED_MAX_AGGS or lits.numel() > FUSED_MAX_LITS:
        raise ValueError("fused_filter_agg program past the descriptor's "
                         "bounds")
    desc = _FusedDesc()
    for j, c in enumerate(cols):
        desc.cols[j] = c.data_ptr()
        desc.dtypes[j] = _FUSED_DTYPES[c.dtype]
    # an empty literal table still needs a valid pointer
    lit_buf = lits if lits.numel() else torch.zeros(1, dtype=torch.int32,
                                                    device=cand.device)
    desc.lits = lit_buf.data_ptr()
    desc.n_cols, desc.n_prog, desc.n_aggs = len(cols), len(prog), len(aggs)
    desc.n_lits, desc.ki, desc.kf = lits.numel(), ki, kf
    for j, ins in enumerate(prog):
        desc.prog[j] = _Instr(*ins)
    for j, (op, col, is_float, slot, fill) in enumerate(aggs):
        dt = torch.float32 if is_float else torch.int32
        fk = 0 if op == AGG_OPS["sum"] else _fill_key(fill, dt)
        desc.aggs[j] = _Agg(op, col, int(is_float), slot, fk)
    B = cand.shape[0]
    ints = torch.zeros((B, ki), dtype=torch.int32, device=cand.device)
    flts = torch.zeros((B, kf), dtype=torch.float32, device=cand.device) \
        if kf else None
    if B:
        rc = _lib("fused_filter_agg").fused_filter_agg(
            cand.data_ptr(), rows_in.data_ptr(), B, R, ctypes.addressof(desc),
            ints.data_ptr(), flts.data_ptr() if kf else None,
            _stream(cand.device))
        _raise_on("fused_filter_agg", rc)
        launches["fused_filter_agg"] += 1
    return ints, flts
