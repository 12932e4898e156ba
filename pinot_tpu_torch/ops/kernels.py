"""The port's hand-written CUDA kernels: build, ctypes binding, wrappers,
plain PyTorch versions and launch counts.

K1 ``group_plane_sums`` (csrc/group_plane_sums.cu), K2 ``group_minmax``
(csrc/group_minmax.cu), K3 ``hll_register_max``
(csrc/hll_register_max.cu), K4 ``fused_filter_agg``
(csrc/fused_filter_agg.cu) and the port-only K5 ``cluster_sums``
(csrc/cluster_sums.cu, the t-digest build's ordered sums) are compiled with ``nvcc`` for ``sm_90a``
into one shared library each, with a plain C interface, under
``pinot_tpu_torch/_build/`` at first use — one ``nvcc`` process per
source, all started together — and bound with ``ctypes``. Nothing is
built when the module is imported.

K1-K4 each have a second entry over a leading member axis
(``*_members``): M queries of one template at once, the cohort of
coalesced launches (engine/cohort.py), one launch for all of them. Its
plain version is the solo plain version once per member.

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
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops.blockskip import gather_blocks
from pinot_tpu_torch.ops.hll import hll_slots

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

SOURCES = {
    "group_plane_sums": "group_plane_sums.cu",
    "group_minmax": "group_minmax.cu",
    "hll_register_max": "hll_register_max.cu",
    "fused_filter_agg": "fused_filter_agg.cu",
    "cluster_sums": "cluster_sums.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the compiler's output of each library this process built: with
# -Xptxas -v, every kernel's registers, shared memory and spills
build_log: dict = {}

# the member-axis entries, by the library (source) that holds each
MEMBER_ENTRIES = {
    "group_plane_sums_members": "group_plane_sums",
    "group_minmax_members": "group_minmax",
    "hll_register_max_members": "hll_register_max",
    "fused_filter_agg_members": "fused_filter_agg",
}

# launches per kernel entry, counted where the wrapper launches it and
# nowhere else (chip_smoke.py zeroes them before driving the main path)
launches = {name: 0 for name in (*SOURCES, *MEMBER_ENTRIES)}

# every C entry beside a library's own, by its library: the member-axis
# entries, K5's scratch size and the DADD latency micro (kernel_ab.py)
ENTRY_LIBS = {**MEMBER_ENTRIES, "cluster_sums_scratch": "cluster_sums",
              "dadd_chain": "cluster_sums"}

_libs: dict = {}
_lock = threading.Lock()

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {  # the C signatures at the end of each csrc/*.cu
    "group_plane_sums": [_vp, _vp, _i64, _i32, _i32, _i64, _i32, _vp, _vp],
    "group_minmax": [_vp, _vp, _i64, _i32, _i32, _i32, _vp],
    "hll_register_max": [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp, _vp],
    "fused_filter_agg": [_vp, _vp, _i32, _i32, _vp, _vp, _vp, _vp],
    "cluster_sums": [_vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp],
    "cluster_sums_scratch": [_i64, _i64],
    "dadd_chain": [_vp, _i64, _vp, _vp],
    "group_plane_sums_members": [_vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32,
                                 _i64, _i32, _vp, _vp],
    "group_minmax_members": [_vp, _vp, _vp, _i64, _i32, _i64, _i32, _i32,
                             _i32, _i64, _vp],
    "hll_register_max_members": [_vp, _vp, _vp, _i64, _i32, _i64, _i64, _i64,
                                 _i32, _i32, _i32, _vp, _vp],
    "fused_filter_agg_members": [_vp, _vp, _i32, _i32, _i32, _vp, _i64, _vp,
                                 _vp, _vp],
}
_RESTYPES = {"cluster_sums_scratch": ctypes.c_int64}  # else a cudaError_t


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
        build_log[name] = out.decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{name}:\n{build_log[name]}")
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(name: str):
    """The library of ``name`` (a source, or a member-axis entry of one),
    built and loaded at first use, its entry points typed."""
    src = ENTRY_LIBS.get(name, name)
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            path = _lib_path(src)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fname in (src, *(e for e, s in ENTRY_LIBS.items()
                                 if s == src)):
                fn = getattr(lib, fname)
                fn.argtypes = _ARGTYPES[fname]
                fn.restype = _RESTYPES.get(fname, ctypes.c_int)
            _libs[src] = lib
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

# shared memory a block of K1 or K3 (one 1024-thread block per SM) may
# take for its accumulators: K1's wide float shape (G = 6240, count + 2
# byte planes in int32, 3 float planes in f64: 36 bytes a group) fits one
# partition, K3 57,344 int32 registers
PERSISTENT_SMEM_BYTES = 224 * 1024
K1_MAX_SOURCES = 15          # the reference's MAX_CHANNELS
K1_MAX_ROWS = 16             # output rows: count + 15 channels
INT32_MAX = (1 << 31) - 1

# stored dtypes K1 reads, by the codes of csrc/group_plane_sums.cu
K1_INT_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.int8: 2,
                 torch.int16: 3, torch.int32: 4, torch.int64: 5,
                 torch.uint32: 8}
_K1_F32, _K1_BF16 = 6, 7
_K1_KINDS = {"int": 0, "float": 1, "bf16": 2}


@dataclasses.dataclass(frozen=True)
class PlaneSource:
    """One value source of K1.

    values: the plane as stored (flat or (S, R), read flat) or an
    evaluated expression. kind "int": ``values + plus - minus`` in int64
    split into ``nplanes`` byte planes; "float": f32 values split exactly
    into three bf16 planes; "bf16": one bf16 channel as it is. plus: the
    plane's frame-of-reference offset (0-d int32 / int64 tensor) or None;
    minus: the query's offset (0-d int64 tensor) or None. Both stay on the
    card: the kernel reads them, so no query syncs for them."""

    values: torch.Tensor
    kind: str
    nplanes: int = 1
    plus: torch.Tensor | None = None
    minus: torch.Tensor | None = None

    def __post_init__(self):
        if self.kind not in _K1_KINDS:
            raise ValueError(f"PlaneSource kind {self.kind!r}")
        if self.kind != "int":  # float: three planes; bf16: one channel
            object.__setattr__(self, "nplanes", 3 if self.kind == "float"
                               else 1)


def int_planes(values, offset, nplanes: int):
    """values - offset split into ``nplanes`` byte planes (bf16-exact)."""
    v = values.to(torch.int64) - offset
    return [((v >> (8 * k)) & 0xFF).to(torch.bfloat16) for k in range(nplanes)]


def _bf16_hi(v):
    """Top-16-bit truncation of f32 — exactly bf16-representable, built
    by bit-masking so no rounding step can fold it away."""
    return (v.view(torch.int32) & -65536).view(torch.float32)


def float_planes(values):
    """f32 → 3 bf16 channels summing exactly to the f32 value."""
    v = values.to(torch.float32)
    m0 = _bf16_hi(v)
    r1 = v - m0
    m1 = _bf16_hi(r1)
    r2 = r1 - m1
    m2 = _bf16_hi(r2)
    return [m0.to(torch.bfloat16), m1.to(torch.bfloat16),
            m2.to(torch.bfloat16)]


def source_channels(src: PlaneSource):
    """The bf16 channels a source stands for, built as torch ops: the
    composition K1 does in registers (decode as engine/device.py
    ``_data_col`` does, then ``int_planes`` / ``float_planes``)."""
    v = src.values.reshape(-1)
    if src.kind == "bf16":
        return [v.to(torch.bfloat16)]
    if src.kind == "float":
        return float_planes(v)
    v = v.to(torch.int64)
    if src.plus is not None:
        v = v + src.plus.to(torch.int64)
    return int_planes(v, 0 if src.minus is None else src.minus, src.nplanes)


def plane_layout(sources, count: bool):
    """K1's accumulator layout: per output row, (region, row in region),
    region "int" (int32 cells: the count and byte planes) or "flt" (f64
    cells: float planes and bf16 channels); output rows are the count,
    then each source's planes in order."""
    rows = [("int", 0)] if count else []
    n_int, n_flt = len(rows), 0
    for s in sources:
        for _ in range(s.nplanes):
            if s.kind == "int":
                rows.append(("int", n_int))
                n_int += 1
            else:
                rows.append(("flt", n_flt))
                n_flt += 1
    return rows


def flush_rows(sources) -> int:
    """The most rows a K1 block adds before it flushes: every int32 cell
    gains at most 255 a row (a byte plane; the count gains 1), so
    floor((2^31 - 1) / 255) = 8,421,504 rows keep each cell exact; a
    multiple of 4, the rows a thread takes at a time."""
    most = 255 if any(s.kind == "int" for s in sources) else 1
    return (INT32_MAX // most) // 4 * 4


def plane_span(n_int: int, n_flt: int) -> int:
    """Groups per partition: one copy of the partition's int32 and f64
    accumulators fits PERSISTENT_SMEM_BYTES."""
    return PERSISTENT_SMEM_BYTES // max(1, 4 * n_int + 8 * n_flt)


class _PlaneSource(ctypes.Structure):
    """struct Source of csrc/group_plane_sums.cu, field for field."""
    _fields_ = [("values", ctypes.c_void_p), ("plus", ctypes.c_void_p),
                ("minus", ctypes.c_void_p), ("dtype", ctypes.c_int32),
                ("kind", ctypes.c_int32), ("nplanes", ctypes.c_int32),
                ("plus_is64", ctypes.c_int32), ("row", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


class _PlaneSumsDesc(ctypes.Structure):
    """struct PlaneSumsDesc of csrc/group_plane_sums.cu, field for field."""
    _fields_ = [("src", _PlaneSource * K1_MAX_SOURCES),
                ("int_out", ctypes.c_int32 * K1_MAX_ROWS),
                ("flt_out", ctypes.c_int32 * K1_MAX_ROWS),
                ("n_src", ctypes.c_int32), ("count", ctypes.c_int32),
                ("n_int", ctypes.c_int32), ("n_flt", ctypes.c_int32)]


class _PlaneStrides(ctypes.Structure):
    """struct MemberStrides of csrc/group_plane_sums.cu: per source, the
    member stride of its values (elements) and of its query offset."""
    _fields_ = [("vstride", ctypes.c_int64 * K1_MAX_SOURCES),
                ("minus_mstride", ctypes.c_int32 * K1_MAX_SOURCES)]


def _k1_dtype(src: PlaneSource) -> int:
    dt = src.values.dtype
    if src.kind == "int" and dt in K1_INT_DTYPES:
        return K1_INT_DTYPES[dt]
    if src.kind == "float" and dt == torch.float32:
        return _K1_F32
    if src.kind == "bf16" and dt == torch.bfloat16:
        return _K1_BF16
    raise TypeError(f"group_plane_sums: a {src.kind} source of {dt}")


def lower_plane_sums(sources, count: bool) -> _PlaneSumsDesc:
    """The sources in K1's terms: the descriptor the kernel takes by
    value (pointers of the sources' tensors, dtype and kind codes, first
    accumulator row of each source in its region, and the output row of
    every accumulator row)."""
    if len(sources) > K1_MAX_SOURCES:
        raise ValueError(f"group_plane_sums takes at most {K1_MAX_SOURCES} "
                         f"sources, got {len(sources)}")
    layout = plane_layout(sources, count)
    if len(layout) > K1_MAX_ROWS:
        raise ValueError(f"group_plane_sums: {len(layout)} channels past "
                         f"{K1_MAX_ROWS}")
    desc = _PlaneSumsDesc()
    out_row = int(count)
    for j, s in enumerate(sources):
        region_row = layout[out_row][1]
        plus = s.plus
        if plus is not None and plus.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"group_plane_sums: FOR offset of {plus.dtype}")
        if s.minus is not None and s.minus.dtype != torch.int64:
            raise TypeError(f"group_plane_sums: offset of {s.minus.dtype}")
        desc.src[j] = _PlaneSource(
            s.values.data_ptr(), None if plus is None else plus.data_ptr(),
            None if s.minus is None else s.minus.data_ptr(), _k1_dtype(s),
            _K1_KINDS[s.kind], s.nplanes,
            int(plus is not None and plus.dtype == torch.int64), region_row,
            0)
        out_row += s.nplanes
    for a, (region, r) in enumerate(layout):
        (desc.int_out if region == "int" else desc.flt_out)[r] = a
    desc.n_src, desc.count = len(sources), int(count)
    desc.n_int = sum(1 for region, _ in layout if region == "int")
    desc.n_flt = len(layout) - desc.n_int
    return desc


def group_plane_sums_plain(gid, sources, num_groups: int,
                           count: bool = False):
    """Plain version of K1: the channels built as torch ops
    (``source_channels``), then (A, num_groups) f64 sums over rows whose
    id lies in [0, num_groups), exact in f64."""
    g = gid.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    chans = [torch.ones(g.shape[0], dtype=torch.bfloat16,
                        device=g.device)] if count else []
    for s in sources:
        chans += source_channels(s)
    out = torch.zeros((len(chans), num_groups + 1), dtype=torch.float64,
                      device=gid.device)
    if chans:
        out.index_add_(1, g, torch.stack(chans).to(torch.float64))
    return out[:, :num_groups]


def _aligned(t):
    """A flat view of ``t`` whose data starts on 16 bytes (the kernels'
    vector loads), copied only when it does not."""
    t = t.reshape(-1)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def group_plane_sums(gid, sources, num_groups: int, count: bool = False,
                     span: int | None = None, seg_rows: int | None = None):
    """K1. gid: (n,) int32, id ``num_groups`` = overflow slot; sources:
    PlaneSource values of n rows each; ``count``: output row 0 counts the
    rows. ``span`` overrides the groups per partition and ``seg_rows``
    the rows a block adds between flushes (tests force several).
    Returns (A, num_groups) float64: the count, then each source's
    planes."""
    offsets = [t for s in sources for t in (s.plus, s.minus) if t is not None]
    tensors = (gid, *(s.values for s in sources), *offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return group_plane_sums_plain(gid, sources, num_groups, count)
    _check_cuda("group_plane_sums", *tensors)
    if gid.dtype != torch.int32:
        raise TypeError(f"group_plane_sums takes int32 ids, got {gid.dtype}")
    n = gid.numel()
    if any(s.values.numel() != n for s in sources) \
            or any(t.numel() != 1 for t in offsets):
        raise ValueError(f"group_plane_sums shapes: gid {tuple(gid.shape)}, "
                         f"sources {[tuple(s.values.shape) for s in sources]}")
    sources = [dataclasses.replace(s, values=_aligned(s.values))
               for s in sources]
    gid = _aligned(gid)
    desc = lower_plane_sums(sources, count)
    A = desc.n_int + desc.n_flt
    out = torch.zeros((A, num_groups), dtype=torch.float64, device=gid.device)
    if n == 0 or num_groups == 0 or A == 0:
        return out
    full = plane_span(desc.n_int, desc.n_flt)
    span = min(span or full, full)
    seg = max(4, min(seg_rows or INT32_MAX, flush_rows(sources)) // 4 * 4)
    rc = _lib("group_plane_sums").group_plane_sums(
        gid.data_ptr(), ctypes.addressof(desc), n, num_groups, span, seg,
        PERSISTENT_SMEM_BYTES, out.data_ptr(), _stream(gid.device))
    _raise_on("group_plane_sums", rc)
    launches["group_plane_sums"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: group min/max
# ---------------------------------------------------------------------------

K2_MAX_SOURCES = 8
K2_MAX_CELLS = 2 * K2_MAX_SOURCES
K2_OPS = {"min": 0, "max": 1}

# stored dtypes K2 reads, and the dtypes of a FOR offset it reads, by the
# codes of csrc/group_minmax.cu
K2_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.int8: 2, torch.int16: 3,
             torch.int32: 4, torch.float32: 5}


@dataclasses.dataclass(frozen=True)
class MinMaxSource:
    """One value source of K2.

    values: the plane as stored (flat or (S, R), read flat) or an evaluated
    expression, of a dtype in ``K2_DTYPES``; plus: the plane's
    frame-of-reference offset (0-d tensor) or None, read by the kernel so
    no query syncs on it; dtype: the decoded dtype (the values widened,
    plus the offset, as engine/device.py ``_data_col`` decodes them: the
    result's dtype and the fills' space; default the values'); ops ⊆
    ("min", "max"); fills: per op, the empty-group value in the decoded
    dtype (default its extremes). The offset is not added to the fill."""

    values: torch.Tensor
    ops: tuple
    fills: tuple | None = None
    plus: torch.Tensor | None = None
    dtype: torch.dtype | None = None

    def __post_init__(self):
        if not self.ops or not set(self.ops) <= set(K2_OPS) \
                or len(set(self.ops)) != len(self.ops):
            raise ValueError(f"MinMaxSource ops {self.ops}")
        if self.dtype is None:
            object.__setattr__(self, "dtype", self.values.dtype)
        if self.fills is None:
            object.__setattr__(self, "fills",
                               _default_fills(self.ops, self.dtype))


def _order_keys(v, how: str | None = None):
    """int32 keys whose signed order is the float order of ``v``'s bits
    (-inf < ... < -0.0 < +0.0 < ... < +inf), a NaN of either sign the key
    that wins ``how`` ("min" / "max"): ``ops/agg.py float_keys``, the rule
    K2 and K4 compute in registers. Without ``how``, the bare map (its own
    inverse). Integer values are their own keys."""
    if not v.is_floating_point():
        return v
    return agg_ops.float_keys(v, how)


def _from_keys(k, dtype):
    if not dtype.is_floating_point:
        return k
    return agg_ops.from_float_keys(k, torch.float32)


def _fill_key(fill, dtype) -> int:
    if dtype.is_floating_point:
        return int(agg_ops.float_keys(torch.tensor(fill, dtype=torch.float32)))
    return int(fill)


def _default_fills(ops, dtype):
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    return tuple(info.max if op == "min" else info.min for op in ops)


def minmax_decode(src: MinMaxSource):
    """The values a source stands for, built as torch ops: the widening
    and FOR add K2 does in registers (engine/device.py ``_data_col``)."""
    v = src.values.reshape(-1)
    if v.dtype != src.dtype:
        v = v.to(src.dtype)
    if src.plus is not None:
        v = v + src.plus
    return v


def group_minmax_plain(gid, sources, num_groups: int):
    """Plain version of K2: per source, decode (``minmax_decode``), then
    per op a (num_groups,) ``scatter_reduce_`` over rows whose id lies in
    [0, num_groups), seeded with the fill, on the same int32 order keys as
    the kernel. Returns one tuple per source of one tensor per op in the
    source's decoded dtype."""
    g = gid.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    res = []
    for s in sources:
        v = minmax_decode(s)
        outs = []
        for op, fill in zip(s.ops, s.fills):
            out = torch.full((num_groups + 1,), _fill_key(fill, s.dtype),
                             dtype=torch.int32, device=v.device)
            out.scatter_reduce_(0, g, _order_keys(v, op).to(torch.int32),
                                reduce="a" + op, include_self=True)
            outs.append(_from_keys(out[:num_groups], s.dtype).to(s.dtype))
        res.append(tuple(outs))
    return tuple(res)


class _MinMaxSource(ctypes.Structure):
    """struct Source of csrc/group_minmax.cu, field for field."""
    _fields_ = [("values", ctypes.c_void_p), ("plus", ctypes.c_void_p),
                ("dtype", ctypes.c_int32), ("plus_dtype", ctypes.c_int32),
                ("cell", ctypes.c_int32 * 2)]


class _MinMaxDesc(ctypes.Structure):
    """struct MinMaxDesc of csrc/group_minmax.cu, field for field."""
    _fields_ = [("src", _MinMaxSource * K2_MAX_SOURCES),
                ("out", ctypes.c_void_p * K2_MAX_CELLS),
                ("fill", ctypes.c_int32 * K2_MAX_CELLS),
                ("op", ctypes.c_int32 * K2_MAX_CELLS),
                ("n_src", ctypes.c_int32), ("n_cells", ctypes.c_int32)]


class _MinMaxStrides(ctypes.Structure):
    """struct MemberStrides of csrc/group_minmax.cu: per source, the member
    stride of its values (elements)."""
    _fields_ = [("vstride", ctypes.c_int64 * K2_MAX_SOURCES)]


def minmax_cells(sources):
    """K2's accumulator cells in order: (source, op) for each source's ops."""
    return [(j, op) for j, s in enumerate(sources) for op in s.ops]


def lower_minmax(sources, outs) -> _MinMaxDesc:
    """The sources in K2's terms: the descriptor the kernel takes by value
    (pointers of each source's values and FOR offset, their dtype codes,
    each op's accumulator cell) and per cell its output pointer, fill key
    and op. ``outs``: one (G,) int32 tensor per cell."""
    if len(sources) > K2_MAX_SOURCES:
        raise ValueError(f"group_minmax takes at most {K2_MAX_SOURCES} "
                         f"sources, got {len(sources)}")
    desc = _MinMaxDesc()
    for c, (j, op) in enumerate(minmax_cells(sources)):
        s = sources[j]
        desc.src[j].cell[K2_OPS[op]] = c
        desc.out[c] = outs[c].data_ptr()
        desc.fill[c] = _fill_key(s.fills[s.ops.index(op)], s.dtype)
        desc.op[c] = K2_OPS[op]
    for j, s in enumerate(sources):
        if s.values.dtype not in K2_DTYPES:
            raise TypeError(f"group_minmax: values of {s.values.dtype}")
        if s.dtype.is_floating_point != (s.values.dtype == torch.float32) \
                or (s.dtype.is_floating_point and s.plus is not None):
            raise TypeError(f"group_minmax: {s.values.dtype} values decoded "
                            f"to {s.dtype}")
        if s.plus is not None and s.plus.dtype not in K2_DTYPES:
            raise TypeError(f"group_minmax: FOR offset of {s.plus.dtype}")
        src = desc.src[j]
        src.values = s.values.data_ptr()
        src.plus = None if s.plus is None else s.plus.data_ptr()
        src.dtype = K2_DTYPES[s.values.dtype]
        src.plus_dtype = 0 if s.plus is None else K2_DTYPES[s.plus.dtype]
        for op in K2_OPS:
            if op not in s.ops:
                src.cell[K2_OPS[op]] = -1
    desc.n_src, desc.n_cells = len(sources), len(minmax_cells(sources))
    return desc


def group_minmax_sources(gid, sources, num_groups: int,
                         span: int | None = None):
    """K2: one launch for every source. gid: (n,) int32, id ``num_groups``
    = overflow slot; sources: MinMaxSource values of n rows each (at most
    ``K2_MAX_SOURCES``). ``span`` overrides the groups per partition (tests
    force several). Returns one tuple per source of one (num_groups,)
    tensor per op, in the source's decoded dtype."""
    offsets = [s.plus for s in sources if s.plus is not None]
    tensors = (gid, *(s.values for s in sources), *offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return group_minmax_plain(gid, sources, num_groups)
    _check_cuda("group_minmax", *tensors)
    if gid.dtype != torch.int32:
        raise TypeError(f"group_minmax takes int32 ids, got {gid.dtype}")
    n = gid.numel()
    if not sources or any(s.values.numel() != n for s in sources) \
            or any(t.numel() != 1 for t in offsets):
        raise ValueError(f"group_minmax shapes: gid {tuple(gid.shape)}, "
                         f"sources {[tuple(s.values.shape) for s in sources]}")
    sources = [dataclasses.replace(s, values=_aligned(s.values))
               for s in sources]
    gid = _aligned(gid)
    cells = minmax_cells(sources)
    keys = torch.empty((len(cells), num_groups), dtype=torch.int32,
                       device=gid.device)
    desc = lower_minmax(sources, list(keys))
    if num_groups:
        full = PERSISTENT_SMEM_BYTES // (4 * len(cells))
        rc = _lib("group_minmax").group_minmax(
            gid.data_ptr(), ctypes.addressof(desc), n, num_groups,
            min(span or full, full), PERSISTENT_SMEM_BYTES,
            _stream(gid.device))
        _raise_on("group_minmax", rc)
        launches["group_minmax"] += 1
    res, c = [], 0
    for s in sources:
        res.append(tuple(_from_keys(keys[c + k], s.dtype).to(s.dtype)
                         for k in range(len(s.ops))))
        c += len(s.ops)
    return tuple(res)


def group_minmax(gid, values, num_groups: int, ops: tuple,
                 fills: tuple | None = None):
    """K2 over one source. gid: (n,) int32; values: (n,) of a dtype in
    ``K2_DTYPES``; ``ops`` ⊆ ("min", "max"); ``fills``: per-op empty-group
    fill (default: the dtype's extremes). Returns one (num_groups,) tensor
    per op in the values' dtype."""
    return group_minmax_sources(
        gid, [MinMaxSource(values.reshape(-1), tuple(ops), fills)],
        num_groups)[0]


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

HLL_SPAN = PERSISTENT_SMEM_BYTES // 4   # slots per partition: int32


def hll_partitions(nslots: int, span: int | None = None) -> int:
    span = min(span or HLL_SPAN, HLL_SPAN)
    return max(1, -(-nslots // span))


def hll_register_max_plain(h, log2m: int, num_groups: int = 1, gid=None,
                           mask=None):
    """Plain version of K3: ``hll_slots`` (ops/hll.py: ``hll_idx_rho``,
    then ``where``) and a scatter-max: (num_groups << log2m,) int32
    per-slot max of rho, 0 where no row lands."""
    nslots = num_groups << log2m
    slot, rho = hll_slots(h, log2m, num_groups, gid, mask)
    out = torch.zeros(nslots + 1, dtype=torch.int32, device=h.device)
    out.scatter_reduce_(0, slot.reshape(-1).to(torch.int64), rho.reshape(-1),
                        reduce="amax", include_self=True)
    return out[:nslots]


def hll_register_max(h, log2m: int, num_groups: int = 1, gid=None, mask=None,
                     span: int | None = None):
    """K3. h: int32 bit view of the 32-bit hashes (``hh::`` planes, read
    flat); gid: int32 group ids or None (one group); mask: bool or None
    (every row). A row counts when its mask is set and its id lies in
    [0, num_groups). ``span`` overrides the slots per partition (tests
    force several). Returns (num_groups << log2m,) int32 registers."""
    given = [t for t in (gid, mask) if t is not None]
    if all(t.device.type == "cpu" for t in (h, *given)):
        return hll_register_max_plain(h, log2m, num_groups, gid, mask)
    _check_cuda("hll_register_max", h, *given)
    if h.dtype != torch.int32 or (gid is not None and gid.dtype != torch.int32) \
            or (mask is not None and mask.dtype != torch.bool):
        raise TypeError("hll_register_max takes int32 hashes and ids and a "
                        f"bool mask, got {[t.dtype for t in (h, *given)]}")
    n = h.numel()
    if any(t.numel() != n for t in given):
        raise ValueError("hll_register_max shapes: "
                         f"{[tuple(t.shape) for t in (h, *given)]}")
    if not 4 <= log2m <= 16:
        raise ValueError(f"hll_register_max: log2m {log2m} outside [4, 16]")
    nslots = num_groups << log2m
    out = torch.zeros(nslots, dtype=torch.int32, device=h.device)
    if n and nslots:
        span = min(span or HLL_SPAN, HLL_SPAN)
        h, gid, mask = (None if t is None else _aligned(t)
                        for t in (h, gid, mask))
        rc = _lib("hll_register_max").hll_register_max(
            h.data_ptr(), None if gid is None else gid.data_ptr(),
            None if mask is None else mask.data_ptr(), n, log2m, num_groups,
            span, out.data_ptr(), _stream(h.device))
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
FUSED_MAX_STACK = 32   # levels of the program's mask stack
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
        how = "min" if op == AGG_OPS["min"] else "max"
        keys = torch.where(mask, _order_keys(v, how), _fill_key(fill, dt))
        red = keys.amin(dim=1) if how == "min" else keys.amax(dim=1)
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
    # whole 16-byte granules of every plane: copy a plane that starts
    # elsewhere (a view never does in the engine)
    cols = [c if c.data_ptr() % 16 == 0 else c.clone() for c in cols]
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


# ---------------------------------------------------------------------------
# member-axis entries of K1-K4: one launch for a cohort of M queries
# ---------------------------------------------------------------------------


def _member_view(t, M: int, n: int, name: str):
    """(flat view, member stride in elements) of a member-axis operand:
    ``n`` elements shared by every member (stride 0) or ``M * n``, member
    m's at m * n."""
    if t.numel() == n:
        return t.reshape(-1), 0
    if t.numel() == M * n:
        return t.reshape(-1), n
    raise ValueError(f"{name}: an operand of {tuple(t.shape)} for {M} "
                     f"members of {n} rows")


def _member_slice(t, m: int, M: int, n: int):
    """Member ``m``'s (n,) rows of a member-axis operand (shared or not)."""
    flat = t.reshape(-1)
    return flat if flat.numel() == n else flat[m * n:(m + 1) * n]


def _member_scalar(t, m: int):
    """Member ``m``'s 0-d value of a shared (1 element) or per-member (M,)
    offset tensor."""
    if t is None:
        return None
    flat = t.reshape(-1)
    return flat[0] if flat.numel() == 1 else flat[m]


def _member_aligned(t, stride: int):
    """``_aligned`` for a member-axis operand: every member's rows must
    start on 16 bytes too."""
    if t.data_ptr() % 16 == 0 and (stride * t.element_size()) % 16 == 0:
        return t, stride
    if stride == 0:
        return t.clone(), 0
    # pad each member's rows to a 16-byte multiple
    M = t.numel() // stride
    per = 16 // math.gcd(16, t.element_size())
    padded = -(-stride // per) * per
    out = torch.zeros((M, padded), dtype=t.dtype, device=t.device)
    out[:, :stride] = t.reshape(M, stride)
    return out.reshape(-1), padded


def group_plane_sums_members_plain(gid, sources, num_groups: int,
                                   count: bool = False):
    """Plain version of K1's member-axis entry: the solo plain version
    once per member. Returns (M, A, num_groups) float64."""
    M = gid.shape[0]
    n = gid[0].numel() if M else 0
    return torch.stack([group_plane_sums_plain(
        gid[m].reshape(-1),
        [dataclasses.replace(s, values=_member_slice(s.values, m, M, n),
                             minus=_member_scalar(s.minus, m))
         for s in sources], num_groups, count) for m in range(M)])


def group_plane_sums_members(gid, sources, num_groups: int,
                             count: bool = False, span: int | None = None,
                             seg_rows: int | None = None):
    """K1 over a leading member axis. gid: (M, n) int32, each member's own
    ids; sources: PlaneSource whose values are n elements shared by every
    member (a stored plane) or M * n (each member's own, member-major),
    whose ``plus`` is one 0-d offset and whose ``minus`` is 0-d (shared)
    or (M,) int64 (each member's). Returns (M, A, num_groups) float64,
    member m's rows those of the solo entry over its operands."""
    offsets = [t for s in sources for t in (s.plus, s.minus) if t is not None]
    tensors = (gid, *(s.values for s in sources), *offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return group_plane_sums_members_plain(gid, sources, num_groups, count)
    _check_cuda("group_plane_sums_members", *tensors)
    if gid.dtype != torch.int32 or gid.dim() < 1:
        raise TypeError("group_plane_sums_members takes (M, n) int32 ids, "
                        f"got {gid.dtype} {tuple(gid.shape)}")
    M = gid.shape[0]
    n = gid[0].numel() if M else 0
    g, gstride = _member_aligned(gid.reshape(-1), n)
    srcs, vstrides, mstrides = [], [], []
    for s in sources:
        v, vs = _member_view(s.values, M, n, "group_plane_sums_members")
        v, vs = _member_aligned(v, vs)
        if s.plus is not None and s.plus.numel() != 1:
            raise ValueError("group_plane_sums_members: one FOR offset")
        ms = 0
        if s.minus is not None:
            if s.minus.numel() not in (1, M):
                raise ValueError("group_plane_sums_members: offsets of "
                                 f"{tuple(s.minus.shape)} for {M} members")
            ms = int(s.minus.numel() == M and M > 1)
        srcs.append(dataclasses.replace(
            s, values=v, minus=None if s.minus is None
            else s.minus.reshape(-1).contiguous()))
        vstrides.append(vs)
        mstrides.append(ms)
    desc = lower_plane_sums(srcs, count)
    strides = _PlaneStrides()
    for j, (vs, ms) in enumerate(zip(vstrides, mstrides)):
        strides.vstride[j] = vs
        strides.minus_mstride[j] = ms
    A = desc.n_int + desc.n_flt
    out = torch.zeros((M, A, num_groups), dtype=torch.float64,
                      device=gid.device)
    if M == 0 or n == 0 or num_groups == 0 or A == 0:
        return out
    full = plane_span(desc.n_int, desc.n_flt)
    span = min(span or full, full)
    seg = max(4, min(seg_rows or INT32_MAX, flush_rows(srcs)) // 4 * 4)
    rc = _lib("group_plane_sums_members").group_plane_sums_members(
        g.data_ptr(), ctypes.addressof(desc), ctypes.addressof(strides), n, M,
        gstride, num_groups, span, seg, PERSISTENT_SMEM_BYTES, out.data_ptr(),
        _stream(gid.device))
    _raise_on("group_plane_sums_members", rc)
    launches["group_plane_sums_members"] += 1
    return out


def group_minmax_members_plain(gid, sources, num_groups: int):
    """Plain version of K2's member-axis entry: the solo plain version
    once per member. Returns one tuple per source of one (M, num_groups)
    tensor per op."""
    M = gid.shape[0]
    n = gid[0].numel() if M else 0
    per = [group_minmax_plain(
        gid[m].reshape(-1),
        [dataclasses.replace(s, values=_member_slice(s.values, m, M, n))
         for s in sources], num_groups) for m in range(M)]
    return tuple(tuple(torch.stack([per[m][j][k] for m in range(M)])
                       for k in range(len(s.ops)))
                 for j, s in enumerate(sources))


def group_minmax_members(gid, sources, num_groups: int,
                         span: int | None = None):
    """K2 over a leading member axis: gid (M, n) int32, each member's own
    ids; sources: MinMaxSource whose values are n elements shared by every
    member or M * n (each member's own). Returns one tuple per source of
    one (M, num_groups) tensor per op."""
    offsets = [s.plus for s in sources if s.plus is not None]
    tensors = (gid, *(s.values for s in sources), *offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return group_minmax_members_plain(gid, sources, num_groups)
    _check_cuda("group_minmax_members", *tensors)
    if gid.dtype != torch.int32 or gid.dim() < 1:
        raise TypeError("group_minmax_members takes (M, n) int32 ids, got "
                        f"{gid.dtype} {tuple(gid.shape)}")
    if not sources or any(t.numel() != 1 for t in offsets):
        raise ValueError("group_minmax_members: sources and 0-d offsets")
    M = gid.shape[0]
    n = gid[0].numel() if M else 0
    g, gstride = _member_aligned(gid.reshape(-1), n)
    srcs, vstrides = [], []
    for s in sources:
        v, vs = _member_view(s.values, M, n, "group_minmax_members")
        v, vs = _member_aligned(v, vs)
        srcs.append(dataclasses.replace(s, values=v))
        vstrides.append(vs)
    cells = minmax_cells(srcs)
    keys = torch.empty((M, len(cells), num_groups), dtype=torch.int32,
                       device=gid.device)
    if M:
        desc = lower_minmax(srcs, list(keys[0]))
        strides = _MinMaxStrides()
        for j, vs in enumerate(vstrides):
            strides.vstride[j] = vs
        if num_groups:
            full = PERSISTENT_SMEM_BYTES // (4 * len(cells))
            rc = _lib("group_minmax_members").group_minmax_members(
                g.data_ptr(), ctypes.addressof(desc),
                ctypes.addressof(strides), n, M, gstride, num_groups,
                min(span or full, full), PERSISTENT_SMEM_BYTES,
                len(cells) * num_groups, _stream(gid.device))
            _raise_on("group_minmax_members", rc)
            launches["group_minmax_members"] += 1
    res, c = [], 0
    for s in srcs:
        res.append(tuple(_from_keys(keys[:, c + k], s.dtype).to(s.dtype)
                         for k in range(len(s.ops))))
        c += len(s.ops)
    return tuple(res)


def hll_register_max_members_plain(h, log2m: int, members: int,
                                   num_groups: int = 1, gid=None, mask=None):
    """Plain version of K3's member-axis entry: the solo plain version
    once per member. Returns (M, num_groups << log2m) int32."""
    M = members
    # gid and mask are each member's own: they give the rows per member,
    # as in the kernel's wrapper
    given = [t for t in (gid, mask) if t is not None]
    n = (given[0].numel() if given else h.numel()) // max(M, 1)
    return torch.stack([hll_register_max_plain(
        _member_slice(h, m, M, n), log2m, num_groups,
        None if gid is None else _member_slice(gid, m, M, n),
        None if mask is None else _member_slice(mask, m, M, n))
        for m in range(M)])


def hll_register_max_members(h, log2m: int, members: int, num_groups: int = 1,
                             gid=None, mask=None, span: int | None = None):
    """K3 over a leading member axis: each of h (int32 hash bits), gid
    (int32) and mask (bool) is n elements shared by every member or
    (members, n), each member's own; gid and mask, when given, are each
    member's own (members, n), and may be None as on the solo entry.
    Returns (members, num_groups << log2m) int32 registers."""
    M = members
    given = [t for t in (gid, mask) if t is not None]
    if all(t.device.type == "cpu" for t in (h, *given)):
        return hll_register_max_members_plain(h, log2m, M, num_groups, gid,
                                              mask)
    _check_cuda("hll_register_max_members", h, *given)
    if h.dtype != torch.int32 \
            or (gid is not None and gid.dtype != torch.int32) \
            or (mask is not None and mask.dtype != torch.bool):
        raise TypeError("hll_register_max_members takes int32 hashes and ids "
                        f"and a bool mask, got {[t.dtype for t in (h, *given)]}")
    if not 4 <= log2m <= 16:
        raise ValueError(f"hll_register_max_members: log2m {log2m} outside "
                         "[4, 16]")
    # gid and mask are each member's own: they give the rows per member
    n = (given[0].numel() if given else h.numel()) // max(M, 1)
    views = []
    for t in (h, gid, mask):
        if t is None:
            views.append((None, 0))
            continue
        v, st = _member_view(t, M, n, "hll_register_max_members")
        views.append(_member_aligned(v, st))
    (hv, hs), (gv, gs), (mv, ms) = views
    nslots = num_groups << log2m
    out = torch.zeros((M, nslots), dtype=torch.int32, device=h.device)
    if M and n and nslots:
        span = min(span or HLL_SPAN, HLL_SPAN)
        rc = _lib("hll_register_max_members").hll_register_max_members(
            hv.data_ptr(), None if gv is None else gv.data_ptr(),
            None if mv is None else mv.data_ptr(), n, M, hs, gs, ms, log2m,
            num_groups, span, out.data_ptr(), _stream(h.device))
        _raise_on("hll_register_max_members", rc)
        launches["hll_register_max_members"] += 1
    return out


def fused_filter_agg_members_plain(cand, rows_in, cols, lits, prog, aggs,
                                   ki: int, kf: int):
    """Plain version of K4's member-axis entry: the solo plain version
    once per member. Returns (ints (M, B, ki), flts (M, B, kf) or None)."""
    per = [fused_filter_agg_plain(cand[m], rows_in[m], cols, lits[m], prog,
                                  aggs, ki, kf) for m in range(cand.shape[0])]
    ints = torch.stack([p[0] for p in per]) if per else \
        torch.zeros((0, cand.shape[1], ki), dtype=torch.int32,
                    device=cand.device)
    flts = torch.stack([p[1] for p in per]) if kf and per else None
    return ints, flts


def fused_filter_agg_members(cand, rows_in, cols, lits, prog, aggs, ki: int,
                             kf: int):
    """K4 over a leading member axis: cand, rows_in (M, B) int32, each
    member's candidates; lits (M, P) int32, each member's literal table;
    the planes and the program shared. Returns (ints (M, B, ki) int32,
    flts (M, B, kf) float32 or None)."""
    if cand.device.type == "cpu":
        return fused_filter_agg_members_plain(cand, rows_in, cols, lits, prog,
                                              aggs, ki, kf)
    _check_cuda("fused_filter_agg_members", cand, rows_in, lits, *cols)
    if cand.dtype != torch.int32 or rows_in.dtype != torch.int32 \
            or lits.dtype != torch.int32:
        raise TypeError("fused_filter_agg_members takes int32 candidates, "
                        "rows and literals")
    if any(c.dtype not in _FUSED_DTYPES for c in cols):
        raise TypeError("fused_filter_agg_members planes: "
                        f"{[str(c.dtype) for c in cols]}")
    R = cols[0].shape[1] if cols else 0
    if cand.dim() != 2 or rows_in.shape != cand.shape or lits.dim() != 2 \
            or lits.shape[0] != cand.shape[0] \
            or any(c.dim() != 2 or c.shape[1] != R for c in cols):
        raise ValueError("fused_filter_agg_members shapes: cand "
                         f"{tuple(cand.shape)}, rows {tuple(rows_in.shape)}, "
                         f"lits {tuple(lits.shape)}, planes "
                         f"{[tuple(c.shape) for c in cols]}")
    if not cols or len(cols) > FUSED_MAX_COLS or len(prog) > FUSED_MAX_PROG \
            or len(aggs) > FUSED_MAX_AGGS or lits.shape[1] > FUSED_MAX_LITS:
        raise ValueError("fused_filter_agg_members program past the "
                         "descriptor's bounds")
    cols = [c if c.data_ptr() % 16 == 0 else c.clone() for c in cols]
    M, B = cand.shape
    P = lits.shape[1]
    desc = _FusedDesc()
    for j, c in enumerate(cols):
        desc.cols[j] = c.data_ptr()
        desc.dtypes[j] = _FUSED_DTYPES[c.dtype]
    lit_buf = lits if lits.numel() else torch.zeros(1, dtype=torch.int32,
                                                    device=cand.device)
    desc.lits = lit_buf.data_ptr()
    desc.n_cols, desc.n_prog, desc.n_aggs = len(cols), len(prog), len(aggs)
    desc.n_lits, desc.ki, desc.kf = P, ki, kf
    for j, ins in enumerate(prog):
        desc.prog[j] = _Instr(*ins)
    for j, (op, col, is_float, slot, fill) in enumerate(aggs):
        dt = torch.float32 if is_float else torch.int32
        fk = 0 if op == AGG_OPS["sum"] else _fill_key(fill, dt)
        desc.aggs[j] = _Agg(op, col, int(is_float), slot, fk)
    ints = torch.zeros((M, B, ki), dtype=torch.int32, device=cand.device)
    flts = torch.zeros((M, B, kf), dtype=torch.float32, device=cand.device) \
        if kf else None
    if M and B:
        rc = _lib("fused_filter_agg_members").fused_filter_agg_members(
            cand.data_ptr(), rows_in.data_ptr(), B, M, R,
            ctypes.addressof(desc), P, ints.data_ptr(),
            flts.data_ptr() if kf else None, _stream(cand.device))
        _raise_on("fused_filter_agg_members", rc)
        launches["fused_filter_agg_members"] += 1
    return ints, flts


# ---------------------------------------------------------------------------
# K5: ordered cluster sums (the t-digest build, port-only)
# ---------------------------------------------------------------------------


# the regimes K5 sums a cluster in (csrc/cluster_sums.cu): exact
# integers, a lane's chain (at most K5_SHORT values), a block's TMA-fed
# chain; their clusters are counted on the card, per device
K5_REGIMES = ("exact", "lane_chain", "block_chain")
K5_SHORT = 256
K5_MAX_ABS = 2.0 ** 53       # an exact value's magnitude, at most
K5_MAX_SUM_ABS = 2.0 ** 52   # an exact cluster's float64 sum of |v|
_k5_regimes: dict = {}


def _k5_regime_counts(device) -> torch.Tensor:
    t = _k5_regimes.get(device)
    if t is None:
        with _lock:
            t = _k5_regimes.setdefault(device, torch.zeros(
                len(K5_REGIMES), dtype=torch.int64, device=device))
    return t


def cluster_regimes() -> dict:
    """The clusters K5 summed in each regime on the card since the last
    ``reset_cluster_regimes``, over every device (one sync a device)."""
    out = dict.fromkeys(K5_REGIMES, 0)
    for t in list(_k5_regimes.values()):
        for name, n in zip(K5_REGIMES, t.tolist()):
            out[name] += n
    return out


def reset_cluster_regimes() -> None:
    for t in list(_k5_regimes.values()):
        t.zero_()


def cluster_regimes_plain(values, offsets):
    """Plain version of K5's choice of regime, on the CPU: (C,) int64, 0
    where the exact integer regime sums the cluster (every value an
    integer of magnitude at most 2^53 and the float64 sum of |v| at most
    2^52, or an empty cluster), 1 where a lane chains it (at most
    ``K5_SHORT`` values), 2 where a block does. The float sum's order
    differs from the card's, which matters only within a few ulps of
    2^52."""
    v = values.reshape(-1).to("cpu", torch.float64)
    off = offsets.reshape(-1).to("cpu", torch.int64)
    C = off.numel() - 1
    lengths = torch.diff(off)
    seg = torch.repeat_interleave(torch.arange(C), lengths.clamp(min=0))
    vals = v[int(off[0]):int(off[0]) + seg.numel()] if C else v[:0]
    ok = (vals.abs() <= K5_MAX_ABS) & (vals == vals.trunc())
    bad = torch.zeros(C, dtype=torch.int64).index_add_(
        0, seg, (~ok).to(torch.int64))
    asum = torch.zeros(C, dtype=torch.float64).index_add_(0, seg,
                                                          vals.abs())
    exact = (lengths <= 0) | ((bad == 0) & (asum <= K5_MAX_SUM_ABS))
    return torch.where(exact, 0, torch.where(lengths <= K5_SHORT, 1, 2))


def cluster_sums_plain(values, offsets):
    """Plain version of K5, on the CPU whatever the inputs' device: per
    cluster, ``torch.cumsum`` over its values, which the CPU runs as one
    sequential float64 loop from 0.0 (clusters of one length stacked as
    the rows of a matrix, summed along each row, the same loop a row).
    0.0 + v[s] is v[s] but for v[s] = -0.0, and the difference lasts only
    while every value added is a zero, so a cluster of -0.0 values alone
    sums to -0.0, as the sequential sum from v[s] does. Returns (C,)
    float64 on the inputs' device."""
    v = values.reshape(-1).to("cpu", torch.float64)
    off = offsets.reshape(-1).to("cpu", torch.int64)
    lens = off[1:] - off[:-1]
    out = torch.zeros(lens.numel(), dtype=torch.float64)
    neg_zero = torch.tensor(-0.0, dtype=torch.float64)
    for L in torch.unique(lens).tolist():
        if L == 0:
            continue
        same = torch.nonzero(lens == L).reshape(-1)
        step = max(1, (1 << 22) // L)   # rows a chunk: ~32 MB of values
        for cs in same.split(step):
            rows = v[off[cs, None] + torch.arange(L)]
            tot = torch.cumsum(rows, 1)[:, -1]
            negz = ((rows == 0) & torch.signbit(rows)).all(dim=1)
            out[cs] = torch.where(negz, neg_zero, tot)
    return out.to(values.device)


def cluster_sums(values, offsets):
    """K5. values: (n,) float64, sorted within each cluster as the caller
    wants them summed; offsets: (C + 1,) int64, non-decreasing, in [0, n]
    (ops/digest.py builds them on the host). Returns (C,) float64: each
    cluster's values added in index order from its first value, one
    ``__dadd_rn`` at a time (an empty cluster 0.0). On the card each
    cluster takes the regime it proves (``K5_REGIMES``), counted in
    ``cluster_regimes``."""
    if values.device.type == "cpu" and offsets.device.type == "cpu":
        return cluster_sums_plain(values, offsets)
    _check_cuda("cluster_sums", values, offsets)
    if values.dtype != torch.float64 or offsets.dtype != torch.int64:
        raise TypeError("cluster_sums takes float64 values and int64 "
                        f"offsets, got {values.dtype}, {offsets.dtype}")
    if values.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1 \
            or offsets.numel() > INT32_MAX:
        raise ValueError(f"cluster_sums shapes: values {tuple(values.shape)},"
                         f" offsets {tuple(offsets.shape)}")
    n, C = values.numel(), offsets.numel() - 1
    if not C:
        return torch.empty(0, dtype=torch.float64, device=values.device)
    lib = _lib("cluster_sums")
    # one allocation: the output, then the kernel's scratch
    buf = torch.empty(8 * C + lib.cluster_sums_scratch(n, C),
                      dtype=torch.uint8, device=values.device)
    out = buf[:8 * C].view(torch.float64)
    rc = lib.cluster_sums(
        values.data_ptr(), n, offsets.data_ptr(), C, buf.data_ptr(),
        buf.data_ptr() + 8 * C, _k5_regime_counts(values.device).data_ptr(),
        _stream(values.device))
    _raise_on("cluster_sums", rc)
    launches["cluster_sums"] += 1
    return out


def dadd_chain_ns(device, n: int = 1 << 24) -> dict:
    """One DADD's latency on the card: one thread adds n (a multiple of 8)
    dependent float64 values (csrc/cluster_sums.cu ``dadd_chain``), timed
    with CUDA events; and the cycles an addition by ``clock64``. The
    chain regime's bound is its longest cluster times ``ns``."""
    x = torch.tensor([1.0, 0.5, -0.25], dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float64, device=device)

    def run():
        _raise_on("dadd_chain", _lib("dadd_chain").dadd_chain(
            x.data_ptr(), n, out.data_ptr(), _stream(device)))
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    return {"adds": n, "ms": ms, "ns": ms * 1e6 / n,
            "cycles": float(out[1])}
