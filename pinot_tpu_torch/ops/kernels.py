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
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

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
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the compiler's output of each library this process built: with
# -Xptxas -v, every kernel's registers, shared memory and spills
build_log: dict = {}

# dynamic shared memory a block may take (of the H100's 227 KB per block)
SMEM_BYTES = 200 * 1024

# launches per kernel, counted where the wrapper launches it and nowhere
# else (chip_smoke.py zeroes them before driving the main path)
launches = {name: 0 for name in SOURCES}

_libs: dict = {}
_lock = threading.Lock()

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {  # the C signatures at the end of each csrc/*.cu
    "group_plane_sums": [_vp, _vp, _i64, _i32, _i32, _i64, _i32, _vp, _vp],
    "group_minmax": [_vp, _vp, _i64, _i32, _i32, _i32, ctypes.c_int32,
                     ctypes.c_int32, _vp, _vp, _vp],
    "hll_register_max": [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _vp, _vp],
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
        build_log[name] = out.decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{name}:\n{build_log[name]}")
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
