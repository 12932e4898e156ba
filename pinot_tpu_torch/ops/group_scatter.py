"""The group-range partitioned plane sums (K1), group min/max (K2) and
small HLL register builds (K3) — counterpart of
pinot_tpu/ops/pallas_scatter.py.

The reference's Pallas tier replaced XLA's serialized TPU scatters with
purpose-built kernels; on the card the same two functions run through the
hand-written CUDA kernels of ops/kernels.py:

- ``plane_group_sums`` → K1: exact per-group sums of the bf16 plane
  channels of values as stored (split in the kernel), past the
  single-accumulator ceiling ``mm_supported`` sets;
- ``group_minmax`` / ``group_minmax_sources`` → K2: per-group MIN and/or
  MAX of up to 8 sources in one launch, each a plane as stored (decoded
  in the kernel) or an evaluated tensor, with caller-supplied
  empty-group fills;
- ``hll_register_max`` → K3: per-slot max rho, from the hash plane,
  over slot spaces up to ``HLL_MAX_SLOTS`` (scalar and small-group
  HLL).

- ``fused_filter_agg`` → K4: the block-skip path's fused filter +
  gather + aggregate over candidate zone blocks, planned by
  ``plan_fused`` / ``fused_params_ok`` exactly as the reference plans its
  fused kernel, then lowered to K4's postfix filter program.

The routing predicates (``sums_supported``, ``minmax_supported``,
``hll_supported``, the fused plan) and the minimum batch
(``PALLAS_MIN_ROWS``) are the reference's, so the same queries reach the
kernels; other shapes stay on the torch scatters of ops/agg.py, where the
reference uses XLA's.

``launches`` counts kernel launches per entry of this module, beside
``kernels.launches`` per kernel: K1 and K3 each replace two TPU kernels,
and the entry says which one a launch stands for. Each entry has a
``*_members`` twin over a leading member axis, one launch for a cohort of
coalesced queries (engine/cohort.py), where the reference runs the same
``pallas_call`` under ``jax.vmap``.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.blockskip import expr_colkey
from pinot_tpu_torch.ops.groupby_mm import MAX_ACC_CELLS, MAX_CHANNELS

LO = 128                 # the reference's low radix (routing arithmetic)
MAX_PARTITIONS = 8
PALLAS_MIN_ROWS = 1 << 17  # below this the scatter's fixed cost wins

MINMAX_SPAN = 1024
MAX_MINMAX_PARTS = 8     # → num_groups <= 8191

HLL_MAX_SLOTS = 1 << 12  # past this the reference's presence kernel declines

# fused filter + gather + aggregate (K4)
FUSED_BLOCK_ROWS = 4096  # rows per candidate block; the fused plan is only
                         # built when storage.segment.ZONE_BLOCK_ROWS
                         # equals this (engine/device.py build_pipeline
                         # declines otherwise)
FUSED_MAX_IN = 8         # IN-list bound per predicate

launches = {"plane_group_sums": 0, "group_minmax": 0, "hll_register_max": 0,
            "fused_filter_agg": 0, "plane_group_sums_members": 0,
            "group_minmax_members": 0, "hll_register_max_members": 0,
            "fused_filter_agg_members": 0}


def _hpad_total(num_groups: int) -> int:
    return max(8, ((num_groups // LO + 1 + 7) // 8) * 8)


def _span_hpad(a_real: int) -> int:
    h = MAX_ACC_CELLS // (a_real * LO)
    return max(8, (h // 8) * 8)


def sums_supported(num_groups: int, n_channels: int) -> bool:
    """The reference's partitioned plane-sum regime: the group space splits
    into <= MAX_PARTITIONS accumulator-sized ranges."""
    if n_channels > MAX_CHANNELS + 1:
        return False
    hp = _span_hpad(n_channels)
    return -(-_hpad_total(num_groups) // hp) <= MAX_PARTITIONS


def plane_group_sums(gid, sources, num_groups: int, *, count: bool = False,
                     span: int | None = None):
    """Dense per-group sums through K1. gid: (n,) int32 in [0, num_groups]
    (num_groups = overflow slot); sources: kernels.PlaneSource values as
    stored (K1 splits them into channels in registers); ``count``: row 0
    counts the rows. ``span`` overrides K1's groups per partition (tests
    force multi-partition launches on small group counts). Returns
    (A, num_groups) float64."""
    return kernels.count_entry(
        launches, "plane_group_sums", "group_plane_sums",
        kernels.group_plane_sums, gid.reshape(-1), sources, num_groups,
        count=count, span=span)


def plane_group_sums_members(gid, sources, num_groups: int, *,
                             count: bool = False, span: int | None = None):
    """``plane_group_sums`` for a cohort: gid (M, n) int32, each member's
    own ids; sources as ``kernels.group_plane_sums_members`` takes them.
    Returns (M, A, num_groups) float64."""
    return kernels.count_entry(
        launches, "plane_group_sums_members", "group_plane_sums_members",
        kernels.group_plane_sums_members, gid.reshape(gid.shape[0], -1),
        sources, num_groups, count=count, span=span)


_MINMAX_KERNEL_DTYPES = {
    "int8": torch.int32, "int16": torch.int32, "int32": torch.int32,
    "uint8": torch.int32, "uint16": torch.int32, "float32": torch.float32,
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def minmax_supported(num_groups: int, dtype) -> bool:
    """int64/float64 values stay on the torch scatter (the reference's
    kernel has no 64-bit path); the group count is the reference's bound."""
    if _dtype_name(dtype) not in _MINMAX_KERNEL_DTYPES:
        return False
    return -(-(num_groups + 1) // MINMAX_SPAN) <= MAX_MINMAX_PARTS


def group_minmax(gid, values, num_groups: int, ops: tuple,
                 fills: tuple | None = None):
    """Per-group min and/or max of one value tensor through K2, the
    reference's signature. ``ops`` ⊆ ("min", "max"); ``fills`` sets the
    empty-group value per op (callers pass the ORIGINAL dtype's extremes
    so empty slots match the scatter path bit for bit). K2 reads narrow
    values as they are; returns one (num_groups,) tensor per op in the
    kernel dtype (int32 or float32), as the reference does."""
    kdt = _MINMAX_KERNEL_DTYPES[_dtype_name(values.dtype)]
    return group_minmax_sources(
        gid, [kernels.MinMaxSource(values.reshape(-1), tuple(ops), fills,
                                   dtype=kdt)], num_groups)[0]


def group_minmax_sources(gid, sources, num_groups: int,
                         span: int | None = None):
    """Every MIN / MAX / MINMAXRANGE of a query through ONE K2 launch.
    sources: kernels.MinMaxSource, each a plane as stored with its FOR
    offset and decoded dtype (K2 decodes in registers) or an evaluated
    tensor. ``span`` overrides K2's groups per partition. Returns one
    tuple per source of one (num_groups,) tensor per op in the decoded
    dtype."""
    return kernels.count_entry(
        launches, "group_minmax", "group_minmax",
        kernels.group_minmax_sources, gid.reshape(-1).to(torch.int32),
        sources, num_groups, span=span)


def group_minmax_members(gid, sources, num_groups: int):
    """``group_minmax_sources`` for a cohort: gid (M, n), each member's own
    ids. Returns one tuple per source of one (M, num_groups) tensor per
    op."""
    return kernels.count_entry(
        launches, "group_minmax_members", "group_minmax_members",
        kernels.group_minmax_members,
        gid.reshape(gid.shape[0], -1).to(torch.int32), sources, num_groups)


def hll_supported(nslots: int, nrho: int) -> bool:
    """The reference's regime for its presence kernel: at most
    ``HLL_MAX_SLOTS`` slots, split into <= MAX_PARTITIONS accumulator
    ranges of ``nrho`` channels."""
    if nslots > HLL_MAX_SLOTS:
        return False
    hp = _span_hpad(nrho)
    return -(-_hpad_total(nslots) // hp) <= MAX_PARTITIONS


def hll_register_max(h, log2m: int, *, num_groups: int = 1, gid=None,
                     mask=None, span: int | None = None):
    """(num_groups << log2m,) int32 registers = per-slot max rho, through
    K3, from the int32 hash plane ``h``; ``gid`` (int32) or None for one
    group, ``mask`` (bool) or None for every row. ``span`` overrides K3's
    slots per partition."""
    return kernels.count_entry(
        launches, "hll_register_max", "hll_register_max",
        kernels.hll_register_max, h.reshape(-1), log2m, num_groups,
        gid=None if gid is None else gid.reshape(-1),
        mask=None if mask is None else mask.reshape(-1), span=span)


def hll_register_max_members(h, log2m: int, members: int, *,
                             num_groups: int = 1, gid=None, mask=None):
    """``hll_register_max`` for a cohort of ``members`` queries: h shared
    or (M, n), gid / mask each member's own (M, n) or None. Returns (M,
    num_groups << log2m) int32 registers."""
    return kernels.count_entry(
        launches, "hll_register_max_members", "hll_register_max_members",
        kernels.hll_register_max_members, h, log2m, members, num_groups,
        gid=gid, mask=mask)


# ---------------------------------------------------------------------------
# fused filter + gather + aggregate (block-skip candidates), K4
# ---------------------------------------------------------------------------

# storage dtypes the kernel loads directly; raw-space predicate literals
# additionally need a value range strictly inside int32 so host-side
# clipping into storage space preserves every comparison
_FUSED_COL_DTYPES = ("uint8", "uint16", "int8", "int16", "int32", "float32")
_FUSED_PRED_DTYPES = ("uint8", "uint16", "int8", "int16")

_FUSED_AGGS = ("count", "sum", "avg", "min", "max", "minmaxrange")


class FusedPlan:
    """Static plan for one fused launch: operand order, per-agg output
    slots, the parameter transforms the caller applies (shift raw
    literals into storage space, clip into the plane's value range) and
    the filter as K4's postfix program."""

    __slots__ = ("cols", "filter_tpl", "pred_params", "aggs",
                 "n_int", "n_flt", "program")

    def __init__(self, cols, filter_tpl, pred_params, aggs, n_int, n_flt,
                 program):
        self.cols = cols              # tuple of column keys (operand order)
        self.filter_tpl = filter_tpl
        # {param key: (colkey or None, "id" | "storage")} — "storage"
        # params subtract the column's FOR offset and clip to the plane's
        # value range before entering the kernel
        self.pred_params = pred_params
        # tuple of (agg index, name, colkey, buffer, slot, fill)
        self.aggs = aggs
        self.n_int = n_int
        self.n_flt = n_flt
        # postfix filter program: ("true",) / ("false",) / ("and",) /
        # ("or",) / ("not",) / ("in", colkey, key) / ("range", colkey,
        # lo key or None, hi key or None, flags)
        self.program = program


def _plan_filter(tpl, widths, cols, pred_params) -> bool:
    """Walk the filter template: True iff every node is kernel-evaluable.
    Fills ``cols``/``pred_params`` as it goes."""
    kind = tpl[0]
    if kind in ("true", "false"):
        return True
    if kind in ("and", "or"):
        return all(_plan_filter(c, widths, cols, pred_params)
                   for c in tpl[1:])
    if kind == "not":
        return _plan_filter(tpl[1], widths, cols, pred_params)

    def col_ok(key, pred: bool) -> bool:
        w = widths.get(key) if widths and key is not None else None
        if w is None or w[1]:
            return False  # unplanned, or a sub-byte packed plane
        allowed = _FUSED_PRED_DTYPES if pred else _FUSED_COL_DTYPES
        if _dtype_name(w[0]) not in allowed:
            return False
        cols.add(key)
        return True

    if kind in ("eq_dict", "in_dict", "range_dict"):
        if not col_ok(tpl[1], False) \
                or _dtype_name(widths[tpl[1]][0]) == "float32":
            return False
        for key in tpl[2:4] if kind == "range_dict" else tpl[2:3]:
            pred_params[key] = (tpl[1], "id")
        return True
    if kind in ("eq_raw", "in_raw"):
        ck = expr_colkey(tpl[1])
        if not col_ok(ck, True):
            return False
        pred_params[tpl[2]] = (ck, "storage")
        return True
    if kind == "range_raw":
        _, expr_tpl, klo, khi, has_lo, has_hi, _li, _hi_inc = tpl
        ck = expr_colkey(expr_tpl)
        if not col_ok(ck, True):
            return False
        if has_lo:
            pred_params[klo] = (ck, "storage")
        if has_hi:
            pred_params[khi] = (ck, "storage")
        return True
    return False  # lut_dict / mv_any / anything new


def _fused_program(tpl, out: list) -> list:
    """The filter template in postfix order, n-ary and/or folded left."""
    kind = tpl[0]
    if kind in ("true", "false"):
        out.append((kind,))
    elif kind in ("and", "or"):
        _fused_program(tpl[1], out)
        for c in tpl[2:]:
            _fused_program(c, out)
            out.append((kind,))
    elif kind == "not":
        _fused_program(tpl[1], out)
        out.append(("not",))
    elif kind in ("eq_dict", "in_dict"):
        out.append(("in", tpl[1], tpl[2]))
    elif kind in ("eq_raw", "in_raw"):
        out.append(("in", expr_colkey(tpl[1]), tpl[2]))
    elif kind == "range_dict":  # id interval [lo, hi)
        out.append(("range", tpl[1], tpl[2], tpl[3],
                    kernels.RANGE_HAS_LO | kernels.RANGE_HAS_HI
                    | kernels.RANGE_LO_INC))
    else:  # range_raw
        _, expr_tpl, klo, khi, has_lo, has_hi, lo_inc, hi_inc = tpl
        flags = (kernels.RANGE_HAS_LO * bool(has_lo)
                 | kernels.RANGE_HAS_HI * bool(has_hi)
                 | kernels.RANGE_LO_INC * bool(lo_inc)
                 | kernels.RANGE_HI_INC * bool(hi_inc))
        out.append(("range", expr_colkey(expr_tpl),
                    klo if has_lo else None, khi if has_hi else None, flags))
    return out


def _stack_depth(program) -> int:
    depth = most = 0
    for ins in program:
        depth += {"and": -1, "or": -1, "not": 0}.get(ins[0], 1)
        most = max(most, depth)
    return most


def plan_fused(filter_tpl, agg_tpls, widths):
    """Static fused-launch plan for a scalar-shape block-skip template, or
    None when any node falls outside the kernel's surface or its program
    bounds (columns, program length, stack depth, aggregate slots); the
    generic gather branch then runs, with the same integers."""
    cols: set = set()
    pred_params: dict = {}
    if not _plan_filter(filter_tpl, widths, cols, pred_params):
        return None
    aggs = []
    n_int, n_flt = 1, 0  # int slot 0 = per-block matched count
    for i, (name, argt, extra) in enumerate(agg_tpls):
        if name not in _FUSED_AGGS:
            return None
        if name == "count":
            continue
        ck = expr_colkey(argt)
        w = widths.get(ck) if widths and ck is not None else None
        if w is None or w[1]:
            return None
        dt = _dtype_name(w[0])
        if dt not in _FUSED_COL_DTYPES:
            return None
        is_float = dt == "float32"
        if name in ("sum", "avg"):
            if is_float:
                return None  # f32 sums are order-sensitive: generic branch
            rpb = extra[1]  # extra = (nplanes, rows per block)
            if rpb is None or rpb < FUSED_BLOCK_ROWS:
                return None  # per-block int32 partial could overflow
            cols.add(ck)
            aggs.append((i, "sum", ck, "int", n_int, 0))
            n_int += 1
            continue
        ops = ("min", "max") if name == "minmaxrange" else (name,)
        cols.add(ck)
        for op in ops:
            if is_float:
                fill = float("inf") if op == "min" else float("-inf")
                aggs.append((i, op, ck, "flt", n_flt, fill))
                n_flt += 1
            else:
                info = np.iinfo(np.dtype(w[0]))
                fill = int(info.max if op == "min" else info.min)
                aggs.append((i, op, ck, "int", n_int, fill))
                n_int += 1
    program = tuple(_fused_program(filter_tpl, []))
    if (not cols or len(cols) > kernels.FUSED_MAX_COLS
            or len(program) > kernels.FUSED_MAX_PROG
            or _stack_depth(program) > kernels.FUSED_MAX_STACK
            or len(aggs) > kernels.FUSED_MAX_AGGS):
        return None
    return FusedPlan(tuple(sorted(cols)), filter_tpl, pred_params,
                     tuple(aggs), n_int, n_flt, program)


def fused_params_ok(plan: FusedPlan, params: dict) -> bool:
    """Runtime check: every predicate param present with a
    kernel-compatible shape (IN lists bounded, all literals within K4's
    literal table) and dtype. Raw-space params must be INTEGER: a
    fractional literal (``ts < 10.5``) would truncate under the
    storage-space int cast while the generic branch compares with float
    promotion — the query takes the generic gather branch instead."""
    n_lits = 0
    for key, (_ck, kindp) in plan.pred_params.items():
        p = params.get(key)
        if p is None:
            return False
        if p.dim() > 1 or (p.dim() == 1 and p.shape[0] > FUSED_MAX_IN):
            return False
        if kindp == "storage" and (p.is_floating_point()
                                   or p.dtype == torch.bool):
            return False
        n_lits += p.numel()
    return n_lits <= kernels.FUSED_MAX_LITS


def lower_fused(plan: FusedPlan, col_arrays: dict, param_arrays: dict):
    """The plan in K4's terms: (column tensors in operand order, int32
    literal table, program of (op, col, a, b, flags) int tuples, aggs of
    (op, col, is_float, slot, fill), int slots, float slots)."""
    col_ix = {k: j for j, k in enumerate(plan.cols)}
    pkeys = sorted(param_arrays)
    offset, n = {}, 0
    for k in pkeys:
        offset[k] = n
        n += param_arrays[k].numel()
    dev = col_arrays[plan.cols[0]].device
    lits = torch.cat([param_arrays[k].reshape(-1).to(torch.int32)
                      for k in pkeys]) if pkeys \
        else torch.zeros(0, dtype=torch.int32, device=dev)
    ops = {"true": kernels.OP_TRUE, "false": kernels.OP_FALSE,
           "and": kernels.OP_AND, "or": kernels.OP_OR,
           "not": kernels.OP_NOT}
    prog = []
    for ins in plan.program:
        if ins[0] == "in":
            _, ck, key = ins
            prog.append((kernels.OP_IN, col_ix[ck], offset[key],
                         param_arrays[key].numel(), 0))
        elif ins[0] == "range":
            _, ck, klo, khi, flags = ins
            prog.append((kernels.OP_RANGE, col_ix[ck],
                         offset[klo] if klo is not None else 0,
                         offset[khi] if khi is not None else 0, flags))
        else:
            prog.append((ops[ins[0]], 0, 0, 0, 0))
    aggs = tuple((kernels.AGG_OPS[op], col_ix[ck], buf == "flt", slot, fill)
                 for (_i, op, ck, buf, slot, fill) in plan.aggs)
    ki = max(8, plan.n_int)
    kf = max(8, plan.n_flt) if plan.n_flt else 0
    return ([col_arrays[k] for k in plan.cols], lits, tuple(prog), aggs,
            ki, kf)


def fused_filter_agg(cand, rows_in_block, col_arrays: dict,
                     param_arrays: dict, plan: FusedPlan):
    """ONE K4 launch: gather the candidate blocks, evaluate the filter,
    aggregate per block; the generic branch's (B, R) gather buffer never
    exists.

    cand: (B,) int32 candidate block ids into the flattened (S*NB, R)
    view; rows_in_block: (B,) int32 valid rows per candidate (0 for
    padding candidates). col_arrays: {key: (S*NB, R)} storage-dtype
    views; param_arrays: {key: (K,) or () int32} already shifted into
    storage space. Returns (ints (B, max(8, n_int)) int32, flts (B,
    max(8, n_flt)) float32 or None): matched count in int slot 0, agg
    partials per the plan's slots."""
    args = lower_fused(plan, col_arrays, param_arrays)
    return kernels.count_entry(
        launches, "fused_filter_agg", "fused_filter_agg",
        kernels.fused_filter_agg, cand.to(torch.int32).contiguous(),
        rows_in_block.to(torch.int32).contiguous(), *args)


def fused_filter_agg_members(cand, rows_in_block, col_arrays: dict,
                             param_arrays: dict, plan: FusedPlan):
    """``fused_filter_agg`` for a cohort: ONE K4 launch for M members.
    cand, rows_in_block: (M, B) each member's candidates; param_arrays:
    {key: (M, K) or (M,) int32} each member's literals in storage space.
    Returns (ints (M, B, ki) int32, flts (M, B, kf) float32 or None)."""
    M = cand.shape[0]
    first = {k: v[0] for k, v in param_arrays.items()}
    cols, _lits, prog, aggs, ki, kf = lower_fused(plan, col_arrays, first)
    pkeys = sorted(param_arrays)
    lits = torch.cat([param_arrays[k].reshape(M, -1).to(torch.int32)
                      for k in pkeys], dim=1) if pkeys \
        else torch.zeros((M, 0), dtype=torch.int32, device=cand.device)
    return kernels.count_entry(
        launches, "fused_filter_agg_members", "fused_filter_agg_members",
        kernels.fused_filter_agg_members, cand.to(torch.int32).contiguous(),
        rows_in_block.to(torch.int32).contiguous(), cols, lits.contiguous(),
        prog, aggs, ki, kf)
