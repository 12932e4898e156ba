"""Zone-map block skip for the device filter path, on torch —
counterpart of pinot_tpu/ops/blockskip.py.

A selective filter should touch only the rows an index says it must. The
device analog of ColumnValueSegmentPruner's min/max check, pushed down to
``BLOCK_ROWS``-row blocks:

1. **Zone verdicts** (``zone_verdict``): the filter template evaluated in
   INTERVAL semantics over the (S, NB) per-block min/max tensors of the
   batch (engine/params.py ``BatchContext.zone_map``). AND = all children
   may match, OR = any, NOT / regex LUT = always "may match".
2. **Static-bound compaction** (``compact_candidates``): the candidate
   block ids sort to the front and slice to a bound B = ceil(total blocks
   / CAND_FRACTION). More candidates than B is OVERFLOW, and the caller
   runs the dense form instead (engine/device.py reads the candidate
   count to the host: eager torch has no on-device branch).
3. **Block gather** (``gather_blocks``): each needed column reshapes to
   (S * NB, R) and takes only the candidate blocks; the filter and the
   aggregation then run over B * R rows instead of S * L. Scalar
   templates that fit the fused kernel's surface skip the gather buffer
   and go through K4 (ops/group_scatter.py ``fused_filter_agg``).

Zone tensors are tiny (S x NB), so they widen to int64 (or decode through
the frame-of-reference offset) before any comparison: torch's unsigned
16-bit comparisons are thin, and a FOR plane's zones live in storage
space while the literals live in value space.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS as BLOCK_ROWS

# static candidate bound: B = ceil(total_blocks / CAND_FRACTION); past it
# the query runs the dense form, so the worst case adds the verdict and
# one scalar read to the dense cost
CAND_FRACTION = 16

ZLO = "zlo::"  # zone-map column key prefixes (cols dict)
ZHI = "zhi::"


def expr_colkey(expr_tpl):
    """Column key a raw-space predicate's expression reads directly, or
    None when the expression computes (no interval structure tracked)."""
    if not isinstance(expr_tpl, tuple):
        return None
    if expr_tpl[0] == "raw":
        return expr_tpl[1]
    if expr_tpl[0] == "dictval":
        return "dv::" + expr_tpl[1]
    return None


def prunable_columns(tpl) -> tuple[bool, set]:
    """(prunable, column keys) for a filter template: ``prunable`` is True
    when the zone verdict can exclude at least some blocks (a conservative
    child of an OR poisons the whole disjunction, and NOT proves nothing
    about a block); the column set names the zone maps the verdict
    reads."""
    kind = tpl[0]
    if kind == "and":
        cols: set = set()
        any_p = False
        for c in tpl[1:]:
            p, cc = prunable_columns(c)
            any_p |= p
            cols |= cc
        return any_p, cols
    if kind == "or":
        cols = set()
        for c in tpl[1:]:
            p, cc = prunable_columns(c)
            if not p:
                return False, set()  # one conservative child: OR never prunes
            cols |= cc
        return bool(cols), cols
    if kind == "false":
        return True, set()
    if kind in ("eq_dict", "in_dict", "range_dict"):
        return True, {tpl[1]}
    if kind in ("eq_raw", "in_raw", "range_raw"):
        ck = expr_colkey(tpl[1])
        if ck is None:
            return False, set()
        return True, {ck}
    # true / not / lut_dict / mv_any: conservative "may match"
    return False, set()


def _zones(cols, params, colkey, widths=None):
    """(lo, hi) zone tensors for a column key in the column's VALUE
    space: id-space zones widen to int64; frame-of-reference zones widen
    to the plan's wide dtype and add the batch's "fo::<key>" offset;
    float zones stay float32."""
    lo = cols.get(ZLO + colkey)
    hi = cols.get(ZHI + colkey)
    if lo is None or hi is None:
        return None, None
    w = widths.get(colkey) if widths else None
    if w is not None and w[3]:  # (dtype, bits, has_offset, wide)
        wd = torch.from_numpy(np.zeros(0, dtype=np.dtype(w[3]))).dtype
        lo, hi = lo.to(wd), hi.to(wd)
        fo = params.get("fo::" + colkey)
        if w[2] and fo is not None:
            lo, hi = lo + fo, hi + fo
        return lo, hi
    if not lo.is_floating_point():
        lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    return lo, hi


def zone_verdict(tpl, cols, params, shape, widths=None):
    """(S, NB) bool: True where the block MAY hold a matching row. Mirrors
    engine/device.py's ``eval_filter`` node set in interval semantics;
    any node without interval structure gives all-True (it never prunes a
    block the dense mask would match)."""
    kind = tpl[0]
    dev = next(iter(cols.values())).device
    ones = torch.ones(shape, dtype=torch.bool, device=dev)
    if kind == "true":
        return ones
    if kind == "false":
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    if kind in ("and", "or"):
        v = zone_verdict(tpl[1], cols, params, shape, widths)
        for c in tpl[2:]:
            vc = zone_verdict(c, cols, params, shape, widths)
            v = (v & vc) if kind == "and" else (v | vc)
        return v
    if kind in ("eq_dict", "in_dict", "range_dict"):
        lo, hi = _zones(cols, params, tpl[1], widths)
    elif kind in ("eq_raw", "in_raw", "range_raw"):
        lo, hi = _zones(cols, params, expr_colkey(tpl[1]) or "", widths)
    else:  # not / lut_dict / mv_any / anything new: conservative
        return ones
    if lo is None:
        return ones
    if kind in ("eq_dict", "eq_raw"):
        t = params[tpl[2]]  # eq_dict: -2 when absent, below every zone
        return (t >= lo) & (t <= hi)
    if kind in ("in_dict", "in_raw"):
        lits = params[tpl[2]].reshape(-1)  # in_dict pads with -2
        return ((lits >= lo[..., None]) & (lits <= hi[..., None])).any(-1)
    if kind == "range_dict":
        rlo, rhi = params[tpl[2]], params[tpl[3]]  # id interval [rlo, rhi)
        return (lo < rhi) & (hi >= rlo)
    _, _expr, klo, khi, has_lo, has_hi, lo_inc, hi_inc = tpl
    v = ones
    if has_lo:
        b = params[klo]
        v = v & ((hi >= b) if lo_inc else (hi > b))
    if has_hi:
        b = params[khi]
        v = v & ((lo <= b) if hi_inc else (lo < b))
    return v


def cand_bound(total_blocks: int, blockskip=True) -> int:
    """The static candidate bound B = ceil(total_blocks / fraction), at
    least 1 and at most every block. ``blockskip`` is the executor's
    block-skip setting: True (or 1) takes CAND_FRACTION, an int > 1 is
    the plan advisor's tightened fraction (32 or 64), as the reference's
    pipeline reads it."""
    frac = CAND_FRACTION if blockskip is True or int(blockskip) <= 1 \
        else int(blockskip)
    return min(total_blocks, max(1, -(-total_blocks // frac)))


def compact_candidates(flat_verdict, bound: int):
    """The True positions of a flat (total_blocks,) verdict, ascending, in
    a static bound: (candidate ids (bound,) int32, valid (bound,) bool).
    Padding candidates point at block 0 with valid=False; the caller
    masks their rows out. A cohort's (M, total_blocks) verdicts compact
    per member: (M, bound) each."""
    total = flat_verdict.shape[-1]
    iota = torch.arange(total, dtype=torch.int32, device=flat_verdict.device)
    keyed = torch.where(flat_verdict, iota, torch.full_like(iota, total))
    cand = torch.sort(keyed, dim=-1).values[..., :bound]
    valid = cand < total
    return torch.where(valid, cand, torch.zeros_like(cand)), valid


# unsigned planes gather through a same-width signed view: the bits move
# unchanged, and torch's index kernels cover every signed width
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def gather_blocks(x, cand, n_blocks_per_seg: int, block_rows: int):
    """Candidate blocks of an (S, L, ...) column: reshape to (S * NB, R,
    ...) and take the candidate rows — the device analog of an index
    handing the scan a doc-id subset."""
    flat = x.reshape((x.shape[0] * n_blocks_per_seg, block_rows)
                     + tuple(x.shape[2:]))
    signed = _SIGNED_VIEW.get(flat.dtype)
    if signed is None:
        return flat.index_select(0, cand.long())
    return flat.view(signed).index_select(0, cand.long()).view(flat.dtype)
