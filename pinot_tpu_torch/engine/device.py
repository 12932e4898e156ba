"""Device query executor on torch: one pipeline over the whole (S, L)
segment batch,

    filter masks → global-id group keys → dense aggregation

counterpart of pinot_tpu/engine/device.py. The template (literals
parameterized out, as in the reference) is evaluated eagerly as torch ops
on CUDA tensors; there is no compile step to cache. Group-by runs in
global dictionary id space (engine/params.py), so the dense (G,)
accumulator is the ARRAY_BASED group-key regime and its merge at once.

Dense COUNT/SUM/AVG route through the group plane-sum kernel K1,
MIN/MAX/MINMAXRANGE through the group min/max kernel K2 and the
DISTINCTCOUNTHLL register builds through the register-max kernel K3
(ops/group_scatter.py, ops/groupby_mm.py), with the reference's
pallas-tier routing and minimum batch; other shapes use the torch
scatters of ops/agg.py where the reference uses XLA's.

DISTINCTCOUNTHLL and the DISTINCTCOUNT family run over dict columns: a
presence vector over global ids, and HLL registers from per-doc hashes
gathered at upload. A TERMINAL launch (``final``: nothing merges after
it, as for ``QueryEngine.execute``) finalizes them on the card —
popcounts and estimates instead of G x C presence or G x m registers —
and builds large-G HLL register-free from sorted keys
(``_hll_sorted_sums``); a non-terminal launch returns the mergeable
presence sets and registers.

Pruning, as in the reference. Level 1: ``SegmentPruner`` (engine/engine.py)
proves segments empty from their metadata at launch; they stay in the
batch, dead (the ``ps_alive`` param), and a fully pruned launch runs
nothing on the card. Level 2: a filter with interval structure takes the
zone-map block skip (ops/blockskip.py): per-block verdicts over the
batch's zone maps, the candidate blocks compacted under a static bound,
then either the generic gathered form (filter + aggregation over the
(B, R) candidate rows) or, for scalar templates in its surface, the fused
filter + gather + aggregate kernel K4 (ops/group_scatter.py). Where the
reference branches on the device (``lax.cond``), the port reads the
candidate count to the host, one scalar sync, and runs the dense form
when it overflows the bound.

This slice covers the scalar ``agg`` and dense ``groupby`` shapes. The
sorted high-cardinality group-by regime, DISTINCT, HLLMERGE and
first/last-with-time raise DeviceUnsupported and come with later slices.
There is no fallback ladder: a device or kernel error propagates to the
caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pinot_tpu_torch import resolve_device
from pinot_tpu_torch.common.options import bool_option
from pinot_tpu_torch.engine import aggspec
from pinot_tpu_torch.engine.params import (
    BatchContext,
    DeviceUnsupported,
    build_expr,
    build_filter,
    expr_bounds,
    to_device,
)
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import blockskip as bs_ops
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import hll as hll_ops
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops import masks as mask_ops
from pinot_tpu_torch.ops import radix_groupby as radix_ops
from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.query.context import Expression, QueryContext
from pinot_tpu_torch.storage.segment import Encoding

DEVICE_AGGS = {"count", "sum", "min", "max", "avg", "minmaxrange",
               "distinctcount", "distinctcounthll"}
SKETCH_AGGS = ("distinctcount", "distinctcounthll")
# answered as DISTINCTCOUNT over a dict column, as in the reference
DISTINCTCOUNT_ALIASES = ("distinctcountbitmap",
                         "segmentpartitioneddistinctcount")

# aggregations the reference runs on its device that this port runs in a
# later slice
LATER_AGGS = {
    "hllmerge": "star-tree sketch merge",
    "firstwithtime": "first/last-with-time",
    "lastwithtime": "first/last-with-time",
}

MAX_DENSE_GROUPS = 1 << 22        # ARRAY_BASED regime guard (~4M groups)
MAX_PRESENCE_CELLS = 1 << 24      # per-group distinct/HLL state guard


def _torch_dtype(np_str: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(np_str))).dtype


# ---------------------------------------------------------------------------
# template evaluation
# ---------------------------------------------------------------------------


def _ids_col(cols, key):
    """Dict-id plane widened to int32: literal ids and the group-id
    arithmetic must never wrap at a uint8/uint16 plane's width."""
    return cols[key].to(torch.int32)


def _data_col(cols, params, key, widths):
    """Raw / decoded (dv::) value plane DECODED to its plan's wide dtype:
    frame-of-reference planes add the per-batch "fo::<key>" offset. The
    plane stays narrow on the card; decoding always widens, so two narrow
    planes multiplied in an expression do not wrap."""
    v = cols[key]
    w = (widths or {}).get(key)
    if w is None or not w[3]:
        return v
    v = v.to(_torch_dtype(w[3]))
    if w[2]:
        v = v + params["fo::" + key]
    return v


def _eval_expr(tpl, cols, params, widths=None):
    kind = tpl[0]
    if kind == "lit":
        return params[tpl[1]]
    if kind == "raw":
        return _data_col(cols, params, tpl[1], widths)
    if kind == "dictval":
        # decoded on the host at upload (BatchContext.decoded_column)
        return _data_col(cols, params, "dv::" + tpl[1], widths)
    if kind == "cast":
        return get_function("cast").torch_fn(
            _eval_expr(tpl[1], cols, params, widths), tpl[2])
    fn = get_function(kind)
    args = [_eval_expr(a, cols, params, widths) for a in tpl[1:]]
    return fn.torch_fn(*args)


def _eval_filter(tpl, cols, params, shape, device, widths=None):
    kind = tpl[0]
    if kind == "true":
        return torch.ones(shape, dtype=torch.bool, device=device)
    if kind == "false":
        return torch.zeros(shape, dtype=torch.bool, device=device)
    if kind in ("and", "or"):
        m = _eval_filter(tpl[1], cols, params, shape, device, widths)
        for c in tpl[2:]:
            mc = _eval_filter(c, cols, params, shape, device, widths)
            m = (m & mc) if kind == "and" else (m | mc)
        return m
    if kind == "not":
        return ~_eval_filter(tpl[1], cols, params, shape, device, widths)
    if kind == "eq_dict":
        return mask_ops.eq_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "in_dict":
        return mask_ops.in_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "range_dict":
        return mask_ops.range_dict(
            _ids_col(cols, tpl[1]), params[tpl[2]], params[tpl[3]])
    if kind == "lut_dict":
        return mask_ops.lut_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "eq_raw":
        return mask_ops.eq_raw(
            _eval_expr(tpl[1], cols, params, widths), params[tpl[2]])
    if kind == "in_raw":
        return mask_ops.in_raw(
            _eval_expr(tpl[1], cols, params, widths), params[tpl[2]])
    if kind == "range_raw":
        _, expr_tpl, klo, khi, has_lo, has_hi, lo_inc, hi_inc = tpl
        return mask_ops.range_raw(
            _eval_expr(expr_tpl, cols, params, widths), params[klo],
            params[khi], lo_inc, hi_inc, has_lo, has_hi,
        )
    raise AssertionError(f"bad filter template node {kind}")


def _sum_operand(argt, cols, params, widths):
    """(values, FOR offset or None) of one SUM/AVG argument for K1: a bare
    column's plane AS STORED, with the frame-of-reference offset
    ``_data_col`` would add (K1 adds it in registers; the offset stays on
    the card), or an expression evaluated as torch ops."""
    key = {"raw": argt[1], "dictval": "dv::" + argt[1]}.get(argt[0])
    if key is not None and key in cols:
        w = (widths or {}).get(key)
        return cols[key], (params["fo::" + key] if w and w[3] and w[2]
                           else None)
    return _eval_expr(argt, cols, params, widths), None


def _try_mm_groupby(aggs, gid, cols, params, num_groups, outs, widths,
                    min_rows: int):
    """Route COUNT/SUM/AVG through ONE K1 launch when eligible: the
    partitioned entry (ops/group_scatter.py plane_group_sums) when
    ``sums_supported``, else the single-accumulator entry
    (ops/groupby_mm.py group_sums) when ``mm_supported`` — the reference's
    pallas-tier routing. K1 reads each bare column's plane as stored and
    splits it in registers: no channel tensor is built. Fills
    outs["gcount"] + outs[f"a{i}_sum"] and returns the set of agg indexes
    handled; the torch scatters cover the rest."""
    if gid.numel() < min_rows:
        return set()
    plans = []  # (i, PlaneSource)
    total_ch = 1  # the count channel
    for i, (name, argt, extra) in enumerate(aggs):
        if name not in ("sum", "avg"):
            continue
        nplanes_int = extra[0]  # extra = (nplanes, rows per block)
        v, plus = _sum_operand(argt, cols, params, widths)
        if v.shape != gid.shape or not v.is_contiguous():  # e.g. SUM(3)
            v = torch.broadcast_to(v, gid.shape).contiguous()
        if v.is_floating_point():
            src = kernels.PlaneSource(v.to(torch.float32), "float")
        elif nplanes_int is None:  # unknown range → exact scatter instead
            continue
        else:
            if v.dtype not in kernels.K1_INT_DTYPES:
                v = v.to(torch.int64)
            src = kernels.PlaneSource(v, "int", nplanes_int, plus,
                                      params[f"off{i}"])
        if total_ch + src.nplanes > mm.MAX_CHANNELS + 1:
            continue
        plans.append((i, src))
        total_ch += src.nplanes
    use_ps = ps.sums_supported(num_groups, total_ch)
    if not use_ps and not mm.mm_supported(num_groups, total_ch - 1):
        return set()
    if not plans and not any(a[0] in ("count", "avg") for a in aggs):
        return set()

    entry = ps.plane_group_sums if use_ps else mm.group_sums
    sums = entry(gid.reshape(-1), [src for _i, src in plans], num_groups,
                 count=True)
    gcount = torch.round(sums[0]).to(torch.int64)
    outs["gcount"] = gcount
    done = set()
    row = 1
    for i, src in plans:
        planes = [sums[j] for j in range(row, row + src.nplanes)]
        outs[f"a{i}_sum"] = mm.recombine_int(planes, gcount, params[f"off{i}"]) \
            if src.kind == "int" else mm.recombine_float(planes)
        done.add(i)
        row += src.nplanes
    return done


def _group_extreme(gid, v, num_groups: int, ops: tuple, min_rows: int):
    """Per-group min/max: K2 (ops/group_scatter.py group_minmax) when the
    value dtype and group count are in its regime, else the torch
    scatter. Empty-group fills come from the ORIGINAL value dtype's
    extremes on both paths, so results are bit-identical."""
    if ps.minmax_supported(num_groups, v.dtype) and v.numel() >= min_rows:
        if v.is_floating_point():
            fills = tuple(agg_ops.POS_INF if op == "min" else agg_ops.NEG_INF
                          for op in ops)
        else:
            info = torch.iinfo(v.dtype)
            fills = tuple(info.max if op == "min" else info.min for op in ops)
        res = ps.group_minmax(gid, v, num_groups, ops, fills=fills)
        return tuple(r.to(v.dtype) for r in res)
    return tuple(
        agg_ops.group_min(gid, v, num_groups) if op == "min"
        else agg_ops.group_max(gid, v, num_groups) for op in ops)


def _hll_regs(h, gid, mask, num_groups: int, log2m: int, min_rows: int):
    """(num_groups, m) int8 HLL registers from the int32 hash plane ``h``,
    the group ids (None: one group) and the mask (None: ``gid`` carries
    it as the overflow id): K3 through the small-slot entry
    (ops/group_scatter.py, the reference's presence kernel) when the slot
    space is in its regime, else through the group entry
    (ops/groupby_mm.py hll_registers, the reference's rho-mode kernel) —
    both split the hashes in the kernel — else the torch scatter-max over
    ``hll_slots``; all the exact max of rho, so bit-identical. int8 holds
    every rho (<= 33 - log2m) and keeps the register plane a quarter of
    int32's size."""
    m = 1 << log2m
    nslots = num_groups * m
    if h.numel() >= min_rows:
        if ps.hll_supported(nslots, mm.hll_nrho(log2m)):
            regs = ps.hll_register_max(h, log2m, num_groups=num_groups,
                                       gid=gid, mask=mask)
            return regs.reshape(num_groups, m).to(torch.int8)
        if mm.hll_supported(num_groups, log2m):
            return mm.hll_registers(h, gid, num_groups, log2m,
                                    mask=mask).to(torch.int8)
    slot, rho = hll_ops.hll_slots(h, log2m, num_groups, gid, mask)
    regs = agg_ops.slot_max(slot, rho, nslots)
    return regs.reshape(num_groups, m).to(torch.int8)


def _hll_sums_from_sorted(sk, num_groups: int, log2m: int):
    """(3, G) float64 scaled register sums from SORTED packed keys
    (slot << 5 | rho): each slot's run ends at its max rho; three bf16
    power-of-two channels over the run ends go through ONE launch of K1's
    single-accumulator entry (ops/groupby_mm.py group_sums), which takes
    each as it is. See ops/hll.py ``estimate_from_sums_torch`` for why the
    sums are exact."""
    m = 1 << log2m
    rho_max = 33 - log2m
    split = rho_max // 2
    slot_s = sk >> 5
    e = torch.ones_like(slot_s, dtype=torch.bool)
    e[:-1] = slot_s[1:] != slot_s[:-1]
    valid = slot_s < num_groups * m  # masked rows pack the overflow slot
    e &= valid
    rho_s = (sk & 31).to(torch.float32)
    gid_s = torch.where(valid, slot_s >> log2m, num_groups).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=sk.device)
    chans = (e, torch.where(e & (rho_s <= split), torch.exp2(split - rho_s),
                            zero),
             torch.where(e & (rho_s > split), torch.exp2(rho_max - rho_s),
                         zero))
    return mm.group_sums(gid_s, [kernels.PlaneSource(c.to(torch.bfloat16),
                                                     "bf16") for c in chans],
                         num_groups)


def _hll_sorted_sums(slot, rho, num_groups: int, log2m: int):
    """TERMINAL-only register-free HLL build for group counts too large
    for the register kernel's regime: chunk-local sorts of packed
    (slot << 5 | rho) int32 keys dedupe (register, rank) pairs down to
    per-slot maxima (ops/radix_groupby.py hll_chunked_sorted_keys), then
    ``_hll_sums_from_sorted``. Not mergeable (one slot on two batches
    would count twice), hence terminal-only; filterless queries skip the
    sort through the batch's cached sorted projection
    (BatchContext.sorted_hll_keys)."""
    key = (slot.reshape(-1).to(torch.int32) << 5) \
        | rho.reshape(-1).to(torch.int32)
    sk = radix_ops.hll_chunked_sorted_keys(key, num_groups * (1 << log2m))
    return _hll_sums_from_sorted(sk, num_groups, log2m)


def _hll_sort_eligible(final: bool, num_groups: int, log2m: int) -> bool:
    """The reference's gate for the sorted terminal HLL build, shared by
    the pipeline and the executor's column resolution: terminal, past
    the register kernel's regime, packed keys fit int32, and the three
    sums fit K1's single accumulator."""
    m = 1 << log2m
    return (final and not mm.hll_supported(num_groups, log2m)
            and num_groups * m < (1 << 26)
            and mm.mm_supported(num_groups, 3))


def _finalize_sketch_outs(outs: dict, agg_tpls) -> None:
    """TERMINAL finalize on the card, in place: distinct presence →
    int64 popcounts, HLL registers or sorted sums → int64 estimates, so
    only answer-sized arrays are copied to the host."""
    for i, (name, _argt, extra) in enumerate(agg_tpls):
        k = f"a{i}"
        if name == "distinctcount":
            outs[f"{k}_cnt"] = outs.pop(f"{k}_pres").sum(dim=-1,
                                                          dtype=torch.int64)
        elif name == "distinctcounthll" and f"{k}_hs" in outs:
            outs[f"{k}_est"] = hll_ops.estimate_from_sums_torch(
                outs.pop(f"{k}_hs"), extra)
        elif name == "distinctcounthll":
            regs = outs.pop(f"{k}_regs")
            est = hll_ops.estimate_torch(regs.reshape(-1, 1 << extra))
            outs[f"{k}_est"] = est[0] if regs.dim() == 1 else est


def _fused_params(plan, params, widths) -> dict:
    """K4's literals: id-space params as int32; raw-space params shifted
    into the plane's storage space (minus its "fo::" offset) and clipped
    to the storage dtype's range ±1, in int64 before the int32 cast —
    storage values are a strict subset, so every comparison survives."""
    out = {}
    for key, (ck, kindp) in plan.pred_params.items():
        p = params[key].reshape(-1)
        if kindp == "storage":
            w = widths[ck]
            p64 = p.to(torch.int64)
            if w[2] and "fo::" + ck in params:
                p64 = p64 - params["fo::" + ck].to(torch.int64)
            info = np.iinfo(np.dtype(w[0]))
            p = torch.clamp(p64, int(info.min) - 1, int(info.max) + 1)
        out[key] = p.to(torch.int32)
    return out


def _fused_outs(plan, ints, flts, params, widths, outs) -> None:
    """K4's per-candidate partials → the dense form's leaves, in place.
    K4 aggregates STORAGE values; decode applies at answer scale —
    Σ(v + fo) = Σv + fo·n and min(v + fo) = min(v) + fo are exact — and
    an empty int extreme takes the wide dtype's fill, so dtypes and
    values equal the dense form's."""
    dc = outs["doc_count"]
    for (i, op, ck, buf, slot, _fill) in plan.aggs:
        key = f"a{i}_{op}"
        w = widths[ck]
        wide = _torch_dtype(w[3] or w[0])
        fo = params.get("fo::" + ck) if w[2] else None
        if op == "sum":
            tot = ints[:, slot].to(torch.int64).sum()
            outs[key] = tot if fo is None else tot + fo.to(torch.int64) * dc
        elif buf == "int":
            col = ints[:, slot]
            red = (col.min() if op == "min" else col.max()).to(wide)
            if fo is not None:
                red = red + fo
            info = torch.iinfo(wide)
            empty = torch.full((), info.max if op == "min" else info.min,
                               dtype=wide, device=red.device)
            outs[key] = torch.where(dc > 0, red, empty)
        else:
            col = flts[:, slot]
            outs[key] = (col.min() if op == "min" else col.max()).to(wide)


def build_pipeline(template, widths=None, min_rows: int = ps.PALLAS_MIN_ROWS,
                   blockskip: bool = False):
    """template → fn(cols, n_docs, params) → outputs dict of tensors.

    ``widths``: the batch's column width plan {cols key: ColPlan.sig()}.
    ``min_rows``: batches below this row count take the torch scatters
    instead of the kernels (the reference's PALLAS_MIN_ROWS gate; the CPU
    tests pass 0 to reach the kernels' plain versions, as the reference's
    interpret mode ignores its gate). ``blockskip``: the filter's zone
    maps ride in ``cols`` (``zlo::`` / ``zhi::`` keys) and the pipeline
    takes the block-skip forms while the candidates fit the bound.

    Every form emits the same stat leaves (``_stat_outs``) and agrees
    with the dense form exactly."""
    shape, filter_tpl, group_cols, group_cards, aggs, final = template
    if shape not in ("agg", "groupby"):
        raise DeviceUnsupported(f"pipeline shape {shape}")
    num_groups = math.prod(group_cards)
    fused_plan = None
    # K4 reads one zone block per candidate: a retuned ZONE_BLOCK_ROWS
    # must decline the plan, not read a prefix of every block
    if blockskip and shape == "agg" \
            and bs_ops.BLOCK_ROWS == ps.FUSED_BLOCK_ROWS:
        fused_plan = ps.plan_fused(filter_tpl, aggs, widths or {})

    def pipeline(cols, n_docs, params):
        # zone maps are (S, NB) and sorted projections (sk::) 1-D: any
        # other plane gives (S, L)
        data_cols = {k: v for k, v in cols.items()
                     if not k.startswith((bs_ops.ZLO, bs_ops.ZHI))}
        S, L = next(v for k, v in data_cols.items()
                    if not k.startswith("sk::")).shape
        dev = n_docs.device
        alive = params.get("ps_alive")
        alive_b = torch.ones(S, dtype=torch.bool, device=dev) \
            if alive is None else alive.to(torch.bool)
        nd64 = n_docs.to(torch.int64)
        R = bs_ops.BLOCK_ROWS

        def _stat_outs(seg_matched, rows_filter, blocks_total,
                       blocks_scanned):
            return {
                "doc_count": seg_matched.sum(),
                "seg_matched": seg_matched,
                "n_alive": alive_b.sum(dtype=torch.int64),
                "rows_filter": rows_filter,
                "blocks_total": blocks_total,
                "blocks_scanned": blocks_scanned,
            }

        def _aggregate(rows_cols, mask, outs):
            if shape == "groupby":
                _groupby(rows_cols, params, mask, outs)
            else:
                _scalar(rows_cols, params, mask, outs)
            if final:
                _finalize_sketch_outs(outs, aggs)
            return outs

        def dense(blocks_total):
            valid = mask_ops.valid_mask(n_docs, L) & alive_b[:, None]
            mask = _eval_filter(filter_tpl, data_cols, params, (S, L), dev,
                                widths) & valid
            outs = _stat_outs(
                mask.sum(dim=1, dtype=torch.int64),
                torch.where(alive_b, nd64, 0).sum(), blocks_total,
                blocks_total)
            return _aggregate(data_cols, mask, outs)

        if not blockskip or L % R:
            return dense(torch.zeros((), dtype=torch.int64, device=dev))

        # ---- zone-map block skip (ops/blockskip.py) ----------------------
        NB = L // R
        blocks_total = torch.where(alive_b, (nd64 + R - 1) // R, 0).sum()
        verdict = bs_ops.zone_verdict(filter_tpl, cols, params, (S, NB),
                                      widths)
        block_start = torch.arange(NB, dtype=torch.int64, device=dev) * R
        verdict = verdict & (block_start[None, :] < nd64[:, None]) \
            & alive_b[:, None]
        flat = verdict.reshape(-1)
        total = S * NB
        B = min(total, max(1, -(-total // bs_ops.CAND_FRACTION)))
        n_cand = flat.sum(dtype=torch.int64)
        # the reference picks the form on the device (lax.cond); eager
        # torch reads the candidate count to the host: one scalar sync
        if int(n_cand) > B:
            return dense(blocks_total)
        cand, cand_valid = bs_ops.compact_candidates(flat, B)
        seg_of = (cand // NB).long()
        block_row0 = (cand % NB).long() * R
        seg_slot = torch.where(cand_valid, seg_of, S)

        def seg_sums(block_matched):
            return torch.zeros(S + 1, dtype=torch.int64, device=dev) \
                .index_add_(0, seg_slot, block_matched)[:S]

        if fused_plan is not None and ps.fused_params_ok(fused_plan, params):
            # K4 (ops/group_scatter.py): the gather buffer of the generic
            # form never exists
            rows_in = torch.where(
                cand_valid, torch.clamp(nd64[seg_of] - block_row0, 0, R),
                0).to(torch.int32)
            ints, flts = ps.fused_filter_agg(
                cand, rows_in,
                {k: data_cols[k].reshape(S * NB, R) for k in fused_plan.cols},
                _fused_params(fused_plan, params, widths), fused_plan)
            outs = _stat_outs(seg_sums(ints[:, 0].to(torch.int64)),
                              rows_in.sum(dtype=torch.int64), blocks_total,
                              n_cand)
            _fused_outs(fused_plan, ints, flts, params, widths, outs)
            return outs
        row_idx = block_row0[:, None] \
            + torch.arange(R, dtype=torch.int64, device=dev)[None, :]
        rvalid = cand_valid[:, None] & (row_idx < nd64[seg_of][:, None])
        g_cols = {k: bs_ops.gather_blocks(v, cand, NB, R)
                  for k, v in data_cols.items()}
        mask = _eval_filter(filter_tpl, g_cols, params, (B, R), dev,
                            widths) & rvalid
        outs = _stat_outs(seg_sums(mask.sum(dim=1, dtype=torch.int64)),
                          rvalid.sum(dtype=torch.int64), blocks_total, n_cand)
        return _aggregate(g_cols, mask, outs)

    def _group_hll(k, argt, log2m, gid, mask, cols, outs):
        sort = _hll_sort_eligible(final, num_groups, log2m)
        sk_key = f"sk::{argt}::{log2m}"
        if sort and filter_tpl == ("true",) and sk_key in cols:
            # filterless: the batch's cached sorted projection already
            # holds the packed keys, no per-query sort
            outs[f"{k}_hs"] = _hll_sums_from_sorted(cols[sk_key], num_groups,
                                                    log2m)
            return
        h = cols["hh::" + argt]
        if sort:
            slot, rho = hll_ops.hll_slots(h, log2m, num_groups, gid, mask)
            outs[f"{k}_hs"] = _hll_sorted_sums(slot, rho, num_groups, log2m)
        else:
            # gid carries the mask (masked rows hold the overflow id)
            outs[f"{k}_regs"] = _hll_regs(h, gid, None, num_groups, log2m,
                                          min_rows)

    def _groupby(cols, params, mask, outs):
        # columns are already global ids: the group key IS the column
        per_col = [cols[c] for c in group_cols]
        gid = agg_ops.group_ids_combine(per_col, group_cards, mask,
                                        num_groups)
        done = _try_mm_groupby(aggs, gid, cols, params, num_groups, outs,
                               widths, min_rows)
        if "gcount" not in outs:
            outs["gcount"] = agg_ops.group_count(gid, num_groups)
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if i in done or name == "count":
                continue
            if name == "distinctcount":
                sub = torch.clamp(_ids_col(cols, argt), 0, extra - 1)
                cell = torch.where(mask, gid * extra + sub, num_groups * extra)
                outs[f"{k}_pres"] = agg_ops.distinct_presence(
                    cell, num_groups * extra).reshape(num_groups, extra)
                continue
            if name == "distinctcounthll":
                _group_hll(k, argt, extra, gid, mask, cols, outs)
                continue
            v = _eval_expr(argt, cols, params, widths)
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = agg_ops.group_sum(gid, v, num_groups)
            elif name == "minmaxrange":
                outs[f"{k}_min"], outs[f"{k}_max"] = _group_extreme(
                    gid, v, num_groups, ("min", "max"), min_rows)
            else:  # min / max
                outs[f"{k}_{name}"], = _group_extreme(
                    gid, v, num_groups, (name,), min_rows)

    def _scalar(cols, params, mask, outs):
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if name == "count":
                continue  # doc_count reused
            if name == "distinctcount":
                sub = torch.clamp(_ids_col(cols, argt), 0, extra - 1)
                outs[f"{k}_pres"] = agg_ops.distinct_presence(
                    torch.where(mask, sub, extra), extra)
                continue
            if name == "distinctcounthll":
                outs[f"{k}_regs"] = _hll_regs(cols["hh::" + argt], None,
                                              mask, 1, extra, min_rows)[0]
                continue
            v = _eval_expr(argt, cols, params, widths)
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = agg_ops.agg_sum(v, mask)
            if name in ("min", "minmaxrange"):
                outs[f"{k}_min"] = agg_ops.agg_min(v, mask)
            if name in ("max", "minmaxrange"):
                outs[f"{k}_max"] = agg_ops.agg_max(v, mask)

    return pipeline


def _neutral_outs(pipeline, cols, params, S: int) -> dict:
    """Outputs of a FULLY pruned launch, computed on the host: the dense
    form over one row of the batch with every segment dead gives each
    leaf the exact fill the card's kernels give under an all-false mask;
    ``seg_matched`` widens back to the batch's S segments."""
    one = {k: v[:1, :1].cpu() for k, v in cols.items()
           if not k.startswith((bs_ops.ZLO, bs_ops.ZHI))}
    host_params = {k: v.cpu() for k, v in params.items()}
    host_params["ps_alive"] = torch.zeros(1, dtype=torch.bool)
    outs = pipeline(one, torch.zeros(1, dtype=torch.int32), host_params)
    outs["seg_matched"] = torch.zeros(S, dtype=torch.int64)
    return outs


def _needed_columns(tpl) -> set:
    out = set()

    def walk(t):
        if not isinstance(t, tuple):
            return
        if t[0] == "raw":
            out.add(t[1])
            return
        if t[0] == "dictval":
            out.add("dv::" + t[1])
            return
        if t[0] in ("eq_dict", "in_dict", "range_dict", "lut_dict"):
            out.add(t[1])
        for x in t[1:]:
            walk(x)

    walk(tpl)
    return out


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class Launch:
    """A dispatched pipeline: its template, batch and device outputs."""

    def __init__(self, q, ctx, template, outs):
        self.q, self.ctx, self.template, self.outs = q, ctx, template, outs


class DeviceExecutor:
    MAX_CACHED_BATCHES = 4  # LRU cap: a batch holds its columns on the card

    def __init__(self, device=None, num_groups_limit: int = 100_000,
                 min_rows: int = ps.PALLAS_MIN_ROWS):
        self.device = resolve_device(device)
        self.num_groups_limit = max(1, num_groups_limit)
        self.min_rows = min_rows
        self._batches: dict = {}  # segment-dir tuple -> BatchContext (LRU)
        self._pruner = None  # engine.SegmentPruner, made at first use

    def batch_for(self, segments) -> BatchContext:
        key = tuple(s.dir for s in segments)
        ctx = self._batches.pop(key, None)
        if ctx is None:
            ctx = BatchContext(segments, self.device)
        self._batches[key] = ctx
        while len(self._batches) > self.MAX_CACHED_BATCHES:
            self._batches.pop(next(iter(self._batches)))
        return ctx

    def _agg_template(self, i: int, a: Expression, ctx: BatchContext,
                      params, counter):
        name = a.name
        if name in DISTINCTCOUNT_ALIASES:
            name = "distinctcount"
        if name in LATER_AGGS:
            raise DeviceUnsupported(
                f"{name}: the {LATER_AGGS[name]} aggregations come with a "
                f"later slice of the port")
        if name not in DEVICE_AGGS:
            raise DeviceUnsupported(f"aggregation {name} not on device")
        if name == "count":
            return ("count", None, None)
        if name in SKETCH_AGGS:
            arg = a.args[0]
            if not arg.is_identifier \
                    or ctx.encoding(arg.name) != Encoding.DICT:
                raise DeviceUnsupported(f"{name} needs a dict column on "
                                        f"the device")
            if name == "distinctcount":
                return (name, arg.name, ctx.cardinality(arg.name))
            return (name, arg.name, aggspec.make_spec(a).log2m)
        argt = build_expr(a.args[0], ctx, params, counter)
        if name not in ("sum", "avg"):
            return (name, argt, None)
        # metadata interval arithmetic sizes the kernel's byte planes and
        # bounds the fused plan's per-block int32 partials
        nplanes = rpb = None
        bounds = expr_bounds(a.args[0], ctx)
        if bounds is not None:
            rpb = agg_ops.rows_per_block_for(max(abs(bounds[0]),
                                                 abs(bounds[1])))
            nplanes = mm.int_planes_needed(bounds[0], bounds[1])
            params[f"off{i}"] = torch.tensor(
                math.floor(bounds[0]), dtype=torch.int64, device=ctx.device)
        return (name, argt, (nplanes, rpb))

    def launch(self, q: QueryContext, segments, final: bool = False) -> Launch:
        """Template build + column upload (cached per segment set) + the
        pipeline's torch ops and kernel launches, enqueued on the current
        stream. ``final``: the launch is terminal (nothing merges after
        it), so distinct counts and HLL finalize on the card. Raises
        DeviceUnsupported for shapes this slice does not run on the
        device.

        Level 1: segments the SegmentPruner proves empty stay in the
        batch, dead (``ps_alive``); when every segment is pruned nothing
        runs on the card. Level 2: a filter with interval structure takes
        the block-skip forms unless ``SET useBlockSkip = false``."""
        aggs = q.aggregations()
        if q.distinct:
            raise DeviceUnsupported("DISTINCT comes with a later slice of "
                                    "the port")
        if not aggs:
            raise DeviceUnsupported("selection queries come with a later "
                                    "slice of the port")
        for s in segments:
            if getattr(s, "is_mutable", False) \
                    or getattr(s, "valid_docs_mask", None) is not None:
                raise DeviceUnsupported("consuming/upsert segments come with "
                                        "a later slice of the port")
        ctx = self.batch_for(segments)
        params: dict = {}
        counter = [0]
        filter_tpl = ("true",) if q.filter is None else build_filter(
            q.filter, ctx, params, counter)

        group_cols, group_cards = [], []
        for g in q.group_by or ():
            if not g.is_identifier or ctx.encoding(g.name) != Encoding.DICT:
                raise DeviceUnsupported(
                    "group-by must be dict columns on device")
            group_cols.append(g.name)
            group_cards.append(ctx.cardinality(g.name))
        if math.prod(group_cards) > MAX_DENSE_GROUPS:
            raise DeviceUnsupported(
                "group counts past the dense regime run in the sorted "
                "regime, which comes with a later slice of the port")
        agg_tpls = tuple(self._agg_template(i, a, ctx, params, counter)
                         for i, a in enumerate(aggs))
        num_groups = math.prod(group_cards)
        for name, _argt, extra in agg_tpls:
            if group_cols and name in SKETCH_AGGS:
                cells = num_groups * (extra if name == "distinctcount"
                                      else 1 << extra)
                if cells > MAX_PRESENCE_CELLS:
                    raise DeviceUnsupported(
                        f"{name} per-group state too large ({cells})")
        final = final and any(name in SKETCH_AGGS for name, _, _ in agg_tpls)
        template = ("groupby" if group_cols else "agg", filter_tpl,
                    tuple(group_cols), tuple(group_cards), agg_tpls, final)

        opts = q.options_ci()
        # Level-2 eligibility: the filter has interval structure the zone
        # maps can act on, the batch is block-aligned, and the query did
        # not opt out (SET useBlockSkip = false, the force-dense form)
        use_bs, zone_cols = False, set()
        if filter_tpl[0] not in ("true", "false") \
                and bool_option(opts, "useblockskip", None) is not False \
                and ctx.pad_to % bs_ops.BLOCK_ROWS == 0:
            prunable, zone_cols = bs_ops.prunable_columns(filter_tpl)
            use_bs = prunable and bool(zone_cols)
        # Level 1: the filter tree against each segment's column stats;
        # a per-query vector param, pruned segments stay in the batch
        alive = np.ones(ctx.S, dtype=bool)
        if q.filter is not None:
            if self._pruner is None:
                from pinot_tpu_torch.engine.engine import SegmentPruner

                self._pruner = SegmentPruner()
            for j, s in enumerate(segments):
                alive[j] = not self._pruner.prune(q, s)
        params["ps_alive"] = to_device(alive, ctx.device)

        # SET useSortedProjection = false keeps the per-query sort (the
        # cold form); by default a filterless terminal HLL group-by reads
        # the batch's cached sorted projection
        sorted_proj_ok = bool_option(opts, "usesortedprojection",
                                     None) is not False
        needed = _needed_columns(filter_tpl) | set(group_cols)
        for zc in zone_cols if use_bs else ():
            needed |= {bs_ops.ZLO + zc, bs_ops.ZHI + zc}
        for name, argt, extra in agg_tpls:
            if name == "distinctcount":
                needed.add(argt)
            elif name == "distinctcounthll":
                if (group_cols and filter_tpl == ("true",) and sorted_proj_ok
                        and _hll_sort_eligible(final, num_groups, extra)):
                    needed.add(f"sk::{argt}::{extra}")
                else:
                    needed.add("hh::" + argt)
            elif argt is not None:
                needed |= _needed_columns(argt)
        if not needed:  # COUNT(*) no filter: one column carries the shape
            needed.add(segments[0].column_names()[0])
        widths, cols = {}, {}
        for c in sorted(needed):
            if c.startswith((bs_ops.ZLO, bs_ops.ZHI)):
                lo_hi = ctx.zone_map(c[len(bs_ops.ZLO):])
                cols[c] = lo_hi[c.startswith(bs_ops.ZHI)]
                continue
            if c.startswith("sk::"):
                _, colname, l2m = c.split("::")
                cols[c] = ctx.sorted_hll_keys(group_cols, group_cards,
                                              colname, int(l2m))
                continue
            if c.startswith("hh::"):
                cols[c] = ctx.prehashed_column(c[4:])
                continue
            plan = ctx.width_plan(c)
            widths[c] = plan.sig()
            if plan.offset is not None:
                params["fo::" + c] = to_device(
                    np.asarray(plan.offset, dtype=np.dtype(plan.wide)),
                    ctx.device)
            cols[c] = ctx.decoded_column(c[4:]) if c.startswith("dv::") \
                else ctx.column(c)
        if not alive.any():
            # FULLY pruned: nothing runs on the card
            outs = _neutral_outs(build_pipeline(template, widths,
                                                self.min_rows),
                                 cols, params, ctx.S)
            return Launch(q, ctx, template, outs)
        outs = build_pipeline(template, widths, self.min_rows, use_bs)(
            cols, ctx.n_docs_dev, params)
        return Launch(q, ctx, template, outs)

    def fetch(self, launch: Launch) -> IntermediateResult:
        """Device outputs → host numpy → canonical IntermediateResult."""
        outs = {k: v.cpu().numpy() for k, v in launch.outs.items()}
        return self._to_intermediate(launch.q, launch.ctx, launch.template,
                                     outs)

    def execute(self, q: QueryContext, segments,
                final: bool = False) -> IntermediateResult:
        return self.fetch(self.launch(q, segments, final))

    # ---- device outputs → canonical IntermediateResult -------------------
    def _to_intermediate(self, q, ctx: BatchContext, template, outs):
        shape, _, group_cols, group_cards, agg_tpls, _final = template
        doc_count = int(outs["doc_count"])
        # honest under pruning, as the reference: entries count only the
        # alive segments' rows, and only the gathered blocks' rows when a
        # block-skip form ran; pruned segments still count in totalDocs
        n_alive = int(outs["n_alive"])
        entries_in_filter = 0
        if q.filter is not None:
            entries_in_filter = int(outs["rows_filter"]) \
                * len(q.filter.columns())
        entries_post = sum(
            doc_count * len(aggspec.make_spec(a).args)
            for a in q.aggregations())
        stats = ExecutionStats(
            num_docs_scanned=doc_count,
            num_entries_scanned_in_filter=entries_in_filter,
            num_entries_scanned_post_filter=entries_post,
            num_segments_processed=n_alive,
            num_segments_queried=ctx.S,
            num_segments_matched=int((outs["seg_matched"] > 0).sum()),
            num_segments_pruned=ctx.S - n_alive,
            num_blocks_pruned=int(outs["blocks_total"])
            - int(outs["blocks_scanned"]),
            total_docs=int(ctx.n_docs.sum()),
        )
        if shape == "agg":
            partials = [self._scalar_partial(i, t, outs, ctx)
                        for i, t in enumerate(agg_tpls)]
            return IntermediateResult("aggregation", agg_partials=partials,
                                      stats=stats)

        # numGroupsLimit (engine default or per-query SET override):
        # excess groups drop in gid order, and the stats flag says so
        opts = q.options_ci()
        limit = self.num_groups_limit
        if "numgroupslimit" in opts:
            limit = max(1, int(opts["numgroupslimit"]))
        present = np.nonzero(outs["gcount"] > 0)[0]
        if len(present) > limit:
            present = present[:limit]
            stats.num_groups_limit_reached = True
        # decode the combined key (the gid) → per-column global ids → values
        rem = present.copy()
        keys = []
        for card in reversed(group_cards[1:]):
            keys.append(rem % card)
            rem = rem // card
        keys.append(rem)
        keys.reverse()
        key_values = tuple(ctx.global_dict(col).take(k)
                           for col, k in zip(group_cols, keys))
        partials = [self._group_partial(i, t, outs, ctx, present)
                    for i, t in enumerate(agg_tpls)]
        return IntermediateResult("group_by", group_keys=key_values,
                                  agg_partials=partials, stats=stats)

    @staticmethod
    def _scalar_partial(i, tpl, outs, ctx):
        name, argt, _extra = tpl
        k = f"a{i}"

        def one(key, dt=np.float64):
            return np.asarray([outs[key]], dtype=dt)

        if name == "count":
            return {"count": one("doc_count", np.int64)}
        if name == "sum":
            return {"sum": one(f"{k}_sum")}
        if name == "avg":
            return {"sum": one(f"{k}_sum"),
                    "count": one("doc_count", np.int64)}
        if name == "min":
            return {"min": one(f"{k}_min")}
        if name == "max":
            return {"max": one(f"{k}_max")}
        if name == "minmaxrange":
            return {"min": one(f"{k}_min"), "max": one(f"{k}_max")}
        if name == "distinctcount":
            if f"{k}_cnt" in outs:  # terminal: popcount came from the card
                return {"cnt": one(f"{k}_cnt", np.int64)}
            vals = ctx.global_dict(argt).take(np.nonzero(outs[f"{k}_pres"])[0])
            sets = np.empty(1, dtype=object)
            sets[0] = set(np.asarray(vals).tolist())
            return {"sets": sets}
        if f"{k}_est" in outs:  # distinctcounthll, terminal
            return {"est": one(f"{k}_est", np.int64)}
        return {"regs": outs[f"{k}_regs"].reshape(1, -1)}

    @staticmethod
    def _group_partial(i, tpl, outs, ctx, present):
        name, argt, _extra = tpl
        k = f"a{i}"

        def sel(key, dt=np.float64):
            return outs[key][present].astype(dt)

        if name == "count":
            return {"count": sel("gcount", np.int64)}
        if name == "sum":
            return {"sum": sel(f"{k}_sum")}
        if name == "avg":
            return {"sum": sel(f"{k}_sum"),
                    "count": sel("gcount", np.int64)}
        if name == "min":
            return {"min": sel(f"{k}_min")}
        if name == "max":
            return {"max": sel(f"{k}_max")}
        if name == "minmaxrange":
            return {"min": sel(f"{k}_min"), "max": sel(f"{k}_max")}
        if name == "distinctcount":
            if f"{k}_cnt" in outs:  # terminal: popcounts came from the card
                return {"cnt": sel(f"{k}_cnt", np.int64)}
            pres = outs[f"{k}_pres"][present]
            gvals = np.asarray(ctx.global_dict(argt).values)
            sets = np.empty(len(present), dtype=object)
            for j in range(len(present)):
                sets[j] = set(gvals[np.nonzero(pres[j])[0]].tolist())
            return {"sets": sets}
        if f"{k}_est" in outs:  # distinctcounthll, terminal
            return {"est": sel(f"{k}_est", np.int64)}
        return {"regs": outs[f"{k}_regs"][present]}
