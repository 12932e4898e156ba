"""Coalesced cohorts: M queries of one template over one batch as ONE
launch per kernel.

Counterpart of the reference's vmapped cohort pipeline
(pinot_tpu/engine/device.py ``_cohort_launch`` / ``_cohort_pipeline``):
there ``jax.vmap`` stacks the members' params on a leading axis and every
``pallas_call`` gains a batched grid axis. Here the members' params stack
on a leading member axis too, and the pipeline runs over it:

- the torch ops before and after the kernels (filter masks, zone
  verdicts, candidate compaction, the group-id combine, the device trim,
  the sketch finalize) run on the stacked axis, through
  ``torch.func.vmap`` where the solo code takes one member's params;
- each kernel runs ONCE for the cohort through its member-axis entry
  (ops/kernels.py ``*_members``): K1 ``group_plane_sums_members``, K2
  ``group_minmax_members``, K3 ``hll_register_max_members``, K4
  ``fused_filter_agg_members``. Which kernel a leaf takes, and when the
  torch scatter takes it instead, is decided once, by the solo
  pipeline's routing helpers in engine/device.py (``_try_mm_groupby``,
  ``_group_extremes``, ``_hll_regs``, ``plan_fused``, and
  ops/blockskip.py's ``cand_bound`` / ``compact_candidates``), called
  here with the member axis.

Each member gets the stats of its solo run. Where the reference picks
the dense or the block-skip form per member on its device (``lax.cond``
under ``vmap``), the members' candidate counts come to the host in one
copy, and the cohort splits into a dense sub-cohort and a skip
sub-cohort, each one member-axis launch per kernel; K4's candidate lists
are each member's own, padded to the bound with the invalid candidate.

``cohort_supported`` names the templates a cohort covers: the ``agg`` and
``groupby`` shapes over COUNT / SUM / AVG / MIN / MAX / MINMAXRANGE /
DISTINCTCOUNT / DISTINCTCOUNTHLL whose arguments read no literal. The
sorted regime, the sorted terminal HLL build, FIRST/LASTWITHTIME, HLLMERGE
and the host path's shapes dispatch solo; their answers are the same.
"""

from __future__ import annotations

import math

import torch

from pinot_tpu_torch.engine import device as D
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import blockskip as bs_ops
from pinot_tpu_torch.ops import device_reduce as dr_ops
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import masks as mask_ops

COHORT_AGGS = ("count", "sum", "avg", "min", "max", "minmaxrange",
               "distinctcount", "distinctcounthll")

vmap = torch.func.vmap


def _reads(tpl, kinds) -> bool:
    """Whether a template tree holds a node of one of ``kinds``."""
    if not isinstance(tpl, tuple) or not tpl:
        return False
    if tpl[0] in kinds:
        return True
    return any(_reads(t, kinds) for t in tpl[1:])


def cohort_supported(template) -> bool:
    """Whether a template runs as a cohort (see the module docstring)."""
    shape, filter_tpl, _cols, group_cards, aggs, _k, final = template
    if shape not in ("agg", "groupby") or _reads(filter_tpl, ("mask",)):
        return False
    num_groups = math.prod(group_cards)
    for name, argt, extra in aggs:
        if name not in COHORT_AGGS:
            return False
        if name in ("sum", "avg", "min", "max", "minmaxrange") \
                and _reads(argt, ("lit", "val")):
            return False
        if name == "distinctcounthll" and shape == "groupby" \
                and D._hll_sort_eligible(final, num_groups, extra):
            return False
    return True


def split_params(members) -> tuple:
    """(the members' own params on a leading member axis, the params they
    share): a column's frame-of-reference offset (``fo::``) is the
    batch's, so it stays unstacked and a decode runs once, not per
    member."""
    shared = {k: v for k, v in members[0].items() if k.startswith("fo::")}
    return {k: torch.stack([m[k] for m in members]) for k in members[0]
            if k not in shared}, shared


def _select(pstack: dict, idx) -> dict:
    ix = torch.as_tensor(idx, dtype=torch.long,
                         device=next(iter(pstack.values())).device)
    return {k: v.index_select(0, ix) for k, v in pstack.items()}


def _member(pstack: dict, shared: dict, j: int) -> dict:
    """Member ``j``'s params, the shared ones with them."""
    return dict(shared, **{k: v[j] for k, v in pstack.items()})


def masked_extreme(values, mask, how: str):
    """Per member, the MIN or MAX of ``values`` where ``mask`` holds: the
    solo launch's ``agg_ops.agg_min`` / ``agg_max`` over each member's
    rows, floats on the same order keys (so -0.0 < +0.0)."""
    M = mask.shape[0]
    fill = agg_ops._extremes(values.dtype)[0 if how == "min" else 1]
    v = torch.where(mask, values, torch.full((), fill, dtype=values.dtype,
                                             device=values.device))
    v = v.reshape(M, -1)
    if values.dtype not in agg_ops._KEY_INTS:
        return v.amin(dim=1) if how == "min" else v.amax(dim=1)
    k = agg_ops._float_keys(v)
    return agg_ops._from_float_keys(k.amin(dim=1) if how == "min"
                                    else k.amax(dim=1), values.dtype)


# ---------------------------------------------------------------------------
# the pipeline over a member axis
# ---------------------------------------------------------------------------


def run(template, widths, min_rows: int, blockskip: bool, cols, n_docs,
        members, trim=None) -> list:
    """The cohort's outputs, one dict per member in join order, each the
    leaves its solo launch would give (trimmed and finalized as the solo
    launch is). ``members``: the members' params dicts, identical in keys,
    shapes and dtypes."""
    shape, filter_tpl, group_cols, group_cards, aggs, _k, final = template
    num_groups = math.prod(group_cards)
    M = len(members)
    pstack, shared = split_params(members)
    data_cols = {k: v for k, v in cols.items()
                 if not k.startswith((bs_ops.ZLO, bs_ops.ZHI))}
    planes = [v for k, v in data_cols.items() if not k.startswith("sk::")]
    S, L = planes[0].shape[:2]
    dev = n_docs.device
    nd64 = n_docs.to(torch.int64)
    alive = pstack["ps_alive"].to(torch.bool)          # (M, S)
    R = bs_ops.BLOCK_ROWS
    fused_plan = D.plan_fused(template, widths, blockskip)

    def stat_outs(alive_s, seg_matched, rows_filter, blocks_total,
                  blocks_scanned):
        return {"doc_count": seg_matched.sum(dim=1),
                "seg_matched": seg_matched,
                "n_alive": alive_s.sum(dim=1, dtype=torch.int64),
                "rows_filter": rows_filter,
                "blocks_total": blocks_total,
                "blocks_scanned": blocks_scanned}

    def dense(idx, blocks_total):
        sub = _select(pstack, idx)
        alive_s = alive[idx]
        valid = mask_ops.valid_mask(n_docs, L)[None] & alive_s[:, :, None]
        mask = vmap(lambda p: D.eval_filter(
            filter_tpl, data_cols, dict(shared, **p), (S, L), dev,
            widths))(sub) & valid
        outs = stat_outs(alive_s, mask.sum(dim=2, dtype=torch.int64),
                         torch.where(alive_s, nd64[None], 0).sum(dim=1),
                         blocks_total, blocks_total)
        return aggregate(data_cols, mask, sub, outs)

    def aggregate(rows_cols, mask, sub, outs):
        if shape == "groupby":
            groupby(rows_cols, mask, sub, outs)
        else:
            scalar(rows_cols, mask, sub, outs)
        if final:
            outs = vmap(lambda o: _finalized(o, aggs))(outs)
        return outs

    def groupby(rows_cols, mask, sub, outs):
        # the members' own params stacked, with the shared ones: the
        # routing helpers read each member's offsets on the leading axis
        # and the shared FOR offsets; cohort templates' arguments read no
        # literal (``cohort_supported``)
        pm = dict(shared, **sub)
        Mx = mask.shape[0]
        per_col = [rows_cols[c] for c in group_cols]
        gid = agg_ops.group_ids_combine(per_col, group_cards, mask,
                                        num_groups)
        done = D._try_mm_groupby(aggs, gid, rows_cols, pm, num_groups, outs,
                                 widths, min_rows, members=True)
        if "gcount" not in outs:
            outs["gcount"] = D.members_scatter(agg_ops.group_count, gid,
                                               num_groups)
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if i in done or name == "count":
                continue
            if name == "distinctcount":
                s = torch.clamp(D._ids_col(rows_cols, argt), 0, extra - 1)
                cell = torch.where(mask, gid * extra + s, num_groups * extra)
                outs[f"{k}_pres"] = D.members_scatter(
                    agg_ops.distinct_presence, cell,
                    num_groups * extra).reshape(Mx, num_groups, extra)
            elif name == "distinctcounthll":
                outs[f"{k}_regs"] = D._hll_regs(
                    rows_cols["hh::" + argt], gid, None, num_groups, extra,
                    min_rows, members=Mx)
            elif name in ("sum", "avg"):
                outs[f"{k}_sum"] = D.members_scatter(
                    agg_ops.group_sum, gid, num_groups,
                    D._eval_expr(argt, rows_cols, pm, widths))
        D._group_extremes(aggs, gid, rows_cols, pm, num_groups, outs, widths,
                          min_rows, members=True)

    def scalar(rows_cols, mask, sub, outs):
        pm = dict(shared, **sub)
        Mx = mask.shape[0]
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if name == "count":
                continue
            if name == "distinctcount":
                s = torch.clamp(D._ids_col(rows_cols, argt), 0, extra - 1)
                outs[f"{k}_pres"] = D.members_scatter(
                    agg_ops.distinct_presence, torch.where(mask, s, extra),
                    extra)
                continue
            if name == "distinctcounthll":
                outs[f"{k}_regs"] = D._hll_regs(
                    rows_cols["hh::" + argt], None, mask, 1, extra, min_rows,
                    members=Mx)[:, 0]
                continue
            v = torch.broadcast_to(D._eval_expr(argt, rows_cols, pm, widths),
                                   mask.shape)
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = torch.where(
                    mask, v, torch.zeros((), dtype=v.dtype, device=dev)
                ).reshape(Mx, -1).sum(dim=1, dtype=torch.float64
                                      if v.is_floating_point()
                                      else torch.int64)
            if name in ("min", "minmaxrange"):
                outs[f"{k}_min"] = masked_extreme(v, mask, "min")
            if name in ("max", "minmaxrange"):
                outs[f"{k}_max"] = masked_extreme(v, mask, "max")

    def skip(idx, flat, cand_bound, blocks_total, n_cand, NB):
        sub = _select(pstack, idx)
        Mx = len(idx)
        # each member's candidates, padded with the invalid candidate
        cand, cand_valid = bs_ops.compact_candidates(flat, cand_bound)
        seg_of = (cand // NB).long()
        block_row0 = (cand % NB).long() * R
        seg_slot = torch.where(cand_valid, seg_of, S)

        def seg_sums(block_matched):
            return torch.zeros((Mx, S + 1), dtype=torch.int64,
                               device=dev).scatter_add_(
                1, seg_slot, block_matched)[:, :S]

        alive_s = alive[idx]
        if fused_plan is not None \
                and ps.fused_params_ok(fused_plan, _member(sub, shared, 0)):
            rows_in = torch.where(
                cand_valid, torch.clamp(nd64[seg_of] - block_row0, 0, R),
                0).to(torch.int32)
            per = [D._fused_params(fused_plan, _member(sub, shared, j), widths)
                   for j in range(Mx)]
            fparams = {k: torch.stack([p[k] for p in per]) for k in per[0]}
            ints, flts = ps.fused_filter_agg_members(
                cand, rows_in,
                {k: data_cols[k].reshape(S * NB, R) for k in fused_plan.cols},
                fparams, fused_plan)
            outs = stat_outs(alive_s, seg_sums(ints[:, :, 0].to(torch.int64)),
                             rows_in.sum(dim=1, dtype=torch.int64),
                             blocks_total, n_cand)

            def fused_leaves(i_m, f_m, p, dc):
                o = {"doc_count": dc}
                D._fused_outs(fused_plan, i_m, f_m, dict(shared, **p), widths,
                              o)
                del o["doc_count"]
                return o

            outs.update(vmap(fused_leaves,
                             in_dims=(0, None if flts is None else 0, 0, 0))(
                ints, flts, sub, outs["doc_count"]))
            return outs
        row_idx = block_row0[:, :, None] \
            + torch.arange(R, dtype=torch.int64, device=dev)[None, None, :]
        rvalid = cand_valid[:, :, None] \
            & (row_idx < nd64[seg_of][:, :, None])
        flat_cand = cand.reshape(-1)
        g_cols = {}
        for k, v in data_cols.items():
            g = bs_ops.gather_blocks(v, flat_cand, NB, R)
            g_cols[k] = g.reshape((Mx, cand_bound) + tuple(g.shape[1:]))
        mask = vmap(lambda gc, p: D.eval_filter(
            filter_tpl, gc, dict(shared, **p), (cand_bound, R), dev,
            widths))(g_cols, sub) & rvalid
        outs = stat_outs(alive_s, seg_sums(mask.sum(dim=2, dtype=torch.int64)),
                         rvalid.sum(dim=(1, 2), dtype=torch.int64),
                         blocks_total, n_cand)
        return aggregate(g_cols, mask, sub, outs)

    results: list = [None] * M
    forms = []  # (member indexes, stacked outs)
    zero = torch.zeros(M, dtype=torch.int64, device=dev)
    if not blockskip or L % R:
        forms.append((list(range(M)), dense(list(range(M)), zero)))
    else:
        NB = L // R
        blocks_total = torch.where(alive, ((nd64 + R - 1) // R)[None],
                                   0).sum(dim=1)
        verdict = vmap(lambda p: bs_ops.zone_verdict(
            filter_tpl, cols, dict(shared, **p), (S, NB), widths))(pstack)
        block_start = torch.arange(NB, dtype=torch.int64, device=dev) * R
        verdict = verdict & (block_start[None, :] < nd64[:, None])[None] \
            & alive[:, :, None]
        flat = verdict.reshape(M, -1)
        bound = bs_ops.cand_bound(S * NB)
        n_cand = flat.sum(dim=1, dtype=torch.int64)
        # the reference picks the form per member on the device; here the
        # members' candidate counts come to the host in one copy
        counts = n_cand.tolist()
        dense_ix = [m for m in range(M) if counts[m] > bound]
        skip_ix = [m for m in range(M) if counts[m] <= bound]
        if dense_ix:
            forms.append((dense_ix, dense(dense_ix, blocks_total[dense_ix])))
        if skip_ix:
            forms.append((skip_ix, skip(skip_ix, flat[skip_ix], bound,
                                        blocks_total[skip_ix],
                                        n_cand[skip_ix], NB)))
    for idx, outs in forms:
        if trim is not None:
            outs = dr_ops.apply_trim_members(
                outs, _select(pstack, idx)["tr_k"], template, trim)
        for j, m in enumerate(idx):
            results[m] = {k: v[j] for k, v in outs.items()}
    return results


def _finalized(outs: dict, aggs) -> dict:
    outs = dict(outs)
    D._finalize_sketch_outs(outs, aggs)
    return outs
