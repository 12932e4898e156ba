"""Device query executor on torch: one pipeline over the whole (S, L)
segment batch,

    filter masks → global-id group keys → dense aggregation

counterpart of pinot_tpu/engine/device.py. The template (literals
parameterized out, as in the reference) is evaluated eagerly as torch ops
on CUDA tensors; there is no compile step to cache. Group-by runs in
global dictionary id space (engine/params.py), so the dense (G,)
accumulator is the ARRAY_BASED group-key regime and its merge at once.

Dense COUNT/SUM/AVG route through the group plane-sum kernel K1 and
MIN/MAX/MINMAXRANGE through the group min/max kernel K2
(ops/group_scatter.py, ops/groupby_mm.py), with the reference's pallas-tier
routing and minimum batch; other shapes use the torch scatters of
ops/agg.py where the reference uses XLA's.

This slice covers the scalar ``agg`` and dense ``groupby`` shapes. The
sorted high-cardinality regime, block skip, DISTINCT, the distinct-count
and HLL family, and first/last-with-time raise DeviceUnsupported and come
with later slices. There is no fallback ladder: a device or kernel error
propagates to the caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pinot_tpu_torch import resolve_device
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
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import masks as mask_ops
from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.query.context import Expression, QueryContext
from pinot_tpu_torch.storage.segment import Encoding

DEVICE_AGGS = {"count", "sum", "min", "max", "avg", "minmaxrange"}

# aggregations the reference runs on its device that this port runs in a
# later slice
LATER_AGGS = {
    "distinctcount": "distinct-count", "distinctcountbitmap": "distinct-count",
    "segmentpartitioneddistinctcount": "distinct-count",
    "distinctcounthll": "HLL", "hllmerge": "HLL",
    "firstwithtime": "first/last-with-time",
    "lastwithtime": "first/last-with-time",
}

MAX_DENSE_GROUPS = 1 << 22        # ARRAY_BASED regime guard (~4M groups)


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


def _try_mm_groupby(aggs, gid, cols, params, num_groups, outs, widths,
                    min_rows: int):
    """Route COUNT/SUM/AVG through ONE K1 launch when eligible: the
    partitioned entry (ops/group_scatter.py plane_group_sums) when
    ``sums_supported``, else the single-accumulator entry
    (ops/groupby_mm.py group_sums) when ``mm_supported`` — the reference's
    pallas-tier routing. Fills outs["gcount"] + outs[f"a{i}_sum"] and
    returns the set of agg indexes handled; the torch scatters cover the
    rest."""
    n_total = gid.numel()
    if n_total < min_rows:
        return set()
    plans = []  # (i, kind, nplanes, values)
    total_ch = 1  # ones channel
    for i, (name, argt, nplanes_int) in enumerate(aggs):
        if name not in ("sum", "avg"):
            continue
        v = _eval_expr(argt, cols, params, widths)
        if not v.is_floating_point():
            if nplanes_int is None:  # unknown range → exact scatter instead
                continue
            kind, nplanes = "int", nplanes_int
        else:
            kind, nplanes = "float", 3
        if total_ch + nplanes > mm.MAX_CHANNELS + 1:
            continue
        plans.append((i, kind, nplanes, v))
        total_ch += nplanes
    use_ps = ps.sums_supported(num_groups, total_ch)
    if not use_ps and not mm.mm_supported(num_groups, total_ch - 1):
        return set()
    if not plans and not any(a[0] in ("count", "avg") for a in aggs):
        return set()

    channels = torch.empty((total_ch, n_total), dtype=torch.bfloat16,
                           device=gid.device)
    channels[0].fill_(1)
    specs = []  # (i, kind, channel rows)
    row = 1
    for i, kind, nplanes, v in plans:
        flat = v.reshape(-1)
        planes = mm.int_planes(flat, params[f"off{i}"], nplanes) \
            if kind == "int" else mm.float_planes(flat)
        for k, p in enumerate(planes):
            channels[row + k].copy_(p)
        specs.append((i, kind, range(row, row + nplanes)))
        row += nplanes

    flat_gid = gid.reshape(-1).contiguous()
    if use_ps:
        sums = ps.plane_group_sums(flat_gid, channels, num_groups,
                                   first_channel_ones=True)
    else:
        sums = mm.group_sums(flat_gid, channels, num_groups,
                             first_channel_ones=True)
    gcount = torch.round(sums[0]).to(torch.int64)
    outs["gcount"] = gcount
    done = set()
    for i, kind, rows in specs:
        planes = [sums[j] for j in rows]
        outs[f"a{i}_sum"] = mm.recombine_int(planes, gcount, params[f"off{i}"]) \
            if kind == "int" else mm.recombine_float(planes)
        done.add(i)
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


def build_pipeline(template, widths=None, min_rows: int = ps.PALLAS_MIN_ROWS):
    """template → fn(cols, n_docs, params) → outputs dict of tensors.

    ``widths``: the batch's column width plan {cols key: ColPlan.sig()}.
    ``min_rows``: batches below this row count take the torch scatters
    instead of the kernels (the reference's PALLAS_MIN_ROWS gate; the CPU
    tests pass 0 to reach the kernels' plain versions, as the reference's
    interpret mode ignores its gate)."""
    shape, filter_tpl, group_cols, group_cards, aggs = template
    if shape not in ("agg", "groupby"):
        raise DeviceUnsupported(f"pipeline shape {shape}")
    num_groups = math.prod(group_cards)

    def pipeline(cols, n_docs, params):
        S, L = next(iter(cols.values())).shape
        valid = mask_ops.valid_mask(n_docs, L)
        mask = _eval_filter(filter_tpl, cols, params, (S, L), valid.device,
                            widths) & valid
        seg_matched = mask.sum(dim=1, dtype=torch.int64)
        outs = {"doc_count": seg_matched.sum(), "seg_matched": seg_matched}
        if shape == "groupby":
            return _groupby(cols, params, mask, outs)
        return _scalar(cols, params, mask, outs)

    def _groupby(cols, params, mask, outs):
        # columns are already global ids: the group key IS the column
        per_col = [cols[c] for c in group_cols]
        gid = agg_ops.group_ids_combine(per_col, group_cards, mask,
                                        num_groups)
        done = _try_mm_groupby(aggs, gid, cols, params, num_groups, outs,
                               widths, min_rows)
        if "gcount" not in outs:
            outs["gcount"] = agg_ops.group_count(gid, num_groups)
        for i, (name, argt, _extra) in enumerate(aggs):
            k = f"a{i}"
            if i in done or name == "count":
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
        return outs

    def _scalar(cols, params, mask, outs):
        for i, (name, argt, _extra) in enumerate(aggs):
            k = f"a{i}"
            if name == "count":
                continue  # doc_count reused
            v = _eval_expr(argt, cols, params, widths)
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = agg_ops.agg_sum(v, mask)
            if name in ("min", "minmaxrange"):
                outs[f"{k}_min"] = agg_ops.agg_min(v, mask)
            if name in ("max", "minmaxrange"):
                outs[f"{k}_max"] = agg_ops.agg_max(v, mask)
        return outs

    return pipeline


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
        if name in LATER_AGGS:
            raise DeviceUnsupported(
                f"{name}: the {LATER_AGGS[name]} aggregations come with a "
                f"later slice of the port")
        if name not in DEVICE_AGGS:
            raise DeviceUnsupported(f"aggregation {name} not on device")
        if name == "count":
            return ("count", None, None)
        argt = build_expr(a.args[0], ctx, params, counter)
        nplanes = None
        if name in ("sum", "avg"):
            # metadata interval arithmetic sizes the kernel's byte planes
            bounds = expr_bounds(a.args[0], ctx)
            if bounds is not None:
                nplanes = mm.int_planes_needed(bounds[0], bounds[1])
                params[f"off{i}"] = torch.tensor(
                    math.floor(bounds[0]), dtype=torch.int64,
                    device=ctx.device)
        return (name, argt, nplanes)

    def launch(self, q: QueryContext, segments) -> Launch:
        """Template build + column upload (cached per segment set) + the
        pipeline's torch ops and kernel launches, enqueued on the current
        stream. Raises DeviceUnsupported for shapes this slice does not
        run on the device."""
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
        template = ("groupby" if group_cols else "agg", filter_tpl,
                    tuple(group_cols), tuple(group_cards), agg_tpls)

        needed = _needed_columns(filter_tpl) | set(group_cols)
        for _name, argt, _extra in agg_tpls:
            if argt is not None:
                needed |= _needed_columns(argt)
        if not needed:  # COUNT(*) no filter: one column carries the shape
            needed.add(segments[0].column_names()[0])
        widths, cols = {}, {}
        for c in sorted(needed):
            plan = ctx.width_plan(c)
            widths[c] = plan.sig()
            if plan.offset is not None:
                params["fo::" + c] = to_device(
                    np.asarray(plan.offset, dtype=np.dtype(plan.wide)),
                    ctx.device)
            cols[c] = ctx.decoded_column(c[4:]) if c.startswith("dv::") \
                else ctx.column(c)
        outs = build_pipeline(template, widths, self.min_rows)(
            cols, ctx.n_docs_dev, params)
        return Launch(q, ctx, template, outs)

    def fetch(self, launch: Launch) -> IntermediateResult:
        """Device outputs → host numpy → canonical IntermediateResult."""
        outs = {k: v.cpu().numpy() for k, v in launch.outs.items()}
        return self._to_intermediate(launch.q, launch.ctx, launch.template,
                                     outs)

    def execute(self, q: QueryContext, segments) -> IntermediateResult:
        return self.fetch(self.launch(q, segments))

    # ---- device outputs → canonical IntermediateResult -------------------
    def _to_intermediate(self, q, ctx: BatchContext, template, outs):
        shape, _, group_cols, group_cards, agg_tpls = template
        doc_count = int(outs["doc_count"])
        total_docs = int(ctx.n_docs.sum())
        entries_in_filter = 0
        if q.filter is not None:
            entries_in_filter = total_docs * len(q.filter.columns())
        entries_post = sum(
            doc_count * len(aggspec.make_spec(a).args)
            for a in q.aggregations())
        stats = ExecutionStats(
            num_docs_scanned=doc_count,
            num_entries_scanned_in_filter=entries_in_filter,
            num_entries_scanned_post_filter=entries_post,
            num_segments_processed=ctx.S,
            num_segments_queried=ctx.S,
            num_segments_matched=int((outs["seg_matched"] > 0).sum()),
            total_docs=total_docs,
        )
        if shape == "agg":
            partials = [self._scalar_partial(i, t, outs)
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
        partials = [self._group_partial(i, t, outs, present)
                    for i, t in enumerate(agg_tpls)]
        return IntermediateResult("group_by", group_keys=key_values,
                                  agg_partials=partials, stats=stats)

    @staticmethod
    def _scalar_partial(i, tpl, outs):
        name = tpl[0]
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
        return {"min": one(f"{k}_min"), "max": one(f"{k}_max")}

    @staticmethod
    def _group_partial(i, tpl, outs, present):
        name = tpl[0]
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
        return {"min": sel(f"{k}_min"), "max": sel(f"{k}_max")}
