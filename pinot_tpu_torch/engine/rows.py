"""The host path's query shapes, run on the card.

The JAX package's device refuses some shapes and its host path answers
them (its engine/host.py): selection, DISTINCT over anything but dict
columns, group-bys over expressions, raw or virtual columns, and
aggregations its device has no form for: DISTINCTCOUNT over raw
columns, and the digests and sketches (engine/sketches.py). The port
has no host scan. It runs these shapes on the card, with the values,
rows and response stats of that host path:

- the filter mask through the device's filter template, its non-dict
  leaves over the host path's values (engine/values.py), dense over the
  (S, L) batch;
- selection: each segment's first ``limit + offset`` matched rows, in doc
  order or in the stable order of its ORDER BY keys (ops/selection.py),
  then the select expressions and ORDER BY values gathered for those
  rows only;
- DISTINCT: the distinct key tuples of the matched rows, in key order;
- group-by: a factorize on the card (``torch.unique``) into one group id
  per row, numGroupsLimit applied per segment in doc order as the host
  applies it (the kept rows then factorized again, as the host does, so
  a table of 78M groups cut to S x limit sizes the pipeline by the
  latter), then the dense pipeline of engine/device.py over that id
  (its K1 / K2 kernels at their gates), DISTINCTCOUNT as distinct
  (group, value) pairs and FIRST/LASTWITHTIME over the exact values,
  the digests and sketches beside it (engine/sketches.py), each from the
  rows keyed by segment and group;
- stats as the host counts them: entries scanned in the filter by index
  choice, entries after it per kept row, pruned segments dropped (when
  all are pruned, the first runs under a FALSE filter).

Besides the shapes ``DeviceExecutor.host_shape`` sends here, a device
launch's fetch runs a query again here where the reference re-runs it on
its host (engine/device.py ``Launch.fetch``): a sorted-regime table past
its cap, or numGroupsLimit pressure on a trimmed table.

Only answer-sized tensors come to the host, in one copy: the kept rows,
the group keys and accumulators, the per-segment counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pinot_tpu_torch.engine import aggspec, sketches
from pinot_tpu_torch.engine.params import (
    build_filter,
    expr_on_device,
    to_device,
)
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult
from pinot_tpu_torch.engine.values import (
    Rows,
    ValueEvaluator,
    filter_entries,
    later,
)
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import device_reduce as dr_ops
from pinot_tpu_torch.ops import masks as mask_ops
from pinot_tpu_torch.ops import selection as sel_ops
from pinot_tpu_torch.query.context import FilterNode, QueryContext
from pinot_tpu_torch.storage.segment import Encoding

# aggregations the pipeline runs over device templates (engine/device.py)
_PLAIN_AGGS = ("count", "sum", "avg", "min", "max", "minmaxrange")
_DISTINCT_ALIASES = ("distinctcount", "distinctcountbitmap",
                     "segmentpartitioneddistinctcount")


class RowsLaunch:
    """A dispatched host-shaped query: its device leaves, copied to the
    host in one copy at fetch, and the step that turns them into the
    canonical IntermediateResult."""

    def __init__(self, outs: dict, finish):
        self.outs, self.finish = outs, finish

    def fetch(self, ex) -> IntermediateResult:
        return self.finish(ex._to_host(self.outs), ex)


@dataclasses.dataclass
class _Scan:
    """What every shape shares: the evaluator, the matched rows and the
    stats the host path reports for them."""

    ev: ValueEvaluator
    mask: torch.Tensor          # (S, L) matched rows
    all_pruned: bool
    n_alive: int
    entries_in_filter: int

    def stats(self, host: dict, post: int, limit_reached=False):
        ctx = self.ev.ctx
        matched = host["hx_matched"]
        return ExecutionStats(
            num_docs_scanned=int(matched.sum()),
            num_entries_scanned_in_filter=self.entries_in_filter,
            num_entries_scanned_post_filter=int(post),
            # every segment pruned: the host runs the first one under a
            # FALSE filter
            num_segments_processed=1 if self.all_pruned else self.n_alive,
            num_segments_queried=ctx.S,
            num_segments_matched=int((matched > 0).sum()),
            num_segments_pruned=ctx.S - self.n_alive,
            total_docs=int(ctx.n_docs.sum()),
            num_groups_limit_reached=bool(limit_reached),
        )


def filter_plane(f, ctx, ev: ValueEvaluator) -> torch.Tensor:
    """A filter tree through the device's template (engine/params.py
    ``build_filter``), its non-dict leaves over the host path's values,
    evaluated dense over the (S, L) batch (padding rows not masked)."""
    from pinot_tpu_torch.engine.device import (
        DeviceExecutor,
        eval_filter,
        needed_columns,
    )

    params, counter = {}, [0]
    tpl = ("true",) if f is None else build_filter(f, ctx, params, counter,
                                                   ev)
    widths, cols = DeviceExecutor.gather_columns(ctx, needed_columns(tpl),
                                                 params)
    shape = (ctx.S, ctx.pad_to)
    return torch.broadcast_to(
        eval_filter(tpl, cols, params, shape, ctx.device, widths), shape)


def _scan(q: QueryContext, ctx, alive) -> _Scan:
    """The filter over the batch (``filter_plane``), dead segments and
    padding rows masked."""
    ev = ValueEvaluator(ctx)
    all_pruned = not alive.any()
    f = FilterNode.FALSE if all_pruned else q.filter
    valid = mask_ops.valid_mask(ctx.n_docs_dev, ctx.pad_to) \
        & to_device(alive, ctx.device)[:, None]
    mask = filter_plane(f, ctx, ev) & valid
    entries = 0
    if q.filter is not None and not all_pruned:
        entries = sum(filter_entries(q.filter, s)
                      for s, a in zip(ctx.segments, alive) if a)
    return _Scan(ev, mask, all_pruned, int(alive.sum()), entries)


def launch(ex, q: QueryContext, ctx, final: bool, reduce_mode,
           alive) -> RowsLaunch:
    """Dispatch ``q`` in its host-path shape over the batch ``ctx``."""
    aggs = q.aggregations()
    if q.distinct:
        return _distinct(q, ctx, alive)
    if not aggs:
        return _selection(q, ctx, alive)
    return _aggregate(ex, q, ctx, final, reduce_mode, alive, aggs)


def _matched_rows(scan: _Scan) -> torch.Tensor:
    return torch.nonzero(scan.mask.reshape(-1)).reshape(-1)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _selection(q: QueryContext, ctx, alive) -> RowsLaunch:
    scan = _scan(q, ctx, alive)
    ev, S, L = scan.ev, ctx.S, ctx.pad_to
    k = q.limit + q.offset
    if not q.order_by:
        idx = sel_ops.first_rows(scan.mask, k)
    else:
        idx_m = _matched_rows(scan)
        r = Rows(S, L, ctx.device, idx_m)
        keys = [torch.broadcast_to(
            ev.sort_key(ev.eval(ob.expression, r), ob.ascending),
            idx_m.shape) for ob in q.order_by]
        idx = sel_ops.ordered_rows(idx_m, keys, L, S, k)
    r = Rows(S, L, ctx.device, idx)
    exprs = list(q.select_expressions) + [ob.expression for ob in q.order_by]
    vals = [ev.eval(e, r) for e in exprs]
    outs = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64)}
    for j, v in enumerate(vals):
        outs[f"v{j}"] = torch.broadcast_to(v.t, idx.shape).contiguous()
    n_sel = len(q.select_expressions)

    def finish(host, _ex):
        n = len(host["v0"]) if vals else 0
        rows = {}
        for j, v in enumerate(vals):
            key = j if j < n_sel else f"__ob{j - n_sel}"
            rows[key] = ev.decode(v, host[f"v{j}"])
        # ORDER BY values ride along for the reduce's merge re-sort
        return IntermediateResult("selection", rows=rows,
                                  stats=scan.stats(host, n * n_sel))

    return RowsLaunch(outs, finish)


# ---------------------------------------------------------------------------
# DISTINCT
# ---------------------------------------------------------------------------


def _key_columns(ev, exprs, scan: _Scan, ctx) -> tuple:
    """(vals, keys, cards) of the key expressions over the whole batch:
    each one's values, its int64 keys and their known range, if any."""
    full = Rows(ctx.S, ctx.pad_to, ctx.device)
    vals = [ev.eval(e, full) for e in exprs]
    keys = [ev.key(v, scan.mask.shape).reshape(-1) for v in vals]
    return vals, keys, [ev.card(v) for v in vals]


def _group_ids(ev, exprs, scan: _Scan, ctx) -> tuple:
    """(vals, gid, G, group_keys) of the key expressions over the whole
    batch (ops/selection.py factorize, its ranges and ranks taken over
    the matched rows)."""
    vals, keys, cards = _key_columns(ev, exprs, scan, ctx)
    gid, G, gkeys = sel_ops.factorize(keys, scan.mask.reshape(-1), cards)
    return vals, gid, G, gkeys


def _distinct(q: QueryContext, ctx, alive) -> RowsLaunch:
    scan = _scan(q, ctx, alive)
    ev = scan.ev
    vals, gid, G, gkeys = _group_ids(ev, q.select_expressions, scan, ctx)
    mflat = scan.mask.reshape(-1)
    present = agg_ops.distinct_presence(
        torch.where(mflat, gid, G), G).nonzero().reshape(-1)
    outs = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64)}
    for j, k in enumerate(gkeys):
        outs[f"k{j}"] = k[present]

    def finish(host, _ex):
        keys_h = tuple(ev.decode_key(v, host[f"k{j}"])
                       for j, v in enumerate(vals))
        return IntermediateResult("distinct", group_keys=keys_h,
                                  stats=scan.stats(host, 0))

    return RowsLaunch(outs, finish)


# ---------------------------------------------------------------------------
# group-by and aggregation
# ---------------------------------------------------------------------------


def _agg_plan(ex, q, ctx, ev, aggs, full, params, counter, cols):
    """The pipeline's templates: the device template where an aggregation
    has one (the kernels read the stored planes), else value-space planes
    the card computes (``__x`` / ``__k`` / ``__v`` / ``__t`` cols); per
    template the decode a partial needs, if any; and per aggregation its
    slot: the index ``i`` of its template (leaves ``a{i}_...``), or its
    sketch (engine/sketches.py), which runs beside the pipeline."""
    tpls, decodes, slots = [], [], []
    shape = (ctx.S, ctx.pad_to)
    for a in aggs:
        name = a.name
        if name in sketches.NAMES:
            slots.append(sketches.plan(len(slots), a, ev,
                                       lambda f: filter_plane(f, ctx, ev)))
            continue
        i = len(tpls)
        dec = None
        if name in _PLAIN_AGGS:
            if name == "count" or expr_on_device(a.args[0], ctx):
                tpl = ex._agg_template(i, a, ctx, params, counter)
            else:
                # e.g. SUM($docId): the value, computed on the card
                key = f"__x{i}"
                cols[key] = torch.broadcast_to(
                    ev.eval(a.args[0], full).t, shape)
                tpl = (name, ("raw", key),
                       (None, None) if name in ("sum", "avg") else None)
        elif name in _DISTINCT_ALIASES:
            v = ev.eval(a.args[0], full)
            key = f"__k{i}"
            cols[key] = ev.set_key(v, shape)
            tpl, dec = ("distinctcount_v", key, None), v
        elif name in ("firstwithtime", "lastwithtime"):
            v = ev.eval(a.args[0], full)
            t = ev.eval(a.args[1], full)
            if t.kind != "num":
                raise later(f"{name.upper()} over a non-numeric time")
            if v.kind not in ("num", "dict"):
                raise later(f"{name.upper()} over a virtual column value")
            cols[f"__v{i}"] = torch.broadcast_to(v.t, shape)
            cols[f"__t{i}"] = torch.broadcast_to(t.t, shape)
            # integer values ride exactly, as the host path carries them
            exact = v.kind == "num" and v.dtype.kind in "biu"
            tpl = (name, (("raw", f"__v{i}"), ("raw", f"__t{i}")),
                   "exact" if exact else "pair")
            dec = v if v.kind == "dict" else None
        elif name in ("distinctcounthll", "hllmerge", "fasthll"):
            if not a.args[0].is_identifier \
                    or a.args[0].name.startswith("$"):
                raise later(f"{name.upper()} over an expression")
            ev.column_dtype(a.args[0].name)
            if name != "hllmerge" \
                    and ctx.encoding(a.args[0].name) != Encoding.DICT:
                # the reference's device reads dict columns only: a raw
                # column's registers take the sketch's K3 form
                slots.append(sketches.plan(len(slots), a, ev, None))
                continue
            if name == "fasthll":   # the reference's alias
                a = dataclasses.replace(a, name="distinctcounthll")
            tpl = ex._agg_template(i, a, ctx, params, counter)
        else:
            raise later(f"the aggregation {name.upper()}")
        slots.append(i)
        tpls.append(tpl)
        decodes.append(dec)
    return tuple(tpls), decodes, slots


def _partial(i, tpl, host, ctx, present, dec, ev):
    """A partial the device executor's decoders do not build: distinct
    counts as value sets, FIRST/LASTWITHTIME over strings."""
    from pinot_tpu_torch.engine.device import DeviceExecutor

    name, _argt, _extra = tpl
    k = f"a{i}"
    if name == "distinctcount_v":
        if f"{k}_cnt" in host:
            cnt = np.asarray(host[f"{k}_cnt"]).reshape(-1)
            return {"cnt": (cnt if present is None
                            else cnt[present]).astype(np.int64)}
        vals = ev.decode_key(dec, host[f"{k}_pv"])
        g = host.get(f"{k}_pg")
        g = np.zeros(len(vals), dtype=np.int64) if g is None else g
        gids = np.zeros(1, dtype=np.int64) if present is None else present
        sets = np.empty(len(gids), dtype=object)
        sets[:] = [set() for _ in gids]
        pos = {int(x): j for j, x in enumerate(gids)}
        for gg, vv in zip(g.tolist(), vals.tolist()):
            if gg in pos:
                sets[pos[gg]].add(vv)
        return {"sets": sets}
    if present is None:
        part = DeviceExecutor._scalar_partial(i, tpl, host, ctx)
    else:
        part = DeviceExecutor._group_partial(i, tpl, host, ctx, present)
    if dec is not None and "val" in part:
        # string values rode as global dictionary ids
        ids, out = part["val"], np.empty(len(part["val"]), dtype=object)
        gdict = ctx.global_dict(dec.meta)
        for j, x in enumerate(ids.tolist()):
            out[j] = None if np.isnan(x) else gdict.get(int(x)).item()
        part["val"] = out
    return part


def _partials(slots, tpls, decodes, host, ctx, present, ev) -> list:
    """Each aggregation's partial, in the query's order."""
    return [_partial(s, tpls[s], host, ctx, present, decodes[s], ev)
            if isinstance(s, int) else s.partial(host, present)
            for s in slots]


def _post_entries(aggs, kept: int) -> int:
    return sum(kept * len(aggspec.make_spec(a).args) for a in aggs)


def _aggregate(ex, q, ctx, final, reduce_mode, alive, aggs) -> RowsLaunch:
    from pinot_tpu_torch.engine.device import (
        STATE_AGGS,
        agg_columns,
        build_pipeline,
    )

    scan = _scan(q, ctx, alive)
    ev, S, L, dev = scan.ev, ctx.S, ctx.pad_to, ctx.device
    full = Rows(S, L, dev)
    params, counter, cols = {}, [0], {}
    tpls, decodes, slots = _agg_plan(ex, q, ctx, ev, aggs, full, params,
                                     counter, cols)
    final = final and any(t[0] in STATE_AGGS for t in tpls)
    sketch = [s for s in slots if not isinstance(s, int)]
    widths, base = ex.gather_columns(
        ctx, set().union(*(agg_columns(t) for t in tpls)), params)
    cols.update(base)
    params["ps_alive"] = to_device(alive, dev)
    outs0 = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64)}

    if not q.group_by:
        params["__mask__"] = scan.mask
        template = ("agg", ("mask", "__mask__"), (), (), tpls, 0, final)
        outs = build_pipeline(template, widths, ex.min_rows)(
            cols, ctx.n_docs_dev, params)
        for sk in sketch:
            outs.update(sk.launch(sketches.Batch(ev, scan.mask, None, 1)))
        outs.update(outs0)

        def finish_scalar(host, _ex):
            partials = _partials(slots, tpls, decodes, host, ctx, None, ev)
            n = int(host["hx_matched"].sum())
            return IntermediateResult(
                "aggregation", agg_partials=partials,
                stats=scan.stats(host, _post_entries(aggs, n)))

        return RowsLaunch(outs, finish_scalar)

    if not bool(scan.mask.any()):
        def finish_empty(host, _ex):
            specs = [aggspec.make_spec(a) for a in aggs]
            return IntermediateResult(
                "group_by",
                group_keys=tuple(ev.decode(ev.eval(g, full),
                                           np.zeros(0, dtype=np.int64))
                                 for g in q.group_by),
                agg_partials=[s.empty(0) for s in specs],
                stats=scan.stats(host, 0))

        return RowsLaunch(outs0, finish_empty)

    kvals, keys, cards = _key_columns(ev, q.group_by, scan, ctx)
    agg_mask = scan.mask.reshape(-1)
    gid, G, gkeys = sel_ops.factorize(keys, agg_mask, cards)
    limit = ex.groups_limit(q)
    keep = None
    if G > limit:
        idx = _matched_rows(scan)
        keep = sel_ops.limit_groups(idx // L, gid[idx], G, S, limit)
    limit_reached = keep is not None
    if keep is not None:
        agg_mask = agg_mask.clone()
        agg_mask[idx[~keep]] = False
        # at most S * limit groups keep rows: number those alone, as the
        # host factorizes its kept rows again, so the pipeline's tables
        # are sized by what was kept, not by every group met
        gid, G, gkeys = sel_ops.factorize(keys, agg_mask, cards)
    agg_mask = agg_mask.reshape(S, L)
    cols["__gid__"] = torch.where(agg_mask, gid.reshape(S, L), G) \
        .to(torch.int32)
    params["__mask__"] = agg_mask
    template = ("groupby", ("mask", "__mask__"), ("__gid__",), (G,), tpls,
                0, final)
    outs = build_pipeline(template, widths, ex.min_rows)(
        cols, ctx.n_docs_dev, params)
    for j, k in enumerate(gkeys):
        outs[f"gk{j}"] = k
    for sk in sketch:
        outs.update(sk.launch(sketches.Batch(
            ev, agg_mask, cols["__gid__"].reshape(-1), G)))
    # list-, dict- and set-valued partials have no order key to trim by
    pairs = bool(sketch) or any(f"a{i}_pg" in outs
                                for i in range(len(tpls)))
    trim = None
    if reduce_mode is not None and not pairs:
        trim = dr_ops.plan_trim(q, q.group_by, aggs, G, reduce_mode,
                                ex.group_trim_size)
    if trim is not None:
        tr_k = torch.tensor(dr_ops.trim_keep_count(q, reduce_mode,
                                                   ex.group_trim_size),
                            dtype=torch.int64, device=dev)
        outs = dr_ops.apply_trim(
            outs, tr_k, template, trim,
            [ev.key_orders(v, k) for v, k in zip(kvals, gkeys)])
    outs.update(outs0)
    outs["hx_kept"] = agg_mask.sum(dtype=torch.int64)

    def finish_groups(host, ex_):
        if "trim_keys" in host:
            present = np.arange(int(host["trim_n"]))
            ex_.device_reduce_queries += 1
        else:
            present = np.nonzero(host["gcount"] > 0)[0]
        key_values = tuple(ev.decode_key(v, host[f"gk{j}"][present])
                           for j, v in enumerate(kvals))
        partials = _partials(slots, tpls, decodes, host, ctx, present, ev)
        return IntermediateResult(
            "group_by", group_keys=key_values, agg_partials=partials,
            stats=scan.stats(host, _post_entries(aggs, int(host["hx_kept"])),
                             limit_reached))

    return RowsLaunch(outs, finish_groups)

