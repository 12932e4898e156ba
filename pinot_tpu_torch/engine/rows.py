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
- multi-value columns as the host expands them: a selection returns each
  row's entries; a group-by key on an MV column takes one row per entry
  of each matched doc (Cartesian across MV keys), those rows laid out
  like a batch, (S, Lx), so the factorize, numGroupsLimit and the
  pipeline run over them unchanged (``_space``); an ``*MV`` aggregation
  runs its single-value form over the entries of the rows it takes
  (COUNTMV as COUNT, DISTINCTCOUNTHLLMV as the raw sketch), each
  column's entries a space of their own with the group id of their row;
- stats as the host counts them: entries scanned in the filter by index
  choice, entries after it per kept row (per entry for an MV
  aggregation), pruned segments dropped (when all are pruned, the first
  runs under a FALSE filter);
- an upsert valid-docs plane (``launch(..., valid=...)``, the launch's
  snapshot of a part's mask) ANDed into the filter's rows before any
  aggregation, selection or DISTINCT reads them; the docs it masks still
  count in totalDocs, as the host counts them.

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
    DeviceUnsupported,
    build_filter,
    expr_on_device,
    to_device,
)
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult
from pinot_tpu_torch.engine.values import (
    Mixed,
    Rows,
    SpaceEvaluator,
    Val,
    ValueEvaluator,
    filter_entries,
    host_fails,
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
    """A dispatched host-shaped query: its device leaves, which the
    executor's handle copies to the host in one copy
    (engine/device.py ``DeviceExecutor.launch``), and the step that turns
    them into the canonical IntermediateResult: ``finish(host, ex)``."""

    def __init__(self, outs: dict, finish):
        self.outs, self.finish = outs, finish


@dataclasses.dataclass
class _Scan:
    """What every shape shares: the evaluator, the matched rows and the
    stats the host path reports for them."""

    ev: ValueEvaluator
    mask: torch.Tensor          # (S, L) matched rows
    all_pruned: bool
    n_alive: int
    entries_in_filter: int
    alive: np.ndarray           # (S,) the segments the host path runs

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


def _scan(q: QueryContext, ctx, alive, valid_docs=None) -> _Scan:
    """The filter over the batch (``filter_plane``), dead segments and
    padding rows masked, and the upsert valid-docs plane ANDed in
    (``valid_docs``, (S, L) bool, or None): the host path ANDs it into the
    filter's rows before anything reads them, and counts the filter's
    entries over every doc."""
    return _scan_filter(q.filter, ctx, alive, valid_docs)


def _scan_filter(filt, ctx, alive, valid_docs=None) -> _Scan:
    """``_scan`` of the filter tree ``filt`` (None: every row)."""
    ev = ValueEvaluator(ctx)
    all_pruned = not alive.any()
    f = FilterNode.FALSE if all_pruned else filt
    valid = mask_ops.valid_mask(ctx.n_docs_dev, ctx.pad_to) \
        & to_device(alive, ctx.device)[:, None]
    if valid_docs is not None:
        valid = valid & valid_docs
    mask = filter_plane(f, ctx, ev) & valid
    entries = 0
    if filt is not None and not all_pruned:
        entries = sum(filter_entries(filt, s)
                      for s, a in zip(ctx.segments, alive) if a)
    ran = np.asarray(alive, dtype=bool).copy()
    if all_pruned:
        ran[:1] = True   # the first runs under a FALSE filter
    return _Scan(ev, mask, all_pruned, int(alive.sum()), entries, ran)


def filter_mask(seg, filt, device) -> np.ndarray:
    """One segment's (n_docs,) bool mask of the rows the filter tree
    ``filt`` matches, on ``device`` in the host path's shape (the
    reference's host ``SegmentEvaluator.filter_mask``). The segment's
    planes live for this call only: no executor, no batch LRU."""
    from pinot_tpu_torch.engine.params import BatchContext

    ctx = BatchContext([seg], torch.device(device))
    scan = _scan_filter(filt, ctx, np.ones(1, dtype=bool))
    return scan.mask[0, :seg.n_docs].cpu().numpy()


def launch(ex, q: QueryContext, ctx, final: bool, reduce_mode,
           alive, valid=None) -> RowsLaunch:
    """Dispatch ``q`` in its host-path shape over the batch ``ctx``;
    ``valid``: the (S, L) upsert valid-docs plane, or None."""
    aggs = q.aggregations()
    if q.distinct:
        return _distinct(q, ctx, alive, valid)
    if not aggs:
        return _selection(q, ctx, alive, valid)
    return _aggregate(ex, q, ctx, final, reduce_mode, alive, aggs, valid)


def _matched_rows(scan: _Scan) -> torch.Tensor:
    return torch.nonzero(scan.mask.reshape(-1)).reshape(-1)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def _selection(q: QueryContext, ctx, alive, valid=None) -> RowsLaunch:
    scan = _scan(q, ctx, alive, valid)
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
    outs = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64),
            "hx_rows": idx}
    vals = []
    for j, e in enumerate(exprs):
        if e.is_identifier and ev.is_mv(e.name):
            if j >= len(q.select_expressions):
                raise host_fails(f"ORDER BY the multi-value column "
                                 f"{e.name!r}")
            v, outs[f"v{j}"], outs[f"n{j}"] = _mv_rows(ev, e.name, idx, L)
        else:
            v = ev.materialize(ev.eval(e, r))
            outs[f"v{j}"] = torch.broadcast_to(v.t, idx.shape).contiguous()
        vals.append(v)
    n_sel = len(q.select_expressions)

    def finish(host, _ex):
        n = len(host["hx_rows"])
        rows = {}
        for j, v in enumerate(vals):
            key = j if j < n_sel else f"__ob{j - n_sel}"
            if f"n{j}" in host:
                flat = ev.decode(v, host[f"v{j}"], scan.alive)
                rows[key] = np.empty(n, dtype=object)
                rows[key][:] = np.split(flat, np.cumsum(host[f"n{j}"])[:-1]) \
                    if n else []
            else:
                rows[key] = ev.decode(v, host[f"v{j}"], scan.alive)
        # ORDER BY values ride along for the reduce's merge re-sort
        return IntermediateResult("selection", rows=rows,
                                  stats=scan.stats(host, n * n_sel))

    return RowsLaunch(outs, finish)


def _mv_rows(ev, name: str, idx: torch.Tensor, L: int) -> tuple:
    """(Val, flat entries, entry counts) of an MV column at the flat rows
    ``idx``: each row's entries in order, one after another."""
    v, _doc = ev.mv_values(name)
    mp = ev.mv(name)
    if mp is None:
        n = torch.zeros_like(idx, dtype=torch.int64)
        return v, v.t.reshape(-1)[:0], n
    E = mp.vals.shape[1]
    n = mp.lens.reshape(-1)[idx].to(torch.int64)
    first = torch.cumsum(n, 0) - n
    row = torch.repeat_interleave(torch.arange(idx.numel(),
                                               device=idx.device), n)
    rank = torch.arange(row.numel(), device=idx.device) - first[row]
    pos = (idx[row] // L) * E + mp.start.reshape(-1)[idx[row]] + rank
    return v, v.t.reshape(-1)[pos], n


# ---------------------------------------------------------------------------
# DISTINCT
# ---------------------------------------------------------------------------


def _key_columns(ev, exprs, mask, full: Rows) -> tuple:
    """(vals, keys, cards) of the key expressions over all rows ``full``
    (the batch, or an MV group-by's rows): each one's values, its int64
    keys and their known range, if any."""
    vals = [ev.eval(e, full) for e in exprs]
    keys = [ev.key(v, mask.shape).reshape(-1) for v in vals]
    return vals, keys, [ev.card(v) for v in vals]


def _group_ids(ev, exprs, scan: _Scan, ctx) -> tuple:
    """(vals, gid, G, group_keys) of the key expressions over the whole
    batch (ops/selection.py factorize, its ranges and ranks taken over
    the matched rows)."""
    vals, keys, cards = _key_columns(ev, exprs, scan.mask,
                                     Rows(ctx.S, ctx.pad_to, ctx.device))
    gid, G, gkeys = sel_ops.factorize(keys, scan.mask.reshape(-1), cards)
    return vals, gid, G, gkeys


def _distinct(q: QueryContext, ctx, alive, valid=None) -> RowsLaunch:
    scan = _scan(q, ctx, alive, valid)
    ev = scan.ev
    for e in q.select_expressions:
        if e.is_identifier and ev.is_mv(e.name):
            raise host_fails(f"DISTINCT over the multi-value column "
                             f"{e.name!r}")
    vals, gid, G, gkeys = _group_ids(ev, q.select_expressions, scan, ctx)
    mflat = scan.mask.reshape(-1)
    present = agg_ops.distinct_presence(
        torch.where(mflat, gid, G), G).nonzero().reshape(-1)
    outs = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64)}
    for j, k in enumerate(gkeys):
        outs[f"k{j}"] = k[present]

    def finish(host, _ex):
        keys_h = tuple(ev.decode_key(v, host[f"k{j}"], scan.alive)
                       for j, v in enumerate(vals))
        return IntermediateResult("distinct", group_keys=keys_h,
                                  stats=scan.stats(host, 0))

    return RowsLaunch(outs, finish)


# ---------------------------------------------------------------------------
# group-by and aggregation
# ---------------------------------------------------------------------------


def _agg_plan(ex, q, ctx, ev, aggs, full, params, counter, cols, filters,
              mask=None):
    """The pipeline's templates: the device template where an aggregation
    has one (the kernels read the stored planes), else value-space planes
    the card computes (``__x`` / ``__k`` / ``__v`` / ``__t`` cols); per
    template the decode a partial needs, if any; and per aggregation its
    slot: the index ``i`` of its template (leaves ``a{i}_...``), or its
    sketch (engine/sketches.py), which runs beside the pipeline.
    ``filters(FilterNode) -> (S, L) bool`` compiles the theta set form's
    filters over these rows."""
    tpls, decodes, slots = [], [], []
    shape = (ctx.S, ctx.pad_to)
    for a in aggs:
        name = a.name
        if name in sketches.NAMES:
            slots.append(sketches.plan(len(slots), a, ev, filters))
            continue
        i = len(tpls)
        dec = None
        if name in _PLAIN_AGGS:
            if name == "count" or expr_on_device(a.args[0], ctx):
                tpl = ex._agg_template(i, a, ctx, params, counter)
            else:
                # e.g. SUM($docId), or an MV column's entries: the value,
                # computed on the card
                key = f"__x{i}"
                v = ev.operand(a.args[0], full)
                if v.kind != "num":
                    # the host path's numeric reduction of strings fails
                    raise ValueError(f"{name.upper()} requires a numeric "
                                     f"argument, got {a.args[0]}")
                cols[key] = torch.broadcast_to(v.t, shape)
                extra = None
                if name in ("sum", "avg"):
                    extra = _sum_extra(i, a.args[0], v, ev, params)
                    if extra is None:
                        # an int64 sum that could wrap: the reference's
                        # host sums in float64
                        cols[key] = cols[key].to(torch.float64)
                        extra = (None, None)
                tpl = (name, ("raw", key), extra)
        elif name in _DISTINCT_ALIASES or name == "stunion":
            v = ev.eval(a.args[0], full)
            key = f"__k{i}"
            cols[key] = ev.set_key(v, shape)
            # STUNION's answer is the set of its values' texts
            tpl = ("distinctcount_v", key,
                   "sets" if name == "stunion" else None)
            dec = v
        elif name in ("firstwithtime", "lastwithtime"):
            # a point orders by its text
            v = ev.materialize(ev.eval(a.args[0], full))
            t = ev.eval(a.args[1], full)
            if t.kind != "num":
                t = _parsed_times(ev, t, a, mask)
            cols[f"__v{i}"] = torch.broadcast_to(
                v.t if v.kind == "num" else ev.key(v), shape)
            cols[f"__t{i}"] = torch.broadcast_to(t.t, shape)
            # integer values ride exactly, as the host path carries them
            exact = v.kind == "num" and v.dtype.kind in "biu"
            tpl = (name, (("raw", f"__v{i}"), ("raw", f"__t{i}")),
                   "exact" if exact else "pair")
            # values other than numbers ride as their order keys (string
            # order: ties go to the largest value, as for strings)
            dec = v if v.kind != "num" else None
        elif name in ("distinctcounthll", "hllmerge", "fasthll"):
            arg = a.args[0]
            if name != "hllmerge" and (
                    not arg.is_identifier or arg.name.startswith("$")):
                # an expression: its values hashed as the host hashes
                # their dtype, into K3's registers
                slots.append(sketches.plan(len(slots), a, ev, None))
                continue
            ev.column_dtype(arg.name)
            if name != "hllmerge" and (
                    ev.is_mv(arg.name)
                    or ctx.encoding(arg.name) != Encoding.DICT):
                # the reference's device reads dict columns only: a raw
                # column's registers take the sketch's K3 form
                slots.append(sketches.plan(len(slots), a, ev, None))
                continue
            if name == "fasthll":   # the reference's alias
                a = dataclasses.replace(a, name="distinctcounthll")
            tpl = ex._agg_template(i, a, ctx, params, counter)
        else:
            raise KeyError(f"unsupported aggregation function: {name}")
        slots.append(i)
        tpls.append(tpl)
        decodes.append(dec)
    return tuple(tpls), decodes, slots


def _sum_extra(i: int, arg, v: Val, ev, params: dict) -> tuple:
    """K1's (byte planes, rows per block) of an integer SUM / AVG over
    an MV column's entries or a column some segment predates, from the
    values' known range (the global dictionary's ends, or the column
    metadata's bounds with the defaults), its low end the ``off{i}``
    param; (None, None) where no range is known (the exact torch scatter
    sums it); None where the range says an int64 sum over the batch
    could wrap (Long.MIN defaults): the caller sums in float64."""
    import math

    from pinot_tpu_torch.ops import agg as agg_ops
    from pinot_tpu_torch.ops import groupby_mm as mm

    if not arg.is_identifier or arg.name.startswith("$") \
            or v.kind != "num" or v.dtype.kind not in "iub":
        return (None, None)
    if not ev.is_mv(arg.name):
        bounds = ev.ctx.exact_int_bounds(arg.name)
        if bounds is None:
            return (None, None)
    else:
        mp = ev.mv(arg.name)
        if mp is None:
            bounds = (0, 0)
        elif mp.kind == "dict":
            gv = np.asarray(ev.ctx.global_dict(arg.name).values)
            bounds = (int(gv[0]), int(gv[-1])) if len(gv) else (0, 0)
        else:
            metas = [s.column_metadata(arg.name) for s in ev.ctx.segments
                     if arg.name in s.metadata.columns]
            if any(not isinstance(m.min_value, (int, np.integer))
                   or not isinstance(m.max_value, (int, np.integer))
                   for m in metas):
                return (None, None)
            bounds = (min(int(m.min_value) for m in metas),
                      max(int(m.max_value) for m in metas))
    if max(abs(bounds[0]), abs(bounds[1])) * ev.S * ev.L >= 1 << 63:
        return None
    params[f"off{i}"] = torch.tensor(math.floor(bounds[0]),
                                     dtype=torch.int64, device=ev.device)
    return (mm.int_planes_needed(bounds[0], bounds[1]),
            agg_ops.rows_per_block_for(max(abs(bounds[0]), abs(bounds[1]))))


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
        # values other than numbers rode as their order keys
        keys = np.asarray(part["val"], dtype=np.float64)
        hit = ~np.isnan(keys)
        text = ev.decode_key(dec, keys[hit].astype(np.int64))
        out = np.empty(len(keys), dtype=object)
        out[hit] = [x.item() if isinstance(x, np.generic) else x
                    for x in text]
        part["val"] = out
    return part


def _parsed_times(ev, t: Val, a, mask) -> Val:
    """FIRST/LASTWITHTIME's times given as strings: each distinct value
    parsed once, as the host path reads its times (``np.asarray(...,
    dtype=np.int64)``), an int64 LUT gathered per row. A value that does
    not parse, among the rows the aggregation takes, fails the host path
    too: refused, quoting its error."""
    inv, (vals,) = ev.distinct([t], Rows(ev.S, ev.L, ev.device))
    parsed = np.zeros(len(vals), dtype=np.int64)
    errs = {}
    for j in range(len(vals)):
        try:
            parsed[j] = np.asarray(vals[j: j + 1], dtype=np.int64)[0]
        except (ValueError, TypeError, OverflowError) as err:
            errs[j] = err
    if errs:
        bad = torch.isin(inv, to_device(np.asarray(list(errs)), ev.device))
        if mask is not None:
            bad &= torch.broadcast_to(mask, bad.shape)
        if bool(bad.any()):
            raise host_fails(f"{a.name.upper()} over the times {a.args[1]}",
                             errs[int(inv[bad][0])])
    return Val(to_device(parsed, ev.device)[inv], "num", np.dtype(np.int64))


def _partials(slots, tpls, decodes, host, ctx, present, ev) -> list:
    """Each aggregation's partial, in the query's order."""
    return [_partial(s, tpls[s], host, ctx, present, decodes[s], ev)
            if isinstance(s, int) else s.partial(host, present)
            for s in slots]


def _post_entries(aggs, kept: int) -> int:
    return sum(kept * len(aggspec.make_spec(a).args) for a in aggs)


@dataclasses.dataclass
class _Space:
    """Rows aggregations run over, laid out like a batch: the batch
    itself, or its docs repeated per MV entry (``ev`` a
    ``SpaceEvaluator``). ``mask`` (S, Lx) the rows taken, ``n`` (S,)
    int32 the rows of each segment (a prefix of its row), ``src`` (S*Lx,)
    the batch position of each row's doc (None: the batch)."""

    ev: ValueEvaluator
    mask: torch.Tensor
    n: torch.Tensor
    src: torch.Tensor | None = None
    up: torch.Tensor | None = None   # (S*Lx,) each row's row in its parent


def _batch_space(scan: _Scan, ctx) -> _Space:
    return _Space(scan.ev, scan.mask, ctx.n_docs_dev)


def _entry_rows(ev, name: str, parent: _Space):
    """(Val, flat entry positions or None, Lx, base doc of each row, rows
    taken, rows per segment): one row per entry of MV column ``name`` of
    each row ``parent`` takes, in row then entry order. Over the batch
    itself the rows are the column's entries plane, masked."""
    S, L, dev = ev.S, ev.L, ev.device
    v, doc = ev.mv_values(name)
    if parent.src is None:
        E = v.t.shape[1]
        valid = doc >= 0
        src = (torch.arange(S, device=dev)[:, None] * L
               + torch.clamp(doc, min=0).to(torch.int64)).reshape(-1)
        mask = parent.mask.reshape(-1)[src].reshape(S, E) & valid
        return v, None, E, src, mask, valid.sum(dim=1).to(torch.int32)
    mp = ev.mv(name)
    Lp = parent.mask.shape[1]
    lens = torch.zeros_like(parent.src) if mp is None \
        else mp.lens.reshape(-1)[parent.src].to(torch.int64)
    counts = torch.where(parent.mask.reshape(-1), lens, 0).reshape(S, Lp)
    rsrc, rank, per, Lx = sel_ops.expand(counts)
    src = parent.src[rsrc]
    if mp is None:
        pos = torch.zeros_like(src)
    else:
        pos = (src // L) * mp.vals.shape[1] \
            + mp.start.reshape(-1)[src].to(torch.int64) + rank
    v = dataclasses.replace(v, t=v.t.reshape(-1)[pos].reshape(S, Lx))
    mask = torch.arange(Lx, device=dev)[None, :] < per[:, None]
    return v, (rsrc, pos), Lx, src, mask, per.to(torch.int32)


def _key_space(scan: _Scan, ctx, keys) -> _Space:
    """The rows an MV group-by takes: one per entry of each MV key of
    every matched doc, Cartesian across MV keys in doc, then key order
    (engine/host.py ``_expand_mv_groups``)."""
    ev = scan.ev
    space = _batch_space(scan, ctx)
    vals: dict = {}
    for g in keys:
        if not (g.is_identifier and ev.is_mv(g.name)) or g.name in vals:
            continue
        v, how, Lx, src, mask, n = _entry_rows(ev, g.name, space)
        if how is not None:     # earlier keys' values follow their rows
            rsrc = how[0]
            vals = {k: dataclasses.replace(
                x, t=x.t.reshape(-1)[rsrc].reshape(ev.S, Lx))
                for k, x in vals.items()}
        vals[g.name] = v
        space = _Space(SpaceEvaluator(ev, Lx, src, vals), mask, n, src)
    return space


def _entry_space(ev, name: str, parent: _Space, hashes: bool) -> _Space:
    """The entries of MV column ``name`` in the rows ``parent`` takes:
    the space an ``*MV`` aggregation runs its single-value form over,
    with the MV column's entry hashes where an HLL needs them."""
    v, how, Lx, src, mask, n = _entry_rows(ev, name, parent)
    h = {}
    if hashes:
        hp = ev.mv_hashes(name)
        h[name] = hp if how is None \
            else hp.reshape(-1)[how[1]].reshape(ev.S, Lx)
    return _Space(SpaceEvaluator(ev, Lx, src, {name: v}, h), mask, n, src,
                  src if how is None else how[0])


def _mv_groups(aggs) -> list:
    """The query's aggregations by the rows they run over: (None, [(query
    index, aggregation)]) for the rows themselves, then per MV column
    (name, [(query index, its single-value form)]) for its entries."""
    groups: dict = {None: []}
    for qi, a in enumerate(aggs):
        spec = aggspec.make_spec(a)
        if not spec.mv:
            groups[None].append((qi, a))
            continue
        arg = a.args[0]
        if not arg.is_identifier:
            raise NotImplementedError("MV aggregations take a bare MV column")
        groups.setdefault(arg.name, []).append(
            (qi, dataclasses.replace(a, name=a.name[:-2])))
    return list(groups.items())


def _run_aggs(ex, q, ctx, space: _Space, pairs_in, gid, G: int, final,
              alive) -> tuple:
    """The pipeline (engine/device.py) and the sketches over ``space``
    for the aggregations ``pairs_in``: (device leaves, the decode state
    ``_space_partials`` reads)."""
    from pinot_tpu_torch.engine.device import (
        STATE_AGGS,
        agg_columns,
        build_pipeline,
    )

    ev = space.ev
    S, Ls, dev = ctx.S, space.mask.shape[1], ctx.device
    aggs = [a for _qi, a in pairs_in]
    params, counter, cols = {}, [0], {}
    gathered = isinstance(ev, SpaceEvaluator)

    def filters(f):
        plane = filter_plane(f, ctx, ev.base if gathered else ev)
        return ev.gather(plane) if gathered else plane

    tpls, decodes, slots = _agg_plan(ex, q, ev.ctx, ev, aggs,
                                     Rows(S, Ls, dev), params, counter, cols,
                                     filters, space.mask)
    final = final and any(t[0] in STATE_AGGS for t in tpls)
    widths, base = ex.gather_columns(
        ctx, set().union(*(agg_columns(t) for t in tpls)), params)
    cols.update({k: ev.gather(v) for k, v in base.items()} if gathered
                else base)
    params["ps_alive"] = to_device(alive, dev)
    params["__mask__"] = space.mask
    if gid is None:
        template = ("agg", ("mask", "__mask__"), (), (), tpls, 0, final)
        ids = None
    else:
        cols["__gid__"] = torch.where(space.mask, gid.reshape(S, Ls), G) \
            .to(torch.int32)
        template = ("groupby", ("mask", "__mask__"), ("__gid__",), (G,),
                    tpls, 0, final)
        ids = cols["__gid__"].reshape(-1)
    outs = build_pipeline(template, widths, ex.min_rows)(cols, space.n,
                                                         params)
    for sk in slots:
        if not isinstance(sk, int):
            outs.update(sk.launch(sketches.Batch(ev, space.mask, ids,
                                                 1 if gid is None else G)))
    outs["hx_rows"] = space.mask.sum(dtype=torch.int64)
    return outs, (pairs_in, tpls, decodes, slots, ev, template)


def _space_partials(state, host, present) -> list:
    """(query index, partial) of each aggregation of one space."""
    pairs_in, tpls, decodes, slots, ev, _t = state
    parts = _partials(slots, tpls, decodes, host, ev.ctx, present, ev)
    return [(qi, part) for (qi, _a), part in zip(pairs_in, parts)]


def _aggregate(ex, q, ctx, final, reduce_mode, alive, aggs,
               valid=None) -> RowsLaunch:
    scan = _scan(q, ctx, alive, valid)
    ev, S = scan.ev, ctx.S
    outs0 = {"hx_matched": scan.mask.sum(dim=1, dtype=torch.int64)}
    groups = _mv_groups(aggs)
    has_mv_key = any(g.is_identifier and ev.is_mv(g.name)
                     for g in q.group_by or ())
    rows_space = _key_space(scan, ctx, q.group_by) if has_mv_key \
        else _batch_space(scan, ctx)

    def run_all(space, gid, G) -> tuple:
        outs, states = {}, []
        for j, (name, pairs_in) in enumerate(groups):
            if name is None:
                sp = space
            else:
                hashes = any(a.name in ("distinctcounthll",
                                        "distinctcountrawhll")
                             for _qi, a in pairs_in)
                sp = _entry_space(ev, name, space, hashes)
            g = gid if name is None or gid is None \
                else gid.reshape(-1)[sp.up]
            o, st = _run_aggs(ex, q, ctx, sp, pairs_in, g, G, final, alive)
            outs.update({f"g{j}:{k}": v for k, v in o.items()})
            states.append(st)
        return outs, states

    def post(host) -> int:
        n = 0
        for j, (name, pairs_in) in enumerate(groups):
            rows = int(host[f"g{j}:hx_rows"])
            n += rows * len(pairs_in) if name is not None else \
                _post_entries([a for _qi, a in pairs_in], rows)
        return n

    def assemble(host, states, present) -> list:
        out = [None] * len(aggs)
        for j, st in enumerate(states):
            hv = {k[len(f"g{j}:"):]: v for k, v in host.items()
                  if k.startswith(f"g{j}:")}
            for qi, part in _space_partials(st, hv, present):
                out[qi] = part
        return out

    if not q.group_by:
        outs, states = run_all(rows_space, None, 1)
        outs.update(outs0)

        def finish_scalar(host, _ex):
            return IntermediateResult(
                "aggregation", agg_partials=assemble(host, states, None),
                stats=scan.stats(host, post(host)))

        return RowsLaunch(outs, finish_scalar)

    xev = rows_space.ev
    full = Rows(S, rows_space.mask.shape[1], ctx.device)
    if not bool(rows_space.mask.any()):
        def finish_empty(host, _ex):
            specs = [aggspec.make_spec(a) for a in aggs]
            return IntermediateResult(
                "group_by",
                group_keys=tuple(xev.decode(xev.eval(g, full),
                                            np.zeros(0, dtype=np.int64))
                                 for g in q.group_by),
                agg_partials=[s.empty(0) for s in specs],
                stats=scan.stats(host, 0))

        return RowsLaunch(outs0, finish_empty)

    kvals, keys, cards = _key_columns(xev, q.group_by, rows_space.mask,
                                      full)
    agg_mask = rows_space.mask.reshape(-1)
    gid, G, gkeys = sel_ops.factorize(keys, agg_mask, cards)
    limit = ex.groups_limit(q)
    Lx = rows_space.mask.shape[1]
    keep = None
    if G > limit:
        idx = torch.nonzero(agg_mask).reshape(-1)
        keep = sel_ops.limit_groups(idx // Lx, gid[idx], G, S, limit)
    limit_reached = keep is not None
    if keep is not None:
        agg_mask = agg_mask.clone()
        agg_mask[idx[~keep]] = False
        # at most S * limit groups keep rows: number those alone, as the
        # host factorizes its kept rows again, so the pipeline's tables
        # are sized by what was kept, not by every group met
        gid, G, gkeys = sel_ops.factorize(keys, agg_mask, cards)
    kept = dataclasses.replace(rows_space, mask=agg_mask.reshape(S, Lx))
    outs, states = run_all(kept, gid, G)
    for j, k in enumerate(gkeys):
        outs[f"gk{j}"] = k
    # list-, dict- and set-valued partials, and those over MV entries,
    # have no order key to trim by
    pairs = len(groups) > 1 or any(
        not isinstance(sl, int) for sl in states[0][3]) or any(
        f"g0:a{i}_pg" in outs for i in range(len(states[0][1])))
    trim = None
    if reduce_mode is not None and not pairs:
        trim = dr_ops.plan_trim(q, q.group_by, aggs, G, reduce_mode,
                                ex.group_trim_size)
    if trim is not None:
        tr_k = torch.tensor(dr_ops.trim_keep_count(q, reduce_mode,
                                                   ex.group_trim_size),
                            dtype=torch.int64, device=ctx.device)
        rows_kept = outs.pop("g0:hx_rows")
        inner = {k[3:]: v for k, v in outs.items() if k.startswith("g0:")}
        inner.update({k: v for k, v in outs.items() if k.startswith("gk")})
        inner = dr_ops.apply_trim(
            inner, tr_k, states[0][5], trim,
            [xev.key_orders(v, k) for v, k in zip(kvals, gkeys)])
        outs = {(k if k.startswith(("gk", "trim_")) else f"g0:{k}"): v
                for k, v in inner.items()}
        outs["g0:hx_rows"] = rows_kept
    outs.update(outs0)

    def finish_groups(host, ex_):
        if "trim_keys" in host:
            present = np.arange(int(host["trim_n"]))
            ex_.device_reduce_queries += 1
        else:
            present = np.nonzero(host["g0:gcount"] > 0)[0]
        # the reference merges the segments that answered a group
        segs = host["hx_matched"] > 0
        key_values = tuple(xev.decode_key(v, host[f"gk{j}"][present], segs)
                           for j, v in enumerate(kvals))
        return IntermediateResult(
            "group_by", group_keys=key_values,
            agg_partials=assemble(host, states, present),
            stats=scan.stats(host, post(host), limit_reached))

    return RowsLaunch(outs, finish_groups)



# ---------------------------------------------------------------------------
# the multi-stage engine's leaf scans
# ---------------------------------------------------------------------------


def _leaf_runs(segments) -> list:
    """The segments in order, as runs: consecutive sealed ones a device
    batch, any other alone."""
    from pinot_tpu_torch.engine.device import segment_device_eligible

    runs, run = [], []
    for s in segments:
        if segment_device_eligible(s):
            run.append(s)
            continue
        if run:
            runs.append(run)
            run = []
        runs.append([s])
    return runs + ([run] if run else [])


def _leaf_col(ev, v: Val):
    """A gathered column ``Val`` as a query2 ``Col``."""
    from pinot_tpu_torch.query2.columns import Col, of_strings

    if v.kind == "num" and not isinstance(v.meta, Mixed):
        return Col(v.t.reshape(-1), v.dtype)
    if v.kind == "dict":   # the global dictionary is sorted and distinct
        values = np.asarray(ev.ctx.global_dict(v.meta).values)
        return Col(v.t.reshape(-1).to(torch.int64), values.dtype, values)
    if v.kind == "case":
        return of_strings(v.t.reshape(-1), np.asarray(v.meta))
    raise DeviceUnsupported(f"a {v.kind} column in a multi-stage leaf scan")


def _leaf_mv(ev, name: str, rows: Rows):
    """The matched rows of MV column ``name`` as a query2 ``MVCol``: their
    entries gathered into one ``Col`` in row then entry order, each row's
    (start, length) into it."""
    from pinot_tpu_torch.query2.columns import MVCol

    idx, dev = rows.idx, ev.device
    v, _doc = ev.mv_values(name)
    mp = ev.mv(name)
    if mp is None:
        lens = torch.zeros(idx.numel(), dtype=torch.int64, device=dev)
        base = lens
    else:
        E = v.t.shape[1]
        lens = mp.lens.reshape(-1)[idx].to(torch.int64)
        base = (idx // rows.L) * E + mp.start.reshape(-1)[idx].to(torch.int64)
    ends = torch.cumsum(lens, 0)
    starts = ends - lens
    row_of = torch.repeat_interleave(
        torch.arange(idx.numel(), device=dev), lens)
    pos = base[row_of] + torch.arange(row_of.numel(), device=dev) \
        - starts[row_of]
    vals = _leaf_col(ev, dataclasses.replace(v, t=v.t.reshape(-1)[pos]))
    return MVCol(vals, starts, lens)


def leaf_rows(ex, segments, filt, need: tuple, stats, max_rows: int,
              table: str) -> dict:
    """The matched rows of one table's ``segments`` → {column: query2
    ``Col``}, the multi-stage engine's stage 1 (the reference scans it on
    its host, pinot_tpu/query2/runner.py ``scan_local_rows``), on the card
    in its shape: the filter tree ``filt`` (None: every row) through the
    device's filter template (``filter_plane``), the columns ``need`` of
    the matched rows gathered through engine/values.py, rows in segment
    order and docs ascending within each. Sealed segments run as device
    batches, each run of consecutive ones one batch; a consuming segment,
    a tail or an upsert-masked segment runs alone, through a snapshot of
    the docs it publishes now and with its valid-docs plane
    (``DeviceExecutor.part_context``). ``stats`` (ExecutionStats) gains
    the reference host evaluator's counts: per segment queried, processed
    and matched, the filter's entries by index choice, ``len(need)``
    entries per matched row after it, every doc in totalDocs. Past
    ``max_rows`` matched rows the scan is refused, as the reference
    refuses it."""
    from pinot_tpu_torch.engine.device import segment_device_eligible
    from pinot_tpu_torch.query.context import Expression
    from pinot_tpu_torch.query2.columns import concat
    from pinot_tpu_torch.sql.parser import SqlAnalysisError

    parts: dict = {c: [] for c in need}
    total = 0
    for run in _leaf_runs(segments):
        if not segment_device_eligible(run[0]):
            ctx, key = ex.part_context(run[0])
            valid = ex.part_valid_plane(run[0], ctx)
        else:
            ctx, key, valid = ex.batch_for(run, retain=True), \
                ex._batch_key(run), None
        try:
            scan = _scan_filter(filt, ctx, np.ones(ctx.S, dtype=bool), valid)
            matched = scan.mask.sum(dim=1).cpu().numpy()
            stats.num_entries_scanned_in_filter += scan.entries_in_filter
            for j in range(ctx.S):
                m = int(matched[j])
                stats.num_segments_queried += 1
                stats.num_segments_processed += 1
                stats.num_docs_scanned += m
                stats.num_entries_scanned_post_filter += m * len(need)
                stats.total_docs += int(ctx.n_docs[j])
                stats.num_segments_matched += int(m > 0)
                total += m
                if total > max_rows:
                    raise SqlAnalysisError(
                        f"stage-1 row set for table {table!r} exceeds "
                        f"{max_rows} rows; add a more selective filter "
                        f"(PINOT_TPU_MAX_JOIN_ROWS overrides)")
            rows = Rows(ctx.S, ctx.pad_to, ctx.device, _matched_rows(scan))
            for c in need:
                # a part of a mesh may run on another shard's device
                if scan.ev.is_mv(c):
                    parts[c].append(_leaf_mv(scan.ev, c, rows).to(ex.device))
                    continue
                parts[c].append(_leaf_col(
                    scan.ev, scan.ev.eval(Expression.identifier(c),
                                          rows)).to(ex.device))
        finally:
            ex._release_launch(key)
    return {c: concat(parts[c], ex.device) for c in need}
