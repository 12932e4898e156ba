"""Star-tree query substitution and the metadata-only aggregation fast
path: a copy of pinot_tpu/engine/startree_exec.py.

Reference: AggregationPlanNode.java:186-210 — before planning a scan, try
(a) the metadata-only path (NonScanBasedAggregationOperator, :234-259:
COUNT(*) from the segment's doc count, MIN/MAX from column metadata) and
(b) the star-tree substitution (StarTreeUtils.isFitForStarTree → swap the
plan onto pre-aggregated docs).

(b) re-enters the engine over the cube segments (storage/startree.py)
with a rewritten query — sum(x) → sum(sum__x), count(*) →
sum(count__star), DISTINCTCOUNTHLL(x) → HLLMERGE(distinctcounthll__x) —
which runs on the card like any query, then converts the partials back to
the original aggregations' canonical layout, so the merge and the reduce
cannot tell the difference. The merges the JAX package's device has no
form for (TDIGESTMERGE, BITMAPMERGE, SUMPRECISIONMERGE over the cube's
serialized states) run in its host path's shape on the card
(engine/sketches.py), so ``fit`` decides as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from pinot_tpu_torch.engine.result import IntermediateResult
from pinot_tpu_torch.query.context import Expression, QueryContext
from pinot_tpu_torch.storage.startree import SEP, load_star_trees, pair_column, parse_pair

_REWRITABLE = {"count", "sum", "min", "max", "avg", "minmaxrange",
               "distinctcounthll", "percentiletdigest", "percentile",
               "percentileest", "distinctcount", "distinctcountbitmap",
               "sumprecision"}


def _q2_expr(fn: str, col: str, meta: dict) -> Expression:
    """The cube-side aggregation expression for one mapping entry."""
    if fn == "hllmerge":
        # the state column's plane width must be decoded with the SAME m it
        # was built with; carried as a literal arg like HLL's log2m
        return Expression.function(
            "hllmerge", Expression.identifier(col),
            Expression.literal(int(meta["hll_log2m"])),
        )
    if fn == "tdigestmerge":
        # p is irrelevant at merge time (the ORIGINAL agg finalizes);
        # compression governs re-merge compaction. The state column's PAIR
        # FUNCTION (exact match on the name half, not a prefix) identifies
        # which pair built the digests, hence which compression.
        pair_fn = col.split(SEP, 1)[0]
        comp = meta["tdigest_compression"] if pair_fn == "percentiletdigest" \
            else meta["percentileest_compression"]
        return Expression.function(
            "tdigestmerge", Expression.identifier(col),
            Expression.literal(0.5),
            Expression.literal(float(comp)),
        )
    return Expression.function(fn, Expression.identifier(col))


@dataclasses.dataclass
class StarTreePlan:
    q2: QueryContext
    st_segment: object
    # per original agg: list of (q2-agg expression, role) where role names the
    # canonical partial field the q2 partial feeds
    mapping: list
    meta: dict


def _available_pairs(meta: dict) -> set:
    return {tuple(parse_pair(p)) for p in meta["function_column_pairs"]}


def _has_null_predicate(f) -> bool:
    from pinot_tpu_torch.query.context import FilterNodeType, PredicateType

    if f.type is FilterNodeType.PREDICATE:
        return f.predicate.type in (PredicateType.IS_NULL,
                                    PredicateType.IS_NOT_NULL)
    return any(_has_null_predicate(c) for c in f.children or ())


def fit(q: QueryContext, meta: dict) -> Optional[list]:
    """StarTreeUtils.isFitForStarTree analog. Returns the per-agg rewrite
    mapping, or None."""
    if q.distinct or not q.aggregations():
        return None
    if dict(q.options).get("useStarTree") is False:
        return None
    dims = set(meta["dimensions_split_order"])
    if q.filter is not None:
        if not q.filter.columns() <= dims:
            return None
        # null vectors don't survive into the pre-aggregated tree (its rows
        # carry substituted default values), so IS_NULL must scan
        if _has_null_predicate(q.filter):
            return None
    for g in q.group_by:
        if not g.is_identifier or g.name not in dims:
            return None
    pairs = _available_pairs(meta)
    mapping = []
    for a in q.aggregations():
        name = a.name
        if name not in _REWRITABLE:
            return None
        if name == "count":
            if ("count", "*") not in pairs:
                return None
            mapping.append([("sum", pair_column("count", "*"), "count")])
            continue
        arg = a.args[0]
        if not arg.is_identifier:
            return None
        col = arg.name
        if name == "distinctcounthll":
            # sketch pair: cube rows carry register planes, re-merged by
            # HLLMERGE — only if the plane resolution matches the query's
            from pinot_tpu_torch.engine.aggspec import make_spec

            if ("distinctcounthll", col) not in pairs:
                return None
            if meta.get("hll_log2m") != make_spec(a).log2m:
                return None
            mapping.append(
                [("hllmerge", pair_column("distinctcounthll", col), "state")])
            continue
        if name in ("percentiletdigest", "percentile", "percentileest"):
            # digest pairs: cube rows carry serialized t-digests, re-merged
            # by TDIGESTMERGE — only when a pair's digest compression
            # matches the query's (a mismatch would silently change the
            # error bound). All three names share the digest algebra; the
            # PERCENTILETDIGEST pair serves compression-100-family queries
            # and the PERCENTILEEST pair the PERCENTILE/EST default.
            from pinot_tpu_torch.engine.aggspec import make_spec

            want = make_spec(a).compression
            if ("percentiletdigest", col) in pairs \
                    and meta.get("tdigest_compression") == want:
                src = "percentiletdigest"
            elif ("percentileest", col) in pairs \
                    and meta.get("percentileest_compression") == want:
                src = "percentileest"
            else:
                return None
            mapping.append(
                [("tdigestmerge", pair_column(src, col), "state")])
            continue
        if name in ("distinctcount", "distinctcountbitmap"):
            # exact distinct pair: serialized value sets per cube row,
            # re-unioned by BITMAPMERGE (DistinctCountBitmapValueAggregator)
            if ("distinctcountbitmap", col) not in pairs:
                return None
            mapping.append(
                [("bitmapmerge", pair_column("distinctcountbitmap", col),
                  "state")])
            continue
        if name == "sumprecision":
            if ("sumprecision", col) not in pairs:
                return None
            mapping.append(
                [("sumprecisionmerge", pair_column("sumprecision", col),
                  "state")])
            continue
        need = {
            "sum": [("sum", col, "sum")],
            "min": [("min", col, "min")],
            "max": [("max", col, "max")],
            "avg": [("sum", col, "sum"), ("count", "*", "count")],
            "minmaxrange": [("min", col, "min"), ("max", col, "max")],
        }[name]
        for fn, c, _role in need:
            if (fn, c) not in pairs:
                return None
        mapping.append(
            [
                (("sum" if fn == "count" else fn), pair_column(fn, c), role)
                for fn, c, role in need
            ]
        )
    return mapping


def build_plan(q: QueryContext, meta: dict, st_segment) -> Optional[StarTreePlan]:
    mapping = fit(q, meta)
    if mapping is None:
        return None
    # dedup q2 aggregations, preserving order
    q2_aggs: dict = {}
    for entries in mapping:
        for fn, col, _role in entries:
            q2_aggs.setdefault(_q2_expr(fn, col, meta))
    q2 = dataclasses.replace(
        q,
        select_expressions=tuple(q2_aggs),
        aliases=tuple([None] * len(q2_aggs)),
        having=None,
        order_by=(),
    )
    return StarTreePlan(q2=q2, st_segment=st_segment, mapping=mapping,
                        meta=meta)


def convert(result: IntermediateResult, plan: StarTreePlan, q: QueryContext,
            parent_total_docs: int) -> IntermediateResult:
    """q2 partials → the original aggregations' canonical partial layout."""
    q2_aggs = list(plan.q2.aggregations())
    index = {a: i for i, a in enumerate(q2_aggs)}
    out_partials = []
    for orig, entries in zip(q.aggregations(), plan.mapping):
        partial: dict = {}
        for fn, col, role in entries:
            p2 = result.agg_partials[index[_q2_expr(fn, col, plan.meta)]]
            if role == "count":
                partial["count"] = np.rint(p2["sum"]).astype(np.int64)
            elif role == "state":
                # sketch states pass through verbatim (regs — or est when
                # the cube execution finalized on device)
                partial.update(p2)
            else:
                partial[role] = p2[role if role in p2 else "sum"]
        out_partials.append(partial)
    stats = result.stats
    stats.total_docs = parent_total_docs
    return IntermediateResult(
        result.shape,
        agg_partials=out_partials,
        group_keys=result.group_keys,
        stats=stats,
    )


def _trees_for(segment) -> list:
    if getattr(segment, "is_mutable", False):
        return []
    # Upsert guard: the star-tree was pre-aggregated over ALL rows at seal
    # time; a validDocIds mask invalidates those partials (the reference
    # forbids star-tree on upsert tables — TableConfigUtils validation).
    if getattr(segment, "valid_docs_mask", None) is not None:
        return []
    trees = getattr(segment, "_star_trees_cache", None)
    if trees is None:
        try:
            trees = load_star_trees(segment)
        except Exception:
            trees = []
        segment._star_trees_cache = trees
    return trees


def fitting_tree(q: QueryContext, segment):
    """(meta_signature, meta, st_segment) for the first fitting star-tree."""
    for meta, st_seg in _trees_for(segment):
        if fit(q, meta) is not None:
            sig = (
                tuple(meta["dimensions_split_order"]),
                tuple(sorted(meta["function_column_pairs"])),
            )
            return sig, meta, st_seg
    return None


def execute_star_tree_group(engine, q: QueryContext, meta: dict, st_segments: list,
                            parent_total_docs: int,
                            terminal: bool = False) -> IntermediateResult:
    """One batched execution over MANY segments' star-trees sharing a
    signature — a single device launch replaces per-segment tree traversals
    (and per-segment kernel dispatches, which dominate when the pre-agg data
    is tiny). ``terminal``: no upstream merge — sketch re-merges may
    finalize on device (convert passes their 'est' partials through)."""
    plan = build_plan(q, meta, st_segments[0])
    # trim_ok=False: the outer finalize runs under q, not plan.q2 — an
    # in-kernel trim keyed to q2's order/limit could drop cube rows the
    # parent query's reduce still needs
    r2 = engine.execute_segments(plan.q2, st_segments, terminal=terminal,
                                 trim_ok=False)
    return convert(r2, plan, q, parent_total_docs)


# ---------------------------------------------------------------------------
# metadata-only aggregation (NonScanBasedAggregationOperator analog)
# ---------------------------------------------------------------------------


def try_metadata_only(q: QueryContext, segment) -> Optional[IntermediateResult]:
    """COUNT(*)/MIN/MAX with no filter and no group-by answer straight from
    segment metadata — zero scan (AggregationPlanNode.java:234-259)."""
    from pinot_tpu_torch.engine.result import ExecutionStats

    if q.filter is not None or q.group_by or q.distinct:
        return None
    aggs = q.aggregations()
    if not aggs:
        return None
    if getattr(segment, "is_mutable", False) or \
            getattr(segment, "valid_docs_mask", None) is not None:
        return None
    partials = []
    for a in aggs:
        if a.name == "count":
            partials.append({"count": np.array([segment.n_docs], dtype=np.int64)})
            continue
        if a.name not in ("min", "max") or not a.args or not a.args[0].is_identifier:
            return None
        col = a.args[0].name
        if col not in segment.metadata.columns:
            return None
        meta = segment.column_metadata(col)
        v = meta.min_value if a.name == "min" else meta.max_value
        if v is None or isinstance(v, str) or segment.n_docs == 0:
            return None
        partials.append({a.name: np.array([float(v)])})
    stats = ExecutionStats(
        num_docs_scanned=segment.n_docs,  # reference counts docs "matched"
        num_segments_processed=1,
        num_segments_queried=1,
        num_segments_matched=1 if segment.n_docs else 0,
        total_docs=segment.n_docs,
    )
    return IntermediateResult("aggregation", agg_partials=partials, stats=stats)
