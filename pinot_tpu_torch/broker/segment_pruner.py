"""Broker-side segment pruning: partition + time.

Equivalent of the reference's routing pruners
(pinot-broker/.../routing/segmentpruner/SinglePartitionColumnSegmentPruner.java,
TimeSegmentPruner.java + segmentpruner/interval/IntervalTree.java): before
scattering, drop segments whose recorded partition-id set or time range
provably cannot satisfy the query filter. Pruning is conservative — a segment
survives unless the filter *provably* excludes every one of its docs.

The evaluation walks the filter tree bottom-up over a three-value verdict
lattice (structural-no-match < stats-no-match < may-match): AND takes the
minimum, OR the maximum, NOT is always "may match" (the complement of a
partial exclusion proves nothing about the segment). The middle value
attributes prunes that ONLY the per-column min/max stats produced
(numSegmentsPrunedByValue) in a single walk; partition/time/FALSE prunes
are structural. Value comparisons ride the shared interval algebra
(common/pruning.py) so broker and server can never drift.
"""

from __future__ import annotations

from typing import Optional

from pinot_tpu_torch.cluster.registry import SegmentRecord
from pinot_tpu_torch.common.pruning import interval_may_match
from pinot_tpu_torch.query.context import (
    FilterNode,
    FilterNodeType,
    Predicate,
    PredicateType,
    QueryContext,
)
from pinot_tpu_torch.storage.partition import partition_of_value


def _value_in_time_range(v, lo, hi) -> bool:
    try:
        return not (v < lo or v > hi)
    except TypeError:
        return True  # incomparable literal: cannot prune


def _stats_may_match(p: Predicate, rec: SegmentRecord) -> bool:
    """Per-column min/max pruning on ANY column the record carries stats
    for — the shared interval algebra (common/pruning.py), so broker and
    server can never drift on bound or coercion semantics."""
    stats = (rec.column_stats or {}).get(p.lhs.name)
    if not stats:
        return True
    return interval_may_match(p, stats.get("min"), stats.get("max"))


# prune verdicts form a lattice: AND takes the minimum, OR the maximum.
# STATS_NO separates "only the value stats excluded it" (the reference's
# numSegmentsPrunedByValue breakdown) from structural partition/time/FALSE
# prunes in ONE tree walk — under AND a structural exclusion wins (the
# prune would happen without stats), under OR a stats child keeps the
# whole disjunct attributable to stats.
_STRUCT_NO, _STATS_NO, _MAY = 0, 1, 2


def _predicate_verdict(p: Predicate, rec: SegmentRecord,
                       time_column: Optional[str]) -> int:
    if not p.lhs.is_identifier:
        return _MAY
    col = p.lhs.name

    # ---- partition pruning (SinglePartitionColumnSegmentPruner) ----------
    if (
        rec.partition_column == col
        and rec.partition_ids
        and rec.partition_function
        and rec.num_partitions
    ):
        pids = set(rec.partition_ids)

        def pid(v) -> int:
            return partition_of_value(v, rec.partition_function, rec.num_partitions)

        try:
            if p.type is PredicateType.EQ:
                if pid(p.value) not in pids:
                    return _STRUCT_NO
            elif p.type is PredicateType.IN and p.values:
                if all(pid(v) not in pids for v in p.values):
                    return _STRUCT_NO
        except Exception:  # noqa: BLE001 — unhashable/odd literal: no pruning
            pass

    # ---- time pruning (TimeSegmentPruner) --------------------------------
    if (
        time_column is not None
        and col == time_column
        and rec.start_time is not None
        and rec.end_time is not None
    ):
        lo, hi = rec.start_time, rec.end_time
        try:
            if p.type is PredicateType.EQ:
                if not _value_in_time_range(p.value, lo, hi):
                    return _STRUCT_NO
            elif p.type is PredicateType.IN and p.values:
                if not any(_value_in_time_range(v, lo, hi)
                           for v in p.values):
                    return _STRUCT_NO
            elif p.type is PredicateType.RANGE:
                if p.lower is not None:
                    if p.lower > hi or (p.lower == hi and not p.lower_inclusive):
                        return _STRUCT_NO
                if p.upper is not None:
                    if p.upper < lo or (p.upper == lo and not p.upper_inclusive):
                        return _STRUCT_NO
        except TypeError:
            pass  # incomparable: fall through to the stats check

    # ---- per-column value stats (min/max on any column) ------------------
    if not _stats_may_match(p, rec):
        return _STATS_NO
    return _MAY


def _filter_verdict(f: FilterNode, rec: SegmentRecord,
                    time_column: Optional[str]) -> int:
    if f.type is FilterNodeType.PREDICATE:
        return _predicate_verdict(f.predicate, rec, time_column)
    if f.type is FilterNodeType.AND:
        return min((_filter_verdict(c, rec, time_column)
                    for c in f.children), default=_MAY)
    if f.type is FilterNodeType.OR:
        if not f.children:
            return _MAY  # degenerate OR: never prune on it
        return max(_filter_verdict(c, rec, time_column)
                   for c in f.children)
    if f.type is FilterNodeType.CONSTANT_FALSE:
        return _STRUCT_NO
    # NOT / CONSTANT_TRUE: conservative
    return _MAY


def _hybrid_boundary_filter(time_filter: Optional[dict]) -> Optional[FilterNode]:
    """The broker's hybrid time-boundary split (op le/gt) as a prunable
    RANGE predicate over the time column."""
    if not time_filter:
        return None
    from pinot_tpu_torch.query.context import Expression

    col = Expression.identifier(time_filter["column"])
    if time_filter["op"] == "le":
        p = Predicate(PredicateType.RANGE, col, upper=time_filter["value"],
                      upper_inclusive=True)
    else:  # gt
        p = Predicate(PredicateType.RANGE, col, lower=time_filter["value"],
                      lower_inclusive=False)
    return FilterNode.pred(p)


def prune_segments(
    q: Optional[QueryContext],
    records: dict[str, SegmentRecord],
    segments: list[str],
    time_column: Optional[str],
    time_filter: Optional[dict] = None,
) -> tuple[list[str], int, int]:
    """Return (surviving segments, pruned count, pruned-by-value count) for
    one routed instance. ``pruned-by-value`` counts the segments only the
    per-column min/max stats excluded (the reference's
    numSegmentsPrunedByValue breakdown) — partition/time prunes report in
    the total alone."""
    filters = []
    if q is not None and q.filter is not None:
        filters.append(q.filter)
    bf = _hybrid_boundary_filter(time_filter)
    if bf is not None:
        filters.append(bf)
    if not filters:
        return segments, 0, 0
    tree = filters[0] if len(filters) == 1 else FilterNode.and_(*filters)
    out = []
    by_value = 0
    for s in segments:
        rec = records.get(s)
        v = _MAY if rec is None else _filter_verdict(tree, rec, time_column)
        if v == _MAY:
            out.append(s)
        elif v == _STATS_NO:
            by_value += 1  # only the value stats excluded it
    return out, len(segments) - len(out), by_value
