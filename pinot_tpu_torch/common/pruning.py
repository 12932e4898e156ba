"""Conservative min/max interval pruning (a copy of
pinot_tpu/common/pruning.py).

Used by the launch-time segment pruner (engine/engine.py SegmentPruner,
over segment metadata): an interval or membership test proves that a
segment cannot match, and any doubt keeps the segment.
"""

from __future__ import annotations

from pinot_tpu_torch.query.context import Predicate, PredicateType
from pinot_tpu_torch.storage.bloom import BloomFilter


def _lt(a, b) -> bool:
    """STRICT comparison: mixed str/number pairs raise TypeError, which
    callers treat as "incomparable → may match". Coercing them to strings
    (lexicographic order) could prune a segment whose scan would REJECT
    the same literal with a type error."""
    if isinstance(a, str) != isinstance(b, str):
        raise TypeError(
            f"incomparable literal: {type(a).__name__} vs {type(b).__name__}")
    return a < b


def interval_may_match(p: Predicate, mn, mx) -> bool:
    """May any value in [mn, mx] satisfy the predicate? Conservative: only
    EQ/IN/RANGE can prove exclusion, missing bounds and incomparable
    literals always "may match" (ColumnValueSegmentPruner's min/max
    check)."""
    if mn is None or mx is None:
        return True
    try:
        if p.type is PredicateType.EQ:
            return not (_lt(p.value, mn) or _lt(mx, p.value))
        if p.type is PredicateType.IN and p.values:
            return any(not (_lt(v, mn) or _lt(mx, v)) for v in p.values)
        if p.type is PredicateType.RANGE:
            if p.lower is not None:
                if _lt(mx, p.lower) or \
                        (mx == p.lower and not p.lower_inclusive):
                    return False
            if p.upper is not None:
                if _lt(p.upper, mn) or \
                        (mn == p.upper and not p.upper_inclusive):
                    return False
    except TypeError:
        return True  # incomparable literal: cannot prune
    return True


def provably_absent(seg, col: str, values) -> bool:
    """None of ``values`` can occur in the segment: exact dictionary
    membership when the segment has a (sorted, immutable) dictionary,
    else the bloom bitset. Conservative — any doubt (no index, uncastable
    literal) proves nothing."""
    try:
        d = seg.dictionary(col)
    except Exception:  # noqa: BLE001 — reader without dictionaries
        d = None
    if d is not None:
        try:
            return len(d.ids_of(list(values))) == 0
        except Exception:  # noqa: BLE001 — uncastable literal: no prune
            return False
    bloom_fn = getattr(seg, "bloom", None)
    bits = bloom_fn(col) if bloom_fn is not None else None
    if bits is not None:
        try:
            bf = BloomFilter(bits)
            return not any(bf.might_contain(v) for v in values)
        except Exception:  # noqa: BLE001 — odd literal: no prune
            return False
    return False
