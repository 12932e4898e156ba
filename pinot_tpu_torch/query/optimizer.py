"""Filter optimizer: rewrite the FilterNode tree before planning.

Equivalent of pinot-core/.../query/optimizer/filter/:
``FlattenAndOrFilterOptimizer``, ``MergeEqInFilterOptimizer``,
``MergeRangeFilterOptimizer``, plus constant folding
(``NumericalFilterOptimizer``'s always-true/false collapse).
"""

from __future__ import annotations

from typing import Optional

from pinot_tpu_torch.query.context import (
    FilterNode,
    FilterNodeType,
    Predicate,
    PredicateType,
    QueryContext,
)


def optimize_query(q: QueryContext) -> QueryContext:
    if q.filter is None:
        return q
    f = optimize_filter(q.filter)
    if f is q.filter:
        return q
    import dataclasses

    return dataclasses.replace(q, filter=f)


def optimize_filter(f: FilterNode) -> FilterNode:
    f = _flatten(f)
    f = _merge_eq_in(f)
    f = _merge_ranges(f)
    f = _fold_constants(f)
    return f


# ---------------------------------------------------------------------------


def _flatten(f: FilterNode) -> FilterNode:
    """AND(AND(a,b),c) → AND(a,b,c); same for OR; NOT(NOT(x)) → x."""
    if f.type is FilterNodeType.PREDICATE or f.type in (
        FilterNodeType.CONSTANT_TRUE,
        FilterNodeType.CONSTANT_FALSE,
    ):
        return f
    children = [_flatten(c) for c in f.children]
    if f.type is FilterNodeType.NOT:
        c = children[0]
        if c.type is FilterNodeType.NOT:
            return c.children[0]
        return FilterNode(FilterNodeType.NOT, children=(c,))
    out = []
    for c in children:
        if c.type is f.type:
            out.extend(c.children)
        else:
            out.append(c)
    if len(out) == 1:
        return out[0]
    return FilterNode(f.type, children=tuple(out))


def _merge_eq_in(f: FilterNode) -> FilterNode:
    """Under OR: EQ/IN predicates on the same expression merge into one IN
    (MergeEqInFilterOptimizer). Under AND the dual (intersection) applies."""
    if f.type not in (FilterNodeType.AND, FilterNodeType.OR):
        if f.type is FilterNodeType.NOT:
            return FilterNode.not_(_merge_eq_in(f.children[0]))
        return f
    children = [_merge_eq_in(c) for c in f.children]
    mergeable: dict = {}  # lhs -> set of values
    rest = []
    kinds = (PredicateType.EQ, PredicateType.IN)
    for c in children:
        if c.type is FilterNodeType.PREDICATE and c.predicate.type in kinds:
            p = c.predicate
            vals = {p.value} if p.type is PredicateType.EQ else set(p.values)
            if p.lhs in mergeable:
                if f.type is FilterNodeType.OR:
                    mergeable[p.lhs] |= vals
                else:
                    mergeable[p.lhs] &= vals
            else:
                mergeable[p.lhs] = vals
        else:
            rest.append(c)
    for lhs, vals in mergeable.items():
        if len(vals) == 0:
            rest.append(FilterNode.FALSE)
        elif len(vals) == 1:
            rest.append(
                FilterNode.pred(Predicate(PredicateType.EQ, lhs, value=next(iter(vals))))
            )
        else:
            rest.append(
                FilterNode.pred(
                    Predicate(PredicateType.IN, lhs, values=tuple(sorted(vals, key=repr)))
                )
            )
    if len(rest) == 1:
        return rest[0]
    return FilterNode(f.type, children=tuple(rest))


def _merge_ranges(f: FilterNode) -> FilterNode:
    """Under AND: multiple RANGE predicates on the same expression intersect
    into one (MergeRangeFilterOptimizer)."""
    if f.type is FilterNodeType.NOT:
        return FilterNode.not_(_merge_ranges(f.children[0]))
    if f.type is FilterNodeType.OR:
        children = tuple(_merge_ranges(c) for c in f.children)
        return FilterNode(FilterNodeType.OR, children=children)
    if f.type is not FilterNodeType.AND:
        return f
    children = [_merge_ranges(c) for c in f.children]
    ranges: dict = {}
    rest = []
    for c in children:
        if (
            c.type is FilterNodeType.PREDICATE
            and c.predicate.type is PredicateType.RANGE
        ):
            p = c.predicate
            if p.lhs in ranges:
                # an already-empty intersection (None) stays empty — a third
                # range on the same column must not resurrect it
                if ranges[p.lhs] is not None:
                    ranges[p.lhs] = _intersect(ranges[p.lhs], p)
            else:
                ranges[p.lhs] = p
        else:
            rest.append(c)
    for p in ranges.values():
        rest.append(FilterNode.pred(p) if p is not None else FilterNode.FALSE)
    if len(rest) == 1:
        return rest[0]
    return FilterNode(FilterNodeType.AND, children=tuple(rest))


def _intersect(a: Predicate, b: Predicate) -> Optional[Predicate]:
    lower, lower_inc = a.lower, a.lower_inclusive
    if b.lower is not None and (lower is None or b.lower > lower or (b.lower == lower and not b.lower_inclusive)):
        lower, lower_inc = b.lower, b.lower_inclusive
    upper, upper_inc = a.upper, a.upper_inclusive
    if b.upper is not None and (upper is None or b.upper < upper or (b.upper == upper and not b.upper_inclusive)):
        upper, upper_inc = b.upper, b.upper_inclusive
    if lower is not None and upper is not None:
        if lower > upper or (lower == upper and not (lower_inc and upper_inc)):
            return None  # empty range
    return Predicate(
        PredicateType.RANGE,
        a.lhs,
        lower=lower,
        upper=upper,
        lower_inclusive=lower_inc,
        upper_inclusive=upper_inc,
    )


def _fold_constants(f: FilterNode) -> FilterNode:
    if f.type is FilterNodeType.NOT:
        c = _fold_constants(f.children[0])
        if c.type is FilterNodeType.CONSTANT_TRUE:
            return FilterNode.FALSE
        if c.type is FilterNodeType.CONSTANT_FALSE:
            return FilterNode.TRUE
        return FilterNode.not_(c)
    if f.type not in (FilterNodeType.AND, FilterNodeType.OR):
        return f
    children = [_fold_constants(c) for c in f.children]
    out = []
    for c in children:
        if f.type is FilterNodeType.AND:
            if c.type is FilterNodeType.CONSTANT_FALSE:
                return FilterNode.FALSE
            if c.type is FilterNodeType.CONSTANT_TRUE:
                continue
        else:
            if c.type is FilterNodeType.CONSTANT_TRUE:
                return FilterNode.TRUE
            if c.type is FilterNodeType.CONSTANT_FALSE:
                continue
        out.append(c)
    if not out:
        return FilterNode.TRUE if f.type is FilterNodeType.AND else FilterNode.FALSE
    if len(out) == 1:
        return out[0]
    return FilterNode(f.type, children=tuple(out))
