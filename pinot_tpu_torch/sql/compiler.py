"""SQL AST → QueryContext compiler.

Role-equivalent of the reference's QueryContextConverterUtils +
RequestContextUtils (pinot-common/.../common/request/context/
RequestContextUtils.java: expression → FilterContext lowering) plus the
rewriter chain (sql/parsers/rewriter/: alias + ordinal resolution).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pinot_tpu_torch.query.context import (
    Expression,
    ExpressionType,
    FilterNode,
    FilterNodeType,
    OrderByExpression,
    Predicate,
    PredicateType,
    QueryContext,
)
from pinot_tpu_torch.sql.parser import SqlParseError, SqlSelect, parse_sql

DEFAULT_LIMIT = 10  # reference: CalciteSqlParser DEFAULT_LIMIT


def compile_query(sql: str) -> QueryContext:
    return compile_select(parse_sql(sql))


def contains_window(e: Expression) -> bool:
    """True when a ``__window__`` marker (OVER clause) appears anywhere in
    the expression tree."""
    if not e.is_function:
        return False
    if e.name == "__window__":
        return True
    return any(contains_window(a) for a in e.args)


def is_multistage(stmt: SqlSelect) -> bool:
    """Joins or window functions route through the multi-stage engine
    (query2/); everything else stays on the single-stage path untouched."""
    if stmt.joins:
        return True
    exprs = [e for e, _ in stmt.select]
    exprs.extend(e for e, _ in stmt.order_by)
    if stmt.having is not None:
        exprs.append(stmt.having)
    if stmt.where is not None:
        exprs.append(stmt.where)
    exprs.extend(stmt.group_by)
    return any(contains_window(e) for e in exprs)


def _strip_alias(e: Expression, alias: str) -> Expression:
    """``alias.col`` → ``col`` for a single-table query's own alias, so
    FROM t x / SELECT x.c rides the single-stage path unchanged."""
    if e.is_identifier and e.name.startswith(alias + "."):
        return Expression.identifier(e.name[len(alias) + 1:])
    if e.is_function:
        return Expression(
            ExpressionType.FUNCTION, name=e.name,
            args=tuple(_strip_alias(a, alias) for a in e.args))
    return e


def compile_select(stmt: SqlSelect) -> QueryContext:
    if is_multistage(stmt):
        # the planner (query2/logical.py) owns joins and windows; reaching
        # this single-stage entry with one is a routing bug or a direct
        # server submit of a query only the broker/engine can decompose
        raise SqlParseError(
            "join/window queries compile through the multi-stage engine "
            "(query2), not the single-stage compiler")
    # de-qualify single-table references: the explicit alias when one was
    # written (SELECT x.c FROM t x), else the table name itself
    # (SELECT t.c FROM t)
    a = stmt.table_alias or stmt.table
    if a:
        stmt = dataclasses.replace(
            stmt,
            select=[(_strip_alias(e, a), al) for e, al in stmt.select],
            where=None if stmt.where is None else _strip_alias(stmt.where, a),
            group_by=[_strip_alias(e, a) for e in stmt.group_by],
            having=None if stmt.having is None
            else _strip_alias(stmt.having, a),
            order_by=[(_strip_alias(e, a), asc)
                      for e, asc in stmt.order_by],
        )
    select_exprs = tuple(e for e, _ in stmt.select)
    aliases = tuple(a for _, a in stmt.select)
    alias_map = {a: e for e, a in stmt.select if a}

    group_by = tuple(
        _resolve_ref(e, select_exprs, alias_map) for e in stmt.group_by
    )
    order_by = tuple(
        OrderByExpression(_resolve_ref(e, select_exprs, alias_map), asc)
        for e, asc in stmt.order_by
    )

    filt = _to_filter(stmt.where) if stmt.where is not None else None
    having = None
    if stmt.having is not None:
        having = _to_filter(_substitute_aliases(stmt.having, alias_map))

    return QueryContext(
        table_name=stmt.table,
        select_expressions=select_exprs,
        aliases=aliases,
        distinct=stmt.distinct,
        filter=filt,
        group_by=group_by,
        having=having,
        order_by=order_by,
        limit=stmt.limit if stmt.limit is not None else DEFAULT_LIMIT,
        offset=stmt.offset,
        options=tuple(sorted(stmt.options.items())),
        explain=stmt.explain,
        analyze=stmt.analyze,
    )


# ---------------------------------------------------------------------------
# alias / ordinal resolution (rewriter chain analog)
# ---------------------------------------------------------------------------


def _resolve_ref(e: Expression, select_exprs: tuple, alias_map: dict) -> Expression:
    """GROUP BY 2 / ORDER BY alias → the underlying select expression."""
    if e.is_literal and isinstance(e.value, int) and not isinstance(e.value, bool):
        i = e.value - 1
        if 0 <= i < len(select_exprs):
            return select_exprs[i]
        raise SqlParseError(f"ordinal {e.value} out of range")
    return _substitute_aliases(e, alias_map)


def _substitute_aliases(e: Expression, alias_map: dict) -> Expression:
    if e.is_identifier and e.name in alias_map:
        return alias_map[e.name]
    if e.is_function:
        return Expression(
            ExpressionType.FUNCTION,
            name=e.name,
            args=tuple(_substitute_aliases(a, alias_map) for a in e.args),
        )
    return e


# ---------------------------------------------------------------------------
# boolean expression → filter tree
# ---------------------------------------------------------------------------

_CMP_TO_RANGE = {
    "greater_than": (False, "lower"),
    "greater_than_or_equal": (True, "lower"),
    "less_than": (False, "upper"),
    "less_than_or_equal": (True, "upper"),
}


def _to_filter(e: Expression) -> FilterNode:
    """Lower a boolean expression tree into a FilterNode tree
    (RequestContextUtils.getFilter analog)."""
    if e.is_literal:
        return FilterNode.TRUE if e.value else FilterNode.FALSE
    if not e.is_function:
        raise SqlParseError(f"non-boolean filter expression: {e}")

    name = e.name
    if name in ("and", "or"):
        # flatten left-assoc chains into n-ary nodes at construction
        node_t = FilterNodeType.AND if name == "and" else FilterNodeType.OR
        kids = []
        for a in e.args:
            c = _to_filter(a)
            if c.type is node_t:
                kids.extend(c.children)
            else:
                kids.append(c)
        return FilterNode(node_t, children=tuple(kids))
    if name == "not":
        return FilterNode.not_(_to_filter(e.args[0]))

    if name in ("equals", "not_equals"):
        lhs, rhs = _operand_literal(e.args[0], e.args[1])
        t = PredicateType.EQ if name == "equals" else PredicateType.NOT_EQ
        return FilterNode.pred(Predicate(t, lhs, value=rhs))

    if name in _CMP_TO_RANGE:
        lhs, rhs, flipped = _operand_literal_flippable(e.args[0], e.args[1])
        cname = _flip_cmp(name) if flipped else name
        inclusive, side = _CMP_TO_RANGE[cname]
        kw = (
            dict(lower=rhs, lower_inclusive=inclusive, upper=None)
            if side == "lower"
            else dict(upper=rhs, upper_inclusive=inclusive, lower=None)
        )
        return FilterNode.pred(Predicate(PredicateType.RANGE, lhs, **kw))

    if name == "between":
        lhs = e.args[0]
        lo = _require_literal(e.args[1])
        hi = _require_literal(e.args[2])
        return FilterNode.pred(
            Predicate(PredicateType.RANGE, lhs, lower=lo, upper=hi)
        )

    if name in ("in", "not_in"):
        lhs = e.args[0]
        vals = tuple(_require_literal(a) for a in e.args[1:])
        t = PredicateType.IN if name == "in" else PredicateType.NOT_IN
        return FilterNode.pred(Predicate(t, lhs, values=vals))

    if name == "like":
        lhs = e.args[0]
        pat = _require_literal(e.args[1])
        return FilterNode.pred(Predicate(PredicateType.LIKE, lhs, value=pat))

    if name in ("regexp_like", "text_match", "json_match"):
        lhs = e.args[0]
        pat = _require_literal(e.args[1])
        t = {
            "regexp_like": PredicateType.REGEXP_LIKE,
            "text_match": PredicateType.TEXT_MATCH,
            "json_match": PredicateType.JSON_MATCH,
        }[name]
        return FilterNode.pred(Predicate(t, lhs, value=pat))

    if name == "is_null":
        return FilterNode.pred(Predicate(PredicateType.IS_NULL, e.args[0]))
    if name == "is_not_null":
        return FilterNode.pred(Predicate(PredicateType.IS_NOT_NULL, e.args[0]))

    # boolean-valued transform functions (ST_CONTAINS, STARTSWITH, ...)
    # filter as `expr = true` — the reference wraps these the same way
    # (RequestContextUtils' EQ-true predicate over a boolean transform)
    from pinot_tpu_torch.ops.transform import REGISTRY

    fd = REGISTRY.get(name)
    if fd is not None and fd.returns_bool:
        return FilterNode.pred(Predicate(PredicateType.EQ, e, value=True))

    raise SqlParseError(f"cannot use {name}() as a filter")


def _flip_cmp(name: str) -> str:
    return {
        "greater_than": "less_than",
        "greater_than_or_equal": "less_than_or_equal",
        "less_than": "greater_than",
        "less_than_or_equal": "greater_than_or_equal",
    }[name]


def _operand_literal(a: Expression, b: Expression):
    """Normalize (expr, literal) operand order for symmetric predicates."""
    if b.is_literal:
        return a, b.value
    if a.is_literal:
        return b, a.value
    raise SqlParseError(f"predicate requires a literal operand: {a} vs {b}")


def _operand_literal_flippable(a: Expression, b: Expression):
    if b.is_literal:
        return a, b.value, False
    if a.is_literal:
        return b, a.value, True
    raise SqlParseError(f"predicate requires a literal operand: {a} vs {b}")


def _require_literal(e: Expression):
    if not e.is_literal:
        raise SqlParseError(f"expected literal, got {e}")
    return e.value
