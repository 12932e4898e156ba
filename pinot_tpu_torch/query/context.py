"""Engine-internal query IR.

Equivalent of the reference's request-context layer
(pinot-common/.../common/request/context/: ``ExpressionContext``,
``FilterContext``, ``predicate/*``, and pinot-core's ``QueryContext``,
query/request/context/QueryContext.java): the SQL front-end compiles the AST
into this IR, and the plan maker dispatches on it.

TPU-first deviation: every node here is a frozen, hashable dataclass built
from tuples. The executor keys its jit cache on the *structural template* of
a QueryContext (literals parameterized out), so two queries differing only in
literal values reuse one compiled kernel pipeline — the moral equivalent of
the reference compiling per query shape in
``InstancePlanMakerImplV2.makeSegmentPlanNode`` (:237-252) but with explicit
compile-once-per-template semantics that XLA requires.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class ExpressionType(enum.Enum):
    LITERAL = "LITERAL"
    IDENTIFIER = "IDENTIFIER"
    FUNCTION = "FUNCTION"


@dataclasses.dataclass(frozen=True)
class Expression:
    """One node of an expression tree (ExpressionContext.java analog)."""

    type: ExpressionType
    # exactly one of the below is meaningful, per `type`
    value: object = None          # LITERAL: python scalar (str/int/float/bool/None)
    name: str = ""                # IDENTIFIER: column name; FUNCTION: canonical fn name
    args: tuple = ()  # FUNCTION args: tuple[Expression, ...]

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def literal(value) -> "Expression":
        return Expression(ExpressionType.LITERAL, value=value)

    @staticmethod
    def identifier(name: str) -> "Expression":
        return Expression(ExpressionType.IDENTIFIER, name=name)

    @staticmethod
    def function(name: str, *args: "Expression") -> "Expression":
        return Expression(ExpressionType.FUNCTION, name=name.lower(), args=tuple(args))

    # ---- helpers ---------------------------------------------------------
    @property
    def is_literal(self) -> bool:
        return self.type is ExpressionType.LITERAL

    @property
    def is_identifier(self) -> bool:
        return self.type is ExpressionType.IDENTIFIER

    @property
    def is_function(self) -> bool:
        return self.type is ExpressionType.FUNCTION

    def columns(self) -> set[str]:
        """All identifier names referenced under this expression."""
        if self.is_identifier:
            return {self.name} if self.name != "*" else set()
        if self.is_function:
            out: set[str] = set()
            for a in self.args:
                out |= a.columns()
            return out
        return set()

    def __str__(self) -> str:  # EXPLAIN / debugging
        if self.is_literal:
            return repr(self.value) if isinstance(self.value, str) else str(self.value)
        if self.is_identifier:
            return self.name
        return f"{self.name}({','.join(str(a) for a in self.args)})"


STAR = Expression.identifier("*")

# Aggregation function names the engine understands (reference:
# pinot-core/.../query/aggregation/function/AggregationFunctionFactory.java).
AGGREGATION_FUNCTIONS = frozenset(
    {
        "count",
        "sum",
        "min",
        "max",
        "avg",
        "minmaxrange",
        "sumprecision",
        "distinctcount",
        "distinctcountbitmap",
        "distinctcounthll",
        "distinctcountthetasketch",
        "distinctcountrawthetasketch",
        "distinctcountsmarthll",
        "distinctcountrawhll",
        "fasthll",
        "segmentpartitioneddistinctcount",
        "percentile",
        "percentileest",
        "percentilerawest",
        "percentiletdigest",
        "percentilerawtdigest",
        "percentilesmarttdigest",
        "mode",
        "firstwithtime",
        "lastwithtime",
        "idset",
        "stunion",
        "st_union",
        # MV variants
        "countmv",
        "summv",
        "minmv",
        "maxmv",
        "avgmv",
        "minmaxrangemv",
        "distinctcountmv",
        "distinctcountbitmapmv",
        "distinctcounthllmv",
        "distinctcountrawhllmv",
        "percentilemv",
        "percentileestmv",
        "percentiletdigestmv",
        "percentilerawestmv",
        "percentilerawtdigestmv",
        # internal: star-tree sketch-state re-merges (engine/startree_exec.py)
        "hllmerge",
        "tdigestmerge",
        "bitmapmerge",
        "sumprecisionmerge",
    }
)


def is_aggregation(expr: Expression) -> bool:
    return expr.is_function and expr.name in AGGREGATION_FUNCTIONS


def find_aggregations(expr: Expression) -> list[Expression]:
    """All aggregation sub-expressions, depth-first (dedup preserved later).
    ``__window__`` nodes are opaque: SUM(x) OVER (...) is a window function
    owned by the multi-stage runner, not a mergeable aggregation."""
    if not expr.is_function or expr.name == "__window__":
        return []
    if is_aggregation(expr):
        return [expr]
    out = []
    for a in expr.args:
        out.extend(find_aggregations(a))
    return out


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


class PredicateType(enum.Enum):
    EQ = "EQ"
    NOT_EQ = "NOT_EQ"
    IN = "IN"
    NOT_IN = "NOT_IN"
    RANGE = "RANGE"
    REGEXP_LIKE = "REGEXP_LIKE"
    LIKE = "LIKE"
    TEXT_MATCH = "TEXT_MATCH"
    JSON_MATCH = "JSON_MATCH"
    IS_NULL = "IS_NULL"
    IS_NOT_NULL = "IS_NOT_NULL"


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A leaf predicate over one expression (predicate/*.java analog).

    RANGE uses ``lower``/``upper`` (None = unbounded) with inclusivity flags,
    like the reference's RangePredicate string form ``(lo\x00hi]``.
    """

    type: PredicateType
    lhs: Expression
    # EQ/NOT_EQ: value in `value`; IN/NOT_IN: tuple in `values`;
    # RANGE: lower/upper; LIKE/REGEXP_LIKE/TEXT_MATCH/JSON_MATCH: pattern in `value`
    value: object = None
    values: tuple = ()
    lower: object = None
    upper: object = None
    lower_inclusive: bool = True
    upper_inclusive: bool = True

    def __str__(self) -> str:
        t = self.type
        if t is PredicateType.EQ:
            return f"{self.lhs} = {self.value!r}"
        if t is PredicateType.NOT_EQ:
            return f"{self.lhs} != {self.value!r}"
        if t in (PredicateType.IN, PredicateType.NOT_IN):
            op = "IN" if t is PredicateType.IN else "NOT IN"
            return f"{self.lhs} {op} ({','.join(map(repr, self.values))})"
        if t is PredicateType.RANGE:
            lo = "(" if not self.lower_inclusive else "["
            hi = ")" if not self.upper_inclusive else "]"
            return f"{self.lhs} {lo}{self.lower},{self.upper}{hi}"
        if t is PredicateType.IS_NULL:
            return f"{self.lhs} IS NULL"
        if t is PredicateType.IS_NOT_NULL:
            return f"{self.lhs} IS NOT NULL"
        return f"{t.value}({self.lhs},{self.value!r})"


# ---------------------------------------------------------------------------
# Filter tree
# ---------------------------------------------------------------------------


class FilterNodeType(enum.Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"
    PREDICATE = "PREDICATE"
    # constant filters produced by the optimizer (e.g. 1 != 1)
    CONSTANT_TRUE = "TRUE"
    CONSTANT_FALSE = "FALSE"


@dataclasses.dataclass(frozen=True)
class FilterNode:
    """Filter tree node (FilterContext.java analog)."""

    type: FilterNodeType
    children: tuple = ()  # tuple[FilterNode, ...] for AND/OR/NOT
    predicate: Optional[Predicate] = None

    @staticmethod
    def and_(*children: "FilterNode") -> "FilterNode":
        return FilterNode(FilterNodeType.AND, children=tuple(children))

    @staticmethod
    def or_(*children: "FilterNode") -> "FilterNode":
        return FilterNode(FilterNodeType.OR, children=tuple(children))

    @staticmethod
    def not_(child: "FilterNode") -> "FilterNode":
        return FilterNode(FilterNodeType.NOT, children=(child,))

    @staticmethod
    def pred(p: Predicate) -> "FilterNode":
        return FilterNode(FilterNodeType.PREDICATE, predicate=p)

    TRUE = None  # type: ignore  # filled in below
    FALSE = None  # type: ignore

    def columns(self) -> set[str]:
        if self.type is FilterNodeType.PREDICATE:
            return self.predicate.lhs.columns()
        out: set[str] = set()
        for c in self.children:
            out |= c.columns()
        return out

    def __str__(self) -> str:
        if self.type is FilterNodeType.PREDICATE:
            return str(self.predicate)
        if self.type is FilterNodeType.NOT:
            return f"NOT({self.children[0]})"
        if self.type in (FilterNodeType.CONSTANT_TRUE, FilterNodeType.CONSTANT_FALSE):
            return self.type.value
        sep = f" {self.type.value} "
        return "(" + sep.join(str(c) for c in self.children) + ")"


FilterNode.TRUE = FilterNode(FilterNodeType.CONSTANT_TRUE)
FilterNode.FALSE = FilterNode(FilterNodeType.CONSTANT_FALSE)


# ---------------------------------------------------------------------------
# Order-by / query context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OrderByExpression:
    expression: Expression
    ascending: bool = True

    def __str__(self) -> str:
        return f"{self.expression} {'ASC' if self.ascending else 'DESC'}"


@dataclasses.dataclass(frozen=True)
class QueryContext:
    """Compiled query (QueryContext.java analog). Hashable; used as part of
    the executor's jit-cache key after literal parameterization."""

    table_name: str
    select_expressions: tuple  # tuple[Expression, ...]
    aliases: tuple = ()        # tuple[Optional[str], ...] parallel to select
    distinct: bool = False
    filter: Optional[FilterNode] = None
    group_by: tuple = ()       # tuple[Expression, ...]
    having: Optional[FilterNode] = None
    order_by: tuple = ()       # tuple[OrderByExpression, ...]
    limit: int = 10            # reference default LIMIT 10 (CalciteSqlParser)
    offset: int = 0
    options: tuple = ()        # tuple[(key, value), ...] from SET statements
    explain: bool = False
    # EXPLAIN ANALYZE: execute for real + annotate the plan
    analyze: bool = False

    # ---- derived ---------------------------------------------------------
    def aggregations(self) -> list[Expression]:
        """Deduplicated aggregation expressions across select/having/order-by
        (QueryContext.getAggregationFunctions analog)."""
        seen: dict[Expression, None] = {}
        sources = list(self.select_expressions)
        if self.having is not None:
            sources.extend(_filter_expressions(self.having))
        for ob in self.order_by:
            sources.append(ob.expression)
        for e in sources:
            for a in find_aggregations(e):
                seen.setdefault(a)
        return list(seen)

    @property
    def is_aggregation_query(self) -> bool:
        return bool(self.aggregations())

    @property
    def is_group_by(self) -> bool:
        return bool(self.group_by)

    def columns(self) -> set[str]:
        out: set[str] = set()
        for e in self.select_expressions:
            out |= e.columns()
        if self.filter is not None:
            out |= self.filter.columns()
        for e in self.group_by:
            out |= e.columns()
        if self.having is not None:
            out |= self.having.columns()
        for ob in self.order_by:
            out |= ob.expression.columns()
        return out

    def options_dict(self) -> dict:
        return dict(self.options)

    def options_ci(self) -> dict:
        """SET options with case-insensitive keys (the reference treats
        query-option names case-insensitively, QueryOptionsUtils)."""
        return {str(k).lower(): v for k, v in self.options}

    def column_name(self, i: int) -> str:
        """Result column header for select position i (alias or expr string)."""
        if i < len(self.aliases) and self.aliases[i]:
            return self.aliases[i]
        return str(self.select_expressions[i])


def _filter_expressions(f: FilterNode) -> list[Expression]:
    if f.type is FilterNodeType.PREDICATE:
        return [f.predicate.lhs]
    out = []
    for c in f.children:
        out.extend(_filter_expressions(c))
    return out
