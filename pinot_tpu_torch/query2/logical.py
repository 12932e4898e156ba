"""Multi-stage logical planner: SqlSelect with joins/windows → MultiStagePlan.

A copy of pinot_tpu/query2/logical.py (the port imports nothing of the
JAX package); pure host Python over the port's query/context.py,
sql/compiler.py and sql/parser.py.

Role-equivalent of the reference's pinot-query-planner (Calcite logical
plan → dispatchable stage plan), scoped to the shapes engine v2 executes:

- left-deep INNER / LEFT equi-join chains over a probe (fact) table and
  one build table per join,
- window functions over ``OVER (PARTITION BY ... ORDER BY ...)``,
- a stage-2 GROUP BY ... HAVING / ORDER BY / LIMIT over the joined rows,
  reusing the single-stage QueryContext IR so engine/reduce.py finalizes
  the result unchanged.

Name resolution rewrites every identifier to a canonical ``alias.column``
form against the catalog (the per-alias column sets) and raises the typed
``SqlAnalysisError`` — naming the alias and the candidate columns — for
unknown or ambiguous references, instead of letting a raw KeyError escape
the compiler. WHERE conjuncts referencing a single table push down into
that table's stage-1 scan when semantics allow (always for the probe
side; build side only under INNER joins — a LEFT join's build filter must
see the type-default fill of unmatched rows, so it stays post-join).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

from pinot_tpu_torch.query.context import (
    Expression,
    ExpressionType,
    OrderByExpression,
    QueryContext,
    is_aggregation,
)
from pinot_tpu_torch.sql.compiler import (
    DEFAULT_LIMIT,
    _to_filter,
    contains_window,
    is_multistage,  # noqa: F401  (re-exported: the routing predicate)
)
from pinot_tpu_torch.sql.parser import SqlAnalysisError, SqlSelect

WINDOW_FUNCTIONS = {
    "row_number": 0,
    "rank": 0,
    "dense_rank": 0,
    "count": None,  # COUNT(*) or COUNT(x)
    "sum": 1,
    "avg": 1,
    "min": 1,
    "max": 1,
}

BROADCAST_MAX_BUILD_ROWS = 1 << 20  # build side bigger than this shuffles


# ---------------------------------------------------------------------------
# plan IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableSource:
    table: str       # table name as written in the SQL
    alias: str       # alias (defaults to the table name)
    columns: tuple   # column names from the catalog
    is_dim: bool = False


@dataclasses.dataclass(frozen=True)
class JoinStep:
    kind: str        # "INNER" | "LEFT"
    build: TableSource
    left_keys: tuple    # canonical Expressions over the accumulated left side
    right_keys: tuple   # canonical Expressions over the build table
    residual: Optional[Expression] = None  # extra ON conjuncts, post-match


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    fn: str
    expr: Expression      # the canonical __window__ node (runner env key)
    args: tuple           # canonical argument expressions of fn
    partition_by: tuple   # canonical Expressions
    order_by: tuple       # tuple[(Expression, ascending: bool)]

    def describe(self) -> str:
        arg = ",".join(str(a) for a in self.args)
        part = ",".join(str(p) for p in self.partition_by)
        order = ",".join(f"{e} {'ASC' if asc else 'DESC'}"
                         for e, asc in self.order_by)
        spec = []
        if part:
            spec.append(f"PARTITION BY {part}")
        if order:
            spec.append(f"ORDER BY {order}")
        return f"{self.fn}({arg}) OVER ({' '.join(spec)})"


@dataclasses.dataclass
class MultiStagePlan:
    """The compiled two-stage plan. ``stage2`` is a plain QueryContext over
    the canonical joined namespace (table_name = the probe table), so the
    single-stage reduce machinery finalizes it unchanged."""

    sources: tuple            # TableSource..., [0] = probe side
    joins: tuple              # JoinStep...
    pushdown: dict            # alias -> Expression (BARE column names) | None
    post_filter: Optional[Expression]  # canonical; applied to joined rows
    windows: tuple            # WindowSpec...
    stage2: QueryContext
    strategy: str             # "BROADCAST" | "SHUFFLE" | "DISTRIBUTED"
    # True when SET joinStrategy forced it: the runner honors a forced
    # BROADCAST even past BROADCAST_MAX_BUILD_ROWS (a heuristic pick
    # demotes to SHUFFLE there instead of replicating a huge build table)
    strategy_forced: bool = False
    explain: bool = False
    analyze: bool = False  # EXPLAIN ANALYZE

    @property
    def probe(self) -> TableSource:
        return self.sources[0]

    @property
    def table_name(self) -> str:
        """Primary (probe) table — routing / logging identity."""
        return self.sources[0].table

    def options_ci(self) -> dict:
        return self.stage2.options_ci()


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


def compile_plan(stmt: SqlSelect,
                 catalog: Callable[[str], tuple]) -> MultiStagePlan:
    """``catalog(table_name)`` → (column name tuple, is_dim_table bool);
    raises KeyError for an unknown table."""
    sources: list[TableSource] = []
    by_alias: dict[str, TableSource] = {}
    for table, alias in [(stmt.table, stmt.table_alias)] + [
            (j.table, j.alias) for j in stmt.joins]:
        alias = alias or table
        if alias in by_alias:
            raise SqlAnalysisError(
                f"duplicate table alias {alias!r}; every joined table "
                f"needs a distinct alias")
        try:
            columns, is_dim = catalog(table)
        except KeyError:
            raise SqlAnalysisError(f"table {table!r} not found") from None
        src = TableSource(table=table, alias=alias,
                          columns=tuple(columns), is_dim=bool(is_dim))
        sources.append(src)
        by_alias[alias] = src

    res = _Resolver(sources)

    # ---- select list (with * expansion over all sources, in order) ------
    select: list[Expression] = []
    aliases: list[Optional[str]] = []
    for e, a in stmt.select:
        if e.is_identifier and e.name == "*":
            for src in sources:
                for c in src.columns:
                    select.append(Expression.identifier(f"{src.alias}.{c}"))
                    aliases.append(c if len(sources) == 1 else None)
            continue
        select.append(res.resolve(e))
        aliases.append(a)

    group_by = tuple(res.resolve(e) for e in stmt.group_by)
    order_by_resolved = tuple(
        (res.resolve(e), asc) for e, asc in stmt.order_by)
    having_expr = None if stmt.having is None else res.resolve(stmt.having)

    # ---- WHERE split: per-alias pushdown vs post-join residual ----------
    pushdown: dict[str, Optional[Expression]] = {
        s.alias: None for s in sources}
    post: list[Expression] = []
    left_kinds = {s.alias: "PROBE" for s in sources[:1]}
    for j, src in zip(stmt.joins, sources[1:]):
        left_kinds[src.alias] = j.kind
    if stmt.where is not None:
        for conj in _conjuncts(res.resolve(stmt.where)):
            refs = _aliases_of(conj)
            if len(refs) == 1:
                a = next(iter(refs))
                # probe-side filters always commute with the join; a LEFT
                # join's build-side filter must observe default-filled
                # unmatched rows, so it cannot push below the join
                if left_kinds.get(a) in ("PROBE", "INNER"):
                    pushdown[a] = _and(pushdown[a], _unqualify(conj, a))
                    continue
            post.append(conj)

    # ---- joins: equi-key extraction from ON ------------------------------
    joins: list[JoinStep] = []
    seen = {sources[0].alias}
    for clause, build in zip(stmt.joins, sources[1:]):
        on = res.resolve(clause.on)
        keys_l: list[Expression] = []
        keys_r: list[Expression] = []
        residual: list[Expression] = []
        for conj in _conjuncts(on):
            pair = _equi_pair(conj, seen, build.alias)
            if pair is not None:
                keys_l.append(pair[0])
                keys_r.append(pair[1])
                continue
            refs = _aliases_of(conj)
            if clause.kind == "INNER" and len(refs) == 1 \
                    and next(iter(refs)) == build.alias:
                # an INNER join's build-only ON conjunct is equivalent to a
                # WHERE filter on the build table: push it into the scan
                pushdown[build.alias] = _and(
                    pushdown[build.alias], _unqualify(conj, build.alias))
                continue
            residual.append(conj)
        if not keys_l:
            raise SqlAnalysisError(
                f"join ON {build.alias!r} needs at least one equality "
                f"between the joined tables (equi-join); got: {on}")
        joins.append(JoinStep(
            kind=clause.kind, build=build,
            left_keys=tuple(keys_l), right_keys=tuple(keys_r),
            residual=_and_all(residual)))
        seen.add(build.alias)

    # ---- windows ---------------------------------------------------------
    windows = _collect_windows(
        list(select) + [e for e, _ in order_by_resolved])
    if windows and (group_by or stmt.distinct
                    or any(_has_aggregation(e) for e in select)):
        raise SqlAnalysisError(
            "window functions cannot be combined with GROUP BY, DISTINCT "
            "or plain aggregations in the same query")
    if having_expr is not None and contains_window(having_expr):
        raise SqlAnalysisError("window functions are not allowed in HAVING")
    if stmt.where is not None and contains_window(res.resolve(stmt.where)):
        raise SqlAnalysisError("window functions are not allowed in WHERE")

    stage2 = QueryContext(
        table_name=sources[0].table,
        select_expressions=tuple(select),
        aliases=tuple(aliases),
        distinct=stmt.distinct,
        filter=None,
        group_by=group_by,
        having=None if having_expr is None else _to_filter(having_expr),
        order_by=tuple(OrderByExpression(e, asc)
                       for e, asc in order_by_resolved),
        limit=stmt.limit if stmt.limit is not None else DEFAULT_LIMIT,
        offset=stmt.offset,
        options=tuple(sorted(stmt.options.items())),
        explain=stmt.explain,
        analyze=stmt.analyze,
    )

    opts_ci = stage2.options_ci()
    strategy = _pick_strategy(opts_ci, sources[1:])
    return MultiStagePlan(
        sources=tuple(sources), joins=tuple(joins), pushdown=pushdown,
        post_filter=_and_all(post), windows=windows, stage2=stage2,
        strategy=strategy,
        strategy_forced="joinstrategy" in opts_ci,
        explain=stmt.explain, analyze=stmt.analyze)


def _pick_strategy(opts: dict, builds) -> str:
    forced = opts.get("joinstrategy")
    if forced is not None:
        forced = str(forced).upper()
        if forced not in ("BROADCAST", "SHUFFLE", "DISTRIBUTED"):
            raise SqlAnalysisError(
                f"SET joinStrategy must be 'broadcast', 'shuffle' or "
                f"'distributed', got {forced!r}")
        return forced
    # dimension tables are replicated and cheap to broadcast (narrow
    # planes); anything else defaults to the partitioned shuffle join
    if builds and all(b.is_dim for b in builds):
        return "BROADCAST"
    return "SHUFFLE"


# ---------------------------------------------------------------------------
# name resolution
# ---------------------------------------------------------------------------


class _Resolver:
    def __init__(self, sources):
        self.sources = sources
        self.by_alias = {s.alias: s for s in sources}

    def _describe(self) -> str:
        return "; ".join(
            f"{s.alias}({', '.join(s.columns[:8])}"
            f"{', ...' if len(s.columns) > 8 else ''})"
            for s in self.sources)

    def resolve_name(self, name: str) -> str:
        if "." in name:
            alias, col = name.split(".", 1)
            src = self.by_alias.get(alias)
            if src is None:
                raise SqlAnalysisError(
                    f"unknown table alias {alias!r} in column reference "
                    f"{name!r}; tables: {self._describe()}",
                    column=name,
                    candidates=tuple(self.by_alias))
            if col not in src.columns:
                raise SqlAnalysisError(
                    f"column {col!r} not found in table {src.table!r} "
                    f"(alias {alias!r}); its columns: "
                    f"{', '.join(src.columns)}",
                    column=name, candidates=src.columns)
            return name
        hits = [s for s in self.sources if name in s.columns]
        if not hits:
            raise SqlAnalysisError(
                f"column {name!r} not found in any joined table; "
                f"tables: {self._describe()}",
                column=name,
                candidates=tuple(c for s in self.sources for c in s.columns))
        if len(hits) > 1:
            opts = " or ".join(f"{s.alias}.{name}" for s in hits)
            raise SqlAnalysisError(
                f"ambiguous column {name!r}: present in "
                f"{', '.join(repr(s.alias) for s in hits)} — qualify it "
                f"as {opts}",
                column=name, candidates=tuple(s.alias for s in hits))
        return f"{hits[0].alias}.{name}"

    def resolve(self, e: Expression) -> Expression:
        if e.is_identifier:
            if e.name == "*":
                return e  # COUNT(*) operand
            if e.name.startswith("$"):
                raise SqlAnalysisError(
                    f"virtual column {e.name!r} is not supported in "
                    f"multi-stage queries")
            return Expression.identifier(self.resolve_name(e.name))
        if e.is_function:
            return Expression(
                ExpressionType.FUNCTION, name=e.name,
                args=tuple(self.resolve(a) for a in e.args))
        return e


# ---------------------------------------------------------------------------
# expression utilities
# ---------------------------------------------------------------------------


def _conjuncts(e: Expression) -> list:
    if e.is_function and e.name == "and":
        out = []
        for a in e.args:
            out.extend(_conjuncts(a))
        return out
    return [e]


def _and(a: Optional[Expression], b: Expression) -> Expression:
    return b if a is None else Expression.function("and", a, b)


def _and_all(conjs: list) -> Optional[Expression]:
    out = None
    for c in conjs:
        out = _and(out, c)
    return out


def _aliases_of(e: Expression) -> set:
    return {name.split(".", 1)[0] for name in e.columns() if "." in name}


def _unqualify(e: Expression, alias: str) -> Expression:
    """Canonical ``alias.col`` identifiers → bare ``col`` for a pushed-down
    single-table filter (evaluated against that table's own scan)."""
    if e.is_identifier and e.name.startswith(alias + "."):
        return Expression.identifier(e.name[len(alias) + 1:])
    if e.is_function:
        return Expression(
            ExpressionType.FUNCTION, name=e.name,
            args=tuple(_unqualify(a, alias) for a in e.args))
    return e


def _equi_pair(conj: Expression, left_aliases: set, build_alias: str):
    """``equals(a, b)`` with one side referencing only already-joined
    aliases and the other only the build alias → (left_expr, right_expr)."""
    if not (conj.is_function and conj.name == "equals"
            and len(conj.args) == 2):
        return None
    a, b = conj.args
    ra, rb = _aliases_of(a), _aliases_of(b)
    if ra and ra <= left_aliases and rb == {build_alias}:
        return a, b
    if rb and rb <= left_aliases and ra == {build_alias}:
        return b, a
    return None


def _has_aggregation(e: Expression) -> bool:
    if is_aggregation(e):
        return True
    if e.is_function and e.name != "__window__":
        return any(_has_aggregation(a) for a in e.args)
    return False


def _collect_windows(exprs: list) -> tuple:
    found: dict[Expression, WindowSpec] = {}

    def walk(e: Expression):
        if not e.is_function:
            return
        if e.name == "__window__":
            fn, part, order = e.args
            if not fn.is_function or fn.name not in WINDOW_FUNCTIONS:
                raise SqlAnalysisError(
                    f"{fn.name if fn.is_function else fn}() is not a "
                    f"window function; supported: "
                    f"{', '.join(sorted(WINDOW_FUNCTIONS))}")
            arity = WINDOW_FUNCTIONS[fn.name]
            args = tuple(a for a in fn.args
                         if not (a.is_identifier and a.name == "*"))
            if arity is not None and len(args) != arity:
                raise SqlAnalysisError(
                    f"window function {fn.name}() takes {arity} "
                    f"argument(s), got {len(args)}")
            for sub in args + part.args + tuple(
                    o.args[0] for o in order.args):
                if contains_window(sub):
                    raise SqlAnalysisError(
                        "nested window functions are not supported")
            found.setdefault(e, WindowSpec(
                fn=fn.name, expr=e, args=args,
                partition_by=part.args,
                order_by=tuple((o.args[0], o.name == "__asc__")
                               for o in order.args)))
            return
        for a in e.args:
            walk(a)

    for e in exprs:
        walk(e)
    return tuple(found.values())


# ---------------------------------------------------------------------------
# SQL rendering (broker leaf queries + EXPLAIN)
# ---------------------------------------------------------------------------

_OP_BIN = {
    "equals": "=", "not_equals": "<>",
    "greater_than": ">", "greater_than_or_equal": ">=",
    "less_than": "<", "less_than_or_equal": "<=",
    "plus": "+", "minus": "-", "times": "*", "divide": "/", "mod": "%",
}

_IDENT_RE = re.compile(r"[A-Za-z_$][A-Za-z0-9_$]*")


def _sql_ident(name: str) -> str:
    if _IDENT_RE.fullmatch(name):
        return name
    return '"' + name.replace('"', '""') + '"'


def to_sql(e: Expression) -> str:
    """Render an expression back to parseable SQL (broker leaf scans ship
    pushdown filters to servers as text; EXPLAIN renders plans with it)."""
    if e.is_literal:
        v = e.value
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "TRUE" if v else "FALSE"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return str(v)
    if e.is_identifier:
        return e.name if e.name == "*" else _sql_ident(e.name)
    name = e.name
    if name in _OP_BIN and len(e.args) == 2:
        return f"({to_sql(e.args[0])} {_OP_BIN[name]} {to_sql(e.args[1])})"
    if name in ("and", "or"):
        op = f" {name.upper()} "
        return "(" + op.join(to_sql(a) for a in e.args) + ")"
    if name == "not":
        return f"NOT ({to_sql(e.args[0])})"
    if name in ("in", "not_in"):
        vals = ", ".join(to_sql(a) for a in e.args[1:])
        op = "IN" if name == "in" else "NOT IN"
        return f"{to_sql(e.args[0])} {op} ({vals})"
    if name == "between":
        return (f"{to_sql(e.args[0])} BETWEEN {to_sql(e.args[1])} "
                f"AND {to_sql(e.args[2])}")
    if name == "like":
        return f"{to_sql(e.args[0])} LIKE {to_sql(e.args[1])}"
    if name == "is_null":
        return f"{to_sql(e.args[0])} IS NULL"
    if name == "is_not_null":
        return f"{to_sql(e.args[0])} IS NOT NULL"
    if name == "cast":
        return f"CAST({to_sql(e.args[0])} AS {e.args[1].value})"
    return f"{name}({', '.join(to_sql(a) for a in e.args)})"
