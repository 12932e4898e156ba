"""SQL front-end: tokenizer + recursive-descent/Pratt parser.

Role-equivalent of the reference's Calcite-based parser
(pinot-common/.../sql/parsers/CalciteSqlParser.java, ``compileToPinotQuery``)
— but hand-rolled, since the TPU build carries no Calcite/sqlglot dependency.
Parses the Pinot query surface:

    [SET key = value;]* [EXPLAIN PLAN FOR]
    SELECT [DISTINCT] expr [AS alias], ... FROM table
    [WHERE bool_expr] [GROUP BY expr, ...] [HAVING bool_expr]
    [ORDER BY expr [ASC|DESC], ...] [LIMIT n [OFFSET m] | LIMIT m, n]

Expressions parse into the engine IR's ``Expression`` trees directly (the
tree doubles as the AST; boolean operators become functions ``and``/``or``/
``not``/comparison names, which the compiler lowers to FilterNodes the same
way the reference's RequestContextUtils.getFilter does).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from pinot_tpu_torch.query.context import Expression

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<number>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|=|<|>|\|\||[+\-*/%(),;.])
    """,
    re.VERBOSE,
)


class SqlParseError(Exception):
    pass


class SqlAnalysisError(SqlParseError):
    """Typed semantic-analysis error (the multi-stage planner's analog of
    Calcite's validator errors): unknown / ambiguous column references
    resolve to this, naming the table alias and the candidate columns,
    instead of surfacing a raw KeyError from the compiler."""

    def __init__(self, message: str, column: Optional[str] = None,
                 candidates: tuple = ()):
        super().__init__(message)
        self.column = column
        self.candidates = tuple(candidates)


@dataclasses.dataclass
class Token:
    kind: str  # number | string | ident | qident | op | eof
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlParseError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append(Token(kind, m.group(), m.start()))
    tokens.append(Token("eof", "", n))
    return tokens


# ---------------------------------------------------------------------------
# Parsed statement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JoinClause:
    """One ``[INNER|LEFT [OUTER]] JOIN table [AS] alias ON expr`` clause
    (multi-stage grammar; the reference snapshot has no join surface)."""

    kind: str  # "INNER" | "LEFT"
    table: str
    alias: Optional[str]
    on: Expression


@dataclasses.dataclass
class SqlSelect:
    table: str
    select: list  # list[tuple[Expression, Optional[str]]] (expr, alias)
    table_alias: Optional[str] = None
    joins: list = dataclasses.field(default_factory=list)
    distinct: bool = False
    where: Optional[Expression] = None
    group_by: list = dataclasses.field(default_factory=list)
    having: Optional[Expression] = None
    order_by: list = dataclasses.field(default_factory=list)  # [(Expression, asc)]
    limit: Optional[int] = None
    offset: int = 0
    options: dict = dataclasses.field(default_factory=dict)
    explain: bool = False
    # EXPLAIN ANALYZE: execute the query for real and render
    # the plan annotated with per-node actuals; implies explain
    analyze: bool = False


_RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "AS",
    "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "IS", "ASC", "DESC",
    "SELECT", "DISTINCT", "BY", "NULL", "TRUE", "FALSE", "CASE", "WHEN",
    "THEN", "ELSE", "END", "CAST",
    # multi-stage grammar (joins + windows)
    "JOIN", "ON", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "OUTER",
    "OVER", "PARTITION",
}

_COMPARISON = {
    "=": "equals",
    "!=": "not_equals",
    "<>": "not_equals",
    ">": "greater_than",
    ">=": "greater_than_or_equal",
    "<": "less_than",
    "<=": "less_than_or_equal",
}

_ADD = {"+": "plus", "-": "minus", "||": "concat"}
_MUL = {"*": "times", "/": "divide", "%": "mod"}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # ---- token plumbing --------------------------------------------------
    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> bool:
        t = self.peek()
        if t.kind == "ident" and t.upper in kws:
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            t = self.peek()
            raise SqlParseError(f"expected {kw} at {t.pos}, got {t.text!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.text == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise SqlParseError(f"expected {op!r} at {t.pos}, got {t.text!r}")

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    # ---- statement -------------------------------------------------------
    def parse(self) -> SqlSelect:
        options: dict = {}
        # leading SET option = value; statements (Pinot SET syntax)
        while self.at_kw("SET"):
            self.next()
            key_tok = self.next()
            if key_tok.kind not in ("ident", "qident", "string"):
                raise SqlParseError(f"bad SET key at {key_tok.pos}")
            key = _unquote(key_tok)
            self.expect_op("=")
            val_tok = self.next()
            if val_tok.kind == "string":
                val: object = _string_value(val_tok.text)
            elif val_tok.kind == "number":
                val = _number_value(val_tok.text)
            elif val_tok.kind == "ident" and val_tok.upper in ("TRUE", "FALSE"):
                val = val_tok.upper == "TRUE"
            else:
                val = val_tok.text
            options[key] = val
            self.expect_op(";")

        explain = False
        analyze = False
        if self.accept_kw("EXPLAIN"):
            # EXPLAIN PLAN FOR <select> renders the static plan;
            # EXPLAIN ANALYZE <select> executes it and annotates the plan
            # with per-node actuals
            if self.accept_kw("ANALYZE"):
                analyze = True
            else:
                self.expect_kw("PLAN")
                self.expect_kw("FOR")
            explain = True

        stmt = self.parse_select()
        stmt.options = options
        stmt.explain = explain
        stmt.analyze = analyze
        self.accept_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise SqlParseError(f"trailing input at {t.pos}: {t.text!r}")
        return stmt

    def parse_select(self) -> SqlSelect:
        self.expect_kw("SELECT")
        distinct = self.accept_kw("DISTINCT")
        select: list = [self.parse_select_item()]
        while self.accept_op(","):
            select.append(self.parse_select_item())

        self.expect_kw("FROM")
        table, table_alias = self.parse_table_ref()
        joins: list = []
        while True:
            if self.accept_kw("JOIN"):
                kind = "INNER"
            elif self.at_kw("INNER"):
                self.next()
                self.expect_kw("JOIN")
                kind = "INNER"
            elif self.at_kw("LEFT"):
                self.next()
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "LEFT"
            elif self.at_kw("RIGHT", "FULL", "CROSS"):
                t = self.peek()
                raise SqlParseError(
                    f"{t.upper} JOIN is not supported (INNER and LEFT "
                    f"joins only) at {t.pos}")
            else:
                break
            jtable, jalias = self.parse_table_ref()
            self.expect_kw("ON")
            joins.append(JoinClause(kind, jtable, jalias, self.parse_expr()))

        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expr()

        group_by: list = []
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())

        having = None
        if self.accept_kw("HAVING"):
            having = self.parse_expr()

        order_by: list = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())

        limit = None
        offset = 0
        if self.accept_kw("LIMIT"):
            first = self.parse_int()
            if self.accept_op(","):  # LIMIT offset, count (MySQL form)
                offset = first
                limit = self.parse_int()
            else:
                limit = first
                if self.accept_kw("OFFSET"):
                    offset = self.parse_int()

        return SqlSelect(
            table=table, select=select, table_alias=table_alias,
            joins=joins, distinct=distinct, where=where,
            group_by=group_by, having=having, order_by=order_by,
            limit=limit, offset=offset,
        )

    def parse_select_item(self):
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = _unquote(self.next())
        elif self.peek().kind in ("ident", "qident") and not self.at_kw(*_RESERVED_STOP):
            alias = _unquote(self.next())
        return (expr, alias)

    def parse_order_item(self):
        expr = self.parse_expr()
        asc = True
        if self.accept_kw("DESC"):
            asc = False
        else:
            self.accept_kw("ASC")
        # NULLS FIRST/LAST accepted and ignored (engine: nulls sort last)
        if self.accept_kw("NULLS"):
            self.next()
        return (expr, asc)

    def parse_table_ref(self):
        """``table [AS] alias`` → (name, alias or None)."""
        name = self.parse_table_name()
        alias = None
        if self.accept_kw("AS"):
            alias = _unquote(self.next())
        elif self.peek().kind in ("ident", "qident") \
                and not self.at_kw(*_RESERVED_STOP):
            alias = _unquote(self.next())
        return name, alias

    def parse_table_name(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "qident"):
            raise SqlParseError(f"expected table name at {t.pos}")
        name = _unquote(t)
        while self.accept_op("."):  # db.table → keep last part
            name = _unquote(self.next())
        return name

    def parse_int(self) -> int:
        t = self.next()
        if t.kind != "number":
            raise SqlParseError(f"expected integer at {t.pos}")
        return int(t.text)

    # ---- expressions (precedence climbing) ------------------------------
    def parse_expr(self) -> Expression:
        return self.parse_or()

    def parse_or(self) -> Expression:
        left = self.parse_and()
        while self.accept_kw("OR"):
            right = self.parse_and()
            left = Expression.function("or", left, right)
        return left

    def parse_and(self) -> Expression:
        left = self.parse_not()
        while self.accept_kw("AND"):
            right = self.parse_not()
            left = Expression.function("and", left, right)
        return left

    def parse_not(self) -> Expression:
        if self.accept_kw("NOT"):
            return Expression.function("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expression:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.text in _COMPARISON:
            self.next()
            right = self.parse_additive()
            return Expression.function(_COMPARISON[t.text], left, right)

        negated = False
        if self.at_kw("NOT"):
            # lookahead: NOT IN / NOT BETWEEN / NOT LIKE
            nxt = self.tokens[self.i + 1]
            if nxt.kind == "ident" and nxt.upper in ("IN", "BETWEEN", "LIKE"):
                self.next()
                negated = True

        if self.accept_kw("IN"):
            self.expect_op("(")
            vals = [self.parse_expr()]
            while self.accept_op(","):
                vals.append(self.parse_expr())
            self.expect_op(")")
            fn = "not_in" if negated else "in"
            return Expression.function(fn, left, *vals)

        if self.accept_kw("BETWEEN"):
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            e = Expression.function("between", left, lo, hi)
            return Expression.function("not", e) if negated else e

        if self.accept_kw("LIKE"):
            pat = self.parse_additive()
            e = Expression.function("like", left, pat)
            return Expression.function("not", e) if negated else e

        if self.accept_kw("IS"):
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return Expression.function("is_not_null", left)
            self.expect_kw("NULL")
            return Expression.function("is_null", left)

        return left

    def parse_additive(self) -> Expression:
        left = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in _ADD:
                self.next()
                right = self.parse_multiplicative()
                left = Expression.function(_ADD[t.text], left, right)
            else:
                return left

    def parse_multiplicative(self) -> Expression:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in _MUL:
                self.next()
                right = self.parse_unary()
                left = Expression.function(_MUL[t.text], left, right)
            else:
                return left

    def parse_unary(self) -> Expression:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if inner.is_literal and isinstance(inner.value, (int, float)):
                return Expression.literal(-inner.value)
            return Expression.function("minus", Expression.literal(0), inner)
        self.accept_op("+")
        return self.parse_primary()

    def parse_primary(self) -> Expression:
        t = self.next()
        if t.kind == "number":
            return Expression.literal(_number_value(t.text))
        if t.kind == "string":
            return Expression.literal(_string_value(t.text))
        if t.kind == "op" and t.text == "(":
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.text == "*":
            return Expression.identifier("*")
        if t.kind == "qident":
            return self.parse_maybe_qualified(_unquote(t))
        if t.kind == "ident":
            up = t.upper
            if up == "NULL":
                return Expression.literal(None)
            if up == "TRUE":
                return Expression.literal(True)
            if up == "FALSE":
                return Expression.literal(False)
            if up == "CASE":
                return self.parse_case()
            if up == "CAST":
                return self.parse_cast()
            if self.accept_op("("):
                e = self.parse_function_call(t.text)
                if self.at_kw("OVER"):
                    e = self.parse_over(e)
                return e
            return self.parse_maybe_qualified(t.text)
        raise SqlParseError(f"unexpected token {t.text!r} at {t.pos}")

    def parse_maybe_qualified(self, first: str) -> Expression:
        """``alias.col`` → one identifier named ``alias.col`` (the
        multi-stage planner resolves the qualification; single-table
        queries strip a matching table alias in the compiler)."""
        if not self.accept_op("."):
            return Expression.identifier(first)
        t = self.next()
        if t.kind not in ("ident", "qident"):
            raise SqlParseError(
                f"expected column after {first!r}. at {t.pos}")
        return Expression.identifier(f"{first}.{_unquote(t)}")

    def parse_over(self, fn_expr: Expression) -> Expression:
        """``OVER (PARTITION BY ... ORDER BY ...)`` →
        function('__window__', fn, '__partition__'(keys...),
        '__order__'('__asc__'|'__desc__'(key)...)). The dunder names are
        reserved markers the multi-stage planner unpacks; they can never
        collide with transform registry names."""
        self.expect_kw("OVER")
        self.expect_op("(")
        partition: list[Expression] = []
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        order: list[Expression] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            e, asc = self.parse_order_item()
            order.append(Expression.function(
                "__asc__" if asc else "__desc__", e))
            while self.accept_op(","):
                e, asc = self.parse_order_item()
                order.append(Expression.function(
                    "__asc__" if asc else "__desc__", e))
        if self.at_kw("ROWS", "RANGE", "GROUPS"):
            t = self.peek()
            raise SqlParseError(
                f"explicit window frames ({t.upper} ...) are not "
                f"supported at {t.pos}; the default frame applies")
        self.expect_op(")")
        return Expression.function(
            "__window__", fn_expr,
            Expression.function("__partition__", *partition),
            Expression.function("__order__", *order))

    def parse_function_call(self, name: str) -> Expression:
        # COUNT(*) / COUNT(DISTINCT x) special forms
        fname = name.lower()
        if self.accept_op(")"):
            return Expression.function(fname)
        distinct = self.accept_kw("DISTINCT")
        args = [self.parse_expr()]
        while self.accept_op(","):
            args.append(self.parse_expr())
        self.expect_op(")")
        if distinct:
            if fname == "count":
                return Expression.function("distinctcount", *args)
            raise SqlParseError(f"DISTINCT not supported inside {name}()")
        return Expression.function(fname, *args)

    def parse_case(self) -> Expression:
        """CASE WHEN c1 THEN v1 ... [ELSE e] END →
        function('case', c1, v1, c2, v2, ..., else)."""
        args: list[Expression] = []
        while self.accept_kw("WHEN"):
            args.append(self.parse_expr())
            self.expect_kw("THEN")
            args.append(self.parse_expr())
        if self.accept_kw("ELSE"):
            args.append(self.parse_expr())
        else:
            args.append(Expression.literal(None))
        self.expect_kw("END")
        if len(args) < 3:
            raise SqlParseError("CASE requires at least one WHEN")
        return Expression.function("case", *args)

    def parse_cast(self) -> Expression:
        self.expect_op("(")
        e = self.parse_expr()
        self.expect_kw("AS")
        t = self.next()
        if t.kind != "ident":
            raise SqlParseError(f"expected type name at {t.pos}")
        type_name = t.text.upper()
        self.expect_op(")")
        return Expression.function("cast", e, Expression.literal(type_name))


# ---------------------------------------------------------------------------
# literal helpers
# ---------------------------------------------------------------------------


def _number_value(text: str):
    if re.fullmatch(r"\d+", text):
        return int(text)
    return float(text)


def _string_value(text: str) -> str:
    return text[1:-1].replace("''", "'")


def _unquote(t: Token) -> str:
    if t.kind == "qident":
        return t.text[1:-1].replace('""', '"')
    if t.kind == "string":
        return _string_value(t.text)
    return t.text


def parse_sql(sql: str) -> SqlSelect:
    return Parser(sql).parse()


# EXPLAIN ANALYZE executes the UNDERLYING statement through the normal
# path (broker scatter-gather / multi-stage leaves): the keyword pair is
# stripped from the raw SQL once, preserving any leading SET statements.
_EXPLAIN_ANALYZE_RE = re.compile(r"\bEXPLAIN\s+ANALYZE\s+", re.IGNORECASE)


def strip_explain_analyze(sql: str) -> str:
    """The SQL with its first ``EXPLAIN ANALYZE`` removed (the executable
    form the broker re-runs); unchanged input when the keywords are
    absent — callers use equality as the "did anything strip" guard."""
    return _EXPLAIN_ANALYZE_RE.sub("", sql, count=1)
