"""Ingest-time record transforms + filtering (a copy of
pinot_tpu/ingestion/transform.py for the port, over its function
registry's numpy forms and its SQL parser).

Equivalent of the reference's record-transformer chain
(pinot-segment-local/.../recordtransformer/ExpressionTransformer +
FilterTransformer, driven by TransformConfig/FilterConfig): derived
columns compute from source record fields BEFORE schema coercion — so a
transform may read fields that are not schema columns — and rows matching
``filter_function`` are dropped. Expressions are the engine's own SQL
surface (parser + function registry) instead of Groovy.

Evaluation notes:
- String inputs that parse as numbers coerce to numbers before numeric
  ops (CSV readers hand every value over as str; numpy would otherwise
  concatenate '1'+'2' into '12' or crash comparisons).
- IN / NOT IN / BETWEEN / LIKE / IS [NOT] NULL are comparison forms the
  parser lowers to function nodes outside the ops registry; they are
  evaluated here directly.
- Errors raise ``TransformError`` — a CONFIG bug, which ingest paths must
  fail loudly on, never lump in with undecodable (poison) messages.
- Batch files evaluate column-vectorized (the np_fns are vectorized
  already); realtime evaluates per record.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.query.context import Expression
from pinot_tpu_torch.sql.parser import Parser


class TransformError(Exception):
    """A transform/filter expression failed: misconfiguration, not bad data."""


def _parse(expr_text: str) -> Expression:
    try:
        return Parser(expr_text).parse_expr()
    except Exception as e:  # noqa: BLE001
        raise TransformError(f"bad transform expression {expr_text!r}: {e}") from e


def _maybe_number(v):
    """CSV sources are all-string: numeric-looking operands coerce so
    arithmetic is arithmetic (numpy would silently concatenate)."""
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return v
    return v


_LIKE_CACHE: dict = {}


def _like_regex(pattern: str):
    rx = _LIKE_CACHE.get(pattern)
    if rx is None:
        from pinot_tpu_torch.engine.host import like_to_regex

        rx = re.compile(like_to_regex(pattern))
        _LIKE_CACHE[pattern] = rx
    return rx


# ---------------------------------------------------------------------------
# scalar (per-record) evaluation — the realtime path
# ---------------------------------------------------------------------------

def _eval_row(expr: Expression, row: dict):
    """Scalar evaluation over one record; None propagates (a transform
    over an absent/null field yields null, like the reference's
    ExpressionTransformer on null inputs)."""
    if expr.is_literal:
        return expr.value
    if expr.is_identifier:
        return _maybe_number(row.get(expr.name))
    name = expr.name
    if name in ("in", "not_in"):
        lhs = _eval_row(expr.args[0], row)
        if lhs is None:
            return None
        vals = {_eval_row(a, row) for a in expr.args[1:]}
        return (lhs in vals) if name == "in" else (lhs not in vals)
    if name == "between":
        lhs = _eval_row(expr.args[0], row)
        if lhs is None:
            return None
        lo = _eval_row(expr.args[1], row)
        hi = _eval_row(expr.args[2], row)
        return lo <= lhs <= hi
    if name == "like":
        lhs = _eval_row(expr.args[0], row)
        if lhs is None:
            return None
        return bool(_like_regex(str(expr.args[1].value)).match(str(lhs)))
    if name == "is_null":
        return _eval_row(expr.args[0], row) is None
    if name == "is_not_null":
        return _eval_row(expr.args[0], row) is not None
    if name == "cast":
        arg = _eval_row(expr.args[0], row)
        if arg is None:
            return None
        return get_function("cast").np_fn(np.asarray(arg),
                                          expr.args[1].value).item()
    try:
        fn = get_function(name)
    except KeyError as e:
        raise TransformError(f"unknown function {name!r} in transform") from e
    args = [_eval_row(a, row) for a in expr.args]
    if any(a is None for a in args):
        return None
    out = fn.np_fn(*[np.asarray(a) for a in args])
    arr = np.asarray(out)
    return arr.item() if arr.ndim == 0 else arr.tolist()


# ---------------------------------------------------------------------------
# vectorized (per-file) evaluation — the batch path
# ---------------------------------------------------------------------------

class _Cols:
    """Lazy column view over raw row dicts: (values array, none mask)."""

    def __init__(self, rows: list):
        self.rows = rows
        self._cache: dict = {}

    def get(self, name: str):
        if name in self._cache:
            return self._cache[name]
        raw = [r.get(name) for r in self.rows]
        none = np.fromiter((v is None for v in raw), dtype=bool,
                           count=len(raw))
        coerced = [None if v is None else _maybe_number(v) for v in raw]
        numeric = all(isinstance(v, (int, float, bool))
                      for v in coerced if v is not None)
        if numeric:
            arr = np.asarray([0 if v is None else v for v in coerced])
        else:
            arr = np.asarray(["" if v is None else str(v) for v in coerced])
        out = (arr, none)
        self._cache[name] = out
        return out


def _eval_vec(expr: Expression, cols: _Cols, n: int):
    """(values array, none mask) over all rows."""
    if expr.is_literal:
        if expr.value is None:
            return np.zeros(n), np.ones(n, dtype=bool)
        return np.broadcast_to(np.asarray(expr.value), (n,)), \
            np.zeros(n, dtype=bool)
    if expr.is_identifier:
        return cols.get(expr.name)
    name = expr.name
    if name in ("in", "not_in"):
        v, none = _eval_vec(expr.args[0], cols, n)
        vals = [a.value for a in expr.args[1:]]
        if v.dtype.kind in ("U", "S"):
            vals = [str(x) for x in vals]
        m = np.isin(v, np.asarray(vals))
        return (m if name == "in" else ~m), none
    if name == "between":
        v, none = _eval_vec(expr.args[0], cols, n)
        lo, hi = expr.args[1].value, expr.args[2].value
        return (v >= lo) & (v <= hi), none
    if name == "like":
        v, none = _eval_vec(expr.args[0], cols, n)
        rx = _like_regex(str(expr.args[1].value))
        m = np.fromiter((bool(rx.match(str(s))) for s in v), dtype=bool,
                        count=n)
        return m, none
    if name == "is_null":
        _, none = _eval_vec(expr.args[0], cols, n)
        return none.copy(), np.zeros(n, dtype=bool)
    if name == "is_not_null":
        _, none = _eval_vec(expr.args[0], cols, n)
        return ~none, np.zeros(n, dtype=bool)
    try:
        fn = get_function(name)
    except KeyError as e:
        raise TransformError(f"unknown function {name!r} in transform") from e
    if name == "cast":
        v, none = _eval_vec(expr.args[0], cols, n)
        return fn.np_fn(v, expr.args[1].value), none
    parts = [_eval_vec(a, cols, n) for a in expr.args]
    none = np.zeros(n, dtype=bool)
    for _, m in parts:
        none |= m
    return fn.np_fn(*[p[0] for p in parts]), none


class RecordTransformer:
    """Applies a table's IngestionConfig to records (rows)."""

    def __init__(self, table_config):
        ing = getattr(table_config, "ingestion", None)
        self._transforms = []
        self._filter: Optional[Expression] = None
        if ing is None:
            return
        for t in ing.transform_configs:
            self._transforms.append((t.column_name,
                                     _parse(t.transform_function)))
        if ing.filter_function:
            self._filter = _parse(ing.filter_function)

    @property
    def active(self) -> bool:
        return bool(self._transforms) or self._filter is not None

    # ---- realtime: one record at a time ---------------------------------
    def apply_row(self, row: dict) -> Optional[dict]:
        """Transformed record, or None when the filter drops it. Raises
        TransformError on expression failure (config bug — callers must
        NOT treat it as a poison message)."""
        if not self.active:
            return row
        out = dict(row)
        try:
            for col, expr in self._transforms:
                out[col] = _eval_row(expr, out)
            if self._filter is not None and \
                    bool(_eval_row(self._filter, out)):
                return None
        except TransformError:
            raise
        except Exception as e:  # noqa: BLE001 — surface as config failure
            raise TransformError(f"transform failed: {e}") from e
        return out

    # ---- batch: vectorized over a whole file ----------------------------
    def apply_rows(self, rows: list) -> list:
        if not self.active or not rows:
            return rows
        n = len(rows)
        try:
            cols = _Cols(rows)
            derived = {}
            for col, expr in self._transforms:
                vals, none = _eval_vec(expr, cols, n)
                derived[col] = (np.asarray(vals), none)
                # chained transforms see prior outputs
                cols._cache[col] = derived[col]
            keep = np.ones(n, dtype=bool)
            if self._filter is not None:
                m, none = _eval_vec(self._filter, cols, n)
                keep = ~(np.asarray(m, dtype=bool) & ~none)
        except TransformError:
            raise
        except Exception as e:  # noqa: BLE001
            raise TransformError(f"transform failed: {e}") from e
        out = []
        for i in np.nonzero(keep)[0]:
            r = dict(rows[i])
            for col, (vals, none) in derived.items():
                v = vals[i]
                r[col] = None if none[i] else \
                    (v.item() if isinstance(v, np.generic) else v)
            out.append(r)
        return out
