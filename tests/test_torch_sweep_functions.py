"""The differential sweep of tests/test_torch_sweep.py, its second half:
the aggregations' operands where the two packages' value semantics part.

- ``ROUND(x, 1)``, ``ROUND(x, -1)`` and ``CAST(x AS STRING)`` under the
  plain aggregations, the percentiles and SUMPRECISION, in the host
  path's shapes, the device shape and stage 2 of a self-join;
- POWER, SQRT, LN and LOG10 of INT / LONG / DOUBLE operands under MIN /
  MAX / SUMPRECISION / DISTINCTCOUNTHLL, in the device shape and the
  host path's, and literals inside float functions and beside float
  planes in the device shape;
- VALUEIN (a multi-value result) under FIRST/LASTWITHTIME, DISTINCTCOUNT
  and DISTINCTCOUNTHLL.

The data, the oracle and the comparison are test_torch_sweep.py's.
"""

import pytest

from test_torch_host_float64 import dirs  # noqa: F401 — the segments
from test_torch_sweep import _select, check, engines  # noqa: F401


# ---------------------------------------------------------------------------
# F7: ROUND with a scale and CAST to STRING inside aggregations
# ---------------------------------------------------------------------------

OPERANDS = {"round_f_1": "ROUND({t}f, 1)", "round_i_m1": "ROUND({t}i, -1)",
            "cast_f": "CAST({t}f AS STRING)"}
JOIN_OPERANDS = dict(OPERANDS, cast_i="CAST({t}i AS STRING)")
REDUCTIONS = {
    "sum": ("SUM({x})", False), "min": ("MIN({x})", True),
    "max": ("MAX({x})", True), "avg": ("AVG({x})", False),
    "minmaxrange": ("MINMAXRANGE({x})", True),
    "percentile": ("PERCENTILE({x}, 50)", True),
    "percentiletdigest": ("PERCENTILETDIGEST({x}, 50)", True),
    "sumprecision": ("SUMPRECISION({x})", True),
}
HOST_SHAPES = {
    "docid": (None, "WHERE $docId < 1800"),
    "not_null": (None, "WHERE nv IS NOT NULL"),
    "raw_long_key": ("rk", ""),
    "mv_key": ("tags", ""),
    "device": (None, ""),
}


@pytest.mark.parametrize("shape", list(HOST_SHAPES))
@pytest.mark.parametrize("red", list(REDUCTIONS))
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_scaled_round_and_string_cast(engines, operand, red, shape):
    agg, exact = REDUCTIONS[red]
    sql = _select(agg.format(x=OPERANDS[operand].format(t="")),
                  HOST_SHAPES[shape])
    check(engines, sql, [exact])


@pytest.mark.parametrize("red", list(REDUCTIONS))
@pytest.mark.parametrize("operand", list(JOIN_OPERANDS))
def test_stage2_over_a_self_join(engines, operand, red):
    agg, exact = REDUCTIONS[red]
    x = JOIN_OPERANDS[operand].format(t="a.")
    check(engines, f"SET useAdvisor=false; SELECT {agg.format(x=x)} "
          f"FROM t a JOIN t b ON a.ts = b.ts", [exact])


# ---------------------------------------------------------------------------
# F8 / F9: float functions' bits and dtypes
# ---------------------------------------------------------------------------

FUNCTIONS = {"power": "POWER({c}, 2)", "sqrt": "SQRT(ABS({c}))",
             "ln": "LN(ABS({c}) + 1)", "log10": "LOG10(ABS({c}) + 1)"}
FUNCTION_COLUMNS = {"int": "i", "long": "lm", "double": "f"}
EXACT_AGGS = {"min": "MIN({x})", "max": "MAX({x})",
              "sumprecision": "SUMPRECISION({x})",
              "hll": "DISTINCTCOUNTHLL({x})"}
FUNCTION_SHAPES = {"device": (None, ""), "mv_key": ("tags", "")}
# the device shape's dtypes show in MIN / MAX, the host path's last bits
# in the exact sums and the hashes
FUNCTION_CASES = [(a, "device") for a in EXACT_AGGS] \
    + [("sumprecision", "mv_key"), ("hll", "mv_key")]


@pytest.mark.parametrize("agg,shape", FUNCTION_CASES)
@pytest.mark.parametrize("col", list(FUNCTION_COLUMNS))
@pytest.mark.parametrize("fn", list(FUNCTIONS))
def test_float_function_bits(engines, fn, col, agg, shape):
    """Bit for bit, but for a logarithm of a DOUBLE column's float32
    plane in the device shape: the reference's device computes float32
    logarithms with XLA's own polynomial, a last bit off libm's for some
    values (ROADMAP queue 3, kept divergences), so within
    ``rows_close``."""
    x = FUNCTIONS[fn].format(c=FUNCTION_COLUMNS[col])
    f32_log = shape == "device" and col == "double" and fn in ("ln", "log10")
    check(engines, _select(EXACT_AGGS[agg].format(x=x),
                           FUNCTION_SHAPES[shape]), [not f32_log])


# a literal inside a float function or beside a float plane in the device
# shape: LN(10) and SQRT(2) of an int64 literal, and an integer literal in
# [2^63, 2^64), which JAX promotes as a uint64 (the float plane's dtype
# beside a FLOAT or DOUBLE plane, float64 beside an integer one)
LITERAL_FUNCTIONS = {
    "fl_ln10": "MAX(fl * LN(10))", "f_sqrt2": "MIN(f * SQRT(2))",
    "i_ln10": "MAX(i * LN(10))", "fl_2e63": "MAX(fl * 9223372036854775808)",
    "f_2e63": "MIN(f - 9223372036854775808)",
    "i_2e63": "MAX(i * 9223372036854775808)",
}


@pytest.mark.parametrize("agg", list(LITERAL_FUNCTIONS))
def test_literal_function_dtype(engines, agg):
    check(engines, f"SELECT {LITERAL_FUNCTIONS[agg]} FROM t", [True])


# ---------------------------------------------------------------------------
# F10: VALUEIN as an aggregation's operand
# ---------------------------------------------------------------------------

VALUEIN = "VALUEIN(tags, 1, 2)"
VALUEIN_AGGS = {
    "firstwithtime": f"FIRSTWITHTIME({VALUEIN}, ts, 'DOUBLE')",
    "lastwithtime": f"LASTWITHTIME({VALUEIN}, ts, 'DOUBLE')",
    "distinctcount": f"DISTINCTCOUNT({VALUEIN})",
    "distinctcounthll": f"DISTINCTCOUNTHLL({VALUEIN})",
}
VALUEIN_SHAPES = {"device": (None, ""),
                  "docid": (None, "WHERE $docId < 1800"),
                  "mv_key": ("tags", "")}


@pytest.mark.parametrize("shape", list(VALUEIN_SHAPES))
@pytest.mark.parametrize("agg", list(VALUEIN_AGGS))
def test_valuein_operand(engines, agg, shape):
    check(engines, _select(VALUEIN_AGGS[agg], VALUEIN_SHAPES[shape]),
          [True])
