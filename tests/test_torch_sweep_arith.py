"""A differential sweep of the port against the reference: the arithmetic
functions at their edge values, as aggregations' operands.

F14-F17 (ROADMAP queue 3), each repaired where the port evaluates the
function:

- F14: MOD by an integer zero raised ``ZeroDivisionError`` in the device
  template (``torch.remainder``); it is 0, as ``jnp.mod`` and ``np.mod``
  give it;
- F15: CAST of a float past the integer type's range, or of NaN, took
  torch's CPU cast (the type's minimum) in the device template; it
  saturates there with NaN as 0, as XLA's convert does, and keeps
  numpy's minimum in the host path's shape;
- F16: SIGN of NaN gave 0 (``torch.sign``); it is NaN in both shapes,
  -0.0 keeps its sign in the device template (``jnp.sign``) and gives
  0.0 in the host path's shape (``np.sign``);
- F17: in the host path's shape, an aggregation's operand whose value
  is not float64 but holds a float64 expression (a CAST to INT or LONG of
  a FLOAT column times a float literal, or of a DOUBLE column) took the
  device template, which computes that expression in float32; it takes
  the host's values now (engine/rows.py ``_template_reads``);
- D1: POWER of integers with a negative exponent is refused in-band in
  every tier with numpy's message, where the reference's host refuses
  it and its device's integer power gives no power.

The functions: MOD with an integer and a float divisor, CAST to INT,
LONG, FLOAT, DOUBLE and BOOLEAN, SIGN, ABS, CEIL, FLOOR, LEAST, GREATEST,
DIVIDE and POWER, over operands made in the query from the schema's
columns: a zero divisor (``k`` holds zeros, and a literal 0), NaN
(``SQRT(fl - 0.5)``), +-inf (``fl / 0``), -0.0 (``-0.0 * fl``), floats
past int32 and int64 (``fl * 1e10``, ``fl * 1e30`` and their negations)
and the ends of int32 and int64 as literals. A zero's sign shows as the
sign of an infinity: ``1 / x``.

This file holds SUM, MIN, MAX, AVG and MINMAXRANGE of each as a scalar,
in the device shape and under ``$docId < 1800`` (the host path's shape),
and the faults' examples as first found;
tests/test_torch_sweep_arith_grouped.py holds the same grouped by ``k``,
tests/test_torch_sweep_arith_shapes.py the other positions (a WHERE
predicate, a group key, a selected column, a CASE branch) and stage 2,
so that the three run on three workers; tests/test_torch_edge_values.py
holds each function alone against ``jnp`` and numpy.

The data is tests/test_torch_host_float64.py's seeded segments in its
three tiers (sealed, consuming beside a sealed segment, warm), and the
oracle and its rule are tests/test_torch_sweep.py's ``check``: the
reference's ``QueryEngine()``, its host-only engine where that fails, an
in-band refusal where both fail. The port runs on the CPU at the default
kernel gate and at gate 0. MIN, MAX, MINMAXRANGE and counts match bit
for bit with the same Python type, SUM and AVG within ``rows_close``.
"""

import pytest

import test_torch_host_float64 as hf
import test_torch_sweep as sw
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.ops.transform import NEGATIVE_POWER
from test_torch_host_float64 import dirs  # noqa: F401 — the segments
from test_torch_sweep import engines  # noqa: F401 — the tiers' engines
from test_torch_sweep_strings import one_thread  # noqa: F401 — one thread

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
INT64_MAX = 2 ** 63 - 1
NAN = "SQRT(fl - 0.5)"
INF, NEG_INF = "fl / 0", "(0 - fl) / 0"
NEG_ZERO = "-0.0 * fl"
# +0.0 without a zero literal: the reference's host caches each
# expression's values by the expression, and ``0.0 * fl`` equals
# ``-0.0 * fl`` as a key (0.0 == -0.0), so one would read the other's
POS_ZERO = "fl - fl"

# each function over its edge operands (integer POWER with a negative
# exponent is D1's, below)
EXPRESSIONS = {
    # MOD: integer divisors with zeros, a literal 0, int64, float divisors
    "mod_k": "MOD(i, k)",
    "mod_zero": "MOD(i, 0)",
    "mod_long_k": "MOD(big, k - 5)",
    "mod_int_min": f"MOD(i, {INT32_MIN})",
    "mod_float_divisor": "MOD(i, fl - 0.5)",
    "mod_float_zero": "MOD(fl, 0)",
    "mod_neg_zero": f"1 / MOD({NEG_ZERO}, 3)",
    # CAST to an integer past its range, of NaN and of +-inf
    "cast_int_past": "CAST(fl * 1e10 AS INT)",
    "cast_int_past_neg": "CAST(fl * -1e10 AS INT)",
    "cast_int_nan": f"CAST({NAN} AS INT)",
    "cast_int_inf": f"CAST({INF} AS INT)",
    "cast_int_neg_inf": f"CAST({NEG_INF} AS INT)",
    "cast_int_double": "CAST(f * 1e9 AS INT)",
    "cast_int_f17": "CAST(fl * 1e9 AS INT)",
    "cast_long_past": "CAST(fl * 1e30 AS LONG)",
    "cast_long_past_neg": "CAST(fl * -1e30 AS LONG)",
    "cast_long_nan": f"CAST({NAN} AS LONG)",
    "cast_long_int_end": f"CAST(i * 0 + {INT64_MAX} AS LONG)",
    "cast_int_long": "CAST(big AS INT)",
    "cast_float_long": "CAST(big AS FLOAT)",
    "cast_double_past": "CAST(fl * 1e30 AS DOUBLE)",
    "cast_bool_nan": f"CAST({NAN} AS BOOLEAN)",
    "cast_bool_neg_zero": f"CAST({NEG_ZERO} AS BOOLEAN)",
    # SIGN of NaN, -0.0, +-inf, integers
    "sign_nan": f"SIGN({NAN})",
    "sign_neg_zero": f"1 / SIGN({NEG_ZERO})",
    "sign_inf": f"SIGN({NEG_INF})",
    "sign_int": "SIGN(k - 5)",
    # ABS, CEIL, FLOOR
    "abs_neg_zero": f"1 / ABS({NEG_ZERO})",
    "abs_nan": f"ABS({NAN})",
    "abs_int_end": f"ABS(LEAST(i, {INT32_MIN}))",
    "ceil_neg_zero": "1 / CEIL(0 - fl)",
    "ceil_past": "CEIL(fl * 1e30)",
    "floor_nan": f"FLOOR({NAN})",
    "floor_neg_zero": f"1 / FLOOR({NEG_ZERO})",
    # LEAST, GREATEST: NaN, infinities, zeros of both signs, int ends
    "least_nan": f"LEAST({NAN}, fl)",
    "greatest_inf": f"GREATEST({INF}, i)",
    "least_zeros": f"1 / LEAST({NEG_ZERO}, {POS_ZERO})",
    "greatest_zeros": f"1 / GREATEST({NEG_ZERO}, {POS_ZERO})",
    "greatest_int_end": f"GREATEST(i, {INT32_MAX})",
    # DIVIDE by zeros
    "divide_k": "i / k",
    "divide_zero": "DIVIDE(i, 0)",
    "divide_neg_zero": f"fl / ({NEG_ZERO})",
    # POWER with a non-negative integer exponent
    "power_k": "POWER(k, 2)",
    "power_wrap": "POWER(big, 3)",
    "power_past": "POWER(fl * 1e30, 2)",
}
AGGS = "SUM({x}), MIN({x}), MAX({x}), AVG({x}), MINMAXRANGE({x})"
AGG_EXACT = [False, True, True, False, True]
SHAPES = {"scalar": (None, ""), "docid": (None, "WHERE $docId < 1800")}


@pytest.fixture(scope="module")
def kernel_tier(engines, dirs):  # noqa: F811
    """The reference at its kernel tier over ``engines``' tier, built on
    first use: ``DeviceExecutor(mm_mode="interpret")`` runs its Pallas
    kernels at every size, as the port at gate 0 runs its own."""
    made = []

    def get():
        if not made:
            made.append(hf._load("ref", RefEngine(
                device_executor=RefExecutor(mm_mode="interpret")),
                engines[3], dirs["ref"]))
        return made[0]
    return get


def check(engines, sql: str, exact: list, kernel_tier) -> dict:
    """tests/test_torch_sweep.py's ``check`` at the default gate; at gate
    0 the port's answer is the reference's default one or, where they
    part, its kernel tier's. They part at a SUM or AVG over +-inf in the
    device shape: the reference's K1 splits a float into three bf16 planes
    (its ``float_planes``, the port's too), and inf into inf and NaN, so
    its kernels sum a group holding an infinity to NaN."""
    ref, host, (port, port0), tier = engines
    want = sw.check((ref, host, [port], tier), sql, exact)
    try:
        sw.check((ref, host, [port0], tier), sql, exact)
    except AssertionError:
        if want.get("exceptions") or ref.execute(sql).get("exceptions"):
            raise   # the host's answer: no kernel tier to defer to
        sw.check((kernel_tier(), host, [port0], tier), sql, exact)
    return want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_aggregation_operand(engines, kernel_tier, expr,
                             shape):  # noqa: F811
    sql = sw._select(AGGS.format(x=EXPRESSIONS[expr]), SHAPES[shape])
    check(engines, sql, AGG_EXACT, kernel_tier)


# ---------------------------------------------------------------------------
# D1: POWER of integers with a negative exponent
# ---------------------------------------------------------------------------

D1_SQL = {
    "max_literal": "SELECT MAX(POWER(k, -1)) FROM t",
    "sum_literal": "SELECT SUM(POWER(k, -1)) FROM t WHERE k > 0",
    "column": "SELECT MAX(POWER(k, i)) FROM t",
    "grouped": "SELECT d, MIN(POWER(i, -2)) FROM t GROUP BY d",
    "docid": "SELECT MAX(POWER(k, -1)) FROM t WHERE $docId < 1800",
    "where": "SELECT COUNT(*) FROM t WHERE POWER(k, -1) > 0",
}


@pytest.mark.parametrize("which", list(D1_SQL))
def test_integer_power_with_a_negative_exponent_is_refused(
        engines, which):  # noqa: F811
    """Refused in-band in every tier and shape with the reference host's
    message, where its host-only engine refuses it. (Its device answers
    the sealed tier with no power: MAX(POWER(k, -1)) is
    2.8985526246007624e18.)"""
    _ref, host, ports, _tier = engines
    sql = D1_SQL[which]
    assert NEGATIVE_POWER in sw._message(host.execute(sql))
    for port in ports:
        msg = sw._message(port.execute(sql))
        assert sw.REFUSED in msg and NEGATIVE_POWER in msg, msg


# ---------------------------------------------------------------------------
# the faults' examples as first found (ROADMAP queue 3), with the sealed
# tier's answers as first recorded where they hold no NaN
# ---------------------------------------------------------------------------

F14_AGGS = "SUM(MOD(i, k)), MIN(MOD(i, k)), MAX(MOD(i, k))"
F17_MAX = "MAX(CAST(fl * 1e9 AS {t}))"
EXAMPLES = {
    "f14_aggs": (f"SELECT {F14_AGGS} FROM t", [False, True, True],
                 [[8522.0, 0.0, 8.0]]),
    "f14_where": ("SELECT COUNT(*) FROM t WHERE MOD(i, k) = 0", [True],
                  [[1964]]),
    "f14_literal_zero": ("SELECT MAX(MOD(i, 0)) FROM t", [True], [[0.0]]),
    "f14_docid": (f"SELECT {F14_AGGS} FROM t WHERE $docId < 1800",
                  [False, True, True], None),
    "f14_long": ("SELECT SUM(MOD(big, k)) FROM t", [False], None),
    "f14_key": ("SELECT MOD(i, k - 5), COUNT(*) FROM t GROUP BY "
                "MOD(i, k - 5) ORDER BY MOD(i, k - 5) LIMIT 100", [True],
                None),
    "f15_sum": ("SELECT SUM(CAST(f * 1e9 AS INT)) FROM t", [False],
                [[9486903467453.0]]),
    "f15_where": ("SELECT COUNT(*) FROM t WHERE CAST(f * 1e9 AS INT) < 0",
                  [True], [[0]]),
    "f15_nan": ("SELECT MIN(CAST(SQRT(fl - 0.5) AS INT)) FROM t", [True],
                [[0.0]]),
    "f15_long": ("SELECT MAX(CAST(fl * 1e30 AS LONG)) FROM t", [True],
                 [[9.223372036854776e18]]),
    "f16_grouped": ("SELECT k, MAX(SIGN(SQRT(fl - 0.5))) FROM t GROUP BY k "
                    "ORDER BY k", [True], None),
    "f16_where": ("SELECT COUNT(*) FROM t WHERE SIGN(SQRT(fl - 0.5)) = 0",
                  [True], [[0]]),
    "f16_docid": ("SELECT MAX(SIGN(SQRT(fl - 0.5))) FROM t WHERE $docId < "
                  "1800", [True], [[None]]),
    "f16_neg_zero": ("SELECT MAX(1 / SIGN(-0.0 * fl)) FROM t", [True],
                     [[float("-inf")]]),
    "f16_key": ("SELECT SIGN(SQRT(fl - 0.5)) AS s, COUNT(*) FROM t GROUP BY "
                "s ORDER BY s", [True], None),
    "f17_int": (f"SELECT {F17_MAX.format(t='INT')} FROM t WHERE $docId < "
                f"1800", [True], [[999174356.0]]),
    "f17_long": (f"SELECT {F17_MAX.format(t='LONG')} FROM t WHERE $docId < "
                 f"1800", [True], [[999174356.0]]),
    "f17_grouped": (f"SELECT k, {F17_MAX.format(t='INT')} FROM t WHERE "
                    f"$docId < 1800 GROUP BY k ORDER BY k", [True],
                    [[0, 997494399.0], [1, 995681941.0]]),
    "f17_sum": ("SELECT SUM(CAST(fl * 1e9 AS LONG)) FROM t WHERE $docId < "
                "1800", [False], [[1808308929837.0]]),
    # the device shape in the sealed tier: the float32 neighbour, as the
    # reference's device answers; the host's value in the warm tier
    "f17_warm": (f"SELECT {F17_MAX.format(t='INT')} FROM t", [True],
                 [[999174336.0]]),
    # the same route: a DOUBLE column read from its float32 plane
    "f17_double": ("SELECT SUM(CAST(f * 1000 AS INT)), MAX(CAST(f * 1e9 AS "
                   "INT)) FROM t WHERE $docId < 1800", [True, True],
                   [[16235368.0, 2146999999.0]]),
}


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_quoted_example(engines, kernel_tier, example):  # noqa: F811
    """Each as the oracle answers it; on sealed segments, the first rows
    as first recorded."""
    sql, exact, sealed_rows = EXAMPLES[example]
    want = check(engines, sql, exact, kernel_tier)
    if engines[3] == "sealed" and sealed_rows is not None:
        assert want["resultTable"]["rows"][:len(sealed_rows)] == sealed_rows
