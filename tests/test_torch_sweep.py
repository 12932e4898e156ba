"""A differential sweep of the port against the reference, one query per
case, over the shapes where the two packages' value semantics part. This
file holds integer literals at 2^63 - 1, 2^63, 2^64 and -2^63 - 1 in
every comparison, over INT / LONG / FLOAT / DOUBLE columns, in a filter
and inside ``SUM(x + lit)``; float and integer literals against a raw MV
FLOAT column; and the faults' examples as first found.
tests/test_torch_sweep_functions.py holds the aggregations' operands
(ROUND with a scale, CAST to STRING, the float functions, VALUEIN), so
that the two halves can run on two workers.

tests/test_torch_host_float64.py's schema and seeded segments are the
data: sealed, consuming and warm. The oracle is the reference's
``QueryEngine()``; where it fails (its device has no form for the
shape), its host-only engine ``QueryEngine(device_executor=None)``; where
that fails too, the port must refuse in-band, saying that the reference's
host fails on it too. The port runs on the CPU at the default kernel gate
and at gate 0. MIN / MAX / MINMAXRANGE, SUMPRECISION, the percentiles,
FIRST/LASTWITHTIME, counts and integers must equal the oracle's bit for
bit with the same Python type, SUM / AVG within ``rows_close``.
"""

import warnings

import numpy as np
import pytest

import test_torch_host_float64 as hf
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from test_torch_host_float64 import dirs  # noqa: F401 — the segments

TIERS = ("sealed", "consuming", "warm")
REFUSED = "the reference's host path fails on it too"


@pytest.fixture(scope="module", params=TIERS)
def engines(request, dirs):  # noqa: F811 — the imported fixture
    """(reference, reference host-only, [port at each gate], tier) over
    one tier's segments."""
    t = request.param
    return (hf._load("ref", hf._engine("ref"), t, dirs["ref"]),
            hf._load("ref", RefEngine(device_executor=None), t, dirs["ref"]),
            [hf._load("port", hf._engine("port", g), t, dirs["port"])
             for g in hf.GATES], t)


def _message(resp: dict) -> str:
    return " ".join(str(e.get("message", e))
                    for e in resp.get("exceptions") or [])


def check(engines, sql: str, exact: list) -> None:
    """The port's answer at both gates against the oracle's; no
    RuntimeWarning from the port. Returns the oracle's response."""
    ref, host, ports, _tier = engines
    want = ref.execute(sql)
    if want.get("exceptions"):
        want = host.execute(sql)
    for port in ports:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always", RuntimeWarning)
            got = port.execute(sql)
        assert not [w for w in seen if issubclass(w.category,
                                                  RuntimeWarning)], \
            [str(w.message) for w in seen]
        if want.get("exceptions"):
            assert REFUSED in _message(got), (got, _message(want))
        else:
            hf.assert_host_answer(got, want, exact)
    return want


def _select(aggs: str, shape: tuple) -> str:
    key, where = shape
    if key is None:
        return f"SELECT {aggs} FROM t {where}".strip()
    return (f"SELECT {key}, {aggs} FROM t {where} GROUP BY {key} "
            f"ORDER BY {key} LIMIT 1000")


# ---------------------------------------------------------------------------
# F6: integer literals at and past the ends of int64
# ---------------------------------------------------------------------------

LITERALS = {"int64_max": 2 ** 63 - 1, "2e63": 2 ** 63, "2e64": 2 ** 64,
            "below_int64": -2 ** 63 - 1}
COMPARISONS = {
    "eq": "{c} = {v}", "ne": "{c} <> {v}", "lt": "{c} < {v}",
    "le": "{c} <= {v}", "gt": "{c} > {v}", "ge": "{c} >= {v}",
    "in": "{c} IN (3, {v})", "not_in": "{c} NOT IN (3, {v})",
    "between": "{c} BETWEEN {lo} AND {hi}",
}
# the raw LONG / DOUBLE columns: a dict column's predicate searches the
# global dictionary with code both packages share
COLUMNS = {"int": "i", "long": "big", "float": "fl", "double": "f"}


def _predicate(op: str, col: str, v: int) -> str:
    lo, hi = (-5, v) if v > 0 else (v, 5)
    return COMPARISONS[op].format(c=col, v=v, lo=lo, hi=hi)


@pytest.mark.parametrize("col", list(COLUMNS))
@pytest.mark.parametrize("op", list(COMPARISONS))
@pytest.mark.parametrize("lit", list(LITERALS))
def test_literal_in_a_filter(engines, lit, op, col):
    p = _predicate(op, COLUMNS[col], LITERALS[lit])
    check(engines, f"SELECT COUNT(*) FROM t WHERE {p}", [True])


@pytest.mark.parametrize("lit", list(LITERALS))
def test_literal_in_a_grouped_filter(engines, lit):
    v = LITERALS[lit]
    check(engines, f"SELECT d, COUNT(*) FROM t WHERE big < {v} OR fl > {v} "
          f"GROUP BY d ORDER BY d", [True])


LITERAL_SHAPES = {"device": (None, ""), "docid": (None, "WHERE $docId < 1800")}


SUM_COLUMNS = dict(COLUMNS, long_dict="lm", double_dict="fd")


@pytest.mark.parametrize("shape", list(LITERAL_SHAPES))
@pytest.mark.parametrize("col", list(SUM_COLUMNS))
@pytest.mark.parametrize("lit", list(LITERALS))
def test_literal_in_a_sum(engines, lit, col, shape):
    sql = _select(f"SUM({SUM_COLUMNS[col]} + {LITERALS[lit]})",
                  LITERAL_SHAPES[shape])
    check(engines, sql, [False])


# a raw MV FLOAT column's entries meet the literals in numpy's promoted
# dtype on the host path (float64 beside a float or an int literal), so
# 0.1f is not 0.1, and 16777217 is no float32's
MV_ENTRIES = np.array([0.1, 0.2, 3.0, 16777217.0, 0.5, 7.25],
                      dtype=np.float32)
MV_PREDICATES = {"in_float": "mf IN (0.1, 0.2)",
                 "in_int": "mf IN (3, 16777217)",
                 "not_in_float": "mf NOT IN (0.1, 0.2)",
                 "eq_float": "mf = 0.1", "eq_int": "mf = 16777217",
                 "between_float": "mf BETWEEN 0.1 AND 0.5"}


def _mv_schema(side):
    sc, dt = hf.MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(name="m", dimensions=[("k", D.INT)],
                           multi_value_dimensions=[("mf", D.FLOAT)],
                           metrics=[("x", D.LONG)])


def _mv_data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 5, n).astype(np.int32),
            "mf": [MV_ENTRIES[rng.integers(0, len(MV_ENTRIES),
                                           rng.integers(1, 4))].tolist()
                   for _ in range(n)],
            "x": rng.integers(0, 100, n)}


@pytest.fixture(scope="module")
def mv_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_mv")
    out = {}
    for side in hf.MODS:
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        out[side] = []
        for j in range(2):
            d = str(base / f"{side}{j}")
            creator.build_segment(
                _mv_schema(side), _mv_data(hf.N, 60 + j), d,
                tc.TableConfig(table_name="m", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["mf"])), f"m{j}")
            out[side].append(d)
    return out


def _mv_load(side, eng, tier: str, dirs: list):
    _sc, _dt, _tc, _cr, mut, tiering, segment = hf.MODS[side]
    if tier == "warm":
        for d in dirs:
            eng.add_segment("m", tiering.LazySegmentView(d))
        return eng
    eng.add_segment("m", segment.ImmutableSegment(dirs[0]))
    if tier == "sealed":
        eng.add_segment("m", segment.ImmutableSegment(dirs[1]))
    else:
        ms = mut.MutableSegment(_mv_schema(side), "m__0__0__rt")
        ms.index_batch(hf._records(_mv_data(hf.N, 78)))
        eng.add_segment("m", ms)
    return eng


@pytest.fixture(scope="module", params=TIERS)
def mv_engines(request, mv_dirs):
    """``engines`` over a table with a raw MV FLOAT column."""
    t = request.param
    return (_mv_load("ref", hf._engine("ref"), t, mv_dirs["ref"]),
            _mv_load("ref", RefEngine(device_executor=None), t,
                     mv_dirs["ref"]),
            [_mv_load("port", hf._engine("port", g), t, mv_dirs["port"])
             for g in hf.GATES], t)


@pytest.mark.parametrize("pred", list(MV_PREDICATES))
def test_literal_against_a_raw_float_mv_column(mv_engines, pred):
    check(mv_engines, "SELECT COUNT(*), SUM(x) FROM m WHERE "
          f"{MV_PREDICATES[pred]}", [True, True])


# ---------------------------------------------------------------------------
# the faults' examples as first found that no case above asks as such,
# and the sealed segments' answers as first recorded. The others are
# cases of the sweep: ``big < 9223372036854775808`` (literal_in_a_filter
# 2e63-lt-long above), SUMPRECISION / DISTINCTCOUNTHLL of POWER(f, 2) by
# tags (test_torch_sweep_functions.py float_function_bits
# power-double-*-mv_key), FIRSTWITHTIME and DISTINCTCOUNT of VALUEIN by
# tags (its valuein_operand *-mv_key)
# ---------------------------------------------------------------------------

EXAMPLES = {
    "f6_between_past_int64": (
        "SELECT COUNT(*) FROM t WHERE big BETWEEN 1500000000000000000 AND "
        "15000000000000000000", [True], [[3531]]),
    "f6_grouped": ("SELECT d, COUNT(*) FROM t WHERE lm < 9223372036854775808 "
                   "GROUP BY d ORDER BY d", [True], None),
    "f7_round": ("SELECT SUM(ROUND(i, 1)) FROM t WHERE $docId < 1800",
                 [False], [[15081.0]]),
    "f9_sqrt_long": ("SELECT MAX(SQRT(ABS(lm))) FROM t", [True],
                     [[4194208.888639787]]),
    "f10_hll": ("SELECT DISTINCTCOUNTHLL(VALUEIN(tags, 1, 2)) FROM t WHERE "
                "$docId < 1800", [True], [[5]]),
    "string_cast_predicate": ("SELECT COUNT(*) FROM t WHERE CAST(k AS "
                              "STRING) = '3'", [True], [[487]]),
}


@pytest.mark.parametrize("example", list(EXAMPLES))
def test_quoted_example(engines, example):
    """Each as the oracle answers it; on sealed segments, the rows as
    first recorded."""
    sql, exact, sealed_rows = EXAMPLES[example]
    want = check(engines, sql, exact)
    if engines[3] == "sealed" and sealed_rows is not None:
        assert want["resultTable"]["rows"] == sealed_rows
