"""SUMPRECISION over fractions on the port against the JAX package.

The reference adds ``Decimal(repr(float(v)))`` (an ``int`` where the
value is integral) one at a time into an ``int`` 0 under Python's
28-digit context and renders the sum with ``str()``. While every
partial sum of a group fits 28 digits at the group's least exponent no
addition rounds, so the answer is the exact sum in any order: the port
scales each distinct value by the batch's least exponent to an int64,
sums those and their magnitudes per group through K1's byte planes,
takes each group's least exponent through K2, and renders the exact
sum. These tests hold its strings to the reference's character for
character: over dict and raw DOUBLE, raw FLOAT (widened, so 0.1f is
0.10000000149011612) and expressions; groups of integers only (an int)
beside groups with fractions; the scientific form ('1E-7') and trailing
zeros ('1.0'); a segment where a group holds only integers merged with
one where it holds fractions; NaN and the infinities as Decimal treats
them (+inf meeting -inf fails the reference, and the port refuses);
a group past 28 digits, refused in-band (the reference's answer there
is not the exact sum); the star-tree's fractional decimal states; and
tests/test_agg_extended.py's and tests/test_startree.py's SUMPRECISION
shapes over DOUBLE columns.
"""

import decimal

import numpy as np
import pytest

import test_agg_extended
import test_startree
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import (
    IndexingConfig,
    StarTreeIndexConfig,
    TableConfig,
)
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response
from test_torch_sketches import _PortEngine, agg_extended_port  # noqa: F401


def _schema():
    D = DataType
    return Schema.build(name="p", dimensions=[("g", D.STRING),
                                              ("xd", D.DOUBLE)],
                        metrics=[("x", D.DOUBLE), ("f", D.FLOAT),
                                 ("i", D.INT)])


def _segment(rng, n: int, fraction_groups) -> dict:
    g = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)]
    x = np.round(rng.uniform(-50, 200, n), 2)
    ints = ~np.isin(g, fraction_groups)
    x[ints] = np.round(x[ints])    # integral doubles: the reference's ints
    x[:6] = [0.5, 0.5, 1e-07, 2.5e-05, -0.25, 123456789.125]
    g[:6] = ["a", "a", "c", "c", "a", "c"]
    return {"g": g, "xd": x, "x": x,
            "f": np.round(rng.uniform(0, 10, n), 1).astype(np.float32),
            "i": rng.integers(-9, 9, n).astype(np.int32)}


def _write(base, parts, cfg=None, first: int = 0) -> list:
    cfg = cfg or TableConfig(table_name="p", indexing=IndexingConfig(
        no_dictionary_columns=["x", "f", "i"]))
    dirs = []
    for i, cols in enumerate(parts, first):
        out = str(base / f"s{i}")
        build_segment(_schema(), cols, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    rng = np.random.default_rng(77)
    # 'b' holds only integers in s0 and fractions in s1; 'd' only
    # integers everywhere
    return _write(tmp_path_factory.mktemp("torch_sumprec"), [
        _segment(rng, 1500, ("a", "c")),
        _segment(rng, 2000, ("a", "b", "c")),
        _segment(rng, 1200, ("c",))])


def _ref(dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in dirs:
        eng.add_segment("p", RefSegment(d))
    return eng


def _port(dirs, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        eng.add_segment("p", ImmutableSegment(d))
    return eng


SQL = {
    "raw_by_g": "SELECT g, SUMPRECISION(x) FROM p GROUP BY g ORDER BY g",
    "raw_scalar": "SELECT SUMPRECISION(x) FROM p",
    "dict_by_g": "SELECT g, SUMPRECISION(xd) FROM p GROUP BY g ORDER BY g",
    "float_by_g": "SELECT g, SUMPRECISION(f) FROM p GROUP BY g ORDER BY g",
    "expr_times": "SELECT SUMPRECISION(x * 3) FROM p WHERE x >= 0.01",
    "expr_plus": ("SELECT g, SUMPRECISION(x + f) FROM p GROUP BY g "
                  "ORDER BY g"),
    "expr_divide": ("SELECT g, SUMPRECISION(i / 4) FROM p GROUP BY g "
                    "ORDER BY g"),
    "filtered": ("SELECT g, SUMPRECISION(x), COUNT(*), SUM(i) FROM p "
                 "WHERE i > 0 GROUP BY g ORDER BY g"),
    "tiny_and_halves": ("SELECT g, SUMPRECISION(x) FROM p WHERE "
                        "x IN (0.5, 1e-07, 2.5e-05, -0.25) GROUP BY g "
                        "ORDER BY g"),
    "ints_only_group": ("SELECT SUMPRECISION(x) FROM p WHERE g = 'd'"),
    "by_segment": ("SELECT $segmentName, g, SUMPRECISION(x) FROM p GROUP BY "
                   "$segmentName, g ORDER BY $segmentName, g"),
    "high_card": ("SELECT i, SUMPRECISION(x), SUMPRECISION(f) FROM p "
                  "GROUP BY i ORDER BY i"),
    "empty": "SELECT g, SUMPRECISION(x) FROM p WHERE i > 100 GROUP BY g",
    "empty_scalar": "SELECT SUMPRECISION(x) FROM p WHERE i > 100",
}


@pytest.fixture(scope="module")
def ref_responses(segment_dirs):
    eng = _ref(segment_dirs)
    return {k: eng.execute(sql) for k, sql in SQL.items()}


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "gate"])
def port_engine(request, segment_dirs):
    return _port(segment_dirs, request.param)


@pytest.mark.parametrize("name", sorted(SQL))
def test_sumprecision_matches_reference(port_engine, ref_responses, name):
    got = port_engine.execute(SQL[name])
    assert_same_response(got, ref_responses[name])
    # strings, character for character
    assert got["resultTable"]["rows"] == ref_responses[name][
        "resultTable"]["rows"]


def test_the_forms_the_reference_renders(port_engine, ref_responses):
    rows = dict(port_engine.execute(
        "SELECT g, SUMPRECISION(x) FROM p WHERE x = 0.5 OR x = 1e-07 "
        "GROUP BY g ORDER BY g")["resultTable"]["rows"])
    assert rows["c"] == "3E-7"        # three 1e-07, one a segment
    assert rows["a"] == "3.0"         # six halves: a trailing zero
    d = ref_responses["ints_only_group"]["resultTable"]["rows"][0][0]
    assert "." not in d and "E" not in d   # an int: no fraction met


def test_float_widens_before_repr(segment_dirs, tmp_path):
    """A FLOAT 0.1 is the double 0.10000000149011612: its repr is what
    the reference sums."""
    cols = {"g": np.array(["a", "a"]), "xd": np.array([1.0, 2.0]),
            "x": np.array([1.0, 2.0]),
            "f": np.array([0.1, 0.1], dtype=np.float32),
            "i": np.array([1, 2], dtype=np.int32)}
    dirs = _write(tmp_path, [cols])
    sql = "SELECT SUMPRECISION(f) FROM p"
    got = _port(dirs).execute(sql)["resultTable"]["rows"]
    assert got == [["0.20000000298023224"]]
    assert got == _ref(dirs).execute(sql)["resultTable"]["rows"]


def _special_dirs(tmp_path, parts) -> list:
    out = []
    for i, vals in enumerate(parts):
        n = len(vals)
        cols = {"g": np.array(["a"] * n), "xd": np.zeros(n),
                "x": np.asarray(vals, dtype=np.float64),
                "f": np.zeros(n, dtype=np.float32),
                "i": np.arange(n, dtype=np.int32)}
        out += _write(tmp_path, [cols], first=i)
    return out


@pytest.mark.parametrize("parts", [
    [[1.5, np.nan, 2.0]],
    [[np.inf, 0.5], [2.25]],
    [[-np.inf, 1.5]],
    [[np.inf, np.nan, -np.inf, 0.5]],
    [[np.inf, 0.5], [np.nan], [-np.inf]],
    [[np.nan], [np.inf, 0.25]],
], ids=["nan", "inf_merged", "ninf", "nan_between", "nan_segment",
        "nan_first"])
def test_nan_and_infinities_as_decimal(tmp_path, parts):
    dirs = _special_dirs(tmp_path, parts)
    for sql in ("SELECT SUMPRECISION(x) FROM p",
                "SELECT g, SUMPRECISION(x) FROM p GROUP BY g"):
        want = _ref(dirs).execute(sql)
        for gate in (0, None):
            got = _port(dirs, gate).execute(sql)
            assert_same_response(got, want)


@pytest.mark.parametrize("parts", [
    [[np.inf, -np.inf, np.nan, 0.5]],
    [[-np.inf, 0.5], [np.inf]],
], ids=["in_segment", "across_segments"])
def test_inf_plus_ninf_is_refused(tmp_path, parts):
    """+inf meeting -inf before any NaN: Decimal raises InvalidOperation
    in the reference's host path; the port refuses in-band, saying so."""
    dirs = _special_dirs(tmp_path, parts)
    sql = "SELECT SUMPRECISION(x) FROM p"
    want = _ref(dirs).execute(sql)["exceptions"]
    assert want and "InvalidOperation" in want[0]["message"]
    msg = _port(dirs).execute(sql)["exceptions"][0]["message"]
    assert "the reference's host path fails on it too" in msg
    assert "InvalidOperation" in msg


def test_past_28_digits_is_refused(tmp_path):
    """1e-20 beside 1e10 needs 31 digits at the group's exponent: the
    reference's context rounds, so its answer is not the exact sum (and
    depends on the order of its additions); the port refuses in-band."""
    dirs = _special_dirs(tmp_path, [[1e-20, 1e10, 3.0]])
    sql = "SELECT SUMPRECISION(x) FROM p"
    want = _ref(dirs).execute(sql)["resultTable"]["rows"][0][0]
    with decimal.localcontext() as ctx:
        ctx.prec = 100
        exact = decimal.Decimal(repr(1e-20)) + 10_000_000_000 + 3
    assert decimal.Decimal(want) != exact
    msg = _port(dirs).execute(sql)["exceptions"][0]["message"]
    assert "more than 28 digits" in msg and "queue 3" in msg


def test_expression_past_28_digits_is_refused(segment_dirs):
    """x * 3 over 1e-07 gives 3.0000000000000004e-07: at its exponent the
    batch's sum needs 32 digits, so the reference rounds; the port
    refuses in-band (its twin past 0.01 answers, above)."""
    sql = "SELECT SUMPRECISION(x * 3) FROM p"
    assert _ref(segment_dirs).execute(sql)["exceptions"] == []
    msg = _port(segment_dirs).execute(sql)["exceptions"][0]["message"]
    assert "more than 28 digits" in msg


def test_limbs_past_int64(tmp_path):
    """Scaled to the batch's least exponent a summand may pass int64: it
    goes to K1 in 62-bit limbs. 1e15 beside 1e-7 is 1e22 units of 1e-7,
    and its group's answer is exact; past four limbs (1e300 beside a
    fraction) the port refuses in-band, a named divergence."""
    dirs = _special_dirs(tmp_path / "a", [[1e15, 1e-07, 0.25], [2.5]])
    sql = "SELECT SUMPRECISION(x) FROM p"
    assert_same_response(_port(dirs, 0).execute(sql),
                         _ref(dirs).execute(sql))
    dirs = _special_dirs(tmp_path / "b", [[1e300, 0.5]])
    msg = _port(dirs).execute(sql)["exceptions"][0]["message"]
    assert "past 2^248" in msg and "queue 3" in msg


# ---------------------------------------------------------------------------
# the star-tree's fractional decimal states
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cube_dirs(tmp_path_factory):
    rng = np.random.default_rng(19)
    base = tmp_path_factory.mktemp("torch_sumprec_cube")
    cfg = TableConfig(table_name="p", indexing=IndexingConfig(
        no_dictionary_columns=["x", "f", "i"],
        star_tree_configs=[StarTreeIndexConfig(
            dimensions_split_order=["g"],
            function_column_pairs=["COUNT__*", "SUMPRECISION__x",
                                   "SUMPRECISION__i"])]))
    return _write(base, [_segment(rng, 3000, ("a", "b", "c")),
                         _segment(rng, 2500, ("a",))], cfg)


@pytest.mark.parametrize("sql", [
    "SELECT g, SUMPRECISION(x) FROM p GROUP BY g ORDER BY g",
    "SELECT SUMPRECISION(x), SUMPRECISION(i) FROM p",
    "SELECT g, SUMPRECISION(x) FROM p WHERE g IN ('a', 'd') GROUP BY g "
    "ORDER BY g",
], ids=["by_g", "scalar", "filtered"])
def test_cube_decimal_states(cube_dirs, sql):
    want = _ref(cube_dirs).execute(sql)
    for gate in (0, None):
        got = _port(cube_dirs, gate).execute(sql)
        assert_same_response(got, want)
        assert got["numDocsScanned"] < 5500   # the cube's rows
        scan = _port(cube_dirs, gate).execute(
            "SET useStarTree = false; " + sql)
        assert scan["resultTable"] == want["resultTable"]


# ---------------------------------------------------------------------------
# test_agg_extended.py's and test_startree.py's SUMPRECISION shapes over
# DOUBLE columns
# ---------------------------------------------------------------------------


def test_agg_extended_shape_over_doubles(agg_extended_port):  # noqa: F811
    """test_sumprecision_exact's query over the fixture's DOUBLE columns
    (three decimals): the port's strings are the reference's, and the
    exact sums of the values' reprs."""
    eng, cols = agg_extended_port
    assert isinstance(eng, _PortEngine)
    for col in ("lon", "lat"):
        got = test_agg_extended.rows(
            eng, f"SELECT g, SUMPRECISION({col}) FROM t GROUP BY g "
                 f"ORDER BY g")
        for g, s in got:
            vals = cols[col][cols["g"] == g]
            want = sum((decimal.Decimal(repr(float(v))) if not
                        float(v).is_integer() else int(v)) for v in vals)
            assert s == str(want), (col, g)


@pytest.fixture(scope="module")
def startree_double_dirs(tmp_path_factory):
    """test_startree.py's table with revenue in cents as a DOUBLE and its
    SUMPRECISION pair."""
    rng = np.random.default_rng(31)
    n = 20_000
    cols = {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "d_region": np.array(["AMERICA", "ASIA", "EUROPE", "AFRICA"])[
            rng.integers(0, 4, n)],
        "revenue": rng.integers(100, 100_000, n) / 100.0,
    }
    schema = Schema.build(name="ssb", dimensions=[
        ("d_year", DataType.INT), ("d_region", DataType.STRING)],
        metrics=[("revenue", DataType.DOUBLE)])
    cfg = TableConfig(table_name="ssb", indexing=IndexingConfig(
        star_tree_configs=[StarTreeIndexConfig(
            dimensions_split_order=["d_year", "d_region"],
            function_column_pairs=["COUNT__*", "SUMPRECISION__revenue"])]))
    base = tmp_path_factory.mktemp("torch_sumprec_st")
    dirs = []
    for i, sl in enumerate([slice(0, n // 2), slice(n // 2, n)]):
        out = str(base / f"st{i}")
        build_segment(schema, {k: v[sl] for k, v in cols.items()}, out, cfg,
                      f"s{i}")
        dirs.append(out)
    return dirs


def test_startree_pair_shape_over_doubles(startree_double_dirs):
    """test_sumprecision_pair_exact's query over DOUBLE revenue: the cube
    answers as the scan does, and as the reference does."""
    assert test_startree.test_sumprecision_pair_exact is not None
    sql = ("SELECT d_region, SUMPRECISION(revenue) FROM ssb "
           "GROUP BY d_region ORDER BY d_region")
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    port = QueryEngine(device="cpu")
    for d in startree_double_dirs:
        ref.add_segment("ssb", RefSegment(d))
        port.add_segment("ssb", ImmutableSegment(d))
    want = ref.execute(sql)
    got = port.execute(sql)
    assert_same_response(got, want)
    assert got["numDocsScanned"] < 20_000 / 3
    scan = port.execute("SET useStarTree = false; " + sql)
    assert scan["resultTable"] == got["resultTable"]
