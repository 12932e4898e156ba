"""The function and aggregation tail on the port against the JAX package:
ATAN2 and ROUNDDECIMAL / TRUNCATE as keys and values, GEOTOH3 in both
signatures, ST_POINT over two numeric columns with ST_CONTAINS /
ST_WITHIN / ST_EQUALS / ST_DISTANCE / ST_GEOMETRYTYPE over it, INIDSET
over a real IDSET result, STUNION, a CASE of string and numeric results,
LIKE and REGEXP_LIKE over numbers, the sketches over expressions, and
FIRST/LASTWITHTIME over STRING times, virtual columns and expressions.

Three segments hold taxi-shaped columns: a string key, raw DOUBLE fares
in cents with .5 ties beside them, raw DOUBLE longitudes and latitudes
with six decimals (and points on a polygon's edges and a grid cell's
edge that float32 would move), a raw INT, a dict INT passenger count,
a day as 'yyyyMMdd' and as 'yyyy-MM-dd' strings, and WKT points. The
same SQL runs through ``pinot_tpu``'s ``QueryEngine`` (device in
interpret mode) and the port's (``device="cpu"``, at kernel gate 0 and
at the default gate): rows, dataSchema and every stat must be equal,
floats within ``_rows_close`` (rtol 1e-5, atol 1e-6).

Also replayed through the port: tests/test_geo.py's TestGeoQueries,
tests/test_transform_tail.py's engine tests and
tests/test_agg_extended.py's ``test_st_union_multipoint``.
"""

import pathlib
import re

import numpy as np
import pytest

import test_agg_extended
import test_geo
import test_transform_tail
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import geo as port_geo
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response
from test_torch_sketches import _PortEngine, agg_extended_port  # noqa: F401

SIZES = (1500, 2200, 1800)
POLY = ("POLYGON ((-74.0 40.6, -73.9 40.6, -73.9 40.8, -74.0 40.8, "
        "-74.0 40.6))")
# res 7 cells are 360 / 128 = 2.8125 degrees: 14 cells is 39.375, and
# 39.3749999999 is float32's 39.375
CELL_EDGE = 39.3749999999


def _schema():
    D = DataType
    return Schema.build(
        name="t",
        dimensions=[("k", D.STRING), ("day", D.STRING), ("dash", D.STRING),
                    ("wkt", D.STRING), ("pc", D.INT), ("ts", D.LONG)],
        metrics=[("fare", D.DOUBLE), ("r", D.DOUBLE), ("lon", D.DOUBLE),
                 ("lat", D.DOUBLE), ("n", D.INT)])


def _columns(n: int, rng, seg: int) -> dict:
    lon = np.round(rng.uniform(-74.05, -73.75, n), 6)
    lat = np.round(rng.uniform(40.55, 40.9, n), 6)
    # the polygon's vertices and edges, just inside and outside of them
    # (float32 moves -73.9000001 onto the edge), a cell edge, NaN, inf
    edge = [(-74.0, 40.7), (-73.9, 40.7), (-73.95, 40.6), (-73.95, 40.8),
            (-74.0, 40.6), (-73.9000001, 40.7), (-73.8999999, 40.7),
            (-73.95, 40.6000001), (-73.95, CELL_EDGE), (np.nan, 40.7),
            (-73.95, np.inf)]
    for j, (x, y) in enumerate(edge):
        lon[j], lat[j] = x, y
    r = np.round(rng.uniform(-5, 5, n), 3)
    r[:9] = [0.5, 1.5, 2.5, -0.5, -2.5, 0.125, 1.005, -1.5, 3.5]
    days = rng.integers(1, 20, n)
    return {
        "k": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "day": np.array([f"202001{d:02d}" for d in days]),
        "dash": np.array([f"2020-01-{d:02d}" for d in days]),
        "wkt": np.array([f"POINT ({-74 + d / 10} {40.5 + d / 20})"
                         for d in rng.integers(0, 9, n)]),
        "pc": rng.integers(1, 7, n).astype(np.int32),
        "ts": (seg * 10_000 + rng.integers(0, 50, n)).astype(np.int64),
        "fare": rng.integers(250, 9000, n) / 100.0,
        "r": r, "lon": lon, "lat": lat,
        "n": rng.integers(0, 40, n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_tail")
    rng = np.random.default_rng(12)
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        no_dictionary_columns=["fare", "r", "lon", "lat", "n", "ts"]))
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(_schema(), _columns(n, rng, i), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


def _ref(dirs, device=True):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret")
                    if device else None)
    for d in dirs:
        eng.add_segment("t", RefSegment(d))
    return eng


def _port(dirs, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        eng.add_segment("t", ImmutableSegment(d))
    return eng


def _group(expr: str, agg: str = "COUNT(*)", where: str = "",
           order: str = "", limit: int = 30) -> str:
    return (f"SELECT {expr}, {agg} FROM t {where} GROUP BY {expr} "
            f"ORDER BY {order or expr} LIMIT {limit}")


_CONTAINS = f"ST_CONTAINS(ST_GEOGFROMTEXT('{POLY}'), ST_POINT(lon, lat))"
_WITHIN = f"ST_WITHIN(ST_POINT(lon, lat), ST_GEOGFROMTEXT('{POLY}'))"
_CASE = "CASE WHEN n > 20 THEN 'big' ELSE n END"
SQL = {
    # ATAN2 and ROUNDDECIMAL / TRUNCATE
    "atan2_key": _group("ATAN2(lat, lon)", limit=5),
    "atan2_sum_filter": ("SELECT SUM(ATAN2(lat, lon)) FROM t WHERE "
                         "ATAN2(n, 2) > 1"),
    "round_fare_key": _group("ROUNDDECIMAL(fare, 0)"),
    "round_ties": ("SELECT r, ROUNDDECIMAL(r), ROUNDDECIMAL(r, 2), "
                   "ROUNDDECIMAL(r, 0), TRUNCATE(r, 1), TRUNCATE(r) FROM t "
                   "ORDER BY ts, r LIMIT 40"),
    "round_key_sum": _group("ROUNDDECIMAL(r, 1)", "SUM(fare)", limit=12),
    # GEOTOH3 in both signatures, and over WKT strings
    "geo_cell_5": _group("GEOTOH3(lon, lat, 5)", "COUNT(*), SUM(fare)"),
    "geo_cell_7": _group("GEOTOH3(lon, lat, 7)", order="COUNT(*) DESC, "
                         "GEOTOH3(lon, lat, 7)"),
    "geo_cell_point": _group("GEOTOH3(ST_POINT(lon, lat), 7)"),
    "geo_cell_wkt": _group("GEOTOH3(wkt, 9)"),
    "geo_cell_select": ("SELECT lon, lat, GEOTOH3(lon, lat, 7), "
                        "GEOTOH3(ST_POINT(lon, lat), 12) FROM t "
                        "ORDER BY ts, lon LIMIT 15"),
    # ST_POINT over numbers and the predicates over it
    "contains_count": f"SELECT COUNT(*) FROM t WHERE {_CONTAINS} = 1",
    "contains_by_k": _group("k", "COUNT(*), SUM(fare)",
                            where=f"WHERE {_CONTAINS} = 1"),
    "within_count": f"SELECT COUNT(*) FROM t WHERE {_WITHIN}",
    "contains_key": _group(_CONTAINS),
    "contains_wkt": (f"SELECT COUNT(*) FROM t WHERE ST_CONTAINS("
                     f"ST_GEOGFROMTEXT('{POLY}'), wkt) = 1"),
    "geometry_type": _group("ST_GEOMETRYTYPE(ST_POINT(lon, lat))"),
    "geometry_type_wkt": _group("ST_GEOMETRYTYPE(wkt)"),
    "point_select": ("SELECT ST_POINT(lon, lat), k FROM t ORDER BY ts, lon "
                     "LIMIT 12"),
    "point_key": _group("ST_POINT(lon, lat)", where="WHERE n = 7",
                        limit=8),
    "point_equals": ("SELECT COUNT(*) FROM t WHERE ST_EQUALS(ST_POINT(lon, "
                     "lat), ST_POINT(lon, lat))"),
    "point_equals_literal": ("SELECT COUNT(*) FROM t WHERE ST_EQUALS("
                             "ST_POINT(lon, lat), "
                             "ST_GEOGFROMTEXT('POINT (-73.9 40.7)'))"),
    "distance_count": ("SELECT COUNT(*) FROM t WHERE ST_DISTANCE(ST_POINT("
                       "lon, lat), ST_GEOGFROMTEXT('POINT (-73.95 40.75)')) "
                       "< 5000"),
    "distance_sum": ("SELECT k, SUM(ST_DISTANCE(ST_POINT(lon, lat), "
                     "ST_GEOGFROMTEXT('POINT (-73.95 40.75)'))) FROM t "
                     "GROUP BY k ORDER BY k"),
    "astext_point": ("SELECT ST_ASTEXT(ST_POINT(lon, lat)) FROM t "
                     "ORDER BY ts, lon LIMIT 5"),
    # STUNION
    "stunion": ("SELECT STUNION(ST_POINT(lon, lat)) FROM t WHERE n = 3 AND "
                "fare < 20"),
    "stunion_by_k": ("SELECT k, STUNION(ST_POINT(lon, lat)) FROM t WHERE "
                     "n = 5 AND fare < 15 GROUP BY k ORDER BY k"),
    "stunion_wkt": "SELECT STUNION(wkt) FROM t WHERE n < 3",
    # the sketches over an expression
    "hll_expr": _group("k", "DISTINCTCOUNTHLL(n * 10 + 1)"),
    "hll_expr_scalar": "SELECT DISTINCTCOUNTHLL(fare * 2) FROM t",
    "hll_string_expr": _group("pc", "DISTINCTCOUNTHLL(UPPER(k))"),
    "hll_case_expr": f"SELECT DISTINCTCOUNTHLL({_CASE}) FROM t",
    "rawhll_expr": "SELECT DISTINCTCOUNTRAWHLL(n + 1) FROM t",
    "theta_expr": _group("k", "DISTINCTCOUNTTHETASKETCH(n - 3)"),
    "smarthll_string": "SELECT DISTINCTCOUNTSMARTHLL(UPPER(k)) FROM t",
    "idset_string": "SELECT IDSET(UPPER(k)) FROM t",
    "distinct_point": ("SELECT DISTINCTCOUNT(ST_POINT(lon, lat)) FROM t "
                       "WHERE n < 5"),
    # CASE of string and numeric results
    "case_mixed_key": _group(_CASE, limit=50),
    "case_mixed_select": f"SELECT {_CASE}, n FROM t ORDER BY ts, n LIMIT 9",
    "case_mixed_float": _group("CASE WHEN pc > 4 THEN 'group' ELSE fare / 4 "
                               "END", limit=6),
    # LIKE / REGEXP_LIKE over numbers
    "like_int": "SELECT COUNT(*) FROM t WHERE n LIKE '3%'",
    "like_dict_int": "SELECT COUNT(*) FROM t WHERE pc LIKE '1%'",
    "like_float": "SELECT COUNT(*), SUM(n) FROM t WHERE fare LIKE '1_.5%'",
    "regexp_int": _group("k", "COUNT(*)", where="WHERE REGEXP_LIKE(n, '^3')"),
    "like_expr": "SELECT COUNT(*) FROM t WHERE n * 2 LIKE '%4'",
    # FIRST/LASTWITHTIME over STRING times, virtual values, expressions
    "last_day": _group("k", "LASTWITHTIME(fare, day, 'DOUBLE')"),
    "first_day_scalar": "SELECT FIRSTWITHTIME(n, day, 'INT') FROM t",
    "last_segment_name": _group("k", "LASTWITHTIME($segmentName, n, "
                                "'STRING')"),
    "first_expr_value": _group("pc", "FIRSTWITHTIME(UPPER(k), ts, "
                               "'STRING')"),
    "last_expr_time": _group("k", "LASTWITHTIME(fare, ts * 2 - n, "
                             "'DOUBLE')"),
    "last_point": _group("k", "LASTWITHTIME(ST_POINT(lon, lat), ts, "
                         "'STRING')"),
    # any other function: numpy per distinct value
    "arraysum_sv": "SELECT ARRAYSUM(n), ARRAYMAX(fare) FROM t ORDER BY ts, n "
                   "LIMIT 6",
    "upper_concat_key": _group("CONCAT(UPPER(k), day, '-')", limit=6),
    "dtc_sdf_strings": _group("DATETIMECONVERT(dash, "
                              "'1:DAYS:SIMPLE_DATE_FORMAT:yyyy-MM-dd', "
                              "'1:DAYS:EPOCH', '1:DAYS')", limit=5),
}


@pytest.fixture(scope="module")
def ref_responses(segment_dirs):
    eng = _ref(segment_dirs)
    return {k: eng.execute(sql) for k, sql in SQL.items()}


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "gate"])
def port_engine(request, segment_dirs):
    return _port(segment_dirs, request.param)


def test_columns_are_raw(segment_dirs):
    seg = ImmutableSegment(segment_dirs[0])
    for name in ("fare", "r", "lon", "lat", "n", "ts"):
        assert seg.column_metadata(name).encoding == "RAW", name
    assert seg.column_metadata("pc").encoding == "DICT"


def _ungzip_idsets(resp: dict) -> dict:
    """An IDSET result with its gzip header's time stamp left out (gzip
    stamps the second it compressed in)."""
    import base64
    import gzip

    rows = resp.get("resultTable", {}).get("rows", [])
    for row in rows:
        for j, x in enumerate(row):
            if isinstance(x, str) and x.startswith("H4sI"):
                row[j] = gzip.decompress(base64.b64decode(x)).decode()
    return resp


@pytest.mark.parametrize("name", sorted(SQL))
def test_tail_matches_reference(port_engine, ref_responses, name):
    want = ref_responses[name]
    got = port_engine.execute(SQL[name])
    assert_same_response(_ungzip_idsets(got), _ungzip_idsets(want))
    assert got["resultTable"]["rows"], name


def test_cell_edge_is_float64(port_engine):
    """39.3749999999 stays below the res-7 cell edge 39.375 in float64,
    where float32 would round it onto the edge and into the next cell."""
    sql = ("SELECT GEOTOH3(lon, lat, 7) FROM t WHERE lat < 39.4 "
           "AND lat > 39.3")
    (cell,) = {r[0] for r in port_engine.execute(sql)["resultTable"]["rows"]}
    assert (cell >> 27) & 0x3FFFFFF == 13
    f32 = int(port_geo.grid_cell(np.float32(-73.95), np.float32(CELL_EDGE),
                                 7)[0])
    assert (f32 >> 27) & 0x3FFFFFF == 14


def test_polygon_edge_is_float64(port_engine):
    """-73.8999999 lies just outside the polygon's right edge at -73.9;
    float32 rounds it to -73.9000015, inside. -73.9000001 is inside and
    the edge itself, -73.9, outside (the even-odd test's strict <)."""
    sql = (f"SELECT lon FROM t WHERE {_CONTAINS} = 1 AND lat = 40.7 "
           f"ORDER BY lon")
    lons = [r[0] for r in port_engine.execute(sql)["resultTable"]["rows"]]
    assert -73.9000001 in lons
    assert -73.8999999 not in lons and -73.9 not in lons
    ring = port_geo.parse_polygon(POLY)
    assert port_geo._points_in_ring(
        ring, np.array([np.float32(-73.8999999)], dtype=np.float64),
        np.array([40.7]))[0]


def test_round_decimal_is_half_up(port_engine):
    """BigDecimal HALF_UP: 2.5 -> 3 and -2.5 -> -3 (torch rounds half to
    even), 0.125 at 2 -> 0.13."""
    rows = port_engine.execute(
        "SELECT r, ROUNDDECIMAL(r, 0), ROUNDDECIMAL(r, 2), ROUNDDECIMAL(r) "
        "FROM t WHERE r IN (2.5, -2.5, 0.5, 0.125) ORDER BY r LIMIT 40"
    )["resultTable"]["rows"]
    got = {r[0]: tuple(r[1:]) for r in rows}
    assert got[2.5] == (3.0, 2.5, 3.0)
    assert got[-2.5] == (-3.0, -2.5, -2.0)   # Math.round: floor(x + 0.5)
    assert got[0.5] == (1.0, 0.5, 1.0)
    assert got[0.125] == (0.0, 0.13, 0.0)


def test_sig10_is_the_text_value():
    """``sig10_torch`` is float(f"{x:.10g}"), near ties and past the
    exact powers included (those take the host)."""
    import torch

    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.normal(0, 1e3, 3000), np.round(rng.uniform(-180, 180, 3000), 6),
        rng.uniform(-1, 1, 500) * 10.0 ** rng.integers(-40, 40, 500),
        [0.0, -0.0, 1e-300, 5e-324, 1.23456789045, 0.1 + 0.2, 123456789012345.6,
         -9.99999999995, np.nan, np.inf, -np.inf]])
    got = port_geo.sig10_torch(torch.from_numpy(x)).numpy()
    want = np.asarray([float(f"{v:.10g}") for v in x])
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:5]
    assert np.signbit(got[np.where(x == 0)[0][1]])


def test_last_with_time_over_dates_fails_like_the_reference(segment_dirs):
    """'yyyy-MM-dd' times do not parse as numbers: the reference's host
    raises, and the port refuses in-band quoting the same error."""
    sql = _group("k", "LASTWITHTIME(fare, dash, 'DOUBLE')")
    want = _ref(segment_dirs).execute(sql)["exceptions"]
    assert want and "invalid literal for int()" in want[0]["message"]
    msg = _port(segment_dirs).execute(sql)["exceptions"][0]["message"]
    assert "the reference's host path fails on it too" in msg
    assert "invalid literal for int() with base 10: np.str_('2020-01-" in msg


def test_unparsed_times_outside_the_filter_answer(segment_dirs):
    """Only the rows the aggregation takes are read as times: a filter
    that keeps no row with a bad time answers in both."""
    sql = ("SELECT k, LASTWITHTIME(fare, CASE WHEN n < 5 THEN 'x' ELSE day "
           "END, 'DOUBLE') FROM t WHERE n >= 5 GROUP BY k ORDER BY k")
    assert_same_response(_port(segment_dirs, 0).execute(sql),
                         _ref(segment_dirs).execute(sql))


def test_inidset_over_a_real_idset(segment_dirs):
    """INIDSET over the reference's own IDSET result, numbers and
    strings, as a filter, a key and a selected value."""
    ref = _ref(segment_dirs)
    port = _port(segment_dirs, 0)
    nums = ref.execute("SELECT IDSET(n) FROM t WHERE n < 10")[
        "resultTable"]["rows"][0][0]
    strs = ref.execute("SELECT IDSET(k) FROM t WHERE k <> 'b'")[
        "resultTable"]["rows"][0][0]
    for sql in (
            f"SELECT COUNT(*) FROM t WHERE INIDSET(n, '{nums}') = true",
            f"SELECT COUNT(*), SUM(fare) FROM t WHERE INIDSET(k, '{strs}')",
            _group(f"INIDSET(n, '{nums}')"),
            f"SELECT n, INIDSET(n, '{nums}') FROM t ORDER BY ts, n LIMIT 9",
            f"SELECT COUNT(*) FROM t WHERE INIDSET(fare, '{nums}')"):
        assert_same_response(port.execute(sql), ref.execute(sql))


def test_malformed_idset_is_refused(segment_dirs):
    sql = "SELECT COUNT(*) FROM t WHERE INIDSET(n, 'not-a-set') = true"
    assert _ref(segment_dirs).execute(sql)["exceptions"]
    msg = _port(segment_dirs).execute(sql)["exceptions"][0]["message"]
    assert "the reference's host path fails on it too" in msg


def test_string_literal_predicates_over_numbers(segment_dirs):
    """numpy's EQ / IN of numbers with a string literal match nothing, and
    the host's selection answers so; a RANGE fails in both."""
    ref, port = _ref(segment_dirs), _port(segment_dirs)
    for sql in ("SELECT n FROM t WHERE n = '3' LIMIT 4",
                "SELECT n FROM t WHERE n IN ('3', 4) LIMIT 4",
                "SELECT n FROM t WHERE n <> '3' ORDER BY ts, n LIMIT 4"):
        assert_same_response(port.execute(sql), ref.execute(sql))
    sql = "SELECT n FROM t WHERE n > '3' LIMIT 4"
    assert ref.execute(sql)["exceptions"]
    msg = port.execute(sql)["exceptions"][0]["message"]
    assert "the reference's host path fails on it too" in msg


def test_no_refusal_names_the_done_items():
    """ROADMAP queue 1's e2b, e3e and g2 are done: no message of the port
    names them."""
    import pinot_tpu_torch

    root = pathlib.Path(pinot_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        for item in ("e2b", "e3e", "g2"):
            assert not re.search(rf"item {item}\b", text), (path, item)
        assert "def later(" not in text, path


# ---------------------------------------------------------------------------
# the reference's geo, transform-tail and STUNION tests through the port
# ---------------------------------------------------------------------------


def _unwrap(fixture):
    make = getattr(fixture, "_get_wrapped_function", None)
    return make() if make is not None else fixture.__wrapped__


@pytest.fixture(scope="module")
def geo_port(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(test_geo, "QueryEngine", _PortEngine)
    try:
        yield _unwrap(test_geo.engine)(tmp_path_factory)
    finally:
        mp.undo()


GEO_TESTS = ("test_distance_filter", "test_contains_filter",
             "test_distance_in_select", "test_st_within_and_astext")


@pytest.mark.parametrize("name", GEO_TESTS)
def test_geo_queries_through_the_port(geo_port, name):
    assert isinstance(geo_port, _PortEngine)
    getattr(test_geo.TestGeoQueries(), name)(geo_port)


@pytest.fixture(scope="module")
def tail_port(tmp_path_factory):
    data = _unwrap(test_transform_tail.data)()
    mp = pytest.MonkeyPatch()
    mp.setattr(test_transform_tail, "QueryEngine", _PortEngine)
    try:
        yield _unwrap(test_transform_tail.eng)(tmp_path_factory, data), data
    finally:
        mp.undo()


TAIL_TESTS = ("test_datetime_parts", "test_datetime_aliases",
              "test_atan2_cot", "test_round_decimal_truncate",
              "test_jsonextractkey", "test_inidset_roundtrip",
              "test_geotoh3_grid_cells", "test_st_equals_and_geometry_type")


@pytest.mark.parametrize("name", TAIL_TESTS)
def test_transform_tail_through_the_port(tail_port, name):
    eng, data = tail_port
    assert isinstance(eng, _PortEngine)
    fn = getattr(test_transform_tail, name)
    if name in ("test_datetime_aliases", "test_st_equals_and_geometry_type"):
        fn(eng)
    else:
        fn(eng, data)


def test_st_union_multipoint_through_the_port(agg_extended_port):  # noqa: F811
    eng, _cols = agg_extended_port
    assert isinstance(eng, _PortEngine)
    test_agg_extended.TestExtendedAggs().test_st_union_multipoint(
        agg_extended_port)
