"""String literals as function parameters over raw columns, on the port
against the JAX package: TIMECONVERT, DATETIMECONVERT (epoch to epoch and
to SIMPLE_DATE_FORMAT), ROUND with a scale and CAST to STRING.

Three segments hold a raw LONG dimension of epoch millis with Long.MIN,
negatives and zero among its values, a raw INT and a raw DOUBLE metric
(-0.0 and NaN among the doubles), and a LONG column the first segment
predates (schema-evolved: Long.MIN in every one of its docs). The port
folds the literals into int64 torch ops with the reference's arithmetic
(Java's truncating division as numpy computes it: Long.MIN ms is
106751991168 DAYS) and formats a string result on the host once per
distinct value. Rows, order, the dataSchema and every stat must be
equal, floats per ``_rows_close`` (rtol 1e-5).

Also replayed through the port: tests/test_transform_extended.py's
TIMECONVERT and DATETIMECONVERT tests, and tests/test_query_generator.py's
three seeds against its sqlite oracle (360 queries).
"""

import contextlib
import sqlite3  # noqa: F401 — the generator's oracle
from unittest import mock

import numpy as np
import pytest

import test_query_generator
import test_transform_extended
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common.datatypes import DataType as PortDataType
from pinot_tpu_torch.common.schema import Schema as PortSchema
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops.transform import format_millis
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response

SIZES = (1800, 2300, 2000)
LONG_MIN = -(1 << 63)
DAY = 86_400_000


def _schema(cls, D, evolved: bool):
    dims = [("k", D.STRING), ("ts", D.LONG)]
    if evolved:
        dims.append(("late_ts", D.LONG))
    return cls.build(name="t", dimensions=dims,
                     metrics=[("q", D.INT), ("price", D.DOUBLE)])


def _columns(n: int, rng, evolved: bool) -> dict:
    ts = rng.integers(-40 * DAY, 20_000 * DAY, n).astype(np.int64)
    ts[:6] = [LONG_MIN, -1, 0, 1, -DAY - 1, LONG_MIN + 1]
    price = np.round(rng.uniform(-50, 50, n), 3)
    price[:4] = [-0.0, 0.0, np.nan, 1.005]
    cols = {"k": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "ts": ts, "q": rng.integers(-30, 60, n).astype(np.int32),
            "price": price}
    if evolved:
        cols["late_ts"] = rng.integers(0, 400 * DAY, n).astype(np.int64)
    return cols


_TC = "TIMECONVERT({}, 'MILLISECONDS', '{}')"
_DTC = ("DATETIMECONVERT({}, '1:MILLISECONDS:EPOCH', '{}', '{}')")
_SDF = "1:DAYS:SIMPLE_DATE_FORMAT:yyyy-MM-dd"


def _group(expr: str, agg: str = "COUNT(*)", order: str = "", limit=20):
    return (f"SELECT {expr}, {agg} FROM t GROUP BY {expr} "
            f"ORDER BY {order or expr} LIMIT {limit}")


SQL = {
    "tc_days": _group(_TC.format("ts", "DAYS"),
                      order=f"COUNT(*) DESC, {_TC.format('ts', 'DAYS')}"),
    "tc_hours_expr": _group(_TC.format("ts + 3600000", "HOURS")),
    "tc_evolved": _group(_TC.format("late_ts", "DAYS"), "SUM(q)"),
    "tc_seconds_in": ("SELECT MAX(TIMECONVERT(q, 'SECONDS', 'MINUTES')), "
                      "MIN(TIMECONVERT(ts, 'MILLISECONDS', 'SECONDS')) "
                      "FROM t"),
    "tc_micros": _group("TIMECONVERT(q, 'MICROSECONDS', 'MILLISECONDS')"),
    "tc_filter": (f"SELECT COUNT(*) FROM t WHERE {_TC.format('ts', 'DAYS')} "
                  f"BETWEEN 10 AND 400"),
    "dtc_epoch": _group(_DTC.format("ts", "1:HOURS:EPOCH", "1:DAYS")),
    "dtc_sized": _group(_DTC.format("ts", "5:MINUTES:EPOCH", "5:MINUTES"),
                        "MAX(q)"),
    "dtc_sdf": _group(_DTC.format("ts", _SDF, "1:DAYS"), "SUM(price)"),
    "dtc_sdf_evolved": _group(_DTC.format("late_ts", _SDF, "1:DAYS")),
    "dtc_sdf_time": _group(_DTC.format(
        "ts", "1:SECONDS:SIMPLE_DATE_FORMAT:yyyy-MM-dd HH:mm:ss",
        "1:HOURS")),
    "dtc_sdf_sss": ("SELECT " + _DTC.format(
        "q * 86400123", "1:MILLISECONDS:SIMPLE_DATE_FORMAT:yyyyMMdd "
        "HH:mm:ss.SSS", "1:MILLISECONDS") + ", k FROM t "
        "ORDER BY q, k LIMIT 7"),
    "dtc_sdf_filter": ("SELECT COUNT(*) FROM t WHERE " + _DTC.format(
        "ts", _SDF, "1:DAYS") + " = '1970-01-01'"),
    "round_double": _group("ROUND(price, 1)", order="ROUND(price, 1)",
                           limit=30),
    "round_int": ("SELECT ROUND(q, -1), ROUND(q, 2), ROUND(price, -1), q, "
                  "price FROM t ORDER BY q, price LIMIT 25"),
    "cast_int": _group("CAST(q AS STRING)", "SUM(price)"),
    "cast_double": _group("CAST(price AS STRING)", limit=12),
    "cast_long_order": ("SELECT CAST(ts AS STRING), k FROM t "
                        "ORDER BY CAST(ts AS STRING) DESC, k LIMIT 9"),
    "string_literal": "SELECT 'x', k FROM t ORDER BY ts LIMIT 3",
}


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_time")
    rng = np.random.default_rng(41)
    dirs = []
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        no_dictionary_columns=["ts", "late_ts"]))
    for i, n in enumerate(SIZES):
        evolved = i > 0
        out = str(base / f"s{i}")
        build_segment(_schema(Schema, DataType, evolved),
                      _columns(n, rng, evolved), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


def _ref(dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in dirs:
        seg = RefSegment(d)
        seg.table_schema = _schema(Schema, DataType, True)
        eng.add_segment("t", seg)
    return eng


def _port(dirs, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        seg = ImmutableSegment(d)
        seg.table_schema = _schema(PortSchema, PortDataType, True)
        eng.add_segment("t", seg)
    return eng


@pytest.fixture(scope="module")
def ref_responses(segment_dirs):
    eng = _ref(segment_dirs)
    return {k: eng.execute(sql) for k, sql in SQL.items()}


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    return _port(segment_dirs, request.param)


def test_columns_are_raw(segment_dirs):
    seg = ImmutableSegment(segment_dirs[-1])
    for name in ("ts", "late_ts", "q", "price"):
        assert seg.column_metadata(name).encoding == "RAW", name


@pytest.mark.parametrize("name", sorted(SQL))
def test_literal_functions_match_reference(port_engine, ref_responses, name):
    got = port_engine.execute(SQL[name])
    assert_same_response(got, ref_responses[name])
    assert got["resultTable"]["rows"], name


def test_long_min_through_timeconvert(port_engine):
    """Long.MIN ms, in every doc of the segment that predates late_ts:
    ``sign(v) * (|v| // d)`` with |Long.MIN| wrapping, as numpy computes
    it; a truncating division would give -106751991167."""
    rows = port_engine.execute(
        _group(_TC.format("late_ts", "DAYS"), order="COUNT(*) DESC"))
    assert rows["resultTable"]["rows"][0] == [106751991168, SIZES[0]]
    sdf = port_engine.execute(_group(_DTC.format("late_ts", _SDF, "1:DAYS"),
                                     order="COUNT(*) DESC"))
    assert sdf["resultTable"]["rows"][0] == ["-292275055-05-17", SIZES[0]]


def test_predicate_over_cast_strings(segment_dirs):
    """A predicate over CAST(... AS STRING): the reference's device takes
    the filter and fails on the strings (a JAX array of str), so the
    port is held to the reference's host path, which answers it."""
    sql = ("SELECT COUNT(*) FROM t WHERE CAST(q AS STRING) "
           "IN ('7', '-3', '10')")
    host = RefEngine(device_executor=None)
    for d in segment_dirs:
        seg = RefSegment(d)
        seg.table_schema = _schema(Schema, DataType, True)
        host.add_segment("t", seg)
    assert _ref(segment_dirs).execute(sql)["exceptions"]
    assert_same_response(_port(segment_dirs).execute(sql), host.execute(sql))


def test_nat_millis_under_sss_errors_in_both(segment_dirs):
    """Long.MIN at 1 ms granularity buckets to NaT, which pandas formats
    as NaN; the SSS splice then fails in the reference, and in the port
    with the same error."""
    sql = ("SELECT " + _DTC.format(
        "late_ts", "1:MILLISECONDS:SIMPLE_DATE_FORMAT:yyyyMMdd HH:mm:ss.SSS",
        "1:MILLISECONDS") + " FROM t LIMIT 3")
    want = _ref(segment_dirs).execute(sql)["exceptions"]
    got = _port(segment_dirs).execute(sql)["exceptions"]
    assert want and got and got[0]["message"] == want[0]["message"]


def test_string_literal_against_numbers_is_refused_in_band(segment_dirs):
    """numpy has no comparison of numbers with a string: the reference's
    host fails, and the port refuses in-band, saying so."""
    sql = "SELECT q = '3' FROM t LIMIT 2"
    want = _ref(segment_dirs).execute(sql)
    got = _port(segment_dirs).execute(sql)
    assert want["exceptions"], want
    assert "host path fails on it too" in got["exceptions"][0]["message"]


_RNG = np.random.default_rng(3)
_ANY = np.concatenate([
    _RNG.integers(LONG_MIN + 1, (1 << 63) - 1, 3000),
    _RNG.integers(-10 ** 13, 10 ** 13, 1000),
    np.array([0, -1, 1, -DAY, LONG_MIN + 1, (1 << 63) - 1,
              -9223372036794351616])]).astype(np.int64)
_IN_RANGE = _RNG.integers(-62135596800000, 253402300799999,
                          2000).astype(np.int64)


@pytest.mark.parametrize("fmt,values", [
    ("%Y-%m-%d", _ANY), ("%Y-%m-%d %H:%M:%S", _ANY),
    ("%Y%m%d", _IN_RANGE), ("%d/%m/%Y %I %p", _IN_RANGE),
    ("%a %H:%M:%S", _IN_RANGE), ("%y-%m-%d %H", _IN_RANGE)],
    ids=["iso_day", "iso_second", "compact", "ampm", "weekday", "short"])
def test_format_millis_is_pandas(fmt, values):
    """The port formats without pandas (the card's machine has none); the
    JAX package's ``from_millis`` calls pandas: the same strings."""
    import pandas as pd

    want = np.asarray(pd.to_datetime(values, unit="ms").strftime(fmt),
                      dtype=np.str_)
    np.testing.assert_array_equal(format_millis(values, fmt), want)


def test_format_millis_nat_and_range():
    import pandas as pd

    nat = np.array([LONG_MIN, 5], dtype=np.int64)
    np.testing.assert_array_equal(
        format_millis(nat, "%Y-%m-%d"),
        np.asarray(pd.to_datetime(nat, unit="ms").strftime("%Y-%m-%d"),
                   dtype=np.str_))
    with pytest.raises(NotImplementedError):
        format_millis(np.array([LONG_MIN + 1]), "%Y%m%d")


# ---------------------------------------------------------------------------
# tests/test_transform_extended.py's time tests through the port
# ---------------------------------------------------------------------------

def _unwrap(fixture):
    make = getattr(fixture, "_get_wrapped_function", None)
    return make() if make is not None else fixture.__wrapped__


def _port_engine():
    eng = QueryEngine(device="cpu")
    eng.device.min_rows = 0
    return eng


@pytest.fixture(scope="module")
def tx_setup(tmp_path_factory):
    """test_transform_extended's ``data`` and ``eng`` fixtures, the engine
    and segment classes swapped for the port's."""
    mod = test_transform_extended
    data = _unwrap(mod.data)()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(mod, "QueryEngine",
                                              _port_engine))
        stack.enter_context(mock.patch.object(mod, "ImmutableSegment",
                                              ImmutableSegment))
        eng = _unwrap(mod.eng)(tmp_path_factory, data)
    return eng, data


def _replayed(classes) -> list:
    import inspect

    out = []
    for cname in classes:
        cls = getattr(test_transform_extended, cname)
        out += [f"{cname}::{m}" for m, _f in inspect.getmembers(
            cls, inspect.isfunction) if m.startswith("test_")]
    return sorted(out)


TIME_TESTS = _replayed(("TestTimeConvert", "TestDateTimeConvert"))


@pytest.mark.parametrize("name", TIME_TESTS)
def test_transform_extended_time_through_the_port(tx_setup, name):
    eng, data = tx_setup
    assert isinstance(eng, QueryEngine)
    cname, mname = name.split("::")
    getattr(getattr(test_transform_extended, cname)(), mname)(eng, data)


def test_time_replay_covers_both_classes():
    assert len(TIME_TESTS) == 7


# ---------------------------------------------------------------------------
# tests/test_query_generator.py's seeds through the port
# ---------------------------------------------------------------------------

class _Shim:
    """The generator fixture's engine: segments the reference's creator
    wrote, loaded by the port."""

    def __init__(self, device_executor=None):
        self.eng = _port_engine()

    def add_segment(self, table, seg):
        self.eng.add_segment(table, ImmutableSegment(seg.dir))

    def execute(self, sql):
        return self.eng.execute(sql)


@pytest.fixture(scope="module")
def qgen_setup(tmp_path_factory):
    mod = test_query_generator
    with mock.patch.object(mod, "QueryEngine", _Shim):
        return _unwrap(mod.setup)(tmp_path_factory)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_query_generator_through_the_port(qgen_setup, seed):
    """All 120 queries of each seed against sqlite, time rollups over the
    raw ``clicks`` column included."""
    engine, _con, _cols = qgen_setup
    assert isinstance(engine, _Shim)
    test_query_generator.test_random_queries_match_oracle(qgen_setup, seed)
