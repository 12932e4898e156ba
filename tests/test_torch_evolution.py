"""Schema-evolved single-value columns on the port against the JAX package.

Two segments are sealed under a v1 schema; a third is written under a v2
table schema that adds a STRING, a LONG, an INT and a DOUBLE dimension
and an INT, a FLOAT and a DOUBLE metric (raw, as metrics are), about a
tenth of each new column's rows null. Every segment carries the v2 schema
(``seg.table_schema``), so the older two read each new column as its
``FieldSpec.null_value()``: 'null', the type's sentinel for a dimension
(Long.MIN for LONG), 0 for a metric. The new segment stores the new
numeric dimensions as dict columns in one fixture and raw in the other; a third
engine holds the old segments alone, where no segment stores them.

The reference runs with its device in interpret mode, as its own tests
do; the port on the CPU at the kernel gate 0 (the kernels' plain
versions) and at the default gate. Rows, order, the dataSchema and every
response stat must be equal, floats per ``_rows_close`` (rtol 1e-5).
"""

import numpy as np
import pytest

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
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response

SIZES = (2400, 1900, 2100)
NEW_DIMS = (("s_str", "STRING"), ("s_long", "LONG"), ("s_int", "INT"),
            ("s_dbl", "DOUBLE"))
NEW_METRICS = (("m_int", "INT"), ("m_float", "FLOAT"), ("m_dbl", "DOUBLE"))
NEW = [n for n, _t in NEW_DIMS + NEW_METRICS]


def _schema(cls, D, evolved: bool):
    dims = [("k", D.STRING), ("grp", D.INT)]
    metrics = [("m", D.INT)]
    if evolved:
        dims += [(n, getattr(D, t)) for n, t in NEW_DIMS]
        metrics += [(n, getattr(D, t)) for n, t in NEW_METRICS]
    return cls.build(name="t", dimensions=dims, metrics=metrics)


def _columns(n: int, rng, evolved: bool) -> dict:
    cols = {
        "k": np.array([f"k{i}" for i in range(9)])[rng.integers(0, 9, n)],
        "grp": rng.integers(0, 20, n).astype(np.int32),
        "m": rng.integers(0, 500, n).astype(np.int32),
    }
    if evolved:
        new = {
            "s_str": np.array(["air", "rail", "ship", "truck"])[
                rng.integers(0, 4, n)],
            "s_long": rng.integers(-3, 40, n).astype(np.int64) * 1000,
            "s_int": rng.integers(0, 12, n).astype(np.int32),
            "s_dbl": np.round(rng.uniform(-2, 2, n), 2),
            "m_int": rng.integers(0, 9, n).astype(np.int32),
            "m_float": np.round(rng.uniform(0, 4, n), 1).astype(np.float32),
            "m_dbl": np.round(rng.uniform(0, 100, n), 3),
        }
        for name, v in new.items():
            vals = v.astype(object)
            vals[rng.random(n) < 0.1] = None
            cols[name] = list(vals)
    return cols


SQL = {
    "group_str_long": ("SELECT s_str, s_long, COUNT(*), SUM(m_int) FROM t "
                       "GROUP BY s_str, s_long ORDER BY s_str, s_long "
                       "LIMIT 50"),
    "group_int": ("SELECT s_int, COUNT(*), MAX(m_dbl) FROM t GROUP BY s_int "
                  "ORDER BY s_int"),
    "group_dbl": ("SELECT s_dbl, COUNT(*) FROM t GROUP BY s_dbl "
                  "ORDER BY COUNT(*) DESC, s_dbl LIMIT 10"),
    "group_float_metric": ("SELECT m_float, COUNT(*) FROM t GROUP BY m_float "
                           "ORDER BY m_float LIMIT 12"),
    "sums": ("SELECT SUM(m_int), MAX(m_int), MIN(s_int), SUM(m_float), "
             "MAX(m_dbl), AVG(s_dbl) FROM t"),
    "sum_sentinels": ("SELECT k, SUM(s_long), AVG(s_int), SUM(m_int) FROM t "
                      "GROUP BY k ORDER BY k"),
    "eq_null_str": "SELECT COUNT(*), SUM(m) FROM t WHERE s_str = 'null'",
    "eq_zero": "SELECT COUNT(*) FROM t WHERE m_int = 0",
    "eq_default_and": ("SELECT COUNT(*) FROM t WHERE s_str = 'null' AND "
                       "m_int = 0"),
    "long_sentinel": ("SELECT COUNT(*) FROM t WHERE s_long = "
                      "-9223372036854775808"),
    "range_new": ("SELECT k, COUNT(*) FROM t WHERE s_long BETWEEN 0 AND 20000 "
                  "GROUP BY k ORDER BY k"),
    "in_new": "SELECT COUNT(*) FROM t WHERE s_str IN ('air', 'null')",
    "like_new": "SELECT COUNT(*) FROM t WHERE s_str LIKE 'n%'",
    "selection": ("SELECT k, m, s_str, s_long, s_int, s_dbl, m_int, m_float, "
                  "m_dbl FROM t ORDER BY m DESC, k LIMIT 30"),
    "selection_first": "SELECT s_str, m_int, s_long FROM t LIMIT 8",
    "distinct": "SELECT DISTINCT s_str FROM t ORDER BY s_str",
    "distinct_int": "SELECT DISTINCT s_int, m_int FROM t ORDER BY s_int, m_int",
    "expression": ("SELECT s_int + 1, COUNT(*) FROM t GROUP BY s_int + 1 "
                   "ORDER BY s_int + 1 LIMIT 5"),
    "expr_metric": "SELECT SUM(m_int * 2 + m), MAX(m_dbl - m) FROM t",
    "old_keys": ("SELECT k, SUM(m_int), COUNT(*) FROM t WHERE s_str <> 'ship' "
                 "GROUP BY k ORDER BY k"),
    "distinctcount": "SELECT DISTINCTCOUNT(s_str), DISTINCTCOUNT(m_int) FROM t",
    "order_by_new": ("SELECT k, s_long FROM t ORDER BY s_long DESC, k, m "
                     "LIMIT 10"),
}
# no segment stores the new columns
OLD_SQL = {k: SQL[k] for k in ("group_str_long", "sums", "eq_null_str",
                               "eq_zero", "selection_first", "distinct",
                               "expression", "long_sentinel")}
ERRORS = ("SELECT COUNT(*) FROM t WHERE nowhere = 3",
          "SELECT nowhere, COUNT(*) FROM t GROUP BY nowhere",
          "SELECT SUM(nowhere) FROM t")


@pytest.fixture(scope="module", params=["dict", "raw"])
def segment_dirs(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"evolution_{request.param}")
    rng = np.random.default_rng(31)
    raw = NEW if request.param == "raw" else []
    dirs = []
    for i, n in enumerate(SIZES):
        evolved = i == len(SIZES) - 1
        cfg = TableConfig(table_name="t", indexing=IndexingConfig(
            no_dictionary_columns=raw if evolved else []))
        out = str(base / f"s{i}")
        build_segment(_schema(Schema, DataType, evolved),
                      _columns(n, rng, evolved), out, cfg, f"s{i}")
        dirs.append(out)
    return request.param, dirs


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
    _kind, dirs = segment_dirs
    eng = _ref(dirs)
    old = _ref(dirs[:-1])
    return ({k: eng.execute(sql) for k, sql in SQL.items()},
            {k: old.execute(sql) for k, sql in OLD_SQL.items()})


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engines(request, segment_dirs):
    _kind, dirs = segment_dirs
    return _port(dirs, request.param), _port(dirs[:-1], request.param)


def test_new_segment_stores_as_configured(segment_dirs):
    kind, dirs = segment_dirs
    seg = ImmutableSegment(dirs[-1])
    for name in NEW:
        meta = seg.column_metadata(name)
        # metrics are raw in both and strings dict in both: the creator
        # gives metrics no dictionary and strings always one
        raw = name.startswith("m_") or kind == "raw" and name != "s_str"
        assert meta.encoding == ("RAW" if raw else "DICT"), name
        assert meta.has_null_vector, name
    assert "s_str" not in ImmutableSegment(dirs[0]).metadata.columns


@pytest.mark.parametrize("name", sorted(SQL))
def test_evolved_columns_match_reference(port_engines, ref_responses, name):
    got = port_engines[0].execute(SQL[name])
    assert_same_response(got, ref_responses[0][name])
    assert got["resultTable"]["rows"], name


@pytest.mark.parametrize("name", sorted(OLD_SQL))
def test_no_segment_stores_the_column(port_engines, ref_responses, name):
    got = port_engines[1].execute(OLD_SQL[name])
    assert_same_response(got, ref_responses[1][name])


@pytest.mark.parametrize("sql", ERRORS)
def test_unknown_column_errors_in_both(segment_dirs, sql):
    _kind, dirs = segment_dirs
    want = _ref(dirs).execute(sql)
    got = _port(dirs).execute(sql)
    assert want["exceptions"] and got["exceptions"], (want, got)
    assert "resultTable" not in got


def test_probe_shapes_render_the_defaults(segment_dirs):
    """The re-anchor's probe: the old segments' rows group under 'null'
    and Long.MIN, and SUM of an evolved INT metric renders 0.0 there."""
    _kind, dirs = segment_dirs
    rows = _port(dirs[:-1]).execute(
        "SELECT s_str, s_long, COUNT(*), SUM(m_int) FROM t "
        "GROUP BY s_str, s_long")["resultTable"]["rows"]
    assert rows == [["null", -9223372036854775808, SIZES[0] + SIZES[1],
                     0.0]]


def test_evolved_columns_take_the_host_path_shape(segment_dirs, monkeypatch):
    """An evolved column is never stored in every segment: the reference's
    device refuses it, so the query runs in its host path's shape."""
    from pinot_tpu_torch.engine import device as dev_mod

    _kind, dirs = segment_dirs
    eng = _port(dirs)
    seen = []
    real = dev_mod.DeviceExecutor.host_shape

    def spy(self, q, ctx):
        out = real(self, q, ctx)
        seen.append(out)
        return out

    monkeypatch.setattr(dev_mod.DeviceExecutor, "host_shape", spy)
    for sql, host in ((SQL["eq_zero"], True), (SQL["group_int"], True),
                      ("SELECT k, COUNT(*) FROM t GROUP BY k", False)):
        seen.clear()
        assert eng.execute(sql)["exceptions"] == []
        assert seen == [host], sql


def test_default_joins_the_global_dictionary(segment_dirs):
    """Over dict columns the default is one more value of the batch's
    global dictionary, and the old segments' planes hold its id."""
    from pinot_tpu_torch.engine.params import BatchContext

    kind, dirs = segment_dirs
    segs = []
    for d in dirs:
        seg = ImmutableSegment(d)
        seg.table_schema = _schema(PortSchema, PortDataType, True)
        segs.append(seg)
    ctx = BatchContext(segs, "cpu")
    col = ctx.column("s_str").numpy()
    if kind == "dict":
        values = list(ctx.global_dict("s_str").values)
        assert values == ["air", "null", "rail", "ship", "truck"]
        assert (col[0, : SIZES[0]] == values.index("null")).all()
    assert ctx.encoding("s_long") == ("RAW" if kind == "raw" else "DICT")
    exact = ctx.exact_column("m_dbl").numpy() if kind == "raw" else None
    if exact is not None:
        assert (exact[:2, : SIZES[1]] == 0.0).all()
