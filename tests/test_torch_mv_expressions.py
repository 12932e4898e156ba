"""Multi-value columns inside expressions on the port against the JAX
package: ARRAYLENGTH / CARDINALITY, ARRAYSUM / ARRAYAVERAGE / ARRAYMIN /
ARRAYMAX, VALUEIN and MAPVALUE.

Two segments hold a dict STRING MV column (``tags``), a raw INT one
(``codes``), a dict INT one (``vals``, MAPVALUE's values beside the keys
``mkeys``) and a FLOAT one (``fl``); the first has docs without a
``codes`` entry, the second has none, and a third column (``extra``) is
schema-evolved: no entry in any doc. The reference computes each
function per segment in numpy, and its result dtype depends on the data:
ARRAYSUM over INT entries is int64 in a segment where every doc has an
entry and float64 (an empty doc's 0.0) where one has none; ARRAYMIN /
ARRAYMAX fill +-inf, MAPVALUE's miss 0. Its reduce concatenates the
segments' arrays, so one float segment among those it merges makes the
answer float. VALUEIN's result is the per-doc list, a group key as a
whole list (not expanded per entry), as the reference groups it.

Rows, order, the dataSchema and every stat must be equal, floats per
``_rows_close`` (rtol 1e-5); the reference runs with its device in
interpret mode, the port on the CPU at the kernel gate 0 and at the
default gate. tests/test_transform_extended.py's TestArrayTransforms and
TestMapValue replay through the port; DISTINCT and ORDER BY over an MV
column, on which the reference's host fails, are refused in-band.
"""

import numpy as np
import pytest

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
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response
from test_torch_time_literals import _replayed, tx_setup  # noqa: F401

SIZES = (1500, 1300)
TAGS = np.array([f"t{i}" for i in range(8)])


def _schema(cls, D, evolved: bool):
    mv = [("tags", D.STRING), ("codes", D.INT), ("mkeys", D.STRING),
          ("vals", D.INT), ("fl", D.FLOAT)]
    if evolved:
        mv.append(("extra", D.INT))
    return cls.build(name="t", dimensions=[("k", D.STRING)],
                     multi_value_dimensions=mv,
                     metrics=[("m", D.INT)])


def _columns(n: int, rng, empties: bool) -> dict:
    lo = 0 if empties else 1
    keys = np.array(["a", "b", "c", "d"])
    mkeys = [list(keys[rng.choice(4, rng.integers(0, 4), replace=False)])
             for _ in range(n)]
    return {
        "k": np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
        "tags": [list(TAGS[rng.integers(0, 8, rng.integers(0, 5))])
                 for _ in range(n)],
        "codes": [list(rng.integers(-20, 60, rng.integers(lo, 6)))
                  for _ in range(n)],
        "mkeys": mkeys,
        "vals": [list(rng.integers(1, 90, len(r))) for r in mkeys],
        "fl": [list(np.round(rng.uniform(-5, 5, rng.integers(1, 4)), 2))
               for _ in range(n)],
        "m": rng.integers(0, 100, n).astype(np.int32),
    }


_ALEN = "ARRAYLENGTH(tags)"
_VIN = "VALUEIN(tags, 't1', 't3', 't6')"


def _group(expr: str, agg: str = "COUNT(*)", order: str = "", where=""):
    return (f"SELECT {expr}, {agg} FROM t {where}GROUP BY {expr} "
            f"ORDER BY {order or expr} LIMIT 40")


SQL = {
    "len_group": _group(_ALEN, "COUNT(*), SUM(m)"),
    "cardinality": "SELECT MAX(CARDINALITY(codes)), SUM(CARDINALITY(fl)) "
                   "FROM t",
    "len_filter": ("SELECT COUNT(*), SUM(m) FROM t WHERE ARRAYLENGTH(tags) "
                   ">= 3"),
    # tests/test_differential_large.py's MV transform (its harness needs
    # upsert segments, ROADMAP item j)
    "len_sum": "SELECT SUM(ARRAYLENGTH(tags)) FROM t",
    "len_expr": _group("ARRAYLENGTH(codes) * 2 + 1"),
    "sum_group": _group("ARRAYSUM(codes)", order="ARRAYSUM(codes) DESC"),
    "sum_group_int_only": _group("ARRAYSUM(codes)", where="WHERE $docId < "
                                 "0 OR $segmentName = 's1' "),
    "min_group": _group("ARRAYMIN(codes)"),
    "min_group_int_only": _group("ARRAYMIN(codes)",
                                 where="WHERE $segmentName = 's1' "),
    "reductions": ("SELECT SUM(ARRAYSUM(codes)), MIN(ARRAYMIN(codes)), "
                   "MAX(ARRAYMAX(codes)), AVG(ARRAYAVERAGE(codes)), "
                   "SUM(ARRAYSUM(fl)), MAX(ARRAYAVERAGE(fl)) FROM t"),
    "reduce_by_k": ("SELECT k, SUM(ARRAYSUM(vals)), MAX(ARRAYMAX(codes)), "
                    "MIN(ARRAYMIN(fl)) FROM t GROUP BY k ORDER BY k"),
    "selection": ("SELECT m, ARRAYSUM(codes), ARRAYMIN(codes), "
                  "ARRAYMAX(codes), ARRAYAVERAGE(codes), ARRAYLENGTH(codes) "
                  "FROM t ORDER BY m, k LIMIT 20"),
    "selection_int_only": ("SELECT ARRAYSUM(codes), ARRAYMIN(codes) FROM t "
                           "WHERE $segmentName = 's1' LIMIT 6"),
    "order_by_sum": ("SELECT k, m FROM t ORDER BY ARRAYSUM(codes) DESC, m, k "
                     "LIMIT 10"),
    "valuein_group": _group(_VIN),
    "valuein_desc": _group(_VIN, order=f"{_VIN} DESC"),
    "valuein_len": _group(f"ARRAYLENGTH({_VIN})", "COUNT(*), SUM(m)"),
    "valuein_sum_len": f"SELECT SUM(ARRAYLENGTH({_VIN})) FROM t",
    "valuein_select": f"SELECT {_VIN}, k FROM t ORDER BY m, k LIMIT 12",
    "valuein_numbers": _group("VALUEIN(codes, 5, 7, 40)"),
    "mapvalue_int": _group("MAPVALUE(mkeys, 'b', vals)"),
    "mapvalue_sum": ("SELECT SUM(MAPVALUE(mkeys, 'c', vals)), "
                     "MAX(MAPVALUE(mkeys, 'a', vals)) FROM t"),
    "mapvalue_select": ("SELECT MAPVALUE(mkeys, 'a', vals), m FROM t "
                        "ORDER BY m, k LIMIT 8"),
    "mapvalue_string": _group("MAPVALUE(mkeys, 'b', tags)"),
    "evolved": ("SELECT ARRAYLENGTH(extra), ARRAYSUM(extra), COUNT(*) FROM t "
                "GROUP BY ARRAYLENGTH(extra), ARRAYSUM(extra)"),
    "evolved_valuein": _group("VALUEIN(extra, 1, 2)"),
    "sv_length": "SELECT ARRAYLENGTH(k), COUNT(*) FROM t GROUP BY "
                 "ARRAYLENGTH(k)",
}


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_mv_expr")
    rng = np.random.default_rng(8)
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        no_dictionary_columns=["codes"]))
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(_schema(Schema, DataType, False),
                      _columns(n, rng, empties=i == 0), out, cfg, f"s{i}")
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


@pytest.mark.parametrize("name", sorted(SQL))
def test_mv_expressions_match_reference(port_engine, ref_responses, name):
    got = port_engine.execute(SQL[name])
    assert_same_response(got, ref_responses[name])
    assert got["resultTable"]["rows"], name


def test_the_dtype_follows_the_segments(port_engine, ref_responses):
    """ARRAYSUM / ARRAYMIN over INT entries: float64 where a merged
    segment has a doc without entries, int64 / int32 where none has."""
    types = {name: port_engine.execute(SQL[name])["resultTable"]
             ["dataSchema"]["columnDataTypes"][0]
             for name in ("sum_group", "sum_group_int_only", "min_group",
                          "min_group_int_only")}
    assert types == {"sum_group": "DOUBLE", "sum_group_int_only": "LONG",
                     "min_group": "DOUBLE", "min_group_int_only": "INT"}
    for name, t in types.items():
        assert ref_responses[name]["resultTable"]["dataSchema"][
            "columnDataTypes"][0] == t


def test_valuein_groups_by_the_whole_list(port_engine):
    rows = port_engine.execute(SQL["valuein_group"])["resultTable"]["rows"]
    keys = [r[0] for r in rows]
    assert keys[0] == [] and all(isinstance(k, list) for k in keys)
    assert keys == sorted(keys)
    assert any(len(k) > 1 for k in keys)


@pytest.mark.parametrize("sql", [
    "SELECT DISTINCT tags FROM t",
    "SELECT k, tags FROM t ORDER BY tags",
    "SELECT k, codes FROM t ORDER BY codes LIMIT 5",
], ids=["distinct", "order_by", "order_by_raw"])
def test_distinct_and_order_by_mv_refused_in_band(segment_dirs, sql):
    """The reference's host fails on these (numpy cannot factorize the
    per-doc arrays): no answer to hold the port to, so the port refuses
    in-band and says that the reference fails."""
    want = _ref(segment_dirs).execute(sql)
    got = _port(segment_dirs).execute(sql)
    assert want["exceptions"], want
    assert "resultTable" not in got
    msg = got["exceptions"][0]["message"]
    assert "DeviceUnsupported" in msg \
        and "the reference's host path fails on it too" in msg \
        and "queue 3" in msg, msg


@pytest.mark.parametrize("sql,item", [
    ("SELECT CASE WHEN m > 1 THEN 'a' ELSE 1 END FROM t LIMIT 2", "e3e"),
    ("SELECT FIRSTWITHTIME(m, k, 'INT') FROM t", "e3e"),
    ("SELECT ARRAYSUM(ARRAYLENGTH(tags)) FROM t", "e3e"),
], ids=["case_mixed", "firstwithtime_string_time", "array_of_sv"])
def test_refusals_name_their_item(segment_dirs, sql, item):
    """These shapes were refused naming ROADMAP queue 1, item ``item``,
    which is done: the port answers as the reference does, or refuses
    in-band saying that the reference's host fails too."""
    want = _ref(segment_dirs).execute(sql)
    got = _port(segment_dirs).execute(sql)
    if want["exceptions"]:
        msg = got["exceptions"][0]["message"]
        assert "the reference's host path fails on it too" in msg, msg
    else:
        assert_same_response(got, want)
    assert f"item {item})" not in str(got)


def test_sumprecision_over_fractions_names_e2b(tmp_path):
    """Item e2b is done: SUMPRECISION over fractions answers the
    reference's exact decimal string."""
    schema = Schema.build(name="d", dimensions=[("k", DataType.STRING)],
                          metrics=[("x", DataType.DOUBLE)])
    d = str(tmp_path / "d")
    build_segment(schema, {"k": ["a", "b"], "x": np.array([0.5, 1.25])}, d,
                  TableConfig(table_name="d"), "d0")
    eng = QueryEngine(device="cpu")
    eng.add_segment("d", ImmutableSegment(d))
    got = eng.execute("SELECT SUMPRECISION(x) FROM d")
    assert got["exceptions"] == [], got
    assert got["resultTable"]["rows"] == [["1.75"]]


def test_no_refusal_names_the_old_item():
    """Every ``later()`` names e2b or e3e now: the old item e3 is gone
    from the port's messages."""
    import pathlib
    import re

    import pinot_tpu_torch

    root = pathlib.Path(pinot_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"item e3\)", text), path
        assert not re.search(r"item e3\"", text), path


# ---------------------------------------------------------------------------
# tests/test_transform_extended.py's array and map tests through the port
# ---------------------------------------------------------------------------

ARRAY_TESTS = _replayed(("TestArrayTransforms", "TestMapValue"))


@pytest.mark.parametrize("name", ARRAY_TESTS)
def test_transform_extended_arrays_through_the_port(tx_setup, name):  # noqa: F811
    eng, data = tx_setup
    assert isinstance(eng, QueryEngine)
    cname, mname = name.split("::")
    getattr(getattr(test_transform_extended, cname)(), mname)(eng, data)


def test_array_replay_covers_both_classes():
    assert len(ARRAY_TESTS) == 6
