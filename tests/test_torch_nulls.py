"""IS NULL / IS NOT NULL and the NULL literal on the port against the JAX
package.

Three segments hold a STRING dimension and a LONG metric with nulls
(each written with a null vector), a DOUBLE metric without, and a column
the first segment predates (schema-evolved: null in every one of its
docs). The reference answers IS NULL on its host path from the null
vectors (its engine/host.py), and adds nothing to numEntriesScannedInFilter
for it; its device refuses the predicate. The port answers it in that
host path's shape, the null vectors uploaded once a batch as a bool
plane. Rows, order, the dataSchema and every stat must be equal, floats
per ``_rows_close`` (rtol 1e-5); the reference runs with its device in
interpret mode, the port on the CPU at the kernel gate 0 and at the
default gate.

A star-tree segment must scan (the cube holds the substituted defaults),
and tests/test_nulls_percentile.py's IS NULL test replays through the
port.
"""

import numpy as np
import pytest

import test_nulls_percentile
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
from pinot_tpu_torch.common.datatypes import DataType as PortDataType
from pinot_tpu_torch.common.schema import Schema as PortSchema
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response

SIZES = (2200, 2600, 1700)


def _schema(cls, D, evolved: bool):
    dims = [("k", D.STRING), ("grp", D.INT)]
    if evolved:
        dims.append(("late", D.STRING))
    return cls.build(name="t", dimensions=dims,
                     metrics=[("v", D.LONG), ("f", D.DOUBLE)])


def _columns(n: int, rng, evolved: bool) -> dict:
    k = np.array([f"k{i}" for i in range(7)])[rng.integers(0, 7, n)] \
        .astype(object)
    k[rng.random(n) < 0.15] = None
    v = rng.integers(-50, 50, n).astype(object)
    v[rng.random(n) < 0.2] = None
    cols = {"k": list(k), "grp": rng.integers(0, 9, n).astype(np.int32),
            "v": list(v), "f": np.round(rng.uniform(0, 10, n), 2)}
    if evolved:
        late = np.array(["x", "y"])[rng.integers(0, 2, n)].astype(object)
        late[rng.random(n) < 0.3] = None
        cols["late"] = list(late)
    return cols


SQL = {
    "k_null": "SELECT COUNT(*) FROM t WHERE k IS NULL",
    "k_not_null": "SELECT COUNT(*), SUM(f) FROM t WHERE k IS NOT NULL",
    "v_null": "SELECT COUNT(*), SUM(v) FROM t WHERE v IS NULL",
    "f_never_null": "SELECT COUNT(*) FROM t WHERE f IS NULL",
    "f_not_null": "SELECT COUNT(*) FROM t WHERE f IS NOT NULL",
    "late_null": "SELECT COUNT(*) FROM t WHERE late IS NULL",
    "late_not_null": ("SELECT late, COUNT(*) FROM t WHERE late IS NOT NULL "
                      "GROUP BY late ORDER BY late"),
    "expr_never_null": "SELECT COUNT(*) FROM t WHERE v + 1 IS NULL",
    "expr_not_null": "SELECT COUNT(*) FROM t WHERE grp * 2 IS NOT NULL",
    "and": "SELECT COUNT(*) FROM t WHERE k IS NULL AND v IS NULL",
    "or": ("SELECT COUNT(*), MAX(f) FROM t WHERE k IS NULL OR v IS NULL "
           "OR late IS NULL"),
    "not": "SELECT COUNT(*) FROM t WHERE NOT k IS NULL AND grp = 3",
    "beside_scan": "SELECT COUNT(*) FROM t WHERE NOT k IS NULL AND f > 5",
    "mixed_dict_leaf": ("SELECT COUNT(*) FROM t WHERE v IS NOT NULL AND "
                        "k IN ('k1', 'k2')"),
    "group_by": ("SELECT k, COUNT(*), SUM(v), MIN(v) FROM t WHERE v IS NOT NULL "
                 "GROUP BY k ORDER BY k"),
    "group_by_grp": ("SELECT grp, COUNT(*) FROM t WHERE k IS NULL "
                     "GROUP BY grp ORDER BY grp"),
    "selection": ("SELECT k, v, grp FROM t WHERE v IS NULL ORDER BY grp, k "
                  "LIMIT 15"),
    "selection_first": "SELECT k, f FROM t WHERE k IS NULL LIMIT 6",
    "distinct": "SELECT DISTINCT grp FROM t WHERE late IS NULL ORDER BY grp",
    "null_literal": "SELECT NULL, k, grp FROM t ORDER BY grp, f LIMIT 5",
}
ERRORS = ("SELECT COUNT(*) FROM t WHERE nowhere IS NULL",
          "SELECT COUNT(*) FROM t WHERE $docId IS NULL")


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_nulls")
    rng = np.random.default_rng(12)
    dirs = []
    for i, n in enumerate(SIZES):
        evolved = i > 0
        out = str(base / f"s{i}")
        build_segment(_schema(Schema, DataType, evolved),
                      _columns(n, rng, evolved), out,
                      TableConfig(table_name="t", indexing=IndexingConfig(
                          inverted_index_columns=["grp"])), f"s{i}")
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
def test_null_predicates_match_reference(port_engine, ref_responses, name):
    got = port_engine.execute(SQL[name])
    assert_same_response(got, ref_responses[name])


def test_is_null_scans_no_entries(port_engine, ref_responses):
    """IS NULL returns before the host counts a scan: numEntriesScanned
    InFilter is 0 alone, and a scanned predicate beside it adds its own."""
    for name in ("k_null", "late_null", "or", "expr_never_null"):
        got = port_engine.execute(SQL[name])
        assert got["numEntriesScannedInFilter"] == 0, name
    got = port_engine.execute(SQL["beside_scan"])
    assert got["numEntriesScannedInFilter"] == sum(SIZES) \
        == ref_responses["beside_scan"]["numEntriesScannedInFilter"]


@pytest.mark.parametrize("sql", ERRORS)
def test_unknown_column_errors_in_both(segment_dirs, sql):
    want = _ref(segment_dirs).execute(sql)
    got = _port(segment_dirs).execute(sql)
    assert want["exceptions"] and got["exceptions"], (want, got)


def test_null_literal_in_arithmetic_is_refused_in_band(segment_dirs):
    """numpy cannot add None to numbers: the reference's host fails, and
    the port refuses the shape in-band, saying so."""
    sql = "SELECT grp + NULL FROM t LIMIT 3"
    want = _ref(segment_dirs).execute(sql)
    got = _port(segment_dirs).execute(sql)
    assert want["exceptions"], want
    assert "host path fails on it too" in got["exceptions"][0]["message"]


def test_null_plane_is_uploaded_once(segment_dirs):
    from pinot_tpu_torch.engine.params import BatchContext

    segs = []
    for d in segment_dirs:
        seg = ImmutableSegment(d)
        seg.table_schema = _schema(PortSchema, PortDataType, True)
        segs.append(seg)
    ctx = BatchContext(segs, "cpu")
    before = ctx.resident_bytes
    plane = ctx.null_plane("late")
    assert plane.dtype.is_floating_point is False and plane.shape == (
        3, ctx.pad_to)
    assert ctx.resident_bytes == before + plane.numel()
    assert ctx.null_plane("late") is plane
    assert bool(plane[0, : SIZES[0]].all())          # predates the column
    assert not bool(plane[0, SIZES[0]:].any())       # padding
    assert not bool(ctx.null_plane("f").any())       # no null vector
    want = np.asarray(segs[1].null_vector("k"))
    np.testing.assert_array_equal(
        ctx.null_plane("k")[1, : SIZES[1]].numpy(), want)


def test_star_tree_segment_scans(tmp_path):
    """The cube holds the substituted defaults: IS NULL must not fit it
    (engine/startree_exec.py), and the answer is the null vector's."""
    from pinot_tpu_torch.engine.startree_exec import fitting_tree
    from pinot_tpu_torch.sql.compiler import compile_query

    schema = Schema.build(name="t", dimensions=[("k", DataType.STRING)],
                          metrics=[("v", DataType.LONG),
                                   ("f", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        star_tree_configs=[StarTreeIndexConfig(
            dimensions_split_order=["k"],
            function_column_pairs=["COUNT__*", "SUM__v"])]))
    cols = {"k": ["a", None, "a", "b", None, "b"], "v": [1, 2, 3, None, 5, 6],
            "f": [0.0] * 6}
    d = str(tmp_path / "st")
    build_segment(schema, cols, d, cfg, "st0")
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    ref.add_segment("t", RefSegment(d))
    port = QueryEngine(device="cpu")
    seg = ImmutableSegment(d)
    port.add_segment("t", seg)
    for sql in ("SELECT COUNT(*) FROM t WHERE k IS NULL",
                "SELECT SUM(v) FROM t WHERE v IS NOT NULL",
                "SELECT k, SUM(v) FROM t WHERE k IS NOT NULL GROUP BY k "
                "ORDER BY k"):
        got = port.execute(sql)
        assert_same_response(got, ref.execute(sql))
        assert got["numDocsScanned"] > 0
    assert fitting_tree(compile_query(
        "SELECT COUNT(*) FROM t WHERE k IS NULL"), seg) is None
    assert fitting_tree(compile_query(
        "SELECT COUNT(*) FROM t WHERE k = 'a'"), seg) is not None


def test_is_null_predicates_replayed(tmp_path, monkeypatch):
    """tests/test_nulls_percentile.py::TestNullVectors::
    test_is_null_predicates with its engine swapped for the port's."""
    def port_engine(seg):
        eng = QueryEngine(device="cpu")
        eng.device.min_rows = 0
        eng.add_segment("t", ImmutableSegment(seg.dir))
        return eng

    monkeypatch.setattr(test_nulls_percentile, "_engine_with", port_engine)
    test_nulls_percentile.TestNullVectors().test_is_null_predicates(tmp_path)


def test_star_tree_null_test_replayed(tmp_path, monkeypatch):
    """test_star_tree_not_used_for_null_predicates, through the port."""
    def port_engine(seg):
        eng = QueryEngine(device="cpu")
        eng.add_segment("t", ImmutableSegment(seg.dir))
        return eng

    monkeypatch.setattr(test_nulls_percentile, "_engine_with", port_engine)
    test_nulls_percentile.TestNullVectors() \
        .test_star_tree_not_used_for_null_predicates(tmp_path)
