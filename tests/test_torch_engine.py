"""The port's engine against the JAX package's engine on the slice's SQL.

SSB-shaped segments (3 x 20k rows, bench.py's lineorder columns plus a
DOUBLE metric) are written by the JAX package's creator and loaded into
both engines. The reference runs its Pallas tier in interpret mode
(``DeviceExecutor(mm_mode="interpret")``); the port runs on the CPU, once
with its kernel gate at 0 rows (so the group sums and min/max go through
K1/K2's plain versions, as the reference's interpret mode ignores its
gate) and once at the default gate (torch scatters at this size).
Integer cells must match bit for bit, float cells per ``_rows_close``
(the reference's own tolerance, tests/test_pallas_scatter.py), and
numDocsScanned / totalDocs exactly.

The HLL / distinct-count set (``SKETCH_SQL``) must match bit for bit,
estimates, counts and every response stat both engines report; at the
kernel gate of 0 rows its registers go through K3's plain version (both
entries) and its large-G sorted form through K1's single-accumulator
entry. The non-terminal executor's registers and distinct sets equal the
reference's mergeable partials.
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.query.optimizer import optimize_query as ref_optimize
from pinot_tpu.sql.compiler import compile_select as ref_compile
from pinot_tpu.sql.parser import parse_sql as ref_parse
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.sql.compiler import compile_select
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment

SQL = {
    "q1_scan_agg": (
        "SET useStarTree = false; "
        "SELECT lo_suppkey, SUM(lo_revenue) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) DESC LIMIT 10"),
    "q2_range_sum": (
        "SELECT SUM(lo_revenue) FROM lineorder WHERE "
        "lo_orderdate BETWEEN 19930101 AND 19931231 "
        "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"),
    "q3_in_range": (
        "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE "
        "lo_suppkey IN (11, 234, 567, 890, 1203, 1456, 1789) "
        "AND lo_discount BETWEEN 4 AND 6"),
    "q4_no_hll": (
        "SELECT lo_suppkey, COUNT(*), AVG(lo_quantity) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10"),
    "q5_cube_scan": (
        "SET useStarTree = false; "
        "SELECT d_year, c_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "q6_minmax": (
        "SELECT d_year, s_nation, MIN(lo_revenue), MAX(lo_revenue), "
        "MINMAXRANGE(lo_quantity), COUNT(*) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year, s_nation "
        "ORDER BY d_year, s_nation LIMIT 200"),
    "double_sum_avg": (
        "SELECT d_year, SUM(lo_tax), AVG(lo_tax), MAX(lo_tax) FROM lineorder "
        "GROUP BY d_year ORDER BY d_year"),
    "two_key": (
        "SELECT c_region, s_nation, COUNT(*), SUM(lo_quantity) "
        "FROM lineorder WHERE d_year >= 1995 AND c_region <> 'ASIA' "
        "GROUP BY c_region, s_nation ORDER BY c_region, s_nation LIMIT 200"),
    "scalar_minmax_expr": (
        "SELECT MIN(lo_quantity), MAX(lo_revenue), "
        "SUM(lo_quantity * lo_discount) FROM lineorder "
        "WHERE s_nation LIKE 'nation_1%'"),
}
FLOAT_QUERIES = {"double_sum_avg"}

Q4_HLL = ("SELECT lo_suppkey, COUNT(*), AVG(lo_quantity), "
          "DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
          "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10")
SKETCH_SQL = {
    "hll_scalar": "SELECT COUNT(*), DISTINCTCOUNTHLL(lo_custkey) FROM lineorder",
    "hll_scalar_filtered": (
        "SELECT COUNT(*), DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3"),
    "hll_log2m_8": (
        "SELECT DISTINCTCOUNTHLL(lo_custkey, 8), DISTINCTCOUNTHLL(s_nation) "
        "FROM lineorder WHERE lo_quantity < 25"),
    "hll_small_group": (
        "SELECT d_year, c_region, DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    # G = 2000 x 1024 slots: the sorted terminal form
    "q4_scan_hll": "SET useStarTree = false; " + Q4_HLL,
    "q4_scan_hll_cold": ("SET useStarTree = false; "
                         "SET useSortedProjection = false; " + Q4_HLL),
    "hll_sorted_filtered": (
        "SELECT lo_suppkey, DISTINCTCOUNTHLL(lo_custkey), COUNT(*) "
        "FROM lineorder WHERE lo_discount > 2 GROUP BY lo_suppkey "
        "ORDER BY DISTINCTCOUNTHLL(lo_custkey) DESC, lo_suppkey LIMIT 10"),
    "distinct_count": (
        "SELECT d_year, DISTINCTCOUNT(lo_suppkey) FROM lineorder "
        "WHERE lo_quantity < 10 GROUP BY d_year ORDER BY d_year"),
    "distinct_count_scalar": (
        "SELECT DISTINCTCOUNT(s_nation), DISTINCTCOUNTBITMAP(lo_suppkey), "
        "COUNT(*) FROM lineorder WHERE d_year = 1995"),
    "distinct_bitmap_group": (
        "SELECT c_region, DISTINCTCOUNTBITMAP(s_nation), "
        "SEGMENTPARTITIONEDDISTINCTCOUNT(lo_discount) FROM lineorder "
        "WHERE c_region <> 'ASIA' GROUP BY c_region ORDER BY c_region"),
}
SKETCH_STATS = ("numDocsScanned", "numEntriesScannedInFilter",
                "numEntriesScannedPostFilter", "numSegmentsQueried",
                "numSegmentsProcessed", "numSegmentsMatched",
                "numGroupsLimitReached", "totalDocs")


def _rows_close(rows_a, rows_b):
    if len(rows_a) != len(rows_b):
        return False
    for ra, rb in zip(rows_a, rows_b):
        for x, y in zip(ra, rb):
            if isinstance(x, str) or x is None:
                if x != y:
                    return False
            elif not np.isclose(float(x), float(y), rtol=1e-5, atol=1e-6):
                return False
    return True


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="lineorder",
        dimensions=[
            ("d_year", DataType.INT), ("c_region", DataType.STRING),
            ("s_nation", DataType.STRING), ("lo_suppkey", DataType.INT),
            ("lo_custkey", DataType.INT), ("lo_orderdate", DataType.INT),
            ("lo_discount", DataType.INT),
        ],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT),
                 ("lo_tax", DataType.DOUBLE)])
    base = tmp_path_factory.mktemp("torch_engine")
    rng = np.random.default_rng(7)
    nations = np.array([f"nation_{i:02d}" for i in range(25)])
    regions = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDEAST"])
    dirs = []
    for i in range(3):
        n = 20000
        cols = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "c_region": regions[rng.integers(0, 5, n)],
            "s_nation": nations[rng.integers(0, 25, n)],
            "lo_suppkey": rng.integers(0, 2000, n).astype(np.int32),
            "lo_custkey": rng.integers(0, 100_000, n).astype(np.int32),
            "lo_orderdate": (19920101 + rng.integers(0, 7, n) * 10000
                             + rng.integers(0, 12, n) * 100
                             + rng.integers(0, 28, n)).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int32),
            "lo_tax": np.round(rng.uniform(0, 8, n), 2),
        }
        out = str(base / f"s{i}")
        build_segment(schema, cols, out, TableConfig(table_name="lineorder"),
                      f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def ref_engine(segment_dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in segment_dirs:
        eng.add_segment("lineorder", RefSegment(d))
    return eng


@pytest.fixture(scope="module")
def ref_responses(ref_engine):
    return {k: ref_engine.execute(sql) for k, sql in SQL.items()}


def _port_engine(segment_dirs, min_rows):
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in segment_dirs:
        eng.add_segment("lineorder", ImmutableSegment(d))
    return eng


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    return _port_engine(segment_dirs, request.param)


@pytest.mark.parametrize("name", sorted(SQL))
def test_port_matches_reference(port_engine, ref_responses, name):
    want = ref_responses[name]
    got = port_engine.execute(SQL[name])
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert rows, "the slice's queries all select rows"
    if name in FLOAT_QUERIES:
        assert _rows_close(rows, ref_rows), (rows, ref_rows)
    else:
        assert rows == ref_rows
    for key in ("numDocsScanned", "totalDocs"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def ref_sketch_responses(ref_engine):
    return {k: ref_engine.execute(sql) for k, sql in SKETCH_SQL.items()}


@pytest.mark.parametrize("name", sorted(SKETCH_SQL))
def test_sketch_queries_match_reference(port_engine, ref_sketch_responses,
                                        name):
    want = ref_sketch_responses[name]
    got = port_engine.execute(SKETCH_SQL[name])
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    assert got["resultTable"]["rows"]
    for key in SKETCH_STATS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", ["hll_scalar_filtered", "hll_log2m_8",
                                  "hll_small_group", "q4_scan_hll",
                                  "distinct_count", "distinct_bitmap_group"])
@pytest.mark.parametrize("min_rows", [0, None], ids=["kernels", "scatter"])
def test_non_terminal_partials_match_reference(segment_dirs, name, min_rows):
    """Without ``final`` the executor returns the mergeable partials: HLL
    registers (every group, as int8 like the reference's) and distinct
    value sets, equal to the reference executor's non-terminal launch."""
    sql = SKETCH_SQL[name]
    ref_q = ref_optimize(ref_compile(ref_parse(sql)))
    want = RefExecutor(mm_mode="interpret").launch(
        ref_q, [RefSegment(d) for d in segment_dirs]).fetch()
    ex = DeviceExecutor("cpu") if min_rows is None \
        else DeviceExecutor("cpu", min_rows=min_rows)
    got = ex.execute(optimize_query(compile_select(parse_sql(sql))),
                     [ImmutableSegment(d) for d in segment_dirs])
    assert got.shape == want.shape
    for g, w in zip(got.group_keys or (), want.group_keys or ()):
        np.testing.assert_array_equal(g, w)
    assert len(got.agg_partials) == len(want.agg_partials)
    for pg, pw in zip(got.agg_partials, want.agg_partials):
        assert sorted(pg) == sorted(pw)
        for key in pw:
            if key == "sets":
                assert list(pg[key]) == list(pw[key])
            else:
                assert pg[key].dtype == np.asarray(pw[key]).dtype, key
                np.testing.assert_array_equal(pg[key], np.asarray(pw[key]))
    assert "regs" in {k for p in got.agg_partials for k in p} \
        or "sets" in {k for p in got.agg_partials for k in p}


def test_hll_is_reported_in_band(port_engine):
    """HLLMERGE (the star-tree sketch merge) reads a cube's fixed-width
    BYTES register planes; over any other column it is refused in-band,
    as every shape the port does not run."""
    resp = port_engine.execute(
        "SELECT lo_suppkey, HLLMERGE(lo_custkey) FROM lineorder "
        "GROUP BY lo_suppkey")
    assert "resultTable" not in resp
    (exc,) = resp["exceptions"]
    assert exc["message"].startswith("DeviceUnsupported")


def test_kernel_gate_routes_to_the_kernels(segment_dirs, monkeypatch):
    """With the gate at 0 rows the group sums and min/max reach the K1/K2
    wrappers (their plain versions on the CPU), q6's three min/max
    aggregates in one K2 call; at the default gate this 60k-row batch
    stays on the torch scatters, as in the reference."""
    calls = {"group_plane_sums": 0, "group_minmax": 0}

    def spy(name):
        real = getattr(kernels, name + "_plain")

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(kernels, name + "_plain", wrapped)

    spy("group_plane_sums")
    spy("group_minmax")
    _port_engine(segment_dirs, None).execute(SQL["q6_minmax"])
    assert calls == {"group_plane_sums": 0, "group_minmax": 0}
    eng = _port_engine(segment_dirs, 0)
    eng.execute(SQL["q1_scan_agg"])
    eng.execute(SQL["q6_minmax"])
    assert calls == {"group_plane_sums": 2, "group_minmax": 1}


def test_sketch_gate_routes_to_the_kernels(segment_dirs, monkeypatch):
    """At the gate of 0 rows scalar HLL (1024 slots) reaches K3's
    small-slot entry, the d_year x c_region HLL (35 x 1024 slots) its
    group entry, and the terminal G = 2000 HLL K1's single-accumulator
    entry, each through the kernel's plain version on the CPU; at the
    default gate only the sorted form's K1 call remains (the reference's
    sorted build has no row gate)."""
    from pinot_tpu_torch.ops import group_scatter, groupby_mm

    calls = []
    for mod, entry in ((group_scatter, "hll_register_max"),
                       (groupby_mm, "hll_registers"),
                       (groupby_mm, "group_sums")):
        real = getattr(mod, entry)

        def wrapped(*a, _real=real, _entry=entry, **k):
            calls.append(_entry)
            return _real(*a, **k)
        monkeypatch.setattr(mod, entry, wrapped)
    for min_rows, want in ((0, ["hll_register_max", "hll_registers",
                                "group_sums"]),
                           (None, ["group_sums"])):
        calls.clear()
        eng = _port_engine(segment_dirs, min_rows)
        for name in ("hll_scalar", "hll_small_group", "q4_scan_hll"):
            assert eng.execute(SKETCH_SQL[name])["exceptions"] == []
        assert calls == want, min_rows
