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
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import kernels
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

HLL_SQL = ("SELECT lo_suppkey, COUNT(*), DISTINCTCOUNTHLL(lo_custkey) "
           "FROM lineorder GROUP BY lo_suppkey LIMIT 10")


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


def test_hll_is_reported_in_band(port_engine):
    resp = port_engine.execute(HLL_SQL)
    assert "resultTable" not in resp
    (exc,) = resp["exceptions"]
    assert exc["message"].startswith("DeviceUnsupported")


def test_kernel_gate_routes_to_the_kernels(segment_dirs, monkeypatch):
    """With the gate at 0 rows the group sums and min/max reach the K1/K2
    wrappers (their plain versions on the CPU); at the default gate this
    60k-row batch stays on the torch scatters, as in the reference."""
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
    assert calls == {"group_plane_sums": 2, "group_minmax": 3}
