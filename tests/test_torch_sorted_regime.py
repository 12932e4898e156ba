"""The port's sorted high-cardinality group-by regime against the JAX
package's engine.

tests/test_device.py::TestSortedRegimeBoundaries' fixture: two dict
columns at full cardinality (3,000 x 1,500 = 4.5M keys, past
MAX_DENSE_GROUPS = 2^22) holding exactly 5,000 distinct pairs over 40,000
rows in four segments, written by the JAX package's creator and loaded
into the reference's ``QueryEngine`` and the port's
``QueryEngine(device="cpu")``. Every case compares rows (integers
exactly, floats within ``_rows_close``), numGroupsLimitReached and every
response stat:

- below the table cap K = min(numGroupsLimit, MAX_SORTED_GROUPS) the
  query runs in the sorted regime (ops/radix_groupby.py), trimmed on the
  card by default and untrimmed under ``SET useDeviceReduce = false``;
- above the cap, and at a lowered MAX_SORTED_GROUPS, the table overflows
  and the reference re-runs on its host: the port runs the query again
  in the host path's shape on the card;
- ``SET numGroupsLimit`` below the group count: without the trim the
  sorted table's first groups in key order, as the reference's device;
  with it the host path's per-segment limit, as the reference's host;
- filters in the dense and block-skip forms (a column ``t`` in
  ingestion order joins the fixture for the zone maps), DISTINCT, a
  chunked plan with merge levels, EXPLAIN's rows.
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine import device as ref_device
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import device as port_device
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import radix_groupby as radix
from pinot_tpu_torch.storage.segment import ImmutableSegment

U, I, D, N = 3000, 1500, 5000, 40_000
OFF = "SET useDeviceReduce = false; "
SQL = ("SELECT u, i, COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v), "
       "MINMAXRANGE(v), SUM(f) FROM bc GROUP BY u, i "
       "ORDER BY SUM(v) DESC, u, i LIMIT 30")
STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned",
         "numGroupsLimitReached", "totalDocs")

# below the cap: the sorted regime on the card at numGroupsLimit = 6000
SORTED_QUERIES = [
    SQL,
    OFF + SQL,
    "SELECT u, i, COUNT(*), MIN(f), MAX(f) FROM bc GROUP BY u, i "
    "ORDER BY u DESC, i LIMIT 25",
    "SELECT u, i, AVG(f) FROM bc GROUP BY u, i "
    "ORDER BY AVG(f), u, i LIMIT 12 OFFSET 3",
    "SELECT u, i, MINMAXRANGE(f), COUNT(*) FROM bc GROUP BY u, i "
    "ORDER BY MINMAXRANGE(f) DESC, u, i LIMIT 10",
    "SELECT u, i, COUNT(*) FROM bc GROUP BY u, i LIMIT 15",
    OFF + "SELECT u, i, COUNT(*) FROM bc GROUP BY u, i LIMIT 15",
    "SELECT u, i, SUM(v) FROM bc WHERE u < 1000 GROUP BY u, i "
    "ORDER BY SUM(v), u, i LIMIT 20",
    "SET useBlockSkip = false; SELECT u, i, SUM(v) FROM bc WHERE u < 1000 "
    "GROUP BY u, i ORDER BY SUM(v), u, i LIMIT 20",
    "SELECT u, i, COUNT(*), SUM(v) FROM bc WHERE t BETWEEN 100 AND 3000 "
    "GROUP BY u, i ORDER BY SUM(v) DESC, u, i LIMIT 10",
    "SET useBlockSkip = false; SELECT u, i, COUNT(*), SUM(v) FROM bc "
    "WHERE t BETWEEN 100 AND 3000 GROUP BY u, i "
    "ORDER BY SUM(v) DESC, u, i LIMIT 10",
    "SELECT u, i, SUM(v * 2) FROM bc WHERE i BETWEEN 100 AND 400 "
    "GROUP BY u, i ORDER BY u, i LIMIT 20",
    "SELECT u, i, COUNT(*) FROM bc WHERE u > 5000 GROUP BY u, i LIMIT 5",
    "SELECT DISTINCT u, i FROM bc ORDER BY u, i LIMIT 7",
    "SELECT DISTINCT i, u FROM bc WHERE v > 500 ORDER BY i DESC, u "
    "LIMIT 7",
]

# numGroupsLimit below the 5,000 groups: key order without the trim, the
# host path's per-segment limit with it
LIMIT_QUERIES = [
    "SET numGroupsLimit = 1000; SELECT u, i, COUNT(*) FROM bc "
    "GROUP BY u, i ORDER BY COUNT(*) DESC, u, i LIMIT 5",
    "SET numGroupsLimit = 1000; SELECT u, i, COUNT(*), SUM(v) FROM bc "
    "GROUP BY u, i LIMIT 5",
    OFF + "SET numGroupsLimit = 1000; SELECT u, i, COUNT(*), SUM(v) "
    "FROM bc GROUP BY u, i LIMIT 5",
    OFF + "SET numGroupsLimit = 1000; SELECT u, i, MAX(f) FROM bc "
    "GROUP BY u, i ORDER BY MAX(f) DESC, u, i LIMIT 5",
]


def _rows_close(rows_a, rows_b):
    if len(rows_a) != len(rows_b):
        return False
    for ra, rb in zip(rows_a, rows_b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, (int, str)) or x is None or isinstance(
                    y, (int, str)) or y is None:
                if x != y:
                    return False
            elif not np.isclose(float(x), float(y), rtol=1e-5, atol=1e-6):
                return False
    return True


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    rng = np.random.default_rng(31)
    base = sorted({j * I + (j % I) for j in range(U)} | set(range(I)))
    pool = rng.choice(U * I, size=2 * D, replace=False)
    bset = set(base)
    extra = [int(p) for p in pool if p not in bset][:D - len(base)]
    pids = np.array(base + extra)
    assert len(pids) == D
    draw = np.concatenate([pids, rng.choice(pids, N - D)])
    rng.shuffle(draw)
    cols = {"u": (draw // I).astype(np.int32),
            "i": (draw % I).astype(np.int32),
            "v": rng.integers(-1000, 1000, N).astype(np.int64),
            "f": np.round(rng.uniform(-5, 5, N), 6),
            # ingestion order: zone-map blocks prune on it
            "t": np.arange(N, dtype=np.int32)}
    schema = Schema.build(name="bc",
                          dimensions=[("u", DataType.INT), ("i", DataType.INT),
                                      ("t", DataType.INT)],
                          metrics=[("v", DataType.LONG), ("f", DataType.DOUBLE)])
    root = tmp_path_factory.mktemp("bc")
    out = []
    quarter = N // 4
    for s in range(4):
        build_segment(schema, {k: v[s * quarter:(s + 1) * quarter]
                               for k, v in cols.items()},
                      str(root / f"s{s}"), TableConfig(table_name="bc"),
                      f"s{s}")
        out.append(str(root / f"s{s}"))
    return out


def _engines(dirs, limit):
    port = QueryEngine(device="cpu", num_groups_limit=limit)
    ref = RefEngine(num_groups_limit=limit)
    for d in dirs:
        port.add_segment("bc", ImmutableSegment(d))
        ref.add_segment("bc", RefSegment(d))
    return port, ref


@pytest.fixture(scope="module")
def at_6000(dirs):
    return _engines(dirs, 6000)


@pytest.fixture
def sorted_calls(monkeypatch):
    """Counts the sorted regime's table builds."""
    calls = []
    real = radix.chunked_group_aggregate

    def spy(*a, **k):
        calls.append(a[-1] if len(a) > 5 else k.get("table_k"))
        return real(*a, **k)

    monkeypatch.setattr(radix, "chunked_group_aggregate", spy)
    return calls


def _parity(port, ref, sql):
    got, want = port.execute(sql), ref.execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert _rows_close(got["resultTable"]["rows"],
                       want["resultTable"]["rows"]), \
        (got["resultTable"]["rows"][:4], want["resultTable"]["rows"][:4])
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])
    return got


@pytest.mark.parametrize("sql", SORTED_QUERIES)
def test_below_the_cap_runs_the_sorted_regime(at_6000, sorted_calls, sql):
    port, ref = at_6000
    reruns = port.device.host_shape_reruns
    got = _parity(port, ref, sql)
    assert sorted_calls and set(sorted_calls) == {6000}
    assert port.device.host_shape_reruns == reruns
    assert got["numGroupsLimitReached"] is False
    if "t BETWEEN" in sql:   # the gathered block-skip form, or its twin
        assert (got["numBlocksPruned"] > 0) == ("useBlockSkip" not in sql)


def test_the_trim_fetches_the_kept_rows(at_6000):
    port, ref = at_6000
    ex = port.device
    d0, b0 = ex.device_reduce_queries, ex.fetch_bytes_total
    trimmed = _parity(port, ref, SQL)
    b1 = ex.fetch_bytes_total
    assert ex.device_reduce_queries == d0 + 1
    untrimmed = _parity(port, ref, OFF + SQL)
    assert ex.device_reduce_queries == d0 + 1
    assert trimmed["resultTable"] == untrimmed["resultTable"]
    assert 0 < b1 - b0 < (ex.fetch_bytes_total - b1) / 50


@pytest.mark.parametrize("sql", [SQL, OFF + SQL,
                                 "SELECT u, i, COUNT(*) FROM bc "
                                 "GROUP BY u, i LIMIT 9"])
def test_above_the_cap_takes_the_host_path_shape(dirs, sorted_calls, sql):
    """5,000 groups past K = 4,000: the reference's fetch re-runs on its
    host, the port's in the host path's shape on the card."""
    port, ref = _engines(dirs, 4000)
    got = _parity(port, ref, sql)
    assert set(sorted_calls) == {4000}
    assert port.device.host_shape_reruns == 1
    assert got["numGroupsLimitReached"] is True


def test_max_sorted_groups_ceiling(dirs, sorted_calls, monkeypatch):
    """K = min(numGroupsLimit, MAX_SORTED_GROUPS): lowered below the
    5,000 groups, even a generous numGroupsLimit overflows on both; at
    its value the sorted regime answers."""
    monkeypatch.setattr(ref_device, "MAX_SORTED_GROUPS", 4500)
    monkeypatch.setattr(port_device, "MAX_SORTED_GROUPS", 4500)
    port, ref = _engines(dirs, 100_000)
    _parity(port, ref, SQL)
    assert set(sorted_calls) == {4500}
    assert port.device.host_shape_reruns == 1
    monkeypatch.setattr(ref_device, "MAX_SORTED_GROUPS", 1 << 17)
    monkeypatch.setattr(port_device, "MAX_SORTED_GROUPS", 1 << 17)
    port, ref = _engines(dirs, 100_000)
    got = _parity(port, ref, SQL)
    assert sorted_calls[-1] == 100_000
    assert port.device.host_shape_reruns == 0
    assert got["numGroupsLimitReached"] is False


@pytest.mark.parametrize("sql", LIMIT_QUERIES)
def test_set_num_groups_limit(at_6000, sql):
    port, ref = at_6000
    reruns = port.device.host_shape_reruns
    got = _parity(port, ref, sql)
    assert got["numGroupsLimitReached"] is True
    # the trim under numGroupsLimit pressure gives way to the host path's
    # shape; untrimmed, the key-order truncation answers from the table
    assert port.device.host_shape_reruns == reruns + (OFF not in sql)


def test_chunked_plan_parity(at_6000, monkeypatch):
    """A multi-chunk plan with merge levels at engine scale (the chunk
    length shrunk, the compaction ratio relaxed) answers the same."""
    orig = radix.plan_chunks
    monkeypatch.setattr(radix, "CHUNK_ROWS", 256)
    monkeypatch.setattr(radix, "CHUNK_ROWS_MAX", 8192)
    monkeypatch.setattr(
        radix, "plan_chunks", lambda n, k, chunk_rows=None, min_ratio=None:
        orig(n, k, chunk_rows, 1))
    C, _L = radix.plan_chunks(N, 6000)
    assert C > 1
    port, ref = at_6000
    _parity(port, ref, SQL)
    _parity(port, ref, OFF + SQL)


def test_explain_renders_the_reference_rows(at_6000):
    """EXPLAIN of a sorted-regime query: the reference's rows with its
    device partials cache off (the port has none), the trim line at K
    included, but the backend label (ROADMAP queue 3)."""
    port, ref = at_6000
    ref.device.partials_cache_enabled = False
    port.device.partials_cache_enabled = False
    for sql in (SQL, "SELECT u, i, COUNT(*) FROM bc WHERE u < 10 "
                     "GROUP BY u, i LIMIT 10",
                "SELECT u, i, DISTINCTCOUNTHLL(v) FROM bc GROUP BY u, i "
                "ORDER BY u LIMIT 10"):
        got = port.execute("EXPLAIN PLAN FOR " + sql)
        want = ref.execute("EXPLAIN PLAN FOR " + sql)
        assert got["exceptions"] == [] and want["exceptions"] == []
        rows_g, rows_w = got["resultTable"]["rows"], want["resultTable"]["rows"]
        assert len(rows_g) == len(rows_w)
        for g, w in zip(rows_g, rows_w):
            if g[0].startswith("  COMBINE_"):
                assert g[0].split(" [")[0] == w[0].split(" [")[0]
                continue
            assert g == w
    assert any(r[0].startswith("    DEVICE_REDUCE(trim=30)")
               for r in port.execute("EXPLAIN PLAN FOR " + SQL)[
                   "resultTable"]["rows"])


def test_aggregations_off_the_sorted_path_take_the_host_path_shape(at_6000):
    """DISTINCTCOUNTHLL is not in SORTED_AGGS: the reference answers on
    its host, the port in that path's shape."""
    port, ref = at_6000
    _parity(port, ref, "SELECT u, i, DISTINCTCOUNTHLL(v) FROM bc "
                       "GROUP BY u, i ORDER BY u, i LIMIT 10")
