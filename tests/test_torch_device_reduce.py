"""The port's on-device top-K trim (ops/device_reduce.py) against the JAX
package's engine.

The shapes of tests/test_subrtt.py's device-reduce parity: 9,000 rows of
120 zones in three segments, written by the JAX package's creator and
loaded into the reference's ``QueryEngine`` and the port's
``QueryEngine(device="cpu")``. A trimmed answer must equal the port's
untrimmed answer (``SET useDeviceReduce = false``) and the reference's,
row for row; the trim must run where the reference's runs and not where
it does not (HAVING, post-aggregation order expressions); the partial
mode keeps ``trim_bound``'s rows. The numGroupsLimit case pins the port
against the reference under ``useDeviceReduce = false`` and by default,
where the trimmed launch gives way to the host path's shape as the
reference's leaves its device. ``lexsort_perm`` equals ``np.lexsort`` on
seeded keys, signed zeros and NaN included.
"""

import numpy as np
import pytest
import torch

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.engine.reduce import finalize as ref_finalize
from pinot_tpu.engine.reduce import trim_group_by as ref_trim_group_by
from pinot_tpu.query.optimizer import optimize_query as ref_optimize
from pinot_tpu.sql.compiler import compile_query as ref_compile
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.reduce import finalize, trim_group_by
from pinot_tpu_torch.ops import device_reduce as dr
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.sql.compiler import compile_query
from pinot_tpu_torch.storage.segment import ImmutableSegment

N, N_ZONES = 9000, 120
OFF = "SET useDeviceReduce = false; "

# tests/test_subrtt.py's TRIMMED_QUERIES
TRIMMED_QUERIES = [
    "SELECT zone, COUNT(*) FROM t GROUP BY zone "
    "ORDER BY COUNT(*) DESC LIMIT 10",
    "SELECT zone, SUM(fare) FROM t GROUP BY zone "
    "ORDER BY SUM(fare) DESC, zone LIMIT 5",
    "SELECT zone, SUM(fare) FROM t GROUP BY zone "
    "ORDER BY SUM(fare), zone DESC LIMIT 5",
    "SELECT zone, AVG(fare) FROM t WHERE hour < 12 GROUP BY zone "
    "ORDER BY AVG(fare) LIMIT 7",
    "SELECT zone, MIN(fare), MAX(fare) FROM t GROUP BY zone "
    "ORDER BY MIN(fare), zone LIMIT 6",
    "SELECT zone, MINMAXRANGE(fare) FROM t GROUP BY zone "
    "ORDER BY MINMAXRANGE(fare) DESC, zone LIMIT 4",
    "SELECT zone, COUNT(*) FROM t GROUP BY zone ORDER BY zone LIMIT 9",
    "SELECT zone, COUNT(*) FROM t GROUP BY zone ORDER BY zone DESC LIMIT 9",
    "SELECT zone, COUNT(*), SUM(fare) FROM t GROUP BY zone LIMIT 12",
    "SELECT zone FROM t GROUP BY zone ORDER BY SUM(fare) DESC LIMIT 8",
    "SELECT zone, COUNT(*) FROM t GROUP BY zone "
    "ORDER BY COUNT(*) DESC, zone LIMIT 10 OFFSET 5",
]
UNTRIMMED_QUERIES = [
    "SELECT zone, COUNT(*) FROM t GROUP BY zone "
    "HAVING COUNT(*) > 50 ORDER BY COUNT(*) DESC, zone LIMIT 10",
    "SELECT zone, SUM(fare) FROM t GROUP BY zone "
    "ORDER BY SUM(fare) / COUNT(*) DESC, zone LIMIT 10",
]


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def _write(base, name, schema, cols, nseg):
    n = len(next(iter(cols.values())))
    out = []
    for i in range(nseg):
        sl = slice(i * n // nseg, (i + 1) * n // nseg)
        build_segment(schema, {k: v[sl] for k, v in cols.items()},
                      str(base / f"s{i}"), TableConfig(table_name=name),
                      f"s{i}")
        out.append(str(base / f"s{i}"))
    return out


def _engines(dirs, table):
    port, ref = QueryEngine(device="cpu"), RefEngine()
    for d in dirs:
        port.add_segment(table, ImmutableSegment(d))
        ref.add_segment(table, RefSegment(d))
    return port, ref


@pytest.fixture(scope="module")
def zones(tmp_path_factory):
    rng = np.random.default_rng(7)
    cols = {
        "zone": np.array([f"z{i:03d}" for i in range(N_ZONES)])[
            rng.integers(0, N_ZONES, N)],
        "hour": rng.integers(0, 24, N).astype(np.int32),
        "fare": rng.integers(1, 10_000, N).astype(np.int64),
    }
    schema = Schema.build(
        name="t", dimensions=[("zone", DataType.STRING)],
        metrics=[("hour", DataType.INT), ("fare", DataType.LONG)])
    return _engines(_write(tmp_path_factory.mktemp("zones"), "t", schema,
                           cols, 3), "t")


def rows_of(eng, sql):
    r = eng.execute(sql)
    assert r["exceptions"] == [], (sql, r)
    return r["resultTable"]["rows"]


@pytest.mark.parametrize("sql", TRIMMED_QUERIES)
def test_trimmed_matches_untrimmed_and_reference(zones, sql):
    port, ref = zones
    want = rows_of(ref, sql)
    before = port.device.device_reduce_queries
    assert rows_of(port, sql) == want
    assert port.device.device_reduce_queries == before + 1
    assert rows_of(port, OFF + sql) == want
    assert port.device.device_reduce_queries == before + 1


def test_trimmed_fetch_moves_fewer_bytes(zones):
    port, _ = zones
    b0 = port.device.fetch_bytes_total
    rows_of(port, TRIMMED_QUERIES[1])
    trimmed = port.device.fetch_bytes_total - b0
    b0 = port.device.fetch_bytes_total
    rows_of(port, OFF + TRIMMED_QUERIES[1])
    untrimmed = port.device.fetch_bytes_total - b0
    assert 0 < trimmed < untrimmed


@pytest.mark.parametrize("sql", UNTRIMMED_QUERIES)
def test_having_and_post_agg_order_not_trimmed(zones, sql):
    port, ref = zones
    before = port.device.device_reduce_queries
    assert rows_of(port, sql) == rows_of(ref, sql)
    assert port.device.device_reduce_queries == before


@pytest.fixture(scope="module")
def limit_case(tmp_path_factory):
    """3,000 groups over three segments: the numGroupsLimit fault."""
    rng = np.random.default_rng(11)
    n = 9000
    cols = {"k": rng.permutation(np.arange(n) % 3000).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.int64)}
    schema = Schema.build(name="t", dimensions=[("k", DataType.INT)],
                          metrics=[("v", DataType.LONG)])
    return _engines(_write(tmp_path_factory.mktemp("limit"), "t", schema,
                           cols, 3), "t")


@pytest.mark.parametrize("order", ["ORDER BY k LIMIT 20",
                                   "ORDER BY COUNT(*) DESC, k LIMIT 20",
                                   "LIMIT 20"])
def test_num_groups_limit_stays_in_band(limit_case, order):
    """Under ``useDeviceReduce = false`` the port keeps the first 100
    gids, as the reference's device path does: rows and
    numGroupsLimitReached equal. By default the reference's trimmed
    table leaves its device and its host keeps the groups each segment
    meets first in doc order; the port's fetch reads the same count and
    runs the query again in the host path's shape on the card: rows,
    numGroupsLimitReached and every response stat equal the
    reference's."""
    port, ref = limit_case
    sql = f"SET numGroupsLimit = 100; SELECT k, COUNT(*) FROM t GROUP BY k {order}"
    off_port, off_ref = port.execute(OFF + sql), ref.execute(OFF + sql)
    assert off_port["exceptions"] == [] and off_ref["exceptions"] == []
    assert off_port["resultTable"] == off_ref["resultTable"]
    assert off_port["numGroupsLimitReached"] is True
    assert off_ref["numGroupsLimitReached"] is True
    reruns = port.device.host_shape_reruns
    got, want = port.execute(sql), ref.execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == []
    assert got["resultTable"] == want["resultTable"]
    for key in LIMIT_STATS:
        assert got[key] == want[key], key
    assert got["numGroupsLimitReached"] is True
    assert port.device.host_shape_reruns == reruns + 1
    # and within the limit the default trims, with no second run
    before = port.device.device_reduce_queries
    ok = f"SET numGroupsLimit = 5000; SELECT k, COUNT(*) FROM t GROUP BY k {order}"
    assert rows_of(port, ok) == rows_of(ref, ok)
    assert port.device.device_reduce_queries == before + 1
    assert port.device.host_shape_reruns == reruns + 1


LIMIT_STATS = ("numDocsScanned", "numEntriesScannedInFilter",
               "numEntriesScannedPostFilter", "numSegmentsQueried",
               "numSegmentsProcessed", "numSegmentsMatched",
               "numSegmentsPrunedByServer", "numBlocksPruned",
               "numGroupsLimitReached", "totalDocs")


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    """Groups tied on COUNT(*) across the LIMIT boundary, and a DOUBLE
    column whose groups' minima are -0.0, +0.0 and other values."""
    rng = np.random.default_rng(3)
    k = np.repeat(np.arange(200), np.where(np.arange(200) % 7 == 0, 6, 5))
    k = rng.permutation(k).astype(np.int32)
    n = len(k)
    f = rng.uniform(0.5, 3.0, n)
    neg = (k % 3 == 0)
    f[neg] = np.where(rng.random(neg.sum()) < 0.5, -0.0, 0.0)
    f[(k % 3 == 1) & (rng.random(n) < 0.3)] = -0.0
    cols = {"k": k, "f": f}
    schema = Schema.build(name="t", dimensions=[("k", DataType.INT)],
                          metrics=[("f", DataType.DOUBLE)])
    return _engines(_write(tmp_path_factory.mktemp("ties"), "t", schema,
                           cols, 2), "t")


@pytest.mark.parametrize("sql", [
    "SELECT k, COUNT(*) FROM t GROUP BY k ORDER BY COUNT(*) DESC, k LIMIT 10",
    "SELECT k, COUNT(*) FROM t GROUP BY k ORDER BY COUNT(*) DESC, k "
    "LIMIT 12 OFFSET 20",
    "SELECT k, COUNT(*) FROM t GROUP BY k ORDER BY COUNT(*) LIMIT 10",
    "SELECT k, MIN(f) FROM t GROUP BY k ORDER BY MIN(f) DESC, k LIMIT 30",
    "SELECT k, MIN(f) FROM t GROUP BY k ORDER BY MIN(f) DESC LIMIT 30",
    "SELECT k, MAX(f), MIN(f) FROM t GROUP BY k ORDER BY MIN(f), k DESC "
    "LIMIT 25",
])
def test_ties_and_signed_zeros(ties, sql):
    port, ref = ties
    want = rows_of(ref, sql)
    before = port.device.device_reduce_queries
    got = rows_of(port, sql)
    assert port.device.device_reduce_queries == before + 1
    assert got == want
    # -0.0 and +0.0 compare equal; the signs must match too
    assert [[np.copysign(1.0, x) if isinstance(x, float) else x for x in r]
            for r in got] == \
        [[np.copysign(1.0, x) if isinstance(x, float) else x for x in r]
         for r in want]
    assert rows_of(port, OFF + sql) == want


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """200 x 100 = 20,000 dense groups: past the partial mode's 5,000-row
    keep bound (T = 8,192)."""
    rng = np.random.default_rng(5)
    n = 30_000
    cols = {"a": np.array([f"a{i:03d}" for i in range(200)])[
                rng.integers(0, 200, n)],
            "b": rng.integers(0, 100, n).astype(np.int32),
            "v": rng.integers(1, 1000, n).astype(np.int64)}
    schema = Schema.build(
        name="hc", dimensions=[("a", DataType.STRING), ("b", DataType.INT)],
        metrics=[("v", DataType.LONG)])
    return _write(tmp_path_factory.mktemp("wide"), "hc", schema, cols, 1)


def test_server_partial_mode_keep_bound(wide):
    """A non-terminal sole partial takes the partial-mode trim: it keeps
    ``max(5 * (offset+limit), 5000)`` groups in ORDER BY order, and the
    server-side trim then finalizes to the reference's rows."""
    sql = ("SELECT a, b, SUM(v) FROM hc GROUP BY a, b "
           "ORDER BY SUM(v) DESC, a, b LIMIT 8")
    port, ref = _engines(wide, "hc")
    q = optimize_query(compile_query(sql))
    merged = port.execute_segments(q, table_segs(port, "hc"), terminal=False)
    assert port.device.device_reduce_queries == 1
    assert len(merged.group_keys[0]) == 5000
    got = finalize(q, trim_group_by(q, merged)).rows
    rq = ref_optimize(ref_compile(sql))
    tdm = ref.tables["hc"]
    acq = tdm.acquire()
    try:
        rmerged = ref.execute_segments(rq, acq, terminal=False)
        want = ref_finalize(rq, ref_trim_group_by(rq, rmerged)).rows
    finally:
        tdm.release(acq)
    assert got == want
    untrimmed = port.execute_segments(
        optimize_query(compile_query(OFF + sql)), table_segs(port, "hc"),
        terminal=False)
    assert len(untrimmed.group_keys[0]) > 5000
    # the kept groups are the top 5,000 of the untrimmed partial
    top = trim_group_by(q, untrimmed)
    for g, w in zip(merged.group_keys, top.group_keys):
        np.testing.assert_array_equal(g, w)


def _lexsort_cases():
    rng = np.random.default_rng(13)
    for n in (1, 7, 500, 4099):
        ints = rng.integers(-3, 4, n)
        counts = rng.integers(0, 5, n)
        floats = rng.choice([-1.5, -0.0, 0.0, 0.25, 2.0, np.nan, -np.inf,
                             np.inf, 1e-310, -1e-310], n)
        f32 = rng.standard_normal(n).astype(np.float32)
        f32[::5] = 0.0
        f32[1::5] = -0.0
        yield n, [counts, floats, ints]
        yield n, [-floats, f32, -counts]
        yield n, [ints]


@pytest.mark.parametrize("n,keys", list(_lexsort_cases()))
def test_lexsort_perm_equals_numpy(n, keys):
    want = np.lexsort(list(reversed(keys)))
    got = dr.lexsort_perm([torch.from_numpy(np.ascontiguousarray(k))
                           for k in keys]).numpy()
    np.testing.assert_array_equal(got, want)


def test_plan_trim_declines_where_the_reference_does():
    def plan(sql, mode="terminal", table_len=1000):
        q = optimize_query(compile_query(sql))
        return dr.plan_trim(q, q.group_by, q.aggregations(), table_len,
                            mode)

    base = "SELECT zone, COUNT(*) FROM t GROUP BY zone "
    assert plan(base + "ORDER BY COUNT(*) DESC LIMIT 10") == \
        (16, (("agg", 0, "count", False),))
    assert plan(base + "ORDER BY zone LIMIT 10 OFFSET 10") == \
        (32, (("col", 0, True),))
    assert plan(base + "LIMIT 10") == (16, ())
    assert plan(base + "LIMIT 10", mode="partial") is None
    assert plan(base + "LIMIT 10", mode=None) is None
    assert plan(OFF + base + "ORDER BY zone LIMIT 10") is None
    assert plan(base + "ORDER BY zone LIMIT 600") is None  # T >= table
    assert plan(base + "ORDER BY zone LIMIT 8", mode="partial",
                table_len=20_000) == (8192, (("col", 0, True),))
