"""The port's mesh (pinot_tpu_torch/parallel/mesh.py) against the
reference's 8-device mesh and against the port's single device, on the
CPU: ``make_mesh(8)`` is ``[cpu] * 8`` here, the reference's the 8 virtual
devices tests/conftest.py provisions.

The same segments load into the reference's
``QueryEngine(device_executor=DeviceExecutor(mesh=make_mesh(8)))`` and
into the port's mesh and single-device engines. Integers and HLL
registers must equal bit for bit, floats within ``_rows_close``, and the
scan stats exactly. Covered: tests/test_mesh.py's cases (dense, sketch
and sorted-regime group-bys, the overflow re-run), the mesh cases of
test_join.py (BROADCAST and SHUFFLE, ``joinFanout``, EXPLAIN's
``[mesh-collective]``), test_window.py, test_blockskip.py (pruning, the
gathered and fused forms under each shard), test_firstlast.py,
test_narrow.py (cardinality boundaries, the sub-byte tier),
test_pallas_scatter.py (K1-K3 entries under each shard), test_subrtt.py
(the device trim after the combine) and test_concurrency.py (cohorts on
the mesh); consuming segments beside sealed ones; the partials cache
keyed with the mesh; the batch LRU's bytes; the placement check; and the
dryrun's six combine families and seven hard shapes."""

import math
import threading

import numpy as np
import pytest
import torch

from pinot_tpu.common.datatypes import DataType as RDT
from pinot_tpu.common.schema import Schema as RSchema
from pinot_tpu.common.table_config import TableConfig as RTC
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pinot_tpu.storage.creator import build_segment as r_build
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import cohort as cohort_mod
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import radix_groupby as radix_ops
from pinot_tpu_torch.parallel import dryrun
from pinot_tpu_torch.parallel import mesh as mesh_ops
from pinot_tpu_torch.parallel.mesh import Mesh, make_mesh
from pinot_tpu_torch.storage.segment import ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned", "totalDocs",
         "numGroupsLimitReached")


def rows_close(a, b) -> bool:
    """Integers and strings exactly, floats per tests/test_pallas_scatter.py
    ``_rows_close`` (rtol 1e-5, atol 1e-6)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(y, float) or isinstance(x, float):
                if x is None or y is None:
                    return x is y
                x, y = float(x), float(y)
                if not ((math.isnan(x) and math.isnan(y))
                        or np.isclose(x, y, rtol=1e-5, atol=1e-6)):
                    return False
            elif x != y or type(x) is not type(y):
                return False
    return True


def port_engine(mesh=True, gate=0) -> QueryEngine:
    ex = DeviceExecutor(device="cpu",
                        mesh=make_mesh(8) if mesh else None)
    ex.min_rows = gate
    return QueryEngine(device_executor=ex)


def ref_mesh_engine(**kw) -> RefEngine:
    return RefEngine(device_executor=RefExecutor(mesh=ref_make_mesh(8),
                                                 **kw))


def same(got, want, single=None, stats=STATS, exact=False,
         single_stats=True):
    """Rows and ``stats`` of the port's mesh ``got`` against the
    reference mesh's ``want``; its rows (and, with ``single_stats``, the
    stats) exactly the port's single device's."""
    for r in (got, want) + ((single,) if single else ()):
        assert not r.get("exceptions"), r.get("exceptions")
    g, w = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert (g == w) if exact else rows_close(g, w), (g[:4], w[:4])
    for k in stats:
        assert got.get(k) == want.get(k), (k, got.get(k), want.get(k))
    if single is not None:
        assert got["resultTable"] == single["resultTable"]
        for k in stats if single_stats else ():
            assert got.get(k) == single.get(k), k


# ---------------------------------------------------------------------------
# tests/test_mesh.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def m_engines(tmp_path_factory):
    rng = np.random.default_rng(23)
    n = 5000
    cols = {
        "k1": np.array([f"g{i}" for i in range(20)])[rng.integers(0, 20, n)],
        "k2": np.array(["x", "y"])[rng.integers(0, 2, n)],
        "v": rng.integers(0, 1000, n).astype(np.int32),
        "ts": rng.integers(0, 50_000, n).astype(np.int64),
    }
    schema = RSchema.build(
        name="m", dimensions=[("k1", RDT.STRING), ("k2", RDT.STRING)],
        metrics=[("v", RDT.INT), ("ts", RDT.LONG)])
    base = tmp_path_factory.mktemp("meshseg")
    ref, mesh, single = ref_mesh_engine(), port_engine(), \
        port_engine(mesh=False)
    bounds = [0, 400, 1400, 2000, 3100, 4200, n]   # 6 uneven segments
    for i in range(6):
        d = str(base / f"s{i}")
        r_build(schema, {k: v[bounds[i]:bounds[i + 1]]
                         for k, v in cols.items()}, d, RTC(table_name="m"),
                f"s{i}")
        ref.add_segment("m", RefSegment(d))
        seg = ImmutableSegment(d)
        mesh.add_segment("m", seg)
        single.add_segment("m", seg)
    return ref, mesh, single


MESH_QUERIES = [
    "SELECT COUNT(*) FROM m",
    "SELECT SUM(v), MIN(v), MAX(v), AVG(v) FROM m WHERE k2 = 'x'",
    "SELECT k1, COUNT(*), SUM(v) FROM m GROUP BY k1 ORDER BY k1 LIMIT 25",
    "SELECT k1, k2, MAX(v) FROM m WHERE v > 100 GROUP BY k1, k2 "
    "ORDER BY k1, k2 LIMIT 50",
    "SELECT DISTINCTCOUNT(k1) FROM m WHERE k2 = 'y'",
    "SELECT k2, DISTINCTCOUNTHLL(k1) FROM m GROUP BY k2 ORDER BY k2",
    "SELECT COUNT(*) FROM m WHERE k1 IN ('g1','g5') OR v BETWEEN 10 AND 50",
    # beyond test_mesh.py: the time pair, MINMAXRANGE, a filterless HLL
    # group-by (the single device's sorted build, registers on the mesh)
    "SELECT k2, FIRSTWITHTIME(v, ts, 'INT'), LASTWITHTIME(v, ts, 'INT') "
    "FROM m GROUP BY k2 ORDER BY k2",
    "SELECT k1, MINMAXRANGE(v), DISTINCTCOUNT(k2) FROM m "
    "GROUP BY k1 ORDER BY k1",
    "SELECT k1, DISTINCTCOUNTHLL(v) FROM m GROUP BY k1 ORDER BY k1",
    "SELECT COUNT(*), SUM(v) FROM m WHERE k1 = 'nope'",
]


@pytest.mark.parametrize("sql", MESH_QUERIES)
def test_sharded_equals_single_equals_reference(m_engines, sql):
    ref, mesh, single = m_engines
    same(mesh.execute(sql), ref.execute(sql), single.execute(sql),
         exact=True)


def test_mesh_runs_every_shard_on_its_device(m_engines, monkeypatch):
    """Six segments over 8 shards: shards 0-5 hold one segment each and
    run the pipeline, 6-7 are padding and run nothing."""
    _, mesh, _ = m_engines
    seen = []
    real = mesh_ops.check_placement

    def spy(shard, device, tensors):
        seen.append(shard)
        return real(shard, device, tensors)

    monkeypatch.setattr(mesh_ops, "check_placement", spy)
    mesh.execute("SET usePartialsCache=false; "
                 "SELECT k1, SUM(v) FROM m GROUP BY k1")
    assert sorted(set(seen)) == [0, 1, 2, 3, 4, 5]


def test_partials_cache_keyed_with_the_mesh(m_engines):
    _, mesh, _ = m_engines
    sql = "SELECT k2, SUM(v) FROM m WHERE v > 17 GROUP BY k2 ORDER BY k2"
    h0 = mesh.device.partials_hits
    a, b = mesh.execute(sql), mesh.execute(sql)
    assert a["resultTable"] == b["resultTable"]
    assert mesh.device.partials_hits == h0 + 1
    assert all(k[-1] == mesh.device.mesh.key for k in mesh.device._partials)


def test_batch_bytes_count_each_shard_plane_once(m_engines):
    """A device-shape launch uploads on the shards only: the batch the
    LRU holds counts each shard's planes once, and holds none itself."""
    _, port, single = m_engines
    mesh = port_engine()
    for seg in port.table("m").segments.values():
        mesh.add_segment("m", seg)
    sql = "SELECT k1, SUM(v), MAX(ts) FROM m WHERE k2 = 'y' GROUP BY k1"
    assert mesh.execute(sql)["resultTable"] == \
        single.execute(sql)["resultTable"]
    ctx, = mesh.device._batches.values()
    shards = ctx._mesh_shards
    assert len(shards) == 6 and not ctx._columns
    assert ctx.resident_bytes == sum(sh.resident_bytes for _d, sh in shards)
    assert ctx.resident_bytes > 0
    assert mesh.device.hbm_stats()["resident_bytes"] == ctx.resident_bytes


class TestSortedRegimeMesh:
    @pytest.fixture(scope="class")
    def hc(self, tmp_path_factory):
        rng = np.random.default_rng(37)
        n, U, I = 12_000, 2300, 2000   # 4.6M keys > MAX_DENSE_GROUPS
        u = rng.integers(0, U, n).astype(np.int32)
        i = rng.integers(0, I, n).astype(np.int32)
        u[:U] = np.arange(U, dtype=np.int32)
        i[:I] = np.arange(I, dtype=np.int32)
        cols = {"u": u, "i": i,
                "v": rng.integers(-500, 500, n).astype(np.int64)}
        schema = RSchema.build(
            name="hcm", dimensions=[("u", RDT.INT), ("i", RDT.INT)],
            metrics=[("v", RDT.LONG)])
        base = tmp_path_factory.mktemp("hcmesh")
        dirs = []
        bounds = [0, 1500, 2600, 4800, 6400, 9000, n]
        for s in range(6):
            d = str(base / f"s{s}")
            r_build(schema, {k: v[bounds[s]:bounds[s + 1]]
                             for k, v in cols.items()}, d,
                    RTC(table_name="hcm"), f"s{s}")
            dirs.append(d)
        return dirs

    def engines(self, dirs, limit=100_000):
        host = RefEngine(device_executor=None, num_groups_limit=limit)
        mesh = QueryEngine(device_executor=DeviceExecutor(
            device="cpu", mesh=make_mesh(8), num_groups_limit=limit),
            num_groups_limit=limit)
        single = QueryEngine(device="cpu", num_groups_limit=limit)
        for d in dirs:
            host.add_segment("hcm", RefSegment(d))
            mesh.add_segment("hcm", ImmutableSegment(d))
            single.add_segment("hcm", ImmutableSegment(d))
        return host, mesh, single

    @pytest.mark.parametrize("sql", [
        "SELECT u, i, COUNT(*), SUM(v) FROM hcm GROUP BY u, i "
        "ORDER BY COUNT(*) DESC, u, i LIMIT 30",
        "SELECT u, i, MIN(v), MAX(v), AVG(v) FROM hcm WHERE v > -200 "
        "GROUP BY u, i ORDER BY MIN(v), u, i LIMIT 40",
    ])
    def test_mesh_equals_single_equals_host(self, hc, sql, monkeypatch):
        host, mesh, single = self.engines(hc)
        calls = []
        real = radix_ops.chunked_group_aggregate

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(radix_ops, "chunked_group_aggregate", spy)
        rm = mesh.execute(sql)
        assert len(calls) == 6          # the sorted regime, per shard
        rh, r1 = host.execute(sql), single.execute(sql)
        same(rm, rh, r1, stats=("numDocsScanned",), exact=True)

    def test_overflow_still_reruns(self, hc):
        host, mesh, _ = self.engines(hc, limit=1000)
        sql = ("SELECT u, i, SUM(v) FROM hcm GROUP BY u, i "
               "ORDER BY u, i LIMIT 20")
        r0 = mesh.device.host_shape_reruns
        same(mesh.execute(sql), host.execute(sql),
             stats=("numDocsScanned",), exact=True)
        assert mesh.device.host_shape_reruns == r0 + 1


# ---------------------------------------------------------------------------
# joins and windows on the mesh (test_join.py, test_window.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def join_engines(tmp_path_factory):
    from test_torch_join import load, make_data

    rng = np.random.default_rng(11)
    fact, parts, custs = make_data(rng)
    ref = load("ref", ref_mesh_engine(), tmp_path_factory.mktemp("jmr"),
               fact, parts, custs)
    port = load("port", port_engine(),
                tmp_path_factory.mktemp("jmp"), fact, parts, custs)
    solo = load("port", port_engine(mesh=False),
                tmp_path_factory.mktemp("jms"), fact, parts, custs)
    return ref, port, solo


JOIN_QUERIES = [
    "SELECT p.category, SUM(o.qty) FROM orders o JOIN parts p "
    "ON o.partkey = p.pkey GROUP BY p.category ORDER BY p.category",
    "SELECT p.category, COUNT(*) FROM orders o LEFT JOIN parts p "
    "ON o.partkey = p.pkey GROUP BY p.category ORDER BY p.category",
    "SELECT o.partkey, p.brand, o.qty FROM orders o JOIN parts p "
    "ON o.partkey = p.pkey WHERE o.qty > 45 LIMIT 30",
    "SELECT p.category, c.region, SUM(o.price) FROM orders o "
    "JOIN parts p ON o.partkey = p.pkey JOIN custs c ON o.custkey = c.ckey "
    "GROUP BY p.category, c.region ORDER BY p.category, c.region LIMIT 50",
    "SELECT o.status, p.pkey FROM orders o JOIN parts p "
    "ON o.custkey = p.pkey JOIN parts q ON o.custkey = q.pkey LIMIT 25",
    "SELECT COUNT(*) FROM orders o JOIN orders x ON o.custkey = x.custkey "
    "WHERE o.qty < 3 AND x.qty < 3",
    "SELECT p.category, PERCENTILETDIGEST(o.price, 50), MODE(o.qty) "
    "FROM orders o JOIN parts p ON o.partkey = p.pkey "
    "GROUP BY p.category ORDER BY p.category",
]


@pytest.mark.parametrize("strategy", ["broadcast", "shuffle"])
@pytest.mark.parametrize("sql", JOIN_QUERIES)
def test_join_on_mesh(join_engines, sql, strategy):
    """Rows in the reference mesh's order: BROADCAST's probe-major pairs,
    SHUFFLE's bucket by bucket."""
    ref, port, _ = join_engines
    full = f"SET useAdvisor=false; SET joinStrategy='{strategy}'; {sql}"
    want, got = ref.execute(full), port.execute(full)
    same(got, want, stats=("numDocsScanned", "numJoinedRows",
                           "joinStrategy", "leafRows"))


def test_shuffle_fanout_is_the_mesh(join_engines):
    """SHUFFLE puts a key bucket on each mesh device: the executed join's
    fan-out is the mesh's size (1 on one device), as the reference's
    plan runner reports it."""
    from pinot_tpu_torch.query2 import logical, runner
    from pinot_tpu_torch.sql.parser import parse_sql

    _, port, solo = join_engines
    sql = ("SET joinStrategy='shuffle'; SELECT COUNT(*) FROM orders o "
           "JOIN parts p ON o.partkey = p.pkey")
    for eng, fanout in ((port, 8), (solo, 1)):
        plan = logical.compile_plan(parse_sql(sql), runner.catalog_for(eng))
        _res, _stats, meta = runner.run_local(eng, plan)
        assert meta["joinFanout"] == fanout
        assert meta["mesh"] == (eng is port)


def test_explain_mesh_exchange(join_engines):
    ref, port, solo = join_engines
    sql = ("EXPLAIN PLAN FOR SELECT COUNT(*) FROM orders o "
           "JOIN parts p ON o.partkey = p.pkey")
    lines = [r[0] for r in port.execute(sql)["resultTable"]["rows"]]
    assert any("[mesh-collective]" in ln for ln in lines)
    want = [r[0] for r in ref.execute(sql)["resultTable"]["rows"]]
    assert [ln for ln in lines if "STAGE_BOUNDARY" in ln] == \
        [ln for ln in want if "STAGE_BOUNDARY" in ln]
    lines = [r[0] for r in solo.execute(sql)["resultTable"]["rows"]]
    assert any("[local]" in ln for ln in lines)


@pytest.mark.parametrize("sql", [
    "SELECT o.custkey, o.qty, ROW_NUMBER() OVER (PARTITION BY o.custkey "
    "ORDER BY o.qty) FROM orders o WHERE o.qty > 46 "
    "ORDER BY o.custkey, o.qty LIMIT 40",
    "SELECT p.category, o.price, SUM(o.qty) OVER (PARTITION BY p.category) "
    "FROM orders o JOIN parts p ON o.partkey = p.pkey WHERE o.qty = 7 "
    "ORDER BY p.category, o.price LIMIT 30",
    "SELECT o.status, o.price, RANK() OVER (PARTITION BY o.status "
    "ORDER BY o.price DESC) FROM orders o WHERE o.custkey = 3 "
    "ORDER BY o.status, o.price DESC LIMIT 20",
])
def test_window_on_mesh(join_engines, sql):
    ref, port, solo = join_engines
    full = "SET useAdvisor=false; " + sql
    same(port.execute(full), ref.execute(full), solo.execute(full),
         stats=("numDocsScanned",))


# ---------------------------------------------------------------------------
# block skip, the fused form, FIRST/LASTWITHTIME, narrow planes, K1-K3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bs_dirs(tmp_path_factory):
    from pinot_tpu.common.table_config import IndexingConfig

    rng = np.random.default_rng(29)
    n, parts = 20_000, []
    for i in range(3):
        base = i * n
        parts.append({
            "ts": (base + np.arange(n)).astype(np.int64),
            "k": np.array([f"k{(base + j) // 5000:04d}" for j in range(n)]),
            "tag": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "m": rng.integers(0, 10_000, n).astype(np.int32),
            "f": np.round(rng.uniform(0, 100, n), 3),
        })
    schema = RSchema.build(
        name="t", dimensions=[("ts", RDT.LONG), ("k", RDT.STRING),
                              ("tag", RDT.STRING)],
        metrics=[("m", RDT.INT), ("f", RDT.DOUBLE)])
    cfg = RTC(table_name="t",
              indexing=IndexingConfig(no_dictionary_columns=["ts"]))
    base = tmp_path_factory.mktemp("bsmesh")
    dirs = []
    for i, cols in enumerate(parts):
        d = str(base / f"s{i}")
        r_build(schema, cols, d, cfg, f"s{i}")
        dirs.append(d)
    return dirs


def _load(dirs, table, *engines):
    for d in dirs:
        for e in engines:
            e.add_segment(table, RefSegment(d) if isinstance(e, RefEngine)
                          else ImmutableSegment(d))
    return engines


@pytest.fixture(scope="module")
def bs_engines(bs_dirs):
    return _load(bs_dirs, "t", ref_mesh_engine(), port_engine(),
                 port_engine(mesh=False))


BS_QUERIES = [
    "SELECT COUNT(*), SUM(m) FROM t WHERE ts BETWEEN 5000 AND 5999",
    "SELECT COUNT(*), SUM(m), MIN(m), MAX(m) FROM t WHERE ts < 3000",
    "SELECT tag, COUNT(*), SUM(m) FROM t WHERE ts BETWEEN 10000 AND 30000 "
    "GROUP BY tag ORDER BY tag",
    "SELECT COUNT(*) FROM t WHERE ts < 2000 OR ts > 55000",
    "SELECT k, COUNT(*) FROM t WHERE ts BETWEEN 4000 AND 21000 "
    "GROUP BY k ORDER BY k",
    "SELECT COUNT(*), MIN(m), MAX(m) FROM t WHERE k = 'zzz'",
    "SELECT tag, DISTINCTCOUNTHLL(k), DISTINCTCOUNT(k) FROM t "
    "WHERE ts BETWEEN 100 AND 200 GROUP BY tag ORDER BY tag",
]


@pytest.mark.parametrize("sql", BS_QUERIES)
def test_blockskip_on_mesh(bs_engines, sql):
    """Each shard prunes and skips its own segments' blocks (its slice of
    ``ps_alive``, its zone maps); pruning stats sum over the shards. A
    shard picks its form (gathered or dense) by its own candidate bound,
    as the reference's shards do, so the filter's entry count follows
    the reference mesh, not the single device."""
    ref, mesh, single = bs_engines
    same(mesh.execute(sql), ref.execute(sql), single.execute(sql),
         single_stats=False)
    dense = mesh.execute("SET useBlockSkip = false; " + sql)
    assert dense["resultTable"] == mesh.execute(sql)["resultTable"]


def test_fused_form_under_each_shard(bs_engines, monkeypatch):
    _, mesh, single = bs_engines
    calls = []
    real = ps.fused_filter_agg

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ps, "fused_filter_agg", spy)
    sql = ("SET usePartialsCache=false; SELECT COUNT(*), SUM(m), MIN(m) "
           "FROM t WHERE ts BETWEEN 5000 AND 5999")
    rm = mesh.execute(sql)
    # each of the three shards holding a segment runs the fused form (the
    # pruned ones over no candidate), where one device runs it once
    assert len(calls) == 3
    assert rm["resultTable"] == single.execute(sql)["resultTable"]


@pytest.fixture(scope="module")
def k_engines(tmp_path_factory):
    """tests/test_pallas_scatter.py's mesh table: a 60-value dict key,
    int32 and int64 sums at 12,000 rows over 4 segments."""
    rng = np.random.default_rng(6)
    n, card = 12_000, 60
    cols = {
        "d": np.array([f"k{i:04d}" for i in range(card)])[
            rng.integers(0, card, n)],
        "e": np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
        "iv": rng.integers(0, 9000, n).astype(np.int32),
        "big": rng.integers(0, 1 << 38, n).astype(np.int64),
        "ts": rng.integers(0, 1 << 40, n).astype(np.int64),
    }
    schema = RSchema.build(
        name="t", dimensions=[("d", RDT.STRING), ("e", RDT.STRING)],
        metrics=[("iv", RDT.INT), ("big", RDT.LONG), ("ts", RDT.LONG)])
    base = tmp_path_factory.mktemp("kmesh")
    dirs = []
    for i in range(4):
        d = str(base / f"s{i}")
        sl = slice(i * n // 4, (i + 1) * n // 4)
        r_build(schema, {k: v[sl] for k, v in cols.items()}, d,
                RTC(table_name="t"), f"s{i}")
        dirs.append(d)
    return _load(dirs, "t", ref_mesh_engine(), port_engine(),
                 port_engine(mesh=False))


K_QUERIES = [
    "SELECT d, COUNT(*), SUM(big), MIN(iv), MAX(iv) FROM t "
    "GROUP BY d ORDER BY d LIMIT 80",
    "SELECT DISTINCTCOUNTHLL(d) FROM t WHERE e != 'z'",
    "SELECT e, LASTWITHTIME(iv, ts, 'LONG'), FIRSTWITHTIME(iv, ts, 'LONG') "
    "FROM t GROUP BY e ORDER BY e",
    "SELECT e, SUM(iv), AVG(big), MINMAXRANGE(iv) FROM t WHERE iv > 4000 "
    "GROUP BY e ORDER BY e",
]


@pytest.mark.parametrize("sql", K_QUERIES)
def test_kernel_entries_under_each_shard(k_engines, sql, monkeypatch):
    """At gate 0 every shard reaches the kernels' entries (their plain
    versions on the CPU), once each; the answer equals the single
    device's and the reference mesh's."""
    ref, mesh, single = k_engines
    calls = []
    for name in ("plane_group_sums", "group_minmax_sources"):
        real = getattr(ps, name)

        def spy(*a, _r=real, _n=name, **k):
            calls.append(_n)
            return _r(*a, **k)

        monkeypatch.setattr(ps, name, spy)
    rm = mesh.execute("SET usePartialsCache=false; " + sql)
    n_single = len(calls)
    r1 = single.execute("SET usePartialsCache=false; " + sql)
    per_single = len(calls) - n_single
    assert n_single == 4 * per_single   # one entry per shard
    same(rm, ref.execute(sql), r1, exact="AVG" not in sql)


@pytest.fixture(scope="module")
def narrow_dirs(tmp_path_factory):
    """test_narrow.py's cardinality boundaries: 255/256 and 65535/65536
    dict values, a uint8 FOR plane and a float column."""
    rng = np.random.default_rng(8)
    n = 70_000
    cols = {
        "c255": np.array([f"a{i:03d}" for i in range(255)])[
            rng.integers(0, 255, n)],
        "c256": np.array([f"b{i:03d}" for i in range(256)])[
            rng.integers(0, 256, n)],
        "c65536": (rng.permutation(n) % 65536).astype(np.int32),
        "small": rng.integers(1000, 1200, n).astype(np.int64),
        "fv": rng.uniform(-5, 5, n),
    }
    cols["c256"][:256] = [f"b{i:03d}" for i in range(256)]
    schema = RSchema.build(
        name="nw", dimensions=[("c255", RDT.STRING), ("c256", RDT.STRING),
                               ("c65536", RDT.INT)],
        metrics=[("small", RDT.LONG), ("fv", RDT.DOUBLE)])
    base = tmp_path_factory.mktemp("nwmesh")
    dirs = []
    for i in range(3):
        d = str(base / f"s{i}")
        sl = slice(i * n // 3, (i + 1) * n // 3)
        r_build(schema, {k: v[sl] for k, v in cols.items()}, d,
                RTC(table_name="nw"), f"s{i}")
        dirs.append(d)
    return dirs


NARROW_QUERIES = [
    "SELECT c255, COUNT(*), SUM(small) FROM nw GROUP BY c255 "
    "ORDER BY c255 LIMIT 300",
    "SELECT c256, MIN(small), MAX(small), SUM(fv) FROM nw "
    "WHERE c255 <> 'a007' GROUP BY c256 ORDER BY c256 LIMIT 300",
    "SELECT COUNT(*), DISTINCTCOUNT(c65536), SUM(small) FROM nw "
    "WHERE c65536 > 30000",
]


@pytest.mark.parametrize("subbyte", [False, True])
def test_narrow_planes_on_mesh(narrow_dirs, subbyte, monkeypatch):
    if subbyte:
        monkeypatch.setenv("PINOT_TPU_SUBBYTE", "1")
    ref, mesh, single = _load(narrow_dirs, "nw", ref_mesh_engine(),
                              port_engine(), port_engine(mesh=False))
    for sql in NARROW_QUERIES:
        same(mesh.execute(sql), ref.execute(sql), single.execute(sql))


# ---------------------------------------------------------------------------
# the device trim after the combine, cohorts on the mesh
# ---------------------------------------------------------------------------


TRIMMED = [
    "SELECT k1, SUM(v) FROM m GROUP BY k1 ORDER BY SUM(v) DESC LIMIT 5",
    "SELECT k1, k2, COUNT(*) FROM m GROUP BY k1, k2 "
    "ORDER BY COUNT(*) DESC, k1, k2 LIMIT 7",
    "SELECT k1, MAX(v) FROM m WHERE v < 900 GROUP BY k1 "
    "ORDER BY MAX(v), k1 LIMIT 3",
]


@pytest.mark.parametrize("sql", TRIMMED)
def test_device_trim_after_combine(m_engines, sql):
    ref, mesh, single = m_engines
    q0 = mesh.device.device_reduce_queries
    same(mesh.execute(sql), ref.execute(sql), single.execute(sql),
         exact=True)
    assert mesh.device.device_reduce_queries == q0 + 1


def _cohort(eng, sqls):
    expected = [eng.execute(s)["resultTable"] for s in sqls]
    eng.device.partials_cache_enabled = False
    co = eng.device.coalescer
    co.force, co.window_s, co.max_cohort = True, 0.05, 8
    c0 = co.queries_coalesced
    got = [None] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def worker(i):
        barrier.wait()
        got[i] = eng.execute(sqls[i])["resultTable"]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(sqls))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        co.force = False
        eng.device.partials_cache_enabled = True
    assert got == expected
    assert co.queries_coalesced > c0


@pytest.mark.parametrize("tpl", [
    "SELECT k1, COUNT(*), SUM(v), MIN(v) FROM m WHERE v > {} "
    "GROUP BY k1 ORDER BY k1",
    "SELECT k2, DISTINCTCOUNT(k1), DISTINCTCOUNTHLL(k1) FROM m "
    "WHERE v > {} GROUP BY k2 ORDER BY k2",
])
def test_cohort_on_mesh(m_engines, tpl, monkeypatch):
    """Each member-axis entry per shard, then a combine, a finalize and a
    trim per member: a cohort's answers equal its members' solo ones."""
    _, mesh, _ = m_engines
    runs = []
    real = cohort_mod.run

    def spy(*a, **k):
        runs.append(len(a[6]))
        return real(*a, **k)

    monkeypatch.setattr(cohort_mod, "run", spy)
    _cohort(mesh, [tpl.format(lit) for lit in (100, 300, 500, 700)])
    assert runs and len(runs) % 6 == 0   # every shard ran each cohort


# ---------------------------------------------------------------------------
# consuming segments beside sealed ones
# ---------------------------------------------------------------------------


def test_consuming_and_masked_parts_on_mesh(tmp_path):
    """Sealed segments shard; the consuming segment's and an
    upsert-masked segment's host parts run alone on their shard's device;
    mesh == single == the reference mesh."""
    import pinot_tpu.storage.mutable as r_mut
    from pinot_tpu_torch.common import datatypes as t_dt
    from pinot_tpu_torch.common import schema as t_schema
    from pinot_tpu_torch.storage import mutable as t_mut

    rng = np.random.default_rng(41)
    n = 3000
    cols = {"k": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)],
            "v": rng.integers(0, 500, n).astype(np.int32)}
    schema = RSchema.build(name="rt", dimensions=[("k", RDT.STRING)],
                           metrics=[("v", RDT.INT)])
    tschema = t_schema.Schema.build(
        name="rt", dimensions=[("k", t_dt.DataType.STRING)],
        metrics=[("v", t_dt.DataType.INT)])
    dirs = []
    for i in range(3):
        d = str(tmp_path / f"s{i}")
        sl = slice(i * 800, (i + 1) * 800)
        r_build(schema, {k: v[sl] for k, v in cols.items()}, d,
                RTC(table_name="rt"), f"s{i}")
        dirs.append(d)
    ref, mesh, single = _load(dirs, "rt", ref_mesh_engine(), port_engine(),
                              port_engine(mesh=False))
    valid = np.ones(800, dtype=bool)
    valid[::4] = False
    for e in (ref, mesh, single):
        seg = next(s for s in e.table("rt").segments.values()
                   if str(s.dir).endswith("s2"))
        seg.valid_docs_mask = valid
    rows = [{"k": str(cols["k"][j]), "v": int(cols["v"][j])}
            for j in range(2400, n)]
    r_ms = r_mut.MutableSegment(schema, "rt__0__0__x")
    r_ms.index_batch(rows)
    ref.add_segment("rt", r_ms)
    for e in (mesh, single):
        ms = t_mut.MutableSegment(tschema, "rt__0__0__x")
        ms.index_batch(rows)
        e.add_segment("rt", ms)
    for sql in ("SELECT k, COUNT(*), SUM(v) FROM rt GROUP BY k ORDER BY k",
                "SELECT COUNT(*), MAX(v), MIN(v) FROM rt WHERE v > 250"):
        same(mesh.execute(sql), ref.execute(sql), single.execute(sql),
             exact=True)


@pytest.fixture(scope="module")
def chunklet_engines(tmp_path_factory):
    """tests/test_torch_chunklet.py's table: a sealed segment and a
    consuming one of 22,000 rows (five 4,096-row chunklets and a tail),
    on the reference's mesh and the port's mesh and single device."""
    from test_torch_mutable import make_rows, mutable

    sealed = mutable("port", make_rows(20_000, seed=11), rows_per=4096,
                     name="sealed0").seal(
        str(tmp_path_factory.mktemp("ckmesh") / "sealed0")).dir
    rows = make_rows(22_000, seed=12)
    ref, mesh, single = ref_mesh_engine(), port_engine(), \
        port_engine(mesh=False)
    ref.table("rt").add_segment(RefSegment(sealed))
    ref.table("rt").add_segment(mutable("ref", rows, rows_per=4096,
                                        name="cons"))
    for eng in (mesh, single):
        eng.add_segment("rt", ImmutableSegment(sealed))
        eng.add_segment("rt", mutable("port", rows, rows_per=4096,
                                      name="cons"))
    return ref, mesh, single


def test_chunklet_batch_shards_on_mesh(chunklet_engines):
    """The consuming segment's clean chunklets form a batch of their own,
    which shards over the mesh like the sealed batch; the tail runs alone
    on its part's device. Rows and stats equal the reference mesh's and
    the single device's."""
    from test_torch_mutable import QUERIES

    ref, mesh, single = chunklet_engines
    for sql in QUERIES:
        same(mesh.execute(sql), ref.execute(sql), single.execute(sql))
    shards = [len(getattr(ctx, "_mesh_shards", ()))
              for ctx in mesh.device._batches.values()]
    assert 5 in shards   # the five chunklets, a shard each


# ---------------------------------------------------------------------------
# placement, the dryrun
# ---------------------------------------------------------------------------


def test_placement_check_fires_on_a_stray_tensor(m_engines, monkeypatch):
    """Two shards on distinct devices (the CPU and the meta device, which
    takes tensors without running anything): a param left on the first
    device is caught before any shard runs."""
    _, port, _ = m_engines
    eng = QueryEngine(device_executor=DeviceExecutor(
        mesh=Mesh([torch.device("cpu"), torch.device("meta")])))
    eng.device.partials_cache_enabled = False
    for seg in port.table("m").segments.values():
        eng.add_segment("m", seg)
    real = mesh_ops.shard_params

    def stray(params, lo, hi, device):
        out = real(params, lo, hi, device)
        out["ps_alive"] = params["ps_alive"][lo:hi]   # left behind
        return out

    monkeypatch.setattr(mesh_ops, "shard_params", stray)
    resp = eng.execute("SELECT k1, SUM(v) FROM m GROUP BY k1")
    msg = resp["exceptions"][0]["message"]
    assert "mesh shard 1: 'ps_alive' is on cpu" in msg and "meta" in msg
    assert mesh_ops.same_device(torch.device("cpu"), torch.device("cpu", 3))
    assert not mesh_ops.same_device(torch.device("cpu"),
                                    torch.device("meta"))


def test_shard_slices_pad_to_the_mesh():
    assert mesh_ops.shard_slices(6, 8) == [(0, 1), (1, 2), (2, 3), (3, 4),
                                           (4, 5), (5, 6), (6, 6), (6, 6)]
    assert mesh_ops.shard_slices(10, 4) == [(0, 3), (3, 6), (6, 9),
                                            (9, 10)]
    assert make_mesh(8).size == 8 and make_mesh(8).devices[0].type == "cpu"


def test_dryrun_combine_families():
    fams = dryrun.check_families(make_mesh(8))
    assert fams == ["psum(count,sum,avg)", "pmin/pmax(min,max,minmaxrange)",
                    "presence-pmax(distinctcount)", "register-pmax(hll)",
                    "time-pair(first/lastwithtime)",
                    "scalar-psum/pmin/pmax"]


def test_dryrun_hard_shapes_equal_reference_host(tmp_path):
    """The seven hard shapes: mesh == single (in ``check_hard_shapes``)
    == the reference's host engine over the same directories."""
    got = dryrun.check_hard_shapes(make_mesh(8), str(tmp_path), 8, "cpu")
    dirs = sorted(str(p) for p in tmp_path.iterdir())
    host = RefEngine(device_executor=None)
    for d in dirs:
        seg = RefSegment(d)
        if d.endswith("masked"):
            valid = np.ones(seg.n_docs, dtype=bool)
            valid[::3] = False
            seg.valid_docs_mask = valid
        host.add_segment("hard", seg)
    assert list(got) == list(dryrun.HARD_SHAPES)
    for fam, sql in dryrun.HARD_SHAPES.items():
        want = host.execute(sql)["resultTable"]["rows"]
        assert dryrun.rows_match(got[fam], want, rel=1e-4), (fam, got[fam][:3],
                                                             want[:3])


def test_dryrun_main(capsys):
    assert dryrun.main(["4"]) == 0
    assert "mesh dryrun OK" in capsys.readouterr().out
