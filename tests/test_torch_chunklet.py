"""The port's chunklet path (realtime/chunklet.py) against the
reference's, after tests/test_chunklet.py: promotion boundaries and the
crossover threshold; tests/test_chunklet.py's QUERIES over a table of a
sealed segment, a consuming segment's chunklets and its tail, also under
upsert masks, rows and every stat equal to the reference's engine;
answers taken while a writer thread ingests, each equal to the oracle at
one published doc count; the block-skip stats of
tests/test_blockskip.py::TestConsumingSegments; the invalidation hook
reaching the port's executor; and a tail's context kept out of the batch
LRU."""

import sys
import threading

import numpy as np
import pytest

import pinot_tpu.realtime.upsert as r_ups
import pinot_tpu_torch.realtime.upsert as t_ups
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import device as t_device
from pinot_tpu_torch.ops import blockskip as bs
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.realtime import chunklet as t_chunklet
from pinot_tpu_torch.realtime.chunklet import split_for_query
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_mutable import (
    MODS,
    MORE_QUERIES,
    QUERIES,
    engines,
    make_rows,
    mutable,
    pair,
    same,
    schema,
)


def test_promotion_boundaries():
    seg = mutable("port", make_rows(1023), rows_per=1024, promote=False)
    ci = seg.chunklet_index
    assert ci.promote() == 0  # one short of a block
    seg.index_batch(make_rows(1))
    assert ci.promote() == 1
    assert ci.frozen_docs == 1024
    seg.index_batch(make_rows(5000))
    assert ci.promote() == 4
    assert ci.chunklets[-1].stop == 5120
    ck = ci.chunklets[0]
    assert ck.n_docs == 1024
    assert ck.column_metadata("zone").cardinality > 0
    np.testing.assert_array_equal(ck.flat_values("fare"),
                                  np.asarray(seg._cols["fare"].values(1024)))
    # the reference seals the same blocks: metadata, ids and dictionaries
    ref = mutable("ref", make_rows(1023) + make_rows(1) + make_rows(5000),
                  rows_per=1024)
    for a, b in zip(ci.chunklets, ref.chunklet_index.chunklets):
        assert (a.name, a.dir, a.start, a.stop) == \
            (b.name, b.dir, b.start, b.stop)
        for col in ("zone", "hour", "fare", "ts"):
            np.testing.assert_array_equal(a.forward(col), b.forward(col))
            ma, mb = a.column_metadata(col), b.column_metadata(col)
            assert (ma.encoding, ma.cardinality, ma.min_value,
                    ma.max_value, ma.has_null_vector) == \
                (mb.encoding, mb.cardinality, mb.min_value, mb.max_value,
                 mb.has_null_vector)
            np.testing.assert_array_equal(a.zone_map(col), b.zone_map(col))


def test_crossover_threshold_gates_split():
    seg = mutable("port", make_rows(4096, with_nulls=False), rows_per=1024,
                  min_rows=10_000)
    assert split_for_query(seg) is None  # frozen 4096 < 10_000
    seg.index_batch(make_rows(8000, with_nulls=False))
    seg.chunklet_index.promote()
    device, host = split_for_query(seg)
    assert sum(c.n_docs for c in device) == 11 * 1024
    assert [type(h).__name__ for h in host] == ["MutableTailView"]
    assert sum(h.n_docs for h in host) == seg.n_docs - 11 * 1024


@pytest.fixture(scope="module")
def sealed_dir(tmp_path_factory):
    rows = make_rows(20_000, seed=11)
    seg = mutable("port", rows, rows_per=4096, name="sealed0")
    return seg.seal(str(tmp_path_factory.mktemp("ck") / "sealed0")).dir


def _mixed(sealed_dir, n=22_000, rows_per=4096):
    """Reference and port engines over one sealed segment and a consuming
    segment of ``n`` rows (chunklets of ``rows_per`` and a tail)."""
    ref_seg, port_seg = pair(mutable, rows=make_rows(n, seed=12),
                             rows_per=rows_per, name="cons")
    assert split_for_query(port_seg) is not None
    ref, port = engines([RefSegment(sealed_dir), ref_seg],
                        [ImmutableSegment(sealed_dir), port_seg])
    return ref, port, port_seg


@pytest.mark.parametrize("sql", QUERIES + MORE_QUERIES)
def test_sealed_chunklets_and_tail(sealed_dir, sql):
    ref, port, seg = _mixed(sealed_dir)
    assert len(seg.chunklet_index.chunklets) == 5
    same(port.execute(sql), ref.execute(sql))


@pytest.mark.parametrize("sql", QUERIES[:3])
def test_partials_cache_and_trim_off(sealed_dir, sql):
    ref, port, _seg = _mixed(sealed_dir)
    opts = "SET usePartialsCache = false; SET useDeviceReduce = false; "
    want = ref.execute(sql)
    same(port.execute(opts + sql), want)
    same(port.execute(sql), want)


def _upsert_segment(side, rows, late, with_chunklets):
    sc, dt, tc, mut = MODS[side]
    ups = (r_ups if side == "ref" else t_ups).PartitionUpsertMetadataManager
    cfg = tc.TableConfig(
        table_name="rt",
        upsert=tc.UpsertConfig(mode="FULL", comparison_column="ts"),
        chunklets=tc.ChunkletConfig(enabled=with_chunklets,
                                    rows_per_chunklet=1024,
                                    device_min_rows=0))
    seg = mut.MutableSegment(schema(sc, dt, pk=True), "s", cfg,
                             enable_upsert=True)
    mgr = ups("ts")
    for batch in (rows, late):
        for r in batch:
            did = seg.index(r)
            mgr.add_record(seg, did, (r["zone"],), r["ts"])
        if seg.chunklet_index is not None:
            seg.chunklet_index.promote()
    return seg


def _upsert_rows():
    rng = np.random.default_rng(9)
    n = 40_000
    rows = [{"zone": f"z{int(rng.integers(0, 25_000)):05d}",
             "hour": int(rng.integers(0, 24)),
             "fare": int(rng.integers(0, 1000)), "ts": i} for i in range(n)]
    # late updates: invalidations land INSIDE the frozen prefix
    late = [{"zone": f"z{i % 25_000:05d}", "hour": 0, "fare": 99_999,
             "ts": n + i} for i in range(3000)]
    return rows, late


UPSERT_QUERIES = QUERIES[:3] + [
    "SELECT COUNT(*) FROM rt WHERE fare = 99999",
    "SELECT hour, COUNT(*), MAX(fare) FROM rt WHERE ts > 1000 "
    "GROUP BY hour ORDER BY hour LIMIT 30",
    "SELECT zone, fare, ts FROM rt WHERE hour = 0 ORDER BY ts DESC LIMIT 5",
]


@pytest.fixture(scope="module")
def upsert_engines():
    rows, late = _upsert_rows()
    ref_seg, port_seg = pair(_upsert_segment, rows=rows, late=late,
                             with_chunklets=True)
    cks = port_seg.chunklet_index.chunklets
    dirty = sum(not c.is_clean for c in cks)
    assert 0 < dirty < len(cks)  # masks engaged, clean blocks remain
    ref, port = engines([ref_seg], [port_seg])
    return ref, port


@pytest.mark.parametrize("sql", UPSERT_QUERIES)
def test_upsert_masks_over_chunklets(upsert_engines, sql):
    ref, port = upsert_engines
    same(port.execute(sql), ref.execute(sql))


def test_upsert_answers_equal_an_unsplit_segment(upsert_engines):
    rows, late = _upsert_rows()
    plain = _upsert_segment("port", rows, late, with_chunklets=False)
    _ref, whole = engines([], [plain])
    _ref, port = upsert_engines
    for sql in UPSERT_QUERIES:
        assert port.execute(sql)["resultTable"]["rows"] == \
            whole.execute(sql)["resultTable"]["rows"], sql


def test_answers_while_ingesting_match_one_snapshot():
    """Each answer taken while a writer indexes batches and promotes
    equals the oracle at one published count between the counts read
    just before and just after the query."""
    batches = [make_rows(512, seed=100 + i, with_nulls=False)
               for i in range(60)]
    for i, b in enumerate(batches):
        for j, r in enumerate(b):
            r["ts"] = i * 512 + j
    fare = np.concatenate([[r["fare"] for r in b] for b in batches])
    hour = np.concatenate([[r["hour"] for r in b] for b in batches])
    csum = np.concatenate([[0], np.cumsum(fare)])
    seg = mutable("port", batches[0], rows_per=1024)
    _ref, eng = engines([], [seg])
    done = threading.Event()
    errors = []

    def ingest():
        try:
            for b in batches[1:]:
                seg.index_batch(b)
                seg.chunklet_index.promote()
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))
        finally:
            done.set()

    t = threading.Thread(target=ingest)
    t.start()
    answers = 0
    while not done.is_set() or answers < 3:
        lo = seg.n_docs
        r = eng.execute("SELECT COUNT(*), SUM(fare), MAX(ts) FROM rt")
        g = eng.execute("SELECT hour, COUNT(*) FROM rt WHERE hour < 3 "
                        "GROUP BY hour ORDER BY hour")
        hi = seg.n_docs
        assert r["exceptions"] == [] and g["exceptions"] == [], (r, g)
        c, s, mx = r["resultTable"]["rows"][0]
        assert lo <= c <= hi and c % 512 == 0
        assert s == csum[c] and mx == c - 1
        gc = g["resultTable"]["rows"]
        assert sum(n for _h, n in gc) <= hi
        k = sum(n for _h, n in gc)
        assert any(k == int((hour[:m] < 3).sum())
                   for m in range(lo, hi + 1, 512) if m >= lo), (lo, hi, k)
        answers += 1
    t.join()
    assert not errors, errors
    r = eng.execute("SELECT COUNT(*), SUM(fare) FROM rt")
    assert r["resultTable"]["rows"] == [[60 * 512, int(csum[-1])]]


BLOCKSKIP_SQL = (
    "SELECT COUNT(*), SUM(m) FROM rt WHERE ts BETWEEN 3000 AND 3999",
    "SELECT tag, COUNT(*) FROM rt WHERE ts < 2500 GROUP BY tag ORDER BY tag",
    "SELECT COUNT(*) FROM rt WHERE ts BETWEEN 8192 AND 12287 AND tag = 'b'",
    "SELECT COUNT(*), SUM(m) FROM rt WHERE ts >= 39000",
)


def _blockskip_segment(side):
    sc, dt, tc, mut = MODS[side]
    DT = dt.DataType
    schema_ = sc.Schema.build(name="rt", dimensions=[("ts", DT.LONG),
                                                     ("tag", DT.STRING)],
                              metrics=[("m", DT.INT)])
    cfg = tc.TableConfig(
        table_name="rt",
        indexing=tc.IndexingConfig(no_dictionary_columns=["ts"]),
        chunklets=tc.ChunkletConfig(enabled=True, rows_per_chunklet=8192,
                                    device_min_rows=8192))
    rng = np.random.default_rng(41)
    n = 40_000
    tags = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    ms = rng.integers(0, 1000, n)
    rows = [{"ts": int(i), "tag": str(t), "m": int(v)}
            for i, (t, v) in enumerate(zip(tags, ms))]
    seg = mut.MutableSegment(schema_, "rt__0__0__0", cfg)
    for i in range(0, n, 8192):
        seg.index_batch(rows[i:i + 8192])
        seg.chunklet_index.promote()
    return seg


@pytest.mark.parametrize("sql", BLOCKSKIP_SQL)
def test_chunklet_batch_prunes_blocks(sql, monkeypatch):
    seen = []
    fused, gather = ps.fused_filter_agg, bs.gather_blocks
    monkeypatch.setattr(ps, "fused_filter_agg",
                        lambda *a, **k: seen.append("fused") or fused(*a, **k))
    monkeypatch.setattr(bs, "gather_blocks",
                        lambda *a, **k: seen.append("gather")
                        or gather(*a, **k))
    ref_seg, port_seg = pair(_blockskip_segment)
    assert len(port_seg.chunklet_index.chunklets) == 4
    ref, port = engines([ref_seg], [port_seg])
    want = ref.execute(sql)
    got = port.execute(sql)
    same(got, want)
    if "39000" in sql:
        # only the tail holds such rows: the pruner drops every chunklet
        assert got["numSegmentsPrunedByServer"] == 4
    else:
        assert got["numBlocksPruned"] > 0  # the chunklets' zone maps
        assert seen  # the chunklet batch took a block-skip form
    dense = port.execute("SET useBlockSkip = false; " + sql)
    assert dense["resultTable"]["rows"] == got["resultTable"]["rows"]


def test_time_range_takes_the_fused_form(monkeypatch):
    seen = []
    fused = ps.fused_filter_agg
    monkeypatch.setattr(ps, "fused_filter_agg",
                        lambda *a, **k: seen.append(1) or fused(*a, **k))
    _ref, port = engines([], [_blockskip_segment("port")])
    r = port.execute(BLOCKSKIP_SQL[0])
    assert r["exceptions"] == [] and seen == [1]


def test_promotion_dirtying_and_seal_drop_the_ports_partials(tmp_path):
    assert t_chunklet._invalidate_device_partials.__code__.co_consts \
        and "pinot_tpu_torch.engine.device" in \
        t_chunklet._invalidate_device_partials.__code__.co_consts
    assert sys.modules.get("pinot_tpu_torch.engine.device") is t_device
    seg = mutable("port", make_rows(3000, with_nulls=False), rows_per=1024)
    _ref, eng = engines([], [seg])
    eng.device.partials_cache_enabled = True
    sql = "SELECT COUNT(*), SUM(fare) FROM rt"

    def entries():
        return eng.device.hbm_stats()["partials_cache_entries"]

    eng.execute(sql)
    assert entries() == 1
    assert eng.execute(sql)["partialsCacheHit"]
    seg.index_batch(make_rows(1024, seed=3, with_nulls=False))
    assert seg.chunklet_index.promote() == 1
    assert entries() == 0  # promotion dropped it
    r = eng.execute(sql)
    assert not r["partialsCacheHit"] and r["resultTable"]["rows"][0][0] \
        == 4024
    assert entries() == 1
    seal = seg.seal(str(tmp_path / "s"))
    assert entries() == 0 and seal.n_docs == 4024


def test_dirtying_a_chunklet_drops_its_partials():
    rows = [{"zone": f"z{i:05d}", "hour": i % 24, "fare": i, "ts": i}
            for i in range(8000)]  # unique keys: every chunklet clean
    seg = _upsert_segment("port", rows, [], with_chunklets=True)
    assert all(c.is_clean for c in seg.chunklet_index.chunklets)
    _ref, eng = engines([], [seg])
    eng.device.partials_cache_enabled = True
    eng.execute("SELECT COUNT(*) FROM rt")
    assert eng.device.hbm_stats()["partials_cache_entries"] == 1
    seg.invalidate(5)   # inside the first chunklet: it turns dirty
    assert not seg.chunklet_index.chunklets[0].is_clean
    assert eng.device.hbm_stats()["partials_cache_entries"] == 0
    r = eng.execute("SELECT COUNT(*) FROM rt")
    assert r["resultTable"]["rows"] == [[7999]]


def test_tail_context_never_enters_the_lru():
    seg = mutable("port", make_rows(3000), rows_per=1024)
    _ref, eng = engines([], [seg])
    dev = eng.device
    for i in range(3):
        seg.index_batch(make_rows(100, seed=20 + i))   # the tail grows
        r = eng.execute("SELECT zone, COUNT(*) FROM rt GROUP BY zone "
                        "ORDER BY zone LIMIT 3")
        assert r["exceptions"] == []
        keys = [k for key in dev._batches for k in key]
        assert keys and all(k.startswith("<chunklet:") for k in keys)
        assert len(dev._batches) == 1  # one chunklet set: one batch
        assert dev.inflight == 0 and dev._inflight_launches == {}
    assert dev.batch_misses == 1


@pytest.mark.parametrize("sql", QUERIES + MORE_QUERIES[:3])
def test_explain_over_a_split_consuming_segment(sealed_dir, sql):
    """EXPLAIN renders the reference's lines for a table with a split
    consuming segment; only the backend label differs."""
    from test_torch_explain import _lines, _ported

    ref, port, _seg = _mixed(sealed_dir)
    want = ref.execute("EXPLAIN PLAN FOR " + sql)
    got = port.execute("EXPLAIN PLAN FOR " + sql)
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert _lines(got) == _ported(_lines(want))


@pytest.mark.parametrize("payload", ["rows", "json"])
def test_ingest_worker_reports_its_rows(payload):
    """The per-partition consume loop (the multi-partition ingest
    harness) runs standalone over the in-memory stream and reports its
    rows/s."""
    rep = t_chunklet.ingest_worker_main(
        {"rows": 30_000, "partition": 3, "rows_per_chunklet": 8192,
         "payload": payload})
    assert rep["rows"] == 30_000 and rep["errors"] == 0
    assert rep["chunklets"] == 30_000 // 8192 and rep["rows_per_s"] > 0
