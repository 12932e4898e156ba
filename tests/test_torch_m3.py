"""Differential tests of ROADMAP item m3's device work and its host
pieces, the port against the JAX package on the CPU, outside the replay
harness's module swap (each side imports its own package): the exchange's
hash (numpy and on the card) and wire codec both ways, a distributed join
through both packages' clusters; the tiers' ``segment_plan_bytes``, a warm
query's answer and resident bytes, ``evict_segment_dir``; the minion's
purge / merge-rollup / realtime-to-offline outputs read by both packages;
the controller's ``recommend_config`` / ``tune_table``.

Integers compare exactly; floats within test_tiering.py's
``_rows_close`` (rtol 1e-5, atol 1e-6).
"""

import numpy as np
import pytest
import torch

# ---------------------------------------------------------------------------
# differential tests of the port's exchange against the reference's
# ---------------------------------------------------------------------------

def _keys(n=4000, seed=3):
    """Key columns of every kind the hash takes: INT, LONG past 2^53,
    DOUBLE with NaN / ±0.0 / ±inf, STRING (non-ASCII and empty too)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n)
    f[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 2.0 ** 60]
    return {
        "int": rng.integers(-1000, 1000, n).astype(np.int32),
        "long": rng.integers(2 ** 53, 2 ** 62, n) * rng.choice([-1, 1], n),
        "double": f,
        "string": np.array(["", "a", "héllo", "πρ", "zz" * 9])[
            rng.integers(0, 5, n)],
    }


@pytest.mark.parametrize("kinds", [("int",), ("long",), ("double",),
                                   ("string",), ("int", "string"),
                                   ("long", "double", "string")])
def test_stable_hash64_is_the_reference_bit_for_bit(kinds):
    """The port's numpy ``stable_hash64`` and its card form (ops/join.py,
    over ``Col`` values: strings as codes into their distinct values)
    give the reference's hashes bit for bit, partition ids and the stable
    partition order with them."""
    from pinot_tpu.ops import join as r_join
    from pinot_tpu.query2 import exchange as r_ex

    from pinot_tpu_torch.ops import join as t_join
    from pinot_tpu_torch.query2 import exchange as t_ex

    keys = _keys()
    cols = [keys[k] for k in kinds]
    n = len(cols[0])
    want = r_ex.stable_hash64(cols, n)
    assert (t_ex.stable_hash64(cols, n) == want).all()
    dev_cols = []
    for c in cols:
        if c.dtype.kind == "U":
            u, codes = np.unique(c, return_inverse=True)
            dev_cols.append((torch.as_tensor(codes), u))
        else:
            dev_cols.append((torch.as_tensor(c), None))
    got = t_join.stable_hash64(dev_cols, n, "cpu")
    assert (got.numpy() == want).all()
    P = 6
    order, bounds = t_join.hash_partition_rows(got % P, P)
    for p, rows in enumerate(r_join.hash_partition_rows(want % P, P)):
        assert (order.numpy()[bounds[p]:bounds[p + 1]] == rows).all()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_wire_codec_decodes_across_packages(direction):
    """A payload encoded by either package decodes in the other: names,
    header, every column's values and dtype, the empty payload typed."""
    from pinot_tpu.query2 import exchange as r_ex

    from pinot_tpu_torch.query2 import exchange as t_ex

    enc, dec = (r_ex, t_ex) if direction == "ref_to_port" else (t_ex, r_ex)
    keys = _keys(300)
    cols = {"k": keys["int"], "l": keys["long"], "d": keys["double"],
            "s": keys["string"].astype(object)}
    for n, part in ((300, cols), (0, {c: v[:0] for c, v in cols.items()})):
        payload = enc.encode_transfer("ex1", "server_0", "a", 3, part, n)
        got = dec.decode_transfer(payload)
        assert (got["id"], got["sender"], got["alias"], got["partition"],
                got["n"], got["done"]) == ("ex1", "server_0", "a", 3, n,
                                           False)
        want = r_ex.decode_transfer(r_ex.encode_transfer(
            "ex1", "server_0", "a", 3, part, n))["cols"]
        assert list(got["cols"]) == list(want)
        for c in want:
            assert got["cols"][c].dtype == want[c].dtype
            np.testing.assert_array_equal(got["cols"][c], want[c])
    done = enc.encode_transfer("ex1", "server_1", "", -1, {}, 0, done=True,
                               expected={"a": {"3": 1}})
    got = dec.decode_transfer(done)
    assert got["done"] and got["expected"] == {"a": {"3": 1}}


_EXCHANGE_STATS = ("numDocsScanned", "numSegmentsQueried", "totalDocs",
                   "numJoinedRows", "leafRows", "joinStrategy",
                   "joinFanout", "numPartitionsShipped", "numServersQueried",
                   "numServersResponded", "numRetries", "partialResult",
                   "numSegmentsCold")


@pytest.fixture(scope="module")
def twin_clusters(tmp_path_factory):
    """test_exchange.py's two-server cluster built once by each package
    (the port's servers on the CPU, their K1 gate at 0 so every owned
    partition's sums reach the kernel's wrapper)."""
    import importlib

    from test_torch_cluster import load_replay, port_swap

    ref_mod = importlib.import_module("test_exchange")
    port_mod = load_replay("test_exchange")
    ref = ref_mod._make_cluster(tmp_path_factory.mktemp("xref"))
    with port_swap():
        port = port_mod._make_cluster(tmp_path_factory.mktemp("xport"))
    assert type(ref[3]).__module__ == "pinot_tpu.broker.broker"
    assert type(port[3]).__module__ == "pinot_tpu_torch.broker.broker"
    for s in port[2]:
        s.engine.device.min_rows = 0
    yield {"ref": ref, "port": port}
    for _reg, _ctl, servers, broker, _con in (ref, port):
        broker.close()
        for s in servers:
            s.stop()


@pytest.mark.parametrize("which", ["GROUP_SQL", "SELECT_SQL", "LEFT_SQL"])
def test_distributed_join_equals_the_reference_cluster(twin_clusters, which,
                                                       monkeypatch):
    """The same distributed join through both packages' clusters: rows,
    every count stat and each server's stage-2 rows equal; the port's
    owned partitions reach K1's wrapper for a group-by."""
    import test_exchange

    from pinot_tpu_torch.ops import group_scatter, groupby_mm

    sql = "SET joinStrategy = 'distributed'; " + getattr(test_exchange,
                                                         which)
    calls = []
    for mod, name in ((group_scatter, "plane_group_sums"),
                      (groupby_mm, "group_sums")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
    want = twin_clusters["ref"][3].execute(sql)
    got = twin_clusters["port"][3].execute(sql)
    assert not got["exceptions"] and not want["exceptions"], (got, want)
    assert got["resultTable"] == want["resultTable"]
    for key in _EXCHANGE_STATS:
        assert got.get(key) == want.get(key), (key, got.get(key),
                                               want.get(key))
    assert got["exchange"]["partitions"] == want["exchange"]["partitions"]
    assert {w: v["stage2Rows"] for w, v in got["exchange"]["servers"].items()} \
        == {w: v["stage2Rows"] for w, v in want["exchange"]["servers"].items()}
    if which != "SELECT_SQL":
        assert calls, "no owned partition's sums reached K1's wrapper"


# ---------------------------------------------------------------------------
# differential tests of the port's tiers against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """test_tiering.py's two-segment table (tag, mid, m, f)."""
    from test_tiering import _build

    return _build(tmp_path_factory.mktemp("tiers"))


def _mv_segment(base):
    """A segment with every plane kind the model prices: a dict column of
    each id width, a narrow and a wide raw integer, a float, an MV dict
    column."""
    from pinot_tpu.common.datatypes import DataType
    from pinot_tpu.common.schema import Schema
    from pinot_tpu.common.table_config import IndexingConfig, TableConfig
    from pinot_tpu.storage.creator import build_segment

    rng = np.random.default_rng(11)
    n = 70_000
    schema = Schema.build(
        name="w",
        dimensions=[("d8", DataType.STRING), ("d16", DataType.INT),
                    ("d32", DataType.LONG)],
        multi_value_dimensions=[("tags", DataType.STRING)],
        metrics=[("r8", DataType.INT), ("r64", DataType.LONG),
                 ("f", DataType.DOUBLE)])
    cols = {
        "d8": np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
        "d16": rng.integers(0, 1000, n).astype(np.int32),
        "d32": np.arange(n, dtype=np.int64) * 7,
        "tags": [list(np.array(["p", "q", "r"])[rng.integers(0, 3, k)])
                 for k in rng.integers(1, 4, n)],
        "r8": rng.integers(100, 300, n).astype(np.int32),
        "r64": rng.integers(-2 ** 40, 2 ** 40, n),
        "f": rng.uniform(0, 1, n),
    }
    cfg = TableConfig(table_name="w", indexing=IndexingConfig(
        no_dictionary_columns=["r8", "r64", "f"]))
    d = str(base / "w0")
    build_segment(schema, cols, d, cfg, "w0")
    return d


def test_segment_plan_bytes_equals_the_reference(table, tmp_path):
    """``segment_plan_bytes`` prices the port's plane widths
    (engine/params.py ColPlan), which equal the reference's, so its
    figures equal the reference's on the same segments."""
    from pinot_tpu.server import tiering as r_tiering
    from pinot_tpu.storage.segment import ImmutableSegment as RefSegment

    from pinot_tpu_torch.server import tiering as t_tiering
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    dirs = [s.dir for s in table[2]] + [_mv_segment(tmp_path)]
    for d in dirs:
        want = r_tiering.segment_plan_bytes(RefSegment(d))
        assert t_tiering.segment_plan_bytes(ImmutableSegment(d)) == want
        assert want > 0


@pytest.mark.parametrize("sql", [
    "SELECT tag, COUNT(*), SUM(m), MIN(m), MAX(m) FROM tiers "
    "GROUP BY tag ORDER BY tag",
    "SELECT COUNT(*), SUM(m) FROM tiers WHERE mid < 150",
    "SELECT mid, SUM(m) FROM tiers WHERE tag = 'c' GROUP BY mid "
    "ORDER BY mid LIMIT 10",
])
def test_warm_segments_run_on_the_device_and_leave_no_planes(table, sql,
                                                           monkeypatch):
    """Warm segments (``LazySegmentView``) run in the host path's shape on
    the port's device, a group-by's sums through K1's wrapper at
    ``min_rows = 0``; their planes live for the query only: resident
    bytes and cached batches are the same after the query as before it,
    and the answer equals the reference's warm engine's exactly
    (integers)."""
    from pinot_tpu.engine.engine import QueryEngine as RefEngine
    from pinot_tpu.server.tiering import LazySegmentView as RefLazy

    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.ops import group_scatter, groupby_mm
    from pinot_tpu_torch.server.tiering import LazySegmentView

    dirs = [s.dir for s in table[2]]
    eng = QueryEngine(device="cpu")
    eng.device.min_rows = 0
    eng.device.partials_cache_enabled = False
    for d in dirs:
        eng.add_segment("tiers", LazySegmentView(d))
    ref = RefEngine()
    for d in dirs:
        ref.add_segment("tiers", RefLazy(d))
    calls = []
    for mod, name in ((group_scatter, "plane_group_sums"),
                      (groupby_mm, "group_sums")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
    before = eng.device.hbm_stats()
    got = eng.execute(sql)
    after = eng.device.hbm_stats()
    want = ref.execute(sql)
    assert not got["exceptions"], got
    assert got["resultTable"]["rows"] == want["resultTable"]["rows"]
    assert got["numDocsScanned"] == want["numDocsScanned"]
    assert after["resident_bytes"] == before["resident_bytes"] == 0
    assert after["cached_batches"] == before["cached_batches"] == 0
    if "GROUP BY" in sql:
        assert calls, "the warm scan's group sums did not reach K1's wrapper"


def test_evict_segment_dir_drops_the_segments_batches(table):
    """A hot segment's batch leaves the LRU when the segment is demoted
    (``DeviceExecutor.evict_segment_dir``), and its bytes with it."""
    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    eng = QueryEngine(device="cpu")
    eng.device.min_rows = 0
    for s in table[2]:
        eng.add_segment("tiers", ImmutableSegment(s.dir))
    eng.execute("SELECT tag, SUM(m) FROM tiers GROUP BY tag")
    assert eng.device.hbm_stats()["resident_bytes"] > 0
    assert eng.device.evict_segment_dir(table[2][0].dir) == 1
    stats = eng.device.hbm_stats()
    assert stats["cached_batches"] == 0 and stats["resident_bytes"] == 0
    assert eng.device.evict_segment_dir(table[2][0].dir) == 0


# ---------------------------------------------------------------------------
# the minion: each task's output read by both packages
# ---------------------------------------------------------------------------

def _side_module(side: str, name: str):
    import contextlib
    import importlib

    from test_torch_cluster import load_replay, port_swap

    if side == "ref":
        return importlib.import_module(name), contextlib.nullcontext()
    return load_replay(name), port_swap()


def _rt2o_table(mod, controller):
    """test_minion.py's realtime-to-offline table, its 250 events
    published (buckets of ts 0..99, 1000..1099, 2000..2049)."""
    mod.TopicRegistry.delete("events")
    topic = mod.TopicRegistry.create("events", 1)
    schema = mod.Schema.build(
        name="events", dimensions=[("kind", mod.DataType.STRING)],
        metrics=[("v", mod.DataType.INT)],
        datetimes=[("ts", mod.DataType.LONG)])
    controller.add_table(mod.TableConfig(table_name="events",
                                         time_column="ts"), schema)
    controller.add_table(mod.TableConfig(
        table_name="events", table_type=mod.TableType.REALTIME,
        time_column="ts",
        stream=mod.StreamConfig(
            stream_type="memory", topic="events", decoder="json",
            segment_flush_threshold_rows=50,
            segment_flush_threshold_seconds=3600),
        task_configs={"RealtimeToOfflineSegmentsTask": {
            "bucket_ms": 1000, "buffer_ms": 0}}), schema)
    for ts in (list(range(100)) + list(range(1000, 1100))
               + list(range(2000, 2050))):
        topic.publish_json({"kind": f"k{ts % 3}", "v": 1, "ts": ts})


def _committed_rows(mod, registry, table: str) -> int:
    """Rows of ``table``'s committed segments: ONLINE, with their
    deep-store copy."""
    return sum(r.n_docs for r in registry.segments(table).values()
               if r.state == mod.SegmentState.ONLINE and r.location)


def _run_task(side: str, tmp, task: str) -> list:
    """One minion task through ``side``'s cluster (test_minion.py's
    fixture and tables; the port's on the CPU) → the output segments'
    directories in its deep store."""
    mod, swap = _side_module(side, "test_minion")
    with swap:
        gen = mod.cluster.__wrapped__(tmp)
        registry, controller, _servers, broker, minion = next(gen)
        try:
            if task == "rt2o":
                _rt2o_table(mod, controller)
                table = "events_OFFLINE"
                # the task reads committed segments only: wait until all
                # 250 rows are committed (in as many segments as the
                # consumer's batches made), not for rows that a consuming
                # segment answers
                assert mod.wait_until(lambda: _committed_rows(
                    mod, registry, "events_REALTIME") == 250, 20)
                assert mod.wait_until(lambda: mod._rows(
                    broker, "SELECT COUNT(*) FROM events") == [[250]], 20)
                now_ms = 10_000
            else:
                mod._sales_table(tmp, controller, {
                    "purge": {"PurgeTask": {"filter": "deleted = 1"}},
                    "concat": {"MergeRollupTask": {
                        "max_docs_per_segment": 10_000}},
                    "rollup": {"MergeRollupTask": {
                        "mode": "rollup", "max_docs_per_segment": 10_000}},
                }[task])
                table = "sales_OFFLINE"
                assert mod.wait_until(
                    lambda: len(registry.external_view(table)) == 4)
                now_ms = None
            assert controller.run_task_generation(now_ms=now_ms)
            done = minion.run_one()
            assert done is not None and done["state"] == "DONE", done
            return sorted(rec.location
                          for rec in registry.segments(table).values())
        finally:
            next(gen, None)


_MINION_SQL = {
    "sales": ["SELECT region, COUNT(*), SUM(amount), SUM(deleted) FROM t "
              "GROUP BY region ORDER BY region",
              "SELECT COUNT(*), MIN(amount), MAX(amount) FROM t",
              "SELECT region, amount, deleted FROM t "
              "ORDER BY region, amount, deleted LIMIT 25"],
    "events": ["SELECT kind, COUNT(*), SUM(v), MIN(ts), MAX(ts) FROM t "
               "GROUP BY kind ORDER BY kind",
               "SELECT COUNT(*) FROM t"],
}


@pytest.mark.parametrize("task", ["purge", "concat", "rollup", "rt2o"])
def test_minion_outputs_answer_as_the_references(task, tmp_path):
    """The same task through both packages' clusters: each output is
    readable by both packages, and every reader answers every query the
    same over either package's outputs (the purge's mask ran through the
    port's filter lowering on the worker's device)."""
    from pinot_tpu.engine.engine import QueryEngine as RefEngine
    from pinot_tpu.storage.segment import ImmutableSegment as RefSegment

    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    outs = {side: _run_task(side, tmp_path / side, task)
            for side in ("ref", "port")}
    assert len(outs["ref"]) == len(outs["port"]) >= 1
    sqls = _MINION_SQL["events" if task == "rt2o" else "sales"]
    answers = []
    for side in ("ref", "port"):
        for reader in ("ref", "port"):
            eng = RefEngine() if reader == "ref" else QueryEngine(device="cpu")
            seg_cls = RefSegment if reader == "ref" else ImmutableSegment
            for d in outs[side]:
                eng.add_segment("t", seg_cls(d))
            answers.append([eng.execute(q)["resultTable"]["rows"]
                            for q in sqls])
    assert all(a == answers[0] for a in answers[1:]), answers


# ---------------------------------------------------------------------------
# the controller's config advisor and table tuner
# ---------------------------------------------------------------------------

def _plain(v):
    """A recommendation as plain data (configs through their JSON form)."""
    import dataclasses

    if dataclasses.is_dataclass(v):
        return _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("queries", [
    ["SELECT SUM(clicks) FROM ads WHERE city = 'nyc'",
     "SELECT COUNT(*) FROM ads WHERE city IN ('sf', 'la')",
     "SELECT SUM(cost) FROM ads WHERE clicks BETWEEN 10 AND 90",
     "SELECT COUNT(*) FROM ads WHERE clicks > 5 AND city = 'mia'",
     "SELECT city, tier, SUM(clicks), COUNT(*) FROM ads GROUP BY city, tier",
     "SELECT tier, city, COUNT(*), SUM(clicks) FROM ads GROUP BY tier, city",
     "SELECT COUNT(*) FROM ads WHERE REGEXP_LIKE(url, 'checkout')"],
    ["NOT SQL AT ALL", "SELECT COUNT(*) FROM ads WHERE tier = 'gold'"],
], ids=["workload", "unparsable"])
def test_recommend_config_is_the_references(queries, tmp_path):
    """``Controller.recommend_config`` gives the reference's config, its
    rationale included, on the same schema and queries."""
    out = {}
    for side in ("ref", "port"):
        mod, swap = _side_module(side, "test_controller_longtail")
        with swap:
            schema = mod.Schema.build(
                name="ads",
                dimensions=[("city", mod.DataType.STRING),
                            ("tier", mod.DataType.STRING),
                            ("url", mod.DataType.STRING)],
                metrics=[("clicks", mod.DataType.LONG),
                         ("cost", mod.DataType.DOUBLE)])
            ctl = mod.Controller(mod.ClusterRegistry(),
                                 str(tmp_path / side))
            out[side] = _plain(ctl.recommend_config(schema, queries,
                                                    qps=200))
    assert out["port"] == out["ref"]


def test_tune_table_is_the_references(tmp_path):
    """``Controller.tune_table`` grows the reference's config from the
    same segment's stats, and the second run changes nothing."""
    out = {}
    for side in ("ref", "port"):
        mod, swap = _side_module(side, "test_controller_longtail")
        with swap:
            reg = mod.ClusterRegistry()
            ctl = mod.Controller(reg, str(tmp_path / side / "ds"))
            server = mod.ServerInstance("s0", reg, str(tmp_path / side / "srv"),
                                        device_executor=None)
            server.start()
            schema = mod.Schema.build(
                name="t", dimensions=[("low", mod.DataType.STRING),
                                      ("high", mod.DataType.STRING)],
                metrics=[("v", mod.DataType.INT)])
            cfg = mod.TableConfig(table_name="t")
            ctl.add_table(cfg, schema)
            n = 5000
            rng = np.random.default_rng(3)
            d = str(tmp_path / side / "seg")
            mod.build_segment(schema, {
                "low": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
                "high": np.asarray([f"id_{i}" for i in range(n)]),
                "v": rng.integers(0, 10, n).astype(np.int32)}, d, cfg, "s0")
            ctl.upload_segment("t", d)
            first = _plain(ctl.tune_table("t"))
            out[side] = (first, _plain(ctl.tune_table("t")),
                         _plain(reg.table_config("t_OFFLINE").indexing))
            server.stop()
    assert out["port"] == out["ref"]
    assert out["port"][0]["changes"] and out["port"][1]["changes"] == []
