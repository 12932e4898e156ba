"""The port's realtime consume loop (realtime/manager.py over the
in-memory stream) against the reference's, after tests/test_realtime.py:
consume, query and commit; restart from the checkpoint; a flaky consumer
that loses nothing; FULL upsert (the latest record wins, out-of-order
rows are ignored, a restart reconciles, upsert survives a commit);
PARTIAL upsert's strategies; orphan quarantine.

Each test runs the same stream through both packages: a ``Twin`` holds
a reference manager over the reference's engine and a port manager over
``QueryEngine(device="cpu")``, each on its own in-memory topic. A phase
publishes its messages to both topics at once (under each topic's lock,
so every fetch sees all of a phase or none of it, and both consume loops
cut the same segments), waits until both have consumed them, and holds
the port's answer to the reference's: rows, and every stat while both
tables hold the same segments."""

import json
import os
import shutil
import time

import pytest

import pinot_tpu.common.datatypes as r_dt
import pinot_tpu.common.schema as r_schema
import pinot_tpu.common.table_config as r_tc
import pinot_tpu.realtime.manager as r_mgr
import pinot_tpu.stream.memory_stream as r_ms
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.common import datatypes as t_dt
from pinot_tpu_torch.common import schema as t_schema
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.realtime import manager as t_mgr
from pinot_tpu_torch.realtime.merger import STRATEGIES, PartialUpsertMerger
from pinot_tpu_torch.stream import memory_stream as t_ms
from pinot_tpu_torch.stream.spi import get_decoder
from test_torch_mutable import same

SIDES = {"ref": (r_schema, r_dt, r_tc, r_mgr, r_ms),
         "port": (t_schema, t_dt, t_tc, t_mgr, t_ms)}


def make_schema(side, pk=False):
    sc, dt = SIDES[side][:2]
    DT = dt.DataType
    return sc.Schema.build(
        name="events",
        dimensions=[("user", DT.STRING), ("action", DT.STRING)],
        metrics=[("amount", DT.INT)],
        datetimes=[("ts", DT.LONG)],
        primary_key_columns=["user"] if pk else [],
    )


def wait_until(cond, timeout=20.0, interval=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(interval)
    return False


class Twin:
    """One stream consumed by the reference's manager and the port's."""

    def __init__(self, tmp_path, topic, n_partitions=1, flush_rows=10_000,
                 upsert=None, cmp_col="ts", strategies=None):
        self.tmp_path, self.topic_name = tmp_path, topic
        self.n_partitions = n_partitions
        self.upsert, self.cmp_col = upsert, cmp_col
        self.strategies, self.flush_rows = strategies or {}, flush_rows
        self.topics = {}
        for side, mods in SIDES.items():
            reg = mods[4].TopicRegistry
            reg.delete(topic)
            self.topics[side] = reg.create(topic, n_partitions)
        self.engines, self.mgrs = {}, {}
        self.restart()

    def config(self, side):
        tc = SIDES[side][2]
        up = tc.UpsertConfig()
        if self.upsert is not None:
            up = tc.UpsertConfig(
                mode=self.upsert, comparison_column=self.cmp_col,
                partial_upsert_strategies=dict(self.strategies))
        return tc.TableConfig(
            table_name="events", table_type=tc.TableType.REALTIME,
            upsert=up,
            stream=tc.StreamConfig(
                stream_type="memory", topic=self.topic_name, decoder="json",
                segment_flush_threshold_rows=self.flush_rows,
                segment_flush_threshold_seconds=3600))

    def restart(self):
        """New engines and managers over the same data dirs and topics."""
        for side in SIDES:
            if side == "ref":
                eng = RefEngine()
            else:
                eng = QueryEngine(device="cpu")
                eng.device.min_rows = 0
            mgr = SIDES[side][3].RealtimeTableDataManager(
                make_schema(side, pk=self.upsert is not None),
                self.config(side), eng.table("events"),
                str(self.tmp_path / side))
            self.engines[side], self.mgrs[side] = eng, mgr

    def start(self):
        for m in self.mgrs.values():
            m.start()

    def stop(self, commit_remaining=False):
        for m in self.mgrs.values():
            m.stop(commit_remaining=commit_remaining)

    def publish(self, rows, partition=None):
        """Every row of a phase to both topics, each topic's rows appended
        under its lock in one step."""
        for topic in self.topics.values():
            with topic._lock:
                for i, r in enumerate(rows):
                    p = partition if partition is not None \
                        else i % self.n_partitions
                    topic._partitions[p].append(json.dumps(r).encode())

    def consumed(self):
        """Every published message indexed, dropped or committed."""
        def done(mgr, topic):
            for p, pm in mgr.partition_managers.items():
                if pm._offset.value < topic.log_size(p):
                    return False
            return True
        return all(done(self.mgrs[s], self.topics[s]) for s in SIDES)

    def quiescent(self):
        """Consumed, and no commit in flight or due on either side: a
        partition manager advances its offset before it commits, so
        ``consumed()`` alone holds while a commit is still under way."""
        if not self.consumed():
            return False
        return not any(
            pm.state == pm.COMMITTING
            or pm.segment.n_docs >= pm.rows_threshold
            for s in SIDES
            for pm in self.mgrs[s].partition_managers.values())

    def wait(self, cond=None, timeout=60.0):
        """Poll, without asserting, until both sides are quiescent and
        ``cond()`` holds; ``check`` then compares them."""
        assert wait_until(lambda: self.quiescent()
                          and (cond is None or cond())
                          and self.quiescent(), timeout)

    def counts(self, sql="SELECT COUNT(*) FROM events"):
        """Each side's first value, for a wait's condition (no assert)."""
        return [self.engines[s].execute(sql)["resultTable"]["rows"][0][0]
                for s in SIDES]

    def layout(self, side):
        tdm = self.engines[side].tables["events"]
        return [(s.name, s.n_docs) for s in tdm.segments.values()]

    def check(self, sql):
        want = self.engines["ref"].execute(sql)
        got = self.engines["port"].execute(sql)
        if self.layout("ref") == self.layout("port"):
            same(got, want)
        else:  # a commit in flight on one side: the rows still agree
            assert got["resultTable"]["rows"] == \
                want["resultTable"]["rows"], (sql, got, want)
        return got["resultTable"]["rows"]

    def commits(self, side="port"):
        return sum(m.commits for m in self.mgrs[side].partition_managers
                   .values())


def _count(twin):
    return twin.check("SELECT COUNT(*) FROM events")[0][0]


CHECKS = [
    "SELECT COUNT(*) FROM events",
    "SELECT user, COUNT(*), SUM(amount) FROM events GROUP BY user "
    "ORDER BY user LIMIT 20",
    "SELECT action, MAX(ts), MIN(amount) FROM events WHERE amount > 3 "
    "GROUP BY action ORDER BY action",
    "SELECT user, action, amount, ts FROM events ORDER BY ts DESC LIMIT 6",
]


def test_consume_query_commit(tmp_path):
    tw = Twin(tmp_path, "tt_consume", n_partitions=2, flush_rows=150)
    tw.publish([{"user": f"u{i % 10}", "action": "view", "amount": i % 50,
                 "ts": i} for i in range(500)])
    tw.start()
    try:
        tw.wait(lambda: tw.commits("ref") >= 2 and tw.commits() >= 2)
        assert _count(tw) == 500
        for sql in CHECKS:
            tw.check(sql)
        rows = tw.check(CHECKS[1])
        assert [r[1] for r in rows] == [50] * 10
        # more rows into the consuming segments, queried as they land
        tw.publish([{"user": f"u{i % 3}", "action": "buy", "amount": i,
                     "ts": 500 + i} for i in range(120)])
        tw.wait()
        for sql in CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_restart_resumes_from_checkpoint(tmp_path):
    tw = Twin(tmp_path, "tt_resume", flush_rows=100)
    tw.publish([{"user": "u1", "action": "a", "amount": 1, "ts": i}
                for i in range(250)])
    tw.start()
    tw.wait(lambda: tw.counts() == [250, 250])
    assert _count(tw) == 250
    tw.stop(commit_remaining=True)
    tw.restart()
    tw.start()
    try:
        tw.wait()
        reconciled = _count(tw)
        assert 0 < reconciled <= 250
        tw.publish([{"user": "u2", "action": "b", "amount": 1,
                     "ts": 250 + i} for i in range(50)])
        tw.wait(lambda: tw.counts() == [reconciled + 50] * 2)
        assert tw.check("SELECT COUNT(*) FROM events WHERE user = 'u2'") \
            == [[50]]
        for sql in CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_flaky_consumer_loses_nothing(tmp_path):
    tw = Twin(tmp_path, "tt_flaky")
    calls = {"n": 0}

    class FlakyConsumer:
        def __init__(self, inner):
            self.inner = inner

        def fetch_messages(self, offset, timeout_ms):
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                raise RuntimeError("flaky!")
            return self.inner.fetch_messages(offset, timeout_ms)

        def close(self):
            self.inner.close()

    mgr = tw.mgrs["port"]
    real = mgr._factory

    class FlakyFactory:
        def partition_count(self):
            return real.partition_count()

        def earliest_offset(self, p):
            return real.earliest_offset(p)

        def create_partition_consumer(self, p):
            return FlakyConsumer(real.create_partition_consumer(p))

    mgr._factory = FlakyFactory()
    tw.start()
    try:
        for wave in range(3):
            tw.publish([{"user": f"u{i}", "action": "x", "amount": 1,
                         "ts": wave * 100 + i} for i in range(100)])
            tw.wait()
        assert _count(tw) == 300 and calls["n"] >= 3
        for sql in CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def _indexed(tw):
    return all(sum(m.segment.n_docs for m in mgr.partition_managers.values())
               for mgr in tw.mgrs.values())


UPSERT_CHECKS = [
    "SELECT COUNT(*) FROM events",
    "SELECT user, action, amount, ts FROM events ORDER BY user",
    "SELECT SUM(amount), MAX(ts) FROM events WHERE user <> 'zz'",
    "SELECT action, COUNT(*) FROM events GROUP BY action ORDER BY action",
]


def test_full_upsert_latest_wins_and_out_of_order_ignored(tmp_path):
    tw = Twin(tmp_path, "tt_upsert", upsert="FULL")
    tw.publish([
        {"user": "alice", "action": "a", "amount": 10, "ts": 100},
        {"user": "bob", "action": "b", "amount": 20, "ts": 100},
        {"user": "alice", "action": "c", "amount": 99, "ts": 200},
        {"user": "x", "action": "new", "amount": 5, "ts": 500},
        {"user": "x", "action": "old", "amount": 7, "ts": 100},
    ])
    tw.start()
    try:
        tw.wait()
        assert tw.check("SELECT COUNT(*) FROM events") == [[3]]
        assert tw.check("SELECT SUM(amount) FROM events "
                        "WHERE user = 'alice'") == [[99]]
        assert tw.check("SELECT SUM(amount) FROM events "
                        "WHERE user = 'x'") == [[5]]
        for sql in UPSERT_CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_upsert_restart_reconciles(tmp_path):
    tw = Twin(tmp_path, "tt_upsert_rc", upsert="FULL", flush_rows=2)
    tw.start()
    tw.publish([{"user": "a", "action": "1", "amount": 1, "ts": 1},
                {"user": "b", "action": "1", "amount": 2, "ts": 1}])
    tw.wait(lambda: tw.commits("ref") >= 1 and tw.commits() >= 1)
    tw.publish([{"user": "a", "action": "2", "amount": 70, "ts": 2},
                {"user": "c", "action": "1", "amount": 5, "ts": 1}])
    tw.wait(lambda: tw.commits("ref") >= 2 and tw.commits() >= 2)
    for sql in UPSERT_CHECKS:
        tw.check(sql)
    tw.stop()
    tw.restart()
    tw.start()
    try:
        assert _count(tw) == 3
        assert tw.check("SELECT SUM(amount) FROM events "
                        "WHERE user = 'a'") == [[70]]
        tw.publish([{"user": "a", "action": "3", "amount": 900, "ts": 3}])
        tw.wait()
        assert tw.check("SELECT SUM(amount) FROM events "
                        "WHERE user = 'a'") == [[900]]
        for sql in UPSERT_CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_upsert_survives_commit(tmp_path):
    tw = Twin(tmp_path, "tt_upsert_commit", upsert="FULL", flush_rows=3)
    tw.start()
    try:
        tw.publish([{"user": u, "action": "1", "amount": i + 1, "ts": 1}
                    for i, u in enumerate("abc")])
        tw.wait(lambda: tw.commits("ref") >= 1 and tw.commits() >= 1)
        # override a key that now lives in the SEALED segment, whose mask
        # the port's engine then reads
        tw.publish([{"user": "a", "action": "2", "amount": 100, "ts": 2}])
        tw.wait()
        assert tw.check("SELECT SUM(amount) FROM events") == [[105]]
        assert _count(tw) == 3
        for sql in UPSERT_CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


@pytest.mark.parametrize("strategies,events,sql,want", [
    ({"amount": "INCREMENT", "action": "IGNORE"},
     [{"user": "a", "action": "first", "amount": 10, "ts": 1},
      {"user": "a", "action": "second", "amount": 5, "ts": 2}],
     "SELECT action, amount FROM events WHERE user = 'a'", [["first", 15]]),
    ({},
     [{"user": "a", "action": "x", "amount": 42, "ts": 1},
      {"user": "a", "ts": 2}],
     "SELECT action, amount FROM events WHERE user = 'a'", [["x", 42]]),
    ({"amount": "INCREMENT"},
     [{"user": "a", "action": "n", "amount": 10, "ts": 500},
      {"user": "a", "action": "o", "amount": 7, "ts": 100}],
     "SELECT SUM(amount) FROM events WHERE user = 'a'", [[10]]),
    ({"amount": "INCREMENT"},
     [{"user": "a", "action": "x", "amount": 10, "ts": 1},
      {"user": "a", "action": "y", "amount": None, "ts": 2}],
     "SELECT action, amount FROM events WHERE user = 'a'", [["y", 10]]),
    ({"action": "IGNORE"},
     [{"user": "a", "amount": 1, "ts": 1},
      {"user": "a", "action": "real", "amount": 2, "ts": 2},
      {"user": "b", "amount": 1, "ts": 1},
      {"user": "b", "amount": 2, "ts": 2}],
     "SELECT user, action FROM events ORDER BY user", [["a", "real"],
                                                      ["b", "null"]]),
    ({"amount": "MAX", "action": "OVERWRITE"},
     [{"user": "a", "action": "p", "amount": 30, "ts": 1},
      {"user": "a", "action": "q", "amount": 20, "ts": 2},
      {"user": "b", "action": "r", "amount": 5, "ts": 1},
      {"user": "b", "action": "s", "amount": 9, "ts": 3}],
     "SELECT user, action, amount FROM events ORDER BY user",
     [["a", "q", 30], ["b", "s", 9]]),
    ({"amount": "MIN"},
     [{"user": "a", "action": "p", "amount": 30, "ts": 1},
      {"user": "a", "action": "q", "amount": 20, "ts": 2},
      {"user": "a", "action": "r", "amount": 25, "ts": 3}],
     "SELECT action, amount FROM events", [["r", 20]]),
], ids=["increment_ignore", "missing_carries", "out_of_order",
        "explicit_null", "previous_null", "max_overwrite", "min"])
def test_partial_upsert(tmp_path, strategies, events, sql, want):
    tw = Twin(tmp_path, "tt_partial", upsert="PARTIAL",
              strategies=strategies)
    tw.publish(events)
    tw.start()
    try:
        tw.wait()
        assert tw.check(sql) == want
        tw.check("SELECT COUNT(*) FROM events WHERE action IS NULL")
        for sql_ in UPSERT_CHECKS:
            tw.check(sql_)
        assert not any(m.index_errors for m in
                       tw.mgrs["port"].partition_managers.values())
    finally:
        tw.stop()


def test_partial_upsert_merges_from_sealed_and_restarts(tmp_path):
    tw = Twin(tmp_path, "tt_partial_seal", upsert="PARTIAL", flush_rows=2,
              strategies={"amount": "INCREMENT", "action": "IGNORE"})
    tw.start()
    tw.publish([{"user": "a", "action": "keep", "amount": 1, "ts": 1},
                {"user": "b", "action": "y", "amount": 2, "ts": 1}])
    tw.wait(lambda: tw.commits("ref") >= 1 and tw.commits() >= 1)
    tw.publish([{"user": "a", "action": "drop", "amount": 9, "ts": 2}])
    tw.wait()
    assert tw.check("SELECT action, amount FROM events "
                    "WHERE user = 'a'") == [["keep", 10]]
    tw.stop(commit_remaining=True)
    tw.restart()
    tw.start()
    try:
        assert tw.check("SELECT SUM(amount) FROM events "
                        "WHERE user = 'a'") == [[10]]
        tw.publish([{"user": "a", "action": "later", "amount": 5, "ts": 3}])
        tw.wait()
        assert tw.check("SELECT action, amount FROM events "
                        "WHERE user = 'a'") == [["keep", 15]]
        for sql in UPSERT_CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_strategy_validation_and_functions():
    sc, dt = SIDES["port"][:2]
    tc = SIDES["port"][2]
    with pytest.raises(ValueError, match="unknown"):
        PartialUpsertMerger(make_schema("port", pk=True), tc.UpsertConfig(
            mode="PARTIAL", partial_upsert_strategies={"amount": "BOGUS"}))
    with pytest.raises(ValueError, match="key/comparison"):
        PartialUpsertMerger(make_schema("port", pk=True), tc.UpsertConfig(
            mode="PARTIAL", comparison_column="ts",
            partial_upsert_strategies={"ts": "MAX"}))
    assert STRATEGIES["APPEND"]([1, 2], [3]) == [1, 2, 3]
    assert STRATEGIES["APPEND"](1, 2) == [1, 2]
    assert STRATEGIES["UNION"]([1, 2], [2, 3]) == [1, 2, 3]
    assert STRATEGIES["MAX"](3, 5) == 5 and STRATEGIES["MIN"](3, 5) == 3
    assert STRATEGIES["OVERWRITE"]("a", "b") == "b"
    assert STRATEGIES["IGNORE"]("a", "b") == "a"
    assert STRATEGIES["INCREMENT"](2, 3) == 5


@pytest.mark.parametrize("seq_of_orphan", ["last", "older"])
def test_orphan_quarantined(tmp_path, seq_of_orphan):
    tw = Twin(tmp_path, f"tt_orphan_{seq_of_orphan}", flush_rows=50)
    tw.start()
    for wave in range(3):
        tw.publish([{"user": f"u{i % 5}", "action": "a", "amount": 1,
                     "ts": wave * 60 + i} for i in range(60)])
        tw.wait(lambda: tw.commits("ref") >= wave + 1
                and tw.commits() >= wave + 1)
    tw.stop(commit_remaining=True)
    orphans = {}
    for side in SIDES:
        rt = tmp_path / side
        with open(rt / "checkpoints.json") as f:
            names = json.load(f)["events/0"]["names"]
        seq = max(names, key=int) if seq_of_orphan == "last" else "1"
        orphan = f"events__0__{seq}__19990101T000000Z"
        shutil.copytree(rt / names[seq], rt / orphan)
        orphans[side] = rt / orphan
    tw.restart()
    tw.start()
    try:
        tw.wait()
        n = _count(tw)
        assert 0 < n <= 180
        for side, orphan in orphans.items():
            assert not orphan.exists()
            assert (orphan.parent / "_orphans" / orphan.name).exists()
        for sql in CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_later_decoders_and_streams_name_their_item():
    """The binary decoders and the Kafka / Kinesis consumers are served as
    the reference serves them: a decoder without its stream properties and
    a consumer without its client library raise the reference's error,
    type and message alike."""
    from pinot_tpu.stream.spi import get_decoder as r_get_decoder

    def outcome(fn, *args):
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001 — compared below
            return type(e).__name__, str(e)
        return None

    for name in ("avro", "thrift", "confluent-avro", "protobuf"):
        got = outcome(get_decoder, name,
                      t_tc.StreamConfig(stream_type="kafka", topic="x"))
        want = outcome(r_get_decoder, name,
                       r_tc.StreamConfig(stream_type="kafka", topic="x"))
        assert got is not None and got == want, (name, got, want)
        assert "comes with" not in got[1]
    for kind in ("kafka", "kinesis"):
        got = outcome(t_mgr.create_consumer_factory,
                      t_tc.StreamConfig(stream_type=kind, topic="x"))
        want = outcome(r_mgr.create_consumer_factory,
                       r_tc.StreamConfig(stream_type=kind, topic="x"))
        assert got is not None and got == want, (kind, got, want)
    cfg = t_tc.StreamConfig(stream_type="kafka", topic="x")
    assert get_decoder("json", cfg)(b'{"a": 1}') == {"a": 1}
    assert os.path.basename(t_ms.__file__) == "memory_stream.py"


TRANSFORM_ROWS = [
    {"user": "a", "action": "view", "amount": 10, "ts": 1, "extra": 7},
    {"user": "b", "action": "buy", "amount": 45, "ts": 2, "extra": "3"},
    {"user": "c", "action": "view", "amount": None, "ts": 3, "extra": 1},
    {"user": "d", "action": "buy", "amount": 2, "ts": 4},
]


@pytest.mark.parametrize("transforms,filter_fn", [
    ({"amount": "amount * 2"}, None),
    ({"amount": "amount + extra", "ts": "ts * 1000"}, "amount > 40"),
    ({}, "action = 'view'"),
])
def test_record_transformer_matches_reference(transforms, filter_fn):
    from pinot_tpu.ingestion.transform import RecordTransformer as Ref
    from pinot_tpu_torch.ingestion.transform import RecordTransformer

    def config(tc):
        return tc.TableConfig(table_name="events", ingestion=tc.IngestionConfig(
            transform_configs=[tc.TransformConfig(c, f)
                               for c, f in transforms.items()],
            filter_function=filter_fn))

    ref, port = Ref(config(r_tc)), RecordTransformer(config(t_tc))
    assert port.active == ref.active
    assert [port.apply_row(r) for r in TRANSFORM_ROWS] == \
        [ref.apply_row(r) for r in TRANSFORM_ROWS]
    assert port.apply_rows(TRANSFORM_ROWS) == ref.apply_rows(TRANSFORM_ROWS)


def test_consume_loop_applies_the_ingestion_config(tmp_path):
    tw = Twin(tmp_path, "tt_transform")
    for side in SIDES:
        tc = SIDES[side][2]
        cfg = tw.config(side)
        cfg.ingestion = tc.IngestionConfig(
            transform_configs=[tc.TransformConfig("amount", "amount * 3")],
            filter_function="amount > 100")
        tw.mgrs[side] = SIDES[side][3].RealtimeTableDataManager(
            make_schema(side), cfg, tw.engines[side].table("events"),
            str(tmp_path / side))
    tw.publish([{"user": f"u{i % 4}", "action": "a", "amount": i, "ts": i}
                for i in range(60)])
    tw.start()
    try:
        tw.wait()
        assert tw.check("SELECT COUNT(*), MAX(amount) FROM events") == \
            [[34, 99]]
        for sql in CHECKS:
            tw.check(sql)
    finally:
        tw.stop()


def test_adopt_segment_copies_the_committed_directory(tmp_path):
    from pinot_tpu_torch.realtime.completion import (
        CommitOutcome,
        adopt_segment,
    )

    src = tmp_path / "winner" / "events__0__3__100"
    src.mkdir(parents=True)
    (src / "metadata.json").write_text("{}")
    entry = {"segment": src.name, "location": str(src), "offset": "200"}
    dest = adopt_segment(entry, str(tmp_path / "local"))
    assert os.path.exists(os.path.join(dest, "metadata.json"))
    assert adopt_segment({**entry, "location": dest},
                         str(tmp_path / "local")) == dest  # already local
    assert {CommitOutcome.WON, CommitOutcome.ADOPT, CommitOutcome.ABORT} \
        == {"WON", "ADOPT", "ABORT"}
