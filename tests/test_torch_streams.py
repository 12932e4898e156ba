"""The port's Kafka, Kinesis and Pulsar consumers against the JAX
package's, on the CPU.

The reference tests' fake client modules (tests/test_kafka_stream.py,
tests/test_avro_kinesis.py, tests/test_plugin_tail.py) stand in for
kafka-python, boto3 and pulsar-client. The same stream contents go through
both packages' stream SPI (``create_consumer_factory``): partition counts,
earliest offsets, every fetched message (offset, payload, key), the
resume offsets and a late arrival must be equal, and so must the errors
without a client. Then a consuming segment fed from the fake Kafka (and
one from the fake Kinesis) through each package's realtime manager
answers the same SQL alike.
"""

import json
import sys
import time
import types

import pytest

import test_avro_kinesis as kin
import test_kafka_stream as kaf
import test_plugin_tail as pul
from pinot_tpu.common import table_config as r_tc
from pinot_tpu.stream import spi as r_spi
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.stream import spi as t_spi

SIDES = {"ref": (r_tc, r_spi), "port": (t_tc, t_spi)}


def _kinesis_streams():
    return {"events": {
        "shardId-000": [(100, b'{"v": 1}', "a"), (101, b'{"v": 2}', "b"),
                        (105, b'{"v": 3}', "c")],
        "shardId-001": [(500, b'{"v": 10}', "d")]}}


def _install(monkeypatch, kind):
    """A fresh fake stream of ``kind`` (the same contents on every call)
    and a hook that appends one late record: → append()."""
    if kind == "kafka":
        mod = types.ModuleType("kafka")
        mod.TopicPartition = kaf._FakeTopicPartition
        mod.KafkaConsumer = kaf._FakeKafkaConsumer
        monkeypatch.setitem(sys.modules, "kafka", mod)
        kaf._LOG.clear()
        kaf._LOG[("events", 0)] = [
            kaf._FakeRecord(5 + i, json.dumps({"a": i}).encode(),
                            key=b"k%d" % i) for i in range(4)]
        kaf._LOG[("events", 1)] = [kaf._FakeRecord(40, b'{"a": 9}')]
        return lambda: kaf._LOG[("events", 0)].append(
            kaf._FakeRecord(9, b'{"a": 99}'))
    if kind == "kinesis":
        streams = _kinesis_streams()
        mod = types.ModuleType("boto3")
        mod.client = lambda service, **kw: kin._FakeKinesisClient(streams)
        monkeypatch.setitem(sys.modules, "boto3", mod)
        return lambda: streams["events"]["shardId-000"].append(
            (107, b'{"v": 4}', "e"))
    fake = types.ModuleType("pulsar")
    fake.Client = pul.FakeClient
    fake.MessageId = pul.FakeMessageId
    monkeypatch.setitem(sys.modules, "pulsar", fake)
    pul.FakeClient.msgs = [
        pul.FakeMsg(pul.FakeMessageId(-1, 1, i, -1),
                    json.dumps({"i": i}).encode()) for i in range(5)]
    return lambda: pul.FakeClient.msgs.append(
        pul.FakeMsg(pul.FakeMessageId(-1, 2, 0, -1), b'{"i": 99}'))


def _config(tc, kind):
    props = {"kafka": {"bootstrap.servers": "b1:9092",
                       "kafka.consumer.client_id": "pinot"},
             "kinesis": {"aws.region": "us-test-1"},
             "pulsar": {}}[kind]
    return tc.StreamConfig(stream_type=kind,
                           topic="t" if kind == "pulsar" else "events",
                           decoder="json", properties=props)


def _drive(monkeypatch, side, kind):
    tc, spi = SIDES[side]
    append = _install(monkeypatch, kind)
    factory = spi.create_consumer_factory(_config(tc, kind))
    n = factory.partition_count()
    out = [("partitions", n)]
    for p in range(n):
        start = factory.earliest_offset(p)
        out.append(("earliest", p, start.value))
        consumer = factory.create_partition_consumer(p)
        batch = consumer.fetch_messages(start, 100)
        out.append([(m.offset.value, m.payload, m.key)
                    for m in batch.messages])
        out.append(("next", batch.next_offset.value))
        again = consumer.fetch_messages(batch.next_offset, 100)
        out.append(("again", len(again), again.next_offset.value))
        if p == 0:
            append()
            late = consumer.fetch_messages(again.next_offset, 100)
            out.append([(m.offset.value, m.payload)
                        for m in late.messages])
        consumer.close()
    return out


@pytest.mark.parametrize("kind", ["kafka", "kinesis", "pulsar"])
def test_stream_fetches_match_reference(monkeypatch, kind):
    got = _drive(monkeypatch, "port", kind)
    want = _drive(monkeypatch, "ref", kind)
    assert got == want
    assert any(isinstance(x, list) and x for x in got)


def _kinesis_resume(monkeypatch, side):
    """tests/test_avro_kinesis.py's resume: a checkpoint mid-stream
    replays only the tail."""
    tc, spi = SIDES[side]
    _install(monkeypatch, "kinesis")
    c = spi.create_consumer_factory(_config(tc, "kinesis")) \
        .create_partition_consumer(0)
    return [m.payload for m in c.fetch_messages(
        spi.StreamPartitionMsgOffset(102), 100).messages]


def test_kinesis_checkpoint_resume_matches_reference(monkeypatch):
    got = _kinesis_resume(monkeypatch, "port")
    assert got == _kinesis_resume(monkeypatch, "ref") == [b'{"v": 3}']


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kind,client", [("kafka", "kafka"),
                                         ("kinesis", "boto3"),
                                         ("pulsar", "pulsar")])
def test_gating_error_without_client_matches_reference(monkeypatch, kind,
                                                       client):
    monkeypatch.setitem(sys.modules, client, None)
    errs = []
    for side in ("port", "ref"):
        tc, spi = SIDES[side]
        errs.append(_error(lambda: spi.create_consumer_factory(
            _config(tc, kind)).partition_count()))
    assert errs[0] is not None and errs[0] == errs[1]
    assert errs[0][0] == "RuntimeError"


def test_pulsar_entry_bound_matches_reference(monkeypatch):
    _install(monkeypatch, "pulsar")
    from pinot_tpu.stream.pulsar_stream import PulsarConsumerFactory as RF
    from pinot_tpu_torch.stream.pulsar_stream import (
        PulsarConsumerFactory,
        pack_message_id,
        unpack_message_id,
    )

    over = {"pulsar.max.entries.per.ledger": str(1 << 21)}
    got = _error(lambda: PulsarConsumerFactory(t_tc.StreamConfig(
        stream_type="pulsar", topic="t", decoder="json", properties=over)))
    want = _error(lambda: RF(r_tc.StreamConfig(
        stream_type="pulsar", topic="t", decoder="json", properties=over)))
    assert got == want and got[0] == "ValueError"
    assert unpack_message_id(pack_message_id(5, 100, -1)) == (5, 100, -1)
    assert pack_message_id(5, 999, 3) < pack_message_id(6, 0, -1)


# ---------------------------------------------------------------------------
# consuming segments fed from the fake streams
# ---------------------------------------------------------------------------

RT_SQL = ["SELECT COUNT(*), SUM(v) FROM ev",
          "SELECT k, COUNT(*), MAX(v) FROM ev GROUP BY k ORDER BY k",
          "SELECT SUM(v) FROM ev WHERE k = 'u1'"]


def _consume(monkeypatch, side, kind, tmp_path, want_rows):
    """A realtime table over the fake stream, consumed until it holds
    ``want_rows`` rows: → the answers to RT_SQL."""
    if side == "port":
        from pinot_tpu_torch.common.datatypes import DataType
        from pinot_tpu_torch.common.schema import Schema
        from pinot_tpu_torch.engine.engine import QueryEngine
        from pinot_tpu_torch.realtime.manager import RealtimeTableDataManager
        eng = QueryEngine(device="cpu")
        eng.device.min_rows = 0
    else:
        from pinot_tpu.common.datatypes import DataType
        from pinot_tpu.common.schema import Schema
        from pinot_tpu.engine.engine import QueryEngine
        from pinot_tpu.realtime.manager import RealtimeTableDataManager
        eng = QueryEngine(device_executor=None)
    tc = SIDES[side][0]
    if kind == "kafka":
        _install(monkeypatch, "kafka")
        kaf._LOG.clear()
        kaf._LOG[("events", 0)] = [
            kaf._FakeRecord(i, json.dumps(
                {"k": f"u{i % 3}", "v": i}).encode()) for i in range(30)]
        props = {"bootstrap.servers": "b1:9092"}
        parts = None
    else:
        streams = {"events": {
            "shardId-000": [(100 + i, json.dumps(
                {"k": f"u{i % 3}", "v": i}).encode(), "p") for i in range(20)],
            "shardId-001": [(500 + i, json.dumps(
                {"k": "u1", "v": 100 + i}).encode(), "q") for i in range(7)]}}
        mod = types.ModuleType("boto3")
        mod.client = lambda service, **kw: kin._FakeKinesisClient(streams)
        monkeypatch.setitem(sys.modules, "boto3", mod)
        props = {"aws.region": "us-test-1"}
        parts = [0, 1]
    schema = Schema.build(name="ev", dimensions=[("k", DataType.STRING)],
                          metrics=[("v", DataType.LONG)])
    cfg = tc.TableConfig(
        table_name="ev", table_type=tc.TableType.REALTIME,
        stream=tc.StreamConfig(stream_type=kind, topic="events",
                               decoder="json",
                               segment_flush_threshold_rows=100_000,
                               segment_flush_threshold_seconds=3600,
                               properties=props))
    mgr = RealtimeTableDataManager(schema, cfg, eng.table("ev"),
                                   str(tmp_path / side))
    mgr.start(partitions=parts)
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            r = eng.execute(RT_SQL[0])
            if not r.get("exceptions") and \
                    r["resultTable"]["rows"][0][0] == want_rows:
                break
            time.sleep(0.05)
        out = []
        for sql in RT_SQL:
            r = eng.execute(sql)
            assert r["exceptions"] == [], (side, sql, r)
            out.append(r["resultTable"])
        return out
    finally:
        mgr.stop(commit_remaining=False)


@pytest.mark.parametrize("kind,n", [("kafka", 30), ("kinesis", 27)])
def test_stream_fed_consuming_segment_matches_reference(monkeypatch,
                                                        tmp_path, kind, n):
    got = _consume(monkeypatch, "port", kind, tmp_path, n)
    want = _consume(monkeypatch, "ref", kind, tmp_path, n)
    assert got == want
    assert got[0]["rows"][0][0] == n
