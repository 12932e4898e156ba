"""Kinesis stream plugin (pinot-plugins/pinot-stream-ingestion/pinot-kinesis
analog), gated on ``boto3``.

Shape-match to the reference's KinesisConsumerFactory / KinesisConsumer /
KinesisStreamMetadataProvider:

- a Kinesis SHARD is the partition-group unit; shards are mapped to dense
  partition ids ordinally (sorted by shardId), like the reference's
  partition-group metadata derived from ListShards;
- checkpoints are SEQUENCE NUMBERS. Kinesis sequence numbers are decimal
  strings of monotonically increasing integers, so they ride the SPI's
  integer offsets directly: offset 0 = TRIM_HORIZON (earliest), offset
  v > 0 = "resume AFTER sequence number v-1" — next_offset after a record
  with sequence s is int(s)+1, mirroring the kafka plugin's last+1;
- fetches map to GetShardIterator + GetRecords with the SPI timeout.

StreamConfig.properties pass through:

    stream_type: kinesis
    topic: my-stream           # Kinesis stream name
    properties:
      aws.region: us-west-2
      aws.endpoint: http://localhost:4566   # localstack/dev override
      # any further boto3 client kwarg as kinesis.client.<name>

boto3 is optional (a copy of pinot_tpu/stream/kinesis_stream.py for the
port); the module registers lazily and raises a clear gating error at factory construction (plugin isolation, PluginManager
analog) — tests fake the boto3 module.
"""

from __future__ import annotations

from pinot_tpu_torch.common.table_config import StreamConfig
from pinot_tpu_torch.stream.spi import (
    MessageBatch,
    PartitionGroupConsumer,
    StreamConsumerFactory,
    StreamMessage,
    StreamPartitionMsgOffset,
    register_stream_type,
)


def _boto3():
    try:
        import boto3  # type: ignore

        return boto3
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "stream_type 'kinesis' needs the boto3 package; install it or "
            "use the 'memory'/'kafka' streams") from e


def _client(config: StreamConfig, timeout_ms: int = 10_000):
    props = config.properties or {}
    kwargs = {}
    if props.get("aws.region"):
        kwargs["region_name"] = props["aws.region"]
    if props.get("aws.endpoint"):
        kwargs["endpoint_url"] = props["aws.endpoint"]
    for key, val in props.items():
        if key.startswith("kinesis.client."):
            kwargs[key[len("kinesis.client."):]] = val
    boto3 = _boto3()
    # bound the SDK so fetch_messages honors the SPI timeout: boto3's
    # defaults (60s read timeout x retries) would stall the ingest thread
    # far past the consume loop's deadline during a partition
    try:
        from botocore.config import Config  # type: ignore

        timeout_s = max(1.0, timeout_ms / 1000.0)
        kwargs.setdefault("config", Config(
            connect_timeout=timeout_s, read_timeout=timeout_s,
            retries={"max_attempts": 2}))
    except ImportError:  # pragma: no cover — faked boto3 in tests
        pass
    return boto3.client("kinesis", **kwargs)


def _shard_ids(client, stream: str) -> list:
    """Dense ordinal shard mapping (sorted by shardId for stability)."""
    shards = []
    token = None
    while True:
        if token:
            resp = client.list_shards(NextToken=token)
        else:
            resp = client.list_shards(StreamName=stream)
        shards.extend(s["ShardId"] for s in resp.get("Shards", []))
        token = resp.get("NextToken")
        if not token:
            return sorted(shards)


class KinesisPartitionConsumer(PartitionGroupConsumer):
    def __init__(self, config: StreamConfig, partition: int):
        self.config = config
        # client-level SDK bound approximating the per-fetch SPI timeout
        # (boto3 configures timeouts per client, not per call); the stream
        # property overrides the 10s default
        props = config.properties or {}
        self._client = _client(
            config,
            timeout_ms=int(props.get("kinesis.fetch.timeout.ms", 10_000)))
        self._stream = config.topic
        ids = _shard_ids(self._client, self._stream)
        if partition >= len(ids):
            raise ValueError(
                f"stream {self._stream!r} has {len(ids)} shards; "
                f"partition {partition} out of range")
        self._shard_id = ids[partition]
        self._iterator = None
        self._positioned_at = None

    def _seek(self, offset_value: int) -> None:
        if offset_value <= 0:
            resp = self._client.get_shard_iterator(
                StreamName=self._stream, ShardId=self._shard_id,
                ShardIteratorType="TRIM_HORIZON")
        else:
            resp = self._client.get_shard_iterator(
                StreamName=self._stream, ShardId=self._shard_id,
                ShardIteratorType="AFTER_SEQUENCE_NUMBER",
                StartingSequenceNumber=str(offset_value - 1))
        self._iterator = resp["ShardIterator"]
        self._positioned_at = offset_value

    def fetch_messages(self, start_offset: StreamPartitionMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        if self._iterator is None or self._positioned_at != start_offset.value:
            self._seek(start_offset.value)
        resp = self._client.get_records(ShardIterator=self._iterator)
        self._iterator = resp.get("NextShardIterator")
        messages = []
        next_off = start_offset.value
        for r in resp.get("Records", []):
            seq = int(r["SequenceNumber"])
            ts = r.get("ApproximateArrivalTimestamp")
            messages.append(StreamMessage(
                offset=StreamPartitionMsgOffset(seq + 1),
                payload=r["Data"],
                key=r.get("PartitionKey"),
                timestamp_ms=int(ts.timestamp() * 1000)
                if hasattr(ts, "timestamp") else ts,
            ))
            next_off = seq + 1
        self._positioned_at = next_off
        return MessageBatch(messages=messages,
                            next_offset=StreamPartitionMsgOffset(next_off))

    def close(self) -> None:
        close = getattr(self._client, "close", None)
        if close is not None:
            close()


class KinesisConsumerFactory(StreamConsumerFactory):
    def __init__(self, config: StreamConfig):
        super().__init__(config)
        _boto3()  # fail fast with the clear gating error

    def partition_count(self) -> int:
        client = _client(self.config)
        try:
            return len(_shard_ids(client, self.config.topic))
        finally:
            close = getattr(client, "close", None)
            if close is not None:
                close()

    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        return KinesisPartitionConsumer(self.config, partition)

    def earliest_offset(self, partition: int) -> StreamPartitionMsgOffset:
        return StreamPartitionMsgOffset(0)  # TRIM_HORIZON


register_stream_type("kinesis", KinesisConsumerFactory)
