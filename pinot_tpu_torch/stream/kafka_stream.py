"""Kafka stream plugin (pinot-plugins/pinot-stream-ingestion/pinot-kafka-2.0
analog), gated on the ``kafka-python`` client library.

Maps the SPI onto KafkaConsumer primitives the way KafkaPartitionLevelConsumer
does: one consumer per partition pinned with ``assign``, offsets are Kafka
offsets (long, so StreamPartitionMsgOffset wraps them directly), fetches are
``poll`` with the SPI timeout, and partition count comes from
``partitions_for_topic``. StreamConfig.properties pass through:

    stream_type: kafka
    topic: my-events
    properties:
      bootstrap.servers: broker1:9092,broker2:9092
      # any further kafka-python kwarg as kafka.consumer.<name>

The client library is optional (a copy of pinot_tpu/stream/kafka_stream.py
for the port): the module registers lazily and raises a clear error at
factory-construction time when ``kafka`` is not importable — the SPI registry itself never
breaks (plugin isolation, PluginManager analog).
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


def _kafka():
    try:
        import kafka  # type: ignore

        return kafka
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "stream_type 'kafka' needs the kafka-python package; install it "
            "or use the 'memory'/'file' streams") from e


def _coerce(val):
    """StreamConfig.properties is dict[str, str]; kafka-python does no
    config coercion, so numeric/bool kwargs must be typed here."""
    if not isinstance(val, str):
        return val
    low = val.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        return val


def _consumer_kwargs(config: StreamConfig) -> dict:
    props = config.properties or {}
    kwargs = {
        "bootstrap_servers": props.get("bootstrap.servers", "localhost:9092"),
        "enable_auto_commit": False,  # offsets live in the checkpoint store
        "group_id": None,
    }
    for key, val in props.items():
        if key.startswith("kafka.consumer."):
            name = key[len("kafka.consumer."):]
            if name == "enable_auto_commit":
                # broker-side auto-commit would fight the checkpoint store's
                # exactly-once resume; refuse rather than silently re-enable
                raise ValueError(
                    "kafka.consumer.enable_auto_commit is not overridable: "
                    "offsets are managed by the checkpoint store")
            kwargs[name] = _coerce(val)
    return kwargs


class KafkaPartitionConsumer(PartitionGroupConsumer):
    def __init__(self, config: StreamConfig, partition: int):
        k = _kafka()
        self._tp = k.TopicPartition(config.topic, partition)
        self._consumer = k.KafkaConsumer(**_consumer_kwargs(config))
        self._consumer.assign([self._tp])
        self._positioned_at = None

    def fetch_messages(self, start_offset: StreamPartitionMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        if self._positioned_at != start_offset.value:
            self._consumer.seek(self._tp, start_offset.value)
        polled = self._consumer.poll(timeout_ms=timeout_ms)
        records = polled.get(self._tp, [])
        messages = [
            StreamMessage(
                offset=StreamPartitionMsgOffset(r.offset),
                payload=r.value,
                key=r.key,
                timestamp_ms=getattr(r, "timestamp", None),
            )
            for r in records
        ]
        next_off = (records[-1].offset + 1) if records else start_offset.value
        self._positioned_at = next_off
        return MessageBatch(messages=messages,
                            next_offset=StreamPartitionMsgOffset(next_off))

    def close(self) -> None:
        self._consumer.close()


class KafkaConsumerFactory(StreamConsumerFactory):
    def __init__(self, config: StreamConfig):
        super().__init__(config)
        _kafka()  # fail fast with the clear gating error
        self._earliest: dict = {}  # partition -> offset, one probe for all

    def _probe_metadata(self) -> int:
        """ONE probe consumer answers partition count AND every partition's
        beginning offset — a 64-partition table start is one broker
        round-trip, not 65."""
        k = _kafka()
        probe = k.KafkaConsumer(**_consumer_kwargs(self.config))
        try:
            parts = probe.partitions_for_topic(self.config.topic)
            if not parts:
                raise RuntimeError(
                    f"kafka topic {self.config.topic!r} has no partitions "
                    f"(missing topic?)")
            tps = [k.TopicPartition(self.config.topic, p) for p in parts]
            begins = probe.beginning_offsets(tps)
            self._earliest = {tp.partition: off for tp, off in begins.items()}
            return len(parts)
        finally:
            probe.close()

    def partition_count(self) -> int:
        return self._probe_metadata()

    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        return KafkaPartitionConsumer(self.config, partition)

    def earliest_offset(self, partition: int) -> StreamPartitionMsgOffset:
        if partition not in self._earliest:
            self._probe_metadata()
        return StreamPartitionMsgOffset(self._earliest.get(partition, 0))


register_stream_type("kafka", KafkaConsumerFactory)
