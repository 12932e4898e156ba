"""Pulsar stream plugin (pinot-plugins/pinot-stream-ingestion/pinot-pulsar
analog), gated on ``pulsar-client``.

Shape-match to the reference's PulsarConsumerFactory /
PulsarPartitionLevelConsumer / MessageIdStreamOffset:

- a partitioned topic's partition N maps to the ``<topic>-partition-N``
  sub-topic, read with the Reader API (no subscription state — the
  engine's registry checkpoints are the source of truth, exactly like the
  reference bypasses Pulsar subscriptions);
- offsets are MessageIds. The SPI wraps orderable integers, so MessageIds
  PACK into one int: (ledger_id << 28) | (entry_id << 8) | (batch_index
  + 1), with offset 0 = earliest. Ledger ids grow monotonically and entry
  ids reset per ledger, so packed values order exactly like the
  reference's MessageIdStreamOffset comparison (documented bounds:
  entry_id < 2^20 per ledger, batch < 255 — far above broker defaults of
  50k entries/ledger);
- next_offset after a message is its packed id + 1 ("resume after").

StreamConfig.properties pass through:

    stream_type: pulsar
    topic: persistent://tenant/ns/events
    properties:
      pulsar.service.url: pulsar://localhost:6650
      # further pulsar.Client kwargs as pulsar.client.<name>

pulsar-client is optional (a copy of pinot_tpu/stream/pulsar_stream.py
for the port); the module registers lazily and raises a clear gating error at factory construction — tests fake the
``pulsar`` module.
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

_ENTRY_BITS = 20
_BATCH_BITS = 8
# broker-side managedLedgerMaxEntriesPerLedger, declared by the operator so
# the packing bound is checked at CONSTRUCTION (fail fast, before any
# checkpoint advances) instead of mid-consume
_MAX_ENTRIES_PROP = "pulsar.max.entries.per.ledger"


def _validate_entry_bound(config: StreamConfig) -> None:
    """Packed offsets bound entry_id below 2^20 per ledger. Brokers default
    to 50k entries/ledger (far under the bound), but an operator who raised
    managedLedgerMaxEntriesPerLedger past 2^20 would only find out via a
    mid-consume ValueError with the consumer making no ingest progress —
    so the factory/consumer checks the DECLARED broker bound (the
    ``pulsar.max.entries.per.ledger`` stream property) up front and rejects
    the config with the same remediation message. pack_message_id keeps
    its per-message guard as the backstop for undeclared configs."""
    props = config.properties or {}
    declared = props.get(_MAX_ENTRIES_PROP)
    if declared is None:
        return
    try:
        bound = int(declared)
    except (TypeError, ValueError):
        raise ValueError(
            f"{_MAX_ENTRIES_PROP}={declared!r} is not an integer — set it "
            f"to the broker's managedLedgerMaxEntriesPerLedger value")
    if bound > (1 << _ENTRY_BITS):
        raise ValueError(
            f"{_MAX_ENTRIES_PROP}={declared} exceeds the packed-offset "
            f"entry_id bound 2^{_ENTRY_BITS} — lower the broker's "
            f"managedLedgerMaxEntriesPerLedger below it or widen the "
            f"packing (_ENTRY_BITS)")


def _pulsar():
    try:
        import pulsar  # type: ignore

        return pulsar
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "stream_type 'pulsar' needs the pulsar-client package; install "
            "it or use the 'memory'/'kafka' streams") from e


def pack_message_id(ledger_id: int, entry_id: int, batch_index: int) -> int:
    """MessageId → orderable int (MessageIdStreamOffset role). batch_index
    -1 (non-batched) packs as 0; batched entries 0.. pack as 1.. so a
    non-batched message sorts before its (impossible) batch siblings."""
    if entry_id >= (1 << _ENTRY_BITS):
        raise ValueError(
            f"entry_id {entry_id} exceeds the packed-offset bound "
            f"2^{_ENTRY_BITS} — raise managedLedgerMaxEntriesPerLedger "
            f"below it or widen the packing")
    b = batch_index + 1 if batch_index is not None and batch_index >= 0 else 0
    if b >= (1 << _BATCH_BITS):
        raise ValueError(f"batch_index {batch_index} exceeds packing bound")
    return (ledger_id << (_ENTRY_BITS + _BATCH_BITS)) \
        | (entry_id << _BATCH_BITS) | b


def unpack_message_id(packed: int):
    """(ledger_id, entry_id, batch_index) from a packed offset."""
    b = packed & ((1 << _BATCH_BITS) - 1)
    entry = (packed >> _BATCH_BITS) & ((1 << _ENTRY_BITS) - 1)
    ledger = packed >> (_ENTRY_BITS + _BATCH_BITS)
    return ledger, entry, b - 1


def _client(config: StreamConfig):
    props = config.properties or {}
    url = props.get("pulsar.service.url", "pulsar://localhost:6650")
    kwargs = {}
    for key, val in props.items():
        if key.startswith("pulsar.client."):
            kwargs[key[len("pulsar.client."):]] = val
    return _pulsar().Client(url, **kwargs)


def _partition_topic(topic: str, partition: int, n_partitions: int) -> str:
    return topic if n_partitions <= 1 else f"{topic}-partition-{partition}"


class PulsarPartitionConsumer(PartitionGroupConsumer):
    def __init__(self, config: StreamConfig, partition: int,
                 n_partitions: int):
        _validate_entry_bound(config)
        self.config = config
        self._pulsar = _pulsar()
        self._client = _client(config)
        self._topic = _partition_topic(config.topic, partition, n_partitions)
        self._reader = None
        self._positioned_at = None

    def _seek(self, offset_value: int) -> None:
        if self._reader is not None:
            self._reader.close()
        if offset_value <= 0:
            start = self._pulsar.MessageId.earliest
        else:
            # resume AFTER the packed id − 1 (exclusive start): position AT
            # the previous message and skip it via the reader contract
            ledger, entry, batch = unpack_message_id(offset_value - 1)
            start = self._pulsar.MessageId(-1, ledger, entry, batch)
        self._reader = self._client.create_reader(
            self._topic, start,
            start_message_id_inclusive=(offset_value <= 0))
        self._positioned_at = offset_value

    def fetch_messages(self, start_offset: StreamPartitionMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        if self._reader is None or self._positioned_at != start_offset.value:
            self._seek(start_offset.value)
        messages = []
        next_off = start_offset.value
        deadline_ms = max(1, int(timeout_ms))
        # only TIMEOUT ends a fetch quietly; transport/auth errors must
        # surface (a swallowed ConnectError would read as caught-up and
        # stall ingestion silently)
        timeout_excs = tuple(
            e for e in (getattr(self._pulsar, "Timeout", None), TimeoutError)
            if e is not None)
        while True:
            try:
                msg = self._reader.read_next(timeout_millis=deadline_ms)
            except timeout_excs:
                break
            mid = msg.message_id()
            packed = pack_message_id(
                mid.ledger_id(), mid.entry_id(),
                getattr(mid, "batch_index", lambda: -1)())
            next_off = packed + 1
            messages.append(StreamMessage(
                offset=StreamPartitionMsgOffset(packed),
                payload=msg.data(),
                key=(msg.partition_key() or "").encode("utf-8") or None,
                timestamp_ms=msg.publish_timestamp(),
            ))
            deadline_ms = 1  # drain whatever is already buffered
            if len(messages) >= 10_000:
                break
        self._positioned_at = next_off
        return MessageBatch(messages=messages,
                            next_offset=StreamPartitionMsgOffset(next_off))

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
        self._client.close()


class PulsarConsumerFactory(StreamConsumerFactory):
    def __init__(self, config: StreamConfig):
        super().__init__(config)
        _validate_entry_bound(config)
        self._n_partitions: int | None = None

    def partition_count(self) -> int:
        # cached: a 32-partition table would otherwise open one throwaway
        # client + metadata round trip PER consumer construction
        if self._n_partitions is None:
            client = _client(self.config)
            try:
                parts = client.get_topic_partitions(self.config.topic)
                self._n_partitions = max(1, len(parts))
            finally:
                client.close()
        return self._n_partitions

    def create_partition_consumer(self, partition: int) -> PulsarPartitionConsumer:
        return PulsarPartitionConsumer(self.config, partition,
                                       self.partition_count())


register_stream_type("pulsar", PulsarConsumerFactory)
