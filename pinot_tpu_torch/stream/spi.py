"""Stream ingestion SPI: pluggable consumers, offsets, decoders (a copy
of pinot_tpu/stream/spi.py for the port).

Equivalent of pinot-spi/.../stream/: ``StreamConsumerFactory``,
``PartitionGroupConsumer``, ``MessageBatch``, ``StreamPartitionMsgOffset``
(orderable opaque offsets), ``StreamMessageDecoder``. Concrete streams
register under a type key (reference: StreamConsumerFactoryProvider +
isolated plugin classloaders; here a plain registry — python imports are the
plugin boundary).
"""

from __future__ import annotations

import abc
import dataclasses
import functools
import json
from typing import Callable, Optional, Sequence

from pinot_tpu_torch.common.table_config import StreamConfig


@functools.total_ordering
class StreamPartitionMsgOffset:
    """Orderable opaque offset (StreamPartitionMsgOffset.java). Wraps a long
    for the built-in streams; subclasses may carry richer state as long as
    comparison and string round-trip hold."""

    def __init__(self, value: int):
        self.value = int(value)

    def __eq__(self, other):
        return isinstance(other, StreamPartitionMsgOffset) and self.value == other.value

    def __lt__(self, other):
        return self.value < other.value

    def __repr__(self):
        return f"Offset({self.value})"

    def to_string(self) -> str:
        return str(self.value)

    @classmethod
    def from_string(cls, s: str) -> "StreamPartitionMsgOffset":
        return cls(int(s))


@dataclasses.dataclass
class StreamMessage:
    offset: StreamPartitionMsgOffset
    payload: bytes
    key: Optional[bytes] = None
    timestamp_ms: Optional[int] = None


@dataclasses.dataclass
class MessageBatch:
    """One fetch result (MessageBatch.java): messages plus the offset to
    resume from (next fetch's start)."""

    messages: Sequence[StreamMessage]
    next_offset: StreamPartitionMsgOffset

    def __len__(self):
        return len(self.messages)


class PartitionGroupConsumer(abc.ABC):
    """Consumer pinned to one stream partition (PartitionGroupConsumer.java)."""

    @abc.abstractmethod
    def fetch_messages(self, start_offset: StreamPartitionMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        ...

    def close(self) -> None:
        pass


class StreamConsumerFactory(abc.ABC):
    """Per-table stream access (StreamConsumerFactory.java)."""

    def __init__(self, config: StreamConfig):
        self.config = config

    @abc.abstractmethod
    def partition_count(self) -> int:
        ...

    @abc.abstractmethod
    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        ...

    def earliest_offset(self, partition: int) -> StreamPartitionMsgOffset:
        return StreamPartitionMsgOffset(0)


# ---------------------------------------------------------------------------
# decoders (input-format plugins: pinot-plugins/pinot-input-format/*)
# ---------------------------------------------------------------------------


def json_decoder(payload: bytes) -> dict:
    return json.loads(payload.decode("utf-8"))


def json_batch_decoder(payloads) -> list:
    """Decode MANY json payloads in one parser call by joining them into a
    single JSON array — the C scanner loops instead of paying the python
    ``loads`` entry cost per message (~4x on small events; the columnar
    ingest path's decode basis, realtime/chunklet.py). Falls back to the
    per-payload decoder on any malformed message (caller isolates it)."""
    return json.loads(b"[" + b",".join(payloads) + b"]")


def get_batch_decoder(name: str, stream_config: StreamConfig) -> Optional[Callable]:
    """Batch decoder (payloads list → rows list) for decoders that have a
    vectorized form, else None (callers loop the row decoder)."""
    if name == "json":
        return json_batch_decoder
    return None


def csv_decoder_for(columns: Sequence[str], delimiter: str = ",") -> Callable:
    def decode(payload: bytes) -> dict:
        parts = payload.decode("utf-8").rstrip("\n").split(delimiter)
        return dict(zip(columns, parts))

    return decode


_DECODERS: dict[str, Callable] = {"json": json_decoder}


def get_decoder(name: str, stream_config: StreamConfig) -> Callable:
    if name == "csv":
        cols = stream_config.properties.get("csv.columns", "")
        return csv_decoder_for(cols.split(","),
                               stream_config.properties.get("csv.delimiter", ","))
    if name == "avro":
        # schemaful binary records (SimpleAvroMessageDecoder analog): the
        # writer schema rides in stream properties, one binary record per
        # message, no container framing
        from pinot_tpu_torch.ingestion.avro_io import binary_decoder_for

        schema_json = stream_config.properties.get("avro.schema", "")
        if not schema_json:
            raise KeyError(
                "avro decoder needs the writer schema in stream "
                "properties['avro.schema']")
        return binary_decoder_for(schema_json)
    if name == "thrift":
        # TBinaryProtocol struct records (ThriftRecordReader role); the
        # field-id → column map plays the generated class's part
        from pinot_tpu_torch.ingestion.thrift_io import binary_decoder_for as thrift_for

        fmap = stream_config.properties.get("thrift.field.map", "")
        return thrift_for(fmap)
    if name == "confluent-avro":
        # magic byte + schema-registry id framing
        # (KafkaConfluentSchemaRegistryAvroMessageDecoder role)
        from pinot_tpu_torch.ingestion.confluent_avro import ConfluentAvroDecoder

        inline = {
            k[len("schema.registry.schemas."):]: v
            for k, v in stream_config.properties.items()
            if k.startswith("schema.registry.schemas.")
        }
        return ConfluentAvroDecoder(
            registry_url=stream_config.properties.get(
                "schema.registry.url", ""),
            inline_schemas=inline or None)
    if name == "protobuf":
        # one serialized message per payload (ProtoBufMessageDecoder)
        from pinot_tpu_torch.ingestion.protobuf_io import binary_decoder_for

        desc = stream_config.properties.get("protobuf.descriptor_file", "")
        msg = stream_config.properties.get("protobuf.message_name", "")
        if not desc or not msg:
            raise KeyError(
                "protobuf decoder needs stream properties "
                "'protobuf.descriptor_file' + 'protobuf.message_name'")
        return binary_decoder_for(desc, msg)
    try:
        return _DECODERS[name]
    except KeyError:
        raise KeyError(f"unknown decoder {name!r}") from None


def register_decoder(name: str, fn: Callable) -> None:
    _DECODERS[name] = fn


# ---------------------------------------------------------------------------
# factory registry (StreamConsumerFactoryProvider analog)
# ---------------------------------------------------------------------------

_FACTORIES: dict[str, type] = {}


def register_stream_type(name: str, factory_cls: type) -> None:
    _FACTORIES[name] = factory_cls


def create_consumer_factory(config: StreamConfig) -> StreamConsumerFactory:
    # built-ins register lazily so importing the SPI stays dependency-free
    if config.stream_type == "memory" and "memory" not in _FACTORIES:
        from pinot_tpu_torch.stream import memory_stream  # noqa: F401  (registers)
    if config.stream_type == "kafka" and "kafka" not in _FACTORIES:
        from pinot_tpu_torch.stream import kafka_stream  # noqa: F401  (registers)
    if config.stream_type == "kinesis" and "kinesis" not in _FACTORIES:
        from pinot_tpu_torch.stream import kinesis_stream  # noqa: F401  (registers)
    if config.stream_type == "pulsar" and "pulsar" not in _FACTORIES:
        from pinot_tpu_torch.stream import pulsar_stream  # noqa: F401  (registers)
    try:
        cls = _FACTORIES[config.stream_type]
    except KeyError:
        raise KeyError(
            f"unknown stream type {config.stream_type!r}; registered: "
            f"{sorted(_FACTORIES)}"
        ) from None
    return cls(config)
