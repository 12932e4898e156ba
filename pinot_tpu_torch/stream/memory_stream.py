"""In-memory stream: the embedded-Kafka analog for tests and quickstarts
(a copy of pinot_tpu/stream/memory_stream.py for the port).

The reference's integration tests start an embedded Kafka broker
(BaseClusterIntegrationTest.startKafka); here an in-process, thread-safe
topic registry plays that role. Producers publish bytes per partition;
consumers fetch by offset, exactly like a log.
"""

from __future__ import annotations

import threading
from typing import Optional

from pinot_tpu_torch.common.table_config import StreamConfig
from pinot_tpu_torch.stream.spi import (
    MessageBatch,
    PartitionGroupConsumer,
    StreamConsumerFactory,
    StreamMessage,
    StreamPartitionMsgOffset,
    register_stream_type,
)


class InMemoryTopic:
    def __init__(self, name: str, num_partitions: int = 1):
        self.name = name
        self._partitions: list[list[bytes]] = [[] for _ in range(num_partitions)]
        self._lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def publish(self, payload: bytes, partition: int = 0, key: Optional[bytes] = None):
        with self._lock:
            self._partitions[partition].append(payload)

    def publish_json(self, obj: dict, partition: int = 0) -> None:
        import json

        self.publish(json.dumps(obj).encode("utf-8"), partition)

    def log_size(self, partition: int) -> int:
        with self._lock:
            return len(self._partitions[partition])

    def read(self, partition: int, start: int, max_count: int) -> list:
        with self._lock:
            return self._partitions[partition][start : start + max_count]


class TopicRegistry:
    """Process-wide topic namespace (the 'broker')."""

    _topics: dict[str, InMemoryTopic] = {}
    _lock = threading.Lock()

    @classmethod
    def create(cls, name: str, num_partitions: int = 1) -> InMemoryTopic:
        with cls._lock:
            if name not in cls._topics:
                cls._topics[name] = InMemoryTopic(name, num_partitions)
            return cls._topics[name]

    @classmethod
    def get(cls, name: str) -> InMemoryTopic:
        with cls._lock:
            try:
                return cls._topics[name]
            except KeyError:
                raise KeyError(f"topic {name!r} does not exist") from None

    @classmethod
    def delete(cls, name: str) -> None:
        with cls._lock:
            cls._topics.pop(name, None)


class MemoryPartitionConsumer(PartitionGroupConsumer):
    def __init__(self, topic: InMemoryTopic, partition: int, max_batch: int = 1000):
        self._topic = topic
        self._partition = partition
        self._max_batch = max_batch

    def fetch_messages(self, start_offset: StreamPartitionMsgOffset,
                       timeout_ms: int) -> MessageBatch:
        start = start_offset.value
        payloads = self._topic.read(self._partition, start, self._max_batch)
        messages = [
            StreamMessage(StreamPartitionMsgOffset(start + i), p)
            for i, p in enumerate(payloads)
        ]
        return MessageBatch(messages, StreamPartitionMsgOffset(start + len(payloads)))

    def fetch_payload_batch(self, start_offset: StreamPartitionMsgOffset,
                            max_count: int):
        """Columnar-ingest fast path (realtime/chunklet.py): raw payloads +
        next offset, skipping per-message StreamMessage/offset object
        construction (~2.5us/message — above the whole columnar index cost
        per row). Optional SPI surface: consumers without it fall back to
        fetch_messages."""
        start = start_offset.value
        payloads = self._topic.read(self._partition, start, max_count)
        return payloads, StreamPartitionMsgOffset(start + len(payloads))


class MemoryStreamConsumerFactory(StreamConsumerFactory):
    def partition_count(self) -> int:
        return TopicRegistry.get(self.config.topic).num_partitions

    def create_partition_consumer(self, partition: int) -> PartitionGroupConsumer:
        return MemoryPartitionConsumer(TopicRegistry.get(self.config.topic), partition)


register_stream_type("memory", MemoryStreamConsumerFactory)
