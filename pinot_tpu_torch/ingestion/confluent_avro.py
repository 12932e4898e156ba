"""Confluent-Avro stream decoder
(pinot-plugins/pinot-input-format/pinot-confluent-avro analog:
KafkaConfluentSchemaRegistryAvroMessageDecoder).

Wire format: 1 magic byte (0) + 4-byte big-endian schema id + the avro
binary record. The writer schema resolves through a Confluent Schema
Registry (``schema.registry.url``, fetched over plain HTTP with urllib —
no extra dependency) or through inline config
(``schema.registry.schemas`` = {id: schema-json}) for air-gapped /
test deployments. Resolved schemas cache per decoder (the reference
caches via CachedSchemaRegistryClient).

A copy of pinot_tpu/ingestion/confluent_avro.py for the port.
"""

from __future__ import annotations

import io
import json
import struct

from pinot_tpu_torch.ingestion.avro_io import _norm_schema, decode_value

MAGIC = 0


class ConfluentAvroDecoder:
    def __init__(self, registry_url: str = "",
                 inline_schemas: dict | None = None,
                 timeout_s: float = 10.0):
        if not registry_url and not inline_schemas:
            raise KeyError(
                "confluent-avro decoder needs 'schema.registry.url' or "
                "inline 'schema.registry.schemas' in stream properties")
        self.registry_url = registry_url.rstrip("/")
        self.timeout_s = timeout_s
        self._cache: dict[int, dict] = {}
        for sid, sj in (inline_schemas or {}).items():
            self._cache[int(sid)] = _norm_schema(
                json.loads(sj) if isinstance(sj, str) else sj)

    def _schema(self, schema_id: int) -> dict:
        hit = self._cache.get(schema_id)
        if hit is not None:
            return hit
        if not self.registry_url:
            raise KeyError(
                f"schema id {schema_id} not in inline schemas and no "
                f"registry url configured")
        import urllib.request

        with urllib.request.urlopen(
                f"{self.registry_url}/schemas/ids/{schema_id}",
                timeout=self.timeout_s) as resp:
            body = json.loads(resp.read().decode("utf-8"))
        schema = _norm_schema(json.loads(body["schema"]))
        self._cache[schema_id] = schema
        return schema

    def __call__(self, payload: bytes) -> dict:
        if len(payload) < 5 or payload[0] != MAGIC:
            raise ValueError(
                "not a Confluent-framed message (magic byte 0 + schema id)")
        schema_id = struct.unpack(">I", payload[1:5])[0]
        return decode_value(io.BytesIO(payload[5:]),
                            self._schema(schema_id))


def encode_confluent(schema_id: int, schema, record: dict) -> bytes:
    """Producer/test helper: frame one record the Confluent way."""
    from pinot_tpu_torch.ingestion.avro_io import encode_record

    return bytes([MAGIC]) + struct.pack(">I", schema_id) \
        + encode_record(schema, record)
