"""Pure-python Apache Avro codec: binary records + Object Container Files.

A copy of pinot_tpu/ingestion/avro_io.py for the port. No avro library is
assumed, and Avro is the canonical Pinot
ingestion payload (pinot-plugins/pinot-input-format/pinot-avro/ for batch,
SimpleAvroMessageDecoder / KafkaConfluentSchemaRegistryAvroMessageDecoder
for realtime) — so the format is implemented here from the Avro 1.11 spec:

- binary encoding: zigzag-varint longs, little-endian IEEE float/double,
  length-prefixed bytes/UTF-8 strings, block-encoded arrays/maps,
  union-index-prefixed unions, enums as index, fixed as raw bytes;
- Object Container Files: magic ``Obj\\x01``, metadata map carrying
  ``avro.schema`` + ``avro.codec`` (null and deflate supported), 16-byte
  sync marker, blocks of (record count, byte length, payload, sync).

A writer is included (the reference only reads Avro, but test fixtures and
the quickstart need files to exist without an external library).

Logical types are passed through as their underlying primitives, matching
the reference's GenericRow handling.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib


MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# binary primitives
# ---------------------------------------------------------------------------


def _read_long(buf: io.BytesIO) -> int:
    """Zigzag varint (Avro int and long share the encoding)."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
        if shift > 63:
            # Avro longs are 64-bit: an endless 0x80 run in a corrupt file
            # must fail fast, not grow a bigint unboundedly
            raise ValueError("varint exceeds 64 bits (corrupt avro data)")
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63) if n < 0 else (n << 1)
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema-driven decode / encode
# ---------------------------------------------------------------------------


def _norm_schema(schema, names=None):
    """Resolve named-type references and normalize to dict/list/str form."""
    if names is None:
        names = {}
    if isinstance(schema, str):
        if schema in names:
            return names[schema]
        return schema
    if isinstance(schema, list):
        return [_norm_schema(s, names) for s in schema]
    t = schema.get("type")
    if t in ("record", "enum", "fixed"):
        names[schema["name"]] = schema
        if t == "record":
            for f in schema["fields"]:
                f["type"] = _norm_schema(f["type"], names)
    elif t == "array":
        schema["items"] = _norm_schema(schema["items"], names)
    elif t == "map":
        schema["values"] = _norm_schema(schema["values"], names)
    return schema


def decode_value(buf: io.BytesIO, schema):
    if isinstance(schema, list):  # union: index then value
        idx = _read_long(buf)
        return decode_value(buf, schema[idx])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: decode_value(buf, f["type"])
                    for f in schema["fields"]}
        if t == "array":
            out = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:  # block with byte-size prefix
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    out.append(decode_value(buf, schema["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:
                    _read_long(buf)
                    n = -n
                for _ in range(n):
                    k = _read_bytes(buf).decode("utf-8")
                    out[k] = decode_value(buf, schema["values"])
            return out
        if t == "enum":
            return schema["symbols"][_read_long(buf)]
        if t == "fixed":
            return buf.read(schema["size"])
        return decode_value(buf, t)  # {"type": "long", ...} primitive form
    if schema == "null":
        return None
    if schema == "boolean":
        return buf.read(1) == b"\x01"
    if schema in ("int", "long"):
        return _read_long(buf)
    if schema == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if schema == "bytes":
        return _read_bytes(buf)
    if schema == "string":
        return _read_bytes(buf).decode("utf-8")
    raise ValueError(f"unsupported avro schema {schema!r}")


def encode_value(out: io.BytesIO, schema, value) -> None:
    if isinstance(schema, list):  # union: pick the first matching branch
        for i, s in enumerate(schema):
            if _matches(s, value):
                _write_long(out, i)
                encode_value(out, s, value)
                return
        raise ValueError(f"value {value!r} matches no union branch {schema}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                v = value.get(f["name"])
                if v is None and not _nullable(f["type"]):
                    # str(None)/int(None) would silently corrupt the file
                    # or raise a context-free TypeError rows later
                    raise ValueError(
                        f"missing required avro field {f['name']!r} "
                        f"(schema {schema.get('name', '?')})")
                encode_value(out, f["type"], v)
            return
        if t == "array":
            if value:
                _write_long(out, len(value))
                for v in value:
                    encode_value(out, schema["items"], v)
            _write_long(out, 0)
            return
        if t == "map":
            if value:
                _write_long(out, len(value))
                for k, v in value.items():
                    _write_bytes(out, str(k).encode("utf-8"))
                    encode_value(out, schema["values"], v)
            _write_long(out, 0)
            return
        if t == "enum":
            _write_long(out, schema["symbols"].index(value))
            return
        if t == "fixed":
            out.write(value)
            return
        encode_value(out, t, value)
        return
    if schema == "null":
        return
    if schema == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif schema in ("int", "long"):
        _write_long(out, int(value))
    elif schema == "float":
        out.write(struct.pack("<f", float(value)))
    elif schema == "double":
        out.write(struct.pack("<d", float(value)))
    elif schema == "bytes":
        _write_bytes(out, bytes(value))
    elif schema == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    else:
        raise ValueError(f"unsupported avro schema {schema!r}")


def _nullable(schema) -> bool:
    if schema == "null":
        return True
    if isinstance(schema, list):
        return any(_nullable(s) for s in schema)
    return isinstance(schema, dict) and schema.get("type") == "null"


def _matches(schema, value) -> bool:
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return value is None
    if value is None:
        return False
    if t == "boolean":
        return isinstance(value, bool)
    if t in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if t in ("float", "double"):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t in ("bytes", "fixed"):
        return isinstance(value, (bytes, bytearray))
    if t in ("string", "enum"):
        return isinstance(value, str)
    if t == "array":
        return isinstance(value, (list, tuple))
    if t == "map":
        return isinstance(value, dict)
    if t == "record":
        return isinstance(value, dict)
    return False


# ---------------------------------------------------------------------------
# Object Container Files
# ---------------------------------------------------------------------------


def read_container(path: str) -> list:
    """[(record dict), ...] from an Avro Object Container File."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path} is not an Avro container file")
    meta = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:
            _read_long(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode("utf-8")
            meta[k] = _read_bytes(buf)
    schema = _norm_schema(json.loads(meta["avro.schema"].decode("utf-8")))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = buf.read(16)
    rows = []
    while buf.tell() < len(data):
        count = _read_long(buf)
        block = _read_bytes(buf)
        if codec == "deflate":
            block = zlib.decompress(block, -15)  # raw deflate per spec
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        bbuf = io.BytesIO(block)
        for _ in range(count):
            rows.append(decode_value(bbuf, schema))
        if buf.read(16) != sync:
            raise ValueError("avro sync marker mismatch (corrupt file)")
    return rows


def write_container(path: str, schema: dict, rows: list,
                    codec: str = "null", sync: bytes = b"\x07" * 16) -> None:
    schema = _norm_schema(dict(schema))
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8")}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode("utf-8"))
        _write_bytes(out, v)
    _write_long(out, 0)
    out.write(sync)
    block = io.BytesIO()
    for r in rows:
        encode_value(block, schema, r)
    payload = block.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()
    elif codec != "null":
        raise ValueError(f"unsupported avro codec {codec!r}")
    _write_long(out, len(rows))
    _write_bytes(out, payload)
    out.write(sync)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def schema_for_pinot(schema) -> dict:
    """Avro record schema matching a pinot_tpu_torch Schema (test/demo helper)."""
    fields = []
    for name, spec in schema.fields.items():
        dt = spec.data_type.name
        base = {"INT": "int", "LONG": "long", "FLOAT": "float",
                "DOUBLE": "double", "BOOLEAN": "boolean", "STRING": "string",
                "BYTES": "bytes", "TIMESTAMP": "long", "JSON": "string",
                "BIG_DECIMAL": "string"}.get(dt, "string")
        t = base if spec.single_value else {"type": "array", "items": base}
        fields.append({"name": name, "type": t})
    return {"type": "record", "name": schema.name or "row", "fields": fields}


def binary_decoder_for(schema_json: str):
    """Schemaful payload decoder for realtime streams
    (SimpleAvroMessageDecoder analog): each message is one binary-encoded
    record with no container framing."""
    schema = _norm_schema(json.loads(schema_json))

    def decode(payload: bytes) -> dict:
        return decode_value(io.BytesIO(payload), schema)

    return decode


def encode_record(schema, record: dict) -> bytes:
    """One binary record (test/producer helper for the stream decoder)."""
    schema = _norm_schema(schema if isinstance(schema, dict)
                          else json.loads(schema))
    out = io.BytesIO()
    encode_value(out, schema, record)
    return out.getvalue()
