"""Thrift input format (pinot-plugins/pinot-input-format/pinot-thrift
analog): TBinaryProtocol struct records → row dicts.

The reference's ThriftRecordReader deserializes through a GENERATED thrift
class (thriftClass config) and maps field ids to names via its metadata
map. A Python build has no generated classes, so the decoder here speaks
the TBinaryProtocol WIRE FORMAT directly — field headers are
self-describing (type byte + int16 field id) — and maps field ids to
column names through the reader config (``thrift.field.map``:
``"1:name,2:age"``), the role the generated class's FieldMetaData plays.
Strict protocol framing (versioned or unversioned struct encoding), no
external thrift dependency.

Supported field types cover FieldSpec's data model: BOOL, BYTE, I16, I32,
I64, DOUBLE, STRING/BINARY, and LIST thereof (multi-value columns).
Nested STRUCT/MAP/SET fields are skipped field-accurately (their bytes
are consumed) — the reference flattens only declared fields too.

A copy of pinot_tpu/ingestion/thrift_io.py for the port.
"""

from __future__ import annotations

import struct
from typing import Optional

# TType codes (thrift protocol constants)
T_STOP, T_BOOL, T_BYTE, T_DOUBLE = 0, 2, 3, 4
T_I16, T_I32, T_I64 = 6, 8, 10
T_STRING, T_STRUCT, T_MAP, T_SET, T_LIST = 11, 12, 13, 14, 15


class _Buf:
    __slots__ = ("b", "o")

    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def take(self, n: int) -> bytes:
        if self.o + n > len(self.b):
            raise EOFError("truncated thrift record")
        out = self.b[self.o: self.o + n]
        self.o += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.take(8))[0]


def _read_value(buf: _Buf, ttype: int, binary: bool = False):
    if ttype == T_BOOL:
        return buf.u8() != 0
    if ttype == T_BYTE:
        return struct.unpack(">b", buf.take(1))[0]
    if ttype == T_DOUBLE:
        return buf.f64()
    if ttype == T_I16:
        return buf.i16()
    if ttype == T_I32:
        return buf.i32()
    if ttype == T_I64:
        return buf.i64()
    if ttype == T_STRING:
        n = buf.i32()
        raw = buf.take(n)
        if binary:
            return raw  # declared BINARY: bytes, always
        # declared STRING: str, always — the wire type (11) doesn't
        # distinguish string/binary, so the field map's annotation does;
        # content-dependent str-or-bytes would be type-unstable per column
        return raw.decode("utf-8")
    if ttype in (T_LIST, T_SET):
        et = buf.u8()
        n = buf.i32()
        return [_read_value(buf, et, binary) for _ in range(n)]
    if ttype == T_MAP:
        kt, vt = buf.u8(), buf.u8()
        n = buf.i32()
        return {_read_value(buf, kt): _read_value(buf, vt) for _ in range(n)}
    if ttype == T_STRUCT:
        return _read_struct(buf, None)
    raise ValueError(f"unsupported thrift type {ttype}")


def _read_struct(buf: _Buf, field_names: Optional[dict]):
    """One struct's fields; ``field_names`` maps field-id →
    (column name, is_binary) (None → id-keyed dict for nested structs)."""
    out: dict = {}
    while True:
        ftype = buf.u8()
        if ftype == T_STOP:
            return out
        fid = buf.i16()
        decl = field_names.get(fid) if field_names is not None else None
        val = _read_value(buf, ftype,
                          binary=bool(decl and decl[1]))
        if field_names is None:
            out[fid] = val
        elif decl is not None:
            out[decl[0]] = val
        # undeclared fields: bytes consumed, value dropped (reference
        # reads only the thrift class's declared fields)


def parse_field_map(spec: str) -> dict:
    """'1:name,2:age,3:blob#bytes' → {1: ('name', False), 2: ('age',
    False), 3: ('blob', True)}. The ``#bytes`` annotation marks a BINARY
    field (thrift's wire type 11 covers both string and binary; the
    generated class's metadata makes the call in the reference — the
    annotation plays that role here, keeping each column type-stable)."""
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        fid, name = part.split(":", 1)
        name = name.strip()
        binary = name.endswith("#bytes")
        if binary:
            name = name[: -len("#bytes")].strip()
        out[int(fid)] = (name, binary)
    if not out:
        raise ValueError(
            "thrift decoder needs a field map ('thrift.field.map' = "
            "'1:col,2:col2') — the role the generated class plays in the "
            "reference's ThriftRecordReader")
    return out


def decode_record(payload: bytes, field_names: dict) -> dict:
    """One TBinaryProtocol struct → row dict. Accepts both the bare struct
    encoding and the versioned strict framing some serializers emit."""
    buf = _Buf(payload)
    # strict framing starts with a negative i32 version word; the bare
    # struct encoding starts with a field-type byte (< 16)
    if len(payload) >= 4 and payload[0] & 0x80:
        buf.i32()  # VERSION_1 | message type
        name_len = buf.i32()
        buf.take(name_len)
        buf.i32()  # seqid
    return _read_struct(buf, field_names)


def binary_decoder_for(field_map_spec: str):
    names = parse_field_map(field_map_spec)

    def decode(payload: bytes) -> dict:
        return decode_record(payload, names)

    return decode


def encode_record(row: dict, field_map: dict) -> bytes:
    """Row → TBinaryProtocol struct bytes (test fixture / writer utility;
    field_map: id → name). Types are inferred: bool, int (i64), float
    (double), str, bytes, list thereof."""
    out = bytearray()

    def w_value(v):
        if isinstance(v, bool):
            return T_BOOL, bytes([1 if v else 0])
        if isinstance(v, int):
            return T_I64, struct.pack(">q", v)
        if isinstance(v, float):
            return T_DOUBLE, struct.pack(">d", v)
        if isinstance(v, str):
            b = v.encode("utf-8")
            return T_STRING, struct.pack(">i", len(b)) + b
        if isinstance(v, (bytes, bytearray)):
            return T_STRING, struct.pack(">i", len(v)) + bytes(v)
        if isinstance(v, (list, tuple)):
            if not v:
                return T_LIST, bytes([T_STRING]) + struct.pack(">i", 0)
            et, _ = w_value(v[0])
            body = b"".join(w_value(x)[1] for x in v)
            return T_LIST, bytes([et]) + struct.pack(">i", len(v)) + body
        raise TypeError(f"unsupported thrift test value {type(v)}")

    for fid, name in sorted(field_map.items()):
        if isinstance(name, tuple):  # parse_field_map form (name, binary)
            name = name[0]
        if name not in row:
            continue
        ttype, body = w_value(row[name])
        out += bytes([ttype]) + struct.pack(">h", fid) + body
    out += bytes([T_STOP])
    return bytes(out)
