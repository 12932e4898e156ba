"""Protobuf input format (pinot-plugins/pinot-input-format/pinot-protobuf
analog), gated on the google.protobuf runtime.

Mirrors the reference's configuration shape: a compiled descriptor set
(``protoc --descriptor_set_out``) names the schema and ``message_name``
picks the record type (ProtoBufRecordReaderConfig: descriptorFile +
protoClassName). Batch files hold length-delimited messages (varint length
prefix, the standard delimited framing the reference reader consumes);
stream payloads are single serialized messages
(ProtoBufMessageDecoder analog).

Records decode to plain dicts with original field names; nested messages
become nested dicts, repeated fields lists — the GenericRow shape.

A copy of pinot_tpu/ingestion/protobuf_io.py for the port.
"""

from __future__ import annotations

import io


def _protobuf():
    try:
        from google.protobuf import (  # type: ignore
            descriptor_pb2,
            json_format,
            message_factory,
        )

        return descriptor_pb2, message_factory, json_format
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "protobuf input requires the google.protobuf runtime; "
            "install protobuf or use csv/json/avro") from e


def load_message_class(descriptor_file: str, message_name: str):
    """Message class from a compiled FileDescriptorSet."""
    descriptor_pb2, message_factory, _ = _protobuf()
    fds = descriptor_pb2.FileDescriptorSet()
    with open(descriptor_file, "rb") as f:
        fds.ParseFromString(f.read())
    classes = message_factory.GetMessages(list(fds.file))
    try:
        return classes[message_name]
    except KeyError:
        raise ValueError(
            f"message {message_name!r} not in descriptor set "
            f"(available: {sorted(classes)})") from None


def message_to_row(msg) -> dict:
    _, _, json_format = _protobuf()
    try:
        return json_format.MessageToDict(
            msg, preserving_proto_field_name=True,
            always_print_fields_with_no_presence=True)
    except TypeError:
        # protobuf < 5.26 names the option differently
        return json_format.MessageToDict(
            msg, preserving_proto_field_name=True,
            including_default_value_fields=True)


def _read_varint(buf: io.BytesIO):
    """None at a clean record boundary; raises on EOF mid-varint (a
    truncated length prefix must not silently drop the partial record)."""
    shift = acc = 0
    first = True
    while True:
        b = buf.read(1)
        if not b:
            if first:
                return None
            raise ValueError("truncated varint length prefix")
        first = False
        acc |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return acc
        shift += 7


def read_delimited(path: str, descriptor_file: str, message_name: str) -> list:
    """Length-delimited message file → list of row dicts."""
    cls = load_message_class(descriptor_file, message_name)
    rows = []
    with open(path, "rb") as f:
        buf = io.BytesIO(f.read())
    while True:
        n = _read_varint(buf)
        if n is None:
            return rows
        payload = buf.read(n)
        if len(payload) != n:
            raise ValueError(f"{path}: truncated delimited message")
        msg = cls()
        msg.ParseFromString(payload)
        rows.append(message_to_row(msg))


def write_delimited(path: str, messages) -> None:
    """Test/producer helper: serialize messages with varint framing."""
    with open(path, "wb") as f:
        for m in messages:
            payload = m.SerializeToString()
            n = len(payload)
            while True:
                b = n & 0x7F
                n >>= 7
                f.write(bytes([b | 0x80] if n else [b]))
                if not n:
                    break
            f.write(payload)


def binary_decoder_for(descriptor_file: str, message_name: str):
    """Schemaful stream decoder (ProtoBufMessageDecoder analog): each
    message is one serialized record, no framing."""
    cls = load_message_class(descriptor_file, message_name)

    def decode(payload: bytes) -> dict:
        msg = cls()
        msg.ParseFromString(payload)
        return message_to_row(msg)

    return decode
