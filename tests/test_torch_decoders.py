"""The port's binary input formats against the JAX package's, on the CPU:
Avro (pure-python binary records and container files), Confluent-Avro
(schema-registry framing), Protobuf (descriptor-driven) and Thrift
(TBinaryProtocol), each through the stream SPI's ``get_decoder`` as a
realtime table reads them.

The same payloads go through both packages: decoded rows must be equal,
the encoders must write the same bytes, files written by one package must
read back in the other, and malformed input must raise the same error.
The reference tests' schemas and rows (tests/test_avro_kinesis.py,
tests/test_plugin_tail.py, tests/test_protobuf_format.py) are the inputs.
"""

import json

import pytest

import test_avro_kinesis as tak
import test_plugin_tail as tpt
import test_protobuf_format as tpf
from pinot_tpu.common import table_config as r_tc
from pinot_tpu.ingestion import avro_io as r_avro
from pinot_tpu.ingestion import confluent_avro as r_conf
from pinot_tpu.ingestion import thrift_io as r_thrift
from pinot_tpu.stream import spi as r_spi
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.ingestion import avro_io, confluent_avro, thrift_io
from pinot_tpu_torch.stream import spi as t_spi

descriptor = tpf.descriptor  # the reference's protoc-compiled fixture


def _decoders(name, props):
    """(port's, reference's) stream decoder for ``name``."""
    return (t_spi.get_decoder(name, t_tc.StreamConfig(
                stream_type="memory", topic="t", decoder=name,
                properties=props)),
            r_spi.get_decoder(name, r_tc.StreamConfig(
                stream_type="memory", topic="t", decoder=name,
                properties=props)))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared below
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# Avro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(tak.ROWS)))
def test_avro_records_match_reference(i):
    row = tak.ROWS[i]
    payload = avro_io.encode_record(tak.AVRO_SCHEMA, row)
    assert payload == r_avro.encode_record(tak.AVRO_SCHEMA, row)
    port, ref = _decoders("avro",
                          {"avro.schema": json.dumps(tak.AVRO_SCHEMA)})
    assert port(payload) == ref(payload) == row


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_containers_cross_read(tmp_path, codec):
    rows = tak.ROWS * 50
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "ref.avro")
    avro_io.write_container(mine, tak.AVRO_SCHEMA, rows, codec=codec)
    r_avro.write_container(theirs, tak.AVRO_SCHEMA, rows, codec=codec)
    assert r_avro.read_container(mine) == avro_io.read_container(theirs) \
        == rows


def test_avro_schema_for_pinot_matches_reference():
    from pinot_tpu.common import datatypes as r_dt
    from pinot_tpu.common import schema as r_sc
    from pinot_tpu_torch.common import datatypes as t_dt
    from pinot_tpu_torch.common import schema as t_sc

    def build(sc, dt):
        return sc.Schema.build(
            name="ev", dimensions=[("user", dt.DataType.STRING)],
            metrics=[("clicks", dt.DataType.LONG),
                     ("score", dt.DataType.DOUBLE)])

    assert avro_io.schema_for_pinot(build(t_sc, t_dt)) \
        == r_avro.schema_for_pinot(build(r_sc, r_dt))


def test_avro_truncated_record_raises_alike():
    payload = avro_io.encode_record(tak.AVRO_SCHEMA, tak.ROWS[0])[:-4]
    port, ref = _decoders("avro",
                          {"avro.schema": json.dumps(tak.AVRO_SCHEMA)})
    got, want = _outcome(port, payload), _outcome(ref, payload)
    assert got == want and got[0] != "ok"


# ---------------------------------------------------------------------------
# Confluent-Avro
# ---------------------------------------------------------------------------

CONF_CASES = [(7, {"k": "x", "v": 42}), (3, {"k": "", "v": -(2 ** 40)}),
              (7, {"k": "ué", "v": 0})]


@pytest.mark.parametrize("sid,row", CONF_CASES)
def test_confluent_inline_schema_matches_reference(sid, row):
    props = {f"schema.registry.schemas.{s}": json.dumps(tpt.SCHEMA)
             for s in (3, 7)}
    msg = confluent_avro.encode_confluent(sid, tpt.SCHEMA, row)
    assert msg == r_conf.encode_confluent(sid, tpt.SCHEMA, row)
    port, ref = _decoders("confluent-avro", props)
    assert port(msg) == ref(msg) == row


@pytest.mark.parametrize("msg", [
    b"\x01junk",                                       # wrong magic byte
    r_conf.encode_confluent(8, tpt.SCHEMA, {"k": "x", "v": 1}),  # unknown id
])
def test_confluent_bad_frames_raise_alike(msg):
    port = confluent_avro.ConfluentAvroDecoder(
        inline_schemas={7: json.dumps(tpt.SCHEMA)})
    ref = r_conf.ConfluentAvroDecoder(
        inline_schemas={7: json.dumps(tpt.SCHEMA)})
    got, want = _outcome(port, msg), _outcome(ref, msg)
    assert got == want and got[0] in ("ValueError", "KeyError")


def test_confluent_registry_fetch_matches_reference(monkeypatch):
    import urllib.request

    class Resp:
        def read(self):
            return json.dumps({"schema": json.dumps(tpt.SCHEMA)}).encode()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

    calls = []

    def fake_urlopen(url, timeout=None):
        calls.append(url)
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    msg = confluent_avro.encode_confluent(11, tpt.SCHEMA, {"k": "y", "v": 5})
    for cls in (confluent_avro.ConfluentAvroDecoder,
                r_conf.ConfluentAvroDecoder):
        dec = cls(registry_url="http://reg:8081")
        assert dec(msg) == dec(msg) == {"k": "y", "v": 5}
    # one fetch a decoder: the schema is cached
    assert calls == ["http://reg:8081/schemas/ids/11"] * 2


# ---------------------------------------------------------------------------
# Thrift
# ---------------------------------------------------------------------------

THRIFT_CASES = [
    ("1:name, 2:age, 3:score, 4:tags",
     {"name": "ann", "age": 41, "score": 2.5, "tags": ["x", "y"]}),
    ("1:s,2:b#bytes", {"s": "text", "b": b"abc"}),
    ("1:k,2:v", {"k": "a", "v": 7}),
    ("1:a,2:b,3:c", {"a": -(2 ** 40), "b": "", "c": -0.125}),
]


@pytest.mark.parametrize("spec,row", THRIFT_CASES)
def test_thrift_records_match_reference(spec, row):
    fmap = thrift_io.parse_field_map(spec)
    assert fmap == r_thrift.parse_field_map(spec)
    plain = {i: name for i, (name, _b) in fmap.items()}
    payload = thrift_io.encode_record(row, plain)
    assert payload == r_thrift.encode_record(row, plain)
    port, ref = _decoders("thrift", {"thrift.field.map": spec})
    assert port(payload) == ref(payload) == row


def test_thrift_undeclared_and_truncated_alike():
    payload = thrift_io.encode_record({"a": 1, "b": "keep", "c": 9.5},
                                      {1: "a", 2: "b", 3: "c"})
    port, ref = _decoders("thrift", {"thrift.field.map": "2:b"})
    assert port(payload) == ref(payload) == {"b": "keep"}
    short = thrift_io.encode_record({"a": "hello"}, {1: "a"})[:-3]
    port, ref = _decoders("thrift", {"thrift.field.map": "1:a"})
    got, want = _outcome(port, short), _outcome(ref, short)
    assert got == want and got[0] == "EOFError"


# ---------------------------------------------------------------------------
# Protobuf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(tpf.ROWS)))
def test_protobuf_messages_match_reference(descriptor, i):
    msg = tpf._messages(descriptor, [tpf.ROWS[i]])[0]
    payload = msg.SerializeToString()
    port, ref = _decoders("protobuf", {
        "protobuf.descriptor_file": descriptor,
        "protobuf.message_name": "bench.Click"})
    assert port(payload) == ref(payload)


def test_protobuf_delimited_files_cross_read(descriptor, tmp_path):
    from pinot_tpu.ingestion import protobuf_io as r_pb
    from pinot_tpu_torch.ingestion import protobuf_io

    msgs = tpf._messages(descriptor, tpf.ROWS * 20)
    mine, theirs = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
    protobuf_io.write_delimited(mine, msgs)
    r_pb.write_delimited(theirs, msgs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = protobuf_io.read_delimited(theirs, descriptor, "bench.Click")
    assert got == r_pb.read_delimited(mine, descriptor, "bench.Click")
    assert len(got) == 60


def test_missing_properties_raise_alike():
    for name in ("avro", "protobuf", "confluent-avro", "thrift"):
        got = _outcome(t_spi.get_decoder, name, t_tc.StreamConfig(
            stream_type="memory", topic="t"))
        want = _outcome(r_spi.get_decoder, name, r_tc.StreamConfig(
            stream_type="memory", topic="t"))
        assert got == want and got[0] != "ok", name
