"""Compressed raw forward indexes and the sub-byte tier on the port.

Storage: a raw single-value column compressed in 256 KiB chunks with
zlib, zstd or lz4 (``<col>.fwdz.bin`` + ``<col>.fwdz.off.npy``), through
the port's own codec library (pinot_tpu_torch/native/packer.cpp, built
with g++ into ``pinot_tpu_torch/_build/``) or its Python codecs. Each
codec is written by each package and read by the other; a compressed
column answers in filters, keys, aggregations and selection exactly as
its uncompressed twin does, and as the reference does; a truncated or
corrupt blob raises.

The sub-byte tier (``PINOT_TPU_SUBBYTE=1``, read when a batch is built):
dict id planes of C <= 3 pack 2 bits, C <= 15 4 bits, unpacked by torch
ops before a kernel reads them. The plans at the cardinality edges
(3 / 4, 15 / 16), the resident bytes against the wide load, and the
answers, equal to the wide load's and the reference's.

Also replayed through the port: tests/test_native_packer.py's
TestChunkCompression and TestPackedSegments, and tests/test_narrow.py's
``TestSubByteTier::test_subbyte_opt_in_parity`` (the port's ``column``
gives the unpacked ids, so the replay reads the packed plane through
``packed_column``).
"""

import os
import sys

import numpy as np
import pytest

import pinot_tpu
import test_narrow
import test_native_packer
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment as ref_build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch import native
from pinot_tpu_torch.common.datatypes import DataType as PortDataType
from pinot_tpu_torch.common.schema import Schema as PortSchema
from pinot_tpu_torch.common.table_config import IndexingConfig as PortIndexing
from pinot_tpu_torch.common.table_config import TableConfig as PortTableConfig
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.params import BatchContext
from pinot_tpu_torch.storage.creator import build_segment
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_multivalue import assert_same_response
from test_torch_sketches import _PortEngine

CODECS = ("zlib", "zstd", "lz4")
SIZES = (3000, 4500)


def _schema(cls, D):
    return cls.build(
        name="z", dimensions=[("k", D.STRING), ("ts", D.LONG)],
        metrics=[("fare", D.DOUBLE), ("n", D.INT), ("q", D.FLOAT)])


def _columns(n: int, rng, seg: int) -> dict:
    return {"k": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)],
            "ts": np.sort(seg * 1_000_000 + rng.integers(0, 900_000, n))
            .astype(np.int64),
            "fare": rng.integers(250, 9000, n) / 100.0,
            "n": rng.integers(-20, 40, n).astype(np.int32),
            "q": rng.uniform(0, 5, n).astype(np.float32)}


def _write(base, writer: str, codec) -> list:
    """Segments written by ``writer`` ("ref" or "port"), their raw columns
    compressed with ``codec`` (None: uncompressed)."""
    rng = np.random.default_rng(21)
    raw = ["ts", "fare", "n", "q"]
    codecs = {c: codec for c in raw} if codec else {}
    if writer == "ref":
        build, schema = ref_build_segment, _schema(Schema, DataType)
        cfg = TableConfig(table_name="z", indexing=IndexingConfig(
            no_dictionary_columns=raw, compression_codec=codecs))
    else:
        build, schema = build_segment, _schema(PortSchema, PortDataType)
        cfg = PortTableConfig(table_name="z", indexing=PortIndexing(
            no_dictionary_columns=raw, compression_codec=codecs))
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build(schema, _columns(n, rng, i), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


def _port(dirs, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        eng.add_segment("z", ImmutableSegment(d))
    return eng


def _ref(dirs) -> RefEngine:
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in dirs:
        eng.add_segment("z", RefSegment(d))
    return eng


SQL = {
    "scan": "SELECT COUNT(*), SUM(fare), SUM(n), MIN(q), MAX(ts) FROM z",
    "filter_range": ("SELECT COUNT(*), SUM(fare) FROM z WHERE ts BETWEEN "
                     "200000 AND 1300000"),
    "filter_raw": "SELECT COUNT(*), MAX(fare) FROM z WHERE n > 10 AND q < 2",
    "group_dict": ("SELECT k, COUNT(*), SUM(fare), MIN(n), MAX(q) FROM z "
                   "GROUP BY k ORDER BY k"),
    "group_raw_key": ("SELECT n, COUNT(*), SUM(fare) FROM z GROUP BY n "
                      "ORDER BY n LIMIT 15"),
    "selection": "SELECT ts, fare, n, q, k FROM z ORDER BY ts DESC LIMIT 12",
    "distinct": "SELECT DISTINCT n FROM z ORDER BY n LIMIT 20",
    "sumprecision": "SELECT k, SUMPRECISION(fare) FROM z GROUP BY k",
    "expression_key": ("SELECT ROUNDDECIMAL(fare, 0), COUNT(*) FROM z "
                       "GROUP BY ROUNDDECIMAL(fare, 0) ORDER BY COUNT(*) "
                       "DESC, ROUNDDECIMAL(fare, 0) LIMIT 5"),
}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_compressed")
    out = {("plain", None): _write(base / "plain", "port", None)}
    for codec in CODECS:
        if native.available_codecs()[codec] is None:
            continue
        for writer in ("ref", "port"):
            out[(writer, codec)] = _write(base / f"{writer}_{codec}",
                                          writer, codec)
    return out


def _needs(codec):
    if native.available_codecs()[codec] is None:
        pytest.skip(f"{codec} has neither a library nor a Python codec here")


def test_codec_library_builds_into_build_dir():
    path = native.library_path()
    assert path is not None
    assert os.path.dirname(path) == os.path.normpath(native.BUILD_DIR)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    here = os.path.dirname(native.__file__)
    assert not any(f.endswith(".so") for f in os.listdir(here))
    codecs = native.available_codecs()
    assert codecs["zlib"] and codecs["lz4"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others(tables, writer, codec):
    """A segment either package writes loads in the other, value for
    value, with the codec in its metadata."""
    _needs(codec)
    dirs = tables[(writer, codec)]
    reader = ImmutableSegment if writer == "ref" else RefSegment
    rng = np.random.default_rng(21)
    for i, (d, n) in enumerate(zip(dirs, SIZES)):
        want = _columns(n, rng, i)
        seg = reader(d)
        for c in ("ts", "fare", "n", "q"):
            assert seg.column_metadata(c).compression == codec
            np.testing.assert_array_equal(np.asarray(seg.forward(c)),
                                          want[c])
        assert os.path.exists(os.path.join(d, "fare.fwdz.bin"))
        assert not os.path.exists(os.path.join(d, "fare.fwd.npy"))


@pytest.mark.parametrize("name", sorted(SQL))
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_equals_plain_twin(tables, codec, name):
    """Over the port's and the reference's writes alike, a compressed
    column answers as its uncompressed twin, and as the reference."""
    _needs(codec)
    sql = SQL[name]
    plain = _port(tables[("plain", None)]).execute(sql)
    for writer in ("ref", "port"):
        dirs = tables[(writer, codec)]
        for gate in (0, None):
            got = _port(dirs, gate).execute(sql)
            assert got["exceptions"] == [], got
            assert got["resultTable"] == plain["resultTable"], (writer, gate)
        assert_same_response(_port(dirs).execute(sql),
                             _ref(dirs).execute(sql))


@pytest.mark.parametrize("codec", CODECS)
def test_truncated_or_corrupt_blob_raises(codec):
    _needs(codec)
    data = np.random.default_rng(2).integers(0, 9, 200_000).astype(np.int64)
    blob, offs = native.compress_chunks(data, codec=codec)
    with pytest.raises(ValueError, match="corrupt"):
        native.decompress_chunks(blob[: len(blob) // 2], offs, data.nbytes,
                                 codec=codec)
    bad = blob.copy()
    bad[2: 40] ^= 0x5A
    with pytest.raises(ValueError, match="corrupt"):
        native.decompress_chunks(bad, offs, data.nbytes, codec=codec)
    with pytest.raises(ValueError, match="corrupt"):
        native.decompress_chunks(blob, offs[:-1], data.nbytes, codec=codec)


@pytest.mark.parametrize("codec", CODECS)
def test_python_codecs_read_the_library_bytes(codec, monkeypatch):
    """Without the library (``PINOT_TPU_NO_NATIVE=1``) the Python codecs
    read what it wrote, and it reads what they wrote."""
    _needs(codec)
    if codec == "zstd" and not native._has_zstandard():
        pytest.skip("the Python zstd codec needs the zstandard package")
    data = np.random.default_rng(3).integers(0, 64, 700_000).astype(np.int32)
    blob, offs = native.compress_chunks(data, codec=codec)
    monkeypatch.setenv("PINOT_TPU_NO_NATIVE", "1")
    out = native.decompress_chunks(blob, offs, data.nbytes, codec=codec)
    np.testing.assert_array_equal(out.view(np.int32), data)
    blob_py, offs_py = native.compress_chunks(data, codec=codec)
    monkeypatch.delenv("PINOT_TPU_NO_NATIVE")
    out = native.decompress_chunks(blob_py, offs_py, data.nbytes,
                                   codec=codec)
    np.testing.assert_array_equal(out.view(np.int32), data)


# ---------------------------------------------------------------------------
# the sub-byte tier
# ---------------------------------------------------------------------------


def _tier_dirs(base) -> list:
    """Dict columns at the tiers' cardinality edges: 3 and 4 values (2-bit
    and 4-bit), 15 and 16 (4-bit and a byte), beside a raw metric."""
    rng = np.random.default_rng(8)
    D = PortDataType
    schema = PortSchema.build(name="sb", dimensions=[
        ("c3", D.STRING), ("c4", D.INT), ("c15", D.STRING), ("c16", D.INT)],
        metrics=[("m", D.INT), ("x", D.DOUBLE)])
    cfg = PortTableConfig(table_name="sb", indexing=PortIndexing(
        no_dictionary_columns=["m", "x"]))
    dirs = []
    for i, n in enumerate((5000, 6100)):
        cols = {"c3": np.array(["p", "q", "r"])[rng.integers(0, 3, n)],
                "c4": rng.integers(0, 4, n).astype(np.int32) * 10,
                "c15": np.array([f"v{j:02d}" for j in range(15)])[
                    rng.integers(0, 15, n)],
                "c16": rng.integers(0, 16, n).astype(np.int32),
                "m": rng.integers(0, 1000, n).astype(np.int32),
                "x": rng.uniform(-1, 1, n)}
        out = str(base / f"s{i}")
        build_segment(schema, cols, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def tier_dirs(tmp_path_factory):
    return _tier_dirs(tmp_path_factory.mktemp("torch_subbyte"))


def _tier_engine(dirs, subbyte: bool, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        eng.add_segment("sb", ImmutableSegment(d))
    old = os.environ.pop("PINOT_TPU_SUBBYTE", None)
    if subbyte:
        os.environ["PINOT_TPU_SUBBYTE"] = "1"
    try:   # plans are read when the batch is built
        eng.execute("SELECT COUNT(*) FROM sb")
    finally:
        os.environ.pop("PINOT_TPU_SUBBYTE", None)
        if old is not None:
            os.environ["PINOT_TPU_SUBBYTE"] = old
    return eng


TIER_SQL = [
    "SELECT c3, c4, COUNT(*), SUM(m), MIN(x), MAX(m) FROM sb GROUP BY c3, c4 "
    "ORDER BY c3, c4",
    "SELECT c15, COUNT(*), SUM(x) FROM sb WHERE c16 IN (3, 15) GROUP BY c15 "
    "ORDER BY c15",
    "SELECT COUNT(*), SUM(m) FROM sb WHERE c3 = 'q' AND c4 BETWEEN 10 AND 20",
    "SELECT c16, DISTINCTCOUNT(c15), DISTINCTCOUNTHLL(c3) FROM sb "
    "GROUP BY c16 ORDER BY c16",
    "SELECT c3, c15, m FROM sb WHERE c4 = 30 ORDER BY m DESC, c15 LIMIT 10",
    "SELECT DISTINCT c4, c3 FROM sb ORDER BY c4, c3",
    "SELECT CONCAT(c3, c15, '-'), COUNT(*) FROM sb GROUP BY "
    "CONCAT(c3, c15, '-') ORDER BY COUNT(*) DESC, CONCAT(c3, c15, '-') "
    "LIMIT 5",
    "SELECT COUNT(*) FROM sb WHERE c15 LIKE 'v1%'",
]


def test_subbyte_plans_at_the_edges(tier_dirs, monkeypatch):
    segs = [ImmutableSegment(d) for d in tier_dirs]
    monkeypatch.setenv("PINOT_TPU_SUBBYTE", "1")
    ctx = BatchContext(segs, "cpu")
    assert {c: ctx.width_plan(c).bits for c in ("c3", "c4", "c15", "c16")} \
        == {"c3": 2, "c4": 4, "c15": 4, "c16": 0}
    for c, bits in (("c3", 2), ("c4", 4), ("c15", 4)):
        packed = ctx.packed_column(c)
        assert packed.dtype == np.dtype(np.uint8) or str(packed.dtype) \
            == "torch.uint8"
        assert tuple(packed.shape) == (2, ctx.pad_to * bits // 8)
    monkeypatch.delenv("PINOT_TPU_SUBBYTE")
    wide = BatchContext(segs, "cpu")
    for c in ("c3", "c4", "c15", "c16"):
        assert wide.width_plan(c).bits == 0
        np.testing.assert_array_equal(ctx.column(c).numpy(),
                                      wide.column(c).numpy())
        lo, hi = ctx.zone_map(c)
        wlo, whi = wide.zone_map(c)
        np.testing.assert_array_equal(lo.numpy(), wlo.numpy())
        np.testing.assert_array_equal(hi.numpy(), whi.numpy())
    assert ctx.resident_bytes < wide.resident_bytes
    assert ctx.narrow_saved_bytes > wide.narrow_saved_bytes > 0


@pytest.mark.parametrize("sql", TIER_SQL)
def test_subbyte_answers_equal_the_wide_load(tier_dirs, sql):
    want = _tier_engine(tier_dirs, False).execute(sql)
    assert want["exceptions"] == [], want
    for gate in (0, None):
        got = _tier_engine(tier_dirs, True, gate).execute(sql)
        assert got["exceptions"] == [], got
        for key in ("resultTable", "numDocsScanned",
                    "numEntriesScannedInFilter",
                    "numEntriesScannedPostFilter"):
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the reference's packer and sub-byte tests through the port
# ---------------------------------------------------------------------------


@pytest.fixture
def packer_on_port(monkeypatch):
    """test_native_packer's names routed to the port: its codec module
    (also where a test imports ``pinot_tpu.native``), engine, creator,
    segment, schema and config classes."""
    m = test_native_packer
    monkeypatch.setattr(m, "native", native)
    monkeypatch.setattr(pinot_tpu, "native", native, raising=False)
    monkeypatch.setitem(sys.modules, "pinot_tpu.native", native)
    monkeypatch.setattr(m, "QueryEngine", _PortEngine)
    monkeypatch.setattr(m, "build_segment", build_segment)
    monkeypatch.setattr(m, "ImmutableSegment", ImmutableSegment)
    monkeypatch.setattr(m, "Schema", PortSchema)
    monkeypatch.setattr(m, "DataType", PortDataType)
    monkeypatch.setattr(m, "IndexingConfig", PortIndexing)
    monkeypatch.setattr(m, "TableConfig", PortTableConfig)


def _methods(cls) -> list:
    return sorted(n for n in vars(cls) if n.startswith("test_"))


CHUNK_TESTS = [(n, None) for n in _methods(
    test_native_packer.TestChunkCompression)
    if n not in ("test_all_codecs_roundtrip_native_and_fallback",
                 "test_codec_segment_roundtrip")]
CHUNK_TESTS += [("test_all_codecs_roundtrip_native_and_fallback", c)
                for c in CODECS]
CHUNK_TESTS += [("test_codec_segment_roundtrip", c) for c in ("zstd", "lz4")]


@pytest.mark.parametrize("name,codec", CHUNK_TESTS)
def test_chunk_compression_through_the_port(packer_on_port, tmp_path, name,
                                            codec):
    fn = getattr(test_native_packer.TestChunkCompression(), name)
    args = [] if name in ("test_roundtrip_native_and_fallback", "test_empty",
                          "test_corrupt_blob_raises",
                          "test_lz4_python_fallback_format_is_valid") \
        else [tmp_path] if codec is None else [codec] \
        if name == "test_all_codecs_roundtrip_native_and_fallback" \
        else [tmp_path, codec]
    fn(*args)


def test_packed_segments_through_the_port(packer_on_port, tmp_path):
    test_native_packer.TestPackedSegments() \
        .test_packed_matches_plain_and_is_smaller(tmp_path)


def test_chunk_replay_covers_the_class():
    assert len(_methods(test_native_packer.TestChunkCompression)) == 8
    assert len(CHUNK_TESTS) == 11


class _PortContext(BatchContext):
    """The port's batch behind the reference's constructor, its
    ``column`` the plane as held (packed where sub-byte)."""

    _pack_subbyte_np = staticmethod(lambda blocks, bits: None)

    def __init__(self, segs):
        super().__init__([ImmutableSegment(s.dir) for s in segs], "cpu")

    def column(self, name):
        return self.packed_column(name)


def _narrow_engine(segs, device="auto", table="nw"):
    """test_narrow's ``_engine``: the port where it builds the device's
    engine, the reference's host where it asks for no device."""
    eng = _PortEngine() if device == "auto" \
        else RefEngine(device_executor=device)
    for s in segs:
        eng.add_segment(table, s)
    return eng


def test_subbyte_opt_in_parity_through_the_port(monkeypatch,
                                                tmp_path_factory):
    segs = test_narrow._build_table(tmp_path_factory.mktemp("narrow_port"))
    monkeypatch.setattr(test_narrow, "BatchContext", _PortContext)
    monkeypatch.setattr(test_narrow, "_engine", _narrow_engine)
    test_narrow.TestSubByteTier().test_subbyte_opt_in_parity(segs,
                                                             monkeypatch)
