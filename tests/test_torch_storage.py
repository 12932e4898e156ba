"""Segments round-trip between the JAX package and the port, both ways.

The on-disk segment is this system's state: a directory written by either
package's creator must load in the other with identical metadata, forward
indexes, dictionaries, zone maps, inverted indexes and bloom filters —
including bit-packed dictionary planes, which the port reads and writes
with its own numpy codec (storage/bitpack.py).
"""

import os

import numpy as np
import pytest

from pinot_tpu import native as ref_native
from pinot_tpu.common.datatypes import DataType as RefDataType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.table_config import IndexingConfig as RefIndexing
from pinot_tpu.common.table_config import TableConfig as RefTableConfig
from pinot_tpu.storage.creator import build_segment as ref_build
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common.datatypes import DataType
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import IndexingConfig, TableConfig
from pinot_tpu_torch.storage import bitpack
from pinot_tpu_torch.storage.creator import build_segment
from pinot_tpu_torch.storage.segment import ImmutableSegment

DIMS = [("d_year", "INT"), ("s_nation", "STRING"), ("lo_suppkey", "INT"),
        ("lo_orderdate", "INT")]
METRICS = [("lo_quantity", "INT"), ("lo_revenue", "LONG"),
           ("lo_tax", "DOUBLE")]


def _columns(n=5000, seed=1):
    rng = np.random.default_rng(seed)
    nations = np.array([f"nation_{i:02d}" for i in range(25)])
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "s_nation": nations[rng.integers(0, 25, n)],
        "lo_suppkey": rng.integers(0, 2000, n).astype(np.int32),
        "lo_orderdate": rng.integers(19920101, 19981231, n).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int64),
        "lo_tax": np.round(rng.uniform(0, 8, n), 2),
    }


def _build(side, out, packing):
    if side == "ref":
        schema = RefSchema.build(
            name="lineorder",
            dimensions=[(c, RefDataType[t]) for c, t in DIMS],
            metrics=[(c, RefDataType[t]) for c, t in METRICS])
        cfg = RefTableConfig(table_name="lineorder", indexing=RefIndexing(
            inverted_index_columns=["lo_suppkey"],
            bloom_filter_columns=["s_nation"],
            enable_bit_packing=packing))
        return ref_build(schema, _columns(), out, cfg, "s0")
    schema = Schema.build(
        name="lineorder",
        dimensions=[(c, DataType[t]) for c, t in DIMS],
        metrics=[(c, DataType[t]) for c, t in METRICS])
    cfg = TableConfig(table_name="lineorder", indexing=IndexingConfig(
        inverted_index_columns=["lo_suppkey"],
        bloom_filter_columns=["s_nation"],
        enable_bit_packing=packing))
    return build_segment(schema, _columns(), out, cfg, "s0")


def _same_segment(a, b):
    ma, mb = a.metadata.to_json(), b.metadata.to_json()
    ma.pop("crc"), mb.pop("crc")
    assert ma == mb
    for col in a.column_names():
        np.testing.assert_array_equal(np.asarray(a.forward(col)),
                                      np.asarray(b.forward(col)))
        da, db = a.dictionary(col), b.dictionary(col)
        assert (da is None) == (db is None)
        if da is not None:
            np.testing.assert_array_equal(np.asarray(da.values),
                                          np.asarray(db.values))
        np.testing.assert_array_equal(np.asarray(a.zone_map(col)),
                                      np.asarray(b.zone_map(col)))
        ia, ib = a.inverted(col), b.inverted(col)
        assert (ia is None) == (ib is None)
        if ia is not None:
            for x, y in zip(ia, ib):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        ba, bb = a.bloom(col), b.bloom(col)
        assert (ba is None) == (bb is None)
        if ba is not None:
            np.testing.assert_array_equal(np.asarray(ba), np.asarray(bb))


@pytest.mark.parametrize("packing", [False, True])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_round_trip(tmp_path, writer, packing):
    """A directory written by one package reads the same through both,
    and the other package's creator writes identical index files."""
    out = str(tmp_path / writer)
    other = "port" if writer == "ref" else "ref"
    _build(writer, out, packing)
    _build(other, str(tmp_path / other), packing)
    for d in (out, str(tmp_path / other)):
        _same_segment(RefSegment(d), ImmutableSegment(d))
    _same_segment(ImmutableSegment(out), ImmutableSegment(str(tmp_path / other)))
    packed = sorted(f for f in os.listdir(out) if f.endswith(".fwdpacked.bin"))
    assert bool(packed) == packing
    for f in packed:
        with open(os.path.join(out, f), "rb") as fa, \
                open(os.path.join(str(tmp_path / other), f), "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("bits", [1, 3, 8, 11, 16])
def test_bitpack_matches_reference_codec(bits):
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << bits, 1001).astype(np.int32)
    packed = bitpack.pack(ids, bits)
    np.testing.assert_array_equal(packed, ref_native.pack(ids, bits))
    assert len(packed) == bitpack.packed_size(len(ids), bits)
    np.testing.assert_array_equal(bitpack.unpack(packed, len(ids), bits), ids)
    assert bitpack.bits_needed(1 << bits) == ref_native.bits_needed(1 << bits)


def test_index_kinds_outside_the_slice_raise(tmp_path):
    """Every index kind is built now: compressed raw forward indexes
    since ROADMAP item g2 (they read back as written), the JSON and text
    indexes since the index slice."""
    schema = Schema.build(name="t", dimensions=[("s", DataType.STRING)],
                          metrics=[("m", DataType.INT)])
    cols = {"s": np.array([f"v{i}" for i in range(10)]),
            "m": np.arange(10, dtype=np.int32)}
    seg = build_segment(schema, cols, str(tmp_path / "x"), TableConfig(
        table_name="t", indexing=IndexingConfig(compressed_columns=["m"])))
    assert seg.column_metadata("m").compression == "zlib"
    np.testing.assert_array_equal(np.asarray(seg.forward("m")), cols["m"])
    for i, indexing in enumerate((IndexingConfig(json_index_columns=["s"]),
                                  IndexingConfig(text_index_columns=["s"]))):
        seg = build_segment(schema, cols, str(tmp_path / f"y{i}"),
                            TableConfig(table_name="t", indexing=indexing))
        idx = seg.json_index("s") if i == 0 else seg.text_index("s")
        assert idx is not None
