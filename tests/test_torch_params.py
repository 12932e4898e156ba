"""The port's BatchContext builds the reference's device planes.

For the same sealed segments, ``column``, ``decoded_column``,
``global_dict`` and ``width_plan`` must equal the JAX package's as numpy
arrays — dtypes included — because group order, ties and the kernels'
inputs depend on the global ids and plane widths. The columns cover
every width tier: uint8 / uint16 / int32 id planes, raw planes that fit
unsigned, that need a frame-of-reference offset, LONG planes that fit
int32, DOUBLE as float32, and decoded (``dv::``) planes of dict columns.
"""

import numpy as np
import pytest
import torch

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.params import BatchContext as RefBatch
from pinot_tpu.storage.creator import build_segment
from pinot_tpu_torch.engine.params import BatchContext
from pinot_tpu_torch.storage.segment import ImmutableSegment

COLUMNS = ["d_year", "s_nation", "lo_suppkey", "lo_custkey", "lo_quantity",
           "lo_revenue", "lo_offset", "lo_long", "lo_tax", "lo_price"]


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="lineorder",
        dimensions=[("d_year", DataType.INT), ("s_nation", DataType.STRING),
                    ("lo_suppkey", DataType.INT), ("lo_custkey", DataType.INT),
                    ("lo_price", DataType.DOUBLE)],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT),
                 ("lo_offset", DataType.INT), ("lo_long", DataType.LONG),
                 ("lo_tax", DataType.DOUBLE)])
    cfg = TableConfig(table_name="lineorder",
                      indexing=IndexingConfig(enable_bit_packing=True))
    base = tmp_path_factory.mktemp("torch_params")
    rng = np.random.default_rng(3)
    nations = np.array([f"nation_{i:02d}" for i in range(25)])
    dirs = []
    for i, n in enumerate((25000, 25000, 23000)):
        cols = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "s_nation": nations[rng.integers(0, 25, n)],
            "lo_suppkey": rng.integers(0, 2000, n).astype(np.int32),
            # > 65535 distinct values across the batch → an int32 id plane
            "lo_custkey": rng.integers(0, 1_000_000, n).astype(np.int32),
            "lo_price": np.round(rng.uniform(1, 100, n), 1),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int32),
            "lo_offset": rng.integers(100_000, 160_000, n).astype(np.int32),
            "lo_long": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            "lo_tax": np.round(rng.uniform(0, 8, n), 2),
        }
        out = str(base / f"s{i}")
        build_segment(schema, cols, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def batches(segment_dirs):
    from pinot_tpu.storage.segment import ImmutableSegment as RefSegment

    ref = RefBatch([RefSegment(d) for d in segment_dirs])
    port = BatchContext([ImmutableSegment(d) for d in segment_dirs], "cpu")
    return ref, port


@pytest.mark.parametrize("col", COLUMNS)
def test_column_planes_equal_reference(batches, col):
    ref, port = batches
    assert port.pad_to == ref.pad_to and port.S == ref.S
    want = np.asarray(ref.column(col))
    got = port.column(col)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    rp, pp = ref.width_plan(col), port.width_plan(col)
    assert (pp.dtype, pp.bits, pp.offset, pp.wide) == \
        (rp.dtype, rp.bits, rp.offset, rp.wide)


@pytest.mark.parametrize("col", ["d_year", "lo_suppkey", "lo_custkey",
                                 "lo_price", "lo_quantity"])
def test_decoded_planes_equal_reference(batches, col):
    ref, port = batches
    want = np.asarray(ref.decoded_column(col))
    got = port.decoded_column(col).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    rp, pp = ref.width_plan("dv::" + col), port.width_plan("dv::" + col)
    assert (pp.dtype, pp.offset, pp.wide) == (rp.dtype, rp.offset, rp.wide)


@pytest.mark.parametrize("col", ["d_year", "s_nation", "lo_suppkey",
                                 "lo_custkey", "lo_price"])
def test_global_dicts_equal_reference(batches, col):
    ref, port = batches
    np.testing.assert_array_equal(np.asarray(port.global_dict(col).values),
                                  np.asarray(ref.global_dict(col).values))
    assert port.cardinality(col) == ref.cardinality(col)


def test_width_tiers_are_all_covered(batches):
    _ref, port = batches
    dtypes = {c: np.dtype(port.width_plan(c).dtype).name for c in COLUMNS}
    assert {"uint8", "uint16", "int32", "float32"} <= set(dtypes.values())
    assert port.width_plan("lo_offset").offset >= 100_000
    assert port.width_plan("lo_long").wide == np.dtype(np.int64).str
    np.testing.assert_array_equal(port.n_docs_dev.numpy(), port.n_docs)
