"""F12's examples as first found, each held to the reference.

F12: a frame-of-reference offset (``fo::``) went up as shape (1,) where
the reference's is 0-d (engine/params.py ``to_device`` gave a 0-d array
an axis), so K4's scalar MIN / MAX / SUM / AVG over a column with such
an offset came back as (1,) leaves and (1, 1) partials, and the first
merge with a second partial raised ``ValueError: array is not
broadcastable to correct shape``. A lone partial skips the merge, so
only a second partial beside it showed the fault: a consuming segment
beside a sealed one, or two servers behind a broker.
"""

import numpy as np
import pytest

import test_torch_host_float64 as hf
import test_torch_sweep_fused as sf
from pinot_tpu_torch.engine.params import to_device
from test_torch_cluster import _pin_replica_order, _session_data, _wait
from test_torch_host_float64 import dirs  # noqa: F401 — the segments


def test_to_device_keeps_a_0d_array_0d():
    t = to_device(np.asarray(5), "cpu")
    assert t.dim() == 0 and t.item() == 5
    assert to_device(np.asarray([5, 6]), "cpu").shape == (2,)
    # a strided view comes back contiguous, in its own shape
    a = np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2]
    np.testing.assert_array_equal(to_device(a, "cpu").numpy(), a)


CONSUMING = {
    "sum_i_k_lt_3": ("SELECT SUM(i) FROM t WHERE k < 3", -18263.0),
    "sum_nv_negative": ("SELECT SUM(nv) FROM t WHERE nv < 0", -153965.0),
}


@pytest.mark.parametrize("example", list(CONSUMING))
def test_consuming_tier_examples(dirs, example):  # noqa: F811
    """tests/test_torch_host_float64.py's sealed ``t0`` beside its
    5,000-row consuming segment; ``i`` and ``nv`` are signed INT / LONG
    planes with an offset."""
    sql, value = CONSUMING[example]
    ref = hf._load("ref", hf._engine("ref"), "consuming", dirs["ref"])
    want = ref.execute(sql)
    assert want["resultTable"]["rows"] == [[value]]
    for gate in hf.GATES:
        port = hf._load("port", hf._engine("port", gate), "consuming",
                        dirs["port"])
        got = port.execute(sql)
        assert not got.get("exceptions"), got["exceptions"]
        assert got["resultTable"] == want["resultTable"]


CLUSTER_SQL = "SELECT SUM(amount) FROM sales WHERE region = 'eu'"


def _signed_sales(side: str, tmp) -> list:
    """tests/test_torch_cluster.py's ``sales`` (three servers, four
    segments at replication 2) with ``amount`` shifted to [-249, 249]:
    the query asked four times, so that the broker's round robin routes
    it over each server's replicas."""
    sc, dt, tc, creator = hf.MODS[side][:4]
    DT = dt.DataType
    with sf.cluster(side, tmp, 3) as (controller, registry, servers, broker):
        schema = sc.Schema.build(
            name="sales",
            dimensions=[("region", DT.STRING), ("product", DT.STRING),
                        ("day", DT.INT)],
            metrics=[("amount", DT.INT), ("price", DT.DOUBLE)])
        cfg = tc.TableConfig(table_name="sales", replication=2)
        controller.add_table(cfg, schema)
        for i, cols in enumerate(_session_data()[0]):
            cols = dict(cols, amount=(cols["amount"] - 250).astype(np.int32))
            d = str(tmp / f"up_s{i}")
            creator.build_segment(schema, cols, d, cfg, f"sales_s{i}")
            controller.upload_segment("sales", d)
        assert _wait(lambda: len(registry.external_view("sales_OFFLINE"))
                     == 4 and all(len(v) == 2 for v in registry.external_view(
                         "sales_OFFLINE").values()))
        _pin_replica_order(registry, servers)
        return [broker.execute(CLUSTER_SQL) for _ in range(4)]


def test_cluster_example(tmp_path):
    want = _signed_sales("ref", tmp_path / "ref")
    got = _signed_sales("port", tmp_path / "port")
    for g, w in zip(got, want):
        assert w["resultTable"]["rows"] == [[-675.0]]
        assert not g.get("exceptions"), g["exceptions"]
        assert g["resultTable"] == w["resultTable"]


def test_fused_leaves_are_0d_beside_an_offset(dirs, monkeypatch):  # noqa: F811
    """K4's scalar leaves over a column with an offset are 0-d, as the
    dense form's: the sealed ``t0`` alone, at gate 0."""
    from pinot_tpu_torch.engine import device as D

    seen = []
    real = D._fused_outs

    def spy(plan, ints, flts, params, widths, outs):
        real(plan, ints, flts, params, widths, outs)
        seen.append([tuple(v.shape) for k, v in outs.items()
                     if k.startswith("a")])

    monkeypatch.setattr(D, "_fused_outs", spy)
    port = hf._engine("port", 0)
    port.add_segment("t", hf.MODS["port"][6].ImmutableSegment(
        dirs["port"][0]))
    got = port.execute("SELECT SUM(i), MIN(i), MAX(nv), AVG(i) FROM t "
                       "WHERE k < 3")
    assert not got.get("exceptions"), got["exceptions"]
    assert seen and all(s == () for leaves in seen for s in leaves), seen
