"""The port's kernels (K1 group plane sums, K2 group min/max) held against
the JAX package's Pallas kernels, on the CPU. K1 takes the values and
splits them into the reference's channels itself.

On CPU tensors the port's wrappers run the kernels' plain PyTorch
versions; the reference kernels run in Pallas interpret mode, as the JAX
package's own tests run them. Inputs come from seeded numpy and go to both
sides as numpy arrays. Integer planes and min/max must match bit for bit;
float planes within rtol 1e-6 (the reference accumulates them in f32 per
65536-row superblock, the plain version in f64). The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.ops import groupby_mm as ref_mm
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import kernels

N = 20000


def _int_case(G, seed=7, nplanes=3):
    """Ids (incl. the overflow id) and int64 values; the reference's
    channel stack, and the port's source, which K1 splits itself."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G + 1, N).astype(np.int32)  # incl. the overflow id
    val = rng.integers(-5_000_000, 5_000_000, N).astype(np.int64)
    off = -5_000_000
    ref_ch = jnp.stack([jnp.ones(N, jnp.bfloat16)]
                       + ref_mm.int_planes(jnp.asarray(val), off, nplanes))
    src = kernels.PlaneSource(torch.from_numpy(val), "int", nplanes,
                              minus=torch.tensor(off))
    return gid, val, off, ref_ch, src


def _np(x):
    """bf16 planes of either side as float32 numpy (exact: bf16 ⊂ f32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("G", [1, 255, 300, 2000, 4096, 6240])
def test_plane_sums_int_bit_exact(G):
    gid, val, off, ref_ch, src = _int_case(G)
    # the port's byte planes are the reference's planes
    np.testing.assert_array_equal(_np(torch.stack(
        [torch.ones(N, dtype=torch.bfloat16)] + kernels.source_channels(src))),
        _np(ref_ch))
    got = ps.plane_group_sums(torch.from_numpy(gid), [src], G,
                              count=True).numpy()
    want = np.asarray(ref_ps.plane_group_sums(
        jnp.asarray(gid), ref_ch, G, interpret=True, first_channel_ones=True))
    np.testing.assert_array_equal(got, want)
    cnt = torch.round(torch.from_numpy(got[0])).to(torch.int64)
    s = mm.recombine_int([torch.from_numpy(r) for r in got[1:]], cnt,
                         torch.tensor(off)).numpy()
    oracle = np.zeros(G + 1, np.int64)
    np.add.at(oracle, gid, val)
    np.testing.assert_array_equal(s, oracle[:G])


@pytest.mark.parametrize("G", [1, 255, 2000, 6240])
def test_single_accumulator_entry_matches_group_sums(G):
    gid, _val, _off, ref_ch, src = _int_case(G, seed=11, nplanes=2)
    assert mm.mm_supported(G, 2) and ref_mm.mm_supported(G, 2)
    got = mm.group_sums(torch.from_numpy(gid), [src], G, count=True).numpy()
    want = np.asarray(ref_mm.group_sums(
        jnp.asarray(gid), ref_ch, G, interpret=True, first_channel_ones=True))
    np.testing.assert_array_equal(got, want)


def test_plane_sums_forced_multi_partition():
    # reference: span_hpad=8 → 1024 groups per partition → 5 partitions;
    # the port's span override asks K1 for the same cut
    G = 5000
    gid, _val, _off, ref_ch, src = _int_case(G, seed=3)
    got = ps.plane_group_sums(torch.from_numpy(gid), [src], G, count=True,
                              span=1024).numpy()
    want = np.asarray(ref_ps.plane_group_sums(
        jnp.asarray(gid), ref_ch, G, interpret=True, first_channel_ones=True,
        span_hpad=8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("G", [255, 2000, 6240])
def test_plane_sums_float_planes(G):
    rng = np.random.default_rng(G)
    gid = rng.integers(0, G + 1, N).astype(np.int32)
    val = rng.uniform(1.0, 100.0, N).astype(np.float32)
    ref_planes = ref_mm.float_planes(jnp.asarray(val))
    src = kernels.PlaneSource(torch.from_numpy(val), "float")
    for a, b in zip(kernels.source_channels(src), ref_planes):
        np.testing.assert_array_equal(_np(a), _np(b))
    got = ps.plane_group_sums(torch.from_numpy(gid), [src], G, count=True)
    want = np.asarray(ref_ps.plane_group_sums(
        jnp.asarray(gid), jnp.stack([jnp.ones(N, jnp.bfloat16)] + ref_planes),
        G, interpret=True, first_channel_ones=True))
    total = mm.recombine_float([got[1], got[2], got[3]]).numpy()
    np.testing.assert_allclose(total, want[1] + want[2] + want[3], rtol=1e-6)
    oracle = np.zeros(G + 1, np.float64)
    np.add.at(oracle, gid, val.astype(np.float64))
    np.testing.assert_allclose(total, oracle[:G], rtol=1e-6)


@pytest.mark.parametrize("G", [1, 255, 1024, 5000, 8191])
@pytest.mark.parametrize("kind", ["i32", "f32"])
def test_group_minmax_bit_exact(G, kind):
    rng = np.random.default_rng(G + (1 if kind == "f32" else 0))
    # even ids only (plus the overflow id): half the groups stay empty and
    # keep the caller's fill
    gid = np.where(rng.random(N) < 0.05, G,
                   (rng.integers(0, G // 2 + 1, N) * 2) % max(G, 1))
    gid = gid.astype(np.int32)
    if kind == "i32":
        val = rng.integers(-1_000_000, 1_000_000, N).astype(np.int32)
        fills = (np.iinfo(np.int32).max, np.iinfo(np.int32).min)
    else:
        val = rng.uniform(-5, 5, N).astype(np.float32)
        fills = (float("inf"), float("-inf"))
    got = ps.group_minmax(torch.from_numpy(gid), torch.from_numpy(val), G,
                          ("min", "max"), fills=fills)
    want = ref_ps.group_minmax(jnp.asarray(gid), jnp.asarray(val), G,
                               ("min", "max"), interpret=True, fills=fills)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if kind == "i32" else torch.float32)
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


def test_group_minmax_narrow_ints_and_single_op():
    rng = np.random.default_rng(5)
    G = 300
    gid = rng.integers(0, G + 1, N).astype(np.int32)
    val = rng.integers(0, 250, N).astype(np.uint8)
    fills = (int(np.iinfo(np.uint8).min),)
    got, = ps.group_minmax(torch.from_numpy(gid), torch.from_numpy(val), G,
                           ("max",), fills=fills)
    want, = ref_ps.group_minmax(jnp.asarray(gid), jnp.asarray(val), G,
                                ("max",), interpret=True, fills=fills)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_group_minmax_orders_signed_zero():
    # the plain version's order keys put -0.0 below +0.0, as the kernel does
    gid = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    v = torch.tensor([0.0, -0.0, -0.0, 0.0], dtype=torch.float32)
    mn, mx = kernels.group_minmax(gid, v, 3, ("min", "max"))
    assert [torch.signbit(x).item() for x in mn[:2]] == [True, True]
    assert [torch.signbit(x).item() for x in mx[:2]] == [False, False]
    assert mn[2].item() == np.finfo(np.float32).max


@pytest.mark.parametrize("G", [1, 35, 175, 2000, 6240, 70000, 1 << 20,
                               1 << 22])
def test_routing_predicates_match_reference(G):
    for a in (1, 2, 4, 8, 16, 17):
        assert ps.sums_supported(G, a) == ref_ps.sums_supported(G, a)
        assert mm.mm_supported(G, a) == ref_mm.mm_supported(G, a)
    for dt in ("int8", "int16", "int32", "int64", "uint8", "uint16",
               "float32", "float64"):
        assert ps.minmax_supported(G, dt) == ref_ps.minmax_supported(
            G, jnp.dtype(dt)), dt
    assert ps.PALLAS_MIN_ROWS == ref_ps.PALLAS_MIN_ROWS


@pytest.mark.parametrize("lo,hi", [(1, 50), (1000, 5_999_999), (-5, 300),
                                   (0.5, 70000.2), (-2**40, 2**40)])
def test_int_planes_needed_matches_reference(lo, hi):
    assert mm.int_planes_needed(lo, hi) == ref_mm.int_planes_needed(lo, hi)


def test_wrappers_refuse_mixed_devices_without_launching():
    before = dict(kernels.launches)
    gid = torch.zeros(4, dtype=torch.int32)
    src = kernels.PlaneSource(torch.zeros(4, dtype=torch.bfloat16,
                                          device="meta"), "bf16")
    with pytest.raises(ValueError):
        kernels.group_plane_sums(gid, [src], 2)
    with pytest.raises(ValueError):
        kernels.group_minmax(gid, torch.zeros(4, device="meta"), 2, ("min",))
    assert kernels.launches == before


def test_plain_versions_ignore_ids_outside_range():
    gid = torch.tensor([-1, 0, 2, 3, 1], dtype=torch.int32)
    ones = kernels.PlaneSource(torch.ones(5, dtype=torch.bfloat16), "bf16")
    out = kernels.group_plane_sums(gid, [ones, ones], 2)
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [1, 1]])
    v = torch.tensor([9, 1, 9, 9, 4], dtype=torch.int32)
    mn, = kernels.group_minmax(gid, v, 2, ("min",))
    np.testing.assert_array_equal(mn.numpy(), [1, 4])
