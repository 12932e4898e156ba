"""The port's HLL path held against the JAX package's, on the CPU.

The device half of ops/hll.py (hash, index/rank split, estimates), the
register kernel K3 through both of its entries, the distinct presence
vector and the chunked sorted HLL build, each fed the same seeded numpy
inputs as the reference function it ports. On CPU tensors K3's wrapper
runs its plain version; the reference's Pallas kernels run in interpret
mode, as the JAX package's own tests run them. Every comparison is
exact: hashes, registers, sorted keys, scaled sums and estimates are
integers or exact powers-of-two sums on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.engine import device as ref_device
from pinot_tpu.ops import agg as ref_agg
from pinot_tpu.ops import groupby_mm as ref_mm
from pinot_tpu.ops import hll as ref_hll
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu.ops import radix_groupby as ref_radix
from pinot_tpu_torch.engine import device as port_device
from pinot_tpu_torch.ops import agg
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import hll
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops import radix_groupby as radix

# 0, 2^31, 2^32 - 1, every power of two and every all-ones low mask
EDGE_HASHES = sorted({0, 2**31, 2**32 - 1} | {1 << k for k in range(32)}
                     | {(1 << k) - 1 for k in range(1, 33)})


def _hashes(seed: int, n: int = 4000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([np.array(EDGE_HASHES, dtype=np.uint64), h]) \
        .astype(np.uint32)


def _slot_rho(seed: int, n: int, nslots: int, nrho: int):
    """HLL-shaped operands: slots incl. the overflow slot, geometric rho
    capped at nrho, and padding rows (overflow slot, rho 0)."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, nslots + 1, n).astype(np.int32)
    rho = np.minimum(rng.geometric(0.5, n), nrho).astype(np.int32)
    pad = rng.random(n) < 0.05
    slot[pad], rho[pad] = nslots, 0
    return slot, rho


# ---------------------------------------------------------------------------
# hash and index/rank split
# ---------------------------------------------------------------------------


def test_hash32_matches_reference():
    keys = np.concatenate([_hashes(1).view(np.int32),
                           np.array([-1, -2**31, 0, 7], dtype=np.int32)])
    got = hll.hash32(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    want = np.asarray(ref_hll.hash32(jnp.asarray(keys))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  hll.hash32_np(keys).astype(np.int64))


@pytest.mark.parametrize("log2m", [4, 8, 10, 12])
@pytest.mark.parametrize("form", ["int32_bits", "int64"])
def test_idx_rho_matches_reference(log2m, form):
    h = _hashes(log2m)
    t = torch.from_numpy(h.view(np.int32) if form == "int32_bits"
                         else h.astype(np.int64))
    idx, rho = hll.hll_idx_rho(t, log2m)
    assert idx.dtype == torch.int32 and rho.dtype == torch.int32
    ref_idx, ref_rho = ref_hll.hll_idx_rho(jnp.asarray(h), log2m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(rho.numpy(), np.asarray(ref_rho))
    assert idx.min() >= 0 and idx.max() < (1 << log2m)
    assert rho.min() >= 1 and rho.max() == mm.hll_nrho(log2m)


# ---------------------------------------------------------------------------
# K3 through both entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,log2m", [(1, 4), (1, 8), (1, 10), (3, 10),
                                     (1, 12)])
def test_small_slot_entry_matches_presence_kernel(G, log2m):
    nslots, nrho = G << log2m, mm.hll_nrho(log2m)
    assert ps.hll_supported(nslots, nrho) == ref_ps.hll_supported(
        nslots, nrho) is True
    slot, rho = _slot_rho(G * 100 + log2m, 20000, nslots, nrho)
    got = ps.hll_register_max(torch.from_numpy(slot), torch.from_numpy(rho),
                              nslots)
    want = ref_ps.hll_register_max(jnp.asarray(slot), jnp.asarray(rho),
                                   nslots, nrho, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_small_slot_entry_forced_partitions():
    # reference: span_hpad=8 → 1024 slots per partition → 4 partitions;
    # the port's span override asks K3 for the same cut
    nslots, nrho = 4096, 23
    assert kernels.hll_partitions(nslots, 1024) == 4
    slot, rho = _slot_rho(5, 30000, nslots, nrho)
    got = ps.hll_register_max(torch.from_numpy(slot), torch.from_numpy(rho),
                              nslots, span=1024)
    want = ref_ps.hll_register_max(jnp.asarray(slot), jnp.asarray(rho),
                                   nslots, nrho, interpret=True, span_hpad=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("G,log2m", [(35, 10), (7, 12), (200, 8)])
def test_group_entry_matches_rho_mode_kernel(G, log2m):
    assert mm.hll_supported(G, log2m) and ref_mm.hll_supported(G, log2m)
    m = 1 << log2m
    slot, rho = _slot_rho(G + log2m, 20000, G * m, mm.hll_nrho(log2m))
    got = mm.hll_registers(torch.from_numpy(slot), torch.from_numpy(rho), G,
                           log2m)
    want = ref_mm.hll_registers(jnp.asarray(slot), jnp.asarray(rho), G,
                                log2m, interpret=True)
    assert tuple(got.shape) == (G, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("G", [1, 2, 4, 35, 175, 500, 1000, 1025, 2000,
                               5000, 70000])
def test_hll_routing_matches_reference(G):
    for log2m in (4, 8, 10, 12):
        nslots, nrho = G << log2m, mm.hll_nrho(log2m)
        assert nrho == ref_mm.hll_nrho(log2m)
        assert ps.hll_supported(nslots, nrho) == ref_ps.hll_supported(
            nslots, nrho)
        assert mm.hll_supported(G, log2m) == ref_mm.hll_supported(G, log2m)
        assert port_device._hll_sort_eligible(True, G, log2m) \
            == ref_device._hll_sort_eligible(True, True, G, log2m,
                                             "interpret")
    assert ps.HLL_MAX_SLOTS == ref_ps.HLL_MAX_SLOTS


def test_k3_plain_version_ignores_slots_outside_range():
    slot = torch.tensor([-1, 0, 2, 3, 1, 1, 0], dtype=torch.int32)
    rho = torch.tensor([9, 4, 9, 9, 0, 2, 5], dtype=torch.int32)
    np.testing.assert_array_equal(
        kernels.hll_register_max(slot, rho, 2).numpy(), [5, 2])


def test_k3_wrapper_refuses_mixed_devices_without_launching():
    before = dict(kernels.launches)
    slot = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.hll_register_max(slot, torch.zeros(4, dtype=torch.int32,
                                                   device="meta"), 8)
    assert kernels.launches == before


def test_cpu_calls_count_no_entry_launch():
    before = (dict(ps.launches), dict(mm.launches))
    slot, rho = _slot_rho(3, 1000, 1024, 23)
    ps.hll_register_max(torch.from_numpy(slot), torch.from_numpy(rho), 1024)
    mm.hll_registers(torch.from_numpy(slot), torch.from_numpy(rho), 1, 10)
    assert (ps.launches, mm.launches) == before


# ---------------------------------------------------------------------------
# estimates
# ---------------------------------------------------------------------------


def _register_planes(kind: str, log2m: int, G: int = 64) -> np.ndarray:
    rng = np.random.default_rng(log2m + len(kind))
    m, rho_max = 1 << log2m, 33 - log2m
    if kind == "linear":   # few registers set: linear counting
        regs = np.where(rng.random((G, m)) < 0.2,
                        rng.integers(1, 4, (G, m)), 0)
    elif kind == "raw":    # every register set, moderate ranks
        regs = np.minimum(rng.geometric(0.5, (G, m)) + 4, rho_max)
    else:                  # ranks near the cap: the large-range correction
        regs = rng.integers(rho_max - 4, rho_max, (G, m))
    return regs.astype(np.int32)


def _branches(regs: np.ndarray) -> set:
    m = regs.shape[1]
    raw = ref_hll._alpha(m) * m * m / np.sum(np.exp2(-regs.astype(float)), 1)
    zeros = (regs == 0).sum(1)
    small = (raw <= 2.5 * m) & (zeros > 0)
    big = raw > (1 << 32) / 30.0
    return set(np.where(small, "linear", np.where(big, "large", "raw")))


def _scaled_sums(regs: np.ndarray, log2m: int) -> np.ndarray:
    rho_max = 33 - log2m
    split = rho_max // 2
    r = regs.astype(np.float64)
    lo = (regs > 0) & (regs <= split)
    hi = regs > split
    return np.stack([(regs > 0).sum(1).astype(np.float64),
                     np.where(lo, np.exp2(split - r), 0).sum(1),
                     np.where(hi, np.exp2(rho_max - r), 0).sum(1)])


@pytest.mark.parametrize("log2m", [4, 8, 10, 12])
@pytest.mark.parametrize("kind", ["linear", "raw", "large"])
def test_estimates_match_reference(kind, log2m):
    regs = _register_planes(kind, log2m)
    assert _branches(regs) == {kind}
    want = np.asarray(ref_hll.estimate_jnp(jnp.asarray(regs)))
    np.testing.assert_array_equal(want, ref_hll.estimate_batch_np(regs))
    got = hll.estimate_torch(torch.from_numpy(regs))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hll.estimate_torch(torch.from_numpy(regs).to(torch.int8)).numpy(),
        want)
    sums = _scaled_sums(regs, log2m)
    np.testing.assert_array_equal(
        hll.estimate_from_sums_torch(torch.from_numpy(sums), log2m).numpy(),
        want)
    np.testing.assert_array_equal(np.asarray(ref_hll.estimate_from_sums_jnp(
        jnp.asarray(sums), log2m)), want)


# ---------------------------------------------------------------------------
# distinct presence and the sorted terminal build
# ---------------------------------------------------------------------------


def test_distinct_presence_matches_reference():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 301, 5000).astype(np.int32)  # 300 = masked
    got = agg.distinct_presence(torch.from_numpy(ids), 300)
    want = ref_agg.distinct_presence(jnp.asarray(ids), 300)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,G,log2m,chunk_rows", [
    (20000, 40, 6, None),    # one monolithic sort
    (20000, 40, 6, 256),     # one chunked pass
    (60000, 10, 6, 256),     # several chunked passes
    (60000, 3, 8, 1024),
])
def test_sorted_keys_and_sums_match_reference(n, G, log2m, chunk_rows):
    m = 1 << log2m
    nslots = G * m
    slot, rho = _slot_rho(n + G, n, nslots, mm.hll_nrho(log2m))
    rho[slot == nslots] = np.maximum(rho[slot == nslots], 1)
    packed = (slot << 5) | rho
    got = radix.hll_chunked_sorted_keys(torch.from_numpy(packed), nslots,
                                        chunk_rows=chunk_rows)
    want = ref_radix.hll_chunked_sorted_keys(jnp.asarray(packed), nslots,
                                             chunk_rows=chunk_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if chunk_rows is not None:
        assert got.shape[0] < n  # the chunked passes compacted
    sums = port_device._hll_sums_from_sorted(got, G, log2m)
    ref_sums = ref_device._hll_sums_from_sorted(want, G, log2m, "interpret")
    np.testing.assert_array_equal(sums.numpy(), np.asarray(ref_sums))
    # the sums' estimates equal the dense registers' estimates
    regs = np.zeros(nslots + 1, np.int32)
    np.maximum.at(regs, slot, rho)
    np.testing.assert_array_equal(
        hll.estimate_from_sums_torch(sums, log2m).numpy(),
        ref_hll.estimate_batch_np(regs[:nslots].reshape(G, m)))


@pytest.mark.parametrize("n,table_k,chunk_rows,min_ratio", [
    (100_007_936, 2_048_000, None, 2), (6_000_000, 2_048_000, None, 2),
    (20000, 2560, 256, 2), (1 << 22, 5000, None, 4), (100, 10, None, 4)])
def test_plan_chunks_matches_reference(n, table_k, chunk_rows, min_ratio):
    assert radix.plan_chunks(n, table_k, chunk_rows, min_ratio) \
        == ref_radix.plan_chunks(n, table_k, chunk_rows, min_ratio)
