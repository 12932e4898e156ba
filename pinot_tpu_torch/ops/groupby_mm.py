"""Dense COUNT/SUM/AVG group-by over bf16 plane channels (the
single-accumulator entry of the group plane-sum kernel K1), and the group
HLL register build (K3).

Counterpart of pinot_tpu/ops/groupby_mm.py. There the TPU kernel turned
the scatter into MXU work with a factored one-hot matmul; on the card the
same function — per-group sums of bf16 channels — runs through K1
(ops/kernels.py, csrc/group_plane_sums.cu), which partitions the group
range by shared memory instead. This module keeps the reference's
routing predicate (``mm_supported``, so the same queries take this entry)
and the recombination of the channel planes, which K1 builds in
registers from the values as stored (ops/kernels.py ``PlaneSource``):

- integers offset by the column's lower bound split into byte planes
  (``int_planes``; each plane <= 255, summed exactly in K1's int32
  cells; the int64 recombination is exact);
- f32 values split exactly into three bf16 planes by bit-masking
  (``float_planes``).

Both splits live in ops/kernels.py as K1's plain version and are
re-exported here, where the reference keeps them.

The reference's HLL build in this module (``rho_group_counts`` /
``hll_registers``) runs the same MXU kernel in rho mode: it forms an
(nrho, slots) matrix of per-rank counts only to reduce it at once to the
registers. That count matrix is an artifact of the matrix unit; here
``hll_registers`` computes the registers directly through K3, the
register-max kernel (ops/kernels.py, csrc/hll_register_max.cu), under
the reference's routing predicate ``hll_supported``.

``launches`` counts kernel launches per entry of this module (see
ops/group_scatter.py).
"""

from __future__ import annotations

import math

import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import float_planes, int_planes  # noqa: F401

MAX_CHANNELS = 15       # + the count channel
MAX_ACC_CELLS = 1 << 21  # the reference's VMEM accumulator bound: A * hpad * 128

launches = {"group_sums": 0, "hll_registers": 0}


def _plan_lo(num_groups: int, a_real: int, ones_first: bool) -> int:
    """The reference's low-radix choice; it only decides the accumulator
    shape ``mm_supported`` bounds, so routing matches the reference."""
    folded = 1 if ones_first else 0
    best, best_cost = 128, None
    for lo in (32, 64, 128):
        hpad = _hpad(num_groups, lo)
        if lo != 128 and a_real * hpad * 128 > MAX_ACC_CELLS:
            continue
        cost = 2 * lo + 2 * hpad + max(0, a_real - folded) * hpad
        if best_cost is None or cost < best_cost:
            best, best_cost = lo, cost
    return best


def _hpad(num_groups: int, lo: int = 128) -> int:
    return max(8, ((num_groups // lo + 1 + 7) // 8) * 8)


def mm_supported(num_groups: int, n_channels: int,
                 ones_first: bool = True) -> bool:
    lo = _plan_lo(num_groups, n_channels + 1, ones_first)
    hpad = _hpad(num_groups, lo)
    return (n_channels + 1) * hpad * 128 <= MAX_ACC_CELLS


def group_sums(gid, sources, num_groups: int, *, count: bool = False):
    """Dense per-group sums through K1's single-accumulator entry.

    gid: (n,) int32 in [0, num_groups]; id == num_groups is the overflow
    slot for masked/padded rows. sources: kernels.PlaneSource values as
    stored (K1 splits them into channels in registers); ``count``: row 0
    counts the rows. Returns (A, num_groups) float64."""
    return kernels.count_entry(
        launches, "group_sums", "group_plane_sums", kernels.group_plane_sums,
        gid.reshape(-1), sources, num_groups, count=count)


def hll_nrho(log2m: int) -> int:
    """Max rho value: clz over (32 - log2m) value bits + 1 (sentinel caps)."""
    return 32 - log2m + 1


def hll_supported(num_groups: int, log2m: int) -> bool:
    """The reference's rho-mode regime: its count matrix fits the
    accumulator (no folded count channel) and the slot space <= 2^20."""
    nslots = num_groups * (1 << log2m)
    return mm_supported(nslots, hll_nrho(log2m), ones_first=False) \
        and nslots <= (1 << 20)


def hll_registers(h, gid, num_groups: int, log2m: int, *, mask=None):
    """(num_groups, m) int32 HLL registers through K3, from the int32 hash
    plane ``h`` and the int32 group ids (None: one group); rows with an id
    outside [0, num_groups), or with ``mask`` unset, add nothing."""
    regs = kernels.count_entry(
        launches, "hll_registers", "hll_register_max",
        kernels.hll_register_max, h.reshape(-1), log2m, num_groups,
        gid=None if gid is None else gid.reshape(-1),
        mask=None if mask is None else mask.reshape(-1))
    return regs.reshape(num_groups, 1 << log2m)


# ---------------------------------------------------------------------------
# channel planes: values → bf16 channels + recombination
# ---------------------------------------------------------------------------


def int_planes_needed(lo: float, hi: float) -> int:
    """Byte planes needed for ints in [lo, hi] after offset-by-floor(lo).
    Ceil/floor (not truncation) so fractional metadata bounds can't
    under-count the span."""
    rng = math.ceil(hi) - math.floor(lo)
    planes = 1
    while rng > (1 << (8 * planes)) - 1:
        planes += 1
    return planes


def recombine_int(plane_sums, count, offset):
    """int64 recombination: Σv = Σ_k 256^k·S_k + count·offset (exact)."""
    tot = torch.zeros(plane_sums[0].shape, dtype=torch.int64,
                      device=plane_sums[0].device)
    for k, s in enumerate(plane_sums):
        tot = tot + (s.to(torch.int64) << (8 * k))
    return tot + count.to(torch.int64) * offset


def recombine_float(plane_sums):
    tot = plane_sums[0]
    for s in plane_sums[1:]:
        tot = tot + s
    return tot
