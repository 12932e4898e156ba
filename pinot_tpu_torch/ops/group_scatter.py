"""The group-range partitioned plane sums (K1), group min/max (K2) and
small HLL register builds (K3) — counterpart of
pinot_tpu/ops/pallas_scatter.py.

The reference's Pallas tier replaced XLA's serialized TPU scatters with
purpose-built kernels; on the card the same two functions run through the
hand-written CUDA kernels of ops/kernels.py:

- ``plane_group_sums`` → K1: exact per-group sums of bf16 plane
  channels, past the single-accumulator ceiling ``mm_supported`` sets;
- ``group_minmax`` → K2: per-group MIN and/or MAX over int32/float32
  values with caller-supplied empty-group fills;
- ``hll_register_max`` → K3: per-slot max rho over slot spaces up to
  ``HLL_MAX_SLOTS`` (scalar and small-group HLL).

The routing predicates (``sums_supported``, ``minmax_supported``,
``hll_supported``) and the minimum batch (``PALLAS_MIN_ROWS``) are the
reference's, so the same queries reach the kernels; other shapes stay on
the torch scatters of ops/agg.py, where the reference uses XLA's. The
reference's fused block-skip kernel comes with a later slice of the port.

``launches`` counts kernel launches per entry of this module, beside
``kernels.launches`` per kernel: K1 and K3 each replace two TPU kernels,
and the entry says which one a launch stands for.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.groupby_mm import MAX_ACC_CELLS, MAX_CHANNELS

LO = 128                 # the reference's low radix (routing arithmetic)
MAX_PARTITIONS = 8
PALLAS_MIN_ROWS = 1 << 17  # below this the scatter's fixed cost wins

MINMAX_SPAN = 1024
MAX_MINMAX_PARTS = 8     # → num_groups <= 8191

HLL_MAX_SLOTS = 1 << 12  # past this the reference's presence kernel declines

launches = {"plane_group_sums": 0, "group_minmax": 0, "hll_register_max": 0}


def _hpad_total(num_groups: int) -> int:
    return max(8, ((num_groups // LO + 1 + 7) // 8) * 8)


def _span_hpad(a_real: int) -> int:
    h = MAX_ACC_CELLS // (a_real * LO)
    return max(8, (h // 8) * 8)


def sums_supported(num_groups: int, n_channels: int) -> bool:
    """The reference's partitioned plane-sum regime: the group space splits
    into <= MAX_PARTITIONS accumulator-sized ranges."""
    if n_channels > MAX_CHANNELS + 1:
        return False
    hp = _span_hpad(n_channels)
    return -(-_hpad_total(num_groups) // hp) <= MAX_PARTITIONS


def plane_group_sums(gid, channels, num_groups: int, *,
                     first_channel_ones: bool = False,
                     span: int | None = None):
    """Dense per-group sums of bf16 plane channels through K1. gid: (n,)
    int32 in [0, num_groups] (num_groups = overflow slot); channels:
    (A, n) bf16. ``span`` overrides K1's groups per partition (tests force
    multi-partition launches on small group counts). Returns
    (A, num_groups) float64."""
    return kernels.count_entry(
        launches, "plane_group_sums", "group_plane_sums",
        kernels.group_plane_sums, gid, channels, num_groups,
        first_channel_ones=first_channel_ones, span=span)


_MINMAX_KERNEL_DTYPES = {
    "int8": torch.int32, "int16": torch.int32, "int32": torch.int32,
    "uint8": torch.int32, "uint16": torch.int32, "float32": torch.float32,
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def minmax_supported(num_groups: int, dtype) -> bool:
    """int64/float64 values stay on the torch scatter (the reference's
    kernel has no 64-bit path); the group count is the reference's bound."""
    if _dtype_name(dtype) not in _MINMAX_KERNEL_DTYPES:
        return False
    return -(-(num_groups + 1) // MINMAX_SPAN) <= MAX_MINMAX_PARTS


def group_minmax(gid, values, num_groups: int, ops: tuple,
                 fills: tuple | None = None):
    """Per-group min and/or max through K2. ``ops`` ⊆ ("min", "max");
    ``fills`` sets the empty-group value per op (callers pass the ORIGINAL
    dtype's extremes so empty slots match the scatter path bit for bit).
    Narrow values widen to int32; returns one (num_groups,) tensor per op
    in the kernel dtype (int32 or float32)."""
    kdt = _MINMAX_KERNEL_DTYPES[_dtype_name(values.dtype)]
    v = values.reshape(-1).to(kdt).contiguous()
    return kernels.count_entry(
        launches, "group_minmax", "group_minmax", kernels.group_minmax,
        gid.reshape(-1).to(torch.int32).contiguous(), v, num_groups, ops,
        fills)


def hll_supported(nslots: int, nrho: int) -> bool:
    """The reference's regime for its presence kernel: at most
    ``HLL_MAX_SLOTS`` slots, split into <= MAX_PARTITIONS accumulator
    ranges of ``nrho`` channels."""
    if nslots > HLL_MAX_SLOTS:
        return False
    hp = _span_hpad(nrho)
    return -(-_hpad_total(nslots) // hp) <= MAX_PARTITIONS


def hll_register_max(slot, rho, nslots: int, *, span: int | None = None):
    """(nslots,) int32 registers = per-slot max rho, through K3. slot:
    int32 ids in [0, nslots] (nslots masks the row); rho: int32 in
    [1, 33 - log2m] (0 on padded rows adds nothing). ``span`` overrides
    K3's slots per partition."""
    return kernels.count_entry(
        launches, "hll_register_max", "hll_register_max",
        kernels.hll_register_max,
        slot.reshape(-1).to(torch.int32).contiguous(),
        rho.reshape(-1).to(torch.int32).contiguous(), nslots, span=span)
