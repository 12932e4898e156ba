"""The multi-stage engine's solo hash join as torch ops: sort the build
side, probe it with binary searches, expand the matched pairs.

Counterpart of pinot_tpu/ops/join.py's solo phases. There they are XLA
code (``jnp``), not Pallas; here they are torch ops on the card:

1. ``sort_build``: the build side's packed int64 key codes ordered once by
   a STABLE sort (``jnp.argsort`` is stable), so equal keys keep build-row
   order; the permutation maps sorted positions back to build rows.
2. ``probe_ranges``: two ``torch.searchsorted`` give each probe row its
   [lo, lo + count) run of matching build rows. ``probe_unique`` is the
   1:1 form for unique build keys (a dimension table's primary key, the
   LOOKUP shape), where the probe is the join.
3. ``expand_pairs``: the matched (probe row, build position) pairs,
   probe-major, each probe row's matches in the build's stable sorted
   order: the joined row order the reference produces, which decides a
   selection's rows without ORDER BY, window tie-breaks and the order of
   float additions. Eager torch knows the total, so the output is exactly
   as long as the matches (the reference pads to ``next_pow2`` for its jit
   cache); ``bound`` may still pad, with invalid slots -1.

Keys are the dense non-negative codes query2/runner.py factorizes both
sides into. ``BUILD_PAD`` sorts after every real key and ``PROBE_PAD``
below every one, so padded slots never match (the mesh forms, which wait
for the mesh slice, pad with them).
"""

from __future__ import annotations

import torch

BUILD_PAD = 1 << 62   # sorts after every real key, never probed
PROBE_PAD = -1        # below every real (non-negative) key code


def next_pow2(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m <<= 1
    return m


def sort_build(keys: torch.Tensor) -> tuple:
    """(n,) int64 packed build keys → (sorted keys, perm): perm maps sorted
    positions back to build rows, equal keys in build-row order."""
    sk, perm = torch.sort(keys, stable=True)
    return sk, perm


def probe_ranges(sorted_keys: torch.Tensor, probe: torch.Tensor) -> tuple:
    """Each probe key's run [lo, lo + count) in the sorted build keys."""
    lo = torch.searchsorted(sorted_keys, probe, side="left")
    hi = torch.searchsorted(sorted_keys, probe, side="right")
    return lo, hi - lo


def probe_unique(sorted_keys: torch.Tensor, perm: torch.Tensor,
                 probe: torch.Tensor) -> tuple:
    """1:1 probe against UNIQUE build keys: (found (n,) bool, build row
    (n,) int64, -1 on a miss)."""
    n = sorted_keys.shape[0]
    if n == 0:
        miss = torch.zeros_like(probe, dtype=torch.bool)
        return miss, torch.full_like(probe, -1, dtype=torch.int64)
    idx = torch.clamp(torch.searchsorted(sorted_keys, probe, side="left"),
                      0, n - 1)
    found = sorted_keys[idx] == probe
    return found, torch.where(found, perm[idx], -1)


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor,
                 bound: int | None = None) -> tuple:
    """The matched pairs of ``probe_ranges``: (probe row, build position,
    valid), probe-major, of length ``bound`` (default: the total number of
    matches, which must not exceed it); slots past the total hold -1 and
    are invalid."""
    counts = counts.to(torch.int64)
    total = int(counts.sum()) if counts.numel() else 0
    bound = total if bound is None else bound
    if bound < total:
        raise ValueError(f"expand_pairs: bound {bound} below the {total} "
                         f"matched pairs")
    dev = counts.device
    row = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts,
        output_size=total)
    start = torch.cumsum(counts, 0) - counts
    j = torch.arange(total, dtype=torch.int64, device=dev)
    build_pos = lo.to(torch.int64)[row] + (j - start[row])
    valid = torch.ones(bound, dtype=torch.bool, device=dev)
    if bound > total:
        pad = torch.full((bound - total,), -1, dtype=torch.int64, device=dev)
        row = torch.cat([row, pad])
        build_pos = torch.cat([build_pos, pad])
        valid[total:] = False
    return row, build_pos, valid
