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
below every one, so padded slots never match.

The mesh forms (parallel/mesh.py), each shard on its own device, as the
reference's ``shard_map``s lay them out: BROADCAST replicates the sorted
build to every device and shards the probe (``mesh_probe_ranges``,
``mesh_probe_unique``); SHUFFLE partitions both sides by key modulo the
mesh size, one bucket a device (``partition_by_key``, the exchange's
stand-in), each bucket sorted and probed on its device
(``mesh_bucket_ranges``) and expanded per bucket
(``expand_pairs_buckets``). Results gather to the mesh's first device.
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


# ---------------------------------------------------------------------------
# mesh forms: BROADCAST (replicated build, sharded probe), SHUFFLE (a key
# bucket a device)
# ---------------------------------------------------------------------------


def mesh_probe_ranges(mesh, sorted_keys: torch.Tensor,
                      probe: torch.Tensor) -> tuple:
    """``probe`` (D * Lp,) cut into D runs, run d probed on device d
    against its replica of the sorted build; (lo, counts) gathered back
    in probe order."""
    D = mesh.size
    Lp = probe.shape[0] // D
    dest = probe.device
    los, counts = [], []
    for d, dev in enumerate(mesh.devices):
        lo, c = probe_ranges(sorted_keys.to(dev),
                             probe[d * Lp:(d + 1) * Lp].to(dev))
        los.append(lo.to(dest))
        counts.append(c.to(dest))
    return torch.cat(los), torch.cat(counts)


def mesh_probe_unique(mesh, sorted_keys: torch.Tensor, perm: torch.Tensor,
                      probe: torch.Tensor) -> tuple:
    """The 1:1 probe, sharded: each device probes its run of ``probe``
    against its replica of the unique-key build."""
    D = mesh.size
    Lp = probe.shape[0] // D
    dest = probe.device
    found, rows = [], []
    for d, dev in enumerate(mesh.devices):
        f, r = probe_unique(sorted_keys.to(dev), perm.to(dev),
                            probe[d * Lp:(d + 1) * Lp].to(dev))
        found.append(f.to(dest))
        rows.append(r.to(dest))
    return torch.cat(found), torch.cat(rows)


def partition_by_key(keys: torch.Tensor, n_buckets: int,
                     pad_value: int) -> tuple:
    """Rows → ``n_buckets`` buckets by key modulo (codes are dense, so
    modulo spreads them): ((D, L) keys padded with ``pad_value``, (D, L)
    int64 row indexes, -1 on padding), each bucket's rows in row order."""
    keys = keys.to(torch.int64)
    dev = keys.device
    bucket = keys % n_buckets
    order = torch.sort(bucket, stable=True).indices
    sb = bucket[order]
    counts = torch.bincount(sb, minlength=n_buckets)
    L = max(int(counts.max()) if keys.numel() else 0, 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(keys.numel(), device=dev) - starts[sb]
    out_keys = torch.full((n_buckets, L), pad_value, dtype=torch.int64,
                          device=dev)
    out_rows = torch.full((n_buckets, L), -1, dtype=torch.int64, device=dev)
    out_keys[sb, pos] = keys[order]
    out_rows[sb, pos] = order
    return out_keys, out_rows


def mesh_bucket_ranges(mesh, build_buckets: torch.Tensor,
                       probe_buckets: torch.Tensor) -> tuple:
    """Bucket d's build sorted and its probe searched on device d: (lo
    (D, Lp), counts (D, Lp), perm (D, Lb)), positions local to each
    bucket."""
    dest = build_buckets.device
    los, counts, perms = [], [], []
    for d, dev in enumerate(mesh.devices):
        sk, perm = sort_build(build_buckets[d].to(dev))
        lo, c = probe_ranges(sk, probe_buckets[d].to(dev))
        los.append(lo.to(dest))
        counts.append(c.to(dest))
        perms.append(perm.to(dest))
    return torch.stack(los), torch.stack(counts), torch.stack(perms)


def expand_pairs_buckets(lo: torch.Tensor, counts: torch.Tensor,
                         bound: int) -> tuple:
    """``expand_pairs`` per bucket: (probe row, build position, valid),
    each (D, bound), positions local to each bucket."""
    outs = [expand_pairs(lo[d], counts[d], bound)
            for d in range(lo.shape[0])]
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))
