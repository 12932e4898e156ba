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


# ---------------------------------------------------------------------------
# the distributed exchange's partitioning (query2/exchange.py routes the
# partitions; the hash here is its ``stable_hash64`` on the card)
# ---------------------------------------------------------------------------

def _u64(c: int) -> int:
    """A uint64 constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_FNV_PRIME = _u64(0x100000001B3)
_FNV_OFFSET = _u64(0xCBF29CE484222325)
_MIX1 = _u64(0xBF58476D1CE4E5B9)
_MIX2 = _u64(0x94D049BB133111EB)


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (v >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(v: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 bits; products wrap mod 2^64 as
    the reference's uint64 ones do."""
    v = v ^ _shr(v, 30)
    v = v * _MIX1
    v = v ^ _shr(v, 27)
    v = v * _MIX2
    return v ^ _shr(v, 31)


def stable_hash64(columns, n: int, device) -> torch.Tensor:
    """query2/exchange.py ``stable_hash64`` on the card, bit for bit: each
    key column is (values tensor, strings or None), a string column's
    values being int64 codes into its ``strings``. Numbers hash their
    float64 bits with -0.0 folded into +0.0; a string hashes the crc32 of
    its UTF-8 bytes, computed on the host once per distinct value and
    gathered by code. Returns (n,) non-negative int64."""
    import zlib

    import numpy as np

    h = torch.full((max(n, 0),), _FNV_OFFSET, dtype=torch.int64,
                   device=device)
    for t, strings in columns:
        if strings is not None:
            crc = np.fromiter((zlib.crc32(str(v).encode("utf-8"))
                               for v in strings), dtype=np.int64,
                              count=len(strings))
            vals = torch.as_tensor(crc, device=device)[t.to(torch.int64)] \
                if n else torch.zeros(0, dtype=torch.int64, device=device)
        else:
            canon = t.to(torch.float64)
            canon = torch.where(canon == 0.0, torch.zeros_like(canon), canon)
            vals = canon.view(torch.int64)
        h = h * _FNV_PRIME + _splitmix64(vals)
    return _shr(_splitmix64(h), 1)


def hash_partition_rows(part_ids: torch.Tensor, n_parts: int) -> tuple:
    """The wire exchange's partitioning (the reference's ragged form):
    each row's partition id → (the rows in partition order, stable
    within a partition, as a tensor on the ids' device; the host list of
    ``n_parts + 1`` offsets where each partition starts). The caller
    copies each column to the host once in this order and cuts the
    partitions there, so no partition costs a copy of its own."""
    part_ids = part_ids.to(torch.int64)
    order = torch.sort(part_ids, stable=True).indices
    counts = torch.bincount(part_ids, minlength=n_parts).cpu().tolist()
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + int(c))
    return order, bounds
