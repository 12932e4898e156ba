"""Chunked sorts for the high-cardinality regimes: the HLL half.

Counterpart of pinot_tpu/ops/radix_groupby.py. The reference sorts with
``lax.sort``, which it leaves to XLA; here the same sorts are
``torch.sort`` on the card. This module carries what the terminal sorted
HLL build needs (engine/device.py ``_hll_sorted_sums``): the chunk plan
and ``hll_chunked_sorted_keys``, which dedupes packed ``slot << 5 | rho``
keys to one per slot per chunk in chunk-local sorts, so no pass but the
last sorts a row-scale operand.

The generic sorted group-by (``pack_keys``, ``chunked_group_aggregate``,
``merge_tables``, ``bucket_histogram``) comes with a later slice of the
port.
"""

from __future__ import annotations

import torch

INT32_SENTINEL = (1 << 31) - 1   # masked/padded rows: sorts after real keys

CHUNK_ROWS = 1 << 20          # level-1 chunk length target
CHUNK_ROWS_MAX = 1 << 23      # growth cap when the table bound forces
                              # bigger chunks (the q4 HLL slot space,
                              # 2000 groups x 1024 registers)
MIN_COMPACT_RATIO = 4         # chunking pays only when E <= L / this
HLL_COMPACT_RATIO = 2         # the HLL dedup keeps one entry per slot per
                              # chunk and iterates, so even a 2x shrink per
                              # pass converges in O(log) passes


def plan_chunks(n: int, table_k: int, chunk_rows: int | None = None,
                min_ratio: int = MIN_COMPACT_RATIO):
    """(C, L): chunk count and length for ``n`` rows whose compaction
    keeps at most ``table_k + 1`` entries per chunk. Chunking engages
    only when that width shrinks the next pass by at least
    ``min_ratio``; otherwise C = 1, one sort over all rows."""
    L = chunk_rows or CHUNK_ROWS
    cap = max(L, CHUNK_ROWS_MAX)
    while L < min_ratio * (table_k + 1) and L < cap:
        L *= 2
    if n < 2 * L or min(L, table_k + 1) * min_ratio > L:
        return 1, n
    return -(-n // L), L


def _pad_chunks(x, C: int, L: int, fill):
    n = x.shape[0]
    if C * L > n:
        x = torch.cat([x, torch.full((C * L - n,), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(C, L)


def hll_chunked_sorted_keys(packed, n_slots: int,
                            chunk_rows: int | None = None):
    """Packed (n,) int32 ``slot << 5 | rho`` keys → a (usually much
    smaller) SORTED int32 key array with the same per-slot max rho, the
    operand of engine/device.py ``_hll_sums_from_sorted``, which reads
    only slot-run ends.

    Each pass sorts every chunk on its own, keeps each slot's run end
    (the chunk's max rho, since rho is in the low bits) and compacts to
    E = min(L, n_slots + 2) entries: the slots, the masked-row overflow
    slot and the pad sentinel, so the cut never drops a slot. Passes
    repeat on the survivors until chunking stops paying; one sort of
    what is left restores global order."""
    out = packed
    while True:
        C, L = plan_chunks(out.shape[0], n_slots + 1, chunk_rows,
                           min_ratio=HLL_COMPACT_RATIO)
        if C == 1:
            return torch.sort(out).values
        E = min(L, n_slots + 2)
        sk = torch.sort(_pad_chunks(out, C, L, INT32_SENTINEL), dim=1).values
        slot = sk >> 5
        slot_end = torch.ones_like(sk, dtype=torch.bool)
        slot_end[:, :-1] = slot[:, :-1] != slot[:, 1:]
        kept = torch.where(slot_end, sk, INT32_SENTINEL)
        out = torch.sort(kept, dim=1).values[:, :E].reshape(-1)
