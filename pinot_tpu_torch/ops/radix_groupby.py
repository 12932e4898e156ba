"""Chunked sorts for the high-cardinality regimes: the sorted group-by
and the HLL dedup.

Counterpart of pinot_tpu/ops/radix_groupby.py. The reference sorts with
``lax.sort`` and reduces runs with ``lax.associative_scan``, both left to
XLA; here the same steps are torch ops on the card:

1. **Key packing** (``pack_keys``): the cartesian dict-id key packs into
   int32 when the key space fits (``MAX_KEYSPACE_32``), else int64;
   masked rows carry the dtype's sentinel, which sorts last.
2. **Chunked level-1 sorts**: the rows split into C chunks of L rows
   (``plan_chunks``) and ONE ``torch.sort(dim=-1)`` sorts every chunk of
   the (C, L) view. Payloads follow the sort through its indices, each
   distinct argument carried once; only the real (unmasked) rows are
   gathered, as the sentinel runs are dropped anyway.
3. **Run-end partials**: within a sorted chunk every group is a run.
   COUNT is the run's length; an integer SUM a difference of int64
   cumulative sums at run ends (exact under two's-complement wrap); a
   float SUM a segmented scan of the run's own values (no cancellation
   against the other runs); MIN / MAX segmented scans, floats over the
   int order keys of ops/agg.py (-0.0 below +0.0) with a NaN winning, as
   it does in ``jnp.minimum`` / ``jnp.maximum``.
4. **Static compaction**: each chunk keeps its first E = min(L, K + 1)
   runs, K the group-table cap. A chunk with more distinct keys proves
   that the query has more than K groups (chunk-distinct <= global
   distinct), so the cut never drops a group silently: the overflow
   shows in ``n_groups_total``.
5. **Level-2+ merges** re-enter the same chunk / sort / combine /
   compact structure over the partials until chunking stops paying; one
   answer-scale sort builds the (K,) table. ``merge_tables`` runs that
   combine over tables gathered from several devices, aligned by key.

``bucket_histogram`` counts rows per radix partition (the key's high
bits) through K1's count channel (ops/groupby_mm.py ``group_sums``), as
the reference's reaches its Pallas kernel.

``hll_chunked_sorted_keys`` dedupes packed ``slot << 5 | rho`` keys to
one per slot per chunk for the terminal sorted HLL build
(engine/device.py ``_hll_sorted_sums``).
"""

from __future__ import annotations

import torch

INT32_SENTINEL = (1 << 31) - 1   # masked/padded rows: sorts after real keys
INT64_SENTINEL = (1 << 63) - 1   # the same for the int64 basis, and empties
MAX_KEYSPACE_32 = (1 << 31) - 1  # int32 keys stay strictly below the sentinel

CHUNK_ROWS = 1 << 20          # level-1 chunk length target
CHUNK_ROWS_MAX = 1 << 23      # growth cap when the table bound forces
                              # bigger chunks (the q4 HLL slot space,
                              # 2000 groups x 1024 registers)
MIN_COMPACT_RATIO = 4         # chunking pays only when E <= L / this
HLL_COMPACT_RATIO = 2         # the HLL dedup keeps one entry per slot per
                              # chunk and iterates, so even a 2x shrink per
                              # pass converges in O(log) passes

_I64 = torch.iinfo(torch.int64)
_LOW63 = (1 << 63) - 1


def _sentinel_for(dtype) -> int:
    return INT32_SENTINEL if dtype == torch.int32 else INT64_SENTINEL


def pack_keys(per_col_gids, cardinalities, mask):
    """Cartesian combined key in the narrowest dtype the key space allows:
    int32 when the product of cardinalities is below ``MAX_KEYSPACE_32``,
    else int64. Masked rows get the dtype's sentinel. The caller
    guarantees that the product fits int64."""
    total = 1
    for c in cardinalities:
        total *= int(c)
    dt = torch.int32 if total < MAX_KEYSPACE_32 else torch.int64
    key = None
    for g, c in zip(per_col_gids, cardinalities):
        g = torch.clamp(g.to(dt), 0, int(c) - 1)
        key = g if key is None else key * int(c) + g
    return torch.where(mask, key, torch.full((), _sentinel_for(dt), dtype=dt,
                                             device=key.device))


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


# ---------------------------------------------------------------------------
# segmented scans
# ---------------------------------------------------------------------------


def _boundaries(sk):
    """(is_start, is_end) along the last axis of a sorted key array."""
    is_start = torch.ones_like(sk, dtype=torch.bool)
    is_start[..., 1:] = sk[..., 1:] != sk[..., :-1]
    is_end = torch.ones_like(sk, dtype=torch.bool)
    is_end[..., :-1] = is_start[..., 1:]
    return is_start, is_end


def _float_keys(v):
    """int64 keys whose signed order is the order of float64 ``v``'s bits
    (-0.0 below +0.0); the map is its own inverse."""
    b = v.view(torch.int64)
    return b ^ ((b >> 63) & _LOW63)


def _from_float_keys(k):
    return (k ^ ((k >> 63) & _LOW63)).view(torch.float64)


def _extreme_keys(v, how: str):
    """The int64 operand MIN / MAX scans reduce: integers widened, floats
    their order keys with a NaN the extreme that wins ``how``."""
    if not v.is_floating_point():
        return v.to(torch.int64)
    k = _float_keys(v.to(torch.float64))
    win = _I64.min if how == "min" else _I64.max
    return torch.where(torch.isnan(v), torch.full_like(k, win), k)


def _scan(values, is_start, op):
    """Inclusive segmented scan along the last axis, restarting where
    ``is_start``: the reference's monoid over ``lax.associative_scan``
    (combine(a, b) = b where b starts a run, else op(a, b)), as
    log-step passes that each combine every position with the one
    ``d`` before it."""
    v, f = values, is_start
    n = v.shape[-1]
    d = 1
    while d < n:
        cur_v, cur_f = v[..., d:], f[..., d:]
        nv = torch.where(cur_f, cur_v, op(v[..., :-d], cur_v))
        v = torch.cat([v[..., :d], nv], dim=-1)
        f = torch.cat([f[..., :d], cur_f | f[..., :-d]], dim=-1)
        d *= 2
    return v


def seg_sum(values, is_start):
    """Segmented inclusive sum along the last axis. Integers: the int64
    cumulative sum less its value before each run (exact under wrap),
    over the flattened array with every row's first entry a run start;
    floats: the log-step scan, which only adds a run's own values."""
    if values.is_floating_point():
        return _scan(values, is_start, torch.add)
    first = torch.arange(values.shape[-1], device=values.device) == 0
    st = (is_start | first).reshape(-1)
    v = values.to(torch.int64).reshape(-1)
    c = torch.cumsum(v, 0)
    before = (c - v)[st]   # the cumulative sum before each run
    run = torch.cumsum(st.to(torch.int64), 0) - 1
    return (c - before[run]).reshape(values.shape)


def _seg_extreme(values, is_start, how: str):
    op = torch.minimum if how == "min" else torch.maximum
    out = _scan(_extreme_keys(values, how), is_start, op)
    if not values.is_floating_point():
        return out.to(values.dtype)
    return _from_float_keys(out).to(values.dtype)


def seg_min(values, is_start):
    """Segmented inclusive MIN along the last axis (floats: -0.0 below
    +0.0, a NaN wins)."""
    return _seg_extreme(values, is_start, "min")


def seg_max(values, is_start):
    """Segmented inclusive MAX along the last axis (floats: +0.0 above
    -0.0, a NaN wins)."""
    return _seg_extreme(values, is_start, "max")


# ---------------------------------------------------------------------------
# the chunked aggregation: sort within chunks, combine runs, compact
# ---------------------------------------------------------------------------


def _red_for(name: str) -> str:
    """The reduction of a partial column (``min::`` / ``max::`` prefixes
    pick the extremes; counts and sums add)."""
    if name.startswith("min::"):
        return "min"
    if name.startswith("max::"):
        return "max"
    return "sum"


def _sorted_real(key, cols: dict, C: int, L: int):
    """Sort every chunk of the (C, L) view of ``key``; returns the real
    entries in (chunk, key) order, their chunk, and ``cols`` gathered for
    them through the sort's indices."""
    sentinel = _sentinel_for(key.dtype)
    sk, perm = torch.sort(_pad_chunks(key, C, L, sentinel), dim=-1,
                          stable=True)
    flat = sk.reshape(-1)
    pos = torch.nonzero(flat != sentinel).reshape(-1)
    ch = pos // L
    src = ch * L + perm.reshape(-1)[pos]
    return flat[pos], ch, {nm: v[src] for nm, v in cols.items()}


def _combine(keys, ch, cols: dict):
    """Runs of equal (chunk, key) over entries in that order → one entry
    per run: its key, chunk and each column reduced by ``_red_for``."""
    st, en = _boundaries(keys)
    if ch is not None:
        ch_st, ch_en = _boundaries(ch)
        st, en = st | ch_st, en | ch_en
    ends = torch.nonzero(en).reshape(-1)
    out = {}
    for nm, v in cols.items():
        red = _red_for(nm)
        if red == "sum":
            out[nm] = seg_sum(v, st)[ends]
        else:   # int64 extreme keys: the scan's own op
            op = torch.minimum if red == "min" else torch.maximum
            out[nm] = _scan(v, st, op)[ends]
    return keys[ends], None if ch is None else ch[ends], out


def _compact(keys, ch, cols: dict, C: int, E: int):
    """Each chunk's first ``E`` runs (its smallest keys), and whether a
    chunk held more."""
    counts = torch.bincount(ch, minlength=C)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(keys.shape[0], device=keys.device) - first[ch]
    keep = rank < E
    return keys[keep], {nm: v[keep] for nm, v in cols.items()}, \
        (counts > E).any()


def _neutral(name: str, dtype):
    red = _red_for(name)
    if red == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if red == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if red == "min" else info.min


def chunked_group_aggregate(key, payloads, sums, mins, maxs, table_k: int,
                            chunk_rows: int | None = None):
    """The radix-partitioned group aggregation of a packed key array.

    key:      (n,) int32/int64 packed keys; masked rows carry the dtype's
              sentinel (``pack_keys``).
    payloads: {name: (values (n,), kind)}, kind "int" (summed and
              compared in int64) or "float" (float64): each distinct
              argument rides the sort once, widened after it.
    sums / mins / maxs: the payload names each reduction needs.
    table_k:  the group-table cap K (min(numGroupsLimit,
              MAX_SORTED_GROUPS)).

    Returns {"skeys": (K,) int64 keys ascending, INT64_SENTINEL where
    empty, "empty": (K,) bool, "gcount": (K,) int64,
    "sum::<name>" / "min::<name>" / "max::<name>": (K,) columns with each
    reduction's neutral fill where empty, "n_groups_total": 0-d int64}.
    The overflow contract: ``n_groups_total`` counts every distinct real
    key; when a chunk of any level held more than E = min(L, K + 1)
    distinct keys (so more than K overall), it is at least K + 1."""
    K = table_k
    dev = key.device
    C, L = plan_chunks(key.shape[0], K, chunk_rows)
    E = min(L, K + 1)
    rk, ch, pv = _sorted_real(key, {nm: v for nm, (v, _kind)
                                    in payloads.items()}, C, L)
    # level-1 partial columns, each reduced by the prefix of its name
    cols = {"cnt": torch.ones_like(rk, dtype=torch.int64)}
    for nm in sums:
        v = pv[nm]
        cols["sum::" + nm] = v.to(torch.int64) \
            if payloads[nm][1] == "int" else v.to(torch.float64)
    for nm in mins:
        cols["min::" + nm] = _extreme_keys(pv[nm], "min")
    for nm in maxs:
        cols["max::" + nm] = _extreme_keys(pv[nm], "max")
    mk, _ch, cols = _combine(rk, ch, cols)
    mk, cols, overflow = _compact(mk, _ch, cols, C, E)
    while True:
        C2, L2 = plan_chunks(mk.shape[0], K, chunk_rows)
        if C2 == 1:
            break
        E2 = min(L2, K + 1)
        rk, ch, cols = _sorted_real(mk, cols, C2, L2)
        mk, ch, cols = _combine(rk, ch, cols)
        mk, cols, over2 = _compact(mk, ch, cols, C2, E2)
        overflow = overflow | over2
    order = torch.sort(mk, stable=True).indices
    mk, _none, cols = _combine(mk[order], None,
                               {nm: v[order] for nm, v in cols.items()})
    n_groups = torch.tensor(mk.shape[0], dtype=torch.int64, device=dev)
    n_groups_total = torch.where(
        overflow, torch.clamp(n_groups, min=K + 1), n_groups)
    m = min(mk.shape[0], K)
    empty = torch.arange(K, device=dev) >= m
    skeys = torch.full((K,), INT64_SENTINEL, dtype=torch.int64, device=dev)
    skeys[:m] = mk[:m].to(torch.int64)
    outs = {"skeys": skeys, "empty": empty, "n_groups_total": n_groups_total}
    for nm, v in cols.items():
        if _red_for(nm) != "sum":   # order keys back to the payload's dtype
            v = _from_float_keys(v) if payloads[nm[5:]][1] == "float" else v
        col = torch.full((K,), _neutral(nm, v.dtype), dtype=v.dtype,
                         device=dev)
        col[:m] = v[:m]
        outs["gcount" if nm == "cnt" else nm] = col
    return outs


# ---------------------------------------------------------------------------
# the table merge across devices
# ---------------------------------------------------------------------------


def merge_tables(skeys, columns, reductions, table_k: int):
    """Merge group tables gathered from D devices: ``skeys`` (D, K) int64
    with INT64_SENTINEL empties, ``columns`` {name: (D, K)},
    ``reductions`` {name: "sum" | "min" | "max"}. Tables align by key,
    not slot: one answer-sized sort of the D*K entries re-runs the
    combine. Returns ({name: (T,)}, keys (T,), empty (T,),
    merged_distinct), T = min(D*K, table_k), empty slots with each
    reduction's neutral fill."""
    flat = skeys.reshape(-1)
    real = torch.nonzero(flat != INT64_SENTINEL).reshape(-1)
    order = real[torch.sort(flat[real], stable=True).indices]
    names = list(columns)
    prefix = {"sum": "", "min": "min::", "max": "max::"}
    cols = {}
    for nm in names:
        v = columns[nm].reshape(-1)[order]
        red = reductions[nm]
        cols[prefix[red] + nm] = v if red == "sum" else _extreme_keys(v, red)
    mk, _none, red_cols = _combine(flat[order], None, cols)
    merged_distinct = torch.tensor(mk.shape[0], dtype=torch.int64,
                                   device=flat.device)
    T = min(flat.shape[0], table_k)
    m = min(mk.shape[0], T)
    fk = torch.full((T,), INT64_SENTINEL, dtype=torch.int64,
                    device=flat.device)
    fk[:m] = mk[:m]
    out = {}
    for nm in names:
        red = reductions[nm]
        v = red_cols[prefix[red] + nm]
        dt = columns[nm].dtype
        if red != "sum":
            v = _from_float_keys(v).to(dt) if dt.is_floating_point \
                else v.to(dt)
        col = torch.full((T,), _neutral(prefix[red] + nm, dt), dtype=dt,
                         device=flat.device)
        col[:m] = v[:m].to(dt)
        out[nm] = col
    return out, fk, fk == INT64_SENTINEL, merged_distinct


# ---------------------------------------------------------------------------
# the HLL dedup (engine/device.py _hll_sorted_sums)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# the radix histogram
# ---------------------------------------------------------------------------


def bucket_shift(keyspace: int, n_buckets: int) -> int:
    """The right shift that maps keys below ``keyspace`` onto
    ``n_buckets`` partitions."""
    shift = 0
    while (keyspace - 1) >> shift >= n_buckets:
        shift += 1
    return shift


def bucket_histogram(key, keyspace: int, n_buckets: int):
    """(n_buckets,) int64 row counts per radix partition (the key's high
    bits) through K1's count channel: the histogram half of the radix
    scheme. Sentinel (masked) keys land in K1's overflow slot.
    ``n_buckets`` is a power of two; the shift derives from
    ``keyspace``."""
    from pinot_tpu_torch.ops import groupby_mm as mm

    shift = bucket_shift(keyspace, n_buckets)
    flat = key.reshape(-1)
    bucket = torch.clamp(flat >> shift, 0, n_buckets).to(torch.int32)
    bucket = torch.where(flat == _sentinel_for(key.dtype), n_buckets, bucket)
    counts = mm.group_sums(bucket.to(torch.int32), [], n_buckets, count=True)
    return torch.round(counts[0]).to(torch.int64)
