"""Rows, keys and per-segment limits on the card, as torch ops.

The JAX package answers selection, DISTINCT over non-dict columns and
group-bys over expressions, raw or virtual columns on its host, one
segment at a time (its engine/host.py ``_selection``, ``_distinct``,
``_group_by``). These are the same steps over the whole (S, L) batch at
once, each kept per segment where the host's answer depends on it:

- ``first_rows``: the first ``k`` matched rows of every segment in doc
  order (a selection without ORDER BY);
- ``ordered_rows``: every segment's matched rows in the stable
  lexicographic order of its ORDER BY keys, cut to ``k`` per segment (one
  set of stable sorts serves the batch: the segment is the leading key);
- ``factorize``: group ids over several key columns, groups in
  lexicographic key order (the host's ``factorize_multi``), and each
  group's keys;
- ``limit_groups``: numGroupsLimit as the host applies it, per segment:
  the first ``limit`` groups met in doc order keep their rows;
- ``distinct_pair_counts``: per-group distinct counts of a value key;
- ``expand``: rows repeated by a count each (a multi-value column's
  entries), laid out again as an (S, Lx) batch.

Row positions are flat, ``segment * L + doc``, ascending: the order the
host meets rows in.
"""

from __future__ import annotations

import torch

from pinot_tpu_torch.ops.device_reduce import lexsort_perm

_COMBINED_LIMIT = 1 << 62   # mixed-radix group codes must fit int64


def first_rows(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Flat positions of the first ``k`` matched rows of each segment of
    the (S, L) ``mask``, ascending."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
    if k <= 0 or idx.numel() == 0:
        return idx[:0]
    seg = idx // mask.shape[1]
    pos = torch.arange(idx.numel(), device=idx.device) \
        - segment_starts(seg, mask.shape[0])[seg]
    return idx[pos < k]


def segment_starts(seg: torch.Tensor, S: int) -> torch.Tensor:
    """Start offset of each segment's run in a segment-sorted vector (a
    binary search, where a histogram of few bins would contend)."""
    return torch.searchsorted(
        seg, torch.arange(S, dtype=seg.dtype, device=seg.device))


def ordered_rows(idx: torch.Tensor, keys, L: int, S: int,
                 k: int) -> torch.Tensor:
    """``idx``: flat positions of the matched rows, ascending; ``keys``:
    their int64 ORDER BY keys, primary first, ascending. Returns each
    segment's first ``k`` rows in (segment, keys..., doc) order: the
    host's per-segment stable lexsort and trim."""
    if k <= 0 or idx.numel() == 0:
        return idx[:0]
    seg = idx // L
    perm = lexsort_perm([seg] + list(keys))
    seg_s = seg[perm]
    pos = torch.arange(idx.numel(), device=idx.device) \
        - segment_starts(seg_s, S)[seg_s]
    return idx[perm[pos < k]]


def factorize(keys, mask, cards=None, dense_limit: int = 1 << 22) -> tuple:
    """(gid, G, group_keys): ``keys`` are (N,) int64 key columns whose
    order is the value order, ``mask`` (N,) the rows that count. ``gid``
    numbers the key tuples in lexicographic key order (a row outside the
    mask gets some id in range); ``group_keys[j]`` (G,) is each id's key
    in column j. A column whose keys lie in a known range ``cards[j]``,
    or span fewer than ``dense_limit`` values over the mask, codes by
    offset; any other by its rank among the masked rows' distinct keys
    (``torch.unique``). Codes combine in mixed radix, the id space itself
    while the product stays within ``dense_limit`` (ids no row holds
    stay empty), else the present tuples numbered; the ids decode into
    keys by arithmetic, with no pass over the rows."""
    steps, comb, card = [], None, 1
    for j, k in enumerate(keys):
        n = None if cards is None else cards[j]
        lo, u = 0, None
        if n is None:
            km = k[mask]
            lo, hi = (int(x) for x in torch.aminmax(km)) if km.numel() \
                else (0, 0)
            if hi - lo < dense_limit:
                n = hi - lo + 1
            else:
                u = torch.unique(km, sorted=True)
                n = int(u.numel())
        n = max(n, 1)
        code = torch.searchsorted(u, k) if u is not None else k - lo
        code = torch.clamp(code, 0, n - 1)
        if comb is not None and card * n >= _COMBINED_LIMIT:
            comb, card = _compact(comb, mask, steps)
        comb = code if comb is None else comb * n + code
        card *= n
        steps.append((j, lo, u, n))
    if card > dense_limit:
        comb, card = _compact(comb, mask, steps)
    code = torch.arange(card, dtype=torch.int64, device=keys[0].device)
    out = [None] * len(keys)
    for st in reversed(steps):
        if st[0] == "compact":
            code = st[1][code]
            continue
        j, lo, u, n = st
        c = code % n
        code = code // n
        out[j] = u[c] if u is not None else c + lo
    return comb, card, out


def _compact(comb, mask, steps) -> tuple:
    """Number the present combined codes; ``steps`` records the table
    that decodes them back."""
    uc = torch.unique(comb[mask], sorted=True)
    steps.append(("compact", uc))
    n = max(int(uc.numel()), 1)
    return torch.clamp(torch.searchsorted(uc, comb), 0, n - 1), n


def first_of(gid: torch.Tensor, num_groups: int):
    """(G,) first row index of each id in ``gid`` (ids 0..G-1)."""
    M = gid.numel()
    pos = torch.arange(M, dtype=torch.int64, device=gid.device)
    return torch.full((num_groups,), M, dtype=torch.int64,
                      device=gid.device) \
        .scatter_reduce_(0, gid, pos, "amin", include_self=True)


def limit_groups(seg: torch.Tensor, gid: torch.Tensor, num_groups: int,
                 S: int, limit: int):
    """numGroupsLimit per segment over matched rows in flat order: in a
    segment with more than ``limit`` groups, the first ``limit`` groups met
    in doc order keep their rows. Returns the (M,) keep mask, or None when
    no segment passes the limit."""
    if gid.numel() <= limit or num_groups <= limit:
        return None
    pair = seg * num_groups + gid
    up, pinv = torch.unique(pair, sorted=True, return_inverse=True)
    P = up.numel()
    if P <= limit:
        return None
    pseg = up // num_groups
    starts = segment_starts(pseg, S)
    counts = torch.diff(starts, append=starts.new_tensor([P]))
    if not bool((counts > limit).any()):
        return None
    # rows are flat-ordered, so first occurrences order each segment's
    # groups by the doc that met them first, segment by segment
    order = torch.argsort(first_of(pinv, P))
    rank = torch.empty(P, dtype=torch.int64, device=gid.device)
    rank[order] = torch.arange(P, device=gid.device) - starts[pseg[order]]
    return (rank < limit)[pinv]


def distinct_pair_counts(gid: torch.Tensor, vkey: torch.Tensor,
                         num_groups: int) -> torch.Tensor:
    """(G,) int64 count of distinct ``vkey`` values per group over rows
    with ``gid`` < num_groups (the overflow id marks masked rows)."""
    sel = gid < num_groups
    g, v = gid[sel].to(torch.int64), vkey[sel]
    uv, vinv = torch.unique(v, sorted=True, return_inverse=True)
    V = max(int(uv.numel()), 1)
    pairs = torch.unique(g * V + vinv) // V     # sorted by group
    ends = torch.searchsorted(pairs, torch.arange(
        1, num_groups + 1, dtype=pairs.dtype, device=pairs.device))
    return torch.diff(ends, prepend=ends.new_zeros(1))


def distinct_pairs(gid: torch.Tensor, vkey: torch.Tensor,
                   num_groups: int) -> tuple:
    """The distinct (group, value key) pairs over rows with ``gid`` <
    num_groups, as two vectors: the mergeable form of a distinct count."""
    sel = gid < num_groups
    g, v = gid[sel].to(torch.int64), vkey[sel]
    if g.numel() == 0:
        return g, v
    perm = lexsort_perm([g, v])
    g, v = g[perm], v[perm]
    new = torch.ones_like(g, dtype=torch.bool)
    new[1:] = (g[1:] != g[:-1]) | (v[1:] != v[:-1])
    return g[new], v[new]


def expand(counts: torch.Tensor) -> tuple:
    """Each row of the (S, L) int64 ``counts`` repeated ``counts`` times,
    in row order, each segment's rows a prefix of its row of an (S, Lx)
    layout: (src (S*Lx,) the flat row each repeats, rank (S*Lx,) its
    repetition, per (S,) the rows of each segment, Lx). Padding
    positions hold row 0, repetition 0."""
    S, L = counts.shape
    dev = counts.device
    c = counts.reshape(-1)
    per = counts.sum(dim=1)
    host = per.cpu()
    Lx = max(int(host.max()), 1) if S else 1
    total = int(host.sum())
    src = torch.repeat_interleave(torch.arange(S * L, device=dev), c,
                                  output_size=total)
    k = torch.arange(total, device=dev)
    rank = k - (torch.cumsum(c, 0) - c)[src]
    seg = src // L
    pos = seg * Lx + (k - (torch.cumsum(per, 0) - per)[seg])
    out_src = torch.zeros(S * Lx, dtype=torch.int64, device=dev)
    out_rank = torch.zeros(S * Lx, dtype=torch.int64, device=dev)
    out_src[pos] = src
    out_rank[pos] = rank
    return out_src, out_rank, per, Lx
