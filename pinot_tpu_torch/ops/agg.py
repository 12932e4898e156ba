"""Masked scalar aggregations and the dense group-by scatters, as torch ops.

Group ids arrive in global dictionary space (engine/params.py), so the
whole (S, L) batch aggregates into one dense (G,) accumulator: the segment
combine happens inside the launch. Masked and padding docs carry the
overflow id G, sliced off afterwards.

These scatters run where the JAX package leaves the work to XLA scatters
(its ops/agg.py): group shapes outside the kernels' bounds, or batches
below the kernels' minimum row count. The dense group sums, counts and
min/max on the main path go through the hand-written kernels
(ops/kernels.py) instead. Sums accumulate in int64 / float64 directly —
one exact pass, where the reference splits float sums into f32 block
partials on its TPU (the results agree to the float tolerance the tests
state).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")


def _wide(values):
    return torch.int64 if not values.is_floating_point() else torch.float64


def _extremes(dtype):
    if dtype.is_floating_point:
        return POS_INF, NEG_INF
    info = torch.iinfo(dtype)
    return info.max, info.min


# ---- scalar (non-group-by) aggregations over a mask -----------------------


def agg_sum(values, mask):
    v = torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                              device=values.device))
    return v.sum(dtype=_wide(values))


def agg_min(values, mask):
    big = _extremes(values.dtype)[0]
    return torch.where(mask, values, torch.full((), big, dtype=values.dtype,
                                                device=values.device)).min()


def agg_max(values, mask):
    small = _extremes(values.dtype)[1]
    return torch.where(mask, values, torch.full((), small, dtype=values.dtype,
                                                device=values.device)).max()


# ---- dense group-by scatter ----------------------------------------------


def group_count(gids, num_groups: int):
    flat = gids.reshape(-1).to(torch.int64)
    return torch.bincount(flat, minlength=num_groups + 1)[:num_groups]


def group_sum(gids, values, num_groups: int):
    flat = gids.reshape(-1).to(torch.int64)
    v = values.reshape(-1)
    out = torch.zeros(num_groups + 1, dtype=_wide(v), device=v.device)
    out.index_add_(0, flat, v.to(out.dtype))
    return out[:num_groups]


def _group_reduce(gids, values, num_groups: int, how: str, init):
    flat = gids.reshape(-1).to(torch.int64)
    v = values.reshape(-1)
    out = torch.full((num_groups + 1,), init, dtype=v.dtype, device=v.device)
    out.scatter_reduce_(0, flat, v, reduce=how, include_self=True)
    return out[:num_groups]


def group_min(gids, values, num_groups: int):
    return _group_reduce(gids, values, num_groups, "amin",
                         _extremes(values.dtype)[0])


def group_max(gids, values, num_groups: int):
    return _group_reduce(gids, values, num_groups, "amax",
                         _extremes(values.dtype)[1])


def group_ids_combine(per_col_gids, cardinalities, mask, num_groups: int):
    """Combine per-column global ids into one dense group id (the
    ARRAY_BASED regime of DictionaryBasedGroupKeyGenerator: key == id by
    cartesian arithmetic). Ids widen to int32 BEFORE the arithmetic —
    a uint8 plane times a cardinality would wrap at 255 — and are clipped
    into range (padding carries -1 or C). Masked docs land in the
    ``num_groups`` overflow slot."""
    gid = None
    for g, c in zip(per_col_gids, cardinalities):
        g = torch.clamp(g.to(torch.int32), 0, c - 1)
        gid = g if gid is None else gid * c + g
    return torch.where(mask, gid, torch.full((), num_groups, dtype=torch.int32,
                                             device=gid.device))
