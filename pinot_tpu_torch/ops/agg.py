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


def rows_per_block_for(max_abs_value: float):
    """Largest power-of-two block size whose int32 block-sum cannot overflow,
    or None when values are too large for it (the reference's bound for
    its two-stage sums; the port keeps it for the fused block-skip plan,
    whose per-block int32 partials cover 4096 rows)."""
    if max_abs_value <= 0:
        return 1 << 20
    rpb = 1
    while rpb * 2 * (max_abs_value + 1) < 2**31 and rpb < (1 << 20):
        rpb *= 2
    return rpb if rpb >= 256 else None


def _wide(values):
    return torch.int64 if not values.is_floating_point() else torch.float64


def _extremes(dtype):
    if dtype.is_floating_point:
        return POS_INF, NEG_INF
    if dtype == torch.bool:   # CAST(x AS BOOLEAN), as jnp.iinfo(bool)
        return True, False
    info = torch.iinfo(dtype)
    return info.max, info.min


# float MIN / MAX reduce signed-integer order keys of the float bits
# (-0.0 < +0.0), as K2 and K4 do, so a group or a mask holding both zeros
# gives the same sign on every route and in any row order. A NaN of
# either sign takes the key that wins the op, as the reference's
# jnp.minimum / np.minimum.at propagate it: which NaN a backend makes
# (CUDA's 0x7fffffff, numpy's 0xffc00000) does not move the answer.
# This is the port's one float order-key rule: the kernels' plain
# versions (ops/kernels.py), the sorted regime (ops/radix_groupby.py) and
# the cohorts use it, and csrc/group_minmax.cu / fused_filter_agg.cu
# compute the same keys.
_KEY_INTS = {torch.float32: (torch.int32, 31), torch.float64: (torch.int64, 63)}


def float_keys(v, how: str | None = None):
    """Keys whose signed order is the float order of ``v``'s bits; the
    map is its own inverse (``from_float_keys``). ``how`` ("min" /
    "amin" or "max" / "amax"): a NaN becomes the least or the greatest
    key of the dtype, which decodes to a NaN, so it wins that op."""
    it, sh = _KEY_INTS[v.dtype]
    b = v.view(it)
    k = b ^ ((b >> sh) & ((1 << sh) - 1))
    if how is None:
        return k
    info = torch.iinfo(it)
    return torch.where(torch.isnan(v),
                       info.min if how.endswith("min") else info.max, k)


def from_float_keys(k, dtype):
    _it, sh = _KEY_INTS[dtype]
    return (k ^ ((k >> sh) & ((1 << sh) - 1))).view(dtype)


def _masked_extreme(values, mask, how: str):
    fill = _extremes(values.dtype)[0 if how == "min" else 1]
    v = torch.where(mask, values, torch.full((), fill, dtype=values.dtype,
                                            device=values.device))
    if values.dtype not in _KEY_INTS:
        return v.min() if how == "min" else v.max()
    k = float_keys(v, how)
    return from_float_keys(k.min() if how == "min" else k.max(),
                           values.dtype)


# ---- scalar (non-group-by) aggregations over a mask -----------------------


def agg_sum(values, mask):
    v = torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                              device=values.device))
    return v.sum(dtype=_wide(values))


def agg_min(values, mask):
    return _masked_extreme(values, mask, "min")


def agg_max(values, mask):
    return _masked_extreme(values, mask, "max")


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
    if v.dtype in _KEY_INTS:
        keys = float_keys(out)
        keys.scatter_reduce_(0, flat, float_keys(v, how), reduce=how,
                             include_self=True)
        return from_float_keys(keys, v.dtype)[:num_groups]
    out.scatter_reduce_(0, flat, v, reduce=how, include_self=True)
    return out[:num_groups]


def group_min(gids, values, num_groups: int):
    return _group_reduce(gids, values, num_groups, "amin",
                         _extremes(values.dtype)[0])


def group_max(gids, values, num_groups: int):
    return _group_reduce(gids, values, num_groups, "amax",
                         _extremes(values.dtype)[1])


def slot_max(slots, values, num_slots: int):
    """Per-slot max of non-negative ints, 0 where no row lands (the HLL
    register scatter-max past the register kernels' regimes)."""
    return _group_reduce(slots, values, num_slots, "amax", 0)


INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)


def _arg_time_operands(values, times, exact: bool):
    """(int64 times, values): float64 values, as the JAX package's device
    carries them, or int64 where ``exact`` (integer values, as its host
    path carries them: a LONG past 2^53 keeps its bits)."""
    return times.to(torch.int64), \
        values.to(torch.int64 if exact else torch.float64)


def _no_winner(v: torch.Tensor):
    """The value a group with no candidate takes: -inf, or INT64_MIN."""
    return NEG_INF if v.is_floating_point() else INT64_MIN


def _candidates(v: torch.Tensor, at_best: torch.Tensor) -> torch.Tensor:
    """Rows whose value competes: at the winning time, and not NaN."""
    return at_best & ~torch.isnan(v) if v.is_floating_point() else at_best


def agg_arg_time(values, times, mask, is_first: bool, exact: bool = False):
    """FIRSTWITHTIME / LASTWITHTIME over a mask: (best time, best value),
    the min (first) or max (last) time over matched rows and the largest
    non-NaN value among the rows at that time (-inf when there is none;
    the host conversion turns it into NaN). Times ride as int64, values
    as ``_arg_time_operands`` carries them."""
    t, v = _arg_time_operands(values, times, exact)
    fill = INT64_MAX if is_first else INT64_MIN
    tm = torch.where(mask, t, torch.full((), fill, dtype=torch.int64,
                                         device=t.device))
    tb = tm.min() if is_first else tm.max()
    win = _candidates(v, mask & (t == tb))
    vb = torch.where(win, v, torch.full((), _no_winner(v), dtype=v.dtype,
                                        device=v.device)).max()
    return tb, vb


def _spread_reduce(flat, v, num_slots: int, how: str, init):
    """(num_slots,) min or max of ``v`` per slot. Row i reduces into copy
    i % B of the table, then the B copies reduce: with few slots, one
    table would take every row's atomic on a handful of addresses."""
    n = v.numel()
    B = max(1, min(1024, (1 << 24) // num_slots, n))
    slot = (torch.arange(n, device=v.device) % B) * num_slots + flat
    part = torch.full((B * num_slots,), init, dtype=v.dtype, device=v.device)
    part.scatter_reduce_(0, slot, v, how, include_self=True)
    part = part.view(B, num_slots)
    return part.amin(0) if how == "amin" else part.amax(0)


def group_arg_time(gids, values, times, num_groups: int, is_first: bool,
                   exact: bool = False):
    """Dense-group FIRSTWITHTIME / LASTWITHTIME: per group the extremal
    time (a scatter-min or -max), then the largest non-NaN value among the
    rows carrying their group's winning time (a scatter-max; -inf, or
    INT64_MIN when ``exact``, where there is none). Masked rows carry the
    overflow id."""
    flat = gids.reshape(-1).to(torch.int64)
    t, v = _arg_time_operands(values.reshape(-1), times.reshape(-1), exact)
    fill = INT64_MAX if is_first else INT64_MIN
    tb = _spread_reduce(flat, t, num_groups + 1,
                        "amin" if is_first else "amax", fill)
    win = _candidates(v, t == tb[flat])
    vb = _spread_reduce(flat, torch.where(win, v, _no_winner(v)),
                        num_groups + 1, "amax", _no_winner(v))
    return tb[:num_groups], vb[:num_groups]


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


def distinct_presence(gids, num_groups: int):
    """Presence vector over global ids (DISTINCTCOUNT on a dict column):
    1 where any doc carries the id; ids == num_groups are masked docs."""
    flat = gids.reshape(-1).to(torch.int64)
    out = torch.zeros(num_groups + 1, dtype=torch.int8, device=flat.device)
    out.index_fill_(0, flat, 1)
    return out[:num_groups]
