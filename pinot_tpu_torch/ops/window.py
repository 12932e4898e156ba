"""Window functions as torch ops: one ordering, segmented scans, scatter
back.

Counterpart of pinot_tpu/ops/window.py (XLA code there, ``lax.sort`` and
associative scans): ROW_NUMBER / RANK / DENSE_RANK and the running SUM /
AVG / COUNT / MIN / MAX over ``OVER (PARTITION BY ... ORDER BY ...)``
specs that share one (partition, order) pair.

1. Rows are ordered by (partition code, order code, row id). torch has no
   multi-key sort: the two codes pack into one int64 key when their
   ranges allow, else two stable sorts run from the last key to the
   first. Every sort is stable, so the row id breaks ties as the
   reference's third sort key does, and the order is the scatter-back
   permutation.
2. Partition and peer (tie) starts come from neighbour differences.
3. Every function is a segmented scan over them (ops/radix_groupby.py
   ``seg_sum`` / ``seg_min`` / ``seg_max``, and ``_carry_first`` for RANK).
   SQL's default frame with ORDER BY (RANGE UNBOUNDED PRECEDING .. CURRENT
   ROW) gives peers their run's last scan value (``_run_end_broadcast``);
   without ORDER BY the order code is constant, one peer run a partition.
   Float running sums are the log-step scan, the reference's
   associative-scan form; integer results are exact.
4. Results scatter back to the original row order.

Eager torch needs no padding to a power of two (the reference's
``pad_inputs``); nothing here depends on the length.
"""

from __future__ import annotations

import torch

from pinot_tpu_torch.ops.radix_groupby import _scan, seg_max, seg_min, seg_sum

# window function -> needs a value operand?
WINDOW_FUNCTIONS = {
    "row_number": False,
    "rank": False,
    "dense_rank": False,
    "count": True,   # COUNT(x) — callers pass no operand for COUNT(*)
    "sum": True,
    "avg": True,
    "min": True,
    "max": True,
}

RANK_FUNCTIONS = ("row_number", "rank", "dense_rank", "count")


def _carry_first(values: torch.Tensor, is_start: torch.Tensor):
    """Segmented carry: every element takes its run's FIRST value."""
    return _scan(values, is_start, lambda a, b: a)


def _run_end_broadcast(x: torch.Tensor, run_start: torch.Tensor):
    """Every element takes its run's LAST value (the peer-inclusive frame
    read): reversed, run ends are run starts."""
    run_end = torch.cat([run_start[1:], run_start.new_ones(1)])
    return _carry_first(x.flip(0), run_end.flip(0)).flip(0)


def sort_order(part: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The permutation that orders rows by (part, order, row id): both
    codes non-negative int64."""
    n = part.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=part.device)
    o_card = int(order.max()) + 1
    p_card = int(part.max()) + 1
    if p_card * o_card < (1 << 62):
        return torch.sort(part * o_card + order, stable=True).indices
    perm = torch.sort(order, stable=True).indices
    return perm[torch.sort(part[perm], stable=True).indices]


def window_eval(part: torch.Tensor, order: torch.Tensor, values: tuple,
                specs: tuple) -> tuple:
    """Evaluate window specs sharing one (PARTITION BY, ORDER BY) pair.

    part:   (n,) int64 partition codes, non-negative.
    order:  (n,) int64 order codes, non-negative (descending keys already
            reversed by the caller); constant without ORDER BY.
    values: tuple of (n,) float64 operand columns.
    specs:  tuple of (fn_name, value_index): value_index -1 for the rank
            family and COUNT(*), else an index into ``values``.

    Returns one (n,) tensor a spec in the ORIGINAL row order: int64 for
    the rank family and COUNT, float64 otherwise."""
    n = part.shape[0]
    perm = sort_order(part, order)
    p, o = part[perm], order[perm]
    vs = [v[perm] for v in values]
    part_start = torch.ones(n, dtype=torch.bool, device=part.device)
    part_start[1:] = p[1:] != p[:-1]
    peer_start = part_start.clone()
    peer_start[1:] |= o[1:] != o[:-1]
    row_number = seg_sum(torch.ones(n, dtype=torch.int64, device=part.device),
                         part_start)
    run_sums: dict = {}

    def running_sum(vi):
        if vi not in run_sums:
            run_sums[vi] = seg_sum(vs[vi], part_start)
        return run_sums[vi]

    outs = []
    for fn, vi in specs:
        if fn == "row_number":
            res = row_number
        elif fn == "rank":
            res = _carry_first(row_number, peer_start)
        elif fn == "dense_rank":
            res = seg_sum(peer_start.to(torch.int64), part_start)
        elif fn == "count":
            res = _run_end_broadcast(row_number, peer_start)
        elif fn == "sum":
            res = _run_end_broadcast(running_sum(vi), peer_start)
        elif fn == "avg":
            res = _run_end_broadcast(running_sum(vi), peer_start) \
                / _run_end_broadcast(row_number, peer_start).to(torch.float64)
        elif fn == "min":
            res = _run_end_broadcast(seg_min(vs[vi], part_start), peer_start)
        elif fn == "max":
            res = _run_end_broadcast(seg_max(vs[vi], part_start), peer_start)
        else:
            raise ValueError(f"unknown window function {fn}")
        out = torch.empty_like(res)
        out[perm] = res
        outs.append(out)
    return tuple(outs)
