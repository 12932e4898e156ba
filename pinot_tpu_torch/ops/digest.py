"""The t-digest build of ops/quantile_digest.py ``add_values`` on the card.

``add_values([], [], values, delta)`` gives every value a weight of 1 and
runs ``compress``: a stable sort, then one greedy pass that closes a
cluster when ``(cum + acc_w + w[i]) / total <= q_limit`` fails. With unit
weights every term of that test is an integer count, so the cluster
sizes depend on the count N and on delta alone (``schedule``); each
centroid mean is the SEQUENTIAL float64 sum of its cluster's sorted
values, starting from the first, divided by its size. So the build is:

1. a stable sort of the values (NaN dropped, as ``add_values`` drops it),
   per run of (segment, group) — engine/sketches.py;
2. ``schedule(N, delta)`` for each run's count, on the host;
3. the ordered per-cluster sums of K5 (ops/kernels.py ``cluster_sums``),
   and one division on the card.

The schedule runs ``compress``'s own float64 predicate and its
``_k`` / ``_k_inv`` as scalar ``np.float64`` calls, as ``compress`` calls
them, so it cannot drift from it by a vectorized libm path. It takes
O(1) predicate tests per cluster instead of one per value: within a
cluster ``cum``, ``total`` and ``q_limit`` are fixed and the tested
quantity ``(cum + a + 1) / total`` is a correctly rounded quotient of
increasing integers, hence non-decreasing in ``a``: a cluster grows
while the test holds and closes at its first failure, found from an
estimate and corrected by exact tests either way.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from pinot_tpu_torch.ops.quantile_digest import _k, _k_inv


def _q_limit(cum: float, total: float, delta: float) -> float:
    """``compress``'s limit after ``cum`` weight was flushed."""
    return float(_k_inv(_k(np.float64(cum / total), delta) + 1.0, delta))


@functools.lru_cache(maxsize=4096)
def schedule(n: int, delta: float) -> tuple:
    """Cluster sizes ``compress`` gives ``n`` unit-weight values at
    compression ``delta``, in sorted order (sum ``n``)."""
    if n <= 0:
        return ()
    total, cum = float(n), 0.0
    q_limit = _q_limit(cum, total, delta)

    def holds(a: int) -> bool:
        # compress takes the next value into a cluster of size a
        return (cum + a + 1.0) / total <= q_limit

    sizes = []
    while True:
        left = n - int(cum)     # values from this cluster's first on
        # the cluster's size: its first failing a, at most ``left``
        a = int(min(max(math.floor(q_limit * total - cum), 1), left))
        while a < left and holds(a):
            a += 1
        while a > 1 and not holds(a - 1):
            a -= 1
        sizes.append(a)
        cum += float(a)
        if a == left:
            return tuple(sizes)
        q_limit = _q_limit(cum, total, delta)
