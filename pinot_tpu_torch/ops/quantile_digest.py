"""Mergeable quantile sketch: a t-digest (merging variant) on flat arrays.

Replaces raw-value collection for percentile aggregation with fixed-size
mergeable state, the role TDigest plays in the reference
(PercentileTDigestAggregationFunction.java + ObjectSerDeUtils'
TDigest ser/de). State is a pair of parallel arrays (centroid means,
centroid weights) sorted by mean — deliberately NOT an object graph, so a
partial rides the DataTable wire as two flat lists and merging is
concatenate + compress.

Algorithm: the "merging digest" of Dunning & Ertl (public t-digest paper),
k1 scale function k(q) = δ/(2π)·asin(2q−1): centroid sizes taper toward the
tails, giving ~O(1/δ) relative rank error in the middle and much tighter
tails. Compression is a single sort + one greedy pass, numpy-friendly.

Error bound used by tests: rank error ≤ 1.5/δ for mid quantiles.
"""

from __future__ import annotations

import numpy as np

DEFAULT_COMPRESSION = 200


def _k(q: np.ndarray, delta: float) -> np.ndarray:
    return (delta / (2 * np.pi)) * np.arcsin(2 * np.clip(q, 0.0, 1.0) - 1)


def _k_inv(k: np.ndarray, delta: float) -> np.ndarray:
    return (np.sin(2 * np.pi * k / delta) + 1) / 2


def compress(means, weights, delta: float = DEFAULT_COMPRESSION):
    """Merge (means, weights) centroid soup into ≤ ~2δ centroids respecting
    the k1 size bound. Input need not be sorted; output is sorted by mean."""
    m = np.asarray(means, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if len(m) == 0:
        return m, w
    order = np.argsort(m, kind="stable")
    m, w = m[order], w[order]
    total = w.sum()
    out_m: list = []
    out_w: list = []
    cum = 0.0                      # weight already flushed
    acc_mw = m[0] * w[0]           # weighted-mean accumulator
    acc_w = w[0]
    q_limit = float(_k_inv(_k(np.float64(0.0), delta) + 1.0, delta))
    for i in range(1, len(m)):
        if (cum + acc_w + w[i]) / total <= q_limit:
            acc_mw += m[i] * w[i]
            acc_w += w[i]
        else:
            out_m.append(acc_mw / acc_w)
            out_w.append(acc_w)
            cum += acc_w
            q_limit = float(_k_inv(_k(np.float64(cum / total), delta) + 1.0, delta))
            acc_mw = m[i] * w[i]
            acc_w = w[i]
    out_m.append(acc_mw / acc_w)
    out_w.append(acc_w)
    return np.asarray(out_m), np.asarray(out_w)


def add_values(means, weights, values, delta: float = DEFAULT_COMPRESSION):
    """Fold raw values (unit weight) into a digest."""
    v = np.asarray(values, dtype=np.float64)
    v = v[~np.isnan(v)]
    if len(v) == 0:
        return np.asarray(means, dtype=np.float64), np.asarray(weights, dtype=np.float64)
    m = np.concatenate([np.asarray(means, dtype=np.float64), v])
    w = np.concatenate([np.asarray(weights, dtype=np.float64), np.ones(len(v))])
    return compress(m, w, delta)


def merge(m1, w1, m2, w2, delta: float = DEFAULT_COMPRESSION):
    """Merge two digests (the scatter_merge algebra)."""
    m = np.concatenate([np.asarray(m1, dtype=np.float64),
                        np.asarray(m2, dtype=np.float64)])
    w = np.concatenate([np.asarray(w1, dtype=np.float64),
                        np.asarray(w2, dtype=np.float64)])
    if len(m) == 0:
        return m, w
    return compress(m, w, delta)


def quantile(means, weights, q: float) -> float:
    """Estimate the q-quantile (q in [0,1]) by interpolating between
    centroid centers (standard t-digest quantile estimation)."""
    m = np.asarray(means, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if len(m) == 0:
        return float("nan")
    if len(m) == 1:
        return float(m[0])
    total = w.sum()
    target = np.clip(q, 0.0, 1.0) * total
    # centroid "centers" in cumulative-weight space
    cum = np.cumsum(w)
    centers = cum - w / 2
    if target <= centers[0]:
        return float(m[0])
    if target >= centers[-1]:
        return float(m[-1])
    j = int(np.searchsorted(centers, target, side="right"))
    c0, c1 = centers[j - 1], centers[j]
    t = 0.0 if c1 == c0 else (target - c0) / (c1 - c0)
    return float(m[j - 1] + t * (m[j] - m[j - 1]))


# ---- binary ser/de (ObjectSerDeUtils TDigest blob role) -------------------
# Layout: uint32 centroid count, then count f64 means, then count f64
# weights, all little-endian. Trailing padding bytes (fixed-width BYTES
# column storage) are ignored thanks to the count header.


def digest_to_bytes(means, weights) -> bytes:
    m = np.asarray(means, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    head = np.asarray([len(m)], dtype=np.uint32)
    return head.tobytes() + m.tobytes() + w.tobytes()


def digest_from_bytes(blob) -> tuple:
    b = bytes(blob)
    if len(b) < 4:
        return np.empty(0), np.empty(0)
    n = int(np.frombuffer(b[:4], dtype=np.uint32)[0])
    m = np.frombuffer(b[4: 4 + 8 * n], dtype=np.float64)
    w = np.frombuffer(b[4 + 8 * n: 4 + 16 * n], dtype=np.float64)
    return m.copy(), w.copy()
