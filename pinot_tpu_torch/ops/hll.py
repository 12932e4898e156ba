"""HyperLogLog, host half: the canonical value hash, register builds and
the cardinality estimate, in numpy.

The reference package's device register builds (hash, index/rho split,
scatter-max and the register kernels) come with the port's HLL slice;
until then a DISTINCTCOUNTHLL query on the port's device path raises
DeviceUnsupported. This module keeps what aggregation specs and their host
finalize need. Hashing: 32-bit murmur3 finalizer (avalanche) over int32
keys, murmur3_32 over UTF-8 bytes for strings.
"""

from __future__ import annotations

import numpy as np

DEFAULT_LOG2M = 10  # reference default is log2m=8 (DistinctCountHLL...); we
# default finer (±3.2% vs ±6.5%), the same default as the JAX package so
# register partials of both stay comparable


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Canonical murmur3_32 over bytes — deterministic across processes and
    restarts, unlike builtin ``hash()`` (PYTHONHASHSEED-salted), so HLL
    register partials for string columns built on different servers merge to
    the union, not the sum. Matches the reference's murmur-based hashing of
    raw values (clearspring HyperLogLog via DistinctCountHLLAggregationFunction)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash32_np(values: np.ndarray) -> np.ndarray:
    """Host-side canonical hash, bit-identical to :func:`hash32` so host and
    device HLL partials merge consistently. 64-bit inputs fold hi^lo;
    strings/bytes hash via deterministic murmur3_32 over UTF-8 bytes
    (hashed once per unique value, mapped back through the inverse index)."""
    v = np.asarray(values)
    if v.dtype.kind in ("U", "S", "O"):
        uniq, inv = np.unique(v, return_inverse=True)
        uh = np.array(
            [
                murmur3_32(x.encode("utf-8") if isinstance(x, str) else bytes(x))
                for x in uniq.tolist()
            ],
            dtype=np.uint32,
        )
        h = uh[inv.reshape(v.shape)]
    elif v.dtype.itemsize == 8:
        bits = v.view(np.uint64)
        h = ((bits >> np.uint64(32)) ^ (bits & np.uint64(0xFFFFFFFF))).astype(np.uint32)
    elif v.dtype.itemsize == 4:
        h = v.view(np.uint32)
    else:
        h = v.astype(np.uint32)
    h = h.copy()
    h ^= h >> 16
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> 13
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> 16
    return h


def registers_np(values: np.ndarray, group_idx: np.ndarray, n_groups: int,
                 log2m: int = DEFAULT_LOG2M) -> np.ndarray:
    """Host-side register build over raw values (canonical form)."""
    m = 1 << log2m
    h = hash32_np(values)
    idx = (h >> np.uint32(32 - log2m)).astype(np.int64)
    w = ((h.astype(np.uint64) << np.uint64(log2m)) | np.uint64(1 << (log2m - 1))) \
        & np.uint64(0xFFFFFFFF)
    w = np.maximum(w, 1)
    rho = (32 - np.floor(np.log2(w.astype(np.float64))).astype(np.int32)).astype(np.int32)
    regs = np.zeros((n_groups, m), dtype=np.int32)
    np.maximum.at(regs, (np.asarray(group_idx), idx), rho)
    return regs


def _alpha(m: int) -> float:
    if m >= 128:
        return 0.7213 / (1 + 1.079 / m)
    if m == 64:
        return 0.709
    if m == 32:
        return 0.697
    return 0.673


def estimate_batch_np(regs2d: np.ndarray) -> np.ndarray:
    """Vectorized host estimate over (G, m) register planes → (G,) int64.

    Must produce bit-identical results to ``estimate`` per row: the device
    finalize path and the host finalize path both route through this
    math, and oracle tests compare them."""
    regs = np.asarray(regs2d, dtype=np.float64)
    G, m = regs.shape
    raw = _alpha(m) * m * m / np.sum(np.exp2(-regs), axis=1)
    zeros = np.sum(regs2d == 0, axis=1)
    small = (raw <= 2.5 * m) & (zeros > 0)
    lin = m * np.log(m / np.maximum(zeros, 1))
    big = raw > (1 << 32) / 30.0
    large = -float(1 << 32) * np.log(1.0 - raw / float(1 << 32))
    est = np.where(small, lin, np.where(big, large, raw))
    return np.round(est).astype(np.int64)


def estimate(registers: np.ndarray) -> int:
    """Host-side cardinality estimate (standard HLL with corrections) —
    one row of the batch form, so the correction math lives in exactly one
    np implementation."""
    return int(estimate_batch_np(np.asarray(registers)[None, :])[0])
