"""HyperLogLog: the canonical value hash, the register index/rank split,
register builds and the cardinality estimate — device half in torch,
host half in numpy.

Counterpart of pinot_tpu/ops/hll.py. Hashing: 32-bit murmur3 finalizer
(fmix32 avalanche) over int32 keys, murmur3_32 over UTF-8 bytes for
strings. The device path reads per-doc hashes gathered on the host at
upload (engine/params.py ``prehashed_column``, an int32 bit view of the
uint32 hash) and splits them here with ``hll_idx_rho``; the register
builds themselves are the K3 kernel (ops/kernels.py) behind
ops/group_scatter.py and ops/groupby_mm.py.

torch has no uint32 arithmetic to lean on and no count-leading-zeros, so
the device functions do their unsigned math in int64 (masking to 32
bits after every step) and take rho from the float64 exponent, which is
exact for integers below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_LOG2M = 10  # reference default is log2m=8 (DistinctCountHLL...); we
# default finer (±3.2% vs ±6.5%), the same default as the JAX package so
# register partials of both stay comparable

_MASK32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) without overflowing
    int64: the 16-bit halves of ``c`` keep every product below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash32(x):
    """fmix32 avalanche of int32 keys → int64 tensor of the uint32 hash,
    bit-identical to :func:`hash32_np` on the same int32 bits."""
    h = x.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hll_idx_rho(h, log2m: int):
    """(register index, rank) from 32-bit hashes — int32 bit views or
    int64 values in [0, 2^32), any shape; both results int32.

    idx = the top ``log2m`` bits; rho = clz32(w) + 1 with w = the low
    bits shifted up and a sentinel bit that caps rho at 33 - log2m. The
    hash widens to int64 and is masked first: an arithmetic shift of an
    int32 view of a hash >= 2^31 would smear its sign into the index.
    clz32(w) + 1 = 33 - e where w = f·2^e, f in [0.5, 1) (``frexp``),
    exact in float64 for every 32-bit w."""
    u = h.to(torch.int64) & _MASK32
    idx = (u >> (32 - log2m)).to(torch.int32)
    w = ((u << log2m) & _MASK32) | (1 << (log2m - 1))
    _, e = torch.frexp(w.to(torch.float64))
    return idx, (33 - e).to(torch.int32)


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


def estimate_torch(regs):
    """(G, m) integer registers → (G,) int64 estimates on the registers'
    device: the terminal-query finalize, so only answer-sized arrays
    leave the card. The same float64 math as ``estimate_batch_np``.

    Σ 2^-reg is exact in any summation order: every term is a power of
    two no smaller than 2^-(33 - log2m), and m = 2^log2m terms need at
    most 33 bits of mantissa. ``torch.log`` in the linear-counting and
    large-range branches is therefore the only libm call whose last bit
    could differ from numpy's or XLA's; every other step is exact or
    correctly rounded."""
    _G, m = regs.shape
    rf = regs.to(torch.float64)
    raw = _alpha(m) * m * m / torch.sum(torch.exp2(-rf), dim=1)
    zeros = torch.sum(regs == 0, dim=1)
    return _corrected(raw, zeros.to(torch.float64), m)


def estimate_from_sums_torch(sums, log2m: int):
    """(3, G) float64 scaled register sums → (G,) int64 estimates,
    bit-identical to ``estimate_torch`` over the dense register planes
    (engine/device.py ``_hll_sums_from_sorted`` builds the sums).

    sums rows:
      [0] count of registers with at least one row (zeros = m - s0)
      [1] Σ 2^(split - reg) over present registers with reg <= split
      [2] Σ 2^(rho_max - reg) over present registers with reg > split
    with split = rho_max // 2, rho_max = 33 - log2m. Every term is a
    power of two and each scaled sum stays below 2^24, so the channel
    sums are exact and the recombination below is the exact Σ 2^-reg."""
    m = 1 << log2m
    rho_max = 33 - log2m
    split = rho_max // 2
    zeros = m - sums[0]
    denom = zeros + sums[1] * (2.0 ** -split) + sums[2] * (2.0 ** -rho_max)
    raw = _alpha(m) * m * m / denom
    return _corrected(raw, zeros, m)


def _corrected(raw, zeros, m: int):
    """The small- and large-range corrections and the final round, over
    float64 tensors (``zeros`` as float64)."""
    small = (raw <= 2.5 * m) & (zeros > 0)
    lin = m * torch.log(m / torch.clamp(zeros, min=1.0))
    big = raw > (1 << 32) / 30.0
    large = -float(1 << 32) * torch.log(1.0 - raw / float(1 << 32))
    est = torch.where(small, lin, torch.where(big, large, raw))
    return torch.round(est).to(torch.int64)


def estimate(registers: np.ndarray) -> int:
    """Host-side cardinality estimate (standard HLL with corrections) —
    one row of the batch form, so the correction math lives in exactly one
    np implementation."""
    return int(estimate_batch_np(np.asarray(registers)[None, :])[0])
