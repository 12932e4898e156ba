"""Bloom filters for host-side segment pruning.

Equivalent of the reference's guava-format bloom readers
(pinot-segment-local/.../readers/bloom/) used by
``ColumnValueSegmentPruner``: answers "might this segment contain value v?"
for EQ/IN predicates before any device work is scheduled.

Layout: uint64 bitset array; k derived from a fixed 1% target FPP. Hashing is
double-hashing over FNV-1a/FNV-1 of the value's utf-8/bytes form (we need
determinism across processes, not guava compatibility).
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _value_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, float) and float(v).is_integer():
        v = int(v)
    return str(v).encode("utf-8")


def _positions(v, m_bits: int, k: int) -> list[int]:
    b = _value_bytes(v)
    h1 = _fnv1a(b)
    h2 = _fnv1a(b + b"\x01") | 1
    return [((h1 + i * h2) & _MASK64) % m_bits for i in range(k)]


class BloomFilter:
    K = 7  # ~1% fpp at 10 bits/element

    def __init__(self, bits: np.ndarray):
        self._bits = bits  # uint64 words; word 0 is reserved for m_bits
        self.m_bits = int(bits[0])

    @classmethod
    def build(cls, values, bits_per_element: int = 10) -> "BloomFilter":
        n = max(1, len(values))
        m_bits = max(64, n * bits_per_element)
        words = np.zeros(1 + (m_bits + 63) // 64, dtype=np.uint64)
        words[0] = m_bits
        for v in values:
            for pos in _positions(v, m_bits, cls.K):
                words[1 + pos // 64] |= np.uint64(1 << (pos % 64))
        return cls(words)

    def might_contain(self, v) -> bool:
        for pos in _positions(v, self.m_bits, self.K):
            if not (int(self._bits[1 + pos // 64]) >> (pos % 64)) & 1:
                return False
        return True

    def save(self, path: str) -> None:
        np.save(path, self._bits, allow_pickle=False)

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        return cls(np.load(path, allow_pickle=False))


def build_bloom(raw_values, dict_values, out_path: str) -> None:
    """Build from raw values or (deduped) dictionary values."""
    values = dict_values if dict_values is not None else np.unique(np.asarray(raw_values))
    BloomFilter.build(list(values)).save(out_path)
