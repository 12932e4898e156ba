"""Partition functions for ingest-time column partitioning.

Equivalent of pinot-segment-spi/.../partition/ (Murmur/Modulo/HashCode/
ByteArray partition functions): maps column values -> partition id so the
broker can prune segments for ``col = literal`` queries
(SinglePartitionColumnSegmentPruner.java). Vectorized over numpy arrays.
"""

from __future__ import annotations

import numpy as np


def _to_bytes_rows(values: np.ndarray) -> list[bytes]:
    out = []
    for v in values:
        if isinstance(v, bytes):
            out.append(v)
        else:
            out.append(str(v).encode("utf-8"))
    return out


def murmur2_32(data: bytes, seed: int = 0x9747B28C) -> int:
    """Murmur2 32-bit, matching kafka/pinot's MurmurPartitionFunction behavior
    closely enough for internal consistency (we only require determinism)."""
    m = 0x5BD1E995
    r = 24
    length = len(data)
    h = (seed ^ length) & 0xFFFFFFFF
    i = 0
    while length - i >= 4:
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * m) & 0xFFFFFFFF
        k ^= k >> r
        k = (k * m) & 0xFFFFFFFF
        h = (h * m) & 0xFFFFFFFF
        h ^= k
        i += 4
    rem = length - i
    if rem >= 3:
        h ^= data[i + 2] << 16
    if rem >= 2:
        h ^= data[i + 1] << 8
    if rem >= 1:
        h ^= data[i]
        h = (h * m) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * m) & 0xFFFFFFFF
    h ^= h >> 15
    return h


def partition_ids(values: np.ndarray, function: str, num_partitions: int) -> np.ndarray:
    """Vectorized value -> partition id."""
    fn = function.lower()
    if fn == "modulo":
        return (np.asarray(values).astype(np.int64) % num_partitions).astype(np.int32)
    if fn in ("murmur", "murmur2"):
        return np.array(
            [murmur2_32(b) % num_partitions for b in _to_bytes_rows(values)], dtype=np.int32
        )
    if fn == "hashcode":
        # Java String.hashCode analog on utf-8 text
        out = np.empty(len(values), dtype=np.int64)
        for i, b in enumerate(_to_bytes_rows(values)):
            h = 0
            for c in b.decode("utf-8", "replace"):
                h = (31 * h + ord(c)) & 0xFFFFFFFF
            out[i] = h if h < 2**31 else h - 2**32
        return (np.abs(out) % num_partitions).astype(np.int32)
    raise ValueError(f"unknown partition function {function!r}")


def partition_of_value(value, function: str, num_partitions: int) -> int:
    return int(partition_ids(np.array([value], dtype=object), function, num_partitions)[0])
