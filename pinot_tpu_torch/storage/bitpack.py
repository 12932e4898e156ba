"""Bit-packed dictionary-id codec for ``<col>.fwdpacked.bin``.

The same byte format as the reference package's native packer: every id
takes ``bits`` bits, values follow each other in one little-endian
bitstream, and the last byte is zero-padded. Vectorized numpy only, so the
port needs no host toolchain to read or write packed segments.
"""

from __future__ import annotations

import numpy as np


def bits_needed(cardinality: int) -> int:
    """Bits per dict id (>= 1), PinotDataBitSet.getNumBitsPerValue analog."""
    if cardinality <= 1:
        return 1
    return int(cardinality - 1).bit_length()


def packed_size(n: int, bits: int) -> int:
    return (n * bits + 7) // 8


def pack(ids: np.ndarray, bits: int) -> np.ndarray:
    """int32 dict ids -> packed uint8 buffer (little-endian bit order)."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n = len(ids)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    shifts = np.arange(bits, dtype=np.uint32)
    bitmat = ((ids.astype(np.uint32)[:, None] >> shifts) & 1).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def unpack(buf: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Packed uint8 buffer -> (n,) int32 dict ids."""
    if n == 0:
        return np.empty(0, dtype=np.int32)
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    stream = np.unpackbits(buf, bitorder="little")[: n * bits]
    bitmat = stream.reshape(n, bits).astype(np.uint32)
    shifts = np.arange(bits, dtype=np.uint32)
    return (bitmat << shifts).sum(axis=1, dtype=np.uint32).astype(np.int32)
