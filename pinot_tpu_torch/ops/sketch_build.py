"""Sketch and digest builds over the matched rows of a batch, as torch ops.

The JAX package builds these states on its host, one segment at a time
(its engine/aggspec.py ``host_groups``). Here the rows of the whole
(S, L) batch are ordered once on the card by a run key, ``segment * G +
group``, and each run becomes the state the host builds for that
(segment, group):

- ``sorted_runs``: the rows sorted by (run, value), ties in row order,
  and each run's length: the t-digest's sorted values (ops/digest.py);
- ``value_runs``: the distinct values of each run, each with its count,
  its first row and that row's value: MODE's counts, IDSET's and
  DISTINCTCOUNTSMARTHLL's sets, in the order the host meets them;
- ``kmv``: each run's k smallest distinct hashes and the (k+1)-th, its
  theta: the theta sketch's build (ops/theta.py ``build``);
- ``hash32_values`` / ``hash63``: the canonical value hashes
  (ops/hll.py ``hash32_np``, ops/theta.py ``hash63``) at a value's dtype.

Row positions are flat, ``segment * L + doc``, ascending: the order the
host meets rows in. Composite keys sort as stable passes, least
significant first (ops/device_reduce.py ``lexsort_perm``): a float64's
order key alone takes all 64 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.ops.device_reduce import lexsort_perm
from pinot_tpu_torch.ops.hll import hash32

_MASK32 = 0xFFFFFFFF
_MASK62 = (1 << 62) - 1
_GOLDEN = 0x9E3779B9


def hash32_values(t: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """``hash32_np`` of numeric values held at the numpy dtype ``dtype``,
    as an int64 tensor in [0, 2^32): 8-byte values fold their halves,
    4-byte values hash their bits, narrower ones their value cast to
    uint32 (sign-extended, as numpy casts)."""
    dt = np.dtype(dtype)
    if dt.itemsize == 8:
        bits = t.view(torch.int64) if t.dtype == torch.float64 \
            else t.to(torch.int64)
        pre = (bits >> 32) ^ bits
    elif dt.itemsize == 4 and dt.kind == "f":
        pre = t.to(torch.float32).view(torch.int32).to(torch.int64)
    else:
        pre = t.to(torch.int64)
    return hash32(pre & _MASK32)


def hash63(h1: torch.Tensor) -> torch.Tensor:
    """ops/theta.py ``hash63`` from the 32-bit hashes ``h1`` (int64 in
    [0, 2^32)): int64 hashes in [0, 2^62)."""
    h2 = hash32(h1 ^ _GOLDEN)
    return ((h1 << 31) ^ h2) & _MASK62


def _run_starts(*keys) -> torch.Tensor:
    """Where a sorted vector of key tuples starts a new tuple."""
    new = torch.zeros_like(keys[0], dtype=torch.bool)
    new[:1] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def sorted_runs(rk: torch.Tensor, values: torch.Tensor) -> tuple:
    """(sorted values, run keys, run lengths): ``values`` (float64, no NaN)
    sorted by (run key ``rk``, value), ties in the given order (zeros of
    both signs are one value, as numpy's stable sort keeps them), with
    the distinct run keys ascending and their lengths."""
    perm = lexsort_perm([rk, values])
    runs, lengths = torch.unique_consecutive(rk[perm], return_counts=True)
    return values[perm].contiguous(), runs, lengths


def value_runs(rk: torch.Tensor, vkey: torch.Tensor,
               idx: torch.Tensor) -> tuple:
    """The distinct (run, value key) pairs of rows in flat order ``idx``:
    (run key, count, first row) of each, ascending by (run, value key).
    ``vkey``: int64 keys equal where the host's dict or set keys are equal
    (NaN rows keyed apart)."""
    perm = lexsort_perm([rk, vkey])
    srk, svk = rk[perm], vkey[perm]
    starts = torch.nonzero(_run_starts(srk, svk)).reshape(-1)
    counts = torch.diff(starts, append=starts.new_tensor([srk.numel()]))
    return srk[starts], counts, idx[perm][starts]


def kmv(rk: torch.Tensor, h: torch.Tensor, k: int) -> tuple:
    """Per run key, the ``k`` smallest distinct hashes and the (k+1)-th
    (theta) of runs that have more: (run keys, hashes) of the retained
    pairs ascending, and (run keys, thetas)."""
    perm = lexsort_perm([rk, h])
    srk, sh = rk[perm], h[perm]
    new = _run_starts(srk, sh)
    srk, sh = srk[new], sh[new]
    first = _run_starts(srk)
    pos = torch.arange(srk.numel(), device=srk.device)
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    keep, at_k = rank < k, rank == k
    return srk[keep], sh[keep], srk[at_k], sh[at_k]
