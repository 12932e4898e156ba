"""Host helpers the reduce and the parameter build share: SQL LIKE to
regex, multi-column factorization and the stable ORDER BY lexsort.

The reference package's host.py is its complete host executor; the port
runs every query on the device, so it keeps only these helpers (copied,
not imported: the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re

import numpy as np


def like_to_regex(pattern: str) -> str:
    """SQL LIKE → anchored regex (reference: RegexpPatternConverterUtils)."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def factorize_multi(cols: list) -> tuple:
    """(unique_key_arrays, group_idx) for multi-column group keys.

    Pairwise chained np.unique keeps combined codes < n_rows * card so no
    int64 overflow — the host stand-in for the reference's 4-regime
    DictionaryBasedGroupKeyGenerator.
    """
    if not cols:
        raise ValueError("no group-by columns")
    uniqs = []
    codes = []
    for col in cols:
        u, inv = np.unique(np.asarray(col), return_inverse=True)
        uniqs.append(u)
        codes.append(inv.astype(np.int64))
    combined = codes[0]
    for c, u in zip(codes[1:], uniqs[1:]):
        combined = combined * len(u) + c
        _, combined = np.unique(combined, return_inverse=True)
    # group keys decode from the first row of each group
    _, first_rows, ginv = np.unique(
        combined, return_index=True, return_inverse=True
    )
    keys = tuple(np.asarray(c)[first_rows] for c in cols)
    return keys, ginv


def _order_indices(keys: list) -> np.ndarray:
    """Stable lexicographic ordering over (values, ascending) keys; string
    keys order via factorized codes (sorted-unique rank == value order)."""
    sort_cols = []
    for vals, asc in keys:
        v = np.asarray(vals)
        if v.dtype.kind in ("U", "S", "O"):
            u, inv = np.unique(v, return_inverse=True)
            v = inv.astype(np.int64)
        if not asc:
            v = _negate(v)
        sort_cols.append(v)
    # np.lexsort: last key is primary
    return np.lexsort(list(reversed(sort_cols)))


def _negate(v: np.ndarray) -> np.ndarray:
    if v.dtype.kind == "b":
        return ~v
    return -v.astype(np.float64) if v.dtype.kind == "f" else -v.astype(np.int64)
