"""Sorted value dictionaries.

Equivalent to the reference's immutable sorted dictionaries
(pinot-segment-local/.../readers/{Int,Long,Float,Double,String,Bytes}Dictionary.java):
values are stored sorted; ids are ranks; lookup is binary search. Vectorized
with numpy instead of per-call binary search — predicate evaluation resolves
whole literal sets at once, and range predicates become two ``searchsorted``
calls returning a dict-id interval (the trick behind the reference's
dictionary-based predicate evaluators,
pinot-core/.../operator/filter/predicate/).
"""

from __future__ import annotations

import numpy as np


class Dictionary:
    """Immutable sorted dictionary: id <-> value, id order == sort order."""

    def __init__(self, values: np.ndarray):
        # `values` must be sorted ascending and unique.
        self._values = values

    # ---- construction ---------------------------------------------------
    @classmethod
    def build(cls, raw: np.ndarray) -> tuple["Dictionary", np.ndarray]:
        """Build from a raw value column; returns (dictionary, dict_ids[int32]).

        One-pass equivalent of the reference's stats-collector + dictionary
        creator (SegmentDictionaryCreator).
        """
        values, inverse = np.unique(raw, return_inverse=True)
        return cls(values), inverse.astype(np.int32)

    # ---- accessors ------------------------------------------------------
    @property
    def values(self) -> np.ndarray:
        return self._values

    def __len__(self) -> int:
        return len(self._values)

    @property
    def cardinality(self) -> int:
        return len(self._values)

    def get(self, dict_id: int):
        return self._values[dict_id]

    def take(self, dict_ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> value (result materialization path)."""
        return self._values[dict_ids]

    # ---- predicate resolution (value -> id space) -----------------------
    def index_of(self, value) -> int:
        """Exact id of value, or -1 (reference: Dictionary.indexOf)."""
        i = int(np.searchsorted(self._values, value))
        if i < len(self._values) and self._values[i] == value:
            return i
        return -1

    def ids_of(self, values) -> np.ndarray:
        """Ids of the values present in the dictionary (for IN/EQ predicates).

        Values not representable in the dictionary's dtype (longer strings,
        non-integral floats against an int dictionary) are dropped, never
        truncated into false matches.
        """
        if len(self._values) == 0 or len(values) == 0:
            return np.empty(0, dtype=np.int32)
        vals = np.asarray(values)
        kind = self._values.dtype.kind
        if kind in ("U", "S"):
            vals = vals.astype(kind)  # natural width for the queried values
            if vals.dtype.itemsize > self._values.dtype.itemsize:
                unit = 4 if kind == "U" else 1
                max_len = self._values.dtype.itemsize // unit
                vals = vals[np.char.str_len(vals) <= max_len]
                if len(vals) == 0:
                    return np.empty(0, dtype=np.int32)
            cast = vals.astype(self._values.dtype)
        else:
            cast = vals.astype(self._values.dtype)
            exact = cast.astype(np.float64) == vals.astype(np.float64)
            cast = cast[exact]
            if len(cast) == 0:
                return np.empty(0, dtype=np.int32)
        idx = np.searchsorted(self._values, cast)
        idx_clipped = np.minimum(idx, len(self._values) - 1)
        hit = self._values[idx_clipped] == cast
        return idx_clipped[hit].astype(np.int32)

    def range_ids(self, lower, upper, lower_inclusive=True, upper_inclusive=True) -> tuple[int, int]:
        """Dict-id half-open interval [lo, hi) matching a value range.

        Mirrors RangePredicateEvaluatorFactory's dictionary-based evaluator:
        a value range on a sorted dictionary is a contiguous id range.
        """
        if lower is None:
            lo = 0
        else:
            side = "left" if lower_inclusive else "right"
            lo = int(np.searchsorted(self._values, lower, side=side))
        if upper is None:
            hi = len(self._values)
        else:
            side = "right" if upper_inclusive else "left"
            hi = int(np.searchsorted(self._values, upper, side=side))
        return lo, max(lo, hi)

    # ---- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        np.save(path, self._values, allow_pickle=False)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "Dictionary":
        arr = np.load(path, mmap_mode="r" if mmap else None, allow_pickle=False)
        return cls(arr)
