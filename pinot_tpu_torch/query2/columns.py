"""The multi-stage engine's columns: one tensor a column on the card.

The reference carries its stage-1 row sets and joined rows as numpy
arrays on its host (pinot_tpu/query2/runner.py). Here a column is a
``Col``: numbers as a tensor at the host path's numpy dtype, strings as
int64 codes into their sorted distinct values, held on the host once per
distinct value. Code order is value order (numpy orders strings by code
point, as ``np.unique`` sorts them), so a string column's keys, ranks and
equality are its codes. Columns of different dictionaries meet in one
dictionary (``unify``) before they are compared or concatenated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pinot_tpu_torch.engine.params import to_device
from pinot_tpu_torch.ops.device_reduce import order_key

_STRING_KINDS = ("U", "S", "O")


@dataclasses.dataclass
class Col:
    """``t``: (n,) values at ``dtype``, or int64 codes into ``strings``
    (sorted, distinct) for a string column; a 0-d ``t`` is a literal,
    broadcast where it is used."""

    t: torch.Tensor
    dtype: np.dtype
    strings: np.ndarray | None = None

    @property
    def is_str(self) -> bool:
        return self.strings is not None

    def take(self, idx: torch.Tensor) -> "Col":
        t = self.t if self.t.dim() == 0 else self.t[idx]
        return Col(t, self.dtype, self.strings)

    def rows(self, n: int) -> "Col":
        """This column over ``n`` rows (a literal broadcast)."""
        if self.t.dim() == 0:
            return Col(self.t.expand(n).contiguous(), self.dtype,
                       self.strings)
        return self

    def key(self) -> torch.Tensor:
        """int64 keys whose equality and order are numpy's over the
        values (floats: -0.0 equals 0.0, one NaN, last)."""
        return self.t.to(torch.int64) if self.is_str else order_key(self.t)

    def to(self, device) -> "Col":
        return Col(self.t.to(device), self.dtype, self.strings)

    def host(self) -> np.ndarray:
        """The values on the host, at their numpy dtype."""
        a = self.t.cpu().numpy()
        if self.is_str:
            return self.strings[a.astype(np.int64)] if a.size \
                else np.zeros(a.shape, dtype=self.strings.dtype)
        return a.astype(self.dtype, copy=False)

    @property
    def nbytes(self) -> int:
        return self.t.numel() * self.t.element_size()


_AMBIGUOUS = ("The truth value of an array with more than one element is "
              "ambiguous. Use a.any() or a.all()")


@dataclasses.dataclass
class MVCol:
    """A multi-value column's rows, ragged: row ``r`` holds the entries
    ``vals[starts[r]: starts[r] + lens[r]]`` (``vals`` a ``Col`` of every
    entry), ``lens`` -1 on a LEFT join's miss, which reads as "" as the
    reference fills an object column. A take moves the offsets, never the
    entries. Where the joined rows are read as values (a key, a
    comparison, an operand), the column is its single entries when every
    row has one, as numpy reads such an object array; otherwise the
    reference's numpy fails, and so does this (ValueError)."""

    vals: Col
    starts: torch.Tensor
    lens: torch.Tensor

    @property
    def dtype(self) -> np.dtype:
        return self.vals.dtype

    @property
    def strings(self):
        return self.vals.strings

    @property
    def is_str(self) -> bool:
        return self.vals.is_str

    def take(self, idx: torch.Tensor) -> "MVCol":
        return MVCol(self.vals, self.starts[idx], self.lens[idx])

    def rows(self, n: int) -> "MVCol":
        return self

    def to(self, device) -> "MVCol":
        return MVCol(self.vals.to(device), self.starts.to(device),
                     self.lens.to(device))

    def single(self) -> Col:
        """The rows' entries where every row holds one."""
        if bool((self.lens != 1).any()):
            raise ValueError(_AMBIGUOUS)
        return self.vals.take(self.starts)

    @property
    def t(self) -> torch.Tensor:
        return self.single().t

    def key(self) -> torch.Tensor:
        return self.single().key()

    def host(self) -> np.ndarray:
        """Each row's entries as a numpy array (the reference's object
        array of per-doc arrays); "" on a LEFT join's miss."""
        lens = self.lens.cpu().numpy().astype(np.int64)
        starts = self.starts.cpu().numpy().astype(np.int64)
        n = len(lens)
        out = np.empty(n, dtype=object)
        if not n:
            return out
        lo, hi = int(starts.min()), int((starts + np.maximum(lens, 0)).max())
        flat = self.vals.take(torch.arange(
            lo, max(hi, lo), device=self.vals.t.device)).host() \
            if hi > lo else np.zeros(0, dtype=self.dtype)
        for r in range(n):
            if lens[r] < 0:
                out[r] = ""
                continue
            s = starts[r] - lo
            seg = flat[s: s + lens[r]]
            out[r] = seg.copy()
        return out

    @property
    def nbytes(self) -> int:
        return self.vals.nbytes + 2 * self.lens.numel() * 8


def literal(value, device) -> Col:
    a = np.asarray(value)
    if a.dtype.kind in "biuf":
        return Col(torch.tensor(a, device=device), a.dtype)
    return Col(torch.zeros((), dtype=torch.int64, device=device), a.dtype,
               a.reshape(1))


def of_strings(codes: torch.Tensor, values: np.ndarray) -> Col:
    """A string column of ids ``codes`` into ``values`` (any order, with
    repeats): recoded into the sorted distinct values."""
    values = np.asarray(values)
    u, inv = np.unique(values, return_inverse=True)
    lut = to_device(inv.reshape(-1).astype(np.int64), codes.device)
    t = lut[codes.to(torch.int64)] if len(values) \
        else codes.to(torch.int64)
    return Col(t, u.dtype, u)


def recode(c: Col, strings: np.ndarray) -> Col:
    """String column ``c`` over the superset dictionary ``strings``."""
    if c.strings is strings or (len(c.strings) == len(strings)
                                and np.array_equal(c.strings, strings)):
        return Col(c.t, strings.dtype, strings)
    lut = to_device(np.searchsorted(strings, c.strings).astype(np.int64),
                    c.t.device)
    t = lut[c.t] if len(c.strings) else c.t
    return Col(t, strings.dtype, strings)


def unify(cols: list) -> list:
    """String columns over one dictionary, number columns at numpy's
    promoted dtype (``np.concatenate``'s). A mix of the two raises."""
    strs = [c.is_str for c in cols]
    if any(strs) and not all(strs):
        raise TypeError("string and numeric values in one column")
    if all(strs):
        u = np.unique(np.concatenate([c.strings for c in cols]))
        return [recode(c, u) for c in cols]
    dt = np.result_type(*[c.dtype for c in cols])
    tdt = torch.from_numpy(np.zeros(0, dtype=dt)).dtype
    return [Col(c.t.to(tdt), dt) for c in cols]


def concat(cols: list, device):
    """The rows of ``cols`` one after another."""
    if cols and any(isinstance(c, MVCol) for c in cols):
        return concat_mv(cols, device)
    if not cols:
        return Col(torch.zeros(0, dtype=torch.float64, device=device),
                   np.dtype(np.float64))
    cols = unify(cols)
    return Col(torch.cat([c.t.reshape(-1) for c in cols]), cols[0].dtype,
               cols[0].strings)


def concat_mv(cols: list, device) -> MVCol:
    """MV columns' rows one after another, their entries in one ``Col``."""
    if not all(isinstance(c, MVCol) for c in cols):
        raise ValueError(_AMBIGUOUS)
    vals = concat([c.vals for c in cols], device)
    starts, at = [], 0
    for c in cols:
        starts.append(c.starts + at)
        at += c.vals.t.numel()
    return MVCol(vals, torch.cat(starts), torch.cat([c.lens for c in cols]))


def with_default(c: Col) -> tuple:
    """(``c`` over a dictionary holding "", the fill a LEFT join's misses
    take): the column TYPE's default, "" or 0, as a 0-d tensor; an MV
    column's miss is the object column's "" (``MVCol`` lens -1)."""
    if isinstance(c, MVCol):
        return c, None
    if not c.is_str:
        return c, torch.zeros((), dtype=c.t.dtype, device=c.t.device)
    if c.strings.dtype.kind == "O":
        empty = np.asarray([""], dtype=object)
    else:
        empty = np.zeros(1, dtype=c.strings.dtype)
    u = np.unique(np.concatenate([c.strings, empty]))
    c = recode(c, u)
    code = int(np.searchsorted(u, empty[0]))
    return c, torch.tensor(code, dtype=torch.int64, device=c.t.device)
