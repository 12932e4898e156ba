"""A consuming segment's rows as the sealed reader a BatchContext takes.

The reference answers a consuming (mutable) segment, its unfrozen tail
(realtime/chunklet.py ``MutableTailView``) and a mutable segment the
chunklet path does not split on its host, from the decoded values
(engine/host.py there). The port runs those parts on the card in the host
path's shape (engine/rows.py) over a ``BatchContext`` of their own, which
reads the sealed reader protocol: ``metadata.columns``,
``column_metadata``, ``forward``, ``dictionary``, ``mv_offsets``,
``null_vector``.

``SnapshotSegment`` gives a part that protocol over the docs [0, n) it
publishes when it is made, read once (the single-writer contract: docs
below the published count never change):

- a string column (the mutable column's insertion-ordered dictionary,
  which is unsorted and so not a dictionary the batch may search) reads
  as a dict column of a SORTED dictionary of the snapshot's values, built
  here, as a chunklet's is at promotion;
- a numeric column reads raw, as the mutable segment stores it, with the
  snapshot's exact min / max;
- a multi-value column reads as flat entries with their offsets.

No index is claimed (no sorted, inverted, range or bloom), so every
predicate scans, as the reference's host scans a mutable segment. Columns
decode at first use and are held for the snapshot's life, which is one
launch.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from pinot_tpu_torch.storage.creator import _np_column
from pinot_tpu_torch.storage.dictionary import Dictionary
from pinot_tpu_torch.storage.segment import ColumnMetadata, Encoding


class _Columns(Mapping):
    """``metadata.columns``: the part's column names, each column's
    metadata built at first read."""

    def __init__(self, snap: "SnapshotSegment"):
        self._snap = snap

    def __getitem__(self, name):
        if name not in self._snap._names:
            raise KeyError(name)
        return self._snap._column(name)[0]

    def __iter__(self):
        return iter(self._snap._names)

    def __len__(self):
        return len(self._snap._names)


class _Metadata:
    def __init__(self, snap: "SnapshotSegment"):
        self.columns = _Columns(snap)
        self.n_docs = snap.n_docs
        self.segment_name = snap.name


class SnapshotSegment:
    """The docs [0, ``n_docs``) of a mutable segment or a tail view, read
    as a sealed segment (see the module docstring)."""

    is_mutable = False
    valid_docs_mask = None

    def __init__(self, part):
        self.part = part
        self.n_docs = int(part.n_docs)
        self.name = part.name
        self.dir = f"<snapshot:{part.dir}:{self.n_docs}>"
        host = getattr(part, "host_name", None)
        if host is not None:
            self.host_name = host
        self._names = list(part.column_names())
        self._cache: dict = {}
        self.metadata = _Metadata(self)

    def _column(self, name: str) -> tuple:
        """(ColumnMetadata, forward, Dictionary or None, offsets or None)."""
        if name not in self._cache:
            self._cache[name] = self._decode(name)
        return self._cache[name]

    def _decode(self, name: str) -> tuple:
        n = self.n_docs
        meta = self.part.column_metadata(name)
        dt = meta.data_type
        vals = np.asarray(self.part.values(name))[:n]
        nv = self.part.null_vector(name)
        has_nulls = nv is not None and bool(np.asarray(nv)[:n].any())
        offsets = None
        if not meta.single_value:
            lens = np.fromiter((len(r) for r in vals), dtype=np.int64,
                               count=len(vals))
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            parts = [np.asarray(r) for r in vals if len(r)]
            flat = np.concatenate(parts) if parts \
                else np.empty(0, dtype=dt.np_dtype)
            vals = flat
        if dt.is_string_like:
            vals = _np_column(vals, dt)
            uniq, inv = np.unique(vals, return_inverse=True)
            fwd, d = inv.astype(np.int32).reshape(-1), Dictionary(uniq)
            enc, card = Encoding.DICT, len(uniq)
            lo, hi = (uniq[0], uniq[-1]) if len(uniq) else (None, None)
        else:
            fwd = np.ascontiguousarray(vals.astype(dt.np_dtype, copy=False))
            d, enc, card = None, Encoding.RAW, -1
            lo = fwd.min().item() if len(fwd) else None
            hi = fwd.max().item() if len(fwd) else None
        max_mv = 1 if offsets is None else \
            int(np.diff(offsets).max(initial=0))
        cm = ColumnMetadata(
            name=name, data_type=dt, encoding=enc, cardinality=card,
            min_value=lo, max_value=hi, is_sorted=False,
            single_value=meta.single_value, max_mv_entries=max_mv,
            has_dictionary=d is not None, has_null_vector=has_nulls,
            total_number_of_entries=len(fwd))
        return cm, fwd, d, offsets

    # ---- the sealed reader protocol --------------------------------------
    def column_names(self) -> list:
        return list(self._names)

    def column_metadata(self, col: str) -> ColumnMetadata:
        return self._column(col)[0]

    def forward(self, col: str) -> np.ndarray:
        return self._column(col)[1]

    def dictionary(self, col: str):
        return self._column(col)[2]

    def mv_offsets(self, col: str):
        return self._column(col)[3]

    def null_vector(self, col: str):
        nv = self.part.null_vector(col)
        if nv is None:
            return None
        nv = np.asarray(nv)[: self.n_docs]
        return nv if nv.any() else None

    def bloom(self, col: str):
        return None

    def inverted(self, col: str):
        return None

    def range_index(self, col: str):
        return None

    def values(self, col: str) -> np.ndarray:
        return np.asarray(self.part.values(col))[: self.n_docs]
