"""Mutable (consuming) segment: row-at-a-time indexing, immediately queryable.

Equivalent of the reference's ``MutableSegmentImpl``
(pinot-segment-local/.../indexsegment/mutable/MutableSegmentImpl.java):
single-writer / multi-reader via a volatile doc counter — readers snapshot
``n_docs`` once and never see a partially-written row. Strings are
dict-encoded with an *insertion-ordered* mutable dictionary (ids are arrival
ranks, not sort ranks — same as the reference's mutable dictionaries), so
consuming segments execute in the host path's shape; sealing re-encodes into
sorted dictionaries via the immutable segment creator
(realtime/converter: RealtimeSegmentConverter.java analog).

A copy of pinot_tpu/storage/mutable.py for the port: a consuming segment
runs in the host path's shape on the card (engine/snapshot.py reads it
as a sealed segment), its promoted chunklets in a device batch, and
``seal`` writes through the port's creator (a sealed directory loads in
either package).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from pinot_tpu_torch.common.datatypes import DataType, FieldRole
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.storage.segment import ColumnMetadata, Encoding, SegmentMetadata

_INITIAL_CAPACITY = 4096


class MutableColumn:
    def __init__(self, spec):
        self.spec = spec
        self.single_value = spec.single_value
        self.dict_encoded = spec.data_type.is_string_like and spec.single_value
        if not spec.single_value:
            # MV: per-row value arrays in a grow-only list (the host path's shape;
            # sealing re-encodes through the creator's flatten+offsets pass)
            self._rows: list = []
            self.total_entries = 0
        elif self.dict_encoded:
            self._dict: dict = {}
            self._dict_values: list = []
            self._data = np.empty(_INITIAL_CAPACITY, dtype=np.int32)
        else:
            self._data = np.empty(_INITIAL_CAPACITY, dtype=spec.data_type.np_dtype)
        self.min_value = None
        self.max_value = None
        self.null_docs: list = []  # grow-only; readers slice to snapshot n

    def _grow(self, n: int) -> None:
        if n >= len(self._data):
            new = np.empty(max(len(self._data) * 2, n + 1), dtype=self._data.dtype)
            new[: len(self._data)] = self._data
            self._data = new

    def _track(self, v) -> None:
        if self.min_value is None or v < self.min_value:
            self.min_value = v
        if self.max_value is None or v > self.max_value:
            self.max_value = v

    def _mv_row(self, value) -> np.ndarray:
        dt = self.spec.data_type
        entries = value if isinstance(value, (list, tuple, np.ndarray)) \
            else [value]
        if dt.is_string_like:
            return np.asarray([str(v) for v in entries], dtype=np.str_)
        return np.asarray([dt.convert(v) for v in entries], dtype=dt.np_dtype)

    def _append_mv_row(self, row: np.ndarray) -> None:
        self._rows.append(row)
        self.total_entries += len(row)
        for v in row.tolist():
            self._track(v)

    def append(self, value, row_idx: int) -> None:
        if not self.single_value:
            self._append_mv_row(self._mv_row(value))
            return
        self._grow(row_idx)
        if self.dict_encoded:
            v = str(value) if self.spec.data_type is not DataType.BYTES else bytes(value)
            did = self._dict.get(v)
            if did is None:
                did = len(self._dict_values)
                self._dict[v] = did
                self._dict_values.append(v)
            self._data[row_idx] = did
        else:
            v = self.spec.data_type.convert(value)
            self._data[row_idx] = v
        self._track(v)

    # ---- columnar batch path (chunklet subsystem ingest basis) -----------
    def prepare_batch(self, vals: list):
        """Stage a batch WITHOUT mutating column state: all conversion and
        validation (the failure-prone part) happens here, so one bad row
        can never leave partial appends behind — ``commit_batch`` only
        publishes already-validated arrays."""
        try:  # C-level membership scan; nulls are the rare case
            has_null = None in vals
        except ValueError:
            # `in` compares elementwise against ndarray payloads (MV rows);
            # fall back to the identity scan the row path implies
            has_null = any(v is None for v in vals)
        if has_null:
            null_rows = [i for i, v in enumerate(vals) if v is None]
            vals = list(vals)
            fill = [] if not self.single_value else self.spec.null_value()
            for i in null_rows:
                vals[i] = fill
        else:
            null_rows = ()
        if not self.single_value:
            return ("mv", null_rows, [self._mv_row(v) for v in vals])
        dt = self.spec.data_type
        if self.dict_encoded:
            # vectorized dictionary growth: one np.unique over the batch,
            # then ONE dict probe per distinct value instead of per row.
            # Strings sort as a native U array (faster comparator); BYTES
            # stay object-typed — an 'S' array would strip trailing NULs.
            if dt is DataType.BYTES:
                arr = np.asarray([bytes(v) for v in vals], dtype=object)
            else:
                arr = np.asarray(vals)
                if arr.dtype.kind != "U":  # non-str payloads: coerce per value
                    arr = np.asarray([str(v) for v in vals])
            uniq, inv = np.unique(arr, return_inverse=True)
            return ("dict", null_rows, uniq, inv.astype(np.int32))
        try:
            arr = np.asarray(vals, dtype=dt.np_dtype)
        except (TypeError, ValueError):
            # heterogenous payloads (e.g. numeric strings): per-value coerce
            arr = np.asarray([dt.convert(v) for v in vals], dtype=dt.np_dtype)
        return ("raw", null_rows, arr)

    def commit_batch(self, staged, row0: int) -> None:
        """Publish a staged batch at doc ids [row0, row0+n)."""
        kind = staged[0]
        for i in staged[1]:
            self.null_docs.append(row0 + i)
        if kind == "mv":
            for row in staged[2]:
                self._append_mv_row(row)
            return
        if kind == "dict":
            _, _, uniq, inv = staged
            n = len(inv)
            if n == 0:
                return
            self._grow(row0 + n - 1)
            uvals = uniq.tolist()  # python values, like the row path stores
            ids = np.empty(len(uvals), dtype=np.int32)
            for j, v in enumerate(uvals):
                did = self._dict.get(v)
                if did is None:
                    did = len(self._dict_values)
                    self._dict[v] = did
                    self._dict_values.append(v)
                ids[j] = did
            self._data[row0:row0 + n] = ids[inv]
            # uniq is sorted: batch min/max are its ends
            self._track(uvals[0])
            self._track(uvals[-1])
            return
        arr = staged[2]
        n = len(arr)
        if n == 0:
            return
        self._grow(row0 + n - 1)
        self._data[row0:row0 + n] = arr
        self._track(arr.min().item())
        self._track(arr.max().item())

    def dict_table(self) -> np.ndarray:
        """Snapshot of the insertion-ordered dictionary values as an array
        (the dict list only appends, so a slice-copy is a safe snapshot).
        BYTES values stay object-typed — an 'S' array would strip trailing
        NUL bytes on the way through."""
        vals = self._dict_values[:]
        if vals and isinstance(vals[0], bytes):
            return np.asarray(vals, dtype=object)
        return np.asarray(vals)

    def values(self, n: int) -> np.ndarray:
        """Decoded raw values for the first n docs (reader snapshot); MV
        columns return an object array of per-row arrays."""
        return self.values_range(0, n)

    def values_range(self, start: int, stop: int) -> np.ndarray:
        """Decoded raw values for docs [start, stop) — the tail-view form:
        decoding a 64k-row tail must not pay a full-segment dictionary
        take (realtime/chunklet.py MutableTailView)."""
        if not self.single_value:
            out = np.empty(stop - start, dtype=object)
            rows = self._rows  # grow-only list: indexes < stop are stable
            for i in range(start, stop):
                out[i - start] = rows[i]
            return out
        if self.dict_encoded:
            return self.dict_table()[self._data[start:stop]]
        return self._data[start:stop]

    @property
    def cardinality(self) -> int:
        return len(self._dict_values) if self.dict_encoded else -1


class _MetadataView:
    """Duck-typed SegmentMetadata for the host executor / pruner."""

    def __init__(self, seg: "MutableSegment"):
        self._seg = seg

    @property
    def columns(self) -> dict:
        return {name: self._seg.column_metadata(name) for name in self._seg._cols}


class MutableSegment:
    is_mutable = True

    def __init__(self, schema: Schema, segment_name: str,
                 table_config: Optional[TableConfig] = None,
                 enable_upsert: bool = False):
        self.schema = schema
        self.segment_name = segment_name
        self.table_config = table_config or TableConfig(table_name=schema.name)
        self._cols = {n: MutableColumn(schema.field(n)) for n in schema.column_names()}
        self._count = 0  # volatile doc counter: bumped AFTER the row lands
        self._lock = threading.Lock()  # single writer enforced defensively
        self._valid = np.ones(_INITIAL_CAPACITY, dtype=bool) if enable_upsert else None
        self.start_offset = None
        self.end_offset = None
        # chunklet subsystem (realtime/chunklet.py): frozen-prefix promotion
        # into sealed device-eligible blocks. Created eagerly from config so
        # the consume loop / engine never check config themselves; MV
        # columns keep the whole segment in the host path's shape (the device
        # batch layer rejects MV consuming data anyway).
        self.chunklet_index = None
        ck_cfg = getattr(self.table_config, "chunklets", None)
        if ck_cfg is not None and ck_cfg.enabled and all(
                schema.field(n).single_value for n in schema.column_names()):
            from pinot_tpu_torch.realtime.chunklet import ChunkletIndex

            self.chunklet_index = ChunkletIndex(self, ck_cfg)

    # ---- write path ------------------------------------------------------
    def index(self, row: dict) -> int:
        """Index one row; returns its doc id. Row values missing from the
        schema default to the field's null value (recordtransformer analog)."""
        with self._lock:
            doc_id = self._count
            for name, col in self._cols.items():
                v = row.get(name)
                if v is None:
                    # record nullness BEFORE substituting the default value
                    # (IS_NULL reads this; the forward index stores the
                    # default, same as the sealed null-vector contract)
                    col.null_docs.append(doc_id)
                    v = [] if not col.single_value else col.spec.null_value()
                col.append(v, doc_id)
            if self._valid is not None and doc_id >= len(self._valid):
                new = np.ones(len(self._valid) * 2, dtype=bool)
                new[: len(self._valid)] = self._valid
                self._valid = new
            self._count = doc_id + 1  # publish: readers never see doc_id
        from pinot_tpu_torch.common import freshness

        # broker result caches keyed on the table freshness epoch must
        # never serve counts from before this row
        freshness.bump(self.table_config.table_name)
        return doc_id

    def index_batch(self, rows) -> int:
        """Columnar batch indexing (the chunklet subsystem's ingest basis):
        one vectorized append per column instead of n per-row dict walks.
        Conversion is staged for EVERY column before any state mutates, so
        a bad row fails the whole batch atomically — callers fall back to
        row-at-a-time ``index`` to isolate poison rows. Returns the first
        doc id of the batch. Upsert tables keep the per-row path (the
        primary-key CAS is inherently row-at-a-time)."""
        rows = rows if isinstance(rows, list) else list(rows)
        with self._lock:
            row0 = self._count
            n = len(rows)
            if n == 0:
                return row0
            staged = {
                name: col.prepare_batch([r.get(name) for r in rows])
                for name, col in self._cols.items()
            }
            for name, col in self._cols.items():
                col.commit_batch(staged[name], row0)
            if self._valid is not None:
                while row0 + n > len(self._valid):
                    new = np.ones(len(self._valid) * 2, dtype=bool)
                    new[: len(self._valid)] = self._valid
                    self._valid = new
            self._count = row0 + n  # publish the whole batch at once
        from pinot_tpu_torch.common import freshness

        freshness.bump(self.table_config.table_name)
        return row0

    def invalidate(self, doc_id: int) -> None:
        """Upsert: flip this doc out of validDocIds
        (ThreadSafeMutableRoaringBitmap analog)."""
        if self._valid is not None:
            self._valid[doc_id] = False
            from pinot_tpu_torch.common import freshness

            freshness.bump(self.table_config.table_name)
            if self.chunklet_index is not None:
                # a promoted chunklet covering this doc can no longer run
                # unmasked on the device path
                self.chunklet_index.note_invalidated(doc_id)

    # ---- reader protocol (host executor duck type) -----------------------
    @property
    def n_docs(self) -> int:
        return self._count

    @property
    def name(self) -> str:
        return self.segment_name

    @property
    def dir(self) -> str:
        return f"<mutable:{self.segment_name}:{self._count}>"

    @property
    def metadata(self):
        return _MetadataView(self)

    def column_names(self) -> list:
        return list(self._cols)

    def column_metadata(self, col: str) -> ColumnMetadata:
        c = self._cols[col]
        return ColumnMetadata(
            name=col,
            data_type=c.spec.data_type,
            encoding=Encoding.RAW,  # readers take the raw-value scan path
            cardinality=c.cardinality,
            min_value=c.min_value,
            max_value=c.max_value,
            is_sorted=False,
            single_value=c.single_value,
            has_dictionary=False,
            total_number_of_entries=(
                self._count if c.single_value else c.total_entries
            ),
        )

    def dictionary(self, col: str):
        return None  # insertion-ordered dict is not binary-searchable

    def bloom(self, col: str):
        return None

    def values(self, col: str) -> np.ndarray:
        return self._cols[col].values(self._count)

    def valid_docs(self, n: int):
        if self._valid is None:
            return None
        return self._valid[:n]

    def row_value(self, col: str, doc_id: int):
        """One doc's decoded value, or None when null there — O(1), used by
        the partial-upsert previous-version read (no column materialization).
        null_docs appends in doc order, so membership is a binary search."""
        import bisect

        c = self._cols[col]
        nd = c.null_docs
        if nd:
            i = bisect.bisect_left(nd, doc_id, 0, len(nd))
            if i < len(nd) and nd[i] == doc_id:
                return None
        if not c.single_value:
            return c._rows[doc_id].tolist()
        if c.dict_encoded:
            return c._dict_values[int(c._data[doc_id])]
        v = c._data[doc_id]
        return v.item() if isinstance(v, np.generic) else v

    def null_vector(self, col: str):
        """Per-doc null bitmap over all indexed docs, or None when clean
        (readers slice to their snapshot length)."""
        docs = self._cols[col].null_docs
        if not docs:
            return None
        mask = np.zeros(self._count, dtype=bool)
        ids = np.asarray(docs[:], dtype=np.int64)
        mask[ids[ids < self._count]] = True
        return mask

    # ---- seal ------------------------------------------------------------
    def seal(self, out_dir: str):
        """Consuming → immutable conversion (RealtimeSegmentConverter.java):
        re-encodes through the two-pass creator, which rebuilds *sorted*
        dictionaries and all configured indexes."""
        from pinot_tpu_torch.storage.creator import build_segment
        from pinot_tpu_torch.storage.segment import ImmutableSegment

        n = self._count
        ci = self.chunklet_index
        if ci is not None and ci.chunklets:
            # reuse the already-sealed chunklet column blocks for the frozen
            # prefix: only the unfrozen tail decodes through the insertion-
            # ordered dictionary here
            columns = {name: ci.column_with_tail(name, n)
                       for name in self._cols}
        else:
            columns = {name: self._cols[name].values(n) for name in self._cols}
        null_masks = {}
        for name in self._cols:
            nv = self.null_vector(name)
            if nv is not None and nv[:n].any():
                null_masks[name] = nv[:n]
        build_segment(self.schema, columns, out_dir, self.table_config,
                      self.segment_name, null_masks=null_masks or None)
        seg = ImmutableSegment(out_dir)
        if self._valid is not None:
            seg.valid_docs_mask = self._valid[:n].copy()
        if ci is not None:
            # seal retires the consuming segment's chunklet batches: drop
            # any device partials cached over them (realtime/chunklet.py)
            from pinot_tpu_torch.realtime.chunklet import _invalidate_device_partials

            _invalidate_device_partials(f"<chunklet:{self.segment_name}:")
        from pinot_tpu_torch.common import freshness

        # seal swaps the consuming backend for the immutable one: cached
        # broker results built over the old split must re-validate
        freshness.bump(self.table_config.table_name)
        return seg
