"""Immutable segment: on-disk format + host-side reader.

Equivalent of the reference's segment directory format + ``ImmutableSegmentImpl``
(pinot-segment-local/.../indexsegment/immutable/ImmutableSegmentImpl.java and
V1Constants.java:25-53), re-designed for a TPU loader:

- ``metadata.json``         segment + per-column metadata (replaces
                            metadata.properties + index_map)
- ``<col>.fwd.npy``         forward index: int32 dict ids (DICT encoding) or
                            raw typed values (RAW encoding); mmap-able dense
                            arrays instead of bit-packed buffers so the device
                            upload is a straight memcpy. (A bit-packed variant
                            ``<col>.fwdpacked.bin`` is written when bit packing
                            is enabled.)
- ``<col>.mvoff.npy``       multi-value row offsets (n_docs+1) when the column
                            is multi-value; fwd then holds the flattened values
- ``<col>.dict.npy``        sorted dictionary values
- ``<col>.inv.docs.npy`` /
  ``<col>.inv.off.npy``     inverted index: concatenated sorted doc-id lists
                            per dict id + offsets (card+1) — the dense analog
                            of one RoaringBitmap per dict id
                            (BitmapInvertedIndexReader.java)
- ``<col>.bloom.npy``       bloom filter bitset (host-side pruning)
- ``startree/``             star-tree pre-aggregated segment (own metadata)

All arrays load with ``np.load(mmap_mode='r')`` — the host never copies a
column until it is shipped to HBM.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from pinot_tpu_torch.common.datatypes import DataType
from pinot_tpu_torch.storage import bitpack
from pinot_tpu_torch.storage.dictionary import Dictionary

SEGMENT_FORMAT_VERSION = 1

METADATA_FILE = "metadata.json"
CREATION_META_FILE = "creation.meta.json"

# Zone-map granularity (rows per zone-map block). A format constant shared by
# the segment creator (``<col>.zmap.npy``), the chunklet sealer, and the
# device batch loader (engine/params.py) — the device block-skip kernel
# (ops/blockskip.py) prunes at exactly this granularity, so the on-disk
# blocks line up 1:1 with the (S, n_blocks) device zone arrays.
ZONE_BLOCK_ROWS = 4096


def build_zone_map(values: np.ndarray, block_rows: int = ZONE_BLOCK_ROWS) -> np.ndarray:
    """(2, n_blocks) per-block [min, max] over ``values`` (dict ids for DICT
    columns, raw values for RAW) — the columnar analog of the reference's
    per-chunk min/max metadata that ColumnValueSegmentPruner consults, kept
    at a granularity the device can gather by."""
    n = len(values)
    if n == 0:
        return np.zeros((2, 0), dtype=np.asarray(values).dtype)
    starts = np.arange(0, n, block_rows, dtype=np.int64)
    lo = np.minimum.reduceat(values, starts)
    hi = np.maximum.reduceat(values, starts)
    return np.stack([lo, hi])


class Encoding:
    DICT = "DICT"
    RAW = "RAW"


@dataclasses.dataclass
class ColumnMetadata:
    name: str
    data_type: DataType
    encoding: str
    cardinality: int
    min_value: object
    max_value: object
    is_sorted: bool
    single_value: bool = True
    max_mv_entries: int = 1
    has_dictionary: bool = False
    has_inverted: bool = False
    has_range: bool = False
    has_bloom: bool = False
    has_json_index: bool = False
    has_text_index: bool = False
    has_fst_index: bool = False
    has_h3_index: bool = False
    has_null_vector: bool = False
    packed_bits: Optional[int] = None  # bit-packed fwd index width, else None
    compression: Optional[str] = None  # raw fwd chunk codec (zlib|zstd|lz4)
    total_number_of_entries: int = 0  # == n_docs for SV, total MV entries for MV
    partition_function: Optional[str] = None
    num_partitions: Optional[int] = None
    partitions: Optional[list[int]] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["data_type"] = self.data_type.value
        for k in ("min_value", "max_value"):
            v = d[k]
            if isinstance(v, (np.generic,)):
                d[k] = v.item()
            if isinstance(v, bytes):
                d[k] = v.hex()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ColumnMetadata":
        d = dict(d)
        d["data_type"] = DataType(d["data_type"])
        return cls(**d)


@dataclasses.dataclass
class SegmentMetadata:
    segment_name: str
    table_name: str
    n_docs: int
    columns: dict[str, ColumnMetadata]
    time_column: Optional[str] = None
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    format_version: int = SEGMENT_FORMAT_VERSION
    crc: Optional[str] = None

    def to_json(self) -> dict:
        return {
            "segment_name": self.segment_name,
            "table_name": self.table_name,
            "n_docs": self.n_docs,
            "time_column": self.time_column,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "format_version": self.format_version,
            "crc": self.crc,
            "columns": {k: v.to_json() for k, v in self.columns.items()},
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentMetadata":
        d = dict(d)
        d["columns"] = {k: ColumnMetadata.from_json(v) for k, v in d["columns"].items()}
        return cls(**d)


class ImmutableSegment:
    """Host-side handle on a sealed segment directory (mmap-backed).

    The query path never reads values through this object doc-by-doc; it
    either ships whole columns to the device (``DeviceSegment``) or runs
    vectorized numpy over the mmap for host-only paths (pruning, string
    materialization) — the moral replacement for ForwardIndexReader's
    batch ``readDictIds``/``readValuesSV`` (ForwardIndexReader.java:85,114).
    """

    # upsert: in-memory validDocIds mask managed by the upsert metadata
    # manager (realtime/upsert.py); None for non-upsert tables
    valid_docs_mask = None

    # plane-load observation seam: called with the plane file
    # name the FIRST time it is actually mapped/decoded. The warm tier's
    # LazySegmentView (server/tiering.py) counts through it to assert the
    # mapFile contract — a query touching 2 of 20 columns maps only those
    # planes. None (the default) costs one attribute read per cold load.
    plane_load_hook = None

    def __init__(self, segment_dir: str):
        self.dir = segment_dir
        with open(os.path.join(segment_dir, METADATA_FILE)) as f:
            self.metadata = SegmentMetadata.from_json(json.load(f))
        self._dict_cache: dict[str, Optional[Dictionary]] = {}
        self._fwd_cache: dict[str, np.ndarray] = {}
        self._json_cache: dict = {}
        self._text_cache: dict = {}

    # ---- identity -------------------------------------------------------
    @property
    def name(self) -> str:
        return self.metadata.segment_name

    @property
    def n_docs(self) -> int:
        return self.metadata.n_docs

    def column_names(self) -> list[str]:
        return list(self.metadata.columns)

    def column_metadata(self, col: str) -> ColumnMetadata:
        return self.metadata.columns[col]

    def _path(self, fname: str) -> str:
        return os.path.join(self.dir, fname)

    def _note_plane(self, fname: str) -> None:
        h = self.plane_load_hook
        if h is not None:
            h(fname)

    # ---- index readers --------------------------------------------------
    def dictionary(self, col: str) -> Optional[Dictionary]:
        if col not in self._dict_cache:
            meta = self.column_metadata(col)
            if meta.has_dictionary:
                self._note_plane(f"{col}.dict.npy")
                self._dict_cache[col] = Dictionary.load(self._path(f"{col}.dict.npy"))
            else:
                self._dict_cache[col] = None
        return self._dict_cache[col]

    def forward(self, col: str) -> np.ndarray:
        """Dict ids (int32) for DICT columns, raw values for RAW columns.
        Bit-packed columns decode through storage/bitpack.py
        (FixedBitSVForwardIndexReader analog) into an in-memory int32
        array; plain columns stay mmap'd."""
        if col not in self._fwd_cache:
            meta = self.column_metadata(col)
            if meta.compression is not None:
                from pinot_tpu_torch import native

                self._note_plane(f"{col}.fwdz.bin")
                blob = np.fromfile(self._path(f"{col}.fwdz.bin"),
                                   dtype=np.uint8)
                offs = np.load(self._path(f"{col}.fwdz.off.npy"),
                               allow_pickle=False)
                n = (self.n_docs if meta.single_value
                     else meta.total_number_of_entries)
                dtype = np.dtype(meta.data_type.np_dtype)
                raw = native.decompress_chunks(blob, offs, n * dtype.itemsize,
                                               codec=meta.compression)
                self._fwd_cache[col] = raw.view(dtype)
            elif meta.packed_bits is not None:
                self._note_plane(f"{col}.fwdpacked.bin")
                buf = np.fromfile(self._path(f"{col}.fwdpacked.bin"),
                                  dtype=np.uint8)
                n = (self.n_docs if meta.single_value
                     else meta.total_number_of_entries)
                need = bitpack.packed_size(n, meta.packed_bits)
                if len(buf) < need:
                    raise ValueError(
                        f"{col}.fwdpacked.bin truncated: {len(buf)} bytes, "
                        f"need {need} for {n} x {meta.packed_bits} bits"
                    )
                self._fwd_cache[col] = bitpack.unpack(buf, n, meta.packed_bits)
            else:
                self._note_plane(f"{col}.fwd.npy")
                self._fwd_cache[col] = np.load(
                    self._path(f"{col}.fwd.npy"), mmap_mode="r",
                    allow_pickle=False,
                )
        return self._fwd_cache[col]

    def mv_offsets(self, col: str) -> Optional[np.ndarray]:
        if self.column_metadata(col).single_value:
            return None
        self._note_plane(f"{col}.mvoff.npy")
        return np.load(self._path(f"{col}.mvoff.npy"), mmap_mode="r", allow_pickle=False)

    def inverted(self, col: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """(concat_sorted_doc_ids, offsets[card+1]) or None."""
        if not self.column_metadata(col).has_inverted:
            return None
        self._note_plane(f"{col}.inv.docs.npy")
        docs = np.load(self._path(f"{col}.inv.docs.npy"), mmap_mode="r", allow_pickle=False)
        off = np.load(self._path(f"{col}.inv.off.npy"), mmap_mode="r", allow_pickle=False)
        return docs, off

    def bloom(self, col: str) -> Optional[np.ndarray]:
        if not self.column_metadata(col).has_bloom:
            return None
        self._note_plane(f"{col}.bloom.npy")
        return np.load(self._path(f"{col}.bloom.npy"), mmap_mode="r", allow_pickle=False)

    def zone_map(self, col: str) -> Optional[np.ndarray]:
        """(2, n_blocks) per-ZONE_BLOCK_ROWS-block [min, max] over the
        forward index (LOCAL dict ids for DICT columns, raw values
        otherwise), or None for segments built before the format carried
        zone maps (the batch loader then recomputes from the column
        block)."""
        path = self._path(f"{col}.zmap.npy")
        if not os.path.isfile(path):
            return None
        self._note_plane(f"{col}.zmap.npy")
        return np.load(path, mmap_mode="r", allow_pickle=False)

    def range_index(self, col: str) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """(doc_ids_in_value_order, sorted_values) for a RAW range-indexed
        column (RangeIndexReaderImpl analog), or None."""
        meta = self.column_metadata(col)
        if not meta.has_range or meta.encoding == Encoding.DICT:
            return None
        docs_path = self._path(f"{col}.range.docs.npy")
        if not os.path.isfile(docs_path):
            return None
        self._note_plane(f"{col}.range.docs.npy")
        docs = np.load(docs_path, mmap_mode="r", allow_pickle=False)
        vals = np.load(self._path(f"{col}.range.vals.npy"), mmap_mode="r",
                       allow_pickle=False)
        return docs, vals

    def json_index(self, col: str):
        """JSON index reader (ImmutableJsonIndexReader analog), or None."""
        if col not in self._json_cache:
            if not self.column_metadata(col).has_json_index:
                self._json_cache[col] = None
            else:
                from pinot_tpu_torch.storage.jsonindex import JsonIndexReader

                self._json_cache[col] = JsonIndexReader(
                    self._path(f"{col}.jsonidx.npz"))
        return self._json_cache[col]

    def text_index(self, col: str):
        """Text index reader (LuceneTextIndexReader analog), or None."""
        if col not in self._text_cache:
            if not self.column_metadata(col).has_text_index:
                self._text_cache[col] = None
            else:
                from pinot_tpu_torch.storage.textindex import TextIndexReader

                self._text_cache[col] = TextIndexReader(
                    self._path(f"{col}.textidx.npz"))
        return self._text_cache[col]

    def fst_index(self, col: str):
        """Trigram regex-acceleration index (LuceneFSTIndexReader role), or
        None."""
        if not hasattr(self, "_fst_cache"):
            self._fst_cache = {}
        if col not in self._fst_cache:
            if not getattr(self.column_metadata(col), "has_fst_index", False):
                self._fst_cache[col] = None
            else:
                from pinot_tpu_torch.storage.fstindex import TrigramIndex

                self._fst_cache[col] = TrigramIndex.load(self.dir, col)
        return self._fst_cache[col]

    def geo_index(self, col: str):
        """Grid-cell geospatial index (ImmutableH3IndexReader role), or
        None."""
        if not hasattr(self, "_geo_cache"):
            self._geo_cache = {}
        if col not in self._geo_cache:
            if not getattr(self.column_metadata(col), "has_h3_index", False):
                self._geo_cache[col] = None
            else:
                from pinot_tpu_torch.storage.geoindex import GeoGridIndex

                self._geo_cache[col] = GeoGridIndex.load(self.dir, col)
        return self._geo_cache[col]

    def null_vector(self, col: str) -> Optional[np.ndarray]:
        """Per-doc null bitmap, or None when the column has no nulls
        (NullValueVectorReader analog; absent file == empty bitmap)."""
        if not self.column_metadata(col).has_null_vector:
            return None
        self._note_plane(f"{col}.nullvec.npy")
        return np.load(self._path(f"{col}.nullvec.npy"), mmap_mode="r",
                       allow_pickle=False)

    # ---- raw value access (host-side materialization) -------------------
    def values(self, col: str) -> np.ndarray:
        """Decoded raw values for the whole column (host path only).
        Multi-value columns return an object array of per-doc value arrays
        (ForwardIndexReader.java:99 getDictIdMV analog)."""
        meta = self.column_metadata(col)
        flat = self.flat_values(col)
        if meta.single_value:
            return flat
        off = np.asarray(self.mv_offsets(col))
        out = np.empty(self.n_docs, dtype=object)
        for i in range(self.n_docs):
            out[i] = flat[off[i]: off[i + 1]]
        return out

    def flat_values(self, col: str) -> np.ndarray:
        """Decoded values in entry order: (n_docs,) for SV, (total_entries,)
        for MV (pair with ``mv_offsets``). The vectorized MV access path —
        ``values()``'s per-doc object array is for row materialization only."""
        meta = self.column_metadata(col)
        fwd = self.forward(col)
        if meta.encoding == Encoding.DICT:
            return self.dictionary(col).take(np.asarray(fwd))
        return np.asarray(fwd)

    def row_value(self, col: str, doc_id: int):
        """One doc's decoded value, or None when the doc is null there —
        O(1) via the cached forward index + dictionary, used by the
        partial-upsert previous-version read."""
        nv = self.null_vector(col)
        if nv is not None and doc_id < len(nv) and nv[doc_id]:
            return None
        meta = self.column_metadata(col)
        fwd = self.forward(col)
        if meta.single_value:
            v = fwd[doc_id]
            if meta.encoding == Encoding.DICT:
                v = self.dictionary(col).values[int(v)]
        else:
            off = np.asarray(self.mv_offsets(col))
            ent = np.asarray(fwd[off[doc_id]: off[doc_id + 1]])
            if meta.encoding == Encoding.DICT:
                ent = self.dictionary(col).take(ent)
            return ent.tolist()
        return v.item() if isinstance(v, np.generic) else v

    def has_star_tree(self) -> bool:
        return os.path.isdir(self._path("startree"))


def write_creation_meta(segment_dir: str) -> None:
    with open(os.path.join(segment_dir, CREATION_META_FILE), "w") as f:
        json.dump(
            {"creation_time_ms": int(time.time() * 1000), "version": SEGMENT_FORMAT_VERSION}, f
        )
