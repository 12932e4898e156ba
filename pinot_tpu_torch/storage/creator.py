"""Segment creation: columnar data -> sealed segment directory.

Equivalent of the reference's two-pass ``SegmentIndexCreationDriverImpl``
(pinot-segment-local/.../creator/impl/SegmentIndexCreationDriverImpl.java:101
init / :196 build): pass 1 collects per-column stats (cardinality, min/max,
sortedness — creator/impl/stats/), pass 2 writes dictionaries, forward
indexes and auxiliary indexes (SegmentColumnarIndexCreator.java). Here both
passes are fused into vectorized numpy (``np.unique`` yields stats + dict +
encoded ids at once), and indexes are written as dense mmap-able npy arrays
instead of bit-packed buffers.

Encoding policy (TPU-first, diverging from the reference's
dictionary-everything default): STRING/JSON/BYTES and all dimension /
datetime columns are dict-encoded (device work stays in int32 id space);
metric columns are stored raw so SUM/AVG avoid a device-side gather.
``no_dictionary_columns`` forces RAW for numeric columns.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np

from pinot_tpu_torch.common.datatypes import DataType, FieldRole
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.storage import bitpack
from pinot_tpu_torch.storage import partition as partition_mod
from pinot_tpu_torch.storage.segment import (
    METADATA_FILE,
    ColumnMetadata,
    Encoding,
    ImmutableSegment,
    SegmentMetadata,
    build_zone_map,
    write_creation_meta,
)

import json


def _np_column(values, dtype: DataType) -> np.ndarray:
    """Coerce an ingested column to its canonical numpy representation.
    Columns already in canonical dtype pass through without a per-element
    copy (the conversion loop dominated segment build time at 10M+ rows)."""
    if dtype.is_string_like:
        arr = np.asarray(values) if not isinstance(values, np.ndarray) else values
        if dtype is DataType.BYTES:
            if arr.dtype.kind == "S":
                return arr
            return np.asarray(
                [v if isinstance(v, bytes) else bytes(v) for v in values],
                dtype=np.bytes_,
            )
        if arr.dtype.kind == "U":
            return arr
        return np.asarray([str(v) for v in values], dtype=np.str_)
    arr = np.asarray(values)
    if arr.dtype == dtype.np_dtype:
        return arr
    if arr.dtype == object:
        arr = np.asarray([dtype.convert(v) for v in values])
    return arr.astype(dtype.np_dtype)


class SegmentCreator:
    def __init__(
        self,
        schema: Schema,
        table_config: Optional[TableConfig] = None,
        segment_name: str = "segment_0",
    ):
        self.schema = schema
        self.table_config = table_config or TableConfig(table_name=schema.name)
        self.segment_name = segment_name

    def build(self, columns: Mapping[str, Sequence], out_dir: str,
              null_masks: Optional[Mapping[str, Sequence]] = None) -> str:
        """Build a sealed segment from column arrays; returns the segment dir.

        Null semantics (NullValueVectorReader analog): ``None`` entries are
        detected, replaced by the field's default null value in the forward
        index, and recorded in a per-column null vector
        (``<col>.nullvec.npy``). ``null_masks`` lets callers that already
        substituted defaults (the mutable-segment seal) pass explicit masks.
        """
        os.makedirs(out_dir, exist_ok=True)
        idx_cfg = self.table_config.indexing
        n_docs = None
        col_meta: dict[str, ColumnMetadata] = {}

        for name in self.schema.column_names():
            spec = self.schema.field(name)
            if name not in columns:
                raise KeyError(f"input data missing column {name!r}")
            raw_in = columns[name]

            detected = _detect_none(raw_in)
            null_mask = None if null_masks is None else null_masks.get(name)
            if detected is not None:
                raw_in = _substitute_nulls(raw_in, detected, spec)
                null_mask = detected if null_mask is None \
                    else (np.asarray(null_mask, dtype=bool) | detected)

            if not spec.single_value:
                # multi-value: flatten + offsets
                lens = np.fromiter((len(r) for r in raw_in), dtype=np.int64, count=len(raw_in))
                flat = [v for row in raw_in for v in row]
                raw = _np_column(flat, spec.data_type)
                mv_off = np.zeros(len(raw_in) + 1, dtype=np.int64)
                np.cumsum(lens, out=mv_off[1:])
            else:
                raw = _np_column(raw_in, spec.data_type)
                mv_off = None

            nd = len(raw_in)
            if n_docs is None:
                n_docs = nd
            elif nd != n_docs:
                raise ValueError(f"column {name} has {nd} rows, expected {n_docs}")

            use_dict = self._use_dictionary(spec, idx_cfg.no_dictionary_columns)
            meta = self._write_column(
                name, spec, raw, mv_off, out_dir, use_dict, idx_cfg, nd
            )
            if null_mask is not None and np.asarray(null_mask).any():
                np.save(os.path.join(out_dir, f"{name}.nullvec.npy"),
                        np.asarray(null_mask, dtype=bool), allow_pickle=False)
                meta.has_null_vector = True
            col_meta[name] = meta

        time_col = self.table_config.time_column
        start = end = None
        if time_col and time_col in col_meta:
            start = col_meta[time_col].min_value
            end = col_meta[time_col].max_value

        meta = SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self.table_config.table_name,
            n_docs=int(n_docs or 0),
            columns=col_meta,
            time_column=time_col,
            start_time=start,
            end_time=end,
            crc=_segment_crc(out_dir),
        )
        with open(os.path.join(out_dir, METADATA_FILE), "w") as f:
            json.dump(meta.to_json(), f, indent=1, default=_json_default)
        write_creation_meta(out_dir)

        # star-tree build happens after the base segment is sealed, like the
        # reference (SegmentIndexCreationDriverImpl.java:290,316)
        if idx_cfg.star_tree_configs:
            raise NotImplementedError(
                "star-tree indexes come with a later slice of the port")
        return out_dir

    @staticmethod
    def _use_dictionary(spec, no_dict_cols) -> bool:
        if spec.data_type.is_string_like:
            return True
        if spec.name in no_dict_cols:
            return False
        return spec.role is not FieldRole.METRIC

    def _write_column(self, name, spec, raw, mv_off, out_dir, use_dict, idx_cfg, n_docs):
        def p(fname):
            return os.path.join(out_dir, fname)

        total_entries = len(raw)
        is_sorted = bool(np.all(raw[1:] >= raw[:-1])) if total_entries > 1 else True
        if not spec.single_value:
            is_sorted = False

        if use_dict:
            from pinot_tpu_torch.storage.dictionary import Dictionary

            dictionary, ids = Dictionary.build(raw)
            packed_bits = None
            if idx_cfg.enable_bit_packing and spec.single_value:
                bits = bitpack.bits_needed(dictionary.cardinality)
                if bits <= 16:  # >=2x smaller than int32, else not worth it
                    bitpack.pack(ids, bits).tofile(p(f"{name}.fwdpacked.bin"))
                    packed_bits = bits
            if packed_bits is None:
                np.save(p(f"{name}.fwd.npy"), ids, allow_pickle=False)
            # a rebuild into the same dir with packing toggled must not
            # leave another format behind (stale files skew the CRC and
            # ride every download)
            stale = [p(f"{name}.fwdz.bin"), p(f"{name}.fwdz.off.npy")]
            stale.append(p(f"{name}.fwd.npy") if packed_bits is not None
                         else p(f"{name}.fwdpacked.bin"))
            for path in stale:
                if os.path.exists(path):
                    os.unlink(path)
            dictionary.save(p(f"{name}.dict.npy"))
            cardinality = dictionary.cardinality
            if cardinality:
                minv, maxv = dictionary.get(0), dictionary.get(cardinality - 1)
            else:
                minv = maxv = None
            encoding = Encoding.DICT
            compression = None
            fwd_for_inv = ids
            dict_values = dictionary.values
        else:
            dict_values = None
            packed_bits = None
            codec_map = getattr(idx_cfg, "compression_codec", {}) or {}
            if (name in idx_cfg.compressed_columns or name in codec_map) \
                    and spec.single_value:
                raise NotImplementedError(
                    "compressed raw forward indexes come with a later slice "
                    "of the port")
            else:
                np.save(p(f"{name}.fwd.npy"), raw, allow_pickle=False)
                compression = None
            # rebuilds with a different encoding config must not leave the
            # other format behind (stale files skew the CRC)
            stale = [p(f"{name}.fwdpacked.bin")]
            stale += [p(f"{name}.fwd.npy")] if compression else \
                [p(f"{name}.fwdz.bin"), p(f"{name}.fwdz.off.npy")]
            for path in stale:
                if os.path.exists(path):
                    os.unlink(path)
            cardinality = int(len(np.unique(raw)))
            minv, maxv = (raw.min(), raw.max()) if len(raw) else (None, None)
            encoding = Encoding.RAW
            fwd_for_inv = None

        if mv_off is not None:
            np.save(p(f"{name}.mvoff.npy"), mv_off, allow_pickle=False)

        if spec.single_value:
            # per-block zone map over the forward index (local dict ids for
            # DICT, raw values for RAW): the device block-skip path's prune
            # basis (ops/blockskip.py). Local ids remap to the batch's
            # global id space monotonically (both dictionaries are sorted),
            # so min/max survive the remap — engine/params.py reads this
            # file instead of re-scanning the column at batch build.
            zm_src = fwd_for_inv if use_dict else raw
            np.save(p(f"{name}.zmap.npy"), build_zone_map(zm_src),
                    allow_pickle=False)
        elif os.path.exists(p(f"{name}.zmap.npy")):
            os.unlink(p(f"{name}.zmap.npy"))  # SV→MV rebuild: stale zone map

        has_inverted = False
        if name in idx_cfg.inverted_index_columns and fwd_for_inv is not None:
            self._write_inverted(name, fwd_for_inv, cardinality, mv_off, out_dir)
            has_inverted = True

        has_bloom = False
        if name in idx_cfg.bloom_filter_columns:
            from pinot_tpu_torch.storage.bloom import build_bloom

            build_bloom(raw if dict_values is None else None, dict_values, p(f"{name}.bloom.npy"))
            has_bloom = True

        has_json_index = False
        if name in idx_cfg.json_index_columns:
            if not (spec.single_value and spec.data_type.is_string_like):
                raise ValueError(
                    f"json index requires a single-value STRING/JSON column, "
                    f"got {name}")
            raise NotImplementedError(
                "json indexes come with a later slice of the port")
            has_json_index = True

        has_text_index = False
        if name in idx_cfg.text_index_columns:
            if not (spec.single_value and spec.data_type.is_string_like):
                raise ValueError(
                    f"text index requires a single-value STRING column, "
                    f"got {name}")
            raise NotImplementedError(
                "text indexes come with a later slice of the port")
            has_text_index = True

        has_fst_index = False
        if name in getattr(idx_cfg, "fst_index_columns", ()):
            if encoding != Encoding.DICT or dict_values is None:
                raise ValueError(
                    f"fst index requires a dictionary column, got {name}")
            raise NotImplementedError(
                "fst indexes come with a later slice of the port")
            has_fst_index = True

        has_h3_index = False
        if name in getattr(idx_cfg, "h3_index_columns", ()):
            if not (spec.single_value and spec.data_type.is_string_like):
                raise ValueError(
                    f"geo (h3-role) index requires a single-value STRING "
                    f"POINT column, got {name}")
            raise NotImplementedError(
                "geo indexes come with a later slice of the port")
            has_h3_index = True

        # Range acceleration: DICT columns get it for free — the sorted
        # dictionary maps a value range to a dict-id interval. RAW SV
        # columns get a sorted-projection range index (RangeIndexCreator /
        # BitSlicedRangeIndexReader analog): doc ids in value order plus the
        # sorted values, so a range is two binary searches + a doc-id slice.
        has_range = name in idx_cfg.range_index_columns and encoding == Encoding.DICT
        if name in idx_cfg.range_index_columns and encoding == Encoding.RAW \
                and spec.single_value:
            order = np.argsort(raw, kind="stable").astype(np.int32)
            np.save(p(f"{name}.range.docs.npy"), order, allow_pickle=False)
            np.save(p(f"{name}.range.vals.npy"), raw[order], allow_pickle=False)
            has_range = True

        part_fn = part_n = parts = None
        pmap = self.table_config.partition.column_partition_map
        if name in pmap:
            fn, n_part = pmap[name]
            vals = raw if dict_values is None else dict_values
            pids = partition_mod.partition_ids(np.asarray(vals), fn, n_part)
            part_fn, part_n, parts = fn, n_part, sorted(set(int(x) for x in np.unique(pids)))

        return ColumnMetadata(
            name=name,
            data_type=spec.data_type,
            encoding=encoding,
            cardinality=int(cardinality),
            min_value=_scalar(minv),
            max_value=_scalar(maxv),
            is_sorted=is_sorted,
            single_value=spec.single_value,
            max_mv_entries=int(np.max(np.diff(mv_off))) if mv_off is not None and len(mv_off) > 1 else 1,
            has_dictionary=use_dict,
            has_inverted=has_inverted,
            has_range=has_range,
            has_bloom=has_bloom,
            has_json_index=has_json_index,
            has_text_index=has_text_index,
            has_fst_index=has_fst_index,
            has_h3_index=has_h3_index,
            packed_bits=packed_bits,
            compression=compression,
            total_number_of_entries=int(total_entries),
            partition_function=part_fn,
            num_partitions=part_n,
            partitions=parts,
        )

    @staticmethod
    def _write_inverted(name, ids, cardinality, mv_off, out_dir):
        """Inverted index: per-dict-id sorted doc lists, concatenated.

        Dense equivalent of one RoaringBitmap per dict id
        (OffHeapBitmapInvertedIndexCreator.java). ``argsort(kind='stable')``
        groups doc ids by dict id while preserving doc order within a group.
        """
        if mv_off is not None:
            # map each flattened entry back to its doc id
            doc_of_entry = np.repeat(
                np.arange(len(mv_off) - 1, dtype=np.int64), np.diff(mv_off)
            )
            order = np.argsort(ids, kind="stable")
            docs = doc_of_entry[order].astype(np.int32)
            counts = np.bincount(ids, minlength=cardinality)
        else:
            order = np.argsort(ids, kind="stable").astype(np.int32)
            docs = order
            counts = np.bincount(ids, minlength=cardinality)
        offsets = np.zeros(cardinality + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        np.save(os.path.join(out_dir, f"{name}.inv.docs.npy"), docs, allow_pickle=False)
        np.save(os.path.join(out_dir, f"{name}.inv.off.npy"), offsets, allow_pickle=False)


def _segment_crc(out_dir: str) -> str:
    """Content fingerprint over the segment's index files (the reference's
    segment CRC role: refresh-push detection, download validation). Hashes
    every file's name + size + first/last 1MB — full-content hashing of
    multi-GB forward indexes would tax large builds for a fingerprint whose
    job is change detection, not bit-rot integrity."""
    import zlib

    h = 0
    for fname in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, fname)
        if fname == METADATA_FILE or not os.path.isfile(path):
            continue
        size = os.path.getsize(path)
        h = zlib.crc32(f"{fname}:{size};".encode(), h)
        with open(path, "rb") as f:
            h = zlib.crc32(f.read(1 << 20), h)
            if size > (2 << 20):
                f.seek(-(1 << 20), os.SEEK_END)
                h = zlib.crc32(f.read(), h)
    return format(h, "08x")


def _detect_none(raw_in) -> Optional[np.ndarray]:
    """Per-doc ``is None`` mask, or None when no entry can be null (typed
    numpy input) or none is. MV rows count as null when the ROW is None."""
    if isinstance(raw_in, np.ndarray) and raw_in.dtype != object:
        return None
    mask = np.fromiter((v is None for v in raw_in), dtype=bool,
                       count=len(raw_in))
    return mask if mask.any() else None


def _substitute_nulls(raw_in, mask: np.ndarray, spec) -> list:
    """Replace null entries with the field's default null value
    (FieldSpec.getDefaultNullValue), empty list for MV rows."""
    filler = [] if not spec.single_value else spec.null_value()
    return [filler if is_null else v for v, is_null in zip(raw_in, mask)]


def _scalar(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, bytes):
        return o.hex()
    raise TypeError(f"not JSON serializable: {type(o)}")


def build_segment(
    schema: Schema,
    columns: Mapping[str, Sequence],
    out_dir: str,
    table_config: Optional[TableConfig] = None,
    segment_name: str = "segment_0",
    null_masks: Optional[Mapping[str, Sequence]] = None,
) -> ImmutableSegment:
    SegmentCreator(schema, table_config, segment_name).build(
        columns, out_dir, null_masks=null_masks
    )
    return ImmutableSegment(out_dir)
