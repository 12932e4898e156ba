"""Device batch context: segment batch + parameter resolution, on torch.

Counterpart of pinot_tpu/engine/params.py, over CUDA tensors:

- **Global-id columns**: per-segment dictionaries are unioned per column
  and the forward index is remapped into global id space on the host at
  upload time (one numpy gather, cached with the batch). Group-by keys are
  then the column itself, the cross-segment combine is a dense scatter,
  and predicate literals resolve to batch-wide scalars by one binary
  search on the global dictionary. The ids, their order and the plane
  dtypes equal the reference's, so group order and ties do too.
- **Column widths** (ColPlan): dict id planes are uint8 (C <= 255),
  uint16 (C <= 65535) or int32; raw and decoded (``dv::``) integer planes
  take a frame-of-reference narrow dtype that decodes to the wide dtype
  at use; floats are float32 (the device value space, storage/device.py).
- **Predicate params**: literals become small tensors on the device; the
  template is a pure function of them. LIKE / REGEXP evaluate once per
  global dictionary entry into a (C,) boolean LUT.

- **HLL planes**: per-doc value hashes gathered on the host at upload
  (``prehashed_column``) and the cached sorted ``slot << 5 | rho``
  projection of the filterless terminal HLL group-by
  (``sorted_hll_keys``), both held with the batch like its columns.

- **Multi-value columns**: ``mv_column`` is the reference device's
  (S, L, K) block of global dict ids, -1-padded, K <= ``MAX_MV_K``, over
  which an ``mv_any`` predicate matches any entry; ``mv_entries`` holds
  every entry of a column (dict ids or raw values) as an (S, E) plane
  with each entry's doc, for the host path's shape (engine/values.py,
  engine/rows.py), a schema-evolved column with none.

- **Zone maps**: every plane carries (S, NB) per-4096-row-block min/max
  arrays at the plane's storage dtype, built alongside it — dict planes
  in global id space (the local→global remap is monotone), raw planes in
  frame-of-reference storage space, ``dv::`` planes through the sorted
  dictionary's LUT — from the segment's ``<col>.zmap.npy``, recomputed
  when the file is missing or of another granularity. The block-skip
  verdict (ops/blockskip.py) reads them.

- **The sub-byte tier** (opt-in, ``PINOT_TPU_SUBBYTE=1``, read when a
  batch is built): dict id planes of C <= 3 pack 2-bit, C <= 15 4-bit ids
  into uint8 bytes on the card (``resident_bytes`` counts the packed
  plane); ``column`` unpacks them by torch ops (ops/masks.py
  ``unpack_subbyte``) each time a kernel or an expression reads them, and
  the fused K4 form refuses a packed plane, as the reference's does.
  ``narrow_saved_bytes`` counts what the width plans saved against the
  wide layout (int32 ids, the base raw dtype, and their zone maps).

Raises ``DeviceUnsupported`` for anything the device path does not
cover; the engine reports it in the response.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import threading

import numpy as np
import torch

from pinot_tpu_torch.engine.host import like_to_regex
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import hll as hll_ops
from pinot_tpu_torch.ops import masks as mask_ops
from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.query.context import (
    Expression,
    FilterNode,
    FilterNodeType,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.storage.device import RAW_DEVICE_DTYPES, padded_len
from pinot_tpu_torch.storage.dictionary import Dictionary
from pinot_tpu_torch.storage.segment import (
    ZONE_BLOCK_ROWS,
    Encoding,
    build_zone_map,
)


class DeviceUnsupported(Exception):
    """Query shape this slice of the port does not run on the device."""


def evolved_spec(seg, name: str):
    """The table schema's FieldSpec of a column the segment predates
    (schema evolution), or None."""
    if name in seg.metadata.columns:
        return None
    schema = getattr(seg, "table_schema", None)
    return None if schema is None else getattr(schema, "fields", {}).get(name)


@dataclasses.dataclass
class MVPlanes:
    """Every entry of a multi-value column over a batch, on the card:
    ``vals`` (S, E) the entries of each segment in doc order (global dict
    ids as int32 for a dict column, else the stored values; padding 0),
    ``doc`` (S, E) int32 each entry's doc in its segment (-1 on padding),
    ``lens`` / ``start`` (S, L) int32 each doc's entry count and first
    entry in its segment's row of ``vals``; ``kind`` "dict" or "num",
    ``dtype`` the host path's dtype of the values, ``total`` (S,) the
    entries of each segment (host ints), ``empty`` (S,) whether a doc of
    the segment has no entry (host bools)."""

    vals: torch.Tensor
    doc: torch.Tensor
    lens: torch.Tensor
    start: torch.Tensor
    kind: str
    dtype: np.dtype
    total: np.ndarray
    empty: np.ndarray


_NUMERIC_KINDS = ("i", "u", "f")


@dataclasses.dataclass(frozen=True)
class ColPlan:
    """Device storage plan for one column plane."""

    dtype: str          # numpy dtype .str of the STORED plane
    bits: int = 0       # sub-byte pack width (2 | 4); 0 = byte-aligned
    offset: int | None = None  # frame-of-reference offset (raw value space)
    wide: str = ""      # decode target dtype ("" = none needed)

    def sig(self) -> tuple:
        """Hashable template-key form (offset VALUE excluded — it is a
        runtime param)."""
        return (self.dtype, self.bits, self.offset is not None, self.wide)


def _int_for_plan(lo: int, hi: int, base: np.dtype) -> ColPlan:
    """Frame-of-reference plan for an integer plane with exact (python
    int) bounds: narrowest unsigned dtype covering the RANGE, offset only
    when the values don't already fit unsigned, int32 for int64 planes
    whose values fit it."""
    rng = hi - lo
    for dt, span in ((np.uint8, 1 << 8), (np.uint16, 1 << 16)):
        ndt = np.dtype(dt)
        if ndt.itemsize >= base.itemsize:
            break  # no byte-width win at/past the base dtype
        if 0 <= lo and hi < span:
            return ColPlan(ndt.str, wide=base.str)
        if rng < span:
            return ColPlan(ndt.str, offset=int(lo), wide=base.str)
    if base.itemsize > 4:
        if -(1 << 31) <= lo and hi < (1 << 31):
            return ColPlan(np.dtype(np.int32).str, wide=base.str)
        if 0 <= lo and hi < (1 << 32):
            return ColPlan(np.dtype(np.uint32).str, wide=base.str)
        if rng < (1 << 32):
            return ColPlan(np.dtype(np.uint32).str, offset=int(lo),
                           wide=base.str)
    return ColPlan(base.str)


def _pack_subbyte_np(blocks: np.ndarray, bits: int) -> np.ndarray:
    """(S, L) small ids -> (S, L * bits // 8) uint8, little-endian within
    each byte (the host-side inverse of ops/masks.py ``unpack_subbyte``)."""
    f = 8 // bits
    v = blocks.reshape(blocks.shape[0], -1, f).astype(np.uint16)
    shifts = np.arange(f, dtype=np.uint16) * bits
    return (v << shifts).sum(axis=-1, dtype=np.uint16).astype(np.uint8)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device`` in its own shape, 0-d included, as the
    reference's ``jnp.asarray`` keeps it: a 0-d frame-of-reference offset
    must stay 0-d, or K4's scalar leaves gain an axis and their partials
    no longer merge with another's."""
    return torch.from_numpy(np.asarray(a, order="C")).to(device)


def _locked(build):
    """Run a lazy builder of a ``BatchContext`` under the batch's lock.
    Concurrent queries share one cached batch (the executor's LRU), so two
    first readers must never build, upload and count a plane twice; an
    RLock, as builders call one another."""
    @functools.wraps(build)
    def locked(self, *args, **kwargs):
        with self._lock:
            return build(self, *args, **kwargs)
    return locked


class BatchContext:
    """Host+device state for one batch of sealed segments."""

    MAX_MV_K = 16  # (S, L, K) id blocks cost K x an SV column of HBM

    def __init__(self, segments: list, device, pad_multiple: int = 1024):
        self.segments = list(segments)
        self.device = torch.device(device)
        # a whole number of zone blocks, as in the reference, so the
        # planes (and the kernels' shapes) are the same
        pad_multiple = max(pad_multiple, ZONE_BLOCK_ROWS)
        self.pad_to = max(padded_len(s.n_docs, pad_multiple)
                          for s in self.segments)
        self.S = len(self.segments)
        self.n_docs = np.array([s.n_docs for s in self.segments],
                               dtype=np.int32)
        self.n_docs_dev = to_device(self.n_docs, self.device)
        self._columns: dict[str, torch.Tensor] = {}
        self._decoded: dict[str, torch.Tensor] = {}
        self._prehashed: dict[str, torch.Tensor] = {}
        self._sorted_hll: dict[tuple, torch.Tensor] = {}
        self._encodings: dict[str, str] = {}
        self._global_dicts: dict[str, Dictionary] = {}
        self._plans: dict[str, ColPlan] = {}
        self._zone_maps: dict[str, tuple] = {}
        self._mv_columns: dict[str, torch.Tensor] = {}
        self._mv_entries: dict[str, MVPlanes] = {}
        self._evolved: dict[str, list] = {}
        self._derived: dict = {}
        # the builders below run under this lock; resident_bytes grows
        # under it and is read without it (the executor's LRU sums it)
        self._lock = threading.RLock()
        self.resident_bytes = 0
        self.narrow_saved_bytes = 0
        # sampled once: a cached batch's plans never shift mid-life
        self._subbyte = os.environ.get("PINOT_TPU_SUBBYTE", "") \
            not in ("", "0")

    # ---- column access ---------------------------------------------------
    def column_meta(self, name: str):
        for s in self.segments:
            if name in s.metadata.columns:
                return s.column_metadata(name)
        raise DeviceUnsupported(f"unknown column {name}")

    @_locked
    def encoding(self, name: str) -> str:
        """The batch's encoding of a column: the one every segment that
        stores it has; a single-value column the other segments predate
        (``evolved``) reads as theirs, or as a dict column of its default
        where no segment stores it."""
        if name not in self._encodings:
            metas = [s.column_metadata(name) for s in self.segments
                     if name in s.metadata.columns]
            if len(metas) < self.S:
                self.evolved(name)
            if not metas:
                self._encodings[name] = Encoding.DICT
                return Encoding.DICT
            enc = metas[0].encoding
            if any(m.encoding != enc for m in metas):
                raise DeviceUnsupported(f"mixed encodings for {name}")
            if any(not m.single_value for m in metas):
                raise DeviceUnsupported(f"multi-value column {name}")
            self._encodings[name] = enc
        return self._encodings[name]

    @_locked
    def evolved(self, name: str) -> list:
        """Per segment, the default a single-value column reads as in a
        segment that predates it (the table schema's
        ``FieldSpec.null_value()``, as a 0-d array), None where the
        segment stores it. An unknown column raises, as in the
        reference."""
        if name not in self._evolved:
            out = []
            for s in self.segments:
                if name in s.metadata.columns:
                    out.append(None)
                    continue
                spec = evolved_spec(s, name)
                if spec is None:
                    raise KeyError(f"column {name!r} not found")
                if not spec.single_value:
                    raise DeviceUnsupported(
                        f"column {name} is multi-value in some segments")
                out.append(np.asarray(spec.null_value()))
            self._evolved[name] = out
        return self._evolved[name]

    def _forward(self, s, i: int, name: str) -> np.ndarray:
        """Segment ``i``'s forward index of ``name``: its default where the
        segment predates the column (id 0 of ``_dictionary``'s one-value
        dictionary for a dict column, else the value)."""
        if name in s.metadata.columns:
            return np.asarray(s.forward(name))
        if self.encoding(name) == Encoding.DICT:
            return np.zeros(s.n_docs, dtype=np.int32)
        return np.full(s.n_docs, self.evolved(name)[i],
                       dtype=self.raw_dtype(name))

    def _dictionary(self, s, i: int, name: str):
        if name in s.metadata.columns:
            return s.dictionary(name)
        return Dictionary(self.evolved(name)[i].reshape(1))

    def raw_dtype(self, name: str) -> np.dtype:
        """The stored dtype of a raw column's values (its default, where a
        segment predates it, fits: planes keep this dtype)."""
        for s in self.segments:
            if name in s.metadata.columns:
                return np.asarray(s.forward(name)).dtype
        raise DeviceUnsupported(f"unknown column {name}")

    def device_encoding(self, name: str):
        """``encoding`` where the reference's device has one (a column
        every segment stores single-value, in one encoding), else None."""
        metas = [s.column_metadata(name) for s in self.segments
                 if name in s.metadata.columns]
        encs = {m.encoding for m in metas}
        if len(metas) < self.S or len(encs) != 1 \
                or any(not m.single_value for m in metas):
            return None
        return encs.pop()

    # ---- multi-value columns ---------------------------------------------
    def is_mv(self, name: str) -> bool:
        """Whether every segment stores ``name`` multi-value (the
        reference's check: a segment without the column refuses)."""
        for s in self.segments:
            if name not in s.metadata.columns:
                spec = evolved_spec(s, name)
                if spec is None:
                    raise DeviceUnsupported(
                        f"column {name} missing from {s.name}")
                if spec.single_value:
                    return False
            elif s.column_metadata(name).single_value:
                return False
        return True

    def mv_on_device(self, name: str) -> bool:
        """Whether ``mv_column`` has the reference device's form of
        ``name``: multi-value and dict-encoded in every segment, with 1 to
        ``MAX_MV_K`` entries a doc at most."""
        metas = []
        for s in self.segments:
            if name not in s.metadata.columns:
                return False
            m = s.column_metadata(name)
            if m.single_value or m.encoding != Encoding.DICT:
                return False
            metas.append(m)
        return 0 < max(m.max_mv_entries for m in metas) <= self.MAX_MV_K

    @_locked
    def mv_column(self, name: str) -> torch.Tensor:
        """(S, L, K) device int32 GLOBAL dict ids of an MV column, entries
        padded with -1 (K = the batch's most entries a doc): the device
        form of getDictIdMV, over which predicates evaluate per entry and
        reduce match-any over K (``mv_any``)."""
        if name not in self._mv_columns:
            if not self.mv_on_device(name):
                raise DeviceUnsupported(
                    f"MV column {name}: raw, or 0 or more than "
                    f"{self.MAX_MV_K} entries a doc")
            K = max(s.column_metadata(name).max_mv_entries
                    for s in self.segments)
            gdict = self.global_dict(name)
            blocks = np.full((self.S, self.pad_to, K), -1, dtype=np.int32)
            for i, s in enumerate(self.segments):
                remap = np.searchsorted(
                    gdict.values, np.asarray(s.dictionary(name).values)
                ).astype(np.int32)
                fwd = np.asarray(s.forward(name))
                off = np.asarray(s.mv_offsets(name))
                lens = np.diff(off)
                doc = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
                rank = np.arange(len(fwd), dtype=np.int64) \
                    - np.repeat(off[:-1], lens)
                blocks[i, doc, rank] = remap[fwd]
            self._upload(self._mv_columns, name, blocks)
        return self._mv_columns[name]

    @_locked
    def mv_entries(self, name: str, evolved_dtype=None) -> MVPlanes:
        """Every entry of an MV column (``MVPlanes``), for the host path's
        shape: a dict column's entries as global ids, a raw one's as its
        stored values. A segment without the column (schema-evolved,
        ``evolved_dtype`` its values' dtype) has no entries."""
        if name not in self._mv_entries:
            have = [name in s.metadata.columns for s in self.segments]
            metas = [s.column_metadata(name)
                     for s, h in zip(self.segments, have) if h]
            if any(m.single_value for m in metas):
                raise DeviceUnsupported(
                    f"column {name} is single-value in some segments")
            encs = {m.encoding for m in metas}
            if len(encs) > 1:
                raise DeviceUnsupported(f"mixed encodings for {name}")
            is_dict = encs == {Encoding.DICT}
            gdict = self.global_dict(name) if is_dict else None
            per_seg, offs = [], []
            for s, h in zip(self.segments, have):
                if not h:
                    per_seg.append(None)
                    offs.append(np.zeros(s.n_docs + 1, dtype=np.int64))
                    continue
                off = np.asarray(s.mv_offsets(name)).astype(np.int64)
                fwd = np.asarray(s.forward(name))[: off[-1]]
                if is_dict:
                    remap = np.searchsorted(
                        gdict.values, np.asarray(s.dictionary(name).values)
                    ).astype(np.int32)
                    fwd = remap[fwd]
                per_seg.append(fwd)
                offs.append(off)
            if is_dict:
                vdt, host_dt = np.dtype(np.int32), np.asarray(
                    gdict.values).dtype
            else:
                present = [v for v in per_seg if v is not None]
                host_dt = present[0].dtype if present \
                    else np.dtype(evolved_dtype)
                if host_dt.kind not in _NUMERIC_KINDS:
                    raise DeviceUnsupported(
                        f"raw MV column {name} of {host_dt} values")
                vdt = host_dt
            total = np.asarray([o[-1] for o in offs], dtype=np.int64)
            empty = np.asarray([len(o) == 1 or bool((np.diff(o) == 0).any())
                                for o in offs])
            E = max(int(total.max()), 1)
            vals = np.zeros((self.S, E), dtype=vdt)
            doc = np.full((self.S, E), -1, dtype=np.int32)
            lens = np.zeros((self.S, self.pad_to), dtype=np.int32)
            start = np.zeros((self.S, self.pad_to), dtype=np.int32)
            for i, (v, off) in enumerate(zip(per_seg, offs)):
                n = len(off) - 1
                ln = np.diff(off)
                lens[i, :n] = ln
                start[i, :n] = off[:-1]
                if v is not None and len(v):
                    vals[i, : len(v)] = v
                    doc[i, : len(v)] = np.repeat(
                        np.arange(n, dtype=np.int32), ln)
            planes = {}
            for key, arr in (("v", vals), ("d", doc), ("n", lens),
                             ("s", start)):
                self._upload(planes, key, arr)
            self._mv_entries[name] = MVPlanes(
                planes["v"], planes["d"], planes["n"], planes["s"],
                "dict" if is_dict else "num", host_dt, total, empty)
        return self._mv_entries[name]

    # ---- width planning (ColPlan) ---------------------------------------
    @_locked
    def width_plan(self, key: str) -> ColPlan:
        """Device storage plan for a cols key (bare column name or
        "dv::name")."""
        plan = self._plans.get(key)
        if plan is None:
            if key.startswith("dv::"):
                plan = self._plan_decoded(key[4:])
            elif self.encoding(key) == Encoding.DICT:
                plan = self._plan_dict(key)
            else:
                plan = self._plan_raw(key)
            self._plans[key] = plan
        return plan

    def _plan_dict(self, name: str) -> ColPlan:
        C = len(self.global_dict(name))
        # sub-byte tiers reserve the pad sentinel C inside the bit width
        if self._subbyte and C <= 3:
            return ColPlan(np.dtype(np.uint8).str, bits=2)
        if self._subbyte and C <= 15:
            return ColPlan(np.dtype(np.uint8).str, bits=4)
        if C <= 255:  # ids 0..C-1, pad C: C == 255 still fits uint8
            return ColPlan(np.dtype(np.uint8).str)
        if C <= 65535:
            return ColPlan(np.dtype(np.uint16).str)
        return ColPlan(np.dtype(np.int32).str)

    def _plan_raw(self, name: str) -> ColPlan:
        base = np.dtype(RAW_DEVICE_DTYPES[self.column_meta(name).data_type])
        if base.kind == "f":
            return ColPlan(base.str)
        b = self.exact_int_bounds(name)
        if b is None:
            return ColPlan(base.str)
        return _int_for_plan(b[0], b[1], base)

    def _plan_decoded(self, name: str) -> ColPlan:
        if self.encoding(name) != Encoding.DICT:
            return self.width_plan(name)  # dv:: of RAW aliases raw
        per_seg = [np.asarray(self._dictionary(s, i, name).values)
                   for i, s in enumerate(self.segments)]
        if any(v.dtype.kind == "f" for v in per_seg):
            return ColPlan(np.dtype(np.float32).str)
        base = np.dtype(np.int64) if any(v.dtype.itemsize == 8
                                         for v in per_seg) \
            else np.dtype(np.int32)
        if not any(len(v) for v in per_seg):
            return ColPlan(base.str)
        # dictionaries are sorted: batch bounds are the edge values
        lo = min(int(v[0]) for v in per_seg if len(v))
        hi = max(int(v[-1]) for v in per_seg if len(v))
        return _int_for_plan(lo, hi, base)

    def exact_int_bounds(self, name: str):
        """(min, max) as exact python ints from segment metadata, or None."""
        mns, mxs = [], []
        for i, s in enumerate(self.segments):
            if name not in s.metadata.columns:   # evolved: its default
                d = self.evolved(name)[i].item()
                lo = hi = d
            else:
                m = s.column_metadata(name)
                lo, hi = m.min_value, m.max_value
            if not isinstance(lo, (int, np.integer)) \
                    or not isinstance(hi, (int, np.integer)):
                return None
            mns.append(int(lo))
            mxs.append(int(hi))
        return (min(mns), max(mxs)) if mns else None

    def _upload(self, store: dict, key, blocks):
        store[key] = blocks if isinstance(blocks, torch.Tensor) \
            else to_device(blocks, self.device)
        self.resident_bytes += store[key].numel() * store[key].element_size()
        return store[key]

    def host_column(self, name: str) -> tuple:
        """((S, L) host array at the column's planned width, (S, NB) zone
        lo, (S, NB) zone hi): global dict ids (DICT — pad C on unsigned
        planes, -1 on int32) or raw values (RAW — frame-of-reference
        storage when the plan has an offset, pad 0), and their per-block
        min/max in the same space."""
        plan = self.width_plan(name)
        sdt = np.dtype(plan.dtype)
        zlo, zhi = self._zone_fills(sdt)
        if self.encoding(name) == Encoding.DICT:
            gdict = self.global_dict(name)
            pad = len(gdict) if sdt.kind == "u" else -1
            blocks = np.full((self.S, self.pad_to), pad, dtype=sdt)
            for i, s in enumerate(self.segments):
                remap = np.searchsorted(
                    gdict.values,
                    np.asarray(self._dictionary(s, i, name).values)
                ).astype(np.int32)
                fwd = self._forward(s, i, name)
                gids = remap[fwd]
                blocks[i, : len(fwd)] = gids
                zm = self._reader_zone_map(s, name, len(fwd))
                # local->global id remap is monotone (both dictionaries
                # are sorted), so per-block min/max ids survive it
                z = remap[zm] if zm is not None else build_zone_map(gids)
                zlo[i, : z.shape[1]] = z[0]
                zhi[i, : z.shape[1]] = z[1]
            return blocks, zlo, zhi
        off = plan.offset or 0
        blocks = np.zeros((self.S, self.pad_to), dtype=sdt)
        for i, s in enumerate(self.segments):
            fwd = self._forward(s, i, name)
            blocks[i, : len(fwd)] = (fwd.astype(np.int64) - off).astype(sdt) \
                if off else fwd.astype(sdt)
            zm = self._reader_zone_map(s, name, s.n_docs)
            if zm is not None:
                # FOR storage space, as the plane: narrowing is monotone
                z = (zm.astype(np.int64) - off).astype(sdt) if off \
                    else zm.astype(sdt)
            else:
                z = build_zone_map(blocks[i, : s.n_docs])
            zlo[i, : z.shape[1]] = z[0]
            zhi[i, : z.shape[1]] = z[1]
        return blocks, zlo, zhi

    def column(self, name: str) -> torch.Tensor:
        """(S, L) device tensor of ``host_column``; its zone map is
        uploaded with it. A sub-byte plan's plane is held packed and
        unpacked here, by torch ops, at every read."""
        plane = self.packed_column(name)
        plan = self.width_plan(name)
        if plan.bits:
            return mask_ops.unpack_subbyte(plane, plan.bits)
        return plane

    @_locked
    def packed_column(self, name: str) -> torch.Tensor:
        """The plane ``column`` reads, as the card holds it: a sub-byte
        plan's (S, L * bits // 8) packed bytes, else the plane itself."""
        if name not in self._columns:
            blocks, zlo, zhi = self.host_column(name)
            plan = self.width_plan(name)
            if plan.bits:
                blocks = _pack_subbyte_np(blocks, plan.bits)
            self._upload(self._columns, name, blocks)
            self._store_zone_map(name, zlo, zhi)
            wide = 4 if self.encoding(name) == Encoding.DICT else np.dtype(
                RAW_DEVICE_DTYPES[self.column_meta(name).data_type]).itemsize
            self._note_saved(wide, self._columns[name],
                             *self._zone_maps[name])
        return self._columns[name]

    def _note_saved(self, wide_item: int, *planes) -> None:
        """Bytes the width plan saved against the wide layout of a plane
        and its two zone planes (``wide_item`` bytes a value)."""
        nb = self.pad_to // ZONE_BLOCK_ROWS
        wide = wide_item * self.S * (self.pad_to + 2 * nb)
        actual = sum(t.numel() * t.element_size() for t in planes)
        self.narrow_saved_bytes += max(wide - actual, 0)

    # ---- zone maps (the block-skip verdict's basis, ops/blockskip.py) ----
    def _zone_fills(self, dtype):
        """(S, NB) lo/hi arrays pre-filled with never-match sentinels (lo =
        dtype max, hi = dtype min) so padding blocks past a segment's data
        satisfy no interval predicate."""
        nb = self.pad_to // ZONE_BLOCK_ROWS
        dtype = np.dtype(dtype)
        info = np.iinfo(dtype) if dtype.kind in ("i", "u") \
            else np.finfo(dtype)
        return (np.full((self.S, nb), info.max, dtype=dtype),
                np.full((self.S, nb), info.min, dtype=dtype))

    @staticmethod
    def _reader_zone_map(seg, name: str, n: int):
        """The segment's (2, n_blocks) zone map (``<col>.zmap.npy``), or
        None → recompute from the column block (segments written before
        the format carried zone maps, or at another granularity)."""
        fn = getattr(seg, "zone_map", None)
        if fn is None or name not in seg.metadata.columns:
            return None
        try:
            zm = fn(name)
        except Exception:  # noqa: BLE001 — corrupt file: recompute instead
            return None
        if zm is None:
            return None
        zm = np.asarray(zm)
        if zm.shape != (2, -(-n // ZONE_BLOCK_ROWS)):
            return None  # stale granularity: recompute
        return zm

    def _store_zone_map(self, key: str, zlo, zhi) -> None:
        pair = (to_device(zlo, self.device), to_device(zhi, self.device))
        self.resident_bytes += sum(z.numel() * z.element_size() for z in pair)
        self._zone_maps[key] = pair

    @_locked
    def zone_map(self, key: str) -> tuple:
        """((S, NB) lo, (S, NB) hi) device zone tensors for a cols key
        (bare name → global dict ids or raw storage values; "dv::name" →
        decoded storage values), uploading the backing plane on first
        use."""
        if key not in self._zone_maps:
            if key.startswith("dv::"):
                self.decoded_column(key[4:])
            else:
                self.column(key)
        return self._zone_maps[key]

    @_locked
    def global_dict(self, name: str) -> Dictionary:
        """Sorted union of per-segment dictionary values (global id space;
        a schema-evolved multi-value column's segments without it hold no
        value, a single-value one's its default)."""
        if name not in self._global_dicts:
            vals = []
            for i, s in enumerate(self.segments):
                if name not in s.metadata.columns:
                    spec = evolved_spec(s, name)
                    if spec is not None and spec.single_value:
                        vals.append(self.evolved(name)[i].reshape(1))
                    continue
                d = s.dictionary(name)
                if d is None:
                    raise DeviceUnsupported(f"column {name} lacks a dictionary")
                vals.append(np.asarray(d.values))
            if not vals:
                raise DeviceUnsupported(f"unknown column {name}")
            self._global_dicts[name] = Dictionary(
                np.unique(np.concatenate(vals)))
        return self._global_dicts[name]

    def cardinality(self, name: str) -> int:
        return len(self.global_dict(name))

    @_locked
    def decoded_column(self, name: str) -> torch.Tensor:
        """(S, L) device tensor of DECODED numeric values for a dict column,
        gathered through the dictionary on the host at upload (the device
        never gathers), at the ``dv::`` plan's width."""
        if self.encoding(name) != Encoding.DICT:
            return self.column(name)
        if name not in self._decoded:
            per_seg = []
            for i, s in enumerate(self.segments):
                vals = np.asarray(self._dictionary(s, i, name).values)
                if vals.dtype.kind not in _NUMERIC_KINDS:
                    raise DeviceUnsupported(
                        f"non-numeric dict column {name} in expression")
                per_seg.append(vals)
            plan = self.width_plan("dv::" + name)
            sdt = np.dtype(plan.dtype)
            off = plan.offset or 0
            blocks = np.zeros((self.S, self.pad_to), dtype=sdt)
            zlo, zhi = self._zone_fills(sdt)
            for i, (s, vals) in enumerate(zip(self.segments, per_seg)):
                fwd = self._forward(s, i, name)
                lut = (vals.astype(np.int64) - off).astype(sdt) if off \
                    else vals.astype(sdt)
                blocks[i, : len(fwd)] = lut[fwd]
                zm = self._reader_zone_map(s, name, len(fwd))
                # id zone → value zone through the sorted dictionary (id
                # order == value order)
                z = lut[zm] if zm is not None \
                    else build_zone_map(blocks[i, : len(fwd)])
                zlo[i, : z.shape[1]] = z[0]
                zhi[i, : z.shape[1]] = z[1]
            self._upload(self._decoded, name, blocks)
            self._store_zone_map("dv::" + name, zlo, zhi)
            wide = 8 if any(v.dtype.itemsize == 8 for v in per_seg) else 4
            self._note_saved(wide, self._decoded[name],
                             *self._zone_maps["dv::" + name])
        return self._decoded[name]

    @_locked
    def exact_column(self, name: str) -> torch.Tensor:
        """(S, L) device tensor of a raw column's values at their STORED
        dtype (a raw DOUBLE as float64, where ``column`` holds float32),
        uploaded at first use: selection, ORDER BY, DISTINCT and group
        keys read the values the host path reads (engine/values.py)."""
        key = "x64::" + name
        if key not in self._decoded:
            blocks = np.zeros((self.S, self.pad_to),
                              dtype=self.raw_dtype(name))
            for i, s in enumerate(self.segments):
                fwd = self._forward(s, i, name)
                blocks[i, : len(fwd)] = fwd
            self._upload(self._decoded, key, blocks)
        return self._decoded[key]

    @_locked
    def prehashed_column(self, name: str) -> torch.Tensor:
        """(S, L) device int32 bit view of per-doc canonical value hashes
        (ops/hll.py ``hash32_np``, the hash the host register build
        applies to the values) for DISTINCTCOUNTHLL: of each segment's
        dictionary, gathered through the forward index, or of a raw
        column's stored values, on the host at upload. Padding docs hash
        to 0 and are masked."""
        if name not in self._prehashed:
            raw = self.encoding(name) != Encoding.DICT
            blocks = np.zeros((self.S, self.pad_to), dtype=np.uint32)
            for i, s in enumerate(self.segments):
                fwd = self._forward(s, i, name)
                if raw:
                    blocks[i, : len(fwd)] = hll_ops.hash32_np(fwd)
                    continue
                h = hll_ops.hash32_np(
                    np.asarray(self._dictionary(s, i, name).values))
                blocks[i, : len(fwd)] = h[fwd]
            self._upload(self._prehashed, name, blocks.view(np.int32))
        return self._prehashed[name]

    def bytes_width(self, name: str) -> int:
        """Fixed byte width of a BYTES dict column's values (0 = not a
        fixed-width bytes column)."""
        widths = set()
        for s in self.segments:
            d = s.dictionary(name)
            if d is None:
                return 0
            dt = np.asarray(d.values).dtype
            if dt.kind != "S":
                return 0
            widths.add(dt.itemsize)
        return widths.pop() if len(widths) == 1 else 0

    @_locked
    def bytes_plane_column(self, name: str) -> torch.Tensor:
        """(S, L, W) device uint8 tensor of the raw bytes of a fixed-width
        BYTES dict column (HLLMERGE's pre-aggregated register planes),
        gathered per doc through each segment's dictionary on the host at
        upload, as ``decoded_column`` is. Padding docs hold zeros."""
        key = "bp::" + name
        if key not in self._decoded:
            W = self.bytes_width(name)
            if W == 0:
                raise DeviceUnsupported(
                    f"column {name} is not a fixed-width BYTES dict column")
            blocks = np.zeros((self.S, self.pad_to, W), dtype=np.uint8)
            for i, s in enumerate(self.segments):
                vals = np.asarray(s.dictionary(name).values)
                planes = vals.view(np.uint8).reshape(len(vals), W)
                fwd = np.asarray(s.forward(name))
                blocks[i, : len(fwd)] = planes[fwd]
            self._upload(self._decoded, key, blocks)
        return self._decoded[key]

    @_locked
    def sorted_hll_keys(self, group_cols, group_cards, hash_col: str,
                        log2m: int) -> torch.Tensor:
        """(S * L,) device int32: the SORTED packed ``slot << 5 | rho``
        keys of the filterless HLL group-by over these group columns,
        slot = gid * m + idx, padding docs on the overflow slot G * m.
        Built by the first query of the shape and cached with the batch,
        as the reference's sorted projection is; later queries skip the
        sort."""
        key = (tuple(group_cols), tuple(group_cards), hash_col, int(log2m))
        if key not in self._sorted_hll:
            num_groups = 1
            for c in group_cards:
                num_groups *= int(c)
            m = 1 << log2m
            h = self.prehashed_column(hash_col)
            valid = mask_ops.valid_mask(self.n_docs_dev, h.shape[1])
            gid = agg_ops.group_ids_combine(
                [self.column(c) for c in group_cols], group_cards, valid,
                num_groups)
            idx, rho = hll_ops.hll_idx_rho(h, log2m)
            slot = torch.where(valid, gid * m + idx, num_groups * m)
            k32 = (slot.reshape(-1) << 5) | rho.reshape(-1)
            self._upload(self._sorted_hll, key, torch.sort(k32).values)
        return self._sorted_hll[key]

    @_locked
    def null_plane(self, name: str) -> torch.Tensor:
        """(S, L) device bool: the docs where ``name`` is null, as the
        host path reads them (engine/host.py there): each segment's null
        vector (``ImmutableSegment.null_vector``; a column without one is
        never null), every doc of a segment that predates the column
        (schema-evolved); an unknown column raises. Uploaded once a
        batch."""
        key = "nv::" + name
        if key not in self._decoded:
            blocks = np.zeros((self.S, self.pad_to), dtype=bool)
            for i, s in enumerate(self.segments):
                if name not in s.metadata.columns:
                    if evolved_spec(s, name) is None:
                        raise KeyError(f"column {name!r} not found")
                    blocks[i, : s.n_docs] = True
                    continue
                nv = s.null_vector(name)
                if nv is not None:
                    nv = np.asarray(nv)[: s.n_docs]
                    blocks[i, : len(nv)] = nv
            self._upload(self._decoded, key, blocks)
        return self._decoded[key]

    @_locked
    def derived(self, key, build):
        """Device tensors derived on the host from the batch's
        dictionaries (``build()``: a tensor or a tuple of them), built at
        first use and held with the batch."""
        if key not in self._derived:
            out = build()
            self._derived[key] = out
            for t in out if isinstance(out, tuple) else (out,):
                self.resident_bytes += t.numel() * t.element_size()
        return self._derived[key]

    def int_bounds(self, name: str):
        """(min, max) over the batch from column metadata, or None."""
        mns, mxs = [], []
        for i, s in enumerate(self.segments):
            if name not in s.metadata.columns:   # evolved: its default
                d = self.evolved(name)[i].item()
                mns.append(d)
                mxs.append(d)
                continue
            m = s.column_metadata(name)
            if m.min_value is None or m.max_value is None:
                return None
            mns.append(m.min_value)
            mxs.append(m.max_value)
        try:
            return float(min(mns)), float(max(mxs))
        except (TypeError, ValueError):
            return None


class ShardContext(BatchContext):
    """One mesh shard of a batch (parallel/mesh.py): the planes of the
    batch's segments ``lo:hi``, built from those segments alone on the
    shard's own device, at the batch's row length. Global dictionaries,
    encodings, width plans and metadata bounds are the batch's
    (``parent``'s), so ids, plane dtypes and frame-of-reference offsets
    agree on every shard. Its uploads count in the parent's resident
    bytes too, where the batch LRU reads them: each plane once."""

    def __init__(self, parent: BatchContext, lo: int, hi: int, device):
        super().__init__(parent.segments[lo:hi], device)
        self.parent, self.lo, self.hi = parent, lo, hi
        self.pad_to = parent.pad_to
        self.lookup_resolver = getattr(parent, "lookup_resolver", None)

    def encoding(self, name: str) -> str:
        return self.parent.encoding(name)

    def global_dict(self, name: str) -> Dictionary:
        return self.parent.global_dict(name)

    def cardinality(self, name: str) -> int:
        return self.parent.cardinality(name)

    def width_plan(self, key: str) -> ColPlan:
        return self.parent.width_plan(key)

    def exact_int_bounds(self, name: str):
        return self.parent.exact_int_bounds(name)

    def int_bounds(self, name: str):
        return self.parent.int_bounds(name)

    def raw_dtype(self, name: str) -> np.dtype:
        return self.parent.raw_dtype(name)

    def column_meta(self, name: str):
        return self.parent.column_meta(name)

    def bytes_width(self, name: str) -> int:
        return self.parent.bytes_width(name)

    @property
    def resident_bytes(self) -> int:
        return self._own_bytes

    @resident_bytes.setter
    def resident_bytes(self, value: int) -> None:
        delta = value - getattr(self, "_own_bytes", 0)
        self._own_bytes = value
        parent = getattr(self, "parent", None)
        if delta and parent is not None:
            with parent._lock:
                parent.resident_bytes += delta


# ---------------------------------------------------------------------------
# filter template + params
# ---------------------------------------------------------------------------

DEVICE_PRED_TYPES = {
    PredicateType.EQ,
    PredicateType.NOT_EQ,
    PredicateType.IN,
    PredicateType.NOT_IN,
    PredicateType.RANGE,
    PredicateType.LIKE,
    PredicateType.REGEXP_LIKE,
}


def stored_column(name: str, ctx: BatchContext) -> bool:
    """A column every segment of the batch stores (not a virtual one)."""
    return not name.startswith("$") and all(
        name in s.metadata.columns for s in ctx.segments)


def expr_on_device(e: Expression, ctx: BatchContext) -> bool:
    """Whether ``build_expr`` has a device form for ``e``: numeric
    literals, stored columns (a dict column of numbers), and functions
    with a device form over them."""
    if e.is_literal:
        # an integer past uint64 or below int64 is numpy's object: the
        # JAX package's device has no form for it
        return not (isinstance(e.value, str) or e.value is None) \
            and np.asarray(e.value).dtype.kind in "biuf"
    if e.is_identifier:
        if not stored_column(e.name, ctx):
            return False
        enc = ctx.device_encoding(e.name)
        return enc == Encoding.RAW or enc == Encoding.DICT and np.asarray(
            ctx.global_dict(e.name).values).dtype.kind in _NUMERIC_KINDS
    if not get_function(e.name).device_form(e.args):
        return False
    args = e.args[:1] if e.name == "cast" else e.args
    return all(expr_on_device(a, ctx) for a in args)


def filter_on_device(f: FilterNode, ctx: BatchContext) -> bool:
    """Whether ``build_filter`` has a device form for every predicate of
    ``f``: a dict column's predicate, an MV column's in ``mv_column``'s
    form, or a numeric comparison of an expression with a device form."""
    if f.type is not FilterNodeType.PREDICATE:
        return all(filter_on_device(c, ctx) for c in f.children or ())
    p = f.predicate
    if p.type not in DEVICE_PRED_TYPES:
        return False
    lhs = p.lhs
    if lhs.is_identifier and stored_column(lhs.name, ctx):
        if ctx.is_mv(lhs.name):
            return ctx.mv_on_device(lhs.name)
        if ctx.device_encoding(lhs.name) == Encoding.DICT:
            return True
    if p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE) \
            or not expr_on_device(lhs, ctx):
        return False
    lits = [p.value] if p.type in (PredicateType.EQ, PredicateType.NOT_EQ) \
        else list(p.values) if p.type in (PredicateType.IN,
                                          PredicateType.NOT_IN) \
        else [0 if x is None else x for x in (p.lower, p.upper)]
    return np.asarray(lits).dtype.kind in "biuf"


def build_filter(f: FilterNode, ctx: BatchContext, params: dict, counter: list,
                 values=None):
    """FilterNode → template (a nested hashable tuple); ``params`` maps
    slot names to device tensors (global id space has no per-segment
    params). ``values``: the host path's shape (engine/values.py
    ``ValueEvaluator``), whose leaves compare the host's values."""
    t = f.type
    if t is FilterNodeType.CONSTANT_TRUE:
        return ("true",)
    if t is FilterNodeType.CONSTANT_FALSE:
        return ("false",)
    if t in (FilterNodeType.AND, FilterNodeType.OR, FilterNodeType.NOT):
        kids = tuple(build_filter(c, ctx, params, counter, values)
                     for c in f.children)
        return (t.value.lower(),) + kids
    return build_predicate(f.predicate, ctx, params, counter, values)


def literal_fits(arr, dtype) -> bool:
    """Whether every value of the literal ``arr`` is one of ``dtype``'s
    (an integer literal past its ends is not)."""
    a = np.asarray(arr)
    dt = np.dtype(dtype)
    if a.dtype.kind not in "biuf":
        return False
    if dt.kind not in "iu" or a.size == 0:
        return True
    info = np.iinfo(dt)
    return all(info.min <= x <= info.max for x in a.reshape(-1).tolist())


def _slot(params: dict, counter: list, arr, device, dtype=None) -> str:
    """A literal as a device tensor: in ``dtype``, which must hold it, or
    as the JAX package uploads it: floats as f32, the device columns'
    dtype, and an integer in [2^63, 2^64) (numpy's uint64) as f64 under
    a key that marks it (ops/masks.py ``UINT64_LITERAL``), so that the
    comparisons and arithmetic promote it as JAX promotes a uint64."""
    if dtype is not None and not literal_fits(arr, dtype):
        raise DeviceUnsupported(f"literal {arr!r} outside {np.dtype(dtype)}")
    a = np.asarray(arr, dtype=dtype)
    prefix = "pr"
    if a.dtype == np.float64 and dtype is None:
        a = a.astype(np.float32)  # device columns are f32
    elif a.dtype == np.uint64 and dtype is None:
        a = a.astype(np.float64)
        prefix = mask_ops.UINT64_LITERAL
    key = f"{prefix}{counter[0]}"
    counter[0] += 1
    if a.dtype.kind not in "biuf":
        raise DeviceUnsupported(f"{a.dtype} literal in a device predicate")
    sig = params.get("__hostsig__")
    if sig is not None:
        # the literal's host bytes, taken before upload, for the
        # executor's partials-cache key (engine/device.py): hashing the
        # device tensor would read it back
        sig.append((key, a.dtype.str, a.shape, a.tobytes()))
    params[key] = to_device(a, device)
    return key


def plane_slot(params: dict, counter: list, plane: torch.Tensor) -> tuple:
    """A value plane the launch computed, as an expression template."""
    key = f"pr{counter[0]}"
    counter[0] += 1
    sig = params.get("__hostsig__")
    if sig is not None:
        # a plane the launch computed has no host bytes: uncacheable
        sig.append((key, None, None, None))
    params[key] = plane
    return ("val", key)


def build_predicate(p: Predicate, ctx: BatchContext, params: dict,
                    counter: list, values=None):
    if values is not None:
        # the host path's shape: value-space leaves where its values are
        # not a dict column's
        leaf = values.predicate_leaf(p, params, counter)
        if leaf is not None:
            return leaf
    if p.type not in DEVICE_PRED_TYPES:
        raise DeviceUnsupported(f"predicate {p.type} not device-supported")
    lhs = p.lhs
    if lhs.is_identifier and ctx.is_mv(lhs.name):
        # match-any over the (S, L, K) id block: the inner template is the
        # dict predicate evaluated per entry; mv_any reduces over K with
        # the -1 padding masked out (NOT_EQ's "not" stays per entry: ANY
        # entry differs from the value)
        if not ctx.mv_on_device(lhs.name):   # raw, or K past the cap
            raise DeviceUnsupported(
                f"MV column {lhs.name}: raw, or 0 or more than "
                f"{ctx.MAX_MV_K} entries a doc")
        key = "mv::" + lhs.name
        return ("mv_any", key, _dict_predicate(p, ctx, params, counter, key))
    if lhs.is_identifier and ctx.encoding(lhs.name) == Encoding.DICT:
        return _dict_predicate(p, ctx, params, counter)
    # raw column or expression lhs: evaluate on device, compare in raw space
    return raw_predicate(p, build_expr(lhs, ctx, params, counter), params,
                         counter, ctx.device)


def _dict_predicate(p: Predicate, ctx: BatchContext, params: dict,
                    counter: list, col_key: str | None = None):
    col = col_key or p.lhs.name
    gdict = ctx.global_dict(p.lhs.name)
    dev = ctx.device
    t = p.type
    if t in (PredicateType.EQ, PredicateType.NOT_EQ):
        gid = gdict.index_of(p.value)
        key = _slot(params, counter, np.int32(gid if gid >= 0 else -2), dev)
        tpl = ("eq_dict", col, key)
        return ("not", tpl) if t is PredicateType.NOT_EQ else tpl
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        k = max(1, len(p.values))
        vec = np.full(k, -2, dtype=np.int32)
        ids = gdict.ids_of(list(p.values))
        vec[: len(ids)] = ids
        key = _slot(params, counter, vec, dev)
        tpl = ("in_dict", col, key, k)
        return ("not", tpl) if t is PredicateType.NOT_IN else tpl
    if t is PredicateType.RANGE:
        lo, hi = gdict.range_ids(
            p.lower, p.upper, p.lower_inclusive, p.upper_inclusive
        )
        klo = _slot(params, counter, np.int32(lo), dev)
        khi = _slot(params, counter, np.int32(hi), dev)
        return ("range_dict", col, klo, khi)
    # LIKE / REGEXP_LIKE: evaluate once per global dictionary entry → LUT
    key = _slot(params, counter, regex_lut(p, ctx), dev)
    return ("lut_dict", col, key)


def _regex_match(p: Predicate, values) -> np.ndarray:
    pat = like_to_regex(p.value) if p.type is PredicateType.LIKE else p.value
    rx = re.compile(pat)
    match = rx.match if p.type is PredicateType.LIKE else rx.search
    vals = np.asarray(values).astype(str)
    return np.fromiter((bool(match(s)) for s in vals), dtype=bool,
                       count=len(vals))


def regex_lut(p: Predicate, ctx: BatchContext) -> np.ndarray:
    """(C,) bool: LIKE / REGEXP_LIKE of a dict column over its global
    dictionary. Where every segment has the trigram (FST-role) index, its
    candidates narrow each segment's dictionary and the pattern runs on
    them alone (engine/host.py ``_regex_indexed_lut`` there); a value of
    the union no segment offers as a candidate cannot match. The LUT is
    the same either way."""
    col = p.lhs.name
    gvals = np.asarray(ctx.global_dict(col).values)
    idxs = []
    for s in ctx.segments:
        try:
            idxs.append(s.fst_index(col))
        except Exception:  # noqa: BLE001 — absent/corrupt index: scan
            idxs.append(None)
    if any(i is None for i in idxs):
        return _regex_match(p, gvals)
    pat = p.value if p.type is not PredicateType.LIKE \
        else like_to_regex(p.value)
    lut = np.zeros(len(gvals), dtype=bool)
    for s, idx in zip(ctx.segments, idxs):
        local = np.asarray(s.dictionary(col).values)
        cand = idx.candidates(pat, len(local))
        sub = local if cand is None else local[cand]
        if len(sub):
            lut[np.searchsorted(gvals, sub)] |= _regex_match(p, sub)
    return lut


def raw_predicate(p: Predicate, expr_tpl, params: dict, counter: list,
                  dev, dtype=None):
    """A comparison of the values ``expr_tpl`` evaluates to with the
    predicate's literals, given as ``dtype`` (default: ``_slot``'s)."""
    t = p.type
    if t in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
        raise DeviceUnsupported("regex over raw (non-dict) column")
    if t in (PredicateType.EQ, PredicateType.NOT_EQ):
        key = _slot(params, counter, p.value, dev, dtype)
        tpl = ("eq_raw", expr_tpl, key)
        return ("not", tpl) if t is PredicateType.NOT_EQ else tpl
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        key = _slot(params, counter, list(p.values), dev, dtype)
        tpl = ("in_raw", expr_tpl, key, len(p.values))
        return ("not", tpl) if t is PredicateType.NOT_IN else tpl
    # RANGE
    klo = _slot(params, counter, 0 if p.lower is None else p.lower, dev,
                dtype)
    khi = _slot(params, counter, 0 if p.upper is None else p.upper, dev,
                dtype)
    return (
        "range_raw",
        expr_tpl,
        klo,
        khi,
        p.lower is not None,
        p.upper is not None,
        p.lower_inclusive,
        p.upper_inclusive,
    )


# ---------------------------------------------------------------------------
# expression templates (device value-space evaluation)
# ---------------------------------------------------------------------------


def build_expr(e: Expression, ctx: BatchContext, params: dict, counter: list):
    if e.is_literal:
        if isinstance(e.value, str) or e.value is None:
            raise DeviceUnsupported("string/null literal in device expression")
        key = _slot(params, counter, np.asarray(e.value), ctx.device)
        return ("lit", key)
    if e.is_identifier:
        if ctx.encoding(e.name) == Encoding.RAW:
            return ("raw", e.name)
        if np.asarray(ctx.global_dict(e.name).values).dtype.kind \
                not in _NUMERIC_KINDS:
            raise DeviceUnsupported(
                f"non-numeric dict column {e.name} in expression")
        return ("dictval", e.name)
    if not get_function(e.name).device_form(e.args):
        raise DeviceUnsupported(f"function {e.name} has no device form for "
                                f"{e}")
    if e.name == "cast":
        arg = build_expr(e.args[0], ctx, params, counter)
        return ("cast", arg, str(e.args[1].value).upper())
    out = (e.name,) + tuple(build_expr(a, ctx, params, counter)
                            for a in e.args)
    if e.name in ("power", "pow") and e.args[1].is_literal:
        # whether the literal exponent is negative, for the integer
        # power's refusal (ops/transform.py ``_torch_power``), read here
        # and not from the device
        out += (bool(np.asarray(e.args[1].value) < 0),)
    return out


# the last entry of a SUM / AVG template's extra where the sum is taken
# in float64, as the reference's host takes it (engine/rows.py, the host
# path's shape): K1's byte planes recombine in float64, float operands
# skip K1's float32 planes, and the torch scatters sum in float64
SUM_F64 = "f64"


def sums_f64(extra) -> bool:
    """Whether a SUM / AVG template's extra says to sum in float64."""
    return bool(extra) and extra[-1] == SUM_F64


def expr_bounds(e: Expression, ctx: BatchContext):
    """Interval arithmetic over column metadata: the value range that
    sizes the integer byte planes. None = unknown."""
    if e.is_literal:
        try:
            v = float(e.value)
            return v, v
        except (TypeError, ValueError):
            return None
    if e.is_identifier:
        return ctx.int_bounds(e.name)
    if not e.is_function:
        return None
    if e.name in ("plus", "minus", "times"):
        a = expr_bounds(e.args[0], ctx)
        b = expr_bounds(e.args[1], ctx)
        if a is None or b is None:
            return None
        if e.name == "plus":
            return a[0] + b[0], a[1] + b[1]
        if e.name == "minus":
            return a[0] - b[1], a[1] - b[0]
        prods = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
        return min(prods), max(prods)
    if e.name == "cast":
        return expr_bounds(e.args[0], ctx)
    if e.name == "abs":
        b = expr_bounds(e.args[0], ctx)
        if b is None:
            return None
        lo = 0.0 if b[0] <= 0 <= b[1] else min(abs(b[0]), abs(b[1]))
        return lo, max(abs(b[0]), abs(b[1]))
    return None
