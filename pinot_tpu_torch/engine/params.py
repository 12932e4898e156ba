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

Zone maps, the sub-byte tier and the prehashed / sorted-HLL projections
come with later slices of the port. Raises ``DeviceUnsupported`` for
anything this slice's device path does not cover; the engine reports it
in the response.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from pinot_tpu_torch.engine.host import like_to_regex
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
from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS, Encoding


class DeviceUnsupported(Exception):
    """Query shape this slice of the port does not run on the device."""


_NUMERIC_KINDS = ("i", "u", "f")


@dataclasses.dataclass(frozen=True)
class ColPlan:
    """Device storage plan for one column plane."""

    dtype: str          # numpy dtype .str of the STORED plane
    bits: int = 0       # sub-byte pack width; always 0 in this slice
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


def to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class BatchContext:
    """Host+device state for one batch of sealed segments."""

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
        self._encodings: dict[str, str] = {}
        self._global_dicts: dict[str, Dictionary] = {}
        self._plans: dict[str, ColPlan] = {}
        self.resident_bytes = 0

    # ---- column access ---------------------------------------------------
    def column_meta(self, name: str):
        for s in self.segments:
            if name in s.metadata.columns:
                return s.column_metadata(name)
        raise DeviceUnsupported(f"unknown column {name}")

    def encoding(self, name: str) -> str:
        if name not in self._encodings:
            metas = []
            for s in self.segments:
                if name not in s.metadata.columns:
                    raise DeviceUnsupported(
                        f"column {name} missing from {s.name}")
                metas.append(s.column_metadata(name))
            enc = metas[0].encoding
            if any(m.encoding != enc for m in metas):
                raise DeviceUnsupported(f"mixed encodings for {name}")
            if any(not m.single_value for m in metas):
                raise DeviceUnsupported(
                    f"multi-value column {name}: multi-value columns come "
                    f"with a later slice of the port")
            self._encodings[name] = enc
        return self._encodings[name]

    # ---- width planning (ColPlan) ---------------------------------------
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
        if C <= 255:  # ids 0..C-1, pad C: C == 255 still fits uint8
            return ColPlan(np.dtype(np.uint8).str)
        if C <= 65535:
            return ColPlan(np.dtype(np.uint16).str)
        return ColPlan(np.dtype(np.int32).str)

    def _plan_raw(self, name: str) -> ColPlan:
        base = np.dtype(RAW_DEVICE_DTYPES[self.column_meta(name).data_type])
        if base.kind == "f":
            return ColPlan(base.str)
        b = self._exact_int_bounds(name)
        if b is None:
            return ColPlan(base.str)
        return _int_for_plan(b[0], b[1], base)

    def _plan_decoded(self, name: str) -> ColPlan:
        if self.encoding(name) != Encoding.DICT:
            return self.width_plan(name)  # dv:: of RAW aliases raw
        per_seg = [np.asarray(s.dictionary(name).values)
                   for s in self.segments]
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

    def _exact_int_bounds(self, name: str):
        """(min, max) as exact python ints from segment metadata, or None."""
        mns, mxs = [], []
        for s in self.segments:
            m = s.column_metadata(name)
            if not isinstance(m.min_value, (int, np.integer)) \
                    or not isinstance(m.max_value, (int, np.integer)):
                return None
            mns.append(int(m.min_value))
            mxs.append(int(m.max_value))
        return (min(mns), max(mxs)) if mns else None

    def _upload(self, store: dict, key: str, blocks: np.ndarray):
        store[key] = to_device(blocks, self.device)
        self.resident_bytes += store[key].numel() * store[key].element_size()
        return store[key]

    def host_column(self, name: str) -> np.ndarray:
        """(S, L) host array at the column's planned width: global dict ids
        (DICT — pad C on unsigned planes, -1 on int32) or raw values
        (RAW — frame-of-reference storage when the plan has an offset,
        pad 0)."""
        plan = self.width_plan(name)
        sdt = np.dtype(plan.dtype)
        if self.encoding(name) == Encoding.DICT:
            gdict = self.global_dict(name)
            pad = len(gdict) if sdt.kind == "u" else -1
            blocks = np.full((self.S, self.pad_to), pad, dtype=sdt)
            for i, s in enumerate(self.segments):
                remap = np.searchsorted(
                    gdict.values, np.asarray(s.dictionary(name).values)
                ).astype(np.int32)
                fwd = np.asarray(s.forward(name))
                blocks[i, : len(fwd)] = remap[fwd]
            return blocks
        off = plan.offset or 0
        blocks = np.zeros((self.S, self.pad_to), dtype=sdt)
        for i, s in enumerate(self.segments):
            fwd = np.asarray(s.forward(name))
            blocks[i, : len(fwd)] = (fwd.astype(np.int64) - off).astype(sdt) \
                if off else fwd.astype(sdt)
        return blocks

    def column(self, name: str) -> torch.Tensor:
        """(S, L) device tensor of ``host_column``."""
        if name not in self._columns:
            self._upload(self._columns, name, self.host_column(name))
        return self._columns[name]

    def global_dict(self, name: str) -> Dictionary:
        """Sorted union of per-segment dictionary values (global id space)."""
        if name not in self._global_dicts:
            vals = []
            for s in self.segments:
                d = s.dictionary(name)
                if d is None:
                    raise DeviceUnsupported(f"column {name} lacks a dictionary")
                vals.append(np.asarray(d.values))
            self._global_dicts[name] = Dictionary(
                np.unique(np.concatenate(vals)))
        return self._global_dicts[name]

    def cardinality(self, name: str) -> int:
        return len(self.global_dict(name))

    def decoded_column(self, name: str) -> torch.Tensor:
        """(S, L) device tensor of DECODED numeric values for a dict column,
        gathered through the dictionary on the host at upload (the device
        never gathers), at the ``dv::`` plan's width."""
        if self.encoding(name) != Encoding.DICT:
            return self.column(name)
        if name not in self._decoded:
            per_seg = []
            for s in self.segments:
                vals = np.asarray(s.dictionary(name).values)
                if vals.dtype.kind not in _NUMERIC_KINDS:
                    raise DeviceUnsupported(
                        f"non-numeric dict column {name} in expression")
                per_seg.append(vals)
            plan = self.width_plan("dv::" + name)
            sdt = np.dtype(plan.dtype)
            off = plan.offset or 0
            blocks = np.zeros((self.S, self.pad_to), dtype=sdt)
            for i, (s, vals) in enumerate(zip(self.segments, per_seg)):
                fwd = np.asarray(s.forward(name))
                lut = (vals.astype(np.int64) - off).astype(sdt) if off \
                    else vals.astype(sdt)
                blocks[i, : len(fwd)] = lut[fwd]
            self._upload(self._decoded, name, blocks)
        return self._decoded[name]

    def int_bounds(self, name: str):
        """(min, max) over the batch from column metadata, or None."""
        mns, mxs = [], []
        for s in self.segments:
            m = s.column_metadata(name)
            if m.min_value is None or m.max_value is None:
                return None
            mns.append(m.min_value)
            mxs.append(m.max_value)
        try:
            return float(min(mns)), float(max(mxs))
        except (TypeError, ValueError):
            return None


# ---------------------------------------------------------------------------
# filter template + params
# ---------------------------------------------------------------------------

_DEVICE_PRED_TYPES = {
    PredicateType.EQ,
    PredicateType.NOT_EQ,
    PredicateType.IN,
    PredicateType.NOT_IN,
    PredicateType.RANGE,
    PredicateType.LIKE,
    PredicateType.REGEXP_LIKE,
}


def build_filter(f: FilterNode, ctx: BatchContext, params: dict, counter: list):
    """FilterNode → template (a nested hashable tuple); ``params`` maps
    slot names to device tensors (global id space has no per-segment
    params)."""
    t = f.type
    if t is FilterNodeType.CONSTANT_TRUE:
        return ("true",)
    if t is FilterNodeType.CONSTANT_FALSE:
        return ("false",)
    if t is FilterNodeType.AND:
        return ("and",) + tuple(build_filter(c, ctx, params, counter)
                                for c in f.children)
    if t is FilterNodeType.OR:
        return ("or",) + tuple(build_filter(c, ctx, params, counter)
                               for c in f.children)
    if t is FilterNodeType.NOT:
        return ("not", build_filter(f.children[0], ctx, params, counter))
    return build_predicate(f.predicate, ctx, params, counter)


def _slot(params: dict, counter: list, arr, device) -> str:
    key = f"pr{counter[0]}"
    counter[0] += 1
    a = np.asarray(arr)
    if a.dtype == np.float64:
        a = a.astype(np.float32)  # device columns are f32
    if a.dtype.kind not in "biuf":
        raise DeviceUnsupported(f"{a.dtype} literal in a device predicate")
    params[key] = to_device(a, device)
    return key


def build_predicate(p: Predicate, ctx: BatchContext, params: dict,
                    counter: list):
    if p.type not in _DEVICE_PRED_TYPES:
        raise DeviceUnsupported(f"predicate {p.type} not device-supported")
    lhs = p.lhs
    if lhs.is_identifier:
        if ctx.encoding(lhs.name) == Encoding.DICT:
            return _dict_predicate(p, ctx, params, counter)
        return _raw_predicate(p, lhs, ctx, params, counter)
    # expression lhs: evaluate on device, compare in raw space
    return _raw_predicate(p, lhs, ctx, params, counter)


def _dict_predicate(p: Predicate, ctx: BatchContext, params: dict,
                    counter: list):
    col = p.lhs.name
    gdict = ctx.global_dict(col)
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
    pat = like_to_regex(p.value) if t is PredicateType.LIKE else p.value
    rx = re.compile(pat)
    match = rx.match if t is PredicateType.LIKE else rx.search
    vals = np.asarray(gdict.values).astype(str)
    lut = np.fromiter((bool(match(s)) for s in vals), dtype=bool,
                      count=len(vals))
    key = _slot(params, counter, lut, dev)
    return ("lut_dict", col, key)


def _raw_predicate(p: Predicate, lhs: Expression, ctx: BatchContext,
                   params: dict, counter: list):
    expr_tpl = build_expr(lhs, ctx, params, counter)
    dev = ctx.device
    t = p.type
    if t in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
        raise DeviceUnsupported("regex over raw (non-dict) column")
    if t in (PredicateType.EQ, PredicateType.NOT_EQ):
        key = _slot(params, counter, np.asarray(p.value), dev)
        tpl = ("eq_raw", expr_tpl, key)
        return ("not", tpl) if t is PredicateType.NOT_EQ else tpl
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        key = _slot(params, counter, np.asarray(list(p.values)), dev)
        tpl = ("in_raw", expr_tpl, key, len(p.values))
        return ("not", tpl) if t is PredicateType.NOT_IN else tpl
    # RANGE
    klo = _slot(params, counter,
                np.asarray(0 if p.lower is None else p.lower), dev)
    khi = _slot(params, counter,
                np.asarray(0 if p.upper is None else p.upper), dev)
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
    fn = get_function(e.name)
    if not fn.device_capable:
        raise DeviceUnsupported(f"function {e.name} has no device form")
    if e.name == "cast":
        arg = build_expr(e.args[0], ctx, params, counter)
        return ("cast", arg, str(e.args[1].value).upper())
    return (e.name,) + tuple(build_expr(a, ctx, params, counter)
                             for a in e.args)


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
