"""Value-space evaluation on the card: the host path's values, as torch ops.

The JAX package answers selection, DISTINCT over anything but dict
columns, group-bys over expressions, raw or virtual columns and the
aggregations its device refuses on its HOST path (numpy over the stored
values, its engine/host.py). The port runs those shapes on the card
(engine/rows.py); this module gives its torch ops that path's values:

- column values at their stored dtype: raw DOUBLE as float64, not the
  float32 the aggregation planes carry; dict columns as the global
  dictionary's values (numbers) or ids (strings, decoded on the host);
- expression dtypes as numpy promotes them, found by running the numpy
  function once over one-row probes (literals as the 0-d arrays the host
  evaluates), then computing each node in that dtype;
- the filter leaves of the host path's shape (``predicate_leaf``, for
  engine/params.py ``build_filter``): the segment names' predicates as a
  mask the host predicate fills, other non-dict ones as their values
  compared in numpy's dtype;
- the virtual columns ``$docId`` (row inside its segment), ``$segmentName``
  and ``$hostName``;
- the host's numEntriesScannedInFilter per segment (``filter_entries``):
  index-served predicates scan nothing, a scan reads every doc once per
  predicate, a multi-value column's predicate every entry, a geo index
  its candidates;
- multi-value columns (``mv_match``): a predicate per entry over the
  column's entries plane (engine/params.py ``mv_entries``), any entry a
  match for its doc, a schema-evolved column with no entry matching
  none; ``SpaceEvaluator`` evaluates over the rows an MV group-by or an
  MV aggregation expands the docs into (engine/rows.py);
- the index-backed filters: JSON_MATCH and TEXT_MATCH through each
  segment's index (a doc set) or over the global dictionary's distinct
  strings (a LUT), ST_DISTANCE through the geo grid's candidates with
  the haversine check on the card (ops/geo.py), and the functions the
  card has no form for over one dict column, each distinct value
  computed once on the host, as a LUT over its ids;
- schema-evolved columns as their default (engine/params.py
  ``BatchContext.evolved``), IS NULL / IS NOT NULL from the null planes;
- the functions whose string literals are parameters: TIMECONVERT and
  DATETIMECONVERT as int64 torch ops, ROUND with a scale, and a string
  result (a date format, CAST to STRING) computed on the host once per
  distinct value, carried as ids;
- the array functions over MV columns (ARRAYLENGTH, the per-doc
  reductions, VALUEIN, MAPVALUE) over the entry planes, with the dtype
  the reference's numpy gives each segment (``Mixed``);
- the function tail: ATAN2, ROUNDDECIMAL / TRUNCATE, GEOTOH3, and
  ST_POINT over two numeric values (a "point" ``Val``: the coordinates
  its WKT text carries, ops/geo.py ``sig10_torch``) with ST_CONTAINS /
  ST_WITHIN against a literal polygon, ST_EQUALS, ST_DISTANCE and
  ST_GEOMETRYTYPE over it, all float64 / int64 torch ops;
- LOOKUP over a dimension table (``_lookup``): the key's distinct
  values factorized on the card, each resolved once through the
  engine's pk map on the host (a miss takes the value column's type
  default), the values gathered back by key id;
- any other function, and a function over strings or mixed kinds (a
  CASE of string and numeric results, INIDSET, LIKE over numbers): its
  numpy form run on the host once per distinct tuple of its operands'
  values, factorized on the card (``_per_tuple``), the result gathered
  back as numbers or carried as ids into its strings.

A shape the reference's host path fails on raises ``DeviceUnsupported``
saying so (``host_fails``).
"""

from __future__ import annotations

import dataclasses
import re
import socket

import numpy as np
import torch

from pinot_tpu_torch.common.pruning import provably_absent
from pinot_tpu_torch.engine.host import like_to_regex
from pinot_tpu_torch.engine.params import (
    DEVICE_PRED_TYPES,
    DeviceUnsupported,
    evolved_spec,
    plane_slot,
    raw_predicate,
    to_device,
)
from pinot_tpu_torch.ops import geo as geo_ops
from pinot_tpu_torch.ops import selection as sel_ops
from pinot_tpu_torch.ops import sketch_build as sb
from pinot_tpu_torch.ops import transform as tf
from pinot_tpu_torch.ops.device_reduce import order_key
from pinot_tpu_torch.ops.transform import _CAST_NP, get_function
from pinot_tpu_torch.query.context import (
    Expression,
    FilterNodeType,
    Predicate,
    PredicateType,
)
from pinot_tpu_torch.storage.segment import Encoding

INVERTED_MAX_IDS = 64  # the host's doc-list bound (engine/host.py there)
VIRTUAL = ("$docId", "$segmentName", "$hostName")
_LOW63 = (1 << 63) - 1
_NAN_KEY = 0x7FF8 << 48   # order_key of NaN: above every number's key
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}
_NULL_PREDS = (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL)


def host_fails(what: str, err: Exception | None = None):
    """The in-band refusal of a shape the reference's host path itself
    fails on: there is no answer to hold the port to (ROADMAP queue 3)."""
    why = f" ({type(err).__name__}: {err})" if err is not None else ""
    return DeviceUnsupported(
        f"{what}: the reference's host path fails on it too{why}, so the "
        f"port refuses it (ROADMAP queue 3)")


@dataclasses.dataclass(frozen=True)
class Mixed:
    """The dtype of a value whose host path dtype differs per segment (the
    MV reductions' empty-row fill, MAPVALUE's miss): ``base`` in a segment
    without the fill, float64 / int64 (the ``Val``'s) where ``filled``;
    the reference's reduce concatenates the segments' arrays, so any
    filled segment among those merged promotes the whole answer."""

    base: np.dtype
    filled: np.ndarray


@dataclasses.dataclass(frozen=True)
class ListMeta:
    """VALUEIN's per-doc lists, coded as one int64 a doc: the kept
    entries' ranks among the sorted wanted ``values`` (1-based) as base
    ``k + 1`` digits, first entry most significant, zero-padded to ``k``
    digits, so that code order is the lists' order. Past 15 values the
    code is a row of ``table``, the (U, k) digit rows in order."""

    values: tuple
    k: int
    table: np.ndarray | None = dataclasses.field(default=None,
                                                 compare=False)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        base = self.k + 1
        uniq, inv = np.unique(np.asarray(codes, dtype=np.int64),
                              return_inverse=True)
        lists = []
        for c in uniq.tolist():
            kept = []
            for i in range(self.k):
                d = int(self.table[c, i]) if self.table is not None \
                    else (c // base ** (self.k - 1 - i)) % base
                if d == 0:
                    break
                kept.append(self.values[d - 1])
            lists.append(kept)
        for j, i in enumerate(inv.reshape(-1).tolist()):
            out[j] = list(lists[i])   # a fresh list per row, as the host's
        return out


def _factorize_tuples(keys: list, valid) -> tuple:
    """((N,) int64 id of each row's key tuple, (U, K) int64 the distinct
    tuples present among the ``valid`` rows (None: all), in key order):
    ops/selection.py ``factorize`` numbering only what is present, by
    one-dimensional uniques; a row outside ``valid`` gets some id in
    range."""
    mask = torch.ones_like(keys[0], dtype=torch.bool) if valid is None \
        else valid
    gid, _G, cols = sel_ops.factorize(keys, mask, None, dense_limit=1)
    return gid, torch.stack(cols, 1)


def np_eval(e: Expression, env: dict):
    """The host path's numpy value of ``e``: identifiers from ``env``
    (e.g. a column's distinct values), functions through their numpy
    form."""
    if e.is_literal:
        return np.asarray(e.value)
    if e.is_identifier:
        return env[e.name]
    fn = get_function(e.name)
    if e.name == "cast":
        return fn.np_fn(np_eval(e.args[0], env), e.args[1].value)
    return fn.np_fn(*[np_eval(a, env) for a in e.args])


def _constant(e: Expression) -> bool:
    return e.is_literal or (e.is_function
                            and all(_constant(a) for a in e.args))


def host_name_of(seg) -> str:
    host = getattr(seg, "host_name", None)
    return str(socket.gethostname() if host is None else host)


# ---------------------------------------------------------------------------
# rows: the whole batch, or gathered flat positions
# ---------------------------------------------------------------------------


class Rows:
    """The rows an evaluation covers: the whole (S, L) batch, or the flat
    positions ``idx`` (int64, ``segment * L + doc``) of some of them."""

    def __init__(self, S: int, L: int, device, idx=None):
        self.S, self.L, self.device, self.idx = S, L, device, idx

    def take(self, plane: torch.Tensor) -> torch.Tensor:
        if self.idx is None:
            return plane
        flat = plane.reshape((self.S * self.L,) + plane.shape[2:])
        # CUDA has no gather for the wide unsigned dtypes: move the bits
        # as the signed dtype of their width
        signed = _SIGNED_VIEW.get(flat.dtype)
        if signed is None:
            return flat[self.idx]
        return flat.view(signed)[self.idx].view(flat.dtype)

    def seg(self) -> torch.Tensor:
        if self.idx is None:
            return torch.arange(self.S, device=self.device)[:, None] \
                .expand(self.S, self.L)
        return self.idx // self.L

    def doc(self) -> torch.Tensor:
        if self.idx is None:
            return torch.arange(self.L, device=self.device)[None, :] \
                .expand(self.S, self.L)
        return self.idx % self.L


@dataclasses.dataclass
class PointMeta:
    """A "point" ``Val``'s latitudes (its ``t`` holds the longitudes),
    and its factorization once ``key`` has made it: the distinct
    (lon, lat) bit pairs, (U, 2) int64 on the card."""

    lat: torch.Tensor
    uniq: torch.Tensor | None = None
    keys: torch.Tensor | None = None


@dataclasses.dataclass
class Val:
    """An evaluated expression. ``kind``: "num" (values at the host
    dtype), "dict" (global ids of the string dict column ``meta``), "seg"
    (segment index, ``$segmentName``), "host" (``$hostName``: zeros),
    "case" (ids into the strings ``meta``), "list" (VALUEIN's codes) or
    "point" (ST_POINT of numbers: longitudes, ``meta`` a ``PointMeta``;
    its text is ``ops/geo.py format_points`` of them)."""

    t: torch.Tensor
    kind: str
    dtype: np.dtype
    meta: object = None


def from_order_key(k: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """The inverse of ``order_key`` into ``dtype`` (floats come back as
    +0.0 for both zeros and one NaN, the values numpy's unique keeps)."""
    if dtype.kind == "f":
        bits = torch.where(k < 0, k ^ _LOW63, k)
        v = bits.view(torch.float64)
    else:
        v = k
    return v.to(_torch_dtype(dtype))


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def _probe_literal(v):
    return np.asarray(v)   # NULL: the host's 0-d object array


# numpy ufunc-style functions computed in their result dtype, after every
# operand is cast to it
_ARITH = {
    "plus": torch.add, "minus": torch.sub, "times": torch.mul,
    "least": torch.minimum, "greatest": torch.maximum,
    "power": torch.pow, "pow": torch.pow,
}
_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "exp": torch.exp, "ln": torch.log,
    "log2": torch.log2, "log10": torch.log10, "sqrt": torch.sqrt,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
}
# rounding: the identity on an integer result dtype
_ROUND = {"ceil": torch.ceil, "floor": torch.floor, "round": torch.round}
_COMPARE = {
    "equals": torch.eq, "not_equals": torch.ne, "greater_than": torch.gt,
    "greater_than_or_equal": torch.ge, "less_than": torch.lt,
    "less_than_or_equal": torch.le,
}
# the array functions over MV columns (ops/transform.py's numpy forms)
_MV_FUNCS = {"arraylength", "cardinality", "arraysum", "arrayaverage",
             "arraymin", "arraymax", "valuein", "mapvalue"}
# the time conversions, whose string literals are parameters
_TIME_FUNCS = {"timeconvert", "datetimeconvert"}
# the functions ``eval`` computes as torch ops; an expression using any
# other over one dict column is computed per distinct value (``_lut``)
_TORCH_FUNCS = set(_ARITH) | set(_UNARY) | set(_ROUND) | set(_COMPARE) \
    | {"divide", "mod", "and", "or", "not", "cast", "case"} | _MV_FUNCS
# the function tail's torch forms over numbers and points
# (``_tail_function``); over anything else, numpy per distinct value
_TAIL_FUNCS = {"atan2", "rounddecimal", "round_decimal", "truncate",
               "geotoh3", "gridcell", "st_point", "st_contains",
               "st_within", "st_equals", "st_distance", "st_geometrytype"}


def numeric_op(e: Expression, t: list, out_dt: np.dtype,
               cmp_dt=None) -> torch.Tensor:
    """The torch form of ``e`` over number operands ``t`` (its arguments'
    tensors, a CAST's first only): arithmetic, division and modulo as
    numpy computes them, the unary functions, comparisons (in numpy's
    promoted dtype ``cmp_dt`` of the operands), boolean logic and a cast
    to a number, each in numpy's result dtype ``out_dt``."""
    tdt = _torch_dtype(out_dt) if out_dt.kind in "biuf" else None
    name = e.name
    if name in _ARITH:
        return _ARITH[name](*[x.to(tdt) for x in t])
    if name == "divide":
        f = [x.to(torch.float64) for x in t]
        return (f[0] / f[1]).to(tdt)
    if name == "mod":
        a, b = (x.to(tdt) for x in t)
        if out_dt.kind == "f":
            # numpy: fmod, then moved to the divisor's sign
            r = torch.fmod(a, b)
            fix = (r != 0) & ((r < 0) != (b < 0))
            return torch.where(fix, r + b, r)
        zero = b == 0
        r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
        return torch.where(zero, torch.zeros_like(r), r)
    if name in _UNARY:
        return _UNARY[name](t[0].to(tdt))
    if name in _COMPARE:
        ct = _torch_dtype(cmp_dt)
        return _COMPARE[name](t[0].to(ct), t[1].to(ct))
    if name in ("and", "or"):
        m = t[0].to(torch.bool)
        for x in t[1:]:
            m = (m & x.to(torch.bool)) if name == "and" \
                else (m | x.to(torch.bool))
        return m
    if name == "not":
        return ~t[0].to(torch.bool)
    # cast to a number
    x = t[0]
    if np.dtype(_CAST_NP[str(e.args[1].value).upper()]).kind in "iu" \
            and x.is_floating_point():
        x = torch.trunc(x.to(torch.float64))
    return x.to(tdt)


def _div_trunc(v: torch.Tensor, d: int) -> torch.Tensor:
    """ops/transform.py ``_div_trunc`` over int64: ``sign(v) * (|v| //
    d)``, with |Long.MIN| wrapping to Long.MIN as numpy's does (so
    Long.MIN ms is 106751991168 DAYS, not the truncated quotient)."""
    if d == 0:
        return torch.zeros_like(v)   # numpy's int // 0
    return torch.sign(v) * torch.div(torch.abs(v), d, rounding_mode="floor")


def _to_millis(v: torch.Tensor, unit: str) -> torch.Tensor:
    f = tf._unit_ms(unit)
    return v * int(f) if f >= 1 else _div_trunc(v, int(round(1 / f)))


def _from_millis(ms: torch.Tensor, unit: str) -> torch.Tensor:
    f = tf._unit_ms(unit)
    return _div_trunc(ms, int(f)) if f >= 1 else ms * int(round(1 / f))


class ValueEvaluator:
    """Host-path values of expressions and filters over a batch."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.S, self.L, self.device = ctx.S, ctx.pad_to, ctx.device
        names = [str(getattr(s, "name", "")) for s in ctx.segments]
        self.seg_names = np.asarray(names)
        # $segmentName keys order by name: each segment's rank among the
        # sorted distinct names
        self.seg_sorted, rank = np.unique(self.seg_names, return_inverse=True)
        self.seg_rank = to_device(rank.astype(np.int64), self.device)
        self.host_names = np.asarray([host_name_of(s) for s in ctx.segments])
        self._gvals: dict = {}
        self._probes: dict = {}
        self._luts: dict = {}
        self._mvfuncs: dict = {}

    # ---- columns -------------------------------------------------------
    def _check_column(self, name: str) -> None:
        """A single-value column in one encoding (a schema-evolved one's
        missing segments read as its default, engine/params.py
        ``BatchContext.evolved``); an unknown column raises KeyError."""
        if self.is_mv(name):
            raise host_fails(f"the multi-value column {name!r} read as a "
                             f"single value")
        self.ctx.encoding(name)

    # ---- multi-value columns ---------------------------------------------
    def is_mv(self, name: str) -> bool:
        """Whether a segment stores ``name`` multi-value, or predates it
        and the table schema makes it multi-value."""
        for s in self.ctx.segments:
            if name in s.metadata.columns:
                if not s.column_metadata(name).single_value:
                    return True
            else:
                spec = evolved_spec(s, name)
                if spec is not None and not spec.single_value:
                    return True
        return False

    def _evolved_dtype(self, name: str):
        """The values' dtype of a column some segment predates, else None."""
        for s in self.ctx.segments:
            spec = evolved_spec(s, name)
            if spec is not None:
                return np.dtype(spec.data_type.np_dtype)
        return None

    def mv(self, name: str):
        """The column's entries (engine/params.py ``MVPlanes``), or None
        where every segment predates it: no entry anywhere."""
        if not any(name in s.metadata.columns for s in self.ctx.segments):
            if self._evolved_dtype(name) is None:
                raise KeyError(f"column {name!r} not found")
            return None
        return self.ctx.mv_entries(name, self._evolved_dtype(name))

    def mv_values(self, name: str) -> Val:
        """The entries of an MV column as a (S, E) ``Val`` (dict columns
        as global ids), with the (S, E) int32 doc of each entry (-1 on
        padding)."""
        mp = self.mv(name)
        if mp is None:
            dt = self._evolved_dtype(name)
            doc = torch.full((self.S, 1), -1, dtype=torch.int32,
                             device=self.device)
            if dt.kind in "USO":
                return Val(torch.zeros_like(doc), "case", dt,
                           np.asarray([""], dtype=dt)), doc
            return Val(torch.zeros((self.S, 1), dtype=_torch_dtype(dt),
                                   device=self.device), "num", dt), doc
        if mp.kind == "dict":
            if mp.dtype.kind in "USO":
                return Val(mp.vals, "dict", mp.dtype, name), mp.doc
            gv = self._dict_values(name)
            ids = torch.clamp(mp.vals.to(torch.int64), 0, gv.shape[0] - 1)
            return Val(gv[ids], "num", mp.dtype), mp.doc
        return Val(mp.vals, "num", mp.dtype), mp.doc

    def mv_hashes(self, name: str) -> torch.Tensor:
        """(S, E) int32 bit view of each entry's canonical value hash (the
        hash the host's register build applies to the values)."""
        from pinot_tpu_torch.ops import hll as hll_ops

        mp = self.mv(name)
        if mp is None:
            return torch.zeros((self.S, 1), dtype=torch.int32,
                               device=self.device)
        if mp.kind == "dict":
            h = hll_ops.hash32_np(np.asarray(
                self.ctx.global_dict(name).values)).view(np.int32)
            hd = to_device(h, self.device)
            return hd[torch.clamp(mp.vals.to(torch.int64), 0,
                                  max(hd.shape[0] - 1, 0))]
        return sb.hash32_values(mp.vals, mp.dtype).to(torch.int32)

    def mv_match(self, p: Predicate) -> torch.Tensor:
        """(S, L) bool: docs with an entry matching ``p`` (engine/host.py
        ``_mv_predicate_mask``: NOT_EQ and NOT IN ask whether an entry
        differs)."""
        from pinot_tpu_torch.engine.device import eval_filter

        name = p.lhs.name
        hit = torch.zeros(self.S * self.L, dtype=torch.bool,
                          device=self.device)
        mp = self.mv(name)
        if mp is None or not mp.total.any():
            return hit.reshape(self.S, self.L)
        if mp.kind == "dict":
            lut = to_device(predicate_over_values(
                p, np.asarray(self.ctx.global_dict(name).values)),
                self.device)
            ent = lut[torch.clamp(mp.vals.to(torch.int64), 0,
                                  max(lut.shape[0] - 1, 0))]
        elif p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE) \
                or self._string_literal(p):
            # numbers by their text: each distinct entry matched once
            ev = Val(mp.vals, "num", mp.dtype)
            ent = self.distinct_lut(
                ev, Rows(*mp.vals.shape, self.device),
                lambda x: predicate_over_values(p, x), mp.doc >= 0)
        else:
            params, counter = {}, [0]
            tpl = raw_predicate(
                p, plane_slot(params, counter, mp.vals), params, counter,
                self.device, self._literal_dtype(p, mp.dtype))
            ent = eval_filter(tpl, {}, params, mp.vals.shape, self.device)
        ent = ent & (mp.doc >= 0)
        pos = torch.nonzero(ent)
        hit[pos[:, 0] * self.L + mp.doc[pos[:, 0], pos[:, 1]].to(
            torch.int64)] = True
        return hit.reshape(self.S, self.L)

    def column_dtype(self, name: str) -> np.dtype:
        """The dtype the host path's values of a column have: numpy's
        promotion of the stored values' and, where a segment predates the
        column, its default's (``np.full(n, null_value())`` there)."""
        self._check_column(name)
        if self.ctx.encoding(name) == Encoding.DICT:
            return np.asarray(self.ctx.global_dict(name).values).dtype
        defaults = [d.dtype for d in self.ctx.evolved(name) if d is not None]
        return np.result_type(self.ctx.raw_dtype(name), *defaults)

    def _dict_values(self, name: str) -> torch.Tensor:
        if name not in self._gvals:
            self._gvals[name] = to_device(
                np.asarray(self.ctx.global_dict(name).values), self.device)
        return self._gvals[name]

    def _column(self, name: str, rows: Rows) -> Val:
        dt = self.column_dtype(name)
        ctx = self.ctx
        if ctx.encoding(name) == Encoding.DICT:
            ids = rows.take(ctx.column(name))
            if dt.kind in ("U", "S", "O"):
                return Val(ids.to(torch.int32), "dict", dt, name)
            gv = self._dict_values(name)
            return Val(gv[torch.clamp(ids.to(torch.int64), 0,
                                      gv.shape[0] - 1)], "num", dt)
        if dt.kind not in "iuf":
            # raw strings or bytes: ids into their distinct values,
            # factorized on the host once a batch
            ids, uniq = ctx.derived(("raw_values", name),
                                    lambda: self._raw_ids(name))
            return Val(rows.take(ids), "case", uniq.dtype, uniq)
        plan = ctx.width_plan(name)
        if dt.kind == "f" and np.dtype(plan.dtype) != dt:
            # raw DOUBLE: the aggregation plane is float32, the host's
            # values are float64
            return Val(rows.take(ctx.exact_column(name)).to(
                _torch_dtype(dt)), "num", dt)
        v = rows.take(ctx.column(name)).to(_torch_dtype(dt))
        if plan.offset is not None:
            v = v + plan.offset
        return Val(v, "num", dt)

    def _raw_ids(self, name: str) -> tuple:
        """((S, L) int64 ids on the card, their sorted distinct values) of
        a raw column of strings or bytes."""
        ctx = self.ctx
        per = [np.asarray(ctx._forward(s, i, name))
               for i, s in enumerate(ctx.segments)]
        uniq, inv = np.unique(np.concatenate(per) if per else
                              np.zeros(0, dtype=object), return_inverse=True)
        blocks = np.zeros((self.S, self.L), dtype=np.int64)
        at = 0
        for i, v in enumerate(per):
            blocks[i, : len(v)] = inv[at: at + len(v)]
            at += len(v)
        return to_device(blocks, self.device), uniq

    def operand(self, e: Expression, rows: Rows) -> Val:
        """``eval`` for an aggregation's operand: a raw integer column that
        a segment predates keeps its stored dtype. Numpy's promotion by
        the default (int32 by 0 to int64) changes no value an aggregation
        reads, and K1 and K2 read the narrow plane."""
        if e.is_identifier and not e.name.startswith("$") \
                and not self.is_mv(e.name) \
                and self.ctx.encoding(e.name) == Encoding.RAW \
                and any(d is not None for d in self.ctx.evolved(e.name)):
            sdt = self.ctx.raw_dtype(e.name)
            if sdt.kind in "iu":
                v = self._column(e.name, rows)
                return Val(v.t.to(_torch_dtype(sdt)), "num", sdt)
        return self.eval(e, rows)

    # ---- numpy result dtypes ---------------------------------------------
    def probe(self, e: Expression) -> np.ndarray:
        """The numpy value the host computes for ``e`` over a one-row
        segment: its dtype is the dtype of the host's result."""
        if e in self._probes:
            return self._probes[e]
        if e.is_literal:
            out = _probe_literal(e.value)
        elif e.is_identifier:
            if e.name == "$docId":
                out = np.ones(1, dtype=np.int64)
            elif e.name in VIRTUAL:
                out = np.asarray(["x"])
            elif e.name.startswith("$"):
                raise KeyError(f"unknown virtual column {e.name!r}")
            else:
                dt = self.column_dtype(e.name)
                out = np.asarray(["x"]) if dt.kind in "USO" \
                    else np.ones(1, dtype=dt)
        elif e.name == "lookup":
            out = np.asarray([self._dim_table(e)[1]])
        elif self._lut_column(e) is not None:
            out = self._lut(e)[:1]
        elif e.name in _MV_FUNCS and self._mv_form(e):
            v = self._mv_function(e)
            out = v.meta[:1] if v.kind == "case" \
                else np.empty(1, dtype=object) if v.kind == "list" \
                else np.ones(1, dtype=v.dtype)
        else:
            fn = get_function(e.name)
            try:
                with np.errstate(all="ignore"):
                    if e.name == "cast":
                        out = fn.np_fn(self.probe(e.args[0]), e.args[1].value)
                    else:
                        out = fn.np_fn(*[self.probe(a) for a in e.args])
            except (TypeError, ValueError) as err:
                raise host_fails(str(e), err) from err
            out = np.asarray(out)
        self._probes[e] = out
        return out

    # ---- expressions -----------------------------------------------------
    def eval(self, e: Expression, rows: Rows) -> Val:
        if e.is_literal:
            a = _probe_literal(e.value)
            if a.dtype.kind not in "biuf":
                # a string or NULL literal: its value on the host, as the
                # one branch of a "case"
                return Val(torch.zeros((), dtype=torch.int64,
                                       device=self.device), "case", a.dtype,
                           a.reshape(1))
            return Val(torch.tensor(a, device=self.device), "num", a.dtype)
        if e.is_identifier:
            name = e.name
            if name == "$docId":
                return Val(rows.doc().to(torch.int64), "num",
                           np.dtype(np.int64))
            if name == "$segmentName":
                return Val(rows.seg(), "seg", self.seg_names.dtype)
            if name == "$hostName":
                return Val(torch.zeros_like(rows.seg()), "host",
                           self.host_names.dtype)
            if name.startswith("$"):
                raise KeyError(f"unknown virtual column {name!r}")
            return self._column(name, rows)
        if e.name == "case":
            return self._case(e, rows)
        if e.name == "lookup":
            return self._lookup(e, rows)
        if e.name in _MV_FUNCS:
            if not self._mv_form(e):
                return self._per_tuple(e, rows)
            v = self._mv_function(e)
            return dataclasses.replace(v, t=rows.take(v.t))
        if e.name in _COMPARE and any(
                a.is_literal and isinstance(a.value, str) for a in e.args):
            return self._string_compare(e, rows)
        col = self._lut_column(e)
        if col is not None:
            lut = self._lut(e)
            ids = torch.clamp(rows.take(self.ctx.column(col)).to(torch.int64),
                              0, max(len(lut) - 1, 0))
            if lut.dtype.kind in "biuf":
                return Val(to_device(lut, self.device)[ids], "num", lut.dtype)
            return Val(ids, "case", lut.dtype, lut)
        if e.name in _TIME_FUNCS:
            return self._time_function(e, rows)
        if e.name in _TAIL_FUNCS:
            v = self._tail_function(e, rows)
            return self._per_tuple(e, rows) if v is None else v
        if e.name not in _TORCH_FUNCS:
            return self._per_tuple(e, rows)
        out_dt = self.probe(e).dtype
        if e.name == "cast" and out_dt.kind in "USO":
            v = self.eval(e.args[0], rows)
            if v.kind != "num":
                return self._per_tuple(e, rows)
            return self._per_value(e, v,
                                   lambda x: tf._np_cast(x, e.args[1].value),
                                   rows)
        args = [self.eval(a, rows) for a in e.args
                if not (e.name == "cast" and a is e.args[1])]
        if any(a.kind != "num" for a in args) or (
                e.name == "cast"
                and str(e.args[1].value).upper() not in _CAST_NP):
            # strings among the operands: numpy's answer (or failure) per
            # distinct tuple of values
            return self._per_tuple(e, rows)
        t = [a.t for a in args]
        if e.name in _ROUND:
            x = t[0].to(_torch_dtype(out_dt))
            if len(t) > 1:
                if not e.args[1].is_literal:
                    return self._per_tuple(e, rows)
                return Val(self._round_scale(e, x, out_dt), "num", out_dt)
            return Val(_ROUND[e.name](x) if out_dt.kind == "f" else x, "num",
                       out_dt)
        cmp_dt = np.result_type(*[self.probe(a) for a in e.args]) \
            if e.name in _COMPARE else None
        return Val(numeric_op(e, t, out_dt, cmp_dt), "num", out_dt)

    # ---- the function tail: torch forms over numbers and points ----------
    def _tail_function(self, e: Expression, rows: Rows):
        """ATAN2, ROUNDDECIMAL / TRUNCATE, GEOTOH3 and the ST_ functions as
        torch ops where their operands are numbers (or points) and their
        parameters literals; None where they are not (``_per_tuple`` then
        runs numpy's form per distinct value)."""
        name = e.name
        consts = [_constant(a) for a in e.args]
        vals = [None if c else self.eval(a, rows)
                for a, c in zip(e.args, consts)]
        lits = []
        for a, c in zip(e.args, consts):
            if not c:
                lits.append(None)
                continue
            try:
                lits.append(np.asarray(np_eval(a, {})))
            except Exception as err:  # noqa: BLE001 — the host fails too
                raise host_fails(str(a), err) from err

        def num(j):
            return vals[j] is not None and vals[j].kind == "num" \
                and vals[j].dtype.kind in "biuf"

        def point(j):
            """A point operand's (lon, lat) as ``parse_points`` reads
            them; None for anything but a point or one WKT point
            literal."""
            if vals[j] is not None and vals[j].kind == "point":
                return geo_ops.geometric(vals[j].t, vals[j].meta.lat)
            if lits[j] is not None and lits[j].size == 1 \
                    and geo_ops._POINT_RE.fullmatch(
                        str(lits[j].reshape(-1)[0])):
                lon, lat = geo_ops.parse_points(lits[j])
                return float(lon[0]), float(lat[0])
            return None

        f64 = torch.float64
        if name == "st_point" and num(0) and num(1):
            lon = geo_ops.sig10_torch(vals[0].t.to(f64))
            lat = geo_ops.sig10_torch(vals[1].t.to(f64))
            lon, lat = torch.broadcast_tensors(lon, lat)
            return Val(lon, "point", self.probe(e).dtype, PointMeta(lat))
        if any(v is not None and v.kind not in ("num", "point")
               for v in vals):
            return None
        if name == "atan2" and num(0) and num(1):
            out_dt = self.probe(e).dtype
            tdt = _torch_dtype(out_dt)
            return Val(torch.atan2(vals[0].t.to(tdt), vals[1].t.to(tdt)),
                       "num", out_dt)
        if name in ("rounddecimal", "round_decimal", "truncate") and num(0) \
                and (len(e.args) == 1 or lits[1] is not None):
            v = vals[0].t.to(f64)
            trunc = name == "truncate"
            if len(e.args) == 1:
                out = torch.sign(v) * torch.floor(v.abs()) if trunc \
                    else torch.floor(v + 0.5)      # Math.round
            else:
                s = 10.0 ** int(lits[1].item())
                out = torch.sign(v) * torch.floor(
                    v.abs() * s + (0.0 if trunc else 0.5)) / s
            return Val(out, "num", np.dtype(np.float64))
        if name in ("geotoh3", "gridcell"):
            j = len(e.args) - 1
            res = int(lits[j].item()) if lits[j] is not None \
                and lits[j].dtype.kind in "biu" and lits[j].ndim == 0 \
                else vals[j].t if num(j) else None
            if res is None:
                return None
            if len(e.args) == 3 and num(0) and num(1):
                lon, lat = torch.broadcast_tensors(vals[0].t.to(f64),
                                                   vals[1].t.to(f64))
            elif len(e.args) == 2 and vals[0] is not None \
                    and vals[0].kind == "point":
                lon, lat = point(0)
            else:
                return None
            return Val(geo_ops.grid_cell_torch(lon, lat, res), "num",
                       np.dtype(np.int64))
        if name in ("st_contains", "st_within"):
            pj, qj = (0, 1) if name == "st_contains" else (1, 0)
            if lits[pj] is None or lits[pj].size != 1 or vals[qj] is None \
                    or vals[qj].kind != "point":
                return None
            ring = geo_ops.parse_polygon(str(lits[pj].reshape(-1)[0]))
            lon, lat = point(qj)
            return Val(geo_ops.points_in_ring_torch(ring, lon, lat), "num",
                       np.dtype(bool))
        if name == "st_geometrytype" and vals[0] is not None:
            shape = vals[0].t.shape
            return Val(torch.zeros(shape, dtype=torch.int64,
                                   device=self.device), "case",
                       np.dtype(object), np.asarray(["Point"], dtype=object))
        if name == "st_equals" and all(
                v is None or v.kind == "point" for v in vals) \
                and any(v is not None for v in vals):
            pa, pb = point(0), point(1)
            if pa is None or pb is None:
                return None
            ka, kb = self._point_bits(vals[0], lits[0]), \
                self._point_bits(vals[1], lits[1])
            same_text = (ka[0] == kb[0]) & (ka[1] == kb[1])

            def t(x):   # a literal's float64 coordinate, or a plane
                return torch.as_tensor(x, dtype=f64, device=self.device)

            la, lb = t(pa[0]), t(pb[0])
            both = ~torch.isnan(la) & ~torch.isnan(lb)
            coords = (la == lb) & (t(pa[1]) == t(pb[1]))
            return Val(torch.where(both, coords, same_text), "num",
                       np.dtype(bool))
        if name == "st_distance":
            pa, pb = point(0), point(1)
            if pa is None or pb is None:
                return None
            return Val(geo_ops.haversine_torch(pa[0], pa[1], pb[0], pb[1]),
                       "num", np.dtype(np.float64))
        return None

    def _point_bits(self, v, lit) -> tuple:
        """(lon, lat) int64 bits of a point's coordinates at their text's
        value (a literal WKT point parsed once)."""
        if v is not None:
            return geo_ops.float_bits(v.t), geo_ops.float_bits(v.meta.lat)
        m = geo_ops._POINT_RE.fullmatch(str(np.asarray(lit).reshape(-1)[0]))
        xy = (float(m.group(1)), float(m.group(2)))
        return tuple(geo_ops.float_bits(torch.tensor(c, dtype=torch.float64,
                                                     device=self.device))
                     for c in xy)

    # ---- any function: numpy per distinct tuple of operand values --------
    def _valid_rows(self, rows: Rows) -> torch.Tensor:
        """Flat bool of the rows that are real docs (not padding)."""
        if rows.idx is not None:
            return torch.ones(rows.idx.shape, dtype=torch.bool,
                              device=self.device).reshape(-1)
        return (rows.doc() < self.ctx.n_docs_dev.to(torch.int64)[
            rows.seg()]).reshape(-1)

    def _tuple_keys(self, v: Val) -> list:
        """int64 planes whose equality is the identity of ``v``'s values
        (floats by their bits: -0.0 and 0.0 apart, one NaN)."""
        if v.kind == "point":
            return [geo_ops.float_bits(v.t), geo_ops.float_bits(v.meta.lat)]
        if v.kind == "num":
            x = v.t
            if x.is_floating_point():
                if x.dtype == torch.float64:
                    return [geo_ops.float_bits(x)]
                return [torch.where(torch.isnan(x), -1, x.view(
                    {4: torch.int32, 2: torch.int16}[x.element_size()])
                    .to(torch.int64))]
            return [x.to(torch.int64)]
        if v.kind == "host":
            return [torch.zeros_like(v.t, dtype=torch.int64)]
        return [v.t.to(torch.int64)]

    def host_values(self, v: Val, keys: list) -> np.ndarray:
        """The host path's values of ``v`` at fetched ``_tuple_keys``."""
        if v.kind == "point":
            lon = keys[0].astype(np.int64).view(np.float64)
            lat = keys[1].astype(np.int64).view(np.float64)
            return geo_ops.format_points(lon, lat)
        k = np.asarray(keys[0], dtype=np.int64)
        if v.kind == "num":
            if v.dtype.kind == "f":
                nan = k == -1 if v.dtype.itemsize < 8 else None
                w = {8: np.int64, 4: np.int32, 2: np.int16}[v.dtype.itemsize]
                out = k.astype(w).view(v.dtype).copy()
                if nan is not None:
                    out[nan] = np.nan
                return out
            return k.astype(v.dtype)
        return self.decode(v, k)

    def _per_tuple(self, e: Expression, rows: Rows) -> Val:
        """``e``'s numpy form over each distinct tuple of its operands'
        values: the tuples factorized on the card over the real rows,
        their values decoded on the host, the function run once over them
        (a failure is the host path's), and its result gathered back by
        tuple id: numbers as a "num" ``Val``, anything else as ids into
        the values (a "case")."""
        fn = get_function(e.name)
        args = e.args[:1] if e.name == "cast" else e.args
        vals, lits = [], []
        for a in args:
            if _constant(a):
                try:
                    lits.append(np.asarray(np_eval(a, {})))
                except Exception as err:  # noqa: BLE001
                    raise host_fails(str(a), err) from err
                vals.append(None)
            else:
                vals.append(self.eval(a, rows))
                lits.append(None)
        inv, hosts = self.distinct([v for v in vals if v is not None], rows)
        hosts = iter(hosts)
        ops = [lit if v is None else next(hosts) for v, lit in zip(vals, lits)]
        n_uniq = int(inv.max()) + 1 if inv.numel() else 1
        try:
            with np.errstate(all="ignore"):
                out = fn.np_fn(ops[0], e.args[1].value) \
                    if e.name == "cast" else fn.np_fn(*ops)
        except Exception as err:  # noqa: BLE001 — the host path's failure
            raise host_fails(str(e), err) from err
        out = np.asarray(out)
        if out.ndim == 0 or out.shape[0] < n_uniq:
            out = np.broadcast_to(out.reshape(-1)[:1], (n_uniq,)).copy()
        if out.dtype.kind in "biuf":
            return Val(to_device(out, self.device)[inv], "num", out.dtype)
        return Val(inv, "case", out.dtype, out)

    def _dim_table(self, e: Expression) -> tuple:
        """LOOKUP's (pk -> value map, miss default): the engine's
        dimension table (``QueryEngine.dim_table_lookup``)."""
        if len(e.args) != 4:
            raise ValueError(
                "LOOKUP takes (dimTable, valueColumn, pkColumn, keyExpr)")
        resolver = getattr(self.ctx, "lookup_resolver", None)
        if resolver is None:
            raise ValueError("LOOKUP needs an engine with dimension tables")
        names = []
        for a in e.args[:3]:
            if not (a.is_literal and isinstance(a.value, str)):
                raise ValueError(
                    "LOOKUP's first three args are string literals")
            names.append(a.value)
        return resolver(*names)

    def _lookup(self, e: Expression, rows: Rows) -> Val:
        """LOOKUP('dimTable', 'valueCol', 'pkCol', key): the key's values
        factorized on the card (``distinct``), each distinct key resolved
        once through the dimension table's map on the host (a miss takes
        the value column's type default), the values gathered back by
        key id: numbers as numbers, strings as ids into their values. A
        literal key gives a scalar."""
        mapping, default = self._dim_table(e)
        key = e.args[3]
        if _constant(key):
            k = np.asarray(np_eval(key, {}))
            a = np.asarray(mapping.get(k.item(), default))
            if a.dtype.kind in "biuf":
                return Val(torch.tensor(a, device=self.device), "num",
                           a.dtype)
            return Val(torch.zeros((), dtype=torch.int64,
                                   device=self.device), "case", a.dtype,
                       a.reshape(1))
        inv, (keys,) = self.distinct([self.eval(key, rows)], rows)
        out = np.asarray([mapping.get(k, default) for k in keys.tolist()]
                         or [default])
        if out.dtype.kind in "biuf":
            return Val(to_device(out, self.device)[inv], "num", out.dtype)
        return Val(inv, "case", out.dtype, out)

    def _lut_column(self, e: Expression):
        """The dict column ``e`` is computed over as a LUT (``_lut``): a
        function with no torch form here, over one stored single-value
        dict column and literals; else None."""
        if not e.is_function:
            return None
        names, funcs = set(), set()

        def walk(x):
            if x.is_identifier:
                names.add(x.name)
            elif x.is_function:
                funcs.add(x.name)
                for a in x.args:
                    walk(a)

        walk(e)
        if len(names) != 1 or funcs <= _TORCH_FUNCS or "lookup" in funcs:
            return None
        name = names.pop()
        if name.startswith("$") or self.is_mv(name):
            return None
        try:   # a schema-evolved column's default is in its dictionary
            enc = self.ctx.encoding(name)
        except (KeyError, DeviceUnsupported):
            return None
        return name if enc == Encoding.DICT else None

    def _lut(self, e: Expression) -> np.ndarray:
        """(C,) the host path's values of ``e`` over its column's global
        dictionary: each distinct value computed once, in numpy."""
        if e not in self._luts:
            col = self._lut_column(e)
            gv = np.asarray(self.ctx.global_dict(col).values)
            out = np.asarray(np_eval(e, {col: gv}))
            if out.ndim == 0:
                out = np.broadcast_to(out, gv.shape).copy()
            self._luts[e] = out
        return self._luts[e]

    def _string_compare(self, e: Expression, rows: Rows) -> Val:
        """A comparison of a string column with a string literal: the
        numpy comparison over the column's values (the global dictionary
        or the segment names) as a LUT, gathered by id on the card."""
        col, lit = e.args if e.args[1].is_literal else e.args[::-1]
        v = self.eval(col, rows)
        if v.kind == "dict":
            values = np.asarray(self.ctx.global_dict(v.meta).values)
        elif v.kind in ("seg", "host"):
            values = self.seg_names if v.kind == "seg" else self.host_names
        elif v.kind == "case":
            values = np.asarray(v.meta)
        else:
            # numpy has no comparison of numbers with a string
            raise host_fails(f"{e}: a string literal against numbers")
        fn = get_function(e.name).np_fn
        lut = fn(values, lit.value) if col is e.args[0] \
            else fn(lit.value, values)
        lut = to_device(np.asarray(lut, dtype=bool), self.device)
        idx = torch.zeros_like(v.t, dtype=torch.int64) if v.kind == "host" \
            else v.t.to(torch.int64)
        return Val(lut[idx], "num", np.dtype(bool))

    def _case(self, e: Expression, rows: Rows) -> Val:
        conds = list(e.args[:-1:2])
        vals = list(e.args[1:-1:2]) + [e.args[-1]]
        strs = [v.is_literal and isinstance(v.value, str) for v in vals]
        cm = [self.eval(c, rows) for c in conds]
        if any(c.kind != "num" or c.dtype.kind != "b" for c in cm) \
                or (any(strs) and not all(strs)):
            # a condition that is not boolean, or string and numeric
            # results: numpy's np.select per distinct tuple
            return self._per_tuple(e, rows)
        if all(strs):
            # string results: the branch index on the card, the literal on
            # the host
            lits = np.asarray([v.value for v in vals])
            out = torch.full(rows.seg().shape, len(conds), dtype=torch.int64,
                             device=self.device)
            for j in reversed(range(len(conds))):
                out = torch.where(cm[j].t, j, out)
            return Val(out, "case", lits.dtype, lits)
        vv = [self.eval(v, rows) for v in vals]
        if any(v.kind != "num" for v in vv):
            return self._per_tuple(e, rows)
        out_dt = self.probe(e).dtype
        tdt = _torch_dtype(out_dt)
        out = vv[-1].t.to(tdt)
        for j in reversed(range(len(conds))):
            out = torch.where(cm[j].t, vv[j].t.to(tdt), out)
        return Val(torch.broadcast_to(out, rows.seg().shape), "num", out_dt)


    # ---- functions whose string literals are parameters ------------------
    def _per_value(self, e: Expression, v: Val, fn, rows: Rows) -> Val:
        """A number -> string function: the values factorized on the card
        (by their bits, so -0.0 and 0.0 stay apart), ``fn`` (the numpy
        form) run once per distinct value on the host, carried as a
        "case" ``Val`` (ids into the strings)."""
        inv, (u,) = self.distinct([v], rows)
        out = np.asarray(fn(u))
        return Val(inv, "case", out.dtype, out)

    def _round_scale(self, e: Expression, x: torch.Tensor,
                     out_dt: np.dtype) -> torch.Tensor:
        """``np.round(x, d)``: floats as numpy rounds them (x * 10^d, then
        to even, then / 10^d; 10^-d the other way round), integers left
        alone for d >= 0 and rounded through float64 for d < 0."""
        d = int(np.asarray(e.args[1].value))
        if out_dt.kind == "f":
            return torch.round(x, decimals=d)
        if d >= 0:
            return x
        f = float(10 ** -d)
        return (torch.round(x.to(torch.float64) / f) * f).to(x.dtype)

    def _time_function(self, e: Expression, rows: Rows) -> Val:
        """TIMECONVERT and DATETIMECONVERT over any numeric values, the
        format and unit literals folded into int64 torch ops with the
        reference's arithmetic (ops/transform.py: Java's truncating
        division, as numpy computes it); a SIMPLE_DATE_FORMAT output
        formatted on the host once per distinct bucketed millisecond."""
        if not all(a.is_literal for a in e.args[1:]):
            return self._per_tuple(e, rows)
        lits = [str(a.value) for a in e.args[1:]]
        v = self.eval(e.args[0], rows)
        if v.kind != "num":
            return self._per_tuple(e, rows)
        x = v.t.to(torch.int64)
        if e.name == "timeconvert":
            return Val(_from_millis(_to_millis(x, lits[0]), lits[1]), "num",
                       np.dtype(np.int64))
        inf, outf = tf._DateTimeFormat(lits[0]), tf._DateTimeFormat(lits[1])
        if inf.fmt != "EPOCH":
            return self._per_tuple(e, rows)
        gsize, gunit = lits[2].split(":", 1)
        g = int(np.int64(int(gsize) * tf._unit_ms(gunit)))
        ms = _to_millis(x * inf.size, inf.unit)
        bucketed = _div_trunc(ms, g) * g
        if outf.fmt == "EPOCH":
            return Val(_div_trunc(_from_millis(bucketed, outf.unit),
                                  outf.size), "num", np.dtype(np.int64))
        return self._per_value(e, Val(bucketed, "num", np.dtype(np.int64)),
                               outf.from_millis, rows)

    # ---- the array functions over MV columns -----------------------------
    def _mv_arg(self, e: Expression, a: Expression) -> str:
        assert a.is_identifier and self.is_mv(a.name), (e, a)
        return a.name

    def _mv_form(self, e: Expression) -> bool:
        """Whether ``_mv_function`` has the form of ``e``: its columns
        multi-value ones, its keys and values literals. Any other (an
        array function over a single value, a column where a literal
        goes) is numpy's per distinct value (``_per_tuple``)."""
        def mv(a):
            return a.is_identifier and not a.name.startswith("$") \
                and self.is_mv(a.name)

        a = e.args
        if e.name in ("arraylength", "cardinality"):
            return True
        if e.name == "valuein":
            return mv(a[0]) and all(x.is_literal for x in a[1:])
        if e.name == "mapvalue":
            return len(a) == 3 and mv(a[0]) and mv(a[2]) and a[1].is_literal
        return len(a) == 1 and mv(a[0])

    def _entry_docs(self, doc: torch.Tensor):
        """(valid entries (S, E) bool, each entry's flat doc (S, E) int64
        ``segment * L + doc``, padding on the dump slot ``S * L``)."""
        valid = doc >= 0
        seg = torch.arange(doc.shape[0], device=self.device)[:, None]
        return valid, torch.where(valid, seg * self.L + doc.to(torch.int64),
                                  self.S * self.L)

    def _mv_function(self, e: Expression) -> Val:
        """ARRAYLENGTH / CARDINALITY, ARRAYSUM / ARRAYAVERAGE / ARRAYMIN /
        ARRAYMAX, VALUEIN and MAPVALUE (ops/transform.py ``_array_reduce``
        and the rest there) over an MV column's entries
        (engine/params.py ``mv_entries``), as (S, L) planes of the whole
        batch, computed once a batch."""
        if e in self._mvfuncs:
            return self._mvfuncs[e]
        name = e.name
        if name in ("arraylength", "cardinality"):
            a = e.args[0]
            if a.is_function and a.name == "valuein":
                out = Val(self._valuein(a)[1], "num", np.dtype(np.int64))
            elif a.is_identifier and self.is_mv(a.name):
                mp = self.mv(a.name)
                lens = torch.zeros((self.S, self.L), dtype=torch.int64,
                                   device=self.device) if mp is None \
                    else mp.lens.to(torch.int64)
                out = Val(lens, "num", np.dtype(np.int64))
            else:   # a single value is a one-entry array
                self.eval(a, Rows(self.S, self.L, self.device))
                out = Val(torch.ones((self.S, self.L), dtype=torch.int64,
                                     device=self.device), "num",
                          np.dtype(np.int64))
        elif name == "valuein":
            code, _n, meta = self._valuein(e)
            out = Val(code, "list", np.dtype(object), meta)
        elif name == "mapvalue":
            out = self._mapvalue(e)
        else:
            out = self._array_reduce(e)
        self._mvfuncs[e] = out
        return out

    def _array_reduce(self, e: Expression) -> Val:
        """The per-doc reduction of an MV column's entries. Its dtype is
        numpy's per segment: the reduction's (np.sum of ints: int64) where
        every doc has an entry, float64 where one has none (the fill 0.0,
        +-inf, NaN), as ``Mixed``."""
        col = self._mv_arg(e, e.args[0])
        v, doc = self.mv_values(col)
        if v.kind != "num" or v.dtype.kind not in "biuf":
            raise host_fails(f"{e}: a numeric reduction of strings")
        mp = self.mv(col)
        filled = np.ones(self.S, dtype=bool) if mp is None else mp.empty
        name = e.name
        if name == "arraysum":
            base = np.sum(np.ones(1, dtype=v.dtype)).dtype
        elif name == "arrayaverage":
            base = np.mean(np.ones(1, dtype=v.dtype)).dtype
        else:
            base = v.dtype
        dt = np.dtype(np.float64) if filled.any() else base
        _valid, flat = self._entry_docs(doc)
        # every entry scatters, padding onto the dump slot S * L
        idx, x = flat.reshape(-1), v.t.reshape(-1)
        n = self.S * self.L
        f64 = torch.float64
        if name in ("arraysum", "arrayaverage"):
            acc = f64 if base.kind == "f" or name == "arrayaverage" \
                else torch.int64
            out = torch.zeros(n + 1, dtype=acc, device=self.device) \
                .index_add_(0, idx, x.to(acc))[:n]
            if name == "arrayaverage":
                cnt = torch.zeros((self.S, self.L), device=self.device) \
                    if mp is None else mp.lens
                out = out / cnt.reshape(-1).to(f64)   # 0 / 0: NaN, the fill
        else:
            fill = float("inf") if name == "arraymin" else float("-inf")
            red = "amin" if name == "arraymin" else "amax"
            out = torch.full((n + 1,), fill, dtype=f64, device=self.device) \
                .scatter_reduce_(0, idx, x.to(f64), red,
                                 include_self=True)[:n]
        out = out.reshape(self.S, self.L).to(_torch_dtype(dt))
        meta = Mixed(base, filled.copy()) if dt != base else None
        return Val(out, "num", dt, meta)

    def _valuein(self, e: Expression) -> tuple:
        """VALUEIN(col, v1, ...): per doc, the entries among the literals,
        deduplicated in first-seen order (ops/transform.py ``_valuein``),
        as (ListMeta code (S, L) int64, kept entries (S, L) int64,
        ListMeta)."""
        col = self._mv_arg(e, e.args[0])
        want = {np.asarray(a.value).item() for a in e.args[1:]}
        # numbers before strings: a column's entries meet one kind only
        order = sorted(want, key=lambda w: (isinstance(w, str), w))
        k = len(order)
        v, doc = self.mv_values(col)
        S, L, dev = self.S, self.L, self.device
        if v.kind == "dict":
            gv = np.asarray(self.ctx.global_dict(col).values)
            rank = {w: j for j, w in enumerate(order)}
            lut = np.asarray([rank.get(x, -1) for x in gv.tolist()],
                             dtype=np.int64)
            values = []
            for w in order:   # the column's own values, as the rows hold
                hit = [x for x in gv.tolist() if x == w]
                values.append(hit[0] if hit else w)
            widx = to_device(lut, dev)[torch.clamp(v.t.to(torch.int64), 0,
                                                   max(len(lut) - 1, 0))] \
                if len(lut) else torch.full_like(v.t, -1, dtype=torch.int64)
        elif v.kind == "num":
            widx = torch.full(v.t.shape, -1, dtype=torch.int64, device=dev)
            values = []
            for j, w in enumerate(order):
                values.append(np.asarray(w).astype(v.dtype).item()
                              if isinstance(w, (int, float, bool)) else w)
                if isinstance(w, (int, float, bool)):
                    widx = torch.where(v.t == w, j, widx)
        else:   # a column no segment stores: no entry
            widx = torch.full(v.t.shape, -1, dtype=torch.int64, device=dev)
            values = list(order)
        valid, flat = self._entry_docs(doc)
        hit = (widx >= 0) & valid
        E = v.t.shape[1]
        # each entry's doc's first entry, as a flat position into (S * E)
        mp = self.mv(col)
        first = torch.zeros((S, E), dtype=torch.int64, device=dev)
        if mp is not None:
            first = (torch.arange(S, device=dev)[:, None] * E
                     + mp.start.reshape(-1)[torch.clamp(flat, max=S * L - 1)]
                     .to(torch.int64))

        def in_doc(x):
            """Inclusive count of ``x`` from its doc's first entry."""
            cs = torch.cumsum(x.reshape(-1).to(torch.int64), 0)
            before = torch.where(first.reshape(-1) > 0,
                                 cs[torch.clamp(first.reshape(-1) - 1,
                                                min=0)], 0)
            return (cs - before).reshape(S, E)

        kept = torch.zeros_like(hit)
        for j in range(k):
            hj = hit & (widx == j)
            kept |= hj & (in_doc(hj) == 1)
        rank = torch.clamp(in_doc(kept) - 1, 0, max(k - 1, 0))
        n = S * L
        idx = flat.reshape(-1)
        count = torch.zeros(n + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, idx, kept.reshape(-1).to(torch.int64))[:n]
        if (k + 1) ** k >= 1 << 63:
            # past one int64's digits: each doc's digit row, numbered in
            # row order (which is the lists' order) by a unique
            pos = (idx * k + rank.reshape(-1))[kept.reshape(-1)]
            mat = torch.zeros((n + 1) * k, dtype=torch.uint8, device=dev)
            mat[pos] = (widx.reshape(-1)[kept.reshape(-1)] + 1).to(
                torch.uint8)
            table, code = torch.unique(mat.reshape(n + 1, k)[:n], dim=0,
                                       return_inverse=True)
            return code.reshape(S, L), count.reshape(S, L), \
                ListMeta(tuple(values), k, table.cpu().numpy())
        powt = torch.tensor([(k + 1) ** (k - 1 - i) for i in range(k)] or [0],
                            dtype=torch.int64, device=dev)
        digit = torch.where(kept, (widx + 1) * powt[rank], 0).reshape(-1)
        code = torch.zeros(n + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, idx, digit)[:n]
        return code.reshape(S, L), count.reshape(S, L), \
            ListMeta(tuple(values), k)

    def _mapvalue(self, e: Expression) -> Val:
        """MAPVALUE(keys, 'k', values): per doc, the value at the first
        entry of ``keys`` equal to the key, or the values column's type
        default ('' or 0) on a miss (ops/transform.py ``_mapvalue``); a
        numeric answer is numpy's per segment, as ``Mixed``: the values'
        dtype where every doc hits, promoted by the 0 where one misses."""
        kcol = self._mv_arg(e, e.args[0])
        vcol = self._mv_arg(e, e.args[2])
        key = np.asarray(e.args[1].value).item()
        kv, kdoc = self.mv_values(kcol)
        vv, _vdoc = self.mv_values(vcol)
        S, L, dev = self.S, self.L, self.device
        if kv.kind == "dict":
            gv = np.asarray(self.ctx.global_dict(kcol).values)
            lut = to_device(np.asarray([x == key for x in gv.tolist()],
                                       dtype=bool), dev)
            hit = lut[torch.clamp(kv.t.to(torch.int64), 0,
                                  max(len(gv) - 1, 0))] if len(gv) \
                else torch.zeros_like(kv.t, dtype=torch.bool)
        elif isinstance(key, (int, float, bool)):
            hit = kv.t == key
        else:   # numpy: numbers never equal a string
            hit = torch.zeros_like(kv.t, dtype=torch.bool)
        valid, flat = self._entry_docs(kdoc)
        hit &= valid
        kmp, vmp = self.mv(kcol), self.mv(vcol)
        big = torch.iinfo(torch.int64).max
        first = torch.full((S * L + 1,), big, dtype=torch.int64, device=dev)
        if kmp is not None:
            E = kv.t.shape[1]
            pos = torch.arange(E, device=dev)[None, :].expand(S, E)
            rank = pos - kmp.start.reshape(-1)[
                torch.clamp(flat, max=S * L - 1)].to(torch.int64)
            first.scatter_reduce_(0, flat.reshape(-1),
                                  torch.where(hit, rank, big).reshape(-1),
                                  "amin")
        first = first[: S * L]
        if vmp is None:
            has = torch.zeros(S * L, dtype=torch.bool, device=dev)
            at = torch.zeros(S * L, dtype=torch.int64, device=dev)
        else:
            has = first < vmp.lens.reshape(-1).to(torch.int64)
            Ev = vv.t.shape[1]
            seg = torch.arange(S, device=dev).repeat_interleave(L)
            at = torch.clamp(seg * Ev + vmp.start.reshape(-1).to(torch.int64)
                             + torch.where(has, first, 0), max=S * Ev - 1)
        got = vv.t.reshape(-1)[at]
        if vv.kind == "dict":
            gv = np.asarray(self.ctx.global_dict(vcol).values)
            strs = np.concatenate([gv, np.asarray([""], dtype=gv.dtype)])
            ids = torch.where(has, got.to(torch.int64), len(gv))
            return Val(ids.reshape(S, L), "case", strs.dtype, strs)
        if vv.kind != "num":
            # no segment stores the values column: no entry anywhere, so
            # the reference's default is 0
            zero = torch.zeros((S, L), dtype=torch.int64, device=dev)
            return Val(zero, "num", np.dtype(np.int64))
        base = vv.dtype
        valid_doc = torch.arange(L, device=dev)[None, :] \
            < self.ctx.n_docs_dev[:, None].to(torch.int64)
        miss = ((~has.reshape(S, L)) & valid_doc).any(dim=1).cpu().numpy()
        dt = np.result_type(base, np.asarray([0]).dtype) if miss.any() \
            else base
        out = torch.where(has, got, torch.zeros_like(got)) \
            .to(_torch_dtype(dt)).reshape(S, L)
        return Val(out, "num", dt, Mixed(base, miss) if dt != base else None)

    def hash32(self, v: Val) -> torch.Tensor:
        """int64 in [0, 2^32): the canonical hash the host applies to the
        values (ops/hll.py ``hash32_np``): numbers by their dtype, strings
        by their murmur hash, computed once per distinct string."""
        from pinot_tpu_torch.ops import hll as hll_ops

        if v.kind == "num":
            return sb.hash32_values(v.t, v.dtype)
        v = self.materialize(v)
        if v.kind == "dict":
            values = np.asarray(self.ctx.global_dict(v.meta).values)
        elif v.kind == "case":
            values = np.asarray(v.meta)
        elif v.kind in ("seg", "host"):
            values = self.seg_names if v.kind == "seg" else self.host_names
        else:
            raise host_fails(f"a hash of {v.kind} values",
                             TypeError("unhashable type: 'list'"))
        h = to_device(hll_ops.hash32_np(values).astype(np.int64)
                      if len(values) else np.zeros(1, dtype=np.int64),
                      self.device)
        idx = torch.zeros_like(v.t, dtype=torch.int64) if v.kind == "host" \
            else torch.clamp(v.t.to(torch.int64), 0, h.shape[0] - 1)
        return h[idx]

    # ---- keys: equality and order ----------------------------------------
    def key(self, v: Val, shape=None) -> torch.Tensor:
        """int64 keys whose equality and order are the host's over the
        values: numbers by value (``order_key``), strings by rank, VALUEIN's
        lists by their code."""
        if v.kind == "num":
            k = order_key(v.t)
        elif v.kind == "point":
            k = self._point_keys(v)
        elif v.kind == "list":
            k = v.t.to(torch.int64)
        elif v.kind == "dict":
            k = v.t.to(torch.int64)  # the global dictionary is sorted
        elif v.kind == "seg":
            k = self.seg_rank[v.t]
        elif v.kind == "host":
            k = torch.zeros_like(v.t, dtype=torch.int64)
        else:  # case: rank of each branch's literal among the literals
            _u, rank = np.unique(v.meta, return_inverse=True)
            k = to_device(rank.astype(np.int64), self.device)[v.t]
        if shape is not None:
            k = torch.broadcast_to(k, shape)
        return k

    @staticmethod
    def _point_keys(v: Val) -> torch.Tensor:
        """A point's int64 keys: its (lon, lat) bit pairs factorized on the
        card (equal keys, equal text)."""
        m = v.meta
        if m.keys is None:
            inv, uniq = _factorize_tuples(
                [geo_ops.float_bits(v.t).reshape(-1),
                 geo_ops.float_bits(m.lat).reshape(-1)], None)
            m.uniq, m.keys = uniq, inv.reshape(v.t.shape)
        return m.keys

    def _point_text(self, v: Val, k: np.ndarray) -> np.ndarray:
        """The WKT text of a point's values at fetched keys ``k``."""
        self._point_keys(v)
        pairs = v.meta.uniq[to_device(np.asarray(k, dtype=np.int64),
                                      self.device)].cpu().numpy()
        return geo_ops.format_points(pairs[:, 0].view(np.float64),
                                     pairs[:, 1].view(np.float64))

    def materialize(self, v: Val) -> Val:
        """``v`` with values the host decodes from its ``t`` alone: a
        point as ids into its distinct texts (formatted once each)."""
        if v.kind != "point":
            return v
        keys = self._point_keys(v)
        text = self._point_text(v, np.arange(v.meta.uniq.shape[0]))
        return Val(keys, "case", text.dtype, text)

    def set_key(self, v: Val, shape) -> torch.Tensor:
        """``key`` as the host's Python sets tell values apart (its
        DISTINCTCOUNT): NaN equals nothing, not even itself, so each NaN
        row keys by its flat position above every number's key."""
        k = self.key(v, shape)
        if v.kind == "num" and v.t.is_floating_point():
            nan = torch.broadcast_to(torch.isnan(v.t), shape)
            pos = torch.arange(nan.numel(), device=self.device).reshape(shape)
            k = torch.where(nan, _NAN_KEY + pos, k)
        return k

    def card(self, v: Val):
        """The size of the range ``key`` maps ``v`` into, where it is
        known without reading the rows (dictionary ids, segment and
        literal ranks), else None."""
        if v.kind == "dict":
            return len(self.ctx.global_dict(v.meta))
        if v.kind == "seg":
            return len(self.seg_sorted)
        if v.kind == "host":
            return 1
        if v.kind == "case":
            return len(np.unique(v.meta))
        return None

    def sort_key(self, v: Val, ascending: bool) -> torch.Tensor:
        """The host's ORDER BY key (``_order_indices``): descending negates
        the value (floats in float64, so NaN stays last)."""
        if v.kind == "point":   # ordered by its text
            v = self.materialize(v)
        if ascending:
            return self.key(v)
        if v.kind == "num" and v.t.is_floating_point():
            return order_key(-v.t.to(torch.float64))
        return -self.key(v)

    def key_orders(self, v: Val, k: torch.Tensor) -> tuple:
        """(ascending, descending) ORDER BY keys of ``key`` values ``k``
        of ``v``, the descending one as ``sort_key`` makes it."""
        if v.kind == "num" and v.dtype.kind == "f":
            return k, order_key(-from_order_key(k, np.dtype(np.float64)))
        return k, -k

    @staticmethod
    def _merged_dtype(v: Val, segs) -> np.dtype:
        """The dtype of ``v``'s values once the reference's reduce has
        concatenated the segments ``segs`` (None: all) of a ``Mixed``
        value."""
        if isinstance(v.meta, Mixed) and segs is not None \
                and not (v.meta.filled & np.asarray(segs, dtype=bool)).any():
            return v.meta.base
        return v.dtype

    def decode(self, v: Val, host: np.ndarray, segs=None) -> np.ndarray:
        """Host values of a fetched ``Val.t`` (``segs``: the segments
        whose answers the reference merges, for a ``Mixed`` dtype)."""
        if v.kind == "num":
            return np.asarray(host).astype(self._merged_dtype(v, segs),
                                           copy=False)
        if v.kind == "list":
            return v.meta.decode(np.asarray(host).reshape(-1))
        if v.kind == "point":
            raise AssertionError("a point decodes from its keys")
        if v.kind == "dict":
            return self.ctx.global_dict(v.meta).take(np.asarray(host))
        if v.kind == "seg":
            return self.seg_names[np.asarray(host)]
        if v.kind == "host":
            return self.host_names[np.zeros(len(host), dtype=np.int64)]
        return np.asarray(v.meta)[np.asarray(host)]

    def decode_key(self, v: Val, host_keys: np.ndarray,
                   segs=None) -> np.ndarray:
        """Host values of fetched ``key`` values."""
        k = np.asarray(host_keys, dtype=np.int64)
        if v.kind == "num":
            return from_order_key(torch.from_numpy(k), v.dtype).numpy() \
                .astype(self._merged_dtype(v, segs), copy=False)
        if v.kind == "list":
            return v.meta.decode(k)
        if v.kind == "point":
            return self._point_text(v, k)
        if v.kind == "dict":
            return self.ctx.global_dict(v.meta).take(k)
        if v.kind == "seg":
            return self.seg_sorted[k]
        if v.kind == "host":
            return self.host_names[np.zeros(len(k), dtype=np.int64)]
        return np.unique(v.meta)[k]

    # ---- filters: the host path's leaves of build_filter -----------------
    def predicate_leaf(self, p: Predicate, params: dict, counter: list,
                       generic: bool = False):
        """The filter template leaf (engine/params.py ``build_filter``) of
        ``p`` over the host path's values, or None for a dict column's
        predicate, which the template builds as the device does. The
        index-backed filters, multi-value columns' predicates and the
        segment names' predicates become a mask; any other lhs its values
        at the host's dtype, compared with the literals in the dtype numpy
        compares them in. ``generic``: no index (a geo predicate's
        segments without a grid)."""
        lhs = p.lhs
        full = Rows(self.S, self.L, self.device)
        if p.type in _NULL_PREDS:
            return ("mask", plane_slot(params, counter, self.null_mask(p))[1])
        mask = None if generic else self._index_mask(p)
        if mask is None and lhs.is_identifier and self.is_mv(lhs.name) \
                and p.type not in _NULL_PREDS:
            mask = self.mv_match(p)
        if mask is not None:
            return ("mask", plane_slot(params, counter, mask)[1])
        if lhs.is_identifier and lhs.name in ("$segmentName", "$hostName"):
            names = self.seg_names if lhs.name == "$segmentName" \
                else self.host_names
            lut = to_device(predicate_over_values(p, names), self.device)
            return ("mask", plane_slot(params, counter, lut[full.seg()])[1])
        if lhs.is_identifier and not lhs.name.startswith("$"):
            self._check_column(lhs.name)
            if self.ctx.encoding(lhs.name) == Encoding.DICT:
                return None
        v = self.eval(lhs, full)
        if v.kind == "case":
            # strings the card carries as ids: the predicate over each
            # distinct string, gathered by id
            lut = to_device(predicate_over_values(p, np.asarray(v.meta)),
                            self.device)
            mask = torch.broadcast_to(lut[v.t], full.seg().shape)
            return ("mask", plane_slot(params, counter, mask)[1])
        if v.kind != "num" or p.type in (
                PredicateType.LIKE, PredicateType.REGEXP_LIKE) \
                or self._string_literal(p):
            # numpy's predicate over each distinct value (numbers by their
            # text for LIKE; a string literal never equals a number)
            mask = torch.broadcast_to(self.distinct_lut(
                v, full, lambda x: predicate_over_values(p, x)),
                full.seg().shape)
            return ("mask", plane_slot(params, counter, mask)[1])
        dt = self._literal_dtype(p, self.probe(lhs).dtype)
        plane = torch.broadcast_to(v.t.to(_torch_dtype(dt)), full.seg().shape)
        return raw_predicate(p, plane_slot(params, counter, plane), params,
                             counter, self.device, dt)

    def null_mask(self, p: Predicate) -> torch.Tensor:
        """(S, L) bool of IS NULL / IS NOT NULL (engine/host.py there): a
        column's null vectors (engine/params.py ``null_plane``), a
        schema-evolved column null in every doc of a segment that predates
        it; an unknown (or virtual) column raises; any other expression is
        never null."""
        lhs = p.lhs
        if lhs.is_identifier:
            nulls = self.ctx.null_plane(lhs.name)
        else:
            nulls = torch.zeros((self.S, self.L), dtype=torch.bool,
                                device=self.device)
        return nulls if p.type is PredicateType.IS_NULL else ~nulls

    @staticmethod
    def _string_literal(p: Predicate) -> bool:
        """Whether a literal of ``p`` is a string (or its IN list is one
        numpy makes strings)."""
        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            return np.asarray(list(p.values)).dtype.kind not in "biuf"
        lits = [p.value] if p.type in (PredicateType.EQ,
                                       PredicateType.NOT_EQ) \
            else [x for x in (p.lower, p.upper) if x is not None]
        return any(isinstance(x, str) for x in lits)

    def distinct(self, vals: list, rows: Rows, valid=None) -> tuple:
        """(id of each row's tuple of values, shaped as the rows; per
        ``Val`` its values at each id on the host): the tuples of
        ``vals`` over the real rows (``valid``, default: ``rows``' docs)
        numbered on the card, each decoded once (a row outside ``valid``
        gets some id in range). No ``Val``: one id, 0."""
        shape = torch.broadcast_shapes(rows.seg().shape,
                                       *[v.t.shape for v in vals])
        if not vals:
            return torch.zeros(shape, dtype=torch.int64,
                               device=self.device), []
        if valid is None:
            valid = self._valid_rows(rows).reshape(rows.seg().shape)
        valid = torch.broadcast_to(valid, shape).reshape(-1)
        widths = [len(self._tuple_keys(v)) for v in vals]
        keys = [torch.broadcast_to(k, shape).reshape(-1)
                for v in vals for k in self._tuple_keys(v)]
        inv, uniq = _factorize_tuples(keys, valid)
        host = uniq.cpu().numpy()
        out, col = [], 0
        for v, w in zip(vals, widths):
            out.append(self.host_values(v, [host[:, col + j]
                                            for j in range(w)]))
            col += w
        return inv.reshape(shape), out

    def distinct_lut(self, v: Val, rows: Rows, fn,
                     valid=None) -> torch.Tensor:
        """``fn`` (numpy values -> one value each) over each distinct value
        of ``v`` (``distinct``), gathered back per row: the host path's
        function of the values, run once per distinct value. A failure of
        ``fn`` is the host path's."""
        inv, (vals,) = self.distinct([v], rows, valid)
        try:
            with np.errstate(all="ignore"):
                out = np.asarray(fn(vals)).reshape(-1)
        except Exception as err:  # noqa: BLE001 — the host path's failure
            raise host_fails(f"{fn} over {v.dtype} values", err) from err
        return to_device(out, self.device)[inv]

    @staticmethod
    def _literal_dtype(p: Predicate, vdt: np.dtype) -> np.dtype:
        """The dtype numpy compares values of ``vdt`` with the
        predicate's (numeric) literals in."""
        arr = np.ones(1, dtype=vdt)
        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            lits = np.asarray(list(p.values))
            return np.result_type(arr.dtype, lits.dtype)
        lits = [p.value] if p.type in (PredicateType.EQ,
                                       PredicateType.NOT_EQ) \
            else [x for x in (p.lower, p.upper) if x is not None]
        return np.dtype(np.int64) if arr.dtype.kind in "iub" and all(
            isinstance(x, (int, bool)) for x in lits) \
            else np.result_type(arr, *lits)

    # ---- the index-backed filters ----------------------------------------
    def _index_mask(self, p: Predicate):
        """(S, L) bool of a JSON_MATCH, TEXT_MATCH or geo-indexed
        ST_DISTANCE predicate, or None for any other."""
        if p.type is PredicateType.JSON_MATCH:
            from pinot_tpu_torch.storage import jsonindex

            col = self._match_column(p, "JSON_MATCH")
            f = jsonindex.parse_match_expression(p.value)
            if self.ctx.encoding(col) != Encoding.DICT:
                return self._raw_scan(col, lambda vals: jsonindex.match_scan(
                    vals, f, len(vals)))
            return self._doc_set_or_lut(
                col, lambda s: s.json_index(col),
                lambda idx, n: idx.match(f, n),
                lambda vals: jsonindex.match_scan(vals, f, len(vals)))
        if p.type is PredicateType.TEXT_MATCH:
            from pinot_tpu_torch.storage import textindex

            col = self._match_column(p, "TEXT_MATCH")
            if self.ctx.encoding(col) != Encoding.DICT:
                return self._raw_scan(col, lambda vals: textindex
                                      .ScanTextIndex(vals).match(
                                          p.value, len(vals)))
            return self._doc_set_or_lut(
                col, lambda s: s.text_index(col),
                lambda idx, n: idx.match(p.value, n),
                lambda vals: textindex.ScanTextIndex(vals).match(
                    p.value, len(vals)))
        if p.type is PredicateType.RANGE and p.upper is not None:
            return self._geo_mask(p)
        return None

    def _match_column(self, p: Predicate, what: str) -> str:
        if not p.lhs.is_identifier:
            raise ValueError(f"{what} takes a column as its first arg")
        self._check_column(p.lhs.name)
        return p.lhs.name

    def _raw_scan(self, col: str, match_values) -> torch.Tensor:
        """A match over a raw column: the host path's scan of its values,
        run once per distinct value (no raw column has an index)."""
        full = Rows(self.S, self.L, self.device)
        return torch.broadcast_to(self.distinct_lut(
            self.eval(Expression.identifier(col), full), full,
            lambda vals: np.asarray(match_values(vals), dtype=bool)),
            (self.S, self.L))

    def _doc_set_or_lut(self, col: str, index_of, match_docs, match_values):
        """Each segment with its index gives a doc set (``match_docs``),
        scattered into the mask; the others share one LUT over the
        global dictionary's distinct values (``match_values``, the host
        path's scan of them), gathered by id."""
        S, L = self.S, self.L
        flat, scan = [], np.zeros(S, dtype=bool)
        for i, s in enumerate(self.ctx.segments):
            idx = index_of(s)
            if idx is None:
                scan[i] = True
                continue
            docs = np.nonzero(np.asarray(match_docs(idx, s.n_docs))
                              [: s.n_docs])[0]
            flat.append(docs.astype(np.int64) + i * L)
        mask = torch.zeros(S * L, dtype=torch.bool, device=self.device)
        if flat:
            mask[to_device(np.concatenate(flat), self.device)] = True
        mask = mask.reshape(S, L)
        if scan.any():
            gv = np.asarray(self.ctx.global_dict(col).values)
            lut = to_device(np.asarray(match_values(gv), dtype=bool),
                            self.device)
            if lut.numel():
                ids = torch.clamp(self.ctx.column(col).to(torch.int64), 0,
                                  lut.shape[0] - 1)
                mask = mask | (lut[ids]
                               & to_device(scan, self.device)[:, None])
        return mask

    def _geo_mask(self, p: Predicate):
        """ST_DISTANCE(col, point) against a range, through each
        segment's geo grid: its candidate docs from the host's cell
        lookup, their points (each distinct value parsed once) checked
        by haversine on the card. A segment the grid cannot answer takes
        the generic evaluation (``eval``). None where no segment has a
        grid for the shape."""
        cands = [geo_candidates(s, p) for s in self.ctx.segments]
        hits = [c for c in cands if c is not None]
        if not hits:
            return None
        col, qlon, qlat = hits[0][1], hits[0][2], hits[0][3]
        S, L = self.S, self.L
        flat = np.concatenate(
            [c[0].astype(np.int64) + i * L for i, c in enumerate(cands)
             if c is not None])
        mask = torch.zeros(S * L, dtype=torch.bool, device=self.device)
        if len(flat):
            lon, lat = self._points(col)
            pos = to_device(flat, self.device)
            ids = Rows(S, L, self.device, pos).take(
                self.ctx.column(col)).to(torch.int64)
            d = geo_ops.haversine_torch(lon[ids], lat[ids], qlon, qlat)
            radius = float(p.upper)
            ok = (d <= radius) if p.upper_inclusive else (d < radius)
            if p.lower is not None:
                lo = float(p.lower)
                ok &= (d >= lo) if p.lower_inclusive else (d > lo)
            mask[pos[ok]] = True
        mask = mask.reshape(S, L)
        rest = np.asarray([c is None for c in cands])
        if rest.any():
            from pinot_tpu_torch.engine.device import eval_filter

            params, counter = {}, [0]
            tpl = self.predicate_leaf(p, params, counter, generic=True)
            gen = eval_filter(tpl, {}, params, (S, L), self.device)
            mask = torch.where(to_device(rest, self.device)[:, None], gen,
                               mask)
        return mask

    def _points(self, col: str) -> tuple:
        """(C,) float64 lon / lat of a point column's global dictionary,
        on the card: each distinct WKT string parsed once a batch."""
        def build():
            lon, lat = geo_ops.parse_points(
                np.asarray(self.ctx.global_dict(col).values))
            return to_device(lon, self.device), to_device(lat, self.device)

        return self.ctx.derived(("points", col), build)


# ---------------------------------------------------------------------------
# the host predicate over a value vector, and its scan accounting
# ---------------------------------------------------------------------------


def _coerce(value, v: np.ndarray):
    return str(value) if v.dtype.kind in ("U", "S") else value


def predicate_over_values(p: Predicate, v: np.ndarray) -> np.ndarray:
    """The host path's predicate over a vector of values (a dictionary or
    the segment names): one boolean per value."""
    t = p.type
    if t is PredicateType.EQ:
        return np.asarray(v == _coerce(p.value, v), dtype=bool)
    if t is PredicateType.NOT_EQ:
        return np.asarray(v != _coerce(p.value, v), dtype=bool)
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        lits = [str(x) for x in p.values] if v.dtype.kind in ("U", "S") \
            else list(p.values)
        m = np.isin(v, np.asarray(lits))
        return ~m if t is PredicateType.NOT_IN else m
    if t is PredicateType.RANGE:
        m = np.ones(len(v), dtype=bool)
        if p.lower is not None:
            lo = _coerce(p.lower, v)
            m &= (v >= lo) if p.lower_inclusive else (v > lo)
        if p.upper is not None:
            hi = _coerce(p.upper, v)
            m &= (v <= hi) if p.upper_inclusive else (v < hi)
        return m
    if t in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
        pat = p.value if t is not PredicateType.LIKE else like_to_regex(p.value)
        rx = re.compile(pat)
        search = rx.search if t is not PredicateType.LIKE else rx.match
        return np.fromiter((bool(search(s)) for s in v.astype(str)),
                           dtype=bool, count=len(v))
    raise host_fails(f"the predicate {t.value} on the host path")


def filter_operator_for(seg, p: Predicate) -> str:
    """The host's filter operator for a predicate on a segment, by index
    priority (sorted > inverted > scan; raw columns: range index > scan),
    as the JAX package chooses it and EXPLAIN names it."""
    lhs = p.lhs
    if not (lhs.is_identifier and lhs.name in seg.metadata.columns):
        return "FULL_SCAN"
    meta = seg.column_metadata(lhs.name)
    if p.type is PredicateType.JSON_MATCH:
        return "JSON_INDEX" if getattr(meta, "has_json_index", False) \
            else "FULL_SCAN"
    if p.type is PredicateType.TEXT_MATCH:
        return "TEXT_INDEX" if getattr(meta, "has_text_index", False) \
            else "FULL_SCAN"
    if p.type in (PredicateType.IS_NULL, PredicateType.IS_NOT_NULL):
        return "FULL_SCAN"
    if meta.encoding != Encoding.DICT or not meta.single_value:
        if meta.encoding == Encoding.RAW and meta.single_value and \
                meta.has_range and p.type in (PredicateType.EQ,
                                              PredicateType.RANGE):
            return "RANGE_INDEX"
        return "FULL_SCAN"
    indexed = p.type in (PredicateType.EQ, PredicateType.IN,
                         PredicateType.RANGE)
    if meta.is_sorted and indexed:
        return "SORTED_INDEX"
    if meta.has_inverted and indexed:
        return "INVERTED_INDEX"
    return "FULL_SCAN"


def geo_candidates(seg, p: Predicate):
    """(candidate docs, column, query lon, query lat) of an
    ``ST_DISTANCE(col, constant point)`` range on a segment with a geo
    grid that can bound it (engine/host.py ``_geo_distance_mask``), else
    None: the predicate then takes the generic evaluation."""
    e = p.lhs
    if p.type is not PredicateType.RANGE or p.upper is None \
            or not (e.is_function and e.name == "st_distance"
                    and len(e.args) == 2):
        return None
    col_arg = qpt_arg = None
    for a, b in ((e.args[0], e.args[1]), (e.args[1], e.args[0])):
        if a.is_identifier and _constant(b):
            col_arg, qpt_arg = a, b
            break
    if col_arg is None or col_arg.name not in seg.metadata.columns:
        return None
    try:
        idx = seg.geo_index(col_arg.name)
    except Exception:  # noqa: BLE001 — absent/corrupt index: scan
        idx = None
    if idx is None:
        return None
    qlon, qlat = geo_ops.parse_points(np_eval(qpt_arg, {}))
    if len(qlon) != 1 or not np.isfinite(qlon[0]):
        return None
    cand = idx.candidate_docs(float(qlon[0]), float(qlat[0]),
                              float(p.upper))
    if cand is None:
        return None   # antimeridian / pole box: no superset promised
    cand = np.asarray(cand)
    return cand[cand < seg.n_docs], col_arg.name, float(qlon[0]), \
        float(qlat[0])


def _predicate_entries(seg, p: Predicate, n: int) -> int:
    """Entries the host reads to evaluate one predicate on one segment."""
    lhs = p.lhs
    cols = seg.metadata.columns
    if p.type in _NULL_PREDS:
        return 0   # the null vector: read before the host counts a scan
    if p.type is PredicateType.JSON_MATCH:
        return 0 if getattr(seg.column_metadata(lhs.name),
                            "has_json_index", False) else n
    if p.type is PredicateType.TEXT_MATCH:
        return 0 if getattr(seg.column_metadata(lhs.name),
                            "has_text_index", False) else n
    geo = geo_candidates(seg, p)
    if geo is not None:
        return len(geo[0])
    if lhs.is_identifier and lhs.name not in cols \
            and p.type not in _NULL_PREDS:
        spec = evolved_spec(seg, lhs.name)
        if spec is not None and not spec.single_value:
            return 0   # no entries: match-any matches none
    if lhs.is_identifier and lhs.name in cols \
            and p.type in (PredicateType.EQ, PredicateType.IN) \
            and getattr(seg.column_metadata(lhs.name), "has_bloom", False):
        vals = [p.value] if p.type is PredicateType.EQ else list(p.values)
        if vals and provably_absent(seg, lhs.name, vals):
            return 0  # the bloom check proves the segment empty
    if lhs.is_identifier and lhs.name in cols:
        meta = seg.column_metadata(lhs.name)
        if not meta.single_value and p.type not in _NULL_PREDS:
            return int(np.asarray(seg.mv_offsets(lhs.name))[-1])
        if meta.encoding == Encoding.DICT:
            op = filter_operator_for(seg, p)
            ids = np.nonzero(predicate_over_values(
                p, np.asarray(seg.dictionary(lhs.name).values)))[0]
            if op == "SORTED_INDEX":
                if len(ids) == 0 or ids[-1] - ids[0] + 1 == len(ids) \
                        or len(ids) <= INVERTED_MAX_IDS:
                    return 0
            elif op == "INVERTED_INDEX" and len(ids) <= INVERTED_MAX_IDS \
                    and seg.inverted(lhs.name) is not None:
                return 0
            return n
        if filter_operator_for(seg, p) == "RANGE_INDEX" \
                and seg.range_index(lhs.name) is not None:
            return 0
    return n


def filter_entries(f, seg) -> int:
    """numEntriesScannedInFilter of the host path on one segment: every
    predicate is evaluated (no short circuit) and adds the entries it
    reads."""
    if f is None or f.type in (FilterNodeType.CONSTANT_TRUE,
                               FilterNodeType.CONSTANT_FALSE):
        return 0
    if f.type is FilterNodeType.PREDICATE:
        return _predicate_entries(seg, f.predicate, seg.n_docs)
    return sum(filter_entries(c, seg) for c in f.children)


# ---------------------------------------------------------------------------
# rows an MV group-by or aggregation expands the docs into
# ---------------------------------------------------------------------------


class SpaceEvaluator(ValueEvaluator):
    """``ValueEvaluator`` over a space of rows that repeat the batch's
    docs, laid out (S, Lx) with each segment's rows first (engine/rows.py):
    ``src`` (S*Lx,) the flat doc position each row reads; ``mv_vals``
    the MV columns whose value differs per row (an entry), as (S, Lx)
    ``Val``s, with their entry hashes in ``mv_hash``. Any other
    expression is the base evaluator's over the batch, gathered by
    ``src``."""

    def __init__(self, base: ValueEvaluator, Lx: int, src: torch.Tensor,
                 mv_vals: dict, mv_hash: dict | None = None):
        self.__dict__.update(base.__dict__)
        self.base, self.L, self.src = base, Lx, src
        self.mv_vals, self.mv_hash = dict(mv_vals), dict(mv_hash or {})
        self.ctx = _SpaceContext(base.ctx, self)

    def gather(self, plane: torch.Tensor) -> torch.Tensor:
        """A base (S, L, ...) plane at this space's rows: (S, Lx, ...)."""
        b = self.base
        plane = torch.broadcast_to(plane, (b.S, b.L) + plane.shape[2:])
        return Rows(b.S, b.L, b.device, self.src).take(plane) \
            .reshape((self.S, self.L) + plane.shape[2:])

    def eval(self, e: Expression, rows: Rows) -> Val:
        if rows.idx is not None:
            raise AssertionError("a space's values are taken whole")
        if e.is_identifier and e.name in self.mv_vals:
            return self.mv_vals[e.name]
        b = self.base
        v = b.eval(e, Rows(b.S, b.L, b.device))
        if v.t.dim() == 0:
            return v
        if v.kind == "point":
            return dataclasses.replace(v, t=self.gather(v.t), meta=PointMeta(
                self.gather(v.meta.lat)))
        return dataclasses.replace(v, t=self.gather(v.t))

    def is_mv(self, name: str) -> bool:
        return name in self.mv_vals or self.base.is_mv(name)

    def column_dtype(self, name: str) -> np.dtype:
        if name in self.mv_vals:
            return self.mv_vals[name].dtype
        return self.base.column_dtype(name)


class _SpaceContext:
    """The batch as a ``SpaceEvaluator``'s space sees it: (S, Lx) planes,
    hash planes at its rows; anything else is the batch's."""

    def __init__(self, ctx, space: SpaceEvaluator):
        self._ctx, self._space = ctx, space
        self.pad_to = space.L

    def prehashed_column(self, name: str) -> torch.Tensor:
        if name in self._space.mv_hash:
            return self._space.mv_hash[name]
        return self._space.gather(self._ctx.prehashed_column(name))

    def __getattr__(self, name):
        return getattr(self._ctx, name)
