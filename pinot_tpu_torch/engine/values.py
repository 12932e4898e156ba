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
  predicate.

A shape without a form here raises ``DeviceUnsupported`` naming ROADMAP
queue 1, where the rest of the single-stage surface is listed.
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
    plane_slot,
    raw_predicate,
    to_device,
)
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


def later(what: str):
    """The in-band refusal of a shape this slice does not run."""
    return DeviceUnsupported(
        f"{what} comes with a later slice of the port (ROADMAP queue 1)")


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
class Val:
    """An evaluated expression. ``kind``: "num" (values at the host
    dtype), "dict" (global ids of the string dict column ``meta``), "seg"
    (segment index, ``$segmentName``), "host" (``$hostName``: zeros) or
    "case" (branch index into the string literals ``meta``)."""

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
    if v is None:
        raise later("a NULL literal in an expression")
    return np.asarray(v)


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

    # ---- columns -------------------------------------------------------
    def _check_column(self, name: str) -> None:
        for s in self.ctx.segments:
            if name not in s.metadata.columns:
                raise later(f"column {name!r}, absent from segment {s.name}")
        self.ctx.encoding(name)  # single-value, one encoding

    def column_dtype(self, name: str) -> np.dtype:
        """The dtype the host path's values of a column have."""
        self._check_column(name)
        if self.ctx.encoding(name) == Encoding.DICT:
            return np.asarray(self.ctx.global_dict(name).values).dtype
        return np.asarray(self.ctx.segments[0].forward(name)).dtype

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
            raise later(f"raw column {name!r} of {dt} values")
        plan = ctx.width_plan(name)
        if dt.kind == "f" and np.dtype(plan.dtype) != dt:
            # raw DOUBLE: the aggregation plane is float32, the host's
            # values are float64
            return Val(rows.take(ctx.exact_column(name)), "num", dt)
        v = rows.take(ctx.column(name)).to(_torch_dtype(dt))
        if plan.offset is not None:
            v = v + plan.offset
        return Val(v, "num", dt)

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
        else:
            fn = get_function(e.name)
            try:
                with np.errstate(all="ignore"):
                    if e.name == "cast":
                        out = fn.np_fn(self.probe(e.args[0]), e.args[1].value)
                    else:
                        out = fn.np_fn(*[self.probe(a) for a in e.args])
            except (TypeError, ValueError) as err:
                raise later(f"{e}: {err}") from err
            out = np.asarray(out)
        self._probes[e] = out
        return out

    # ---- expressions -----------------------------------------------------
    def eval(self, e: Expression, rows: Rows) -> Val:
        if e.is_literal:
            a = _probe_literal(e.value)
            if a.dtype.kind not in "biuf":
                raise later(f"the string literal {e.value!r} in an expression")
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
        if e.name in _COMPARE and any(
                a.is_literal and isinstance(a.value, str) for a in e.args):
            return self._string_compare(e, rows)
        out_dt = self.probe(e).dtype
        args = [self.eval(a, rows) for a in e.args
                if not (e.name == "cast" and a is e.args[1])]
        for a in args:
            if a.kind != "num":
                raise later(f"{e}: a string operand in an expression")
        t = [a.t for a in args]
        tdt = _torch_dtype(out_dt) if out_dt.kind in "biuf" else None
        name = e.name
        if name in _ARITH:
            return Val(_ARITH[name](*[x.to(tdt) for x in t]), "num", out_dt)
        if name == "divide":
            f = [x.to(torch.float64) for x in t]
            return Val((f[0] / f[1]).to(tdt), "num", out_dt)
        if name == "mod":
            a, b = (x.to(tdt) for x in t)
            if out_dt.kind == "f":
                # numpy: fmod, then moved to the divisor's sign
                r = torch.fmod(a, b)
                fix = (r != 0) & ((r < 0) != (b < 0))
                return Val(torch.where(fix, r + b, r), "num", out_dt)
            zero = b == 0
            r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
            return Val(torch.where(zero, torch.zeros_like(r), r), "num",
                       out_dt)
        if name in _UNARY:
            return Val(_UNARY[name](t[0].to(tdt)), "num", out_dt)
        if name in _ROUND:
            if len(t) > 1:
                raise later("ROUND with a scale")
            x = t[0].to(tdt)
            return Val(_ROUND[name](x) if out_dt.kind == "f" else x, "num",
                       out_dt)
        if name in _COMPARE:
            cdt = np.result_type(*[self.probe(a) for a in e.args])
            ct = _torch_dtype(cdt)
            return Val(_COMPARE[name](t[0].to(ct), t[1].to(ct)), "num",
                       out_dt)
        if name in ("and", "or"):
            m = t[0].to(torch.bool)
            for x in t[1:]:
                m = (m & x.to(torch.bool)) if name == "and" \
                    else (m | x.to(torch.bool))
            return Val(m, "num", out_dt)
        if name == "not":
            return Val(~t[0].to(torch.bool), "num", out_dt)
        if name == "cast":
            target = str(e.args[1].value).upper()
            np_t = _CAST_NP.get(target)
            if np_t is None or np_t is np.str_:
                raise later(f"CAST to {target}")
            x = t[0]
            if np.dtype(np_t).kind in "iu" and x.is_floating_point():
                x = torch.trunc(x.to(torch.float64))
            return Val(x.to(tdt), "num", out_dt)
        raise later(f"the function {name.upper()}")

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
        else:
            raise later(f"{e}: a string literal against numbers")
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
        for c in cm:
            if c.kind != "num" or c.dtype.kind != "b":
                raise later(f"{e}: a CASE condition that is not boolean")
        if all(strs):
            # string results: the branch index on the card, the literal on
            # the host
            lits = np.asarray([v.value for v in vals])
            out = torch.full(rows.seg().shape, len(conds), dtype=torch.int64,
                             device=self.device)
            for j in reversed(range(len(conds))):
                out = torch.where(cm[j].t, j, out)
            return Val(out, "case", lits.dtype, lits)
        if any(strs):
            raise later(f"{e}: a CASE mixing string and numeric results")
        out_dt = self.probe(e).dtype
        tdt = _torch_dtype(out_dt)
        vv = [self.eval(v, rows) for v in vals]
        out = vv[-1].t.to(tdt)
        for j in reversed(range(len(conds))):
            out = torch.where(cm[j].t, vv[j].t.to(tdt), out)
        return Val(torch.broadcast_to(out, rows.seg().shape), "num", out_dt)

    # ---- keys: equality and order ----------------------------------------
    def key(self, v: Val, shape=None) -> torch.Tensor:
        """int64 keys whose equality and order are the host's over the
        values: numbers by value (``order_key``), strings by rank."""
        if v.kind == "num":
            k = order_key(v.t)
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

    def decode(self, v: Val, host: np.ndarray) -> np.ndarray:
        """Host values of a fetched ``Val.t``."""
        if v.kind == "num":
            return np.asarray(host).astype(v.dtype, copy=False)
        if v.kind == "dict":
            return self.ctx.global_dict(v.meta).take(np.asarray(host))
        if v.kind == "seg":
            return self.seg_names[np.asarray(host)]
        if v.kind == "host":
            return self.host_names[np.zeros(len(host), dtype=np.int64)]
        return np.asarray(v.meta)[np.asarray(host)]

    def decode_key(self, v: Val, host_keys: np.ndarray) -> np.ndarray:
        """Host values of fetched ``key`` values."""
        k = np.asarray(host_keys, dtype=np.int64)
        if v.kind == "num":
            return from_order_key(torch.from_numpy(k), v.dtype).numpy()
        if v.kind == "dict":
            return self.ctx.global_dict(v.meta).take(k)
        if v.kind == "seg":
            return self.seg_sorted[k]
        if v.kind == "host":
            return self.host_names[np.zeros(len(k), dtype=np.int64)]
        return np.unique(v.meta)[k]

    # ---- filters: the host path's leaves of build_filter -----------------
    def predicate_leaf(self, p: Predicate, params: dict, counter: list):
        """The filter template leaf (engine/params.py ``build_filter``) of
        ``p`` over the host path's values, or None for a dict column's
        predicate, which the template builds as the device does. The
        segment names' predicates become a mask; any other lhs its values
        at the host's dtype, compared with the literals in the dtype numpy
        compares them in."""
        if p.type not in DEVICE_PRED_TYPES:
            raise later(f"the predicate {p.type.value}")
        lhs = p.lhs
        full = Rows(self.S, self.L, self.device)
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
        if v.kind != "num":
            raise later(f"the predicate {p} over string values")
        if p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
            raise later(f"the predicate {p} over numeric values")
        arr = self.probe(lhs)
        if p.type in (PredicateType.IN, PredicateType.NOT_IN):
            lits = np.asarray(list(p.values))
            if lits.dtype.kind not in "biuf":
                raise later(f"the predicate {p}: string literals against "
                            f"numbers")
            dt = np.result_type(arr.dtype, lits.dtype)
        else:
            lits = [p.value] if p.type in (PredicateType.EQ,
                                           PredicateType.NOT_EQ) \
                else [x for x in (p.lower, p.upper) if x is not None]
            if any(isinstance(x, str) for x in lits):
                raise later(f"the predicate {p}: a string literal against "
                            f"numbers")
            dt = np.dtype(np.int64) if arr.dtype.kind in "iub" and all(
                isinstance(x, (int, bool)) for x in lits) \
                else np.result_type(arr, *lits)
        plane = torch.broadcast_to(v.t.to(_torch_dtype(dt)), full.seg().shape)
        return raw_predicate(p, plane_slot(params, counter, plane), params,
                             counter, self.device, dt)


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
    raise later(f"the predicate {t.value}")


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


def _predicate_entries(seg, p: Predicate, n: int) -> int:
    """Entries the host reads to evaluate one predicate on one segment."""
    lhs = p.lhs
    cols = seg.metadata.columns
    if lhs.is_identifier and lhs.name in cols \
            and p.type in (PredicateType.EQ, PredicateType.IN) \
            and getattr(seg.column_metadata(lhs.name), "has_bloom", False):
        vals = [p.value] if p.type is PredicateType.EQ else list(p.values)
        if vals and provably_absent(seg, lhs.name, vals):
            return 0  # the bloom check proves the segment empty
    if lhs.is_identifier and lhs.name in cols:
        meta = seg.column_metadata(lhs.name)
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
