"""Transform-function registry: one semantic definition, two backends.

The reference's ~50 TransformFunction classes
(pinot-core/.../operator/transform/function/) plus the @ScalarFunction
registry (pinot-common/.../function/scalar/) collapse here into a table of
(numpy impl, torch impl) pairs. The device template evaluates the torch
impl over CUDA tensors; a function without one is host-only, and the
device template build raises DeviceUnsupported for it (the port has no
host scan path to fall back to).

Division follows the reference: DOUBLE division, x/0 → inf (Java double
semantics), so results match across backends and the duckdb oracle modulo
float formatting.

Binary torch impls promote their operands as the JAX package's arrays do
(``torch.promote_types`` over both dtypes): a 0-d literal tensor would
otherwise take the column's dtype under torch's scalar rules (int32 column
times int64 literal stays int32 and wraps) where the reference widens.
"""

from __future__ import annotations

import numpy as np
import torch


class FunctionDef:
    def __init__(self, name, np_fn, torch_fn=None, min_args=1, max_args=None,
                 returns_bool=False):
        self.name = name
        self.np_fn = np_fn
        self.torch_fn = torch_fn  # None → host-only
        self.min_args = min_args
        self.max_args = max_args if max_args is not None else min_args
        self.returns_bool = returns_bool

    @property
    def device_capable(self) -> bool:
        return self.torch_fn is not None


REGISTRY: dict[str, FunctionDef] = {}


def _reg(name, np_fn, torch_fn=None, min_args=1, max_args=None, returns_bool=False):
    REGISTRY[name] = FunctionDef(name, np_fn, torch_fn, min_args, max_args, returns_bool)


def get_function(name: str) -> FunctionDef:
    f = REGISTRY.get(name)
    if f is None:
        raise KeyError(f"unknown function: {name}")
    return f


def _promoted(*args):
    dt = args[0].dtype
    for x in args[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in args]


def _bin(fn):
    """torch binary op over operands promoted like JAX arrays."""
    return lambda a, b: fn(*_promoted(a, b))


def _as_float(a):
    return a if a.is_floating_point() else a.to(torch.float32)


def _float(fn):
    """torch unary float op: integer inputs go through float32, the
    device value space of the JAX package."""
    return lambda a: fn(_as_float(a))


# ---- arithmetic -----------------------------------------------------------

def _np_div(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.asarray(a, dtype=np.float64) / np.asarray(b, dtype=np.float64)


def _torch_div(a, b):
    return a.to(torch.float32) / b.to(torch.float32)


def _torch_round(a, scale=None):
    if scale is not None:
        raise KeyError("ROUND with a scale is host-only")
    return torch.round(a) if a.is_floating_point() else a


_reg("plus", lambda a, b: np.add(a, b), _bin(lambda a, b: torch.add(a, b)), 2)
_reg("minus", lambda a, b: np.subtract(a, b), _bin(lambda a, b: torch.sub(a, b)), 2)
_reg("times", lambda a, b: np.multiply(a, b), _bin(lambda a, b: torch.mul(a, b)), 2)
_reg("divide", _np_div, _torch_div, 2)
_reg("mod", lambda a, b: np.mod(a, b), _bin(lambda a, b: torch.remainder(a, b)), 2)
_reg("abs", np.abs, (lambda a: torch.abs(a)), 1)
_reg("ceil", np.ceil, _float(torch.ceil), 1)
_reg("floor", np.floor, _float(torch.floor), 1)
_reg("exp", np.exp, _float(torch.exp), 1)
_reg("ln", np.log, _float(torch.log), 1)
_reg("log2", np.log2, _float(torch.log2), 1)
_reg("log10", np.log10, _float(torch.log10), 1)
_reg("sqrt", np.sqrt, _float(torch.sqrt), 1)
_reg("power", np.power, _bin(lambda a, b: torch.pow(a, b)), 2)
_reg("pow", np.power, _bin(lambda a, b: torch.pow(a, b)), 2)
_reg("least", np.minimum, _bin(lambda a, b: torch.minimum(a, b)), 2)
_reg("greatest", np.maximum, _bin(lambda a, b: torch.maximum(a, b)), 2)
_reg("sign", np.sign, (lambda a: torch.sign(a)), 1)
_reg("round", np.round, _torch_round, 1, 2)

# trigonometric (scalar/Trigonometric*.java)
for _n, _np, _t in [
    ("sin", np.sin, "sin"), ("cos", np.cos, "cos"), ("tan", np.tan, "tan"),
    ("asin", np.arcsin, "asin"), ("acos", np.arccos, "acos"),
    ("atan", np.arctan, "atan"), ("sinh", np.sinh, "sinh"),
    ("cosh", np.cosh, "cosh"), ("tanh", np.tanh, "tanh"),
    ("degrees", np.degrees, "rad2deg"), ("radians", np.radians, "deg2rad"),
]:
    _reg(_n, _np, _float(lambda a, _f=_t: getattr(torch, _f)(a)), 1)

# ---- comparisons (usable inside CASE / arithmetic contexts) ---------------

_reg("equals", lambda a, b: np.equal(a, b), _bin(torch.eq), 2, returns_bool=True)
_reg("not_equals", lambda a, b: np.not_equal(a, b), _bin(torch.ne), 2, returns_bool=True)
_reg("greater_than", lambda a, b: np.greater(a, b), _bin(torch.gt), 2, returns_bool=True)
_reg("greater_than_or_equal", lambda a, b: np.greater_equal(a, b), _bin(torch.ge), 2, returns_bool=True)
_reg("less_than", lambda a, b: np.less(a, b), _bin(torch.lt), 2, returns_bool=True)
_reg("less_than_or_equal", lambda a, b: np.less_equal(a, b), _bin(torch.le), 2, returns_bool=True)
_reg("and", lambda *a: np.logical_and.reduce(a),
     lambda *a: torch.stack(torch.broadcast_tensors(*a)).bool().all(0), 2, 99,
     returns_bool=True)
_reg("or", lambda *a: np.logical_or.reduce(a),
     lambda *a: torch.stack(torch.broadcast_tensors(*a)).bool().any(0), 2, 99,
     returns_bool=True)
_reg("not", np.logical_not, (lambda a: torch.logical_not(a)), 1, returns_bool=True)


# ---- CASE / CAST ----------------------------------------------------------

def _np_case(*args):
    # (c1, v1, c2, v2, ..., else)
    conds = list(args[:-1:2])
    vals = list(args[1:-1:2])
    return np.select(conds, vals, default=args[-1])


def _torch_case(*args):
    out = args[-1]
    for c, v in zip(reversed(args[:-1:2]), reversed(args[1:-1:2])):
        v, out = _promoted(v, out)
        out = torch.where(c.bool(), v, out)
    return out


_reg("case", _np_case, _torch_case, 3, 99)

_CAST_NP = {
    "INT": np.int32, "INTEGER": np.int32, "LONG": np.int64, "BIGINT": np.int64,
    "FLOAT": np.float32, "DOUBLE": np.float64, "BOOLEAN": np.bool_,
    "STRING": np.str_, "VARCHAR": np.str_, "TIMESTAMP": np.int64,
}
# DOUBLE casts to float32: the device value space (storage/device.py)
_CAST_TORCH = {
    "INT": "int32", "INTEGER": "int32", "LONG": "int64", "BIGINT": "int64",
    "FLOAT": "float32", "DOUBLE": "float32", "BOOLEAN": "bool",
    "TIMESTAMP": "int64",
}


def _np_cast(a, type_name):
    t = _CAST_NP.get(str(type_name).upper())
    if t is None:
        raise KeyError(f"CAST to unsupported type {type_name}")
    if t is np.str_:
        return np.asarray(a).astype(str)
    if np.issubdtype(t, np.integer):
        # SQL CAST truncates toward zero
        return np.trunc(np.asarray(a, dtype=np.float64)).astype(t) \
            if np.asarray(a).dtype.kind == "f" else np.asarray(a).astype(t)
    return np.asarray(a).astype(t)


def _torch_cast(a, type_name):
    t = _CAST_TORCH.get(str(type_name).upper())
    if t is None:
        raise KeyError(f"CAST to {type_name} is host-only")
    if t.startswith("int") and a.is_floating_point():
        a = torch.trunc(a)
    return a.to(getattr(torch, t))


_reg("cast", _np_cast, _torch_cast, 2)


# ---- string functions (host-only; device work stays in dict-id space) -----

def _u(a):
    return np.asarray(a).astype(str)


_reg("lower", lambda a: np.char.lower(_u(a)))
_reg("upper", lambda a: np.char.upper(_u(a)))
_reg("trim", lambda a: np.char.strip(_u(a)))
_reg("ltrim", lambda a: np.char.lstrip(_u(a)))
_reg("rtrim", lambda a: np.char.rstrip(_u(a)))
_reg("reverse", lambda a: np.array([s[::-1] for s in _u(a)]))
_reg("length", lambda a: np.char.str_len(_u(a)).astype(np.int32))
_reg("strlen", lambda a: np.char.str_len(_u(a)).astype(np.int32))
_reg("concat", lambda *a: np.char.add(*[_u(x) for x in a]) if len(a) == 2
     else _concat_many(a), min_args=2, max_args=99)
_reg("substr", lambda a, start, end=None: _substr(a, start, end), 2, 3)
_reg("startswith", lambda a, p: np.char.startswith(_u(a), p), 2, returns_bool=True)
_reg("endswith", lambda a, p: np.char.endswith(_u(a), p), 2, returns_bool=True)
_reg("replace", lambda a, f, t: np.char.replace(_u(a), f, t), 3)
_reg("lpad", lambda a, n, p: np.array([s.rjust(int(n), str(p)) for s in _u(a)]), 3)
_reg("rpad", lambda a, n, p: np.array([s.ljust(int(n), str(p)) for s in _u(a)]), 3)
_reg("codepoint", lambda a: np.array([ord(s[0]) if s else 0 for s in _u(a)], dtype=np.int32))
_reg("chr", lambda a: np.array([chr(int(x)) for x in np.asarray(a).ravel()]))


def _concat_many(arrs):
    out = _u(arrs[0])
    for x in arrs[1:]:
        out = np.char.add(out, _u(x))
    return out


def _substr(a, start, end=None):
    # Pinot substr(col, start[, end]) is 0-based, end exclusive
    s = _u(a)
    start = int(start)
    if end is None:
        return np.array([x[start:] for x in s])
    return np.array([x[start:int(end)] for x in s])


# ---- JSON (host-only; JsonFunctions.java / JsonExtractScalar analog) ------

_JSON_PATH_RE = None  # compiled lazily


def _json_path_steps(path: str) -> list:
    import re as _re

    global _JSON_PATH_RE
    if _JSON_PATH_RE is None:
        _JSON_PATH_RE = _re.compile(r"\.([^.\[\]]+)|\[(\d+)\]")
    if not path.startswith("$"):
        raise ValueError(f"json path must start with $: {path!r}")
    steps = []
    pos = 1
    for m in _JSON_PATH_RE.finditer(path, 1):
        if m.start() != pos:
            # unparsable segment (e.g. [*] or a typo): reject instead of
            # silently navigating a different path
            raise ValueError(f"unsupported json path {path!r} "
                             f"(scalar paths only, no wildcards)")
        steps.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(path):
        raise ValueError(f"unsupported json path {path!r} "
                         f"(scalar paths only, no wildcards)")
    return steps


def _json_nav(obj, steps):
    for s in steps:
        if isinstance(s, int):
            if not isinstance(obj, list) or s >= len(obj):
                return None
            obj = obj[s]
        else:
            if not isinstance(obj, dict):
                return None
            obj = obj.get(s)
        if obj is None:
            return None
    return obj


_JSON_RESULT_TYPES = {
    "INT": (np.int32, 0), "LONG": (np.int64, 0),
    "FLOAT": (np.float32, 0.0), "DOUBLE": (np.float64, 0.0),
    "STRING": (np.str_, ""), "BOOLEAN": (np.bool_, False),
}


def _json_extract_scalar(col, path, result_type, default=None):
    import json as _json

    def lit(x):
        a = np.asarray(x)
        return a.item() if a.ndim == 0 else x

    path, result_type = str(lit(path)), str(lit(result_type)).upper()
    if result_type not in _JSON_RESULT_TYPES:
        raise KeyError(f"json_extract_scalar result type {result_type}")
    dtype, type_default = _JSON_RESULT_TYPES[result_type]
    default = type_default if default is None else lit(default)
    steps = _json_path_steps(path)
    out = []
    for s in np.asarray(col).ravel():
        try:
            v = _json_nav(_json.loads(str(s)), steps)
        except (ValueError, TypeError):
            v = None
        if v is None or isinstance(v, (dict, list)):
            out.append(default)
        elif result_type == "BOOLEAN":
            out.append(v if isinstance(v, bool) else str(v).lower() == "true")
        else:
            out.append(v)
    if dtype is np.str_:
        return np.asarray([str(v) for v in out], dtype=np.str_)
    return np.asarray(out).astype(dtype)


_reg("json_extract_scalar", _json_extract_scalar, min_args=3, max_args=4)
_reg("jsonextractscalar", _json_extract_scalar, min_args=3, max_args=4)


# ---- geospatial (host-only; ops/geo.py — ST_* function analogs) -----------

def _geo(name):
    from pinot_tpu_torch.ops import geo

    return getattr(geo, name)


_reg("st_point", lambda lon, lat: _geo("st_point")(lon, lat), min_args=2,
     max_args=2)
_reg("st_distance", lambda a, b: _geo("st_distance")(a, b), min_args=2,
     max_args=2)
_reg("st_contains", lambda p, pt: _geo("st_contains")(p, pt), min_args=2,
     max_args=2, returns_bool=True)
_reg("st_within", lambda pt, p: _geo("st_within")(pt, p), min_args=2,
     max_args=2, returns_bool=True)
_reg("st_geogfromtext", lambda w: _geo("st_geog_from_text")(w), min_args=1)
_reg("st_geomfromtext", lambda w: _geo("st_geog_from_text")(w), min_args=1)
_reg("st_astext", lambda g: _geo("st_as_text")(g), min_args=1)
_reg("st_polygon", lambda w: _geo("st_polygon")(w), min_args=1)
_reg("st_area", lambda p: _geo("st_area")(p), min_args=1)
_reg("st_asbinary", lambda p: _geo("st_as_binary")(p), min_args=1)
_reg("st_geomfromwkb", lambda b: _geo("st_geom_from_wkb")(b), min_args=1)
_reg("st_geogfromwkb", lambda b: _geo("st_geom_from_wkb")(b), min_args=1)


# ---- lookup join (host-only; evaluated by SegmentEvaluator._lookup with
# engine dim-table state — the np_fn here is never called directly) ---------

def _lookup_stub(*a):
    raise ValueError("LOOKUP needs an engine with dimension tables")


_reg("lookup", _lookup_stub, min_args=4, max_args=4)


# ---- datetime (host-only) -------------------------------------------------

_reg("year", lambda a: _dtfield(a, "year"))
_reg("month", lambda a: _dtfield(a, "month"))
_reg("dayofmonth", lambda a: _dtfield(a, "day"))
_reg("dayofweek", lambda a: _dtfield(a, "dayofweek"))
_reg("hour", lambda a: _dtfield(a, "hour"))
_reg("minute", lambda a: _dtfield(a, "minute"))
_reg("second", lambda a: _dtfield(a, "second"))
_reg("frommillis", lambda a: np.asarray(a, dtype=np.int64))
_reg("tomillis", lambda a: np.asarray(a, dtype=np.int64))


def _dtfield(millis, field):
    dt = np.asarray(millis, dtype="int64").astype("datetime64[ms]")
    Y = dt.astype("datetime64[Y]")
    M = dt.astype("datetime64[M]")
    D = dt.astype("datetime64[D]")
    if field == "year":
        return Y.astype(int) + 1970
    if field == "month":
        return (M - Y).astype(int) + 1
    if field == "day":
        return (D - M).astype(int) + 1
    if field == "dayofweek":
        return ((D.astype(int) + 4) % 7) + 1  # 1970-01-01 was a Thursday
    sec = dt.astype("datetime64[s]")
    if field == "hour":
        return ((sec - D).astype(int) // 3600).astype(np.int32)
    if field == "minute":
        return (((sec - D).astype(int) // 60) % 60).astype(np.int32)
    if field == "second":
        return ((sec - D).astype(int) % 60).astype(np.int32)
    raise KeyError(field)


# ---- TIMECONVERT / DATETIMECONVERT (host-only) ----------------------------
# Reference: TimeConversionTransformFunction.java,
# DateTimeConversionTransformFunction.java:80 + DateTimeFormatSpec — the
# workhorse Pinot time-rollup functions.

_UNIT_MS = {
    "NANOSECONDS": 1e-6, "MICROSECONDS": 1e-3, "MILLISECONDS": 1,
    "SECONDS": 1_000, "MINUTES": 60_000, "HOURS": 3_600_000,
    "DAYS": 86_400_000,
}


def _unit_ms(unit: str) -> float:
    u = str(unit).upper()
    if u not in _UNIT_MS:
        raise ValueError(f"unknown time unit {unit!r}")
    return _UNIT_MS[u]


def _div_trunc(v: np.ndarray, d: np.int64) -> np.ndarray:
    """Integer division truncating toward ZERO (Java long division) — numpy
    // floors, which differs on negatives."""
    return np.sign(v) * (np.abs(v) // d)


def _to_millis(values: np.ndarray, unit: str) -> np.ndarray:
    """TimeUnit.MILLISECONDS.convert(value, unit) — exact integer
    arithmetic, truncating toward zero like Java (a float64 path here
    rounded epoch-nanos into the wrong millisecond bucket)."""
    f = _unit_ms(unit)
    v = np.asarray(values, dtype=np.int64)
    if f >= 1:
        return v * np.int64(f)
    return _div_trunc(v, np.int64(round(1 / f)))


def _from_millis(millis: np.ndarray, unit: str) -> np.ndarray:
    f = _unit_ms(unit)
    ms = np.asarray(millis, dtype=np.int64)
    if f >= 1:
        return _div_trunc(ms, np.int64(f))
    return ms * np.int64(round(1 / f))


def _timeconvert(values, from_unit, to_unit):
    return _from_millis(_to_millis(values, str(from_unit)), str(to_unit))


_reg("timeconvert", _timeconvert, min_args=3, max_args=3)

# Java SimpleDateFormat tokens → strftime (longest-first so yyyy wins over
# yy). SSS maps to %f for PARSING (strptime right-pads fraction digits to
# microseconds, matching SDF millis); formatting post-processes %f's 6
# digits down to SDF's 3 (_fix_sss).
_SDF_TOKENS = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f"), ("a", "%p"),
    ("EEE", "%a"), ("M", "%m"), ("d", "%d"), ("H", "%H"), ("h", "%I"),
]


def _sdf_to_strftime(pattern: str) -> str:
    out, i = [], 0
    while i < len(pattern):
        for tok, rep in _SDF_TOKENS:
            if pattern.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(pattern[i])
            i += 1
    return "".join(out)


class _DateTimeFormat:
    """DateTimeFormatSpec: 'size:unit:EPOCH' or
    'size:unit:SIMPLE_DATE_FORMAT:pattern[ tz(...)]'."""

    def __init__(self, spec: str):
        parts = str(spec).split(":", 3)
        if len(parts) < 3:
            raise ValueError(f"bad datetime format {spec!r}")
        self.size = int(parts[0])
        self.unit = parts[1].upper()
        self.fmt = parts[2].upper()
        self.pattern = parts[3] if len(parts) > 3 else None
        if self.fmt == "SIMPLE_DATE_FORMAT" and self.pattern:
            pat = self.pattern
            if " tz(" in pat:
                pat, tz = pat.split(" tz(", 1)
                tz = tz.rstrip(")")
                if tz.upper() not in ("UTC", "GMT"):
                    raise ValueError(
                        f"only UTC SIMPLE_DATE_FORMAT timezones supported "
                        f"(got {tz!r})")
            self.strftime = _sdf_to_strftime(pat)

    def to_millis(self, values: np.ndarray) -> np.ndarray:
        if self.fmt == "EPOCH":
            return _to_millis(
                np.asarray(values, dtype=np.int64) * self.size, self.unit)
        if self.fmt in ("SIMPLE_DATE_FORMAT", "TIMESTAMP"):
            import pandas as pd

            if self.fmt == "TIMESTAMP":
                dt = pd.to_datetime(np.asarray(values))
            else:
                vals = np.asarray(values).astype(str)
                fmt = self.strftime
                if "%Y" not in fmt and "%y" not in fmt:
                    # Java SDF defaults missing date fields to the 1970
                    # epoch; C strptime defaults to 1900 — pin the base
                    vals = np.char.add("1970-01-01 ", vals)
                    fmt = "%Y-%m-%d " + fmt
                dt = pd.to_datetime(vals, format=fmt)
            # normalize to ms regardless of the index's native resolution
            # (pandas 2.x may parse to s/us/ns depending on the format)
            return np.asarray(dt, dtype="datetime64[ms]").astype(np.int64)
        raise ValueError(f"unknown datetime format {self.fmt!r}")

    def from_millis(self, millis: np.ndarray):
        if self.fmt == "EPOCH":
            return _div_trunc(_from_millis(millis, self.unit),
                              np.int64(self.size))
        import pandas as pd

        ms = np.asarray(millis, dtype=np.int64)
        dt = pd.to_datetime(ms, unit="ms")
        fmt = self.strftime
        # U-dtype (not object): string results flow into group keys and the
        # DataTable wire codec, which round-trips numpy string arrays but
        # refuses pickled object arrays
        if "%f" in fmt:
            # SDF's SSS is 3-digit millis; strftime %f would emit 6-digit
            # micros — format around a sentinel and splice the millis in
            sent = "\x00"
            base = np.asarray(dt.strftime(fmt.replace("%f", sent)))
            frac = np.char.zfill((ms % 1000).astype(str), 3)
            return np.asarray(
                [s.replace(sent, f) for s, f in zip(base, frac)],
                dtype=np.str_)
        return np.asarray(dt.strftime(fmt), dtype=np.str_)


def _datetimeconvert(values, in_fmt, out_fmt, granularity):
    inf = _DateTimeFormat(str(in_fmt))
    outf = _DateTimeFormat(str(out_fmt))
    gsize, gunit = str(granularity).split(":", 1)
    g = np.int64(int(gsize) * _unit_ms(gunit))
    ms = inf.to_millis(values)
    bucketed = _div_trunc(ms, g) * g
    return outf.from_millis(bucketed)


_reg("datetimeconvert", _datetimeconvert, min_args=4, max_args=4)


# ---- array / MV transforms (host-only) ------------------------------------
# Reference: ArrayLength/ArraySum/ArrayAverage/ArrayMin/ArrayMax
# TransformFunction.java, ValueInTransformFunction.java:1,
# MapValueTransformFunction. MV identifier evaluation yields an object
# array of per-doc entry arrays (or a 2-D array when all docs have equal
# entry counts) — helpers handle both.


def _mv_rows(col):
    arr = np.asarray(col)
    if arr.ndim == 2:
        return list(arr)
    if arr.dtype == object:
        return [np.asarray(r) for r in arr]
    # an SV column is a 1-entry MV per the reference's implicit widening
    return [np.asarray([v]) for v in arr]


def _array_reduce(col, fn, empty):
    rows = _mv_rows(col)
    return np.asarray([fn(r) if len(r) else empty for r in rows])


_reg("arraylength", lambda c: np.asarray([len(r) for r in _mv_rows(c)],
                                         dtype=np.int64), min_args=1)
_reg("cardinality", lambda c: np.asarray([len(r) for r in _mv_rows(c)],
                                         dtype=np.int64), min_args=1)
_reg("arraysum", lambda c: _array_reduce(c, np.sum, 0.0), min_args=1)
_reg("arrayaverage",
     lambda c: _array_reduce(c, np.mean, float("nan")), min_args=1)
_reg("arraymin", lambda c: _array_reduce(c, np.min, float("inf")), min_args=1)
_reg("arraymax", lambda c: _array_reduce(c, np.max, float("-inf")), min_args=1)


def _valuein(col, *wanted):
    """Per-doc entry filter: keep MV entries ∈ {wanted} (the reference
    dedups while preserving first-seen order)."""
    want = {np.asarray(w).item() for w in wanted}
    rows = _mv_rows(col)
    out = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        seen, kept = set(), []
        for v in r.tolist():
            if v in want and v not in seen:
                seen.add(v)
                kept.append(v)
        out[i] = kept
    return out


_reg("valuein", _valuein, min_args=2, max_args=99)


def _mapvalue(keys_col, key, values_col):
    """MAPVALUE(map__KEYS, 'k', map__VALUES): per doc, the value at the
    key's position in the keys MV (reference MapValueTransformFunction);
    missing keys yield the value column's type default."""
    k = np.asarray(key).item()
    krows = _mv_rows(keys_col)
    vrows = _mv_rows(values_col)
    first = next((r for r in vrows if len(r)), None)
    if first is not None and np.asarray(first).dtype.kind in "UOS":
        default = ""
    else:
        default = 0
    out = []
    for kr, vr in zip(krows, vrows):
        hits = np.nonzero(np.asarray(kr) == k)[0]
        if len(hits) and hits[0] < len(vr):
            out.append(np.asarray(vr)[hits[0]])
        else:
            out.append(default)
    return np.asarray(out)


_reg("mapvalue", _mapvalue, min_args=3, max_args=3)


# ---- REGEXP_EXTRACT (host-only) -------------------------------------------


def _regexp_extract(col, pattern, group=None, default=None):
    """REGEXP_EXTRACT(value, pattern[, group[, default]]) — first match's
    group (0 = whole match), or the default ('' like the reference's null
    string) when the pattern doesn't match
    (RegexpExtractTransformFunction.java)."""
    import re

    rx = re.compile(str(np.asarray(pattern).item()))
    g = int(np.asarray(group).item()) if group is not None else 0
    d = str(np.asarray(default).item()) if default is not None else ""
    vals = np.asarray(col)
    if vals.ndim == 0:
        vals = vals[None]
    # U-dtype so results can serve as group keys over the DataTable wire
    return np.asarray([
        (m.group(g) if (m := rx.search(str(v))) and g <= rx.groups else d)
        for v in vals.tolist()
    ])


_reg("regexp_extract", _regexp_extract, min_args=2, max_args=4)
_reg("regexpextract", _regexp_extract, min_args=2, max_args=4)


def _datetrunc(unit, millis):
    unit = str(unit).lower()
    ms = np.asarray(millis, dtype=np.int64)
    table = {
        "millisecond": 1, "second": 1000, "minute": 60_000, "hour": 3_600_000,
        "day": 86_400_000, "week": 7 * 86_400_000,
    }
    if unit in table:
        q = table[unit]
        return (ms // q) * q
    dt = ms.astype("datetime64[ms]")
    if unit == "month":
        return dt.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
    if unit == "year":
        return dt.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)
    raise KeyError(f"datetrunc unit {unit}")


_reg("datetrunc", _datetrunc, min_args=2, max_args=2)


# ---- transform-enum tail (TransformFunctionType.java) ---------------------
# QUARTER / WEEK_OF_YEAR / DAY_OF_YEAR / YEAR_OF_WEEK / MILLISECOND
# (DateTimeFunctions.java, UTC like the other datetime fns here),
# ATAN2 / COT / ROUND_DECIMAL / TRUNCATE (ArithmeticFunctions.java),
# JSONEXTRACTKEY, INIDSET, GEOTOH3 (grid-scheme role), ST_EQUALS,
# ST_GEOMETRY_TYPE.


def _epoch_days(millis):
    ms = np.asarray(millis, dtype=np.int64)
    return ms.astype("datetime64[ms]").astype("datetime64[D]").astype(np.int64)


def _iso_week_fields(millis):
    """(weekOfYear, yearOfWeek) under ISO-8601 week numbering (joda
    ISOChronology, DateTimeFunctions.weekOfYear/yearOfWeek): a week
    belongs to the year containing its Thursday."""
    D = _epoch_days(millis)
    wd = (D + 3) % 7                       # 0 = Monday (1970-01-01 was Thu)
    thu = D - wd + 3
    thu_dt = thu.astype("datetime64[D]")
    iso_year = thu_dt.astype("datetime64[Y]").astype(np.int64) + 1970
    jan1 = (iso_year - 1970).astype("datetime64[Y]").astype(
        "datetime64[D]").astype(np.int64)
    week = (thu - jan1) // 7 + 1
    return week.astype(np.int64), iso_year


def _quarter(millis):
    return (np.asarray(_dtfield(millis, "month"), dtype=np.int64) - 1) // 3 + 1


def _day_of_year(millis):
    dt = np.asarray(millis, dtype=np.int64).astype("datetime64[ms]")
    D = dt.astype("datetime64[D]")
    Y = dt.astype("datetime64[Y]")
    return (D - Y.astype("datetime64[D]")).astype(np.int64) + 1


def _millisecond(millis):
    # joda millisOfSecond: non-negative even for pre-epoch instants
    return np.mod(np.asarray(millis, dtype=np.int64), 1000)


_reg("quarter", _quarter)
_reg("weekofyear", lambda a: _iso_week_fields(a)[0])
_reg("week", lambda a: _iso_week_fields(a)[0])
_reg("yearofweek", lambda a: _iso_week_fields(a)[1])
_reg("yow", lambda a: _iso_week_fields(a)[1])
_reg("dayofyear", _day_of_year)
_reg("doy", _day_of_year)
_reg("millisecond", _millisecond)

_reg("atan2", np.arctan2,
     _bin(lambda a, b: torch.atan2(_as_float(a), _as_float(b))), 2)
_reg("cot", lambda a: _np_div(1.0, np.tan(np.asarray(a, dtype=np.float64))),
     _float(lambda a: 1.0 / torch.tan(a)), 1)


def _round_decimal(a, scale=None):
    """BigDecimal HALF_UP rounding (ArithmeticFunctions.roundDecimal) —
    np.round is half-EVEN, which differs on exact .5 boundaries."""
    v = np.asarray(a, dtype=np.float64)
    if scale is None:
        return np.floor(v + 0.5)  # Math.round
    s = 10.0 ** int(np.asarray(scale).item())
    return np.sign(v) * np.floor(np.abs(v) * s + 0.5) / s


def _truncate(a, scale=None):
    """Truncate toward zero to ``scale`` decimals (RoundingMode.DOWN)."""
    v = np.asarray(a, dtype=np.float64)
    if scale is None:
        return np.sign(v) * np.floor(np.abs(v))
    s = 10.0 ** int(np.asarray(scale).item())
    return np.sign(v) * np.floor(np.abs(v) * s) / s


_reg("rounddecimal", _round_decimal, None, 1, 2)
_reg("round_decimal", _round_decimal, None, 1, 2)
_reg("truncate", _truncate, None, 1, 2)


def _json_extract_key(col, path):
    """jsonExtractKey(jsonCol, 'jsonPath') → STRING_MV of the jayway-style
    paths matching the expression (JsonExtractKeyTransformFunction's
    AS_PATH_LIST contract). Scalar paths plus one trailing wildcard
    (``$.a.*`` / ``$.a[*]``) are supported — the subset the engine's json
    navigation models."""
    import json as _json

    p = str(np.asarray(path).item())
    wildcard = p.endswith(".*") or p.endswith("[*]")
    base = p[:-2] if p.endswith(".*") else (p[:-3] if p.endswith("[*]") else p)
    steps = _json_path_steps(base)

    def jay(parts):
        return "$" + "".join(
            f"[{s}]" if isinstance(s, int) else f"['{s}']" for s in parts)

    vals = np.asarray(col)
    if vals.ndim == 0:
        vals = vals[None]
    out = np.empty(len(vals), dtype=object)
    for i, s in enumerate(vals.tolist()):
        try:
            obj = _json_nav(_json.loads(str(s)), steps)
        except (ValueError, TypeError):
            obj = None
        paths = []
        if wildcard:
            if isinstance(obj, dict):
                paths = [jay(steps + [k]) for k in obj]
            elif isinstance(obj, list):
                paths = [jay(steps + [j]) for j in range(len(obj))]
        elif obj is not None:
            paths = [jay(steps)]
        out[i] = paths
    return out


_reg("jsonextractkey", _json_extract_key, min_args=2, max_args=2)
_reg("json_extract_key", _json_extract_key, min_args=2, max_args=2)


def _in_id_set(col, idset_b64):
    """inIdSet(col, 'serialized-idset') → BOOLEAN membership against an
    IDSET aggregation result (engine/aggspec.py IdSetSpec rendering:
    base64(gzip(json(sorted values))))."""
    import base64
    import gzip
    import json as _json

    blob = str(np.asarray(idset_b64).item())
    try:
        ids = set(_json.loads(gzip.decompress(
            base64.b64decode(blob)).decode("utf-8")))
    except Exception as e:  # noqa: BLE001 — malformed literal is a user error
        raise ValueError(f"inIdSet: malformed idset literal: {e}") from None
    vals = np.asarray(col)
    if vals.ndim == 0:
        vals = vals[None]
    out = np.zeros(len(vals), dtype=bool)
    for i, v in enumerate(vals.tolist()):
        out[i] = v in ids or str(v) in ids
    return out


_reg("inidset", _in_id_set, min_args=2, max_args=2, returns_bool=True)
_reg("in_id_set", _in_id_set, min_args=2, max_args=2, returns_bool=True)


def _geo_to_cell(*args):
    """geoToH3's two reference signatures on the grid scheme:
    geoToH3(point, res) or geoToH3(lon, lat, res) (GeoToH3Function.java:
    38-39). Returns grid cell ids, not H3 ids — this build's geo index is
    the 2-D lat/lon grid (storage/geoindex.py), documented in PARITY.md."""
    from pinot_tpu_torch.ops import geo as _g

    if len(args) == 2:
        lon, lat = _g.parse_points(args[0])
        return _g.grid_cell(lon, lat, args[1])
    return _g.grid_cell(args[0], args[1], args[2])


_reg("geotoh3", _geo_to_cell, min_args=2, max_args=3)
_reg("gridcell", _geo_to_cell, min_args=2, max_args=3)

_reg("st_equals", lambda a, b: _geo("st_equals")(a, b), min_args=2,
     max_args=2, returns_bool=True)
_reg("st_geometrytype", lambda g: _geo("st_geometry_type")(g), min_args=1)
