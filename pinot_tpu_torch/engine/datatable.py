"""DataTable wire format: IntermediateResult ↔ bytes.

Equivalent of the reference's versioned binary DataTable
(pinot-core/.../common/datatable/DataTableImplV3.java + ObjectSerDeUtils for
sketch payloads): the server ships mergeable partials to the broker, which
reduces them in value space. Layout:

    [4B magic "PDT1"] [4B header length] [header JSON] [npz blob]

- header: shape, stats, names/dtypes of every array, and per-array role
- arrays: one .npy each inside an uncompressed zip (np.savez) — object-typed
  states (distinct sets, percentile lists, mode maps) are flattened into
  (values, offsets) pairs, the way ObjectSerDeUtils linearizes sketches.
  No pickle crosses the wire.
"""

from __future__ import annotations

import dataclasses
import io
import json

import numpy as np

from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult

MAGIC = b"PDT1"
ERROR_MAGIC = b"PERR"


class ServerQueryError(Exception):
    """Query-level error raised server-side and shipped in-band (the
    reference's processing-exception DataTable metadata)."""


class NoSegmentsHosted(ServerQueryError):
    """The server holds none of the requested segments (benign routing/sync
    race; the broker skips this partial without marking a failure)."""


class QueryTimeoutError(ServerQueryError):
    """The server aborted because the query's propagated deadline expired
    (errorCode 250 shape). The server is HEALTHY — the broker reports the
    timeout in-band as a partial, without poisoning its failure
    detector."""


class ServerShuttingDown(ServerQueryError):
    """The server is draining for shutdown and rejected the submit before
    execution. RETRIABLE: the broker should re-send the segment list to a
    replica — the data was never touched."""


def encode_error(kind: str, message: str) -> bytes:
    import json as _json

    payload = _json.dumps({"kind": kind, "message": message}).encode("utf-8")
    return ERROR_MAGIC + payload


# ---------------------------------------------------------------------------
# object-state flattening (sets / lists / dicts / (val,time) pairs)
# ---------------------------------------------------------------------------


def _flatten_obj(name: str, arr: np.ndarray, arrays: dict, meta: dict) -> None:
    """Object array of sets/lists/dicts → (concat values, offsets)."""
    first = next((x for x in arr if x is not None), None)
    if isinstance(first, (set, list, np.ndarray)) or first is None:
        # ndarray rows are MV selection cells; they round-trip as lists
        kind = "set" if isinstance(first, set) else "list"
        offsets = np.zeros(len(arr) + 1, dtype=np.int64)
        chunks = []
        for i, x in enumerate(arr):
            if isinstance(x, set):
                vals = sorted(x)
            elif x is None:
                vals = []
            else:
                vals = list(x)
            chunks.append(np.asarray(vals))
            offsets[i + 1] = offsets[i] + len(vals)
        concat = (
            np.concatenate([c for c in chunks if len(c)])
            if offsets[-1] > 0
            else np.empty(0)
        )
        arrays[f"{name}__values"] = concat
        arrays[f"{name}__offsets"] = offsets
        meta[name] = {"obj": kind}
    elif isinstance(first, dict):
        offsets = np.zeros(len(arr) + 1, dtype=np.int64)
        keys, counts = [], []
        for i, d in enumerate(arr):
            items = sorted((d or {}).items(), key=lambda kv: repr(kv[0]))
            keys.extend(k for k, _ in items)
            counts.extend(c for _, c in items)
            offsets[i + 1] = offsets[i] + len(items)
        arrays[f"{name}__values"] = np.asarray(keys) if keys else np.empty(0)
        arrays[f"{name}__counts"] = np.asarray(counts, dtype=np.int64)
        arrays[f"{name}__offsets"] = offsets
        meta[name] = {"obj": "dict"}
    elif isinstance(first, (int, float, _Decimal(),
                            np.integer, np.floating)):
        # exact scalars (SUMPRECISION; FIRSTWITHTIME/LASTWITHTIME's exact
        # int64 value plane): arbitrary-precision ints/Decimals ride as
        # decimal strings. A per-element type flag (0=None, 1=int,
        # 2=float, 3=Decimal) keeps empty slots and MIXED planes exact —
        # a host exact-int accumulator that merged a device float64
        # partial (FirstLast over host + device segments) carries both
        # ints and floats in one object array.
        flags = np.zeros(len(arr), dtype=np.int8)
        strs = []
        for i, x in enumerate(arr):
            if x is None:
                strs.append("0")
            elif isinstance(x, (float, np.floating)):
                flags[i] = 2
                strs.append(repr(float(x)))
            elif isinstance(x, (int, np.integer)):
                flags[i] = 1
                strs.append(str(int(x)))
            else:
                flags[i] = 3
                strs.append(str(x))
        arrays[f"{name}__values"] = np.asarray(strs, dtype=np.str_)
        arrays[f"{name}__flags"] = flags
        meta[name] = {"obj": "exact_scalar"}
    elif isinstance(first, str):
        # scalar strings with empty slots (FIRSTWITHTIME/LASTWITHTIME over
        # a STRING column): one value per group + a presence flag so a
        # genuinely-empty slot (None) survives the round trip distinct
        # from the empty string
        arrays[f"{name}__values"] = np.asarray(
            [x if x is not None else "" for x in arr], dtype=np.str_)
        arrays[f"{name}__flags"] = np.asarray(
            [x is not None for x in arr], dtype=np.int8)
        meta[name] = {"obj": "scalar_str"}
    elif isinstance(first, tuple) and len(first) == 2 and \
            first[0] in ("set", "hll"):
        # SmartHLL tagged union: flag per group + set entries or registers
        flags = np.zeros(len(arr), dtype=np.int8)
        offsets = np.zeros(len(arr) + 1, dtype=np.int64)
        chunks = []
        m = 0
        for kind, payload in arr:
            if kind == "hll":
                m = max(m, len(payload))
        regs = np.zeros((len(arr), m), dtype=np.int32)
        for i, (kind, payload) in enumerate(arr):
            if kind == "set":
                vals = sorted(payload, key=repr)
                chunks.append(np.asarray(vals) if vals else np.empty(0))
                offsets[i + 1] = offsets[i] + len(vals)
            else:
                flags[i] = 1
                offsets[i + 1] = offsets[i]
                regs[i, : len(payload)] = payload
        concat = (np.concatenate([c for c in chunks if len(c)])
                  if offsets[-1] > 0 else np.empty(0))
        arrays[f"{name}__values"] = concat
        arrays[f"{name}__offsets"] = offsets
        arrays[f"{name}__flags"] = flags
        arrays[f"{name}__regs"] = regs
        meta[name] = {"obj": "smart_hll"}
    else:
        raise TypeError(f"unsupported object state in partial: {type(first)}")


def _Decimal():
    import decimal

    return decimal.Decimal


def _unflatten_obj(name: str, spec: dict, arrays: dict) -> np.ndarray:
    if spec["obj"] == "exact_scalar":
        import decimal

        vals = arrays[f"{name}__values"]
        flags = arrays.get(f"{name}__flags")
        out = np.empty(len(vals), dtype=object)
        for i, s in enumerate(vals.tolist()):
            if flags is None:
                # legacy payload (no type flags): SUMPRECISION semantics
                out[i] = int(s) if "." not in s and "E" not in s.upper() \
                    else decimal.Decimal(s)
            elif flags[i] == 0:
                out[i] = None
            elif flags[i] == 1:
                out[i] = int(s)
            elif flags[i] == 2:
                out[i] = float(s)
            else:
                out[i] = decimal.Decimal(s)
        return out
    if spec["obj"] == "scalar_str":
        vals = arrays[f"{name}__values"]
        flags = arrays[f"{name}__flags"]
        out = np.empty(len(flags), dtype=object)
        for i, (s, f) in enumerate(zip(vals.tolist(), flags.tolist())):
            out[i] = s if f else None
        return out
    if spec["obj"] == "smart_hll":
        offsets = arrays[f"{name}__offsets"]
        flags = arrays[f"{name}__flags"]
        regs = arrays[f"{name}__regs"]
        vals = arrays[f"{name}__values"]
        n = len(flags)
        out = np.empty(n, dtype=object)
        for i in range(n):
            if flags[i]:
                out[i] = ("hll", np.asarray(regs[i], dtype=np.int32))
            else:
                out[i] = ("set", set(vals[offsets[i]: offsets[i + 1]].tolist()))
        return out
    offsets = arrays[f"{name}__offsets"]
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    if spec["obj"] in ("set", "list"):
        vals = arrays[f"{name}__values"]
        for i in range(n):
            chunk = vals[offsets[i] : offsets[i + 1]]
            out[i] = set(chunk.tolist()) if spec["obj"] == "set" else list(chunk.tolist())
    else:
        vals = arrays[f"{name}__values"]
        counts = arrays[f"{name}__counts"]
        for i in range(n):
            sl = slice(offsets[i], offsets[i + 1])
            out[i] = dict(zip(vals[sl].tolist(), counts[sl].tolist()))
    return out


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def encode(result: IntermediateResult) -> bytes:
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "shape": result.shape,
        "stats": dataclasses.asdict(result.stats),
        "objects": {},
        "partials": None,
        "n_keys": None,
        "trace": result.trace,
        # per-flight roofline records (ISSUE 11) ride like trace spans
        "roofline": result.roofline,
    }

    if result.group_keys is not None:
        meta["n_keys"] = len(result.group_keys)
        for i, k in enumerate(result.group_keys):
            arrays[f"key{i}"] = np.asarray(k)

    if result.agg_partials is not None:
        layout = []
        for pi, partial in enumerate(result.agg_partials):
            fields = []
            for fname, arr in partial.items():
                arr = np.asarray(arr)
                slot = f"agg{pi}__{fname}"
                if arr.dtype == object:
                    _flatten_obj(slot, arr, arrays, meta["objects"])
                else:
                    arrays[slot] = arr
                fields.append(fname)
            layout.append(fields)
        meta["partials"] = layout

    if result.rows is not None:
        meta["row_keys"] = [str(k) for k in result.rows]
        for k, v in result.rows.items():
            v = np.asarray(v)
            if v.dtype == object:  # MV selection column → (values, offsets)
                _flatten_obj(f"row__{k}", v, arrays, meta["objects"])
            else:
                arrays[f"row__{k}"] = v

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    header = json.dumps(meta).encode("utf-8")
    return MAGIC + len(header).to_bytes(4, "big") + header + buf.getvalue()


def decode(data: bytes) -> IntermediateResult:
    if data[:4] == ERROR_MAGIC:
        info = json.loads(data[4:].decode("utf-8"))
        if info.get("kind") == "no_segments":
            raise NoSegmentsHosted(info["message"])
        if info.get("kind") == "query_timeout":
            raise QueryTimeoutError(info["message"])
        if info.get("kind") == "server_shutting_down":
            raise ServerShuttingDown(info["message"])
        raise ServerQueryError(info["message"])
    if data[:4] != MAGIC:
        raise ValueError("bad DataTable magic")
    hlen = int.from_bytes(data[4:8], "big")
    meta = json.loads(data[8 : 8 + hlen].decode("utf-8"))
    npz = np.load(io.BytesIO(data[8 + hlen :]), allow_pickle=False)
    arrays = {k: npz[k] for k in npz.files}

    stats = ExecutionStats(**meta["stats"])

    group_keys = None
    if meta["n_keys"] is not None:
        group_keys = tuple(arrays[f"key{i}"] for i in range(meta["n_keys"]))

    agg_partials = None
    if meta["partials"] is not None:
        agg_partials = []
        for pi, fields in enumerate(meta["partials"]):
            partial = {}
            for fname in fields:
                slot = f"agg{pi}__{fname}"
                if slot in meta["objects"]:
                    partial[fname] = _unflatten_obj(slot, meta["objects"][slot], arrays)
                else:
                    partial[fname] = arrays[slot]
            agg_partials.append(partial)

    rows = None
    if "row_keys" in meta:
        rows = {}
        for k in meta["row_keys"]:
            # selection row keys are select-position ints or "__ob{j}" strings
            key = int(k) if k.lstrip("-").isdigit() else k
            slot = f"row__{k}"
            if slot in meta["objects"]:
                lists = _unflatten_obj(slot, meta["objects"][slot], arrays)
                for i in range(len(lists)):
                    lists[i] = np.asarray(lists[i])
                rows[key] = lists
            else:
                rows[key] = arrays[slot]

    return IntermediateResult(
        meta["shape"],
        agg_partials=agg_partials,
        group_keys=group_keys,
        rows=rows,
        stats=stats,
        trace=meta.get("trace"),
        roofline=meta.get("roofline"),
    )
