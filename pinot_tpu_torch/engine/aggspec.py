"""Aggregation-function specs: canonical mergeable partial states.

The TPU analog of the reference's AggregationFunction SPI
(pinot-core/.../query/aggregation/function/AggregationFunction.java:
``aggregate`` / ``aggregateGroupBySV`` / ``merge`` / ``extractFinalResult``).
Each spec defines:

- ``host_groups(values, group_idx, n)``  — numpy partial arrays per group
- ``empty(n)`` / ``scatter_merge(acc, idx, part)`` — value-space merge used
  by the reduce step (IndexedTable / DataTableReducer analog); device
  executors convert their dense global-id partials into this same canonical
  form, so reduce is backend-agnostic
- ``finalize(part)``                      — final result column

Partial layout: dict[str, np.ndarray] with per-group arrays; object arrays
hold set/list-valued states (distinct sets, percentile value lists).
"""

from __future__ import annotations

import re

import numpy as np

from pinot_tpu_torch.ops import hll as hll_ops
from pinot_tpu_torch.ops import quantile_digest as qd
from pinot_tpu_torch.query.context import Expression


class AggSpec:
    """Base: subclasses define the state algebra."""

    name: str = ""
    # MV specs take ONE arg evaluated as an (entry_values, per_doc_lens)
    # pair (the executor's eval_mv form) instead of per-doc value arrays
    mv: bool = False

    # which select-time arg expressions need evaluating over filtered rows
    def __init__(self, expr: Expression):
        self.expr = expr
        self.args = expr.args

    # ---- host computation over filtered row values -----------------------
    def host_groups(self, arg_values: list, group_idx: np.ndarray, n: int) -> dict:
        raise NotImplementedError

    def host_scalar(self, arg_values: list) -> dict:
        """Non-group-by: one-group case."""
        idx = np.zeros(len(arg_values[0]) if arg_values else 0, dtype=np.int64)
        return self.host_groups(arg_values, idx, 1)

    # ---- merge algebra ---------------------------------------------------
    def empty(self, n: int) -> dict:
        raise NotImplementedError

    def scatter_merge(self, acc: dict, idx: np.ndarray, part: dict) -> None:
        raise NotImplementedError

    def finalize(self, part: dict) -> np.ndarray:
        raise NotImplementedError

    def take(self, part: dict, idx: np.ndarray) -> dict:
        """Row-select a partial (server-side trim): every state field is a
        per-group array, so fancy indexing covers all specs."""
        return {k: np.asarray(v)[idx] for k, v in part.items()}

    def result_type(self) -> str:
        return "DOUBLE"


def _obj_array(n, factory):
    a = np.empty(n, dtype=object)
    for i in range(n):
        a[i] = factory()
    return a


class CountSpec(AggSpec):
    name = "count"

    def __init__(self, expr: Expression):
        super().__init__(expr)
        self.args = ()  # COUNT(*) / COUNT(col) both count docs

    def host_groups(self, arg_values, group_idx, n):
        c = np.zeros(n, dtype=np.int64)
        np.add.at(c, group_idx, 1)
        return {"count": c}

    def empty(self, n):
        return {"count": np.zeros(n, dtype=np.int64)}

    def scatter_merge(self, acc, idx, part):
        np.add.at(acc["count"], idx, part["count"])

    def finalize(self, part):
        return part["count"]

    def result_type(self):
        return "LONG"


class SumSpec(AggSpec):
    name = "sum"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        s = np.zeros(n, dtype=np.float64)
        with np.errstate(invalid="ignore"):   # inf + -inf, unwarned
            np.add.at(s, group_idx, v)
        return {"sum": s}

    def empty(self, n):
        return {"sum": np.zeros(n, dtype=np.float64)}

    def scatter_merge(self, acc, idx, part):
        with np.errstate(invalid="ignore"):
            np.add.at(acc["sum"], idx, part["sum"])

    def finalize(self, part):
        return part["sum"]


class MinSpec(AggSpec):
    name = "min"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        m = np.full(n, np.inf)
        with np.errstate(invalid="ignore"):   # a NaN propagates, unwarned
            np.minimum.at(m, group_idx, v)
        return {"min": m}

    def empty(self, n):
        return {"min": np.full(n, np.inf)}

    def scatter_merge(self, acc, idx, part):
        with np.errstate(invalid="ignore"):
            np.minimum.at(acc["min"], idx, part["min"])

    def finalize(self, part):
        return part["min"]


class MaxSpec(AggSpec):
    name = "max"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        m = np.full(n, -np.inf)
        with np.errstate(invalid="ignore"):
            np.maximum.at(m, group_idx, v)
        return {"max": m}

    def empty(self, n):
        return {"max": np.full(n, -np.inf)}

    def scatter_merge(self, acc, idx, part):
        with np.errstate(invalid="ignore"):
            np.maximum.at(acc["max"], idx, part["max"])

    def finalize(self, part):
        return part["max"]


class AvgSpec(AggSpec):
    name = "avg"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        s = np.zeros(n, dtype=np.float64)
        c = np.zeros(n, dtype=np.int64)
        with np.errstate(invalid="ignore"):
            np.add.at(s, group_idx, v)
        np.add.at(c, group_idx, 1)
        return {"sum": s, "count": c}

    def empty(self, n):
        return {"sum": np.zeros(n, dtype=np.float64), "count": np.zeros(n, dtype=np.int64)}

    def scatter_merge(self, acc, idx, part):
        with np.errstate(invalid="ignore"):
            np.add.at(acc["sum"], idx, part["sum"])
        np.add.at(acc["count"], idx, part["count"])

    def finalize(self, part):
        with np.errstate(divide="ignore", invalid="ignore"):
            return part["sum"] / part["count"]


class MinMaxRangeSpec(AggSpec):
    name = "minmaxrange"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        mn = np.full(n, np.inf)
        mx = np.full(n, -np.inf)
        with np.errstate(invalid="ignore"):
            np.minimum.at(mn, group_idx, v)
            np.maximum.at(mx, group_idx, v)
        return {"min": mn, "max": mx}

    def empty(self, n):
        return {"min": np.full(n, np.inf), "max": np.full(n, -np.inf)}

    def scatter_merge(self, acc, idx, part):
        with np.errstate(invalid="ignore"):
            np.minimum.at(acc["min"], idx, part["min"])
            np.maximum.at(acc["max"], idx, part["max"])

    def finalize(self, part):
        with np.errstate(invalid="ignore"):   # inf - inf
            return part["max"] - part["min"]


class DistinctCountSpec(AggSpec):
    """Exact distinct count: object array of python sets (host canonical
    form; the device path decodes presence vectors into the same sets)."""

    name = "distinctcount"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        sets = _obj_array(n, set)
        for g, val in zip(group_idx, v.tolist()):
            sets[g].add(val)
        return {"sets": sets}

    def empty(self, n):
        return {"sets": _obj_array(n, set)}

    def scatter_merge(self, acc, idx, part):
        if "cnt" in part:
            raise AssertionError(
                "finalized distinct counts are not mergeable — 'cnt' "
                "partials only occur on the terminal single-partial path")
        for i, g in enumerate(idx):
            acc["sets"][g] |= part["sets"][i]

    def finalize(self, part):
        if "cnt" in part:
            # terminal device path: the popcount already happened on device
            return np.asarray(part["cnt"], dtype=np.int64)
        return np.array([len(s) for s in part["sets"]], dtype=np.int64)

    def result_type(self):
        return "INT"


class DistinctCountHLLSpec(AggSpec):
    name = "distinctcounthll"

    def __init__(self, expr: Expression, log2m: int = hll_ops.DEFAULT_LOG2M):
        super().__init__(expr)
        # optional second literal arg = log2m (reference signature)
        if len(expr.args) > 1 and expr.args[1].is_literal:
            log2m = int(expr.args[1].value)
            self.args = expr.args[:1]
        self.log2m = log2m
        self.m = 1 << log2m

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        return {"regs": hll_ops.registers_np(v, group_idx, n, self.log2m)}

    def empty(self, n):
        return {"regs": np.zeros((n, self.m), dtype=np.int32)}

    def scatter_merge(self, acc, idx, part):
        if "est" in part:
            raise AssertionError(
                "finalized HLL estimates are not mergeable — 'est' "
                "partials only occur on the terminal single-partial path")
        np.maximum.at(acc["regs"], idx, part["regs"])

    def finalize(self, part):
        if "est" in part:
            # terminal device path: estimated on device, registers never
            # crossed the host link
            return np.asarray(part["est"], dtype=np.int64)
        if len(part["regs"]) == 0:
            return np.zeros(0, dtype=np.int64)
        return hll_ops.estimate_batch_np(part["regs"])

    def result_type(self):
        return "LONG"


def bytes_planes(values, m: int) -> np.ndarray:
    """(n_rows, m) int32 register planes from a fixed-width BYTES column
    (np 'S<m>' array or object array of bytes). The numpy view recovers
    trailing zero registers that element access would strip."""
    arr = np.asarray(values)
    if arr.dtype.kind == "S":
        if arr.dtype.itemsize != m:
            raise ValueError(
                f"HLLMERGE state column width {arr.dtype.itemsize} != "
                f"register count {m} — was the cube built with a different "
                f"log2m?")
        return arr.view(np.uint8).reshape(len(arr), m).astype(np.int32)
    out = np.zeros((len(arr), m), dtype=np.int32)
    for i, b in enumerate(arr):
        if not isinstance(b, (bytes, bytearray)):
            raise ValueError(
                "HLLMERGE requires a BYTES column of HLL register planes "
                f"(got {type(b).__name__} values)")
        if len(b) > m:
            raise ValueError(
                f"HLLMERGE plane of {len(b)} bytes exceeds register "
                f"count {m}")
        out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


class HllMergeSpec(DistinctCountHLLSpec):
    """HLLMERGE(state_col[, log2m]): max-merge pre-aggregated HLL register
    planes (one fixed-width BYTES row = one int8 register plane) into the
    same canonical {"regs"} partial DISTINCTCOUNTHLL produces.

    This is the star-tree execution rewrite of DISTINCTCOUNTHLL over the
    cube's sketch column — the reference's DistinctCountHLLAggregationFunction
    byte[]-input merge path paired with DistinctCountHLLValueAggregator
    (pinot-segment-local/.../aggregator/DistinctCountHLLValueAggregator.java:1).
    """

    name = "hllmerge"

    def host_groups(self, arg_values, group_idx, n):
        planes = bytes_planes(arg_values[0], self.m)
        acc = np.zeros((n, self.m), dtype=np.int32)
        np.maximum.at(acc, np.asarray(group_idx), planes)
        return {"regs": acc}


def set_to_bytes(values) -> bytes:
    """Serialize a distinct-value set for a star-tree cube row
    (DistinctCountBitmapValueAggregator's serialized-RoaringBitmap role):
    json of the sorted values. JSON round-trips ints, floats, and strings
    exactly; trailing-NUL padding of the fixed-width BYTES column is safe
    because json text never ends in NUL."""
    import json

    return json.dumps(sorted(values, key=lambda x: (str(type(x)), x))).encode()


def set_from_bytes(blob) -> set:
    import json

    if not blob:
        return set()
    return set(json.loads(bytes(blob).rstrip(b"\x00").decode("utf-8")))


class BitmapMergeSpec(DistinctCountSpec):
    """BITMAPMERGE(state_col): union pre-aggregated distinct-value sets
    (one serialized set per cube row) into DistinctCountSpec's canonical
    {"sets"} partial — the star-tree execution rewrite of DISTINCTCOUNT /
    DISTINCTCOUNTBITMAP over the cube's state column (reference
    DistinctCountBitmapValueAggregator,
    pinot-segment-local/.../aggregator/DistinctCountBitmapValueAggregator.java:1).

    The state holds VALUES (not dict ids): cube segments from different
    parent segments have different dictionaries, so id-space planes could
    not merge across segments."""

    name = "bitmapmerge"

    def host_groups(self, arg_values, group_idx, n):
        sets = _obj_array(n, set)
        for g, blob in zip(np.asarray(group_idx).tolist(),
                           np.asarray(arg_values[0]).tolist()):
            sets[g] |= set_from_bytes(blob)
        return {"sets": sets}


class RawHLLSpec(DistinctCountHLLSpec):
    """DISTINCTCOUNTRAWHLL: serialized registers (base64) instead of the
    estimate, like the reference's serialized HyperLogLog blob."""

    name = "distinctcountrawhll"

    def finalize(self, part):
        import base64

        return np.asarray(
            [base64.b64encode(np.asarray(r, dtype=np.int8).tobytes())
             .decode("ascii") for r in part["regs"]], dtype=object)

    def result_type(self):
        return "STRING"


class PercentileSpec(AggSpec):
    """Percentile over a mergeable t-digest (merging variant,
    ops/quantile_digest.py) instead of the reference PERCENTILE's raw
    DoubleArrayList — bounded per-group state (≲2·compression centroids)
    shipped over the wire as (means, weights) lists, matching
    PercentileTDigestAggregationFunction's state algebra. Deliberate
    divergence: plain PERCENTILE is approximate here (rank error
    ~1/compression); O(matched rows) wire state was a scaling hazard the
    round-2 review flagged."""

    name = "percentile"
    compression = float(qd.DEFAULT_COMPRESSION)  # δ: <1% mid-range rank error

    def __init__(self, expr: Expression):
        super().__init__(expr)
        if len(expr.args) < 2 or not expr.args[1].is_literal:
            raise ValueError(f"{expr.name}(column, p) requires a literal p")
        self.p = float(expr.args[1].value)
        if len(expr.args) >= 3 and expr.args[2].is_literal:
            try:
                self.compression = float(expr.args[2].value)
            except (TypeError, ValueError):
                # a parameters STRING third arg (PERCENTILESMARTTDIGEST's
                # 'threshold=...') is accepted and ignored, not a crash
                pass
        self.args = expr.args[:1]

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0], dtype=np.float64)
        means = _obj_array(n, list)
        weights = _obj_array(n, list)
        if len(v):
            order = np.argsort(group_idx, kind="stable")
            gs = np.asarray(group_idx)[order]
            vs = v[order]
            bounds = np.flatnonzero(np.diff(gs)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(gs)]])
            for s, e in zip(starts, ends):
                g = int(gs[s])
                m, w = qd.add_values([], [], vs[s:e], self.compression)
                means[g] = m.tolist()
                weights[g] = w.tolist()
        return {"means": means, "weights": weights}

    def empty(self, n):
        return {"means": _obj_array(n, list), "weights": _obj_array(n, list)}

    def scatter_merge(self, acc, idx, part):
        for i, g in enumerate(idx):
            if not len(part["means"][i]):
                continue
            if not len(acc["means"][g]):
                acc["means"][g] = list(part["means"][i])
                acc["weights"][g] = list(part["weights"][i])
                continue
            m, w = qd.merge(acc["means"][g], acc["weights"][g],
                            part["means"][i], part["weights"][i],
                            self.compression)
            acc["means"][g] = m.tolist()
            acc["weights"][g] = w.tolist()

    def finalize(self, part):
        out = np.full(len(part["means"]), np.nan)
        for i, (m, w) in enumerate(zip(part["means"], part["weights"])):
            if len(m):
                out[i] = qd.quantile(m, w, self.p / 100.0)
        return out


class DistinctCountThetaSketchSpec(AggSpec):
    """DISTINCTCOUNTTHETASKETCH — mergeable KMV theta sketch
    (ops/theta.py), the role DataSketches' QuickSelect sketch plays in
    DistinctCountThetaSketchAggregationFunction.java. Two forms:

    - ``(col[, nominalEntries])``: one sketch per group; state is theta +
      <=k retained hashes.
    - ``(col, 'nominalEntries=K', filterExpr..., 'SET_INTERSECT($1,$2)')``
      — the reference's set-operation form: each quoted filter expression
      builds its OWN sketch over the matching rows ($1 is the first), the
      quoted LAST argument is a post-merge set expression
      (SET_INTERSECT / SET_UNION / SET_DIFF, nestable) evaluated at
      finalize. Filters evaluate per row through the engine's own
      expression registry, so any boolean-valued expression works. State
      per group: one (theta, hashes) pair per filter, keyed theta{i} /
      hashes{i} — each key is a wire-supported flat state, so partials
      ship over the DataTable like the single-sketch form."""

    name = "distinctcountthetasketch"

    def __init__(self, expr: Expression):
        from pinot_tpu_torch.ops import theta as theta_ops

        super().__init__(expr)
        self.k = theta_ops.DEFAULT_NOMINAL
        args = expr.args
        if len(args) >= 2 and args[1].is_literal:
            v = args[1].value
            if isinstance(v, str):
                params_ok = self._parse_params(v)
                if not params_ok and len(args) >= 4:
                    # set form: a malformed params string is almost always
                    # a MISSING params string — treating a filter like
                    # 'dim = ''a''' as ignorable params would silently
                    # shift every $N reference one filter over
                    raise ValueError(
                        f"DISTINCTCOUNTTHETASKETCH set form: second "
                        f"argument must be a parameters string like "
                        f"'nominalEntries=4096' (or ''), got {v!r}")
            elif v is not None:
                self.k = int(v)
        self.filters = []
        self.set_expr = None
        if len(args) >= 4:
            from pinot_tpu_torch.sql.parser import Parser

            for a in args[2:-1]:
                if not (a.is_literal and isinstance(a.value, str)):
                    raise ValueError(
                        "theta set form takes quoted filter expressions")
                self.filters.append(Parser(a.value).parse_expr())
            last = args[-1]
            if not (last.is_literal and isinstance(last.value, str)):
                raise ValueError(
                    "theta set form needs a quoted set expression last")
            self.set_expr = theta_ops.parse_set_expression(last.value)
            if theta_ops.max_ref(self.set_expr) >= len(self.filters):
                raise ValueError(
                    f"set expression references ${theta_ops.max_ref(self.set_expr) + 1} "
                    f"but only {len(self.filters)} filters are given")
            self.args = [args[0]] + self.filters
        elif len(args) == 3:
            # ambiguous: (col, params, X) — X can't be both the required
            # filter AND the required set expression. Silently ignoring it
            # would return an UNFILTERED count, so fail loudly.
            raise ValueError(
                "DISTINCTCOUNTTHETASKETCH set form needs at least one "
                "filter expression AND a set expression: "
                "(col, params, filterExpr..., 'SET_...($1,...)')")
        else:
            self.args = args[:1]

    _KNOWN_PARAMS = {"nominalentries", "samplingprobability",
                     "accumulatorthreshold"}

    def _parse_params(self, s: str) -> bool:
        """'nominalEntries=4096' style parameter string (';'/',' separated;
        empty allowed; a bare quoted integer is legacy nominalEntries).
        Returns False when the content doesn't look like parameters
        (unknown key, no '=') — the caller decides whether that's
        tolerable (legacy 2-arg form) or an error (set form)."""
        if s.strip().isdigit():  # legacy quoted form: ('4096')
            self.k = int(s)
            return True
        ok = True
        for kv in re.split(r"[;,]", s):
            if not kv.strip():
                continue
            key, eq, val = kv.partition("=")
            if not eq or key.strip().lower() not in self._KNOWN_PARAMS:
                ok = False
                continue
            if key.strip().lower() == "nominalentries" and val.strip():
                try:
                    self.k = int(val)
                except ValueError:
                    ok = False
        return ok

    def _sketch_keys(self):
        if not self.filters:
            return [("theta", "hashes")]
        return [(f"theta{i}", f"hashes{i}") for i in range(len(self.filters))]

    @staticmethod
    def _build_per_group(v, group_idx, n, k):
        from pinot_tpu_torch.ops import theta as theta_ops

        thetas = np.full(n, float(theta_ops.MAX_HASH))
        hashes = _obj_array(n, list)
        if len(v):
            order = np.argsort(group_idx, kind="stable")
            gs = np.asarray(group_idx)[order]
            vs = np.asarray(v)[order]
            bounds = np.flatnonzero(np.diff(gs)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(gs)]])
            for s, e in zip(starts, ends):
                g = int(gs[s])
                th, h = theta_ops.build(vs[s:e], k)
                thetas[g] = float(th)
                hashes[g] = h.tolist()
        return thetas, hashes

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        gi = np.asarray(group_idx)
        if not self.filters:
            thetas, hashes = self._build_per_group(v, gi, n, self.k)
            return {"theta": thetas, "hashes": hashes}
        out = {}
        for i, (tk, hk) in enumerate(self._sketch_keys()):
            fmask = np.asarray(arg_values[1 + i], dtype=bool)
            thetas, hashes = self._build_per_group(
                v[fmask], gi[fmask], n, self.k)
            out[tk] = thetas
            out[hk] = hashes
        return out

    def empty(self, n):
        from pinot_tpu_torch.ops import theta as theta_ops

        out = {}
        for tk, hk in self._sketch_keys():
            out[tk] = np.full(n, float(theta_ops.MAX_HASH))
            out[hk] = _obj_array(n, list)
        return out

    def scatter_merge(self, acc, idx, part):
        from pinot_tpu_torch.ops import theta as theta_ops

        for tk, hk in self._sketch_keys():
            for i, g in enumerate(idx):
                if not len(part[hk][i]) \
                        and part[tk][i] >= float(theta_ops.MAX_HASH):
                    continue
                th, h = theta_ops.merge(
                    int(acc[tk][g]), np.asarray(acc[hk][g], np.int64),
                    int(part[tk][i]), np.asarray(part[hk][i], np.int64),
                    self.k,
                )
                acc[tk][g] = float(th)
                acc[hk][g] = h.tolist()

    def finalize(self, part):
        from pinot_tpu_torch.ops import theta as theta_ops

        keys = self._sketch_keys()
        n = len(part[keys[0][0]])
        if self.set_expr is None:
            return np.array([
                round(theta_ops.estimate(int(t), h))
                for t, h in zip(part["theta"], part["hashes"])
            ], dtype=np.int64)
        out = np.empty(n, dtype=np.int64)
        for g in range(n):
            sketches = [
                (int(part[tk][g]), np.asarray(part[hk][g], np.int64))
                for tk, hk in keys
            ]
            th, h = theta_ops.evaluate_set(self.set_expr, sketches, self.k)
            out[g] = round(theta_ops.estimate(th, h))
        return out

    def result_type(self):
        return "LONG"


class PercentileTDigestSpec(PercentileSpec):
    """PERCENTILETDIGEST(col, p[, compression]) — same digest algebra with
    the reference's default compression (100)."""

    name = "percentiletdigest"
    compression = 100.0


class TDigestMergeSpec(PercentileSpec):
    """TDIGESTMERGE(state_col, p, compression): re-merge pre-aggregated
    t-digest blobs (one serialized digest per cube row) into the same
    canonical {"means","weights"} partial the percentile family produces —
    the star-tree execution rewrite of PERCENTILE/PERCENTILETDIGEST over
    the cube's digest column (reference PercentileTDigestValueAggregator,
    pinot-segment-local/.../aggregator/)."""

    name = "tdigestmerge"

    def host_groups(self, arg_values, group_idx, n):
        means = _obj_array(n, list)
        weights = _obj_array(n, list)
        digests: dict = {}
        for g, blob in zip(np.asarray(group_idx).tolist(),
                           np.asarray(arg_values[0]).tolist()):
            m2, w2 = qd.digest_from_bytes(blob)
            if not len(m2):
                continue
            if g in digests:
                m1, w1 = digests[g]
                digests[g] = qd.merge(m1, w1, m2, w2, self.compression)
            else:
                digests[g] = (m2, w2)
        for g, (m, w) in digests.items():
            means[g] = np.asarray(m).tolist()
            weights[g] = np.asarray(w).tolist()
        return {"means": means, "weights": weights}


class ModeSpec(AggSpec):
    name = "mode"

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        if v.dtype.kind not in "iuf":
            raise ValueError(
                "MODE requires a numeric column (reference ModeAggregationFunction "
                "supports INT/LONG/FLOAT/DOUBLE only)"
            )
        counters = _obj_array(n, dict)
        for g, val in zip(group_idx, v.tolist()):
            d = counters[g]
            d[val] = d.get(val, 0) + 1
        return {"counts": counters}

    def empty(self, n):
        return {"counts": _obj_array(n, dict)}

    def scatter_merge(self, acc, idx, part):
        for i, g in enumerate(idx):
            d = acc["counts"][g]
            for k, c in part["counts"][i].items():
                d[k] = d.get(k, 0) + c

    def finalize(self, part):
        out = np.full(len(part["counts"]), np.nan)
        for i, d in enumerate(part["counts"]):
            if d:
                # max count; ties broken by smallest value (reference default),
                # without float-coercing keys in the sort key
                best_count = max(d.values())
                out[i] = min(k for k, c in d.items() if c == best_count)
        return out


class FirstLastWithTimeSpec(AggSpec):
    """FIRSTWITHTIME/LASTWITHTIME(valueCol, timeCol[, 'dataType']): the
    value carried by the earliest/latest time per group — the argmin/
    argmax-by-time combine family
    (pinot-core/.../function/FirstWithTimeAggregationFunction.java:1,
    LastWithTimeAggregationFunction.java:1).

    Deliberate divergence: ties on the winning time break toward the
    LARGEST value (the reference keeps whichever replica/segment merged
    last — stream-order-dependent). A deterministic, associative rule is
    required here so host scatter, device scatter, and the mesh's
    pmin/pmax-pair combine (parallel/mesh.py) all agree bit-for-bit.

    State: per-group (val, time); float values ride float64 arrays,
    INTEGER value columns ride an object array of exact Python ints on
    the host path (ADVICE r5: the old astype(float64) rounded LONG values
    with |v| > 2^53 — the winning TIME was always exact, the VALUE was
    not), STRING dataType rides an object array. The device path's value
    plane remains float64 (PARITY.md documents that divergence); a device
    partial merging into a host accumulator keeps whatever exactness each
    side produced."""

    _T_MAX = np.iinfo(np.int64).max
    _T_MIN = np.iinfo(np.int64).min

    def __init__(self, expr: Expression, is_first: bool):
        super().__init__(expr)
        self.is_first = is_first
        self.name = "firstwithtime" if is_first else "lastwithtime"
        if len(expr.args) < 2:
            raise ValueError(
                f"{self.name.upper()}(valueCol, timeCol[, 'dataType']) "
                "requires value and time expressions")
        self.data_type = "DOUBLE"
        if len(expr.args) >= 3 and expr.args[2].is_literal:
            self.data_type = str(expr.args[2].value).upper()
        # args: (valueCol, timeCol[, 'dataType'])
        self.args = expr.args[:2]

    @property
    def _sentinel(self):
        return self._T_MAX if self.is_first else self._T_MIN

    @staticmethod
    def _val_gt(a, b):
        """Tie-break comparison with None = -inf (empty slot loses)."""
        if b is None:
            return a is not None
        if a is None:
            return False
        try:
            if np.isnan(b):
                return True
            if np.isnan(a):
                return False
        except TypeError:
            pass  # strings
        return a > b

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        if v.dtype.kind == "f":
            v = v.astype(np.float64)
            val = np.full(n, np.nan)
        else:
            # exact value plane: integer columns become Python ints
            # (arbitrary precision — LONG |v| > 2^53 survives exactly),
            # strings stay objects; empty slots are None either way
            val = np.empty(n, dtype=object)
            val[:] = None
        t = np.asarray(arg_values[1], dtype=np.int64)
        tim = np.full(n, self._sentinel, dtype=np.int64)
        for g, vv, tt in zip(group_idx, v.tolist(), t):
            better = tt < tim[g] if self.is_first else tt > tim[g]
            if better or (tt == tim[g] and self._val_gt(vv, val[g])):
                tim[g] = tt
                val[g] = vv
        return {"val": val, "time": tim}

    def empty(self, n):
        return {
            "val": np.full(n, np.nan),
            "time": np.full(n, self._sentinel, dtype=np.int64),
        }

    def scatter_merge(self, acc, idx, part):
        pv = np.asarray(part["val"])
        if pv.dtype == object and acc["val"].dtype != object:
            # string-valued partials arriving into a fresh numeric-empty
            # accumulator: promote (one value type per query — segments of
            # one column can't mix string and numeric)
            promoted = np.empty(len(acc["val"]), dtype=object)
            for j, x in enumerate(acc["val"]):
                promoted[j] = None if (isinstance(x, float) and np.isnan(x)) else x
            acc["val"] = promoted
        for i, g in enumerate(idx):
            tt = part["time"][i]
            better = tt < acc["time"][g] if self.is_first else tt > acc["time"][g]
            vv = pv[i]
            if isinstance(vv, list):
                # wire artifact: an ALL-None object val array round-trips
                # as empty lists (datatable list fallback) — restore None
                vv = vv[0] if vv else None
            if isinstance(vv, float) and np.isnan(vv) and tt == self._sentinel:
                continue  # empty slot in the partial
            if better or (tt == acc["time"][g] and self._val_gt(vv, acc["val"][g])):
                acc["time"][g] = tt
                acc["val"][g] = vv

    def finalize(self, part):
        out = np.asarray(part["val"])
        # the declared dataType shapes the output (result typing is
        # runtime-dtype-based, reduce._np_type_name): an integral
        # declaration renders LONG/INT unless empty groups force NaN
        # (NULL) into the column
        integral = self.data_type in ("INT", "LONG", "BOOLEAN", "TIMESTAMP")
        if out.dtype == object and len(out):
            # exact int plane (host_groups) — possibly mixed with float64
            # values merged in from a device partial
            vals = out.tolist()
            if all(v is None or isinstance(v, (int, float, np.integer,
                                               np.floating)) for v in vals):
                has_null = any(
                    v is None or (isinstance(v, float) and np.isnan(v))
                    for v in vals)
                if integral and not has_null:
                    # the exact path: LONG |v| > 2^53 renders bit-exact
                    return np.array([int(v) for v in vals], dtype=np.int64)
                return np.array(
                    [np.nan if v is None else float(v) for v in vals],
                    dtype=np.float64)
        if integral and out.dtype.kind == "f" and len(out) \
                and not np.isnan(out).any():
            return out.astype(np.int64)
        return out

    def result_type(self):
        if self.data_type in ("INT", "LONG", "FLOAT", "DOUBLE", "STRING",
                              "BOOLEAN", "TIMESTAMP"):
            return self.data_type
        return "DOUBLE"


class FirstWithTimeSpec(FirstLastWithTimeSpec):
    name = "firstwithtime"

    def __init__(self, expr: Expression):
        super().__init__(expr, is_first=True)


class LastWithTimeSpec(FirstLastWithTimeSpec):
    name = "lastwithtime"

    def __init__(self, expr: Expression):
        super().__init__(expr, is_first=False)


class _MVEntrySpec(AggSpec):
    """Shared shape for MV aggregations that fold per-entry values: expand
    the group index per entry and delegate to the SV spec's state algebra
    (reference: SumMVAggregationFunction et al. iterate getDictIdMV)."""

    mv = True
    sv_base: type = None  # parent SV spec class

    def host_groups(self, arg_values, group_idx, n):
        vals, lens = arg_values[0]
        g = np.repeat(group_idx, lens)
        return self.sv_base.host_groups(self, [vals], g, n)


class SumMVSpec(_MVEntrySpec, SumSpec):
    name = "summv"
    sv_base = SumSpec


class MinMVSpec(_MVEntrySpec, MinSpec):
    name = "minmv"
    sv_base = MinSpec


class MaxMVSpec(_MVEntrySpec, MaxSpec):
    name = "maxmv"
    sv_base = MaxSpec


class AvgMVSpec(_MVEntrySpec, AvgSpec):
    name = "avgmv"
    sv_base = AvgSpec


class DistinctCountMVSpec(_MVEntrySpec, DistinctCountSpec):
    name = "distinctcountmv"
    sv_base = DistinctCountSpec


class SumPrecisionSpec(AggSpec):
    """SUMPRECISION: exact arbitrary-precision sum
    (SumPrecisionAggregationFunction / BigDecimal analog) — Python ints and
    Decimals in object arrays, result as a string like the reference's
    BigDecimal rendering."""

    name = "sumprecision"

    def __init__(self, expr: Expression):
        super().__init__(expr)
        self.args = expr.args[:1]

    @staticmethod
    def _exact(v):
        import decimal

        if isinstance(v, int):
            return v  # already exact: never round-trip through float
        f = float(v)
        if f.is_integer():
            return int(f)
        return decimal.Decimal(repr(f))

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        sums = _obj_array(n, int)
        for g, x in zip(group_idx, v.tolist()):
            sums[g] = sums[g] + self._exact(x)
        return {"psum": sums}

    def empty(self, n):
        return {"psum": _obj_array(n, int)}

    def scatter_merge(self, acc, idx, part):
        for i, g in enumerate(idx):
            acc["psum"][g] = acc["psum"][g] + part["psum"][i]

    def finalize(self, part):
        return np.asarray([str(x) for x in part["psum"]], dtype=object)

    def result_type(self):
        return "STRING"


class SumPrecisionMergeSpec(SumPrecisionSpec):
    """SUMPRECISIONMERGE(state_col): exact re-sum of pre-aggregated
    decimal-string partial sums (one per cube row) — the star-tree rewrite
    of SUMPRECISION (reference SumPrecisionValueAggregator,
    pinot-segment-local/.../aggregator/SumPrecisionValueAggregator.java:1)."""

    name = "sumprecisionmerge"

    @staticmethod
    def _parse(blob):
        import decimal

        s = (bytes(blob).rstrip(b"\x00").decode("ascii")
             if isinstance(blob, (bytes, bytearray)) else str(blob))
        if not s:
            return 0
        return int(s) if ("." not in s and "E" not in s.upper()) \
            else decimal.Decimal(s)

    def host_groups(self, arg_values, group_idx, n):
        sums = _obj_array(n, int)
        for g, blob in zip(np.asarray(group_idx).tolist(),
                           np.asarray(arg_values[0]).tolist()):
            sums[g] = sums[g] + self._parse(blob)
        return {"psum": sums}


class IdSetSpec(DistinctCountSpec):
    """IDSET: serialized set of ids (IdSetAggregationFunction analog) —
    base64(gzip(json(sorted values))) instead of a RoaringBitmap blob.
    Shares DistinctCountSpec's set-union state algebra; only the final
    rendering differs."""

    name = "idset"

    def finalize(self, part):
        import base64
        import gzip
        import json

        out = np.empty(len(part["sets"]), dtype=object)
        for i, s in enumerate(part["sets"]):
            blob = gzip.compress(
                json.dumps(sorted(s, key=str)).encode("utf-8"))
            out[i] = base64.b64encode(blob).decode("ascii")
        return out

    def result_type(self):
        return "STRING"


class SmartHLLSpec(AggSpec):
    """DISTINCTCOUNTSMARTHLL: exact set up to a threshold, HLL beyond
    (DistinctCountSmartHLLAggregationFunction) — the memory-bounding
    auto-switch, per group. State: ('set', set) or ('hll', registers)."""

    name = "distinctcountsmarthll"
    DEFAULT_THRESHOLD = 100_000

    def __init__(self, expr: Expression, log2m: int = hll_ops.DEFAULT_LOG2M):
        super().__init__(expr)
        self.threshold = self.DEFAULT_THRESHOLD
        if len(expr.args) > 1 and expr.args[1].is_literal:
            # reference takes a parameters string; accept a numeric
            # threshold literal
            try:
                self.threshold = int(expr.args[1].value)
            except (TypeError, ValueError):
                pass
        self.log2m = log2m
        self.args = expr.args[:1]

    def _to_hll(self, s: set) -> np.ndarray:
        v = np.asarray(list(s))
        return hll_ops.registers_np(v, np.zeros(len(v), dtype=np.int64),
                                    1, self.log2m)[0]

    def _shrink(self, state):
        kind, payload = state
        if kind == "set" and len(payload) > self.threshold:
            return ("hll", self._to_hll(payload))
        return state

    def host_groups(self, arg_values, group_idx, n):
        v = np.asarray(arg_values[0])
        states = _obj_array(n, lambda: ("set", set()))
        for g, x in zip(group_idx, v.tolist()):
            kind, payload = states[g]
            if kind == "set":
                payload.add(x)
        for i in range(n):
            states[i] = self._shrink(states[i])
        return {"smart": states}

    def empty(self, n):
        return {"smart": _obj_array(n, lambda: ("set", set()))}

    def scatter_merge(self, acc, idx, part):
        for i, g in enumerate(idx):
            ak, ap = acc["smart"][g]
            pk, pp = part["smart"][i]
            if ak == "set" and pk == "set":
                acc["smart"][g] = self._shrink(("set", ap | pp))
            elif ak == "hll" and pk == "hll":
                acc["smart"][g] = ("hll", np.maximum(ap, pp))
            else:
                regs = ap if ak == "hll" else pp
                s = pp if ak == "hll" else ap
                if s:
                    regs = np.maximum(regs, self._to_hll(s))
                acc["smart"][g] = ("hll", regs)

    def finalize(self, part):
        out = np.zeros(len(part["smart"]), dtype=np.int64)
        for i, (kind, payload) in enumerate(part["smart"]):
            out[i] = len(payload) if kind == "set" \
                else hll_ops.estimate(payload)
        return out

    def result_type(self):
        return "LONG"


class STUnionSpec(DistinctCountSpec):
    """ST_UNION over POINT geographies: MULTIPOINT of the distinct points
    (STUnionAggregationFunction's role; JTS union collapses to the same
    for point inputs). Set-union state algebra inherited from
    DistinctCountSpec; only the final rendering differs."""

    name = "stunion"

    def finalize(self, part):
        from pinot_tpu_torch.ops.geo import parse_points

        out = np.empty(len(part["sets"]), dtype=object)
        for i, s in enumerate(part["sets"]):
            lon, lat = parse_points(sorted(str(w) for w in s))
            pts = ", ".join(f"{x:.10g} {y:.10g}"
                            for x, y in zip(lon, lat) if not np.isnan(x))
            out[i] = f"MULTIPOINT ({pts})" if pts else "MULTIPOINT EMPTY"
        return out

    def result_type(self):
        return "STRING"


class RawDigestPercentileSpec(PercentileTDigestSpec):
    """PERCENTILERAWTDIGEST/PERCENTILERAWEST: return the serialized digest
    instead of the quantile (base64 json of (means, weights) — the role of
    the reference's serialized TDigest/QuantileDigest blobs). Inherits the
    tdigest family's compression (100)."""

    def finalize(self, part):
        import base64
        import json

        out = np.empty(len(part["means"]), dtype=object)
        for i, (m, w) in enumerate(zip(part["means"], part["weights"])):
            blob = json.dumps({"means": list(m), "weights": list(w),
                               "compression": self.compression})
            out[i] = base64.b64encode(blob.encode("utf-8")).decode("ascii")
        return out

    def result_type(self):
        return "STRING"


class MinMaxRangeMVSpec(_MVEntrySpec, MinMaxRangeSpec):
    name = "minmaxrangemv"
    sv_base = MinMaxRangeSpec


class DistinctCountHLLMVSpec(_MVEntrySpec, DistinctCountHLLSpec):
    name = "distinctcounthllmv"
    sv_base = DistinctCountHLLSpec


class PercentileMVSpec(_MVEntrySpec, PercentileSpec):
    name = "percentilemv"
    sv_base = PercentileSpec


class PercentileTDigestMVSpec(_MVEntrySpec, PercentileTDigestSpec):
    name = "percentiletdigestmv"
    sv_base = PercentileTDigestSpec


class RawDigestPercentileMVSpec(_MVEntrySpec, RawDigestPercentileSpec):
    """PERCENTILERAWEST_MV / PERCENTILERAWTDIGEST_MV: serialized digest
    over MV entry values (the last two names of the reference's
    AggregationFunctionType enum missing here)."""

    name = "percentilerawtdigestmv"
    sv_base = RawDigestPercentileSpec


class RawHLLMVSpec(_MVEntrySpec, RawHLLSpec):
    name = "distinctcountrawhllmv"
    sv_base = RawHLLSpec


class CountMVSpec(AggSpec):
    """COUNTMV: total MV entries per group (not docs)."""

    name = "countmv"
    mv = True

    def __init__(self, expr: Expression):
        super().__init__(expr)
        self.args = expr.args[:1]

    def host_groups(self, arg_values, group_idx, n):
        _, lens = arg_values[0]
        c = np.zeros(n, dtype=np.int64)
        np.add.at(c, group_idx, lens)
        return {"count": c}

    def empty(self, n):
        return {"count": np.zeros(n, dtype=np.int64)}

    def scatter_merge(self, acc, idx, part):
        np.add.at(acc["count"], idx, part["count"])

    def finalize(self, part):
        return part["count"]

    def result_type(self):
        return "LONG"


_SPECS = {
    "count": CountSpec,
    "sum": SumSpec,
    "min": MinSpec,
    "max": MaxSpec,
    "avg": AvgSpec,
    "minmaxrange": MinMaxRangeSpec,
    "distinctcount": DistinctCountSpec,
    "distinctcountbitmap": DistinctCountSpec,  # same exact semantics
    "segmentpartitioneddistinctcount": DistinctCountSpec,
    "distinctcounthll": DistinctCountHLLSpec,
    "hllmerge": HllMergeSpec,
    "tdigestmerge": TDigestMergeSpec,
    "bitmapmerge": BitmapMergeSpec,
    "sumprecisionmerge": SumPrecisionMergeSpec,
    "distinctcountthetasketch": DistinctCountThetaSketchSpec,
    "distinctcountrawthetasketch": DistinctCountThetaSketchSpec,
    "percentile": PercentileSpec,
    "percentileest": PercentileSpec,
    "percentiletdigest": PercentileTDigestSpec,
    "percentilesmarttdigest": PercentileTDigestSpec,
    "percentilerawest": RawDigestPercentileSpec,
    "percentilerawtdigest": RawDigestPercentileSpec,
    "mode": ModeSpec,
    "firstwithtime": FirstWithTimeSpec,
    "lastwithtime": LastWithTimeSpec,
    "sumprecision": SumPrecisionSpec,
    "idset": IdSetSpec,
    "distinctcountsmarthll": SmartHLLSpec,
    "fasthll": DistinctCountHLLSpec,  # deprecated legacy alias upstream
    "distinctcountrawhll": RawHLLSpec,
    "stunion": STUnionSpec,
    "st_union": STUnionSpec,
    "summv": SumMVSpec,
    "minmv": MinMVSpec,
    "maxmv": MaxMVSpec,
    "avgmv": AvgMVSpec,
    "countmv": CountMVSpec,
    "distinctcountmv": DistinctCountMVSpec,
    "distinctcountbitmapmv": DistinctCountMVSpec,  # same exact semantics
    "minmaxrangemv": MinMaxRangeMVSpec,
    "distinctcounthllmv": DistinctCountHLLMVSpec,
    "distinctcountrawhllmv": RawHLLMVSpec,
    "percentilemv": PercentileMVSpec,
    "percentileestmv": PercentileMVSpec,
    "percentiletdigestmv": PercentileTDigestMVSpec,
    "percentilerawestmv": RawDigestPercentileMVSpec,
    "percentilerawtdigestmv": RawDigestPercentileMVSpec,
}


def make_spec(expr: Expression) -> AggSpec:
    name = expr.name
    cls = _SPECS.get(name)
    if cls is None:
        raise KeyError(f"unsupported aggregation function: {name}")
    return cls(expr)
