"""Reduce: merge IntermediateResults and produce the final ResultTable.

The broker-side reduce of the reference (pinot-core/.../query/reduce/
BrokerReduceService.java + GroupByDataTableReducer / AggregationDataTableReducer /
SelectionDataTableReducer, HavingFilterHandler, PostAggregationHandler):
merges mergeable partials in value space, applies HAVING, evaluates
post-aggregation select expressions, orders, trims, and types the result.

Works over results from any executor backend (host numpy, device batch,
remote server) because partials are canonical (engine/aggspec.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pinot_tpu_torch.engine import aggspec
from pinot_tpu_torch.engine.host import _order_indices, factorize_multi
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult, ResultTable, py_value
from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.query.context import (
    Expression,
    FilterNode,
    FilterNodeType,
    PredicateType,
    QueryContext,
)


def merge_intermediates(q: QueryContext, results: list) -> IntermediateResult:
    results = [r for r in results if r is not None]
    if not results:
        raise ValueError("no results to merge")
    shape = results[0].shape
    if len(results) == 1 and shape in ("aggregation", "group_by", "distinct"):
        # single partial: its keys are already unique (dense/sorted device
        # tables and host group tables are deduped per execution), so the
        # factorize + scatter_merge round is identity work — and on sketch
        # partials it was the most expensive host step of the whole query
        # (np.maximum.at over G×m registers)
        return results[0]
    stats = ExecutionStats()
    for r in results:
        stats.merge(r.stats)

    if shape == "aggregation":
        specs = [aggspec.make_spec(a) for a in q.aggregations()]
        acc = [s.empty(1) for s in specs]
        zero = np.zeros(1, dtype=np.int64)
        for r in results:
            for s, a, p in zip(specs, acc, r.agg_partials):
                s.scatter_merge(a, zero, p)
        return IntermediateResult(shape, agg_partials=acc, stats=stats)

    if shape == "group_by":
        specs = [aggspec.make_spec(a) for a in q.aggregations()]
        nonempty = [r for r in results if len(r.group_keys[0]) > 0]
        if not nonempty:
            return IntermediateResult(
                shape,
                group_keys=results[0].group_keys,
                agg_partials=[s.empty(0) for s in specs],
                stats=stats,
            )
        concat_keys = [
            np.concatenate([np.asarray(r.group_keys[i]) for r in nonempty])
            for i in range(len(q.group_by))
        ]
        keys, ginv = factorize_multi(concat_keys)
        n_merged = len(keys[0])
        acc = [s.empty(n_merged) for s in specs]
        off = 0
        for r in nonempty:
            n_r = len(r.group_keys[0])
            idx = ginv[off : off + n_r]
            off += n_r
            for s, a, p in zip(specs, acc, r.agg_partials):
                s.scatter_merge(a, idx, p)
        return IntermediateResult(shape, group_keys=keys, agg_partials=acc, stats=stats)

    if shape == "selection":
        keys = results[0].rows.keys()
        rows = {
            k: np.concatenate([np.asarray(r.rows[k]) for r in results]) for k in keys
        }
        return IntermediateResult(shape, rows=rows, stats=stats)

    if shape == "distinct":
        concat_keys = [
            np.concatenate([np.asarray(r.group_keys[i]) for r in results])
            for i in range(len(results[0].group_keys))
        ]
        if len(concat_keys[0]) == 0:
            keys = tuple(concat_keys)
        else:
            keys, _ = factorize_multi(concat_keys)
        return IntermediateResult(shape, group_keys=keys, stats=stats)

    raise ValueError(f"unknown result shape {shape}")


def trim_bound(q: QueryContext, min_trim_size: int = 5000) -> int:
    """The server-partial keep bound: ``max(5 * (offset+limit),
    min_trim_size)``. The 5x headroom is the reference's guard against a
    group that is globally top-K but not locally top-K on this server.
    ONE copy of the policy — the host trim below and the device trim
    (ops/device_reduce.py) both read it, so they cannot drift."""
    return max(5 * (q.offset + q.limit), min_trim_size)


def trim_group_by(q: QueryContext, merged: IntermediateResult,
                  min_trim_size: int = 5000) -> IntermediateResult:
    """Server-side order-by-aware group trim before the DataTable ships
    (data/table/TableResizer.java analog): keep the top ``trim_bound``
    groups by the query's ORDER BY, evaluated on finalized local
    partials. HAVING queries are not trimmed (the broker filters groups
    after the merge, so any local trim could starve it of survivors).
    When the device already trimmed the sole partial in-kernel
    (ops/device_reduce.py, same bound), n <= trim_size and this is a
    no-op."""
    if merged.shape != "group_by" or not q.order_by or q.having is not None:
        return merged
    n = len(merged.group_keys[0])
    trim_size = trim_bound(q, min_trim_size)
    if n <= trim_size:
        return merged
    specs = [aggspec.make_spec(a) for a in q.aggregations()]
    env = _group_env(q, merged, specs)
    order = _order_indices(
        [(np.broadcast_to(np.asarray(eval_post(ob.expression, env)), (n,)),
          ob.ascending)
         for ob in q.order_by]
    )[:trim_size]
    return IntermediateResult(
        "group_by",
        group_keys=tuple(np.asarray(k)[order] for k in merged.group_keys),
        agg_partials=[s.take(p, order)
                      for s, p in zip(specs, merged.agg_partials)],
        stats=merged.stats,
    )


# ---------------------------------------------------------------------------
# post-aggregation expression evaluation
# ---------------------------------------------------------------------------


def eval_post(expr: Expression, env: dict):
    """Evaluate a select/having/order expression in post-aggregation space:
    ``env`` maps group-by expressions and aggregation expressions to value
    arrays (PostAggregationHandler analog)."""
    if expr in env:
        return env[expr]
    if expr.is_literal:
        return np.asarray(expr.value)
    if expr.is_identifier:
        raise KeyError(
            f"column {expr.name!r} must appear in GROUP BY to be selected"
        )
    fn = get_function(expr.name)
    if expr.name == "cast":
        return fn.np_fn(eval_post(expr.args[0], env), expr.args[1].value)
    args = [eval_post(a, env) for a in expr.args]
    return fn.np_fn(*args)


def _having_mask(f: FilterNode, env: dict, n: int) -> np.ndarray:
    t = f.type
    if t is FilterNodeType.CONSTANT_TRUE:
        return np.ones(n, dtype=bool)
    if t is FilterNodeType.CONSTANT_FALSE:
        return np.zeros(n, dtype=bool)
    if t is FilterNodeType.AND:
        m = _having_mask(f.children[0], env, n)
        for c in f.children[1:]:
            m &= _having_mask(c, env, n)
        return m
    if t is FilterNodeType.OR:
        m = _having_mask(f.children[0], env, n)
        for c in f.children[1:]:
            m |= _having_mask(c, env, n)
        return m
    if t is FilterNodeType.NOT:
        return ~_having_mask(f.children[0], env, n)
    p = f.predicate
    v = np.broadcast_to(np.asarray(eval_post(p.lhs, env)), (n,))
    if p.type is PredicateType.EQ:
        return v == p.value
    if p.type is PredicateType.NOT_EQ:
        return v != p.value
    if p.type is PredicateType.IN:
        return np.isin(v, list(p.values))
    if p.type is PredicateType.NOT_IN:
        return ~np.isin(v, list(p.values))
    if p.type is PredicateType.RANGE:
        m = np.ones(n, dtype=bool)
        if p.lower is not None:
            m &= (v >= p.lower) if p.lower_inclusive else (v > p.lower)
        if p.upper is not None:
            m &= (v <= p.upper) if p.upper_inclusive else (v < p.upper)
        return m
    raise NotImplementedError(f"HAVING predicate {p.type}")


# ---------------------------------------------------------------------------
# finalization per shape
# ---------------------------------------------------------------------------


def finalize(q: QueryContext, merged: IntermediateResult) -> ResultTable:
    if merged.shape == "aggregation":
        return _finalize_aggregation(q, merged)
    if merged.shape == "group_by":
        return _finalize_group_by(q, merged)
    if merged.shape == "selection":
        return _finalize_selection(q, merged)
    if merged.shape == "distinct":
        return _finalize_distinct(q, merged)
    raise ValueError(merged.shape)


def _np_type_name(arr: np.ndarray) -> str:
    k = arr.dtype.kind
    if k == "b":
        return "BOOLEAN"
    if k in ("i", "u"):
        return "LONG" if arr.dtype.itemsize >= 8 else "INT"
    if k == "f":
        return "DOUBLE"
    return "STRING"


def _finalize_aggregation(q, merged) -> ResultTable:
    aggs = q.aggregations()
    specs = [aggspec.make_spec(a) for a in aggs]
    env = {}
    no_rows = merged.stats.num_docs_scanned == 0
    for a, s, p in zip(aggs, specs, merged.agg_partials):
        if no_rows:
            # SQL semantics over zero rows: COUNT = 0, everything else NULL;
            # NaN propagates through post-aggregation arithmetic like NULL
            env[a] = np.asarray([0], dtype=np.int64) if s.name == "count" \
                else np.asarray([np.nan])
        else:
            env[a] = s.finalize(p)
    names, types, cols = [], [], []
    for i, e in enumerate(q.select_expressions):
        v = np.asarray(eval_post(e, env)).reshape(-1)
        names.append(q.column_name(i))
        types.append(_np_type_name(v))
        val = py_value(v[0]) if len(v) else None
        if isinstance(val, float) and np.isnan(val):
            val = None
        cols.append(val)
    return ResultTable(names, types, [tuple(cols)])


def _group_env(q, merged, specs):
    env = {}
    for g, k in zip(q.group_by, merged.group_keys):
        env[g] = np.asarray(k)
    for a, s, p in zip(q.aggregations(), specs, merged.agg_partials):
        env[a] = s.finalize(p)
    return env


def _gapfill_options(q) -> Optional[dict]:
    """SET-driven gapfill config (GapfillProcessor analog, option-shaped:
    SET gapfillBucketMs = 3600000; [gapfillStart/gapfillEnd/gapfillFill]).
    Returns None when gapfill is off."""
    opts = q.options_ci()
    bucket = opts.get("gapfillbucketms")
    if bucket is None:
        return None
    if len(q.group_by) != 1:
        raise ValueError("gapfill needs exactly one GROUP BY time bucket")
    return {
        "bucket": int(bucket),
        "start": opts.get("gapfillstart"),
        "end": opts.get("gapfillend"),
        "fill": str(opts.get("gapfillfill", "zero")).lower(),
    }


def _apply_gapfill(q, env, n, cfg, specs):
    """Insert missing time buckets into the group env: COUNT-like aggs get
    the fill value (zero/null/previous); group keys become the full bucket
    range [start, end) at bucket intervals."""
    key_expr = q.group_by[0]
    keys = np.asarray(env[key_expr], dtype=np.int64)
    bucket = cfg["bucket"]
    if bucket <= 0:
        raise ValueError("gapfillBucketMs must be positive")
    start = int(cfg["start"]) if cfg["start"] is not None else \
        (int(keys.min()) if n else 0)
    end = int(cfg["end"]) if cfg["end"] is not None else \
        (int(keys.max()) + bucket if n else 0)
    if end <= start:
        return env, n
    n_buckets = (end - start + bucket - 1) // bucket
    if n_buckets > 1_000_000:
        raise ValueError(f"gapfill range too large ({n_buckets} buckets)")
    in_range = (keys >= start) & (keys < end)
    if n and np.any((keys[in_range] - start) % bucket != 0):
        # off-grid group keys would otherwise be silently replaced by fill
        # values — reject like the reference rejects misaligned buckets
        raise ValueError(
            "gapfill group keys are not aligned to gapfillBucketMs from "
            "gapfillStart; bucket the GROUP BY expression accordingly")
    full = start + np.arange(n_buckets, dtype=np.int64) * bucket
    pos = np.searchsorted(full, keys)
    hit = np.zeros(n_buckets, dtype=bool)
    src = np.zeros(n_buckets, dtype=np.int64)
    hit[pos[in_range]] = True
    src[pos[in_range]] = np.nonzero(in_range)[0]
    fill = cfg["fill"]
    out = {key_expr: full}
    for a, s in zip(q.aggregations(), specs):
        vals = np.asarray(env[a])
        # zero-fill preserves integer aggregate types (COUNT stays LONG);
        # null/previous fills need NaN, so they widen to float
        if fill == "zero" and vals.dtype.kind in ("i", "u"):
            filled = np.zeros(n_buckets, dtype=np.int64)
        else:
            filled = np.zeros(n_buckets, dtype=np.float64)
            if fill == "null":
                filled[:] = np.nan
        if n:
            filled[hit] = vals[src[hit]].astype(filled.dtype)
        if fill == "previous" and n_buckets:
            # carry the last seen value forward (reference FILL(...,
            # 'FILL_PREVIOUS_VALUE')); leading gaps stay null
            idx = np.where(hit, np.arange(n_buckets), -1)
            idx = np.maximum.accumulate(idx)
            filled = np.where(idx >= 0, filled[np.maximum(idx, 0)], np.nan)
        out[a] = filled
    return out, n_buckets


def _finalize_group_by(q, merged) -> ResultTable:
    specs = [aggspec.make_spec(a) for a in q.aggregations()]
    env = _group_env(q, merged, specs)
    n = len(merged.group_keys[0])

    if q.having is not None and n > 0:
        mask = _having_mask(q.having, env, n)
        env = {k: np.asarray(v)[mask] if np.asarray(v).ndim else v for k, v in env.items()}
        n = int(mask.sum())

    gf = _gapfill_options(q)
    if gf is not None:
        env, n = _apply_gapfill(q, env, n, gf, specs)

    if q.order_by and n > 0:
        order = _order_indices(
            [(np.broadcast_to(np.asarray(eval_post(ob.expression, env)), (n,)), ob.ascending)
             for ob in q.order_by]
        )
        env = {k: (np.asarray(v)[order] if np.asarray(v).ndim else v) for k, v in env.items()}

    sel = q.offset, q.offset + q.limit
    out_cols = []
    names, types = [], []
    for i, e in enumerate(q.select_expressions):
        v = np.broadcast_to(np.asarray(eval_post(e, env)), (n,))[sel[0]: sel[1]]
        names.append(q.column_name(i))
        types.append(_np_type_name(v))
        out_cols.append(v)
    rows = [tuple(py_value(c[i]) for c in out_cols) for i in range(len(out_cols[0]) if out_cols else 0)]
    if gf is not None:
        # null-filled buckets surface as SQL NULLs, not NaN
        rows = [tuple(None if isinstance(x, float) and np.isnan(x) else x
                      for x in r) for r in rows]
    return ResultTable(names, types, rows)


def _finalize_selection(q, merged) -> ResultTable:
    n = len(next(iter(merged.rows.values()))) if merged.rows else 0
    idx = np.arange(n)
    if q.order_by and n > 0:
        order = _order_indices(
            [(merged.rows[f"__ob{j}"], ob.ascending) for j, ob in enumerate(q.order_by)]
        )
        idx = idx[order]
    idx = idx[q.offset : q.offset + q.limit]
    names, types, cols = [], [], []
    for i in range(len(q.select_expressions)):
        v = np.asarray(merged.rows[i])[idx]
        names.append(q.column_name(i))
        types.append(_np_type_name(v))
        cols.append(v)
    rows = [tuple(py_value(c[j]) for c in cols) for j in range(len(idx))]
    return ResultTable(names, types, rows)


def _finalize_distinct(q, merged) -> ResultTable:
    keys = [np.asarray(k) for k in merged.group_keys]
    n = len(keys[0])
    idx = np.arange(n)
    if q.order_by and n > 0:
        env = {e: k for e, k in zip(q.select_expressions, keys)}
        order = _order_indices(
            [(np.broadcast_to(np.asarray(eval_post(ob.expression, env)), (n,)), ob.ascending)
             for ob in q.order_by]
        )
        idx = idx[order]
    idx = idx[q.offset : q.offset + q.limit]
    names, types, cols = [], [], []
    for i, e in enumerate(q.select_expressions):
        v = keys[i][idx]
        names.append(q.column_name(i))
        types.append(_np_type_name(v))
        cols.append(v)
    rows = [tuple(py_value(c[j]) for c in cols) for j in range(len(idx))]
    return ResultTable(names, types, rows)
