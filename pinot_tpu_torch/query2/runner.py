"""Multi-stage stage runner: execute a MultiStagePlan on the card.

Counterpart of pinot_tpu/query2/runner.py, in the same two stages:

- **Stage 1**: the leaf scans. The reference scans them on its host
  (``scan_local_rows`` over its SegmentEvaluator) even when a device is
  attached; here they run on the card in its host path's shape
  (engine/rows.py ``leaf_rows``): the pushed-down filter through the
  device's filter template, the needed columns of the matched rows
  gathered as ``Col`` tensors (query2/columns.py), consuming and
  upsert-masked segments through their snapshots and valid-docs planes,
  and the reference host evaluator's stats.
- **Join**: both sides' keys factorized into one shared code space
  (``_factorize_codes``), then ops/join.py's sort / probe / expand as
  torch ops, the reference's XLA code. Without a mesh BROADCAST and
  SHUFFLE both run the solo form; on a mesh (``DeviceExecutor.mesh``)
  BROADCAST replicates the sorted build and shards the probe, SHUFFLE
  puts one key bucket on each device, as the reference's shard_maps do.
  DISTRIBUTED runs its local SHUFFLE mirror, as the reference runs it
  without a broker; behind a broker each server runs its slice
  (``run_exchange_stage``) over query2/exchange.py's wire.
- **Windows**: ops/window.py, one ordering per (PARTITION BY, ORDER BY).
- **Stage 2**: the joined rows' group keys factorized on the card
  (ops/selection.py ``factorize``, lexicographic key order as the host's
  ``factorize_multi``), COUNT and integer SUM / AVG through K1
  (``group_scatter.plane_group_sums``) under the reference's gate, the
  other aggregations as torch scatters, a selection's ORDER BY and LIMIT
  on the card, the digests and sketches through engine/sketches.py over
  the joined rows laid out as a batch of one segment (``_JoinedValues``,
  K5 / K1 / K3 as single-stage calls them); only answer-sized partials
  come to the host, into engine/reduce.py's ``finalize``.

Expressions over joined rows run as torch ops where they are arithmetic,
comparisons or boolean logic over numbers (numpy's result dtype, found by
a one-row probe of its function), and any other function runs its numpy
form once per distinct tuple of its operands' values (the rule
engine/values.py ``_per_tuple`` keeps). LEFT JOIN misses fill build
columns with the column TYPE's default ("" / 0), the LOOKUP transform's
miss semantics.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pinot_tpu_torch.common.trace import span
from pinot_tpu_torch.engine import aggspec
from pinot_tpu_torch.engine import rows as rows_mod
from pinot_tpu_torch.engine.params import DeviceUnsupported, to_device
from pinot_tpu_torch.engine.reduce import finalize
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult
from pinot_tpu_torch.engine.values import (
    Val,
    ValueEvaluator,
    _ARITH,
    _COMPARE,
    _UNARY,
    _factorize_tuples,
    _torch_dtype,
    from_order_key,
    host_fails,
    numeric_op,
    predicate_over_values,
)
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import hll as hll_ops
from pinot_tpu_torch.ops import join as join_ops
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops import selection as sel_ops
from pinot_tpu_torch.ops import window as window_ops
from pinot_tpu_torch.ops.device_reduce import lexsort_perm, order_key
from pinot_tpu_torch.ops.sketch_build import hash32_values
from pinot_tpu_torch.ops.transform import _CAST_NP, get_function
from pinot_tpu_torch.query.context import (
    Expression,
    FilterNode,
    FilterNodeType,
    PredicateType,
)
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query2.columns import (
    Col,
    MVCol,
    concat,
    literal,
    of_strings,
    unify,
    with_default,
)
from pinot_tpu_torch.query2.logical import (
    BROADCAST_MAX_BUILD_ROWS,
    MultiStagePlan,
    compile_plan,
)
from pinot_tpu_torch.sql.compiler import _to_filter
from pinot_tpu_torch.sql.parser import SqlAnalysisError

MAX_STAGE1_ROWS = int(os.environ.get("PINOT_TPU_MAX_JOIN_ROWS", 4_000_000))
MAX_JOIN_PAIRS = int(os.environ.get("PINOT_TPU_MAX_JOIN_PAIRS", 16_000_000))

# combined key-code space guard: the cartesian pack must stay in int64
_MAX_KEYSPACE = 1 << 62

# ---------------------------------------------------------------------------
# expression evaluation over a columnar row set
# ---------------------------------------------------------------------------


def _probe(c: Col) -> np.ndarray:
    """The numpy operand a one-row probe of a function takes for ``c``: a
    literal as its 0-d array (numpy promotes by it), a column as one
    value of its dtype."""
    if c.is_str:
        return np.asarray(c.strings[0]) if c.t.dim() == 0 \
            else np.asarray(["x"], dtype=c.dtype)
    if c.t.dim() == 0:
        return np.asarray(c.t.cpu().numpy()).astype(c.dtype)
    return np.ones(1, dtype=c.dtype)


def _tuple_key(c: Col) -> torch.Tensor:
    """int64 keys whose equality is the identity of ``c``'s values
    (floats by their bits)."""
    t = c.t
    if c.is_str or not t.is_floating_point():
        return t.to(torch.int64)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.to(torch.float32).view(torch.int32).to(torch.int64)


def _tuple_values(c: Col, keys: torch.Tensor) -> np.ndarray:
    """The values of ``c`` at fetched ``_tuple_key`` keys."""
    k = keys.cpu().numpy().astype(np.int64)
    if c.is_str:
        return c.strings[k]
    if c.dtype.kind == "f":
        if c.dtype.itemsize == 8:
            return k.view(np.float64).copy()
        return k.astype(np.int32).view(np.float32).astype(c.dtype)
    return k.astype(c.dtype)


def _from_host(out: np.ndarray, inv: torch.Tensor) -> Col:
    """A numpy result per distinct tuple gathered back to the rows."""
    if out.dtype.kind in "biuf":
        return Col(to_device(out, inv.device)[inv], out.dtype)
    return of_strings(inv, out)


def _per_tuple(e: Expression, fn, args: list) -> Col:
    """``e``'s numpy form once per distinct tuple of its operands' values
    (literals as their 0-d arrays), gathered back by tuple id."""
    cols = [c for c in args if c.t.dim() > 0]
    dev = args[0].t.device if args else torch.device("cpu")
    if cols:
        inv, uniq = _factorize_tuples([_tuple_key(c) for c in cols], None)
        host = iter(_tuple_values(c, uniq[:, j]) for j, c in enumerate(cols))
    ops = [next(host) if c.t.dim() > 0 else _probe(c) for c in args]
    with np.errstate(all="ignore"):
        out = fn.np_fn(ops[0], e.args[1].value) if e.name == "cast" \
            else fn.np_fn(*ops)
    out = np.asarray(out)
    if not cols:
        return literal(out.reshape(-1)[0] if out.ndim else out.item(), dev)
    u = int(uniq.shape[0])
    if out.ndim == 0 or out.shape[0] < u:
        out = np.broadcast_to(out.reshape(-1)[:1], (u,)).copy()
    return _from_host(out, inv)


def _numeric(e: Expression, fn, args: list) -> Col:
    """A torch form over number operands (engine/values.py
    ``numeric_op``), in numpy's result dtype from a one-row probe."""
    probes = [_probe(a) for a in args]
    with np.errstate(all="ignore"):
        out = fn.np_fn(probes[0], e.args[1].value) if e.name == "cast" \
            else fn.np_fn(*probes)
    cmp_dt = np.result_type(*probes) if e.name in _COMPARE else None
    out_dt = np.asarray(out).dtype
    return Col(numeric_op(e, [a.t for a in args], out_dt, cmp_dt), out_dt)


def _mv_operands(e: Expression, fn, args: list) -> Col:
    """A function over an MV column's rows: its numpy form over the
    reference's object arrays of per-doc arrays, on the host."""
    n = next(a.lens.numel() for a in args if isinstance(a, MVCol))
    dev = next(a.lens.device for a in args if isinstance(a, MVCol))
    ops = [a.host() if isinstance(a, MVCol) else
           _probe(a) if a.t.dim() == 0 else a.host() for a in args]
    with np.errstate(all="ignore"):
        out = fn.np_fn(ops[0], e.args[1].value) if e.name == "cast" \
            else fn.np_fn(*ops)
    out = np.asarray(out)
    if out.ndim == 0:
        out = np.broadcast_to(out, (n,)).copy()
    if out.dtype.kind in "biuf":
        return Col(to_device(out, dev), out.dtype)
    if out.dtype.kind in "USO" and all(isinstance(x, str)
                                       for x in out.tolist()):
        return of_strings(torch.arange(n, device=dev), out.astype(str))
    raise ValueError(f"{e.name} over a multi-value column gives "
                     f"{out.dtype} values on joined rows")


_TORCH_FORMS = set(_ARITH) | set(_UNARY) | set(_COMPARE) \
    | {"divide", "mod", "and", "or", "not"}


def _eval(cols: dict, expr: Expression, env: Optional[dict],
          device=None) -> Col:
    """An expression over canonical joined columns; ``env`` maps window
    expressions to their values."""
    if env and expr in env:
        return env[expr]
    if expr.is_literal:
        if device is None:
            device = _device(cols) if cols else "cpu"
        return literal(expr.value, device)
    if expr.is_identifier:
        if expr.name not in cols:
            raise KeyError(f"column {expr.name!r} not in joined row set")
        return cols[expr.name]
    if expr.name == "__window__":
        raise SqlAnalysisError(
            "window expression evaluated outside its stage")
    fn = get_function(expr.name)
    operands = expr.args[:1] if expr.name == "cast" else expr.args
    args = [_eval(cols, a, env, device) for a in operands]
    if any(isinstance(a, MVCol) for a in args):
        return _mv_operands(expr, fn, args)
    numeric = args and not any(a.is_str for a in args)
    if numeric and (expr.name in _TORCH_FORMS or (
            expr.name == "cast"
            and str(expr.args[1].value).upper() in _CAST_NP
            and np.dtype(_CAST_NP[str(expr.args[1].value).upper()]).kind
            in "biuf")):
        return _numeric(expr, fn, args)
    return _per_tuple(expr, fn, args)


def _eval_rows(cols: dict, expr: Expression, env: Optional[dict],
               n: int) -> Col:
    return _eval(cols, expr, env).rows(n)


def _compare(t: torch.Tensor, dtype: np.dtype, value, op) -> torch.Tensor:
    """``t op value`` as numpy compares an array of ``dtype`` with a
    Python number: an integer array with a float in float64, with an
    integer exactly; a float array in its own dtype (a string literal
    takes ``_predicate_mask``'s LUT)."""
    if value is None:
        raise SqlAnalysisError(f"cannot compare {dtype} values with "
                               f"{value!r} on joined rows")
    if dtype.kind == "f":
        return op(t, value)
    if isinstance(value, float):
        return op(t.to(torch.float64), value)
    return op(t.to(torch.int64), int(value))


def _predicate_mask(c: Col, p) -> torch.Tensor:
    t = p.type
    if t not in (PredicateType.EQ, PredicateType.NOT_EQ, PredicateType.IN,
                 PredicateType.NOT_IN, PredicateType.RANGE,
                 PredicateType.LIKE, PredicateType.REGEXP_LIKE):
        raise SqlAnalysisError(f"predicate {t.value} is not supported on "
                               f"joined rows")
    if c.is_str or t in (PredicateType.LIKE, PredicateType.REGEXP_LIKE) \
            or ValueEvaluator._string_literal(p):
        # a LUT over the distinct values, gathered by code: the host
        # path's numpy predicate once per value (numbers against a string
        # literal compare as numpy compares them, single-stage's rule)
        if c.is_str:
            codes, values = c.t.to(torch.int64), c.strings
        else:
            codes, uniq = _factorize_tuples([_tuple_key(c).reshape(-1)],
                                            None)
            codes = codes.reshape(c.t.shape)
            values = _tuple_values(c, uniq[:, 0])
        lut = to_device(predicate_over_values(p, np.asarray(values)),
                        c.t.device)
        return lut[codes] if len(values) \
            else torch.zeros_like(codes, dtype=torch.bool)
    if t in (PredicateType.IN, PredicateType.NOT_IN):
        vals = np.asarray(list(p.values))
        dt = np.result_type(c.dtype, vals.dtype)
        hit = torch.isin(c.t.to(_torch_dtype(dt)),
                         to_device(vals.astype(dt), c.t.device))
        return hit if t is PredicateType.IN else ~hit
    if t is PredicateType.EQ:
        return _compare(c.t, c.dtype, p.value, torch.eq)
    if t is PredicateType.NOT_EQ:
        return _compare(c.t, c.dtype, p.value, torch.ne)
    m = torch.ones_like(c.t, dtype=torch.bool)
    if p.lower is not None:
        m = m & _compare(c.t, c.dtype, p.lower,
                         torch.ge if p.lower_inclusive else torch.gt)
    if p.upper is not None:
        m = m & _compare(c.t, c.dtype, p.upper,
                         torch.le if p.upper_inclusive else torch.lt)
    return m


def _filter_mask(cols: dict, f: FilterNode, env, n: int) -> torch.Tensor:
    t = f.type
    dev = _device(cols)
    if t is FilterNodeType.CONSTANT_TRUE:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if t is FilterNodeType.CONSTANT_FALSE:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    if t in (FilterNodeType.AND, FilterNodeType.OR):
        m = _filter_mask(cols, f.children[0], env, n)
        for c in f.children[1:]:
            m = (m & _filter_mask(cols, c, env, n)) \
                if t is FilterNodeType.AND \
                else (m | _filter_mask(cols, c, env, n))
        return m
    if t is FilterNodeType.NOT:
        return ~_filter_mask(cols, f.children[0], env, n)
    m = _predicate_mask(_eval_rows(cols, f.predicate.lhs, env, n),
                        f.predicate)
    return torch.broadcast_to(m, (n,))


def _expr_mask(cols: dict, expr: Expression, env, n: int) -> torch.Tensor:
    """Boolean expression → row mask, through the single-stage filter
    lowering so predicate semantics are identical to stage 1."""
    return _filter_mask(cols, optimize_filter(_to_filter(expr)), env, n)


def _take(cols: dict, idx: torch.Tensor) -> dict:
    return {k: v.take(idx) for k, v in cols.items()}


def _n_rows(cols: dict) -> int:
    if not cols:
        return 0
    c = next(iter(cols.values()))
    return c.lens.numel() if isinstance(c, MVCol) else c.t.numel()


def _device(cols: dict):
    c = next(iter(cols.values()))
    return c.lens.device if isinstance(c, MVCol) else c.t.device


# ---------------------------------------------------------------------------
# stage 1: local leaf scans, on the card
# ---------------------------------------------------------------------------


def _tdm_for(engine, table: str):
    for key in (table, f"{table}_OFFLINE", f"{table}_REALTIME"):
        tdm = engine.tables.get(key)
        if tdm is not None:
            return tdm
    raise KeyError(f"table {table!r} not found")


def scan_local_rows(engine, table: str, filter_expr: Optional[Expression],
                    need_cols: tuple, stats: ExecutionStats,
                    segments: Optional[list] = None) -> dict:
    """Matched rows of one table over all locally hosted segments →
    {bare column: Col} (engine/rows.py ``leaf_rows``), with the reference
    host evaluator's stats added to ``stats``. ``segments`` restricts the
    scan to the named segments: the distributed exchange ships each
    worker its routed slice, so two replicas of one segment never both
    scan it. A cold-tier placeholder (server/tiering.py) answers nothing:
    it counts as queried and cold, its docs in totalDocs, and its touch
    schedules the re-download, as in the reference."""
    seg_filter = None if segments is None else set(segments)
    tdm = _tdm_for(engine, table)
    hosted = tdm.acquire()
    try:
        if not hosted:
            raise ValueError(f"table {table!r} has no segments")
        scan = []
        for seg in hosted:
            if seg_filter is not None and \
                    getattr(seg, "name", None) not in seg_filter:
                continue
            if getattr(seg, "is_cold", False):
                stats.num_segments_queried += 1
                stats.num_segments_cold += 1
                stats.total_docs += seg.n_docs
                touch = getattr(seg, "touch", None)
                if touch is not None:
                    touch()
                continue
            scan.append(seg)
        fnode = None if filter_expr is None \
            else optimize_filter(_to_filter(filter_expr))
        return rows_mod.leaf_rows(engine.device, scan, fnode, need_cols,
                                  stats, MAX_STAGE1_ROWS, table)
    finally:
        tdm.release(hosted)


def needed_columns(plan: MultiStagePlan) -> dict:
    """alias → tuple of bare columns the post-scan stages reference."""
    names: set[str] = set()
    q = plan.stage2
    for e in q.select_expressions:
        names |= e.columns()
    for g in q.group_by:
        names |= g.columns()
    if q.having is not None:
        names |= q.having.columns()
    for ob in q.order_by:
        names |= ob.expression.columns()
    for j in plan.joins:
        for k in j.left_keys + j.right_keys:
            names |= k.columns()
        if j.residual is not None:
            names |= j.residual.columns()
    if plan.post_filter is not None:
        names |= plan.post_filter.columns()
    for w in plan.windows:
        for e in w.args + w.partition_by + tuple(e for e, _ in w.order_by):
            names |= e.columns()
    out: dict[str, list] = {s.alias: [] for s in plan.sources}
    for name in sorted(names):
        if "." not in name:
            continue
        alias, col = name.split(".", 1)
        if alias in out and col not in out[alias]:
            out[alias].append(col)
    # at least one column per source, so an empty projection keeps a
    # row count
    for s in plan.sources:
        if not out[s.alias]:
            out[s.alias].append(s.columns[0])
    return {a: tuple(c) for a, c in out.items()}


# ---------------------------------------------------------------------------
# join execution
# ---------------------------------------------------------------------------


def _factorize_codes(left_vals: list, right_vals: list, n_l: int, n_r: int,
                     device) -> tuple:
    """Shared-code-space factorization: per key column, both sides'
    values unified as ``np.concatenate`` promotes them (INT against DOUBLE
    compares as float64) and numbered by ``torch.unique`` of their keys
    (NaNs one value, -0.0 equal to 0.0, as ``np.unique``); multi-column
    keys combine in mixed radix. Returns (codes_l, codes_r, impossible):
    ``impossible`` when a key pair mixes string and numeric operands,
    which never match."""
    codes_l = torch.zeros(n_l, dtype=torch.int64, device=device)
    codes_r = torch.zeros(n_r, dtype=torch.int64, device=device)
    space = 1
    for lv, rv in zip(left_vals, right_vals):
        if lv.is_str != rv.is_str:
            return codes_l, codes_r, True
        lv, rv = unify([lv.rows(n_l), rv.rows(n_r)])
        u, inv = torch.unique(torch.cat([lv.key(), rv.key()]),
                              return_inverse=True)
        c = max(int(u.numel()), 1)
        if space > _MAX_KEYSPACE // c:
            raise SqlAnalysisError(
                "join key space too wide to pack into int64; reduce the "
                "number of join key columns")
        space *= c
        codes_l = codes_l * c + inv[:n_l]
        codes_r = codes_r * c + inv[n_l:]
    return codes_l, codes_r, False


def _check_pairs(total: int) -> None:
    if total > MAX_JOIN_PAIRS:
        raise SqlAnalysisError(
            f"join produces more than {MAX_JOIN_PAIRS} matched pairs")


def _match_pairs(probe: torch.Tensor, build: torch.Tensor, mesh=None,
                 strategy: str = "BROADCAST") -> tuple:
    """ops/join.py's pipeline: (probe rows, build rows) of every match,
    probe-major, each probe row's matches in build-row order; on a mesh,
    BROADCAST's probe sharded against a replicated build (the same
    order), SHUFFLE bucket by bucket (``_match_pairs_mesh_shuffle``)."""
    if mesh is not None and strategy == "SHUFFLE":
        return _match_pairs_mesh_shuffle(probe, build, mesh)
    sk, perm = join_ops.sort_build(build)
    probe_p, n = probe, probe.numel()
    if mesh is not None:
        pad = (-n) % mesh.size
        probe_p = torch.cat([probe, torch.full(
            (pad,), join_ops.PROBE_PAD, dtype=probe.dtype,
            device=probe.device)])
    if bool((sk[1:] != sk[:-1]).all()):
        # dim-table pk probe (the LOOKUP shape): 1:1, no pair expansion
        found, build_row = join_ops.probe_unique(sk, perm, probe) \
            if mesh is None else join_ops.mesh_probe_unique(
                mesh, sk, perm, probe_p)
        probe_idx = torch.nonzero(found[:n]).reshape(-1)
        return probe_idx, build_row[probe_idx]
    lo, counts = join_ops.probe_ranges(sk, probe) if mesh is None \
        else join_ops.mesh_probe_ranges(mesh, sk, probe_p)
    lo, counts = lo[:n], counts[:n]
    _check_pairs(int(counts.sum()))
    pr, bp, _valid = join_ops.expand_pairs(lo, counts)
    return pr, perm[bp]


def _match_pairs_mesh_shuffle(probe: torch.Tensor, build: torch.Tensor,
                              mesh) -> tuple:
    """SHUFFLE on the mesh: both sides partitioned by key, one bucket a
    device, each bucket sorted, probed and expanded on its own; the
    pairs bucket by bucket, as the reference's mesh orders them."""
    D = mesh.size
    bkeys, brows = join_ops.partition_by_key(build, D, join_ops.BUILD_PAD)
    pkeys, prows = join_ops.partition_by_key(probe, D, join_ops.PROBE_PAD)
    lo, counts, perm = join_ops.mesh_bucket_ranges(mesh, bkeys, pkeys)
    per_bucket = counts.sum(dim=1).cpu()
    _check_pairs(int(per_bucket.sum()))
    pr, bp, valid = join_ops.expand_pairs_buckets(
        lo, counts, join_ops.next_pow2(int(per_bucket.max())))
    out_p, out_b = [], []
    for d in range(D):
        v = valid[d]
        out_p.append(prows[d][pr[d][v]])
        out_b.append(brows[d][perm[d][bp[d][v]]])
    return torch.cat(out_p), torch.cat(out_b)


def execute_join_step(left_cols: dict, n_left: int, step, build_cols: dict,
                      device, mesh=None,
                      strategy: str = "BROADCAST") -> tuple:
    """One join: match, expand, gather, residual-filter, LEFT-append.
    Returns (joined cols dict, new row count)."""
    lkeys = [_eval_rows(left_cols, k, None, n_left) for k in step.left_keys]
    n_build = _n_rows(build_cols)
    rkeys = [_eval_rows(build_cols, k, None, n_build)
             for k in step.right_keys]
    pc, bc, impossible = _factorize_codes(lkeys, rkeys, n_left, n_build,
                                          device)
    if n_left == 0 or n_build == 0 or impossible:
        probe_idx = torch.zeros(0, dtype=torch.int64, device=device)
        build_idx = torch.zeros(0, dtype=torch.int64, device=device)
    else:
        probe_idx, build_idx = _match_pairs(pc, bc, mesh, strategy)

    joined = _take(left_cols, probe_idx)
    joined.update(_take(build_cols, build_idx))

    if step.residual is not None and probe_idx.numel():
        keep = torch.nonzero(_expr_mask(joined, step.residual, None,
                                        probe_idx.numel())).reshape(-1)
        probe_idx = probe_idx[keep]
        joined = _take(joined, keep)

    n = probe_idx.numel()
    if step.kind == "LEFT":
        matched = torch.zeros(n_left, dtype=torch.bool, device=device)
        matched[probe_idx] = True
        miss = torch.nonzero(~matched).reshape(-1)
        k = miss.numel()
        if k:
            for name, c in left_cols.items():
                joined[name] = concat([joined[name], c.take(miss)], device)
            for name in build_cols:
                c, fill = with_default(joined[name])
                if isinstance(c, MVCol):
                    joined[name] = MVCol(
                        c.vals, torch.cat([c.starts, torch.zeros(
                            k, dtype=c.starts.dtype, device=device)]),
                        torch.cat([c.lens, torch.full(
                            (k,), -1, dtype=c.lens.dtype, device=device)]))
                    continue
                joined[name] = Col(torch.cat([c.t, fill.expand(k)]),
                                   c.dtype, c.strings)
            n += k
    return joined, n


# ---------------------------------------------------------------------------
# window execution
# ---------------------------------------------------------------------------


def _dense_ranks(key: torch.Tensor) -> tuple:
    u, inv = torch.unique(key, return_inverse=True)
    return inv, int(u.numel())


def _partition_codes(cols: dict, exprs: tuple, n: int, device):
    if not exprs:
        return torch.zeros(n, dtype=torch.int64, device=device)
    keys = [_eval_rows(cols, e, None, n).key() for e in exprs]
    gid, _g, _k = sel_ops.factorize(
        keys, torch.ones(n, dtype=torch.bool, device=device))
    return gid


def _order_codes(cols: dict, order_by: tuple, n: int, device):
    """Dense lexicographic rank codes over (expr, asc) keys: peer rows
    (equal tuples) share a code; a descending key reverses its ranks
    (NaN first), as the reference's codes do."""
    if not order_by:
        return torch.zeros(n, dtype=torch.int64, device=device)
    ranks = []
    for e, asc in order_by:
        r, u = _dense_ranks(_eval_rows(cols, e, None, n).key())
        ranks.append(r if asc else (u - 1) - r)
    if len(ranks) == 1:
        return ranks[0]
    perm = lexsort_perm(ranks)
    new = torch.zeros(n, dtype=torch.bool, device=device)
    for r in ranks:
        rs = r[perm]
        new[1:] |= rs[1:] != rs[:-1]
    out = torch.empty(n, dtype=torch.int64, device=device)
    out[perm] = torch.cumsum(new.to(torch.int64), 0)
    return out


def apply_windows(cols: dict, windows: tuple, n: int, device) -> dict:
    """Every WindowSpec → {window Expression: Col}. Specs sharing a
    (PARTITION BY, ORDER BY) pair share one ordering."""
    env: dict = {}
    groups: dict = {}
    for w in windows:
        groups.setdefault((w.partition_by, w.order_by), []).append(w)
    for (part_by, order_by), ws in groups.items():
        values, val_index, specs = [], {}, []
        for w in ws:
            vi = -1   # the rank family and COUNT(*) need no operand
            if w.args:
                key = w.args[0]
                if key not in val_index:
                    c = _eval_rows(cols, key, None, n)
                    if c.is_str:
                        raise ValueError(f"could not convert string to "
                                         f"float: {key}")
                    val_index[key] = len(values)
                    values.append(c.t.to(torch.float64))
                vi = val_index[key]
            specs.append((w.fn, vi))
        if n == 0:
            for w, (fn, _) in zip(ws, specs):
                dt = np.dtype(np.int64 if fn in window_ops.RANK_FUNCTIONS
                              else np.float64)
                env[w.expr] = Col(torch.zeros(0, dtype=_torch_dtype(dt),
                                              device=device), dt)
            continue
        part = _partition_codes(cols, part_by, n, device)
        order = _order_codes(cols, order_by, n, device)
        outs = window_ops.window_eval(part, order, tuple(values),
                                      tuple(specs))
        for w, out in zip(ws, outs):
            env[w.expr] = Col(out, np.dtype(
                np.int64 if out.dtype == torch.int64 else np.float64))
    return env


# ---------------------------------------------------------------------------
# stage 2: aggregate / having / order / finalize
# ---------------------------------------------------------------------------


def _decode_key(c: Col, k: torch.Tensor) -> np.ndarray:
    """Host values of ``Col.key`` values ``k``."""
    if c.is_str:
        return c.strings[k.cpu().numpy().astype(np.int64)]
    return from_order_key(k, c.dtype).cpu().numpy().astype(c.dtype,
                                                           copy=False)


def _k1_partials(specs, cols, env, gid, n_groups: int, n: int,
                 ex) -> dict:
    """COUNT and integer SUM / AVG group partials through K1
    (group_scatter.plane_group_sums) under the reference's gate (its
    ``_pallas_groupby_partials``): each integer argument's byte planes
    (``int_planes_needed`` over its range), at most ``MAX_CHANNELS`` + 1
    channels with the count, ``sums_supported``, and the kernel gate
    (``min_rows``, K1's 2^17 rows by default). The exact int64 sums come
    back as the canonical float64 ``{"sum"}`` partial; where the values'
    range times the rows could pass 2^63, the planes recombine in float64
    (``sum_could_wrap``), as the reference's host sums. Float sums keep the
    torch scatter. Returns {spec index: partial}; {} out of regime."""
    if n == 0 or n_groups == 0:
        return {}
    count_idx = [i for i, s in enumerate(specs) if s.name == "count"]
    plans = []   # (spec index, values, offset, nplanes, sum in float64)
    total_ch = 1  # the count channel
    for i, spec in enumerate(specs):
        if spec.name not in ("sum", "avg") or spec.mv or not spec.args:
            continue
        v = _eval_rows(cols, spec.args[0], env, n)
        if v.is_str or v.dtype.kind not in ("i", "u", "b"):
            continue
        t = v.t.to(torch.int32) if v.dtype.kind == "b" else v.t
        lo, hi = (int(x) for x in torch.aminmax(t))
        nplanes = mm.int_planes_needed(lo, hi)
        if total_ch + nplanes > mm.MAX_CHANNELS + 1:
            continue
        plans.append((i, t, lo, nplanes, mm.sum_could_wrap(lo, hi, n)))
        total_ch += nplanes
    if not plans and not count_idx:
        return {}
    if not (ps.sums_supported(n_groups, total_ch) and n >= ex.min_rows):
        return {}
    sources = [kernels.PlaneSource(
        t, "int", nplanes, minus=torch.tensor(lo, dtype=torch.int64,
                                              device=t.device))
        for _i, t, lo, nplanes, _f64 in plans]
    sums = ps.plane_group_sums(gid.to(torch.int32), sources, n_groups,
                               count=True)
    gcount = torch.round(sums[0]).to(torch.int64)
    gcount_np = gcount.cpu().numpy()
    out, row = {}, 1
    for i, _t, off, nplanes, f64 in plans:
        recombine = mm.recombine_f64 if f64 else mm.recombine_int
        s = recombine([sums[j] for j in range(row, row + nplanes)],
                      gcount, off).to(torch.float64).cpu().numpy()
        row += nplanes
        out[i] = ({"sum": s, "count": gcount_np.copy()}
                  if specs[i].name == "avg" else {"sum": s})
    for i in count_idx:
        out[i] = {"count": gcount_np.copy()}
    return out


def _extreme(v: torch.Tensor, gid: torch.Tensor, G: int, how: str):
    """float64 per-group MIN / MAX from ±inf, a NaN in a group winning
    (numpy's ``minimum.at``)."""
    fill = float("inf") if how == "min" else float("-inf")
    out = torch.full((G,), fill, dtype=torch.float64, device=v.device)
    out.scatter_reduce_(0, gid, v, "amin" if how == "min" else "amax")
    nan = torch.zeros(G, dtype=torch.int64, device=v.device) \
        .index_add_(0, gid, torch.isnan(v).to(torch.int64))
    return torch.where(nan > 0, torch.nan, out).cpu().numpy()


def _parsed(arg: Col, what: str) -> Col:
    """A string column's values as ``np.asarray(..., dtype=np.float64)``
    parses them (each distinct string once); one that does not parse
    fails the reference's host too."""
    try:
        vals = np.asarray(arg.strings, dtype=np.float64)
    except (TypeError, ValueError) as err:
        raise host_fails(what, err) from err
    lut = to_device(vals if len(vals) else np.zeros(1), arg.t.device)
    return Col(lut[arg.t.to(torch.int64)], np.dtype(np.float64))


def _torch_partial(spec, a, cols, env, gid, G: int, n: int) -> dict:
    """One aggregation's partial over the joined rows as torch scatters,
    the canonical form engine/aggspec.py's ``host_groups`` gives."""
    name = spec.name
    dev = gid.device
    if name == "count":
        return {"count": torch.bincount(gid, minlength=G).cpu().numpy()
                .astype(np.int64)}
    if spec.mv:
        raise SqlAnalysisError(f"multi-value aggregation {a.name}() is not "
                               f"supported over joined rows")
    if name in ("firstwithtime", "lastwithtime"):
        return _with_time_partial(spec, cols, env, gid, G, n)
    arg = _eval_rows(cols, spec.args[0], env, n)
    if name == "hllmerge":
        return _hllmerge_partial(spec, arg, gid, G)
    if name in ("distinctcount", "stunion"):   # and their aliases' specs
        # Python sets tell values apart: -0.0 equals 0.0, every NaN is
        # its own value
        key = arg.key()
        if not arg.is_str and arg.t.is_floating_point():
            key = torch.where(torch.isnan(arg.t),
                              (0x7FF8 << 48) + torch.arange(n, device=dev),
                              key)
        pairs, inv = torch.unique(torch.stack([gid, key], 1), dim=0,
                                  return_inverse=True)
        # each distinct (group, value) decodes from its first row
        vals = arg.take(sel_ops.first_of(inv, int(pairs.shape[0]))) \
            .host().tolist()
        groups = pairs[:, 0].cpu().numpy().tolist()
        sets = np.empty(G, dtype=object)
        sets[:] = [set() for _ in range(G)]
        for gg, vv in zip(groups, vals):
            sets[gg].add(vv)
        return {"sets": sets}
    if arg.is_str:
        if name == "distinctcounthll":
            h = to_device(hll_ops.hash32_np(arg.strings).astype(np.int64)
                          if len(arg.strings) else np.zeros(1, np.int64),
                          dev)[arg.t]
            return _hll_partial(spec, h, gid, G)
        # parsed as the host's float64 read parses them
        arg = _parsed(arg, f"{name.upper()}({spec.args[0]})")
    if name == "distinctcounthll":
        return _hll_partial(spec, hash32_values(arg.t, arg.dtype), gid, G)
    exact = arg.dtype.kind in "iub"
    if name in ("sum", "avg"):
        if exact and arg.dtype.itemsize == 8 and n:
            lo, hi = (int(x) for x in torch.aminmax(arg.t))
            exact = not mm.sum_could_wrap(lo, hi, n)
        if exact:
            s = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                0, gid, arg.t.to(torch.int64)).to(torch.float64)
        else:
            s = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(
                0, gid, arg.t.to(torch.float64))
        out = {"sum": s.cpu().numpy()}
        if name == "avg":
            out["count"] = torch.bincount(gid, minlength=G).cpu().numpy() \
                .astype(np.int64)
        return out
    v = arg.t.to(torch.float64)
    if name == "min":
        return {"min": _extreme(v, gid, G, "min")}
    if name == "max":
        return {"max": _extreme(v, gid, G, "max")}
    if name == "minmaxrange":
        return {"min": _extreme(v, gid, G, "min"),
                "max": _extreme(v, gid, G, "max")}
    raise KeyError(f"unsupported aggregation function: {a.name}")


def _with_time_partial(spec, cols, env, gid, G: int, n: int) -> dict:
    """FIRSTWITHTIME / LASTWITHTIME over joined rows: engine/device.py's
    scatter pair (ops/agg.py ``group_arg_time``). Strings ride as their
    codes (code order is string order, ties to the largest value as the
    host compares them) and integers exactly, as the host's object
    array of Python values; times as the host reads them
    (``np.asarray(..., dtype=np.int64)``), a string time parsed once per
    distinct value."""
    from pinot_tpu_torch.engine.device import with_time_partial
    from pinot_tpu_torch.ops import agg as agg_ops

    v = _eval_rows(cols, spec.args[0], env, n)
    tc = _eval_rows(cols, spec.args[1], env, n)
    if tc.is_str:
        lut = np.asarray(tc.strings, dtype=np.int64) if len(tc.strings) \
            else np.zeros(1, dtype=np.int64)
        times = to_device(lut, gid.device)[tc.t]
    else:
        times = tc.t.to(torch.int64)
    exact = v.is_str or v.dtype.kind in "biu"
    vals = v.t.to(torch.int64) if exact else v.t
    tb, vb = agg_ops.group_arg_time(gid, vals, times, G, spec.is_first,
                                    exact)
    part = with_time_partial(spec.name, {"w_t": tb.cpu().numpy(),
                                         "w_v": vb.cpu().numpy()}, "w", None)
    if v.is_str:
        part["val"] = np.asarray(
            [None if x is None else v.strings[x].item()
             for x in part["val"].tolist()], dtype=object)
    elif v.dtype.kind == "b":
        part["val"] = np.asarray([None if x is None else bool(x)
                                  for x in part["val"].tolist()],
                                 dtype=object)
    return part


def _hllmerge_partial(spec, arg: Col, gid, G: int) -> dict:
    """HLLMERGE over joined rows of register planes (a BYTES column):
    each distinct plane decoded once (aggspec ``bytes_planes``), then a
    scatter-max of the rows' planes into (G, m) on the card."""
    if not arg.is_str:
        raise ValueError(f"HLLMERGE reads a BYTES state column, got "
                         f"{arg.dtype} values")
    table = to_device(aggspec.bytes_planes(arg.strings, spec.m),
                      gid.device)
    planes = table[arg.t] if len(arg.strings) \
        else torch.zeros((0, spec.m), dtype=torch.int32, device=gid.device)
    regs = torch.zeros((G, spec.m), dtype=torch.int32, device=gid.device)
    regs.scatter_reduce_(0, gid.reshape(-1, 1).expand(-1, spec.m), planes,
                         "amax")
    return {"regs": regs.cpu().numpy()}


class _JoinedDicts:
    """The dictionaries engine/sketches.py reads through ``ctx``: each
    string column of the joined rows (keyed by its expression) with its
    sorted distinct strings, and its values' hash plane."""

    def __init__(self, ev):
        self.ev = ev
        self.cols: dict = {}

    def global_dict(self, key):
        from pinot_tpu_torch.storage.dictionary import Dictionary

        return Dictionary(self.cols[key].strings)

    def prehashed_column(self, name: str) -> torch.Tensor:
        v = self.ev.eval(Expression.identifier(name))
        return torch.broadcast_to(self.ev.hash32(v).to(torch.int32),
                                  (1, self.ev.L))


class _JoinedValues(ValueEvaluator):
    """engine/values.py's evaluator over the joined rows laid out as one
    segment (S = 1, L = the row count; ``sketches.Batch.joined``): what
    the sketches read of a batch. A number column is a "num" value, a
    string column a "dict" value over its sorted distinct strings."""

    joined = True

    def __init__(self, cols: dict, env: dict, n: int, device):
        self.cols, self.env = cols, env
        self.S, self.L, self.device = 1, n, device
        self.ctx = _JoinedDicts(self)
        self.seg_names = self.seg_sorted = self.host_names = \
            np.asarray([""])
        self._gvals, self._probes, self._luts, self._mvfuncs = {}, {}, {}, {}

    def eval(self, e: Expression, rows=None) -> Val:
        c = _eval(self.cols, e, self.env, self.device)
        if isinstance(c, MVCol):
            c = c.single()
        if c.is_str:
            key = e.name if e.is_identifier else str(e)
            self.ctx.cols[key] = c
            return Val(c.t, "dict", c.dtype, key)
        return Val(c.t, "num", c.dtype)

    operand = eval

    def is_mv(self, name: str) -> bool:
        return False

    def column_dtype(self, name: str) -> np.dtype:
        return self.eval(Expression.identifier(name)).dtype


def _sketch_partials(idxs: list, aggs, cols, env, gid, G: int, n: int,
                     device) -> dict:
    """The digests and sketches (engine/sketches.py ``NAMES``) over the
    joined rows, as single-stage runs them: each plan checked first, then
    their device leaves (K5's ordered cluster sums, K1's byte planes, K3's
    registers, the KMV and value runs), fetched answer-sized, each
    finished into the reference's partial. ``gid`` None: one group."""
    from pinot_tpu_torch.engine import sketches

    if n == 0:
        return {i: aggspec.make_spec(aggs[i]).empty(G) for i in idxs}
    ev = _JoinedValues(cols, env, n, device)

    def filters(f):
        return _filter_mask(cols, optimize_filter(f), env, n).reshape(1, n)

    plans = {i: sketches.plan(i, aggs[i], ev, filters) for i in idxs}
    batch = sketches.Batch.joined(ev, gid, G)
    outs: dict = {}
    for sk in plans.values():
        outs.update(sk.launch(batch))
    host = {k: v.cpu().numpy() for k, v in outs.items()}
    present = None if gid is None else np.arange(G)
    return {i: sk.partial(host, present) for i, sk in plans.items()}


def _hll_partial(spec, h: torch.Tensor, gid: torch.Tensor, G: int) -> dict:
    slot, rho = hll_ops.hll_slots(h, spec.log2m, G, gid)
    m = 1 << spec.log2m
    regs = torch.zeros(G * m + 1, dtype=torch.int32, device=h.device)
    regs.scatter_reduce_(0, slot.to(torch.int64), rho, "amax")
    return {"regs": regs[: G * m].reshape(G, m).cpu().numpy()}


def _partials(aggs, specs, cols, env, gid, G: int, n: int, fast,
              grouped: bool = True) -> list:
    from pinot_tpu_torch.engine.sketches import NAMES

    done = dict(fast)
    sk = [i for i, a in enumerate(aggs) if i not in done and a.name in NAMES]
    if sk:
        done.update(_sketch_partials(sk, aggs, cols, env,
                                     gid if grouped else None, G, n,
                                     gid.device))
    return [done[i] if i in done
            else _torch_partial(spec, a, cols, env, gid, G, n)
            for i, (a, spec) in enumerate(zip(aggs, specs))]


def _desc_key(c: Col) -> torch.Tensor:
    """The reference's descending ORDER BY key (``_order_indices``): the
    negated value, floats in float64 so NaN stays last."""
    if not c.is_str and c.t.is_floating_point():
        return order_key(-c.t.to(torch.float64))
    return -c.key()


def stage2_partial(plan: MultiStagePlan, cols: dict, n: int, env: dict,
                   ex) -> IntermediateResult:
    """Joined rows → one IntermediateResult for engine/reduce.py's
    finalize, with only answer-sized tensors copied to the host: group
    keys and partials, DISTINCT's tuples, a selection's first ``limit +
    offset`` rows in its ORDER BY order."""
    q = plan.stage2
    dev = ex.device
    stats = ExecutionStats(num_docs_scanned=n)
    aggs = q.aggregations()

    if q.distinct or (aggs and q.group_by):
        exprs = q.select_expressions if q.distinct else q.group_by
        key_cols = [_eval_rows(cols, e, env, n) for e in exprs]
        if n == 0:
            keys = tuple(c.host()[:0] for c in key_cols)
        else:
            # only the key tuples present are numbered
            gid, G, gkeys = sel_ops.factorize(
                [c.key() for c in key_cols],
                torch.ones(n, dtype=torch.bool, device=dev), dense_limit=1)
            keys = tuple(_decode_key(c, k) for c, k in zip(key_cols, gkeys))
        if q.distinct:
            return IntermediateResult("distinct", group_keys=keys,
                                      stats=stats)
        specs = [aggspec.make_spec(a) for a in aggs]
        if n == 0:
            return IntermediateResult(
                "group_by", group_keys=keys,
                agg_partials=[s.empty(0) for s in specs], stats=stats)
        for a, spec in zip(aggs, specs):
            if spec.mv:
                raise SqlAnalysisError(
                    f"multi-value aggregation {a.name}() is not supported "
                    f"over joined rows")
        fast = _k1_partials(specs, cols, env, gid, G, n, ex)
        return IntermediateResult(
            "group_by", group_keys=keys,
            agg_partials=_partials(aggs, specs, cols, env, gid, G, n, fast),
            stats=stats)

    if aggs:
        specs = [aggspec.make_spec(a) for a in aggs]
        for a, spec in zip(aggs, specs):
            if spec.mv:
                raise SqlAnalysisError(
                    f"multi-value aggregation {a.name}() is not supported "
                    f"over joined rows")
        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        return IntermediateResult(
            "aggregation",
            agg_partials=_partials(aggs, specs, cols, env, zero, 1, n, {},
                                   grouped=False),
            stats=stats)

    # selection: the first limit + offset rows in ORDER BY order (stable,
    # as the reduce sorts), then the select and ORDER BY values of those
    k = q.limit + q.offset
    if q.order_by and n:
        keys = []
        for ob in q.order_by:
            c = _eval_rows(cols, ob.expression, env, n)
            keys.append(c.key() if ob.ascending else _desc_key(c))
        idx = lexsort_perm(keys)[:k]
    else:
        idx = torch.arange(min(k, n), dtype=torch.int64, device=dev)
    m = idx.numel()
    sub = _take(cols, idx)
    sub_env = {e: c.take(idx) for e, c in env.items()}
    rows: dict = {}
    for i, e in enumerate(q.select_expressions):
        rows[i] = _eval(sub, e, sub_env, dev).rows(m).host()
    for j, ob in enumerate(q.order_by):
        rows[f"__ob{j}"] = _eval(sub, ob.expression, sub_env,
                                 dev).rows(m).host()
    return IntermediateResult("selection", rows=rows, stats=stats)


def run_stage2(plan: MultiStagePlan, cols: dict, n: int, env: dict, ex):
    """Joined rows → ResultTable through the single-stage reduce path."""
    return finalize(plan.stage2, stage2_partial(plan, cols, n, env, ex))


# ---------------------------------------------------------------------------
# plan execution over materialized stage-1 row sets
# ---------------------------------------------------------------------------


def run_plan(plan: MultiStagePlan, table_rows: dict, ex, advisor=None,
             advisor_key=None):
    """table_rows: alias → {bare column: Col}. Returns (ResultTable, meta
    dict with join / window execution facts).

    ``advisor`` / ``advisor_key``: the plan advisor's memo of this
    template feeds the join-strategy pick (measured build-side rows of
    earlier executions beat the catalog's dimension-table heuristic), and
    every step's actual build rows and strategy are observed back.
    Overrides land in meta["advisorDecisions"]."""
    dev = ex.device
    mesh = getattr(ex, "mesh", None)
    probe = plan.probe
    left_cols = {f"{probe.alias}.{c}": v
                 for c, v in table_rows[probe.alias].items()}
    n = _n_rows(left_cols)

    strategies = []
    roofline_recs = []
    adv_notes = []
    for step in plan.joins:
        build_cols = {f"{step.build.alias}.{c}": v
                      for c, v in table_rows[step.build.alias].items()}
        n_build = _n_rows(build_cols)
        strat = plan.strategy
        if strat == "DISTRIBUTED":
            # the wire exchange is the cluster tier's; run here, the local
            # form of a distributed join is the shuffle mirror
            strat = "SHUFFLE"
        if advisor is not None and advisor_key \
                and not plan.strategy_forced:
            # both strategies compute the same joined rows: the pick is
            # performance only
            strat2, note = advisor.advise_join_strategy(
                advisor_key, strat, step.build.alias,
                BROADCAST_MAX_BUILD_ROWS)
            if note:
                strat = strat2
                adv_notes.append(note)
        if strat == "BROADCAST" and not plan.strategy_forced \
                and n_build > BROADCAST_MAX_BUILD_ROWS:
            # a heuristic BROADCAST must not replicate a huge build table;
            # SET joinStrategy='broadcast' overrides
            strat = "SHUFFLE"
        bytes_in = sum(v.nbytes for v in left_cols.values()) \
            + sum(v.nbytes for v in build_cols.values())
        t_join = time.perf_counter()
        with span("join"):
            left_cols, n = execute_join_step(left_cols, n, step, build_cols,
                                             dev, mesh, strat)
        join_ms = (time.perf_counter() - t_join) * 1e3
        strategies.append(strat)
        if advisor is not None and advisor_key:
            advisor.observe(advisor_key,
                            build_rows={step.build.alias: n_build},
                            join_strategy=strat)
        roofline_recs.append(_join_roofline_record(
            step, strat, bytes_in, left_cols, join_ms, dev))

    if plan.post_filter is not None and n:
        keep = torch.nonzero(_expr_mask(left_cols, plan.post_filter, None,
                                        n)).reshape(-1)
        left_cols = _take(left_cols, keep)
        n = keep.numel()

    env = {}
    if plan.windows:
        with span("window"):
            env = apply_windows(left_cols, plan.windows, n, dev)

    with span("aggregate"):
        result = run_stage2(plan, left_cols, n, env, ex)
    effective = None
    if strategies:
        effective = strategies[0] if len(set(strategies)) == 1 else "MIXED"
    meta = {
        "numStages": 2 if (plan.joins or plan.windows) else 1,
        "joinStrategy": effective,
        "numJoinedRows": n,
        "mesh": mesh is not None,
        "roofline": roofline_recs,
        # the executed join's partition fan-out: a bucket a mesh device
        # under SHUFFLE, else 1 (0 without a join), as the reference's
        "joinFanout": (mesh.size if (mesh is not None
                                     and effective == "SHUFFLE")
                       else 1) if strategies else 0,
    }
    if adv_notes:
        meta["advisorDecisions"] = adv_notes
    return result, meta


def _join_roofline_record(step, strat: str, bytes_in: int, out_cols: dict,
                          join_ms: float, device) -> dict:
    """Roofline flight record for one executed join step: probe and build
    bytes in, joined bytes out, over the step's wall."""
    from pinot_tpu_torch.ops import roofline as rl

    bytes_out = sum(v.nbytes for v in out_cols.values())
    bytes_moved = bytes_in + bytes_out
    rec = {"kernel": f"join_{step.kind.lower()}+{strat.lower()}",
           "bytesMoved": bytes_moved, "bytesFetched": bytes_out,
           "kernelMs": round(join_ms, 3), "linkMs": 0.0,
           "cacheHit": False}
    if join_ms > 0:
        gbps = bytes_moved / (join_ms / 1e3) / 1e9
        rec["gbps"] = round(gbps, 3)
        peak = rl.hbm_peak_gbps(device)
        pct = rl.pct_of_peak(gbps, peak)
        if pct is not None:
            rec["peakGbps"] = round(peak, 1)
            rec["pctOfPeak"] = pct
    return rec


def run_local(engine, plan: MultiStagePlan):
    """Embedded execution: stage-1 scans over the engine's hosted
    segments, then the plan runner. The spans keep the reference's names
    (``host_scan`` a leaf, ``stage2``), so EXPLAIN ANALYZE's waterfall has
    its shape; the join, the windows and the aggregation nest under
    ``stage2``."""
    stats = ExecutionStats()
    need = needed_columns(plan)
    table_rows = {}
    for src in plan.sources:
        with span("host_scan"):
            table_rows[src.alias] = scan_local_rows(
                engine, src.table, plan.pushdown.get(src.alias),
                need[src.alias], stats)
    # the executor's plan advisor memoizes multi-stage templates too (the
    # join strategy from measured build rows); SET useAdvisor = false
    # bypasses it
    advisor = getattr(engine.device, "advisor", None)
    adv_key = None
    if advisor is not None:
        from pinot_tpu_torch.broker.querylog import template_key
        from pinot_tpu_torch.engine.advisor import advisor_enabled

        try:
            opts = plan.stage2.options_ci()
        except Exception:  # noqa: BLE001 — advice is optional
            opts = {}
        if advisor_enabled(opts):
            adv_key = template_key(plan)
    with span("stage2"):
        result, meta = run_plan(plan, table_rows, engine.device,
                                advisor=advisor, advisor_key=adv_key)
    meta["leafRows"] = {alias: _n_rows(cols)
                        for alias, cols in table_rows.items()}
    return result, stats, meta


def run_exchange_stage(engine, plan: MultiStagePlan, spec: dict, mailbox,
                       send, done, deadline, ex=None):
    """One worker's slice of a DISTRIBUTED stage 2 (the reference's
    ``run_exchange_stage``): scan the locally routed stage-1 segments on
    the card, partition every row set by the join key's
    ``stable_hash64`` (data-independent, so every worker routes a key to
    the same owner), hand each partition to ``send`` (a self-offer or an
    ExchangeTransfer to its owner), then join and partially aggregate
    every OWNED partition on the card and merge those partials into the
    one IntermediateResult the broker's final merge takes.

    The hash, the partition ids and their stable order are computed on
    the card (ops/join.py ``stable_hash64``, ``hash_partition_rows``);
    each column then comes to the host once, in partition order, and is
    cut there into the payloads. An owned partition's rows go back to
    the card for ``execute_join_step`` and ``stage2_partial`` (K1 past
    its gate, K5 for a digest, K3 for raw / smart HLL).

    ``spec``: {"partitions": P, "partitionOwners": {str(p): instance},
    "senders": [instances], "selfId": str, "routing": {alias: {"table",
    "segments", optional "dtypes"}}}. The broker gates this path to
    single-join, window-free plans."""
    from pinot_tpu_torch.engine.reduce import merge_intermediates
    from pinot_tpu_torch.query2.columns import host_col

    ex = engine.device if ex is None else ex
    dev = ex.device
    if len(plan.joins) != 1 or plan.windows:
        raise SqlAnalysisError(
            "distributed exchange supports exactly one join and no "
            "window functions")
    step = plan.joins[0]
    probe_alias = plan.probe.alias
    build_alias = step.build.alias
    P = int(spec["partitions"])
    owners = {int(p): o for p, o in spec["partitionOwners"].items()}
    self_id = spec["selfId"]
    mesh = getattr(ex, "mesh", None)

    stats = ExecutionStats()
    need = needed_columns(plan)
    key_exprs = {probe_alias: step.left_keys, build_alias: step.right_keys}

    # ---- stage 1 + scatter: scan routed segments, partition, ship ----
    for src in plan.sources:
        route = spec["routing"].get(src.alias) or {}
        segs = route.get("segments")
        dtypes = route.get("dtypes") or {}
        with span(f"exchange_scan:{src.alias}"):
            cols = scan_local_rows(
                engine, src.table, plan.pushdown.get(src.alias),
                need[src.alias], stats, segments=segs) if segs else {}
        n_rows = _n_rows(cols)
        stats.leaf_rows[src.alias] = \
            stats.leaf_rows.get(src.alias, 0) + n_rows
        if n_rows:
            if any(isinstance(v, MVCol) for v in cols.values()):
                raise DeviceUnsupported(
                    "a multi-value column through the distributed "
                    "exchange (the reference's wire casts it to strings)")
            prefixed = {f"{src.alias}.{c}": v for c, v in cols.items()}
            keys = [_eval_rows(prefixed, k, None, n_rows).rows(n_rows)
                    for k in key_exprs[src.alias]]
            h = join_ops.stable_hash64([(k.t, k.strings) for k in keys],
                                       n_rows, dev)
            order, bounds = join_ops.hash_partition_rows(h % P, P)
            # one device-to-host copy a column, in partition order
            host = {c: v.take(order).host() for c, v in cols.items()}
        else:
            # an empty side still ships typed, at the broker's schema
            # dtypes (the reference's empty-leaf guard)
            host = {c: np.empty(0, dtype=np.dtype(dtypes[c]))
                    if c in dtypes else np.empty(0)
                    for c in need[src.alias]}
            bounds = [0] * (P + 1)
        deadline.check("exchange.partition")
        with span(f"exchange_send:{src.alias}"):
            for p in range(P):
                # EVERY partition ships, empty included: the owner's
                # gather then always sees typed arrays for both sides
                lo, hi = bounds[p], bounds[p + 1]
                send(owners[p], src.alias, p,
                     {c: a[lo:hi] for c, a in host.items()}, hi - lo)
    done()

    # ---- barrier: all senders done, all announced payloads arrived ----
    with span("exchange_barrier"):
        mailbox.wait_ready(spec["senders"], deadline)

    # ---- stage 2 per owned partition, on the card ----
    def on_card(alias: str, p: int) -> tuple:
        got, n = mailbox.gather(alias, p)
        if not got:
            got = {c: np.empty(0) for c in need[alias]}
        return {f"{alias}.{c}": host_col(np.asarray(v), dev)
                for c, v in got.items()}, n

    owned = sorted(p for p, o in owners.items() if o == self_id)
    partials = []
    total_joined = 0
    for p in owned:
        deadline.check("exchange.stage2")
        left, n_probe = on_card(probe_alias, p)
        build, _ = on_card(build_alias, p)
        with span(f"exchange_join:p{p}"):
            joined, n_j = execute_join_step(
                left, n_probe, step, build, dev, mesh, "SHUFFLE")
        if plan.post_filter is not None and n_j:
            keep = torch.nonzero(_expr_mask(joined, plan.post_filter, None,
                                            n_j)).reshape(-1)
            joined = _take(joined, keep)
            n_j = keep.numel()
        total_joined += n_j
        with span(f"exchange_stage2:p{p}"):
            partials.append(stage2_partial(plan, joined, n_j, {}, ex))
    if partials:
        merged = merge_intermediates(plan.stage2, partials)
    else:
        # a worker that owns no partition still returns a typed empty
        # partial over the joined namespace
        empty = {f"{a}.{c}": host_col(np.empty(0), dev)
                 for a, cs in need.items() for c in cs}
        merged = stage2_partial(plan, empty, 0, {}, ex)
    stats.stage2_rows = total_joined
    merged.stats = stats
    return merged


def catalog_for(engine):
    """The plan compiler's catalog over an engine's tables: table →
    (columns, is a dimension table)."""
    def catalog(table: str):
        tdm = _tdm_for(engine, table)
        segs = tdm.acquire()
        try:
            if not segs:
                raise ValueError(f"table {table!r} has no segments")
            cols = tuple(segs[0].column_names())
        finally:
            tdm.release(segs)
        return cols, bool(getattr(tdm, "is_dim_table", False))

    return catalog


def execute_multistage(engine, stmt, t0: Optional[float] = None) -> dict:
    """Parsed multi-stage statement → broker-style response dict (the
    ``QueryEngine.execute`` integration point)."""
    t0 = time.time() if t0 is None else t0
    plan = compile_plan(stmt, catalog_for(engine))
    analyze = plan.explain and plan.analyze
    if plan.explain and not analyze:
        from pinot_tpu_torch.engine.explain import explain_multistage

        return explain_multistage(engine, plan)
    tracer = None
    if analyze:
        from pinot_tpu_torch.common import trace as _trace

        tracer = _trace.start_trace("analyze")
    try:
        result, stats, meta = run_local(engine, plan)
    finally:
        if tracer is not None:
            from pinot_tpu_torch.common import trace as _trace

            _trace.end_trace()
    resp = result.to_json()
    resp.update({
        "exceptions": [],
        "numDocsScanned": stats.num_docs_scanned,
        "numEntriesScannedInFilter": stats.num_entries_scanned_in_filter,
        "numEntriesScannedPostFilter": stats.num_entries_scanned_post_filter,
        "numSegmentsQueried": stats.num_segments_queried,
        "numSegmentsProcessed": stats.num_segments_processed,
        "numSegmentsMatched": stats.num_segments_matched,
        "numSegmentsPrunedByServer": stats.num_segments_pruned,
        "numBlocksPruned": stats.num_blocks_pruned,
        "numSegmentsCold": stats.num_segments_cold,
        "partialResult": stats.num_segments_cold > 0,
        "numGroupsLimitReached": stats.num_groups_limit_reached,
        "totalDocs": stats.total_docs,
        "numStages": meta["numStages"],
        "numJoinedRows": meta["numJoinedRows"],
        "leafRows": meta.get("leafRows") or {},
        "timeUsedMs": round((time.time() - t0) * 1000, 3),
    })
    if meta.get("roofline"):
        resp["roofline"] = meta["roofline"]
    if meta["joinStrategy"]:
        resp["joinStrategy"] = meta["joinStrategy"]
    # the plan advisor's stamps: stage 2's strategy overrides, then those
    # the leaf scans' stats carried up
    adv_lines = list(meta.get("advisorDecisions") or [])
    for line in (stats.advisor_decisions or []):
        if line not in adv_lines:
            adv_lines.append(line)
    if adv_lines:
        resp["advisorDecisions"] = adv_lines
    if analyze:
        from pinot_tpu_torch.engine.explain import (
            annotate_analyze,
            explain_multistage,
        )

        if tracer is not None and tracer.spans:
            resp["traceInfo"] = {"server": tracer.to_json()}
        out = annotate_analyze(explain_multistage(engine, plan), resp)
        out["analyzedResponse"] = resp
        return out
    return resp
