"""EXPLAIN PLAN FOR and EXPLAIN ANALYZE: the logical plan as rows.

Counterpart of pinot_tpu/engine/explain.py's ``explain_plan`` (the
reference's ServerQueryExecutorV1Impl.processExplainPlanQueries renders
the operator tree): the engine's shape dispatch, the filter tree with
the index each predicate takes on a representative segment, the
projected columns and, for the shapes the reference's device runs, the
on-device trim and the device partials cache's ``CACHED_PARTIALS`` line.
Every line equals the JAX package's but the backend label, which names
what runs the query here: the card, in the reference's device shape or
in its host path's shape (engine/rows.py).

``annotate_analyze`` renders EXPLAIN ANALYZE: the plan annotated with the
executed response's actuals, then the ANALYZE subtree (rows, segments,
the phase waterfall, one KERNEL line per roofline flight, the cache
state, the ADVISOR lines), as the reference's. A flight's label names the port's kernels
``+cuda`` where the reference names its Pallas tier ``+pallas``.

``explain_multistage`` renders a two-stage (join / window) plan as the
reference's does: the stage boundary, each join's strategy with its build
and probe sides, the window specs and each table's stage-1 scan with its
pushed-down filter. The backend label names the card; the boundary's
exchange is ``[server-fleet]`` for DISTRIBUTED (stage 2 runs on the
servers, over query2/exchange.py), else ``[mesh-collective]`` on a mesh
(parallel/mesh.py), else ``[local]``, as the reference's.
"""

from __future__ import annotations

import os

import numpy as np

from pinot_tpu_torch.common.options import bool_option
from pinot_tpu_torch.engine.values import filter_operator_for
from pinot_tpu_torch.query.context import FilterNode, FilterNodeType, \
    QueryContext

BACKEND_DEVICE = "DEVICE(torch/cuda)"
BACKEND_HOST_SHAPE = "DEVICE(torch/cuda, host-path shape)"


def _width_lines(q: QueryContext, segs, out: list) -> None:
    """PINOT_TPU_WIDTH_AUDIT=1: the device width plan of each referenced
    column (engine/params.py ColPlan). Best-effort: a column the device
    path rejects renders no line."""
    from pinot_tpu_torch.engine.params import BatchContext
    from pinot_tpu_torch.storage.segment import Encoding

    try:
        # a throwaway context on the host: planning reads only metadata
        # and dictionaries, and the executor's batch cache stays as it is
        ctx = BatchContext(segs, "cpu")
        for name in sorted(q.columns()):
            plan = ctx.width_plan(name)
            desc = np.dtype(plan.dtype).name
            if plan.bits:
                desc += f" packed={plan.bits}b"
            if plan.offset is not None:
                desc += f" for-offset={plan.offset}"
            if plan.wide:
                desc += f" wide={np.dtype(plan.wide).name}"
            if ctx.encoding(name) == Encoding.DICT:
                desc += f" card={ctx.cardinality(name)}"
            out.append(f"    WIDTH({name}: {desc})")
    except Exception:  # noqa: BLE001 — display only
        pass


def _filter_lines(f: FilterNode, depth: int, out: list, seg=None) -> None:
    pad = "  " * depth
    if f.type is FilterNodeType.PREDICATE:
        op = "PREDICATE" if seg is None \
            else filter_operator_for(seg, f.predicate)
        out.append(f"{pad}FILTER_{op}({f.predicate})")
        return
    out.append(f"{pad}FILTER_{f.type.value}")
    for c in f.children:
        _filter_lines(c, depth + 1, out, seg)


def _rows_response(lines: list) -> dict:
    return {
        "resultTable": {
            "dataSchema": {
                "columnNames": ["Operator", "Operator_Id", "Parent_Id"],
                "columnDataTypes": ["STRING", "INT", "INT"],
            },
            "rows": [[ln, i, i - 1] for i, ln in enumerate(lines)],
        },
        "exceptions": [],
    }


def _trim_line(engine, q: QueryContext, segs) -> str | None:
    """The DEVICE_REDUCE line, when the on-device trim would engage: its
    static bound below the group table's length (cardinalities from a
    throwaway context; a group key without one renders no line): the
    dense group count, or the sorted regime's cap K."""
    from pinot_tpu_torch.engine.device import (
        MAX_DENSE_GROUPS,
        MAX_SORTED_GROUPS,
    )
    from pinot_tpu_torch.engine.params import BatchContext
    from pinot_tpu_torch.ops.device_reduce import plan_trim, trim_keep_count

    dev = engine.device
    try:
        ctx = BatchContext(segs, "cpu")
        total = 1
        for g in q.group_by:
            total *= ctx.cardinality(g.name)
        if total > MAX_DENSE_GROUPS:
            total = min(dev.num_groups_limit, MAX_SORTED_GROUPS)
        spec = plan_trim(q, tuple(q.group_by), tuple(q.aggregations()),
                         total, "terminal", dev.group_trim_size)
    except Exception:  # noqa: BLE001 — display only
        return None
    if spec is None:
        return None
    return f"    DEVICE_REDUCE(trim={trim_keep_count(q, 'terminal')})"


def _fmt_ms(v) -> str:
    try:
        return f"{float(v):.2f}ms"
    except (TypeError, ValueError):
        return "?"


def _kernel_line(rec: dict) -> str:
    """One roofline flight → its KERNEL line: achieved GB/s against the
    probed peak, modeled bytes, kernel and link time, and the instance
    that ran it where a broker merged the flights of several."""
    label = rec.get("kernel", "kernel")
    inst = rec.get("instance")
    where = f"@{inst}" if inst else ""
    if rec.get("cacheHit"):
        return (f"    KERNEL({label}{where}: CACHED_PARTIALS, "
                f"linkMs={rec.get('linkMs')})")
    gbps = rec.get("gbps")
    pct = rec.get("pctOfPeak")
    if gbps is None:
        perf = "n/a"
    elif pct is not None:
        perf = (f"{gbps} GB/s ({pct}% of HBM peak {rec.get('peakGbps')} "
                f"GB/s)")
    else:
        perf = f"{gbps} GB/s"
    return (f"    KERNEL({label}{where}: {perf}, "
            f"bytes={rec.get('bytesMoved')}, "
            f"kernelMs={rec.get('kernelMs')}, linkMs={rec.get('linkMs')})")


def annotate_analyze(plan: dict, resp: dict) -> dict:
    """EXPLAIN ANALYZE rendering: the plan's rows annotated with the
    executed response's actuals (rows in / out on the reduce and the
    combine, matched rows and blocks pruned on the root filter), then an
    ANALYZE subtree with the segment counters, the phase waterfall, one
    KERNEL line per roofline flight and the cache state."""
    lines = [r[0] for r in plan["resultTable"]["rows"]]
    nrows = len(((resp.get("resultTable") or {}).get("rows")) or [])
    docs = resp.get("numDocsScanned")
    leaf_rows = resp.get("leafRows") or {}
    # a multi-stage plan carries a filter per table: the total
    # numDocsScanned belongs to none of them
    filter_done = bool(leaf_rows) or resp.get("numJoinedRows") is not None
    out = []
    for ln in lines:
        s = ln.strip()
        if s.startswith("BROKER_REDUCE"):
            ln += f" (actual: rows={nrows}, timeMs={resp.get('timeUsedMs')})"
        elif s.startswith("STAGE_2_"):
            # stage 2 reads the joined rows, not the leaves' docs
            n_in = resp.get("numJoinedRows")
            ln += (f" (actual: in={docs if n_in is None else n_in} rows, "
                   f"out={nrows} rows)")
        elif s.startswith("COMBINE_"):
            ln += f" (actual: in={docs} rows, out={nrows} rows)"
        elif s.startswith("STAGE_BOUNDARY(") and resp.get("exchange"):
            # a distributed stage 2 ran (perhaps demoted at run time): the
            # strategy that ran, the partition count, shipped bytes,
            # spills and each server's stage-2 rows
            import re as _re

            ex = resp["exchange"]
            if "exchange:DISTRIBUTED" not in ln:
                ln = _re.sub(r"exchange:\w+ \[[^\]]*\]",
                             "exchange:DISTRIBUTED [server-fleet]", ln)
            per = ", ".join(
                f"{w}={v.get('stage2Rows')}"
                for w, v in sorted((ex.get("servers") or {}).items()))
            ln += (f" (actual: partitions={ex.get('partitions')}, "
                   f"shippedBytes={resp.get('exchangeBytes')}, "
                   f"spills={resp.get('exchangeSpillCount')}, "
                   f"stage2Rows[{per}])")
        elif s.startswith("JOIN_") and resp.get("numJoinedRows") is not None:
            ln += f" (actual: out={resp['numJoinedRows']} rows)"
        elif s.startswith("SCAN("):
            alias = s[len("SCAN("):].split("=", 1)[0]
            if alias in leaf_rows:
                ln += f" (actual: out={leaf_rows[alias]} rows)"
        elif (s.startswith("FILTER_") and not filter_done
              and not s.startswith("FILTER_MATCH_ENTIRE")
              and docs is not None):
            filter_done = True  # the ROOT filter node only
            ln += (f" (actual: matched={docs} rows, "
                   f"blocksPruned={resp.get('numBlocksPruned', 0)})")
        out.append(ln)
    out.append("  ANALYZE")
    out.append(f"    ROWS(scanned={docs}, returned={nrows}, "
               f"totalDocs={resp.get('totalDocs')})")
    out.append(
        "    SEGMENTS("
        f"queried={resp.get('numSegmentsQueried')}, "
        f"processed={resp.get('numSegmentsProcessed')}, "
        f"matched={resp.get('numSegmentsMatched')}, "
        f"prunedByServer={resp.get('numSegmentsPrunedByServer')}, "
        f"prunedByBroker={resp.get('numSegmentsPrunedByBroker', 0)}, "
        f"blocksPruned={resp.get('numBlocksPruned')})")
    # the multi-stage traceInfo nests a dict of spans per leaf:
    # tools/querylog.py's breakdown walks it
    from pinot_tpu_torch.tools.querylog import phase_breakdown

    phases = phase_breakdown({"traceInfo": resp.get("traceInfo") or {}})
    if phases:
        out.append("    PHASE(" + ", ".join(
            f"{k}={_fmt_ms(v)}" for k, v in sorted(phases.items())) + ")")
    for rec in resp.get("roofline") or ():
        out.append(_kernel_line(rec))
    out.append(
        f"    CACHE(partialsCacheHit={bool(resp.get('partialsCacheHit'))}, "
        f"resultCacheHit={bool(resp.get('resultCacheHit'))})")
    # the plan advisor: one line per measurement-driven override this
    # execution ran with, formatted at the decision site as
    # ADVISOR(<decision>: measured=X default=Y)
    for line in resp.get("advisorDecisions") or ():
        out.append(f"    {line}")
    return _rows_response(out)


def explain_multistage(engine, plan) -> dict:
    """EXPLAIN of a two-stage (join / window) plan: the reference's lines,
    the card as the backend, the stage boundary's exchange local or on
    the mesh."""
    from pinot_tpu_torch.query2.logical import to_sql
    from pinot_tpu_torch.sql.compiler import _to_filter

    q = plan.stage2
    aggs = q.aggregations()
    if q.distinct:
        shape = "DISTINCT"
    elif aggs and q.group_by:
        shape = "AGGREGATE_GROUPBY_ORDERBY"
    elif aggs:
        shape = "AGGREGATE"
    elif plan.windows:
        shape = "SELECT_WINDOW"
    else:
        shape = "SELECT_ORDERBY" if q.order_by else "SELECT"
    lines = [f"BROKER_REDUCE(limit:{q.limit})",
             f"  STAGE_2_{shape}"
             f"({', '.join(str(e) for e in q.select_expressions)})"
             f" [{BACKEND_DEVICE}]"]
    if q.group_by:
        lines.append(
            f"    GROUP_BY({', '.join(str(g) for g in q.group_by)})")
    if q.having is not None:
        lines.append(f"    HAVING({q.having})")
    for w in plan.windows:
        lines.append(f"    WINDOW({w.describe()})")
    if plan.post_filter is not None:
        lines.append(f"    POST_JOIN_FILTER({to_sql(plan.post_filter)})")
    # DISTRIBUTED runs stage 2 on the server fleet: the boundary is a
    # wire exchange between servers, whatever mesh the renderer sees
    mesh = getattr(getattr(engine, "device", None), "mesh", None)
    if plan.strategy == "DISTRIBUTED" and plan.joins:
        exchange = "server-fleet"
    else:
        exchange = "mesh-collective" if mesh is not None else "local"
    if plan.joins:
        lines.append(f"  STAGE_BOUNDARY(exchange:{plan.strategy} "
                     f"[{exchange}])")
    else:
        lines.append("  STAGE_BOUNDARY(exchange:SORT [window])")
    probe_desc = f"{plan.probe.alias}={plan.probe.table}"
    for j in plan.joins:
        dim = " dim" if j.build.is_dim else ""
        lines.append(
            f"  JOIN_{j.kind}(strategy={plan.strategy}, "
            f"build={j.build.alias}={j.build.table}{dim}, "
            f"probe={probe_desc})")
        keys = ", ".join(f"{lk} = {rk}"
                         for lk, rk in zip(j.left_keys, j.right_keys))
        lines.append(f"      KEYS({keys})")
        if j.residual is not None:
            lines.append(f"      RESIDUAL({to_sql(j.residual)})")
    for src in plan.sources:
        role = "probe" if src is plan.probe else \
            ("build/broadcast" if plan.strategy == "BROADCAST"
             else "build/shuffle")
        lines.append(f"  SCAN({src.alias}={src.table} [{role}])")
        push = plan.pushdown.get(src.alias)
        if push is not None:
            _filter_lines(_to_filter(push), 2, lines)
        else:
            lines.append("    FILTER_MATCH_ENTIRE_SEGMENT")
    return _rows_response(lines)


def explain_plan(engine, q: QueryContext) -> dict:
    aggs = q.aggregations()
    if q.distinct:
        shape = "DISTINCT"
    elif aggs and q.group_by:
        shape = "AGGREGATE_GROUPBY_ORDERBY"
    elif aggs:
        shape = "AGGREGATE"
    else:
        shape = "SELECT_ORDERBY" if q.order_by else "SELECT"
    # the broker renders without an executor (its servers pick the
    # shape), as the reference's broker renders its host label
    device_shape = engine.device is not None and engine.device.supports(q)
    backend = BACKEND_DEVICE if device_shape else BACKEND_HOST_SHAPE
    tdm = engine.tables.get(q.table_name)
    segs = list(tdm.segments.values()) if tdm is not None else []

    lines = [f"BROKER_REDUCE(limit:{q.limit})",
             f"  COMBINE_{shape} [{backend}]",
             f"    PLAN_START(table:{q.table_name})",
             f"    {shape}({', '.join(str(e) for e in q.select_expressions)})"]
    if q.group_by:
        lines.append(f"    GROUP_BY({', '.join(str(g) for g in q.group_by)})")
    if q.filter is not None:
        # index choice is per segment; like the reference's non-verbose
        # mode, EXPLAIN describes it on one representative segment. The
        # stats pruner's verdicts: every segment pruned renders as
        # FILTER_EMPTY, some as a PRUNE line under the tree
        n_pruned = sum(1 for s in segs if engine.pruner.prune(q, s))
        if segs and n_pruned == len(segs):
            lines.append("    FILTER_EMPTY")
        else:
            _filter_lines(q.filter, 2, lines, segs[0] if segs else None)
            if n_pruned:
                lines.append(
                    f"      PRUNE(zone-map: {n_pruned}/{len(segs)} segments)")
    else:
        lines.append("    FILTER_MATCH_ENTIRE_SEGMENT")
    lines.append("    PROJECT(" + ", ".join(sorted(q.columns())) + ")")
    if device_shape and q.group_by and not q.distinct and segs:
        line = _trim_line(engine, q, segs)
        if line is not None:
            lines.append(line)
    dev = engine.device
    if device_shape and dev.partials_cache_enabled \
            and bool_option(q.options_ci(), "usepartialscache",
                            None) is not False:
        lines.append(f"    CACHED_PARTIALS(entries={len(dev._partials)})")
    if device_shape and segs \
            and os.environ.get("PINOT_TPU_WIDTH_AUDIT", "") not in ("", "0"):
        _width_lines(q, segs, lines)
    return _rows_response(lines)
