"""EXPLAIN PLAN FOR: the logical plan as rows.

Counterpart of pinot_tpu/engine/explain.py's ``explain_plan`` (the
reference's ServerQueryExecutorV1Impl.processExplainPlanQueries renders
the operator tree): the engine's shape dispatch, the filter tree with
the index each predicate takes on a representative segment, the
projected columns and, for the shapes the reference's device runs, the
on-device trim. Every line equals the JAX package's but the backend
label, which names what runs the query here: the card, in the
reference's device shape or in its host path's shape (engine/rows.py).
The port has no device partials cache, so no CACHED_PARTIALS line
renders (the reference's line with the cache off); EXPLAIN ANALYZE and
multi-stage plans come with later slices.
"""

from __future__ import annotations

import os

import numpy as np

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
    device_shape = engine.device.supports(q)
    backend = BACKEND_DEVICE if device_shape else BACKEND_HOST_SHAPE
    segs = list(engine.tables.get(q.table_name) or ())

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
    if device_shape and segs \
            and os.environ.get("PINOT_TPU_WIDTH_AUDIT", "") not in ("", "0"):
        _width_lines(q, segs, lines)
    return _rows_response(lines)
