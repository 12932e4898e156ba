"""Minion task executors: mergeRollup, realtimeToOffline, purge.

Equivalent of the reference's built-in minion tasks
(pinot-plugins/pinot-minion-tasks/pinot-minion-builtin-tasks/.../tasks/:
MergeRollupTaskExecutor, RealtimeToOfflineSegmentsTaskExecutor,
PurgeTaskExecutor), re-shaped for this runtime:

- Segment replace is made atomic to queries via registry segment lineage
  (SegmentLineage analog): brokers route the FROM set while the replace is
  IN_PROGRESS and flip to the TO set on the single-tx COMPLETED flip.
- Record reading is whole-column vectorized numpy over the mmap'd segment
  (not row-by-row GenericRow transforms): merges concatenate column arrays,
  rollup groups via np.unique over factorized dimension ids, and purge
  reuses the host engine's vectorized filter evaluator as its RecordPurger.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from pinot_tpu_torch.common.datatypes import FieldRole
from pinot_tpu_torch.storage.creator import build_segment
from pinot_tpu_torch.storage.segment import ImmutableSegment

log = logging.getLogger("pinot_tpu_torch.minion")


class TaskContext:
    """What an executor needs: cluster state, segment push/delete, scratch."""

    def __init__(self, registry, controller, work_dir: str, device=None):
        from pinot_tpu_torch import resolve_device

        self.registry = registry
        self.controller = controller
        self.work_dir = work_dir
        # where a task's device work runs (purge's filter): the card
        # unless the caller asks for "cpu"
        self.device = resolve_device(device)
        os.makedirs(work_dir, exist_ok=True)

    def scratch(self, task_id: str) -> str:
        d = os.path.join(self.work_dir, task_id)
        os.makedirs(d, exist_ok=True)
        return d


def _wait_until(cond, timeout_s: float = 30.0, interval_s: float = 0.05) -> bool:
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return False


def _read_columns(segments: list, schema, row_masks=None) -> tuple:
    """Concatenate decoded columns across segments (optionally row-masked).
    SV columns come back as typed arrays, MV columns as lists of per-row
    value arrays (what ``build_segment`` expects). Returns
    ``(columns, null_masks)`` — nullness lives only in the per-column null
    vectors (the forward index stores substituted defaults), so a rebuild
    that dropped them would silently un-null every row."""
    out: dict = {}
    null_out: dict = {}
    for name in schema.column_names():
        spec = schema.field(name)
        parts = []
        null_parts = []
        for i, seg in enumerate(segments):
            mask = None if row_masks is None else row_masks[i]
            nv = seg.null_vector(name) if hasattr(seg, "null_vector") else None
            nulls = (np.zeros(seg.n_docs, dtype=bool) if nv is None
                     else np.asarray(nv, dtype=bool)[: seg.n_docs])
            null_parts.append(nulls if mask is None else nulls[mask])
            if spec.single_value:
                vals = np.asarray(seg.flat_values(name))
                parts.append(vals if mask is None else vals[mask])
            else:
                vals = seg.values(name)
                if mask is not None:
                    vals = vals[mask]
                parts.extend(list(vals))
        if spec.single_value:
            out[name] = np.concatenate(parts) if parts else np.array([])
        else:
            out[name] = parts
        combined = np.concatenate(null_parts) if null_parts else np.empty(0, bool)
        if combined.any():
            null_out[name] = combined
    return out, null_out or None


def _rollup(columns: dict, schema, aggregates: dict) -> dict:
    """Group identical dimension/datetime rows, aggregating metric columns
    (MergeRollupTask rollup mode; default aggregation SUM, per
    MergeRollupTaskUtils). MV dimension cells participate as tuples."""
    dim_cols = [n for n in schema.column_names()
                if schema.field(n).role is not FieldRole.METRIC]
    metric_cols = [n for n in schema.column_names()
                   if schema.field(n).role is FieldRole.METRIC]
    n_rows = None
    ids = []
    for name in dim_cols:
        col = columns[name]
        if isinstance(col, list):  # MV: factorize via hashable tuples
            keys = [tuple(np.asarray(v).tolist()) for v in col]
            lut: dict = {}
            arr = np.fromiter((lut.setdefault(k, len(lut)) for k in keys),
                              dtype=np.int64, count=len(keys))
        else:
            _, arr = np.unique(np.asarray(col), return_inverse=True)
        ids.append(arr)
        n_rows = len(arr)
    if not ids:  # no dimensions: single output row
        gid = np.zeros(len(next(iter(columns.values()))), dtype=np.int64)
        first = np.array([0])
        n_groups = 1
    else:
        stacked = np.stack(ids, axis=1)
        uniq, first, gid = np.unique(
            stacked, axis=0, return_index=True, return_inverse=True
        )
        gid = gid.reshape(-1)
        n_groups = len(uniq)
    out: dict = {}
    for name in dim_cols:
        col = columns[name]
        if isinstance(col, list):
            out[name] = [col[i] for i in first]
        else:
            out[name] = np.asarray(col)[first]
    for name in metric_cols:
        vals = np.asarray(columns[name])
        agg = aggregates.get(name, "SUM").upper()
        if agg == "SUM":
            if vals.dtype.kind in "iu":
                # exact integer accumulation — float64 bincount weights lose
                # bits past 2^53
                merged = np.zeros(n_groups, dtype=np.int64)
                np.add.at(merged, gid, vals.astype(np.int64))
                info = np.iinfo(vals.dtype)
                if len(merged) and (merged.max() > info.max
                                    or merged.min() < info.min):
                    raise ValueError(
                        f"rollup SUM of {name} overflows {vals.dtype}; "
                        f"widen the schema column to LONG"
                    )
                merged = merged.astype(vals.dtype)
            else:
                merged = np.bincount(gid, weights=vals.astype(np.float64),
                                     minlength=n_groups)
        elif agg == "MIN":
            merged = np.full(n_groups, np.iinfo(vals.dtype).max
                             if vals.dtype.kind in "iu" else np.inf, dtype=vals.dtype)
            np.minimum.at(merged, gid, vals)
        elif agg == "MAX":
            merged = np.full(n_groups, np.iinfo(vals.dtype).min
                             if vals.dtype.kind in "iu" else -np.inf, dtype=vals.dtype)
            np.maximum.at(merged, gid, vals)
        else:
            raise ValueError(f"unsupported rollup aggregate {agg!r} for {name}")
        out[name] = merged
    return out


def _lineage_swap(ctx: TaskContext, table: str, input_names: list,
                  out_dir: str, merged_name: str) -> None:
    """Upload ``out_dir`` as the replacement for ``input_names`` with
    query-atomic cutover, then delete the inputs."""
    lid = ctx.registry.start_lineage(table, input_names, [merged_name])
    try:
        ctx.controller.upload_segment(table, out_dir)
        # Wait for a server to actually serve the replacement before the
        # flip — completing early would leave queries seeing neither set.
        if not _wait_until(
            lambda: merged_name in ctx.registry.external_view(table)
        ):
            raise TimeoutError(
                f"replacement segment {merged_name} never reached the "
                f"external view of {table}"
            )
        if not ctx.registry.complete_lineage(table, lid):
            # controller repair claimed the entry while we were uploading
            # (we looked dead); abandoning keeps the FROM set authoritative
            raise RuntimeError(
                f"lineage {lid} flip lost to concurrent repair; "
                f"abandoning replace of {input_names}"
            )
    except Exception:
        # Unwind BEFORE dropping the lineage entry: while IN_PROGRESS the
        # replacement is routing-excluded, so deleting it first can never
        # expose a double-counting window (to + from both routed).
        try:
            ctx.controller.delete_segment(table, merged_name)
        except Exception:  # noqa: BLE001 — best-effort unwind
            log.exception("failed to unwind replacement segment %s", merged_name)
        ctx.registry.revert_lineage(table, lid)
        raise
    for name in input_names:
        ctx.controller.delete_segment(table, name)
    ctx.registry.prune_lineage(table)


def execute_merge_rollup(ctx: TaskContext, task: dict) -> str:
    """MergeRollupTaskExecutor analog: N small segments -> one, optionally
    rolling up duplicate dimension rows. Star-trees are rebuilt implicitly:
    ``build_segment`` re-runs the star-tree build from the table config."""
    table = task["table"]
    cfg = task["config"]
    schema = ctx.registry.table_schema(table)
    table_cfg = ctx.registry.table_config(table)
    records = ctx.registry.segments(table)
    # Requeued-attempt idempotency: if a previous attempt already flipped a
    # COMPLETED lineage over (some of) these inputs, the replacement is the
    # live copy — re-merging would shadow it. Finish that attempt's cleanup
    # (delete the leftover FROM segments) instead of redoing the merge.
    input_set = set(cfg["segments"])
    for entry in ctx.registry.lineage(table).values():
        if entry["state"] == "COMPLETED" and input_set & set(entry["from"]):
            for name in entry["from"]:
                if name in records:
                    ctx.controller.delete_segment(table, name)
            ctx.registry.prune_lineage(table)
            return (f"previous attempt already committed "
                    f"{entry['to']}; cleaned up leftover inputs")
    names = [n for n in cfg["segments"] if n in records]
    if len(names) < 2:
        return f"skipped: only {len(names)} input segments still exist"
    segments = [ImmutableSegment(records[n].location) for n in names]
    columns, null_masks = _read_columns(segments, schema)
    if cfg.get("mode", "concat") == "rollup":
        columns = _rollup(columns, schema, cfg.get("rollup_aggregates", {}))
        # rollup re-groups rows: per-row nullness no longer maps through
        # (aggregated metrics are non-null; dims grouped by substituted
        # value). Matches the reference, where rollup drops null vectors.
        null_masks = None
    # name is unique per task AND per attempt: a requeued re-run must never
    # collide with a half-dead prior attempt's upload
    merged_name = (f"merged_{table}_"
                   + "_".join(task["id"].split("_")[-2:])
                   + f"_a{task.get('attempts', 1)}")
    out_dir = os.path.join(ctx.scratch(task["id"]), merged_name)
    build_segment(schema, columns, out_dir, table_cfg, merged_name,
                  null_masks=null_masks)
    _lineage_swap(ctx, table, names, out_dir, merged_name)
    n_docs = len(next(iter(columns.values())))
    return f"merged {len(names)} segments -> {merged_name} ({n_docs} docs)"


def execute_realtime_to_offline(ctx: TaskContext, task: dict) -> str:
    """RealtimeToOfflineSegmentsTaskExecutor analog: extract the
    [window_start, window_end) time slice from sealed realtime segments into
    a segment pushed to the OFFLINE table, then advance the watermark. The
    hybrid broker's time boundary moves with the new offline max end time,
    which is what hides the realtime copies of the moved rows."""
    rt_table = task["table"]
    cfg = task["config"]
    ws, we = cfg["window_start_ms"], cfg["window_end_ms"]
    raw = rt_table[: -len("_REALTIME")]
    off_table = f"{raw}_OFFLINE"
    rt_cfg = ctx.registry.table_config(rt_table)
    schema = ctx.registry.table_schema(rt_table)
    off_cfg = ctx.registry.table_config(off_table)
    if off_cfg is None:
        raise KeyError(f"no offline table {off_table} to move data into")
    time_col = rt_cfg.time_column
    records = ctx.registry.segments(rt_table)
    segs, masks = [], []
    for rec in records.values():
        if rec.state != "ONLINE" or not rec.location:
            continue
        if rec.start_time is not None and rec.start_time >= we:
            continue
        if rec.end_time is not None and rec.end_time < ws:
            continue
        seg = ImmutableSegment(rec.location)
        tvals = np.asarray(seg.flat_values(time_col))
        mask = (tvals >= ws) & (tvals < we)
        if mask.any():
            segs.append(seg)
            masks.append(mask)
    moved = 0
    if segs:
        columns, null_masks = _read_columns(segs, schema, masks)
        moved = len(next(iter(columns.values())))
        name = f"{raw}_{ws}_{we}"
        out_dir = os.path.join(ctx.scratch(task["id"]), name)
        build_segment(schema, columns, out_dir, off_cfg, name,
                      null_masks=null_masks)
        ctx.controller.upload_segment(off_table, out_dir)
        # Gate on a server actually serving the pushed segment before
        # advancing the watermark: the hybrid time boundary only moves for
        # externally-visible offline segments (broker._physical_tables), so
        # the window never goes dark between push and load. On timeout the
        # push is unwound and the watermark stays put for a retry.
        if not _wait_until(
            lambda: name in ctx.registry.external_view(off_table)
        ):
            ctx.controller.delete_segment(off_table, name)
            raise TimeoutError(
                f"offline segment {name} never reached the external view "
                f"of {off_table}; watermark not advanced"
            )
    meta = ctx.registry.task_metadata_get(rt_table, "RealtimeToOfflineSegmentsTask")
    meta["watermark_ms"] = we
    ctx.registry.task_metadata_set(rt_table, "RealtimeToOfflineSegmentsTask", meta)
    return f"moved {moved} docs in [{ws}, {we}) to {off_table}"


def execute_purge(ctx: TaskContext, task: dict) -> str:
    """PurgeTaskExecutor analog. The RecordPurger is a SQL boolean
    expression from the task config (rows MATCHING it are dropped),
    evaluated as a filter plane on the worker's device (engine/rows.py
    ``filter_mask``: the filter lowering of the host path's shape, where
    the reference runs its host evaluator) instead of a per-row Java
    predicate."""
    from pinot_tpu_torch.engine.rows import filter_mask
    from pinot_tpu_torch.query.optimizer import optimize_query
    from pinot_tpu_torch.sql.compiler import compile_query

    table = task["table"]
    cfg = task["config"]
    schema = ctx.registry.table_schema(table)
    table_cfg = ctx.registry.table_config(table)
    filter_node = optimize_query(
        compile_query(f"SELECT COUNT(*) FROM {table} WHERE {cfg['filter']}")
    ).filter
    records = ctx.registry.segments(table)
    purged_meta = ctx.registry.task_metadata_get(table, "PurgeTask")
    # the purged map is only valid for the filter it was built under
    if purged_meta.get("filter") != cfg["filter"]:
        purged_meta = {"filter": cfg["filter"], "purged": {}}
    done = dict(purged_meta.get("purged", {}))
    out_msgs = []
    for name in cfg["segments"]:
        rec = records.get(name)
        if rec is None:
            continue
        seg = ImmutableSegment(rec.location)
        drop = filter_mask(seg, filter_node, ctx.device)
        n_drop = int(drop.sum())
        if n_drop == 0:
            out_msgs.append(f"{name}: clean")
        elif n_drop == seg.n_docs:
            ctx.controller.delete_segment(table, name)
            out_msgs.append(f"{name}: fully purged ({n_drop} docs), deleted")
        else:
            keep = ~drop
            columns, null_masks = _read_columns([seg], schema, [keep])
            new_name = f"{name}_purged_{int(time.time() * 1000)}"
            out_dir = os.path.join(ctx.scratch(task["id"]), new_name)
            build_segment(schema, columns, out_dir, table_cfg, new_name,
                          null_masks=null_masks)
            _lineage_swap(ctx, table, [name], out_dir, new_name)
            done[new_name] = int(time.time() * 1000)
            out_msgs.append(f"{name}: purged {n_drop} docs -> {new_name}")
        done[name] = int(time.time() * 1000)
    purged_meta["purged"] = done
    ctx.registry.task_metadata_set(table, "PurgeTask", purged_meta)
    return "; ".join(out_msgs) if out_msgs else "nothing to purge"


def execute_refresh_segments(ctx: TaskContext, task: dict) -> str:
    """Rebuild segments under the CURRENT IndexingConfig — the reference's
    segment reload (needReload -> reload) expressed as a lineage-atomic
    minion swap: each input rebuilds 1:1 under a fresh name so queries
    never see a half-indexed copy."""
    table = task["table"]
    cfg = task["config"]
    schema = ctx.registry.table_schema(table)
    table_cfg = ctx.registry.table_config(table)
    records = ctx.registry.segments(table)
    # requeued-attempt idempotency (same contract as merge): a COMPLETED
    # lineage over an input means a prior attempt already swapped it —
    # finish that attempt's cleanup (delete the leftover FROM copy) so the
    # lineage entry can prune and the segment stops being busy forever
    done_lineage = {
        f for e in ctx.registry.lineage(table).values()
        if e["state"] == "COMPLETED" for f in e["from"]
    }
    out_msgs = []
    attempt = task.get("attempts", 1)
    suffix = "_".join(task["id"].split("_")[-2:])
    for name in cfg["segments"]:
        rec = records.get(name)
        if name in done_lineage:
            if rec is not None:
                ctx.controller.delete_segment(table, name)
            ctx.registry.prune_lineage(table)
            out_msgs.append(f"{name}: already swapped; cleaned up leftover")
            continue
        if rec is None:
            out_msgs.append(f"{name}: gone")
            continue
        seg = ImmutableSegment(rec.location)
        columns, null_masks = _read_columns([seg], schema)
        new_name = f"refreshed_{name}_{suffix}_a{attempt}"
        out_dir = os.path.join(ctx.scratch(task["id"]), new_name)
        build_segment(schema, columns, out_dir, table_cfg, new_name,
                      null_masks=null_masks)
        _lineage_swap(ctx, table, [name], out_dir, new_name)
        out_msgs.append(f"{name} -> {new_name}")
    return "; ".join(out_msgs) or "nothing to refresh"


TASK_EXECUTORS = {
    "MergeRollupTask": execute_merge_rollup,
    "RealtimeToOfflineSegmentsTask": execute_realtime_to_offline,
    "PurgeTask": execute_purge,
    "RefreshSegmentsTask": execute_refresh_segments,
}
