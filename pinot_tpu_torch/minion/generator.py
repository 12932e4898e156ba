"""Minion task generation: table task configs -> concrete queued tasks.

Equivalent of the reference's ``PinotTaskManager`` + per-type task
generators (pinot-controller/.../core/minion/PinotTaskManager.java,
pinot-plugins/.../tasks/*/…TaskGenerator.java), driven by
``TableConfig.task_configs`` and the registry task queue instead of the
Helix task framework.

Divergence worth noting: RealtimeToOffline window-readiness here is "sealed
data exists past the window end" rather than the reference's per-partition
consuming-state check — the registry's completion FSM seals partitions
independently, and the buffer_ms guard covers stragglers the same way the
reference's bufferTimePeriod does.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger("pinot_tpu_torch.minion")

_ACTIVE = ("PENDING", "RUNNING")


def _busy_segments(registry, table: str) -> set:
    """Segments referenced by queued/running tasks or active lineage — not
    eligible for new tasks (no two tasks may rewrite the same segment)."""
    busy: set = set()
    for t in registry.tasks(table=table):
        if t["state"] in _ACTIVE:
            busy.update(t["config"].get("segments", ()))
    for entry in registry.lineage(table).values():
        # Mid-swap (IN_PROGRESS/ABORTING): both sides are locked.
        # COMPLETED: the from-set is awaiting deletion, but the to-set is a
        # live segment — eligible for new tasks.
        busy.update(entry["from"])
        if entry["state"] != "COMPLETED":
            busy.update(entry["to"])
    return busy


def _has_active_task(registry, table: str, task_type: str) -> bool:
    return any(
        t["type"] == task_type and t["state"] in _ACTIVE
        for t in registry.tasks(table=table)
    )


def generate_merge_rollup_tasks(registry, table: str, cfg: dict) -> list:
    """Small ONLINE segments -> merge buckets up to max_docs_per_segment
    (MergeRollupTaskGenerator, simplified to a single merge level)."""
    table_cfg = registry.table_config(table)
    if table_cfg is not None and table_cfg.upsert.mode != "NONE":
        return []  # validDocIds are server-local; compaction handles upsert
    if _has_active_task(registry, table, "RealtimeToOfflineSegmentsTask"):
        # an RTO task reads whichever ONLINE segments overlap its window at
        # EXECUTION time (its config carries no segment list), so no swap
        # may run concurrently with it
        return []
    max_docs = int(cfg.get("max_docs_per_segment", 5_000_000))
    min_inputs = int(cfg.get("min_input_segments", 2))
    busy = _busy_segments(registry, table)
    candidates = sorted(
        (r for r in registry.segments(table).values()
         if r.state == "ONLINE" and r.location and r.name not in busy
         and r.n_docs < max_docs),
        key=lambda r: r.name,
    )
    out = []
    bucket, bucket_docs = [], 0
    for rec in candidates:
        if bucket_docs + rec.n_docs > max_docs and bucket:
            if len(bucket) >= min_inputs:
                out.append(bucket)
            bucket, bucket_docs = [], 0
        bucket.append(rec.name)
        bucket_docs += rec.n_docs
    if len(bucket) >= min_inputs:
        out.append(bucket)
    ids = []
    for names in out:
        ids.append(registry.submit_task("MergeRollupTask", table, {
            "segments": names,
            "mode": cfg.get("mode", "concat"),
            "rollup_aggregates": cfg.get("rollup_aggregates", {}),
        }))
    return ids


def generate_realtime_to_offline_tasks(registry, table: str, cfg: dict,
                                       now_ms: int) -> list:
    """One time-bucket window per invocation, watermark-driven
    (RealtimeToOfflineSegmentsTaskGenerator)."""
    if not table.endswith("_REALTIME"):
        return []
    raw = table[: -len("_REALTIME")]
    if registry.table_config(f"{raw}_OFFLINE") is None:
        return []
    table_cfg = registry.table_config(table)
    if table_cfg is None or table_cfg.time_column is None:
        return []
    if any(t["state"] in _ACTIVE for t in registry.tasks(table=table)) \
            or registry.lineage(table):
        return []  # exclusive with swaps: RTO reads live ONLINE segments
    bucket_ms = int(cfg.get("bucket_ms", 86_400_000))
    # Reference default bufferTimePeriod=2d: the window must be well past
    # "now" before moving — the guard against a slow partition whose
    # in-window rows are still CONSUMING (we only read sealed segments, and
    # consuming segments carry no time metadata to check directly).
    buffer_ms = int(cfg.get("buffer_ms", 2 * 86_400_000))
    sealed = [r for r in registry.segments(table).values()
              if r.state == "ONLINE" and r.start_time is not None]
    if not sealed:
        return []
    meta = registry.task_metadata_get(table, "RealtimeToOfflineSegmentsTask")
    wm = meta.get("watermark_ms")
    if wm is None:
        wm = (min(r.start_time for r in sealed) // bucket_ms) * bucket_ms
    we = wm + bucket_ms
    max_end = max(r.end_time for r in sealed if r.end_time is not None)
    if we > now_ms - buffer_ms or max_end < we:
        return []  # window not yet complete
    return [registry.submit_task("RealtimeToOfflineSegmentsTask", table, {
        "window_start_ms": int(wm), "window_end_ms": int(we),
        "bucket_ms": bucket_ms,
    })]


def generate_purge_tasks(registry, table: str, cfg: dict) -> list:
    """Segments not yet purged under the current filter (PurgeTaskGenerator
    tracks last-purge time in segment metadata; here a task-metadata map)."""
    if not cfg.get("filter"):
        return []
    table_cfg = registry.table_config(table)
    if table_cfg is not None and table_cfg.upsert.mode != "NONE":
        return []
    if _has_active_task(registry, table, "RealtimeToOfflineSegmentsTask"):
        return []
    busy = _busy_segments(registry, table)
    meta = registry.task_metadata_get(table, "PurgeTask")
    # a changed filter is a new purge request: prior markers don't apply
    done = meta.get("purged", {}) if meta.get("filter") == cfg["filter"] else {}
    names = [r.name for r in registry.segments(table).values()
             if r.state == "ONLINE" and r.location
             and r.name not in busy and r.name not in done]
    if not names:
        return []
    return [registry.submit_task("PurgeTask", table, {
        "segments": sorted(names), "filter": cfg["filter"],
    })]


def _index_mismatch(meta, idx_cfg) -> bool:
    """True when a segment's on-disk indexes don't reflect the CURRENT
    IndexingConfig (the reload-needed check the reference surfaces through
    needReload/table reload status). Only indexes the BUILDER can actually
    create count — an unachievable config entry (inverted on a RAW column,
    range on a RAW MV column) must not flag forever, or generation would
    rebuild-and-swap the same segment in an infinite loop."""
    cols = meta.columns
    for c in idx_cfg.inverted_index_columns:
        if c in cols and cols[c].has_dictionary and not cols[c].has_inverted:
            return True
    for c in idx_cfg.bloom_filter_columns:
        if c in cols and not cols[c].has_bloom:
            return True
    for c in getattr(idx_cfg, "json_index_columns", ()):
        if c in cols and cols[c].single_value and \
                cols[c].data_type.is_string_like and not cols[c].has_json_index:
            return True
    for c in getattr(idx_cfg, "text_index_columns", ()):
        if c in cols and cols[c].single_value and \
                cols[c].data_type.is_string_like and not cols[c].has_text_index:
            return True
    for c in idx_cfg.range_index_columns:
        if c in cols and not cols[c].has_range and (
            cols[c].encoding == "DICT"
            or (cols[c].encoding == "RAW" and cols[c].single_value)
        ):
            return True
    for c in getattr(idx_cfg, "compressed_columns", ()):
        if c in cols and cols[c].encoding == "RAW" and \
                cols[c].single_value and cols[c].compression is None:
            return True
    return False


def generate_refresh_tasks(registry, table: str, cfg: dict) -> list:
    """Segments whose index set lags the current IndexingConfig get a
    rebuild task (the reference's segment reload, as a minion swap)."""
    import json as _json
    import os as _os

    from pinot_tpu_torch.storage.segment import METADATA_FILE, SegmentMetadata

    table_cfg = registry.table_config(table)
    if table_cfg is None:
        return []
    if table_cfg.upsert.mode != "NONE":
        # validDocIds are server-local in-memory state: a rebuilt copy
        # would resurrect superseded rows (same reason merge/purge skip)
        return []
    if _has_active_task(registry, table, "RealtimeToOfflineSegmentsTask"):
        # an RTO task reads whichever ONLINE segments overlap its window
        # at EXECUTION time; no swap may run concurrently with it
        return []
    busy = _busy_segments(registry, table)
    # segments are immutable: once a segment checked clean under THIS
    # indexing config, skip re-parsing its metadata on every cycle
    fp = _json.dumps(table_cfg.indexing.__dict__, sort_keys=True, default=str)
    meta_state = registry.task_metadata_get(table, "RefreshSegmentsTask")
    clean = set(meta_state.get("clean", ())) \
        if meta_state.get("config_fp") == fp else set()
    stale = []
    for r in registry.segments(table).values():
        if r.state != "ONLINE" or not r.location or r.name in busy \
                or r.name in clean:
            continue
        meta_path = _os.path.join(r.location, METADATA_FILE)
        try:
            with open(meta_path) as f:
                meta = SegmentMetadata.from_json(_json.load(f))
        except (OSError, ValueError, KeyError):
            continue  # unreadable metadata: leave the segment alone
        if _index_mismatch(meta, table_cfg.indexing):
            stale.append(r.name)
        else:
            clean.add(r.name)
    live = set(registry.segments(table))
    registry.task_metadata_set(table, "RefreshSegmentsTask", {
        "config_fp": fp, "clean": sorted(clean & live),
    })
    if not stale:
        return []
    return [registry.submit_task("RefreshSegmentsTask", table,
                                 {"segments": sorted(stale)})]


def generate_tasks(registry, now_ms=None) -> list:
    """Scan every table's task_configs and enqueue what is due."""
    now_ms = now_ms or int(time.time() * 1000)
    registry.prune_terminal_tasks()
    ids = []
    for table in registry.tables():
        table_cfg = registry.table_config(table)
        if table_cfg is None or not table_cfg.task_configs:
            continue
        registry.prune_lineage(table)
        for task_type, cfg in table_cfg.task_configs.items():
            if task_type == "MergeRollupTask":
                ids += generate_merge_rollup_tasks(registry, table, cfg)
            elif task_type == "RealtimeToOfflineSegmentsTask":
                ids += generate_realtime_to_offline_tasks(
                    registry, table, cfg, now_ms
                )
            elif task_type == "PurgeTask":
                ids += generate_purge_tasks(registry, table, cfg)
            elif task_type == "RefreshSegmentsTask":
                ids += generate_refresh_tasks(registry, table, cfg)
            else:
                log.warning("unknown task type %s on table %s", task_type, table)
    return ids
