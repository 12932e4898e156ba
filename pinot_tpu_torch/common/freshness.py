"""Per-table data-freshness epochs — the broker result cache's staleness
contract (a copy of pinot_tpu/common/freshness.py for the port; the
broker caches that read it come with the cluster tier).

A process-local monotonic counter per LOGICAL table (type suffix
stripped): every mutation that can change a query's answer without
changing the segment SET bumps it — columnar batch/row publishes into a
consuming segment, chunklet promotion, upsert invalidations, and seal
(the same seams ``invalidate_cached_partials`` rides). Segment
adds/removes are covered separately by the registry's routing
generation, so (routing generation, epoch view) together bound every
way a cached broker result can go stale.

Servers report their epoch in every DataTable partial
(``ExecutionStats.table_epoch``) and in the sync-loop heartbeat
(``InstanceInfo.table_epochs``); the broker folds both into a per-table
{instance: epoch} view and refuses to serve any cached entry whose
recorded view differs (broker/result_cache.py).

Deliberately dependency-free: ingest worker processes bump epochs
without importing torch or the engine.

Epochs are offset by the process start time in nanoseconds, so a
restarted server can never report a value a broker has already seen
from the previous incarnation (its counter restarts, but its base is
later than any epoch the old process could have reached — one bump per
nanosecond of uptime is unattainable). A stale-by-restart cached entry
therefore invalidates on the restarted process's first mutation instead
of ratcheting forever behind the old, higher count.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_epochs: dict = {}
_BASE = time.time_ns()


def base_table(table) -> str:
    """Physical registry key → logical table name (``sales_OFFLINE`` and
    ``sales_REALTIME`` share one epoch, like they share one quota)."""
    name = str(table or "")
    for suffix in ("_OFFLINE", "_REALTIME"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def bump(table) -> int:
    """Data under ``table`` changed in place; returns the new epoch."""
    key = base_table(table)
    with _lock:
        _epochs[key] = _epochs.get(key, _BASE) + 1
        return _epochs[key]


def epoch(table) -> int:
    """Current epoch (0 = never mutated in this process)."""
    with _lock:
        return _epochs.get(base_table(table), 0)


def snapshot() -> dict:
    """{logical table: epoch} — the heartbeat payload."""
    with _lock:
        return dict(_epochs)


def reset() -> None:
    """Test hook: forget every epoch (fresh-process semantics)."""
    with _lock:
        _epochs.clear()
