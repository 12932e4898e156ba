"""Per-segment access-temperature telemetry.

A tiered lifecycle (object-store/cold → host-mmap/warm → device/hot;
server/tiering.py) needs a per-segment
temperature signal to drive promotion and demotion.  This module is the
server-side half: exponentially-decayed per-segment access counters
(accesses/s and approximate bytes-scanned/s at a configurable half
life) plus lifetime totals, updated on every query that touches the
segment (sealed AND consuming — a chunklet-backed consuming segment
counts under its segment name, which is the granularity the lifecycle
moves).  The snapshot piggybacks in the registry heartbeat exactly like
the scheduler pressure, the controller aggregates it across
instances behind ``GET /tables/{t}/heat``
(controller/http_api.py).

The decayed-rate math is the standard lazy-decay counter: on each
touch, the stored rate first decays by ``0.5 ** (dt / half_life)`` and
then absorbs the new observation.  Reads decay the same way without
mutating, so an idle segment's reported temperature falls toward zero
between queries — the demotion signal — while the lifetime totals keep
the audit trail.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class SegmentHeatTracker:
    """Decayed per-(table, segment) access/frequency/bytes counters."""

    def __init__(self, half_life_s: float = 300.0,
                 max_entries: int = 8192):
        self.half_life_s = max(1.0, float(half_life_s))
        self.max_entries = max(16, int(max_entries))
        self._lock = threading.Lock()
        # (table, segment) -> [rate, bytes_rate, accesses, bytes, last_ts]
        # insertion order doubles as the LRU for the entry bound
        self._entries: dict = {}

    # ---- recording -------------------------------------------------------
    def _decay(self, value: float, dt_s: float) -> float:
        if dt_s <= 0:
            return value
        return value * 0.5 ** (dt_s / self.half_life_s)

    def note(self, table: str, segment: str, bytes_scanned: int = 0,
             now: Optional[float] = None) -> None:
        """Record one query access of ``segment``. ``bytes_scanned`` is
        the caller's APPROXIMATION of bytes the scan touched (the server
        uses rows x referenced columns x 4 — a admission-cost proxy, not
        an exact I/O meter)."""
        now = time.time() if now is None else now
        key = (table, segment)
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                ent = [0.0, 0.0, 0, 0, now]
            dt = now - ent[4]
            ent[0] = self._decay(ent[0], dt) + 1.0
            ent[1] = self._decay(ent[1], dt) + float(bytes_scanned)
            ent[2] += 1
            ent[3] += int(bytes_scanned)
            ent[4] = now
            self._entries[key] = ent  # LRU touch
            while len(self._entries) > self.max_entries:
                self._entries.pop(next(iter(self._entries)))

    # ---- export ----------------------------------------------------------
    def size(self) -> int:
        with self._lock:
            return len(self._entries)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def iter_all(self, now: Optional[float] = None):
        """Full-iteration export: yields ``(table, segment,
        record)`` for EVERY tracked entry with decay applied as of
        ``now`` — the TierManager's demotion input. ``snapshot``'s
        top-N cap exists for the bounded heartbeat payload; demotion
        decisions need exactly the cold tail it drops (a table with >32
        segments would otherwise never see its coldest ones ranked)."""
        now = time.time() if now is None else now
        with self._lock:
            items = [(t, s, list(e)) for (t, s), e in self._entries.items()]
        for t, s, (rate, brate, acc, byt, last) in items:
            dt = now - last
            yield t, s, {
                "rate": self._decay(rate, dt),
                "bytesRate": self._decay(brate, dt),
                "accesses": acc,
                "bytes": byt,
                "lastAccessTs": last,
            }

    def snapshot(self, top_per_table: Optional[int] = 32,
                 now: Optional[float] = None) -> dict:
        """{table: {segment: {...}}} with decay applied as of ``now``,
        capped at the ``top_per_table`` hottest segments per table (the
        heartbeat payload must stay bounded at million-segment scale —
        cold segments are exactly the ones whose absence means "cold").
        ``top_per_table=None`` disables the cap (the full-export form for
        in-process consumers; heartbeats keep the capped default).

        ``rate`` / ``bytesRate`` are decayed half-life accumulators, NOT
        per-second rates: comparable across segments under one half
        life, which is all the promotion policy ranks on."""
        now = time.time() if now is None else now
        per_table: dict = {}
        for t, s, rec in self.iter_all(now=now):
            rec["rate"] = round(rec["rate"], 4)
            rec["bytesRate"] = round(rec["bytesRate"], 1)
            rec["lastAccessTs"] = round(rec["lastAccessTs"], 3)
            per_table.setdefault(t, {})[s] = rec
        out = {}
        for t, segs in per_table.items():
            ranked = sorted(segs.items(), key=lambda kv: -kv[1]["rate"])
            if top_per_table is not None:
                ranked = ranked[:max(1, top_per_table)]
            out[t] = dict(ranked)
        return out
