"""Structured broker query log: rotating JSONL + in-memory ring buffer.

The third leg of the query-path flight recorder: every query
the broker decides is WORTH KEEPING — slow past a threshold, errored,
timed out, partial, or sampled — is appended as one JSON line carrying
the merged trace (broker + per-instance server spans), the
retry/hedge/pruning counters, and a literal-independent template key, so
an operator can answer "where did THAT query's 120 ms go" days later.
The reference ships this as the broker's query log
(BaseBrokerRequestHandler's ``QueryLogger`` with its ``maxRatePerSecond``
/ dropped-count semantics); ours trades the rate limiter for a
threshold + sample-rate pair plus always-on capture of anything
abnormal.

Config (common/config.py Configuration keys):

- ``pinot.broker.querylog.path``            — JSONL file; unset = ring only
- ``pinot.broker.querylog.slow.threshold.ms`` (default 500.0)
- ``pinot.broker.querylog.sample.rate``     — 0..1 of HEALTHY fast queries
  to keep anyway (default 0.0)
- ``pinot.broker.querylog.max.bytes``       — rotation size (default 16 MB;
  one rotated generation, ``<path>.1``)
- ``pinot.broker.querylog.ring.size``       — /debug/queries depth (128)

The ring buffer backs the broker's ``GET /debug/queries`` endpoint — the
last N kept entries, newest first, no file required.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Optional


def template_key(q) -> str:
    """Literal-independent shape key for a compiled QueryContext — the
    same normalization that keeps device template/cohort keys stable
    under changing filter literals: table + result shape + agg
    names + group-by columns + filter STRUCTURE (ops and columns, no
    values). Two dashboard queries differing only in literals share a
    key, so the summarizer can aggregate latency per template.

    Multi-stage plans (query2/ joins + windows) key on the stage-2 shape
    PLUS the join chain (kind, strategy, build alias, key columns — no
    literals) and the window function/partition signature, so two-stage
    dashboard queries group per template exactly like single-stage ones."""
    try:
        if hasattr(q, "stage2") and hasattr(q, "joins"):
            inner = template_key(q.stage2)
            joins = ";".join(
                f"{j.kind}:{q.strategy}:{j.build.alias}"
                f"({','.join(str(k) for k in j.left_keys)})"
                for j in q.joins)
            wins = ",".join(
                f"{w.fn}[{','.join(str(p) for p in w.partition_by)}]"
                for w in q.windows)
            parts = [inner]
            if joins:
                parts.append(f"joins[{joins}]")
            if wins:
                parts.append(f"windows[{wins}]")
            return "|".join(parts)
        aggs = ",".join(a.name for a in q.aggregations())
        group = ",".join(g.name if g.is_identifier else "expr"
                         for g in (q.group_by or ()))
        shape = ("distinct" if q.distinct
                 else "group_by" if q.group_by
                 else "aggregation" if q.aggregations()
                 else "selection")

        def _filter_sig(f) -> str:
            if f is None:
                return ""
            from pinot_tpu_torch.query.context import FilterNodeType

            if f.type is FilterNodeType.PREDICATE:
                p = f.predicate
                col = p.lhs.name if p.lhs.is_identifier else "expr"
                return f"{p.type.name}({col})"
            kids = ",".join(_filter_sig(c) for c in (f.children or ()))
            return f"{f.type.name}[{kids}]"

        return f"{q.table_name}|{shape}|{aggs}|{group}|{_filter_sig(q.filter)}"
    except Exception:  # noqa: BLE001 — a log key must never fail a query
        return "unknown"


class QueryLogger:
    def __init__(self, path: Optional[str] = None,
                 slow_threshold_ms: float = 500.0,
                 sample_rate: float = 0.0,
                 max_bytes: int = 16 << 20,
                 ring_size: int = 128,
                 broker_id: Optional[str] = None):
        self.path = path
        # fleet attribution: when set, every kept entry stamps
        # which broker wrote it, so tools/querylog.py can merge JSONL
        # files from N brokers and still break stats down per broker
        self.broker_id = broker_id
        self.slow_threshold_ms = float(slow_threshold_ms)
        self.sample_rate = float(sample_rate)
        self.max_bytes = int(max_bytes)
        self.ring = collections.deque(maxlen=max(1, int(ring_size)))
        self._lock = threading.Lock()
        self.dropped = 0  # entries that failed to write (disk trouble)

    @classmethod
    def from_config(cls, conf=None) -> "QueryLogger":
        if conf is None:
            from pinot_tpu_torch.common.config import Configuration

            conf = Configuration()
        return cls(
            path=conf.get("pinot.broker.querylog.path", None),
            slow_threshold_ms=conf.get_float(
                "pinot.broker.querylog.slow.threshold.ms", 500.0),
            sample_rate=conf.get_float(
                "pinot.broker.querylog.sample.rate", 0.0),
            max_bytes=int(conf.get_float(
                "pinot.broker.querylog.max.bytes", float(16 << 20))),
            ring_size=int(conf.get_float(
                "pinot.broker.querylog.ring.size", 128)),
        )

    # ---- capture policy --------------------------------------------------
    def should_log(self, time_used_ms: float, abnormal: bool) -> bool:
        """Timeouts/errors/partials ALWAYS log; healthy queries log past
        the slow threshold or with sample_rate probability."""
        if abnormal:
            return True
        if time_used_ms >= self.slow_threshold_ms:
            return True
        return self.sample_rate > 0 and random.random() < self.sample_rate

    def record(self, sql: str, resp: dict, time_used_ms: float,
               table: Optional[str] = None,
               template=None,
               extra: Optional[dict] = None) -> Optional[dict]:
        """Build + (maybe) keep one entry from a finished broker response.
        Returns the entry when it was kept, None when policy dropped it.
        ``template`` may be a zero-arg callable — resolved only AFTER the
        keep decision, so the default-policy hot path (healthy fast
        queries, dropped) never pays the template-key tree walk."""
        excs = resp.get("exceptions") or []
        # shed/degraded responses are always-log abnormal:
        # the typed sheddingReason contract includes the query log
        abnormal = bool(excs) or bool(resp.get("partialResult")) \
            or bool(resp.get("sheddingReason"))
        if not self.should_log(time_used_ms, abnormal):
            return None
        if callable(template):
            template = template()
        entry = {
            "ts": round(time.time(), 3),
            "brokerId": self.broker_id or resp.get("brokerId"),
            "requestId": resp.get("requestId"),
            "traceId": resp.get("traceId"),
            "table": table,
            "template": template,
            "sql": sql if len(sql) <= 2000 else sql[:2000] + "...",
            "timeUsedMs": round(float(time_used_ms), 3),
            "partialResult": bool(resp.get("partialResult")),
            "exceptions": excs,
            "counters": {
                k: resp.get(k) for k in (
                    "numServersQueried", "numServersResponded",
                    "numRetries", "numHedges",
                    "numSegmentsPrunedByBroker",
                    "numSegmentsPrunedByServer", "numBlocksPruned",
                    "numDocsScanned", "numGroupsLimitReached",
                    "partialsCacheHit",
                    # cluster-tier attribution: which replica
                    # group took the query at what load score, and whether
                    # the broker result cache answered without a scatter
                    "numReplicaGroupsQueried", "replicaGroup",
                    "loadScore", "resultCacheHit",
                    # multi-tenant admission: who asked, at
                    # what priority, and whether the overload loop shed
                    # or degraded the query (typed, never silent)
                    "tenant", "priorityClass", "sheddingReason",
                    "servedStale", "staleAgeMs",
                    # kernel roofline accounting: HBM bytes
                    # the device pipelines moved vs their kernel wall
                    "deviceBytesMoved", "deviceKernelMs", "deviceLinkMs",
                    # distributed stage-2 exchange: effective
                    # strategy (demotion included — the plan is mutated
                    # before logging), partition fan-out, wire volume,
                    # warm-tier spills
                    "joinStrategy", "joinStrategyDemoted", "joinFanout",
                    "numPartitionsShipped", "exchangeBytes",
                    "exchangeSpillCount",
                    # plan advisor: the measurement-driven
                    # overrides this execution ran with — the raw
                    # ADVISOR(...) stamps, aggregated per template by
                    # tools/querylog.py --per-template
                    "advisorDecisions",
                ) if resp.get(k) is not None
            },
        }
        roofline = resp.get("roofline")
        if roofline:
            # per-flight achieved-GB/s records, capped so one scattered
            # query over many servers can't bloat a log line
            entry["roofline"] = list(roofline)[:8]
        trace_info = resp.get("traceInfo")
        if trace_info:
            entry["traceInfo"] = trace_info
        if extra:
            entry.update(extra)
        with self._lock:
            self.ring.appendleft(entry)
        self._write(entry)
        return entry

    # ---- file backend ----------------------------------------------------
    def _write(self, entry: dict) -> None:
        if not self.path:
            return
        line = json.dumps(entry, default=str) + "\n"
        try:
            with self._lock:
                try:
                    if os.path.getsize(self.path) + len(line) > self.max_bytes:
                        # one rotated generation, replace-style (atomic on
                        # POSIX): bounded disk, never a mid-query stall
                        os.replace(self.path, self.path + ".1")
                except OSError:
                    pass  # no file yet
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
        except OSError:
            self.dropped += 1

    def recent(self, limit: int = 0) -> list:
        """Newest-first kept entries from the ring (the /debug/queries
        payload)."""
        with self._lock:
            out = list(self.ring)
        return out[:limit] if limit else out
