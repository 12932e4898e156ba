"""Query schedulers: bounded admission + token-bucket priority.

Equivalent of the reference's ``QueryScheduler`` hierarchy
(pinot-core/.../query/scheduler/QueryScheduler.java:56):

- ``QueryScheduler`` — FCFS with a hard concurrency cap and a bounded wait
  queue (FCFSQueryScheduler + BoundedAccountingExecutor): past both, the
  query is rejected immediately with an in-band error rather than piling
  onto gRPC threads.
- ``TokenBucketScheduler`` — per-group (per-table) token buckets with
  priority pick (tokenbucket/TokenPriorityScheduler.java:1 +
  TableBasedGroupMapper + MultiLevelPriorityQueue): each group accrues
  execution-time budget at a fixed rate; when queries contend for slots,
  the group with the most remaining budget runs first and every query
  charges its wall-time to its group — a heavy tenant drains its bucket
  and yields to light tenants instead of starving them.

Both record per-query resource accounting (scheduler wait + thread CPU
time), surfaced through ExecutionStats into the broker response like the
reference's DataTable V3 ``threadCpuTimeNs`` metadata.

A copy of pinot_tpu/engine/scheduler.py for the port.
"""

from __future__ import annotations

import threading
import time


class SchedulerSaturated(Exception):
    """Queue full: the caller should surface QUERY_SCHEDULING_TIMEOUT."""


# priority class -> weighted-fair slot weight: one contract
# end to end — the broker's admission controller scales tenant bucket
# refill by these, ships the class in every instance request, and the
# server's TokenBucketScheduler uses the same weight as the group's fair
# slot share. interactive > dashboard > adhoc.
PRIORITY_WEIGHTS = {"interactive": 4.0, "dashboard": 2.0, "adhoc": 1.0}


class QueryScheduler:
    def __init__(self, max_concurrent: int = 8, max_queued: int = 32,
                 queue_timeout_s: float = 5.0):
        # queue_timeout_s must stay below the broker's query timeout (10s
        # default): a slot granted after the broker abandoned the request
        # would burn a worker doing work nobody reads.
        self.max_concurrent = max_concurrent
        self.max_queued = max_queued
        self.queue_timeout_s = queue_timeout_s
        self._sem = threading.Semaphore(max_concurrent)
        self._lock = threading.Lock()
        self._waiting = 0
        self._running = 0
        self.num_rejected = 0
        self.num_executed = 0

    def pressure(self) -> int:
        """Admitted + queued query count — the device launch coalescer's
        gate (engine/inflight.py): a micro-batch window only opens when
        concurrent demand makes a cohort partner likely."""
        with self._lock:
            return self._running + self._waiting

    def run(self, fn, queue_timeout_s=None, group: str = "default",
            stats_out=None, weight: float = 1.0):
        """Execute ``fn`` under the concurrency cap; raises
        SchedulerSaturated when the wait queue is full or the slot wait
        times out. ``queue_timeout_s`` lets a per-query deadline (SET
        timeoutMs) shrink the admission wait: a query whose budget elapsed
        queueing must not start and burn a worker nobody reads. ``group``
        and ``weight`` are ignored (FCFS); ``stats_out`` (dict) receives
        per-query accounting: scheduler_wait_ms + thread_cpu_time_ns."""
        wait_s = self.queue_timeout_s if queue_timeout_s is None \
            else min(self.queue_timeout_s, queue_timeout_s)
        t_enq = time.perf_counter()
        with self._lock:
            if self._waiting >= self.max_queued:
                self.num_rejected += 1
                raise SchedulerSaturated(
                    f"query queue full ({self._waiting} waiting, "
                    f"{self.max_concurrent} running)"
                )
            self._waiting += 1
        try:
            if not self._sem.acquire(timeout=wait_s):
                with self._lock:
                    self.num_rejected += 1
                raise SchedulerSaturated(
                    f"no execution slot within {wait_s}s"
                )
        finally:
            with self._lock:
                self._waiting -= 1
        try:
            with self._lock:
                self.num_executed += 1
                self._running += 1
            # wait is over — publish it BEFORE fn so fn can fold it into
            # the stats it serializes (fn measures its own thread CPU: a
            # post-fn write here could never reach an already-encoded
            # response)
            if stats_out is not None:
                stats_out["scheduler_wait_ms"] = \
                    (time.perf_counter() - t_enq) * 1e3
            return fn()
        finally:
            with self._lock:
                self._running -= 1
            self._sem.release()


class SchedulerGroup:
    """One tenant's bucket (SchedulerGroup + TokenSchedulerGroup analog).

    ``weight`` (priority classes): the group's weighted-fair
    slot share — a weight-4 (interactive) tenant is entitled to 4x the
    running slots of a weight-1 (adhoc) one before yielding. Updated to
    the latest value each admission (the broker ships the query's
    priority-class weight per request)."""

    def __init__(self, name: str, rate_ms_per_s: float, burst_ms: float):
        self.name = name
        self.rate = rate_ms_per_s
        self.burst = burst_ms
        self.tokens = burst_ms  # start full: cold tenants get full burst
        self.last_refill = time.perf_counter()
        self.weight = 1.0
        self.num_executed = 0
        self.num_rejected = 0
        self.cpu_ms_total = 0.0
        self.wall_ms_total = 0.0

    def refill(self, now: float) -> None:
        dt = now - self.last_refill
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + self.rate * dt)
            self.last_refill = now

    def charge(self, wall_ms: float) -> None:
        # tokens may go negative (the reference lets a long query overdraw;
        # the group then sits out until refill catches up)
        self.tokens -= wall_ms


class TokenBucketScheduler:
    """Priority admission by per-group execution-time budget.

    tokenbucket/TokenPriorityScheduler.java:1 re-shaped for this engine:
    instead of reserving JVM threads per group, each group owns a bucket of
    execution milliseconds refilled at ``rate_ms_per_s``; a slot goes to
    the waiting query whose group holds the most tokens (FIFO within a
    group). Groups are created on first use (TableBasedGroupMapper: group
    == table name)."""

    def __init__(self, max_concurrent: int = 8, max_queued: int = 32,
                 queue_timeout_s: float = 5.0,
                 rate_ms_per_s: float = 2_000.0, burst_ms: float = 4_000.0,
                 per_group_hard_limit: int = None):
        self.max_concurrent = max_concurrent
        self.max_queued = max_queued
        self.queue_timeout_s = queue_timeout_s
        self.rate_ms_per_s = rate_ms_per_s
        self.burst_ms = burst_ms
        # UNCONDITIONAL per-group slot cap (ResourceManager hard limit /
        # BoundedAccountingExecutor): priority alone can't protect a light
        # tenant arriving while a heavy one occupies every slot — without
        # preemption, the only guarantee is never letting one group hold
        # them all
        self.per_group_hard_limit = per_group_hard_limit if \
            per_group_hard_limit is not None else \
            max(1, int(max_concurrent * 0.75))
        self._cond = threading.Condition()
        self._groups: dict[str, SchedulerGroup] = {}
        self._waiters: list = []  # [(seq, group_name)] in arrival order
        self._running_by_group: dict[str, int] = {}
        self._seq = 0
        self._running = 0
        self.num_rejected = 0
        self.num_executed = 0

    MAX_GROUPS = 1024  # arbitrary-SQL servers must not grow state unboundedly

    def pressure(self) -> int:
        """Admitted + queued query count (see QueryScheduler.pressure)."""
        with self._cond:
            return self._running + len(self._waiters)

    def _group(self, name: str) -> SchedulerGroup:
        g = self._groups.get(name)
        if g is None:
            if len(self._groups) >= self.MAX_GROUPS:
                # overflow tenants share one bucket rather than minting
                # fresh full-burst groups forever
                return self._groups.setdefault(
                    "__overflow__", SchedulerGroup(
                        "__overflow__", self.rate_ms_per_s, self.burst_ms))
            g = self._groups[name] = SchedulerGroup(
                name, self.rate_ms_per_s, self.burst_ms)
        return g

    def _my_turn(self, seq: int, name: str) -> bool:
        """Weighted-fair slot pick: among waiters, the group
        holding the smallest share of running slots RELATIVE TO ITS
        WEIGHT goes first (running/weight — a weight-4 interactive tenant
        may hold 4x the slots of a weight-1 adhoc one before yielding);
        ties break by most remaining tokens, then FIFO inside a group.
        Waiters whose group is at its hard slot cap are not candidates;
        waiters whose group is overdrawn sit out until refill unless EVERY
        remaining group is overdrawn — then the weighted-fair order still
        applies so slots the hardware could use never idle."""
        if self._running >= self.max_concurrent:
            return False
        now = time.perf_counter()
        for g in self._groups.values():
            g.refill(now)
        under_cap = [
            (s, n) for s, n in self._waiters
            if self._running_by_group.get(n, 0) < self.per_group_hard_limit
        ]
        if not under_cap:
            return False
        candidates = [(s, n) for s, n in under_cap
                      if self._groups[n].tokens > 0]
        if not candidates:
            candidates = under_cap

        def share(n: str) -> float:
            g = self._groups[n]
            return self._running_by_group.get(n, 0) / max(g.weight, 1e-9)

        best = min(candidates,
                   key=lambda e: (share(e[1]),
                                  -self._groups[e[1]].tokens, e[0]))
        return best == (seq, name)

    def run(self, fn, queue_timeout_s=None, group: str = "default",
            stats_out=None, weight: float = 1.0):
        wait_s = self.queue_timeout_s if queue_timeout_s is None \
            else min(self.queue_timeout_s, queue_timeout_s)
        deadline = time.perf_counter() + wait_s
        with self._cond:
            # resolve to the EFFECTIVE group once (overflow sharing) so all
            # later lookups agree; the query's priority-class weight
            # becomes the group's weighted-fair share (latest wins)
            g0 = self._group(group)
            group = g0.name
            g0.weight = max(float(weight), 1e-9)
            if len(self._waiters) >= self.max_queued:
                self.num_rejected += 1
                self._groups[group].num_rejected += 1
                raise SchedulerSaturated(
                    f"query queue full ({len(self._waiters)} waiting, "
                    f"{self._running} running)")
            seq = self._seq
            self._seq += 1
            me = (seq, group)
            self._waiters.append(me)
            try:
                while not self._my_turn(seq, group):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        self.num_rejected += 1
                        self._groups[group].num_rejected += 1
                        raise SchedulerSaturated(
                            f"no execution slot within {wait_s}s "
                            f"(group {group!r} tokens "
                            f"{self._groups[group].tokens:.0f}ms)")
                    # bounded wait: token refill is time-driven, so waiters
                    # must wake periodically even without a notify
                    self._cond.wait(min(left, 0.02))
            finally:
                self._waiters.remove(me)
            self._running += 1
            self._running_by_group[group] = \
                self._running_by_group.get(group, 0) + 1
            self.num_executed += 1
            self._groups[group].num_executed += 1
            # other waiters may now also be eligible (free slots remain);
            # without this they idle until their 20ms poll expires
            self._cond.notify_all()
        if stats_out is not None:
            stats_out["scheduler_wait_ms"] = \
                (time.perf_counter() - (deadline - wait_s)) * 1e3
        t0 = time.perf_counter()
        t_cpu = time.thread_time_ns()
        try:
            return fn()
        finally:
            wall_ms = (time.perf_counter() - t0) * 1e3
            cpu_ns = time.thread_time_ns() - t_cpu
            if stats_out is not None:
                stats_out["thread_cpu_time_ns"] = cpu_ns
            with self._cond:
                g = self._groups[group]
                g.charge(wall_ms)
                g.cpu_ms_total += cpu_ns / 1e6
                g.wall_ms_total += wall_ms
                self._running -= 1
                self._running_by_group[group] -= 1
                self._cond.notify_all()

    def group_stats(self) -> dict:
        """Per-tenant accounting snapshot (the reference's per-group
        metrics on SchedulerGroup)."""
        with self._cond:
            now = time.perf_counter()
            out = {}
            for name, g in self._groups.items():
                g.refill(now)
                out[name] = {
                    "tokens_ms": round(g.tokens, 1),
                    "weight": g.weight,
                    "executed": g.num_executed,
                    "rejected": g.num_rejected,
                    "cpu_ms_total": round(g.cpu_ms_total, 1),
                    "wall_ms_total": round(g.wall_ms_total, 1),
                }
            return out


def make_scheduler(name: str, max_concurrent: int, max_queued: int,
                   **kwargs):
    """Config-selected scheduler (pinot.server.query.scheduler.name)."""
    if name in ("fcfs", "", None):
        return QueryScheduler(max_concurrent=max_concurrent,
                              max_queued=max_queued)
    if name == "tokenbucket":
        return TokenBucketScheduler(max_concurrent=max_concurrent,
                                    max_queued=max_queued, **kwargs)
    raise ValueError(f"unknown scheduler {name!r} (fcfs|tokenbucket)")
