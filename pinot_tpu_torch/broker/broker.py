"""Broker role: SQL endpoint → route → scatter/gather → reduce.

Equivalent of the reference's broker stack (pinot-broker/:
BaseBrokerRequestHandler.java:169,194-400 parse→rewrite→route→scatter→reduce,
BrokerRoutingManager + instance selectors, failuredetector/ with exponential
backoff, SingleConnectionBrokerRequestHandler netty scatter-gather). The
scatter rides gRPC channels (transport/grpc_transport.py); the reduce is the
same value-space merge used in-process (engine/reduce.py), since servers ship
canonical DataTable partials.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from concurrent import futures
from typing import Optional

from pinot_tpu_torch.broker.segment_pruner import prune_segments
from pinot_tpu_torch.cluster.registry import (
    HB_STALE_S,
    ClusterRegistry,
    Role,
    SegmentState,
)
from pinot_tpu_torch.common import faults
from pinot_tpu_torch.common.deadline import Deadline
from pinot_tpu_torch.common.options import bool_option
from pinot_tpu_torch.engine.datatable import decode
from pinot_tpu_torch.engine.reduce import finalize, merge_intermediates
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.transport.grpc_transport import QueryRouterChannel, make_instance_request

log = logging.getLogger("pinot_tpu_torch.broker")


class QueryQuotaManager:
    """Per-table QPS token bucket
    (queryquota/HelixExternalViewBasedQueryQuotaManager analog). Rates come
    from TableConfig.quota.max_queries_per_second; the bucket holds up to
    one second of burst. Enforced per broker — the reference divides the
    table quota by the live-broker count, which a deployment can mirror by
    setting the per-table rate accordingly."""

    def __init__(self, registry):
        self.registry = registry
        self._buckets: dict = {}  # raw table -> [tokens, last_ts, rate]
        self._lock = threading.Lock()
        # rate lookups memoized per registry routing generation: config
        # changes ride the tables section (which bumps the generation), so
        # the memo is exact — and the steady-state query path stops paying
        # three registry reads per query (its hit-latency budget)
        self._rates: dict = {}
        self._rates_gen = None

    @staticmethod
    def _base_name(table: str) -> str:
        # one bucket per logical table: 'tbl', 'tbl_OFFLINE' and
        # 'tbl_REALTIME' must draw from the SAME quota — the same fold
        # the freshness epochs use (single-sourced there; freshness is
        # the dependency-free module, so the broker delegates to it)
        from pinot_tpu_torch.common import freshness

        return freshness.base_table(table)

    def _rate(self, base: str, gen=None) -> Optional[float]:
        if gen is None:
            gen = self.registry.routing_generation()
        with self._lock:
            if self._rates_gen == gen and base in self._rates:
                return self._rates[base]
        rate = None
        for key in (base, f"{base}_OFFLINE", f"{base}_REALTIME"):
            cfg = self.registry.table_config(key)
            if cfg is not None and \
                    cfg.quota.max_queries_per_second is not None:
                rate = float(cfg.quota.max_queries_per_second)
                break
        with self._lock:
            if self._rates_gen != gen:
                self._rates = {}
                self._rates_gen = gen
            self._rates[base] = rate
        return rate

    def acquire(self, table: str, gen=None) -> bool:
        """True = admit; False = over quota (HTTP 429-shaped rejection).
        ``gen``: the caller's already-read routing generation (the broker
        reads it ONCE per query and shares it across every memo)."""
        base = self._base_name(table)
        rate = self._rate(base, gen)
        if rate is None:
            return True
        now = time.time()
        with self._lock:
            tokens, last, _ = self._buckets.get(base, (rate, now, rate))
            tokens = min(rate, tokens + (now - last) * rate)
            if tokens < 1.0:
                self._buckets[base] = [tokens, now, rate]
                return False
            self._buckets[base] = [tokens - 1.0, now, rate]
            return True


class FailureDetector:
    """Connection-level failure detector: exponential backoff + half-open
    circuit-breaker probing
    (pinot-broker/.../failuredetector/BaseExponentialBackoffRetryFailureDetector).

    State machine per instance:

        HEALTHY --mark_failure--> OPEN (backoff window, no traffic)
        OPEN --window elapses--> HALF_OPEN (ONE probe query admitted)
        HALF_OPEN --probe mark_success--> HEALTHY (backoff forgotten)
        HALF_OPEN --probe mark_failure--> OPEN (backoff doubled)

    The probe IS a live query the router deliberately sends (try_probe
    consumes the slot only when the instance is actually picked); while a
    probe is outstanding, other queries keep routing to healthy replicas
    so a still-down server costs at most one query per backoff window."""

    ST_HEALTHY, ST_OPEN, ST_HALF_OPEN = "healthy", "open", "half_open"
    PROBE_TTL_S = 10.0  # a probe that never resolves frees the slot

    def __init__(self, initial_backoff_s: float = 1.0, max_backoff_s: float = 30.0):
        # id -> [retry_at, backoff, probe_started_or_None]
        self._unhealthy: dict[str, list] = {}
        self._initial = initial_backoff_s
        self._max = max_backoff_s
        self._lock = threading.Lock()

    def mark_failure(self, instance_id: str) -> None:
        with self._lock:
            entry = self._unhealthy.get(instance_id)
            backoff = self._initial / 2 if entry is None else entry[1]
            backoff = min(backoff * 2, self._max)
            self._unhealthy[instance_id] = [time.time() + backoff, backoff, None]

    def mark_success(self, instance_id: str) -> None:
        with self._lock:
            self._unhealthy.pop(instance_id, None)

    def state(self, instance_id: str) -> str:
        with self._lock:
            entry = self._unhealthy.get(instance_id)
            if entry is None:
                return self.ST_HEALTHY
            return self.ST_HALF_OPEN if time.time() >= entry[0] \
                else self.ST_OPEN

    def is_healthy(self, instance_id: str) -> bool:
        """Routable at all: healthy, or half-open (the backoff window
        elapsed — the routed query becomes the recovery probe)."""
        return self.state(instance_id) != self.ST_OPEN

    def try_probe(self, instance_id: str) -> bool:
        """Claim the half-open instance's single probe slot. True → the
        caller's query is the probe (its mark_success/mark_failure
        resolves the state); False → a probe is already in flight (or
        the window hasn't opened) and the caller should route elsewhere."""
        with self._lock:
            entry = self._unhealthy.get(instance_id)
            if entry is None:
                return True  # healthy: not a probe at all
            now = time.time()
            if now < entry[0]:
                return False  # still OPEN
            if entry[2] is not None and now - entry[2] < self.PROBE_TTL_S:
                return False  # probe outstanding
            entry[2] = now
            return True

    def release_probe(self, instance_id: str) -> None:
        """The probe query never actually ran (cancelled before start —
        e.g. its entry settled via a hedge): free the slot so the next
        query can probe instead of waiting out PROBE_TTL_S."""
        with self._lock:
            entry = self._unhealthy.get(instance_id)
            if entry is not None:
                entry[2] = None


class LatencyTracker:
    """Per-server latency view → the hedging trigger delay
    (AdaptiveServerSelector's latency EWMA role). This
    rides the SHARED metrics histogram machinery
    (``broker.serverLatencyMs.<instance>`` — common/metrics.py
    Histogram): every sample feeds the registry histogram (the
    /metrics p50/p90/p99 exposition and the query log read that one
    lifetime distribution), and the hedge trigger reads the SAME
    log-bucketed histogram over a two-generation rotating window —
    recency matters for hedging: a lifetime distribution with 100k fast
    samples would hold the trigger at the old p90 for tens of thousands
    of queries after a server degrades, hedging every request mid-
    incident. A server with no history hedges after the default —
    better to hedge a touch early than never."""

    METRIC = "serverLatencyMs"
    WINDOW_S = 30.0        # rotate generations at least this often...
    WINDOW_SAMPLES = 512   # ...or after this many samples, whichever first

    def __init__(self, default_s: float = 0.05, registry=None):
        self.default_s = default_s
        if registry is None:
            from pinot_tpu_torch.common.metrics import get_metrics

            registry = get_metrics("broker")
        self.metrics = registry
        # instance -> [current Histogram, previous Histogram, rotated_at]
        self._windows: dict = {}
        self._lock = threading.Lock()

    def record(self, instance_id: str, seconds: float) -> None:
        from pinot_tpu_torch.common.metrics import Histogram

        ms = seconds * 1e3
        self.metrics.time_ms(self.METRIC, ms, tag=instance_id)
        now = time.monotonic()
        with self._lock:
            w = self._windows.get(instance_id)
            if w is None:
                w = self._windows[instance_id] = [Histogram(), None, now]
            cur = w[0]
            if (cur.count >= self.WINDOW_SAMPLES
                    or now - w[2] >= self.WINDOW_S):
                w[1], w[0], w[2] = cur, Histogram(), now
                cur = w[0]
            cur.update(ms)

    def p90_s(self, instance_id: str) -> float:
        from pinot_tpu_torch.common.metrics import Histogram

        with self._lock:
            w = self._windows.get(instance_id)
            if w is None:
                p90_ms = None
            else:
                # merge current + previous generations (shared global
                # bucket bounds make the merge a count add) so a fresh
                # rotation never empties the view
                merged = Histogram()
                for h in (w[0], w[1]):
                    if h is None:
                        continue
                    for i, c in enumerate(h.counts):
                        merged.counts[i] += c
                    merged.count += h.count
                    merged.min_ms = min(merged.min_ms, h.min_ms)
                    merged.max_ms = max(merged.max_ms, h.max_ms)
                p90_ms = merged.quantile(0.9) if merged.count else None
        if p90_ms is None:
            # no windowed samples yet (e.g. restarted tracker): fall back
            # to the lifetime histogram, then the default
            p90_ms = self.metrics.quantile(self.METRIC, 0.9,
                                           tag=instance_id)
        return self.default_s if p90_ms is None else p90_ms / 1e3


class LoadTracker:
    """Decayed per-instance load view feeding the replica-group pick
    (AdaptiveServerSelector's NumInFlightReqSelector + server-latency
    roles). Three signals fold into one score:

    - the server's scheduler ``pressure()`` + in-flight depth, piggybacked
      in every DataTable partial (freshest; observed at gather time);
    - the same pressure from the sync-loop heartbeat
      (``InstanceInfo.pressure``) when no queries are flowing;
    - this broker's own outstanding RPC count per instance (instant —
      covers the window before any response could report back).

    Reported observations EWMA-decay toward idle over ``DECAY_S`` so one
    busy moment doesn't blacklist a server; past ``STALE_S`` the score is
    None and the router falls back to rolling-p90 latency."""

    DECAY_S = 10.0
    STALE_S = 30.0
    # heartbeat-staleness cut (single-sourced in
    # cluster/registry.py): an instance that missed 3 heartbeat
    # intervals is presumed crashed/wedged — its last pressure sample
    # must DECAY OUT of scoring entirely, not sit there exponentially
    # decaying toward 0 and making a dead server look like the
    # cluster's idlest pick
    HB_STALE_S = HB_STALE_S

    def __init__(self):
        self._lock = threading.Lock()
        self._obs: dict = {}          # inst -> [ewma score, monotonic ts]
        self._outstanding: dict = {}  # inst -> this broker's in-flight RPCs

    def observe(self, instance_id: str, pressure, inflight=0,
                ts: float = None) -> None:
        import math

        load = max(float(pressure or 0), float(inflight or 0))
        now = time.monotonic() if ts is None else ts
        with self._lock:
            cur = self._obs.get(instance_id)
            if cur is None:
                self._obs[instance_id] = [load, now]
                return
            if cur[1] > now:
                return  # a fresher (piggybacked) observation already landed
            decayed = cur[0] * math.exp(-(now - cur[1]) / self.DECAY_S)
            self._obs[instance_id] = [0.5 * decayed + 0.5 * load, now]

    def expire_if_stale(self, instance_id: str, max_age_s: float) -> None:
        """Drop an instance's observation when the observation ITSELF is
        older than ``max_age_s`` — the heartbeat-stale fix: a crashed
        server stops both heartbeating and piggybacking, so its frozen
        sample would otherwise decay toward 0 and read as 'idle' to the
        least-loaded pick for the full STALE_S window. A fresher
        piggybacked observation (server alive, registry heartbeat merely
        delayed) keeps the entry."""
        now = time.monotonic()
        with self._lock:
            cur = self._obs.get(instance_id)
            if cur is not None and now - cur[1] > max_age_s:
                self._obs.pop(instance_id, None)

    def note_dispatch(self, instance_id: str) -> None:
        with self._lock:
            self._outstanding[instance_id] = \
                self._outstanding.get(instance_id, 0) + 1

    def note_done(self, instance_id: str) -> None:
        with self._lock:
            n = self._outstanding.get(instance_id, 0) - 1
            if n > 0:
                self._outstanding[instance_id] = n
            else:
                self._outstanding.pop(instance_id, None)

    def outstanding(self, instance_id: str) -> int:
        with self._lock:
            return self._outstanding.get(instance_id, 0)

    def score(self, instance_id: str):
        """Decayed reported load + this broker's own outstanding RPCs, or
        None when the last report went stale (router falls back to p90)."""
        import math

        now = time.monotonic()
        with self._lock:
            out = self._outstanding.get(instance_id, 0)
            cur = self._obs.get(instance_id)
            if cur is None or now - cur[1] > self.STALE_S:
                return None
            return cur[0] * math.exp(-(now - cur[1]) / self.DECAY_S) + out


class RoutingManager:
    """table → {instance: [segments]} from the registry's external view
    (BrokerRoutingManager.java:87 + instance selection).

    This routes at REPLICA-GROUP granularity when the
    controller has built a group map: the derived routing structures
    (lineage/offline-filtered replicas + per-group segment coverage) are
    cached per (table, registry routing generation) — rebuilt only when
    the cluster actually changed, not per query — and each query goes to
    ONE group's instances, picked least-loaded (decayed piggybacked
    pressure, falling back to rolling-p90 latency when pressure is
    stale). Tables without a group map keep the per-segment healthy-first
    round-robin."""

    # groups within this much of the best score share round-robin traffic
    # (a strict argmin would starve an equally-idle group on float noise)
    LOAD_TIE_EPS = 0.5

    def __init__(self, registry: ClusterRegistry,
                 failure_detector: FailureDetector, latency=None):
        self.registry = registry
        self.failures = failure_detector
        self.latency = latency  # LatencyTracker: stale-pressure fallback
        self.loads = LoadTracker()
        # optional memoized instances supplier (the Broker wires its 0.25s
        # _server_instances memo here) so the rate-limited heartbeat-load
        # refresh doesn't pay a registry read — file-backed registries
        # make that real I/O on the query path
        self.instances_fn = None
        self._rr = itertools.count()
        self._snap_lock = threading.Lock()
        self._snapshots: dict = {}  # table -> (routing generation, snapshot)
        self._last_hb_refresh = 0.0
        # serializes pick + reservation: without it a burst of concurrent
        # queries all read the same scores before any outstanding count
        # moves and herd onto one group (observed: 2 servers at 55%
        # utilization each, zero scaling)
        self._pick_lock = threading.Lock()

    def routing_table(self, table: str) -> Optional[dict]:
        routing, _, _ = self.routing_with_replicas(table)
        return routing

    # ---- cached derived routing state ------------------------------------
    def _snapshot(self, table: str, gen=None) -> dict:
        """The expensive derived structures, cached per (table, registry
        routing generation) — a steady cluster costs
        one dict lookup per query instead of a registry walk."""
        if gen is None:
            gen = self.registry.routing_generation()
        with self._snap_lock:
            ent = self._snapshots.get(table)
            if ent is not None and ent[0] == gen:
                return ent[1]
        snap = self._build_snapshot(table)
        with self._snap_lock:
            self._snapshots[table] = (gen, snap)
        return snap

    def _build_snapshot(self, table: str) -> dict:
        # route on the EXTERNAL VIEW (what servers actually serve), not the
        # ideal-state assignment — assignment may race ahead of loading.
        # Segment-lineage filter (reference SegmentLineage +
        # SegmentLineageBasedSegmentPreSelector): an IN_PROGRESS replace
        # routes the FROM set (the TO segments are still loading); a
        # COMPLETED one routes the TO set even while the FROM segments
        # linger in the external view awaiting deletion. This is what makes
        # a minion merge swap atomic from the query path's point of view.
        view, records, lineage = self.registry.routing_snapshot(table)
        excluded = set()
        for entry in lineage.values():
            excluded.update(
                entry["from"] if entry["state"] == "COMPLETED" else entry["to"]
            )
        replicas: dict[str, list] = {}
        for segment, instances in view.items():
            if segment in excluded:
                continue
            rec = records.get(segment)
            if rec is not None and rec.state == SegmentState.OFFLINE:
                continue
            replicas[segment] = list(instances)
        # per-group coverage: group -> {segment: [serving members]}; a
        # group missing ANY segment can't take whole queries and is left
        # out (its instances still serve as per-segment retry replicas)
        groups = self.registry.replica_groups(table)
        group_cover: dict = {}
        if replicas:
            for name, members in groups.items():
                mset = set(members)
                cover: Optional[dict] = {}
                for seg, insts in replicas.items():
                    within = [i for i in insts if i in mset]
                    if not within:
                        cover = None
                        break
                    cover[seg] = within
                if cover is not None:
                    group_cover[name] = cover
        return {"replicas": replicas, "groups": groups,
                "group_cover": group_cover}

    def _refresh_heartbeat_loads(self) -> None:
        """Fold sync-loop heartbeat pressure into the load view (rate
        limited — piggybacked response signals dominate under traffic)."""
        now = time.monotonic()
        if now - self._last_hb_refresh < 0.5:
            return
        self._last_hb_refresh = now
        now_ms = time.time() * 1000
        instances = (self.instances_fn() if self.instances_fn is not None
                     else self.registry.instances(Role.SERVER))
        for i in instances:
            age_s = max(0.0, (now_ms - i.last_heartbeat_ms) / 1e3)
            if age_s <= LoadTracker.HB_STALE_S:
                self.loads.observe(i.instance_id,
                                   getattr(i, "pressure", 0.0),
                                   ts=now - age_s)
            else:
                # no heartbeat within 3 intervals: the instance is
                # presumed down — expire its load sample (unless a
                # fresher piggybacked response observation proves it
                # alive) so the least-loaded pick stops seeing a
                # crashed server as permanently idle
                self.loads.expire_if_stale(i.instance_id,
                                           LoadTracker.HB_STALE_S)

    # ---- query-time selection --------------------------------------------
    def release(self, instances) -> None:
        """Release reservations taken by ``routing_with_replicas(...,
        reserve=True)`` — the broker calls this when the query's scatter
        completes (one release per reserved occurrence)."""
        for inst in instances:
            self.loads.note_done(inst)

    def routing_with_replicas(self, table: str, reserve: bool = False,
                              gen=None) -> tuple:
        """(routing {instance: [segments]},
            replicas {segment: [instances]},
            info {numReplicaGroupsQueried, replicaGroup, loadScore, ...}).

        The replicas map is what the scatter path's failure handling
        consumes: on a transport failure (or a hedge trigger) the broker
        re-sends the failed instance's segment list to another serving
        replica instead of immediately declaring ``partialResult``.

        ``reserve=True`` (the broker's scatter path) atomically bumps the
        picked instances' outstanding counts WITH the pick — concurrent
        arrivals see each other's placements instead of herding onto one
        group — and lists them under ``info["reserved"]``; the caller MUST
        ``release()`` them when the query settles."""
        snap = self._snapshot(table, gen)
        replicas = snap["replicas"]
        if not replicas:
            return None, {}, {}
        offset = next(self._rr)
        info: dict = {"numReplicaGroupsQueried": 0}
        if snap["group_cover"]:
            # registry/heartbeat I/O stays OUTSIDE the pick lock — a
            # file-backed refresh while holding it would serialize every
            # concurrent query's group pick behind the read
            self._refresh_heartbeat_loads()
            with self._pick_lock:
                routing, ginfo = self._route_via_group(snap, offset)
                if routing is not None and reserve:
                    reserved = []
                    for inst, segs in routing.items():
                        self.loads.note_dispatch(inst)
                        reserved.append(inst)
                    ginfo["reserved"] = reserved
            if routing is not None:
                info.update(ginfo)
                return routing, replicas, info
        out: dict[str, list] = {}
        for segment, instances in replicas.items():
            # healthy replicas take traffic; a half-open one (backoff
            # window elapsed) joins the pool and, when the round-robin
            # actually picks it, claims the single probe slot — its query
            # is the recovery probe. If the probe slot is taken, fall
            # back to a healthy replica.
            healthy, half_open = [], []
            for i in instances:
                st = self.failures.state(i)
                if st == FailureDetector.ST_HEALTHY:
                    healthy.append(i)
                elif st == FailureDetector.ST_HALF_OPEN:
                    half_open.append(i)
            pool = healthy + half_open
            if not pool:
                pool, half_open = list(instances), []  # all down: try anyway
            pick = pool[offset % len(pool)]
            if pick in half_open and not self.failures.try_probe(pick):
                pick = healthy[offset % len(healthy)] if healthy else pick
            out.setdefault(pick, []).append(segment)
        if reserve and out:
            reserved = []
            for inst in out:
                self.loads.note_dispatch(inst)
                reserved.append(inst)
            info["reserved"] = reserved
        return out, replicas, info

    def _route_via_group(self, snap: dict, offset: int) -> tuple:
        """Pick ONE replica group for the whole query: least-loaded by
        decayed piggybacked pressure across the group's serving members;
        when any candidate's pressure is stale, every group re-scores on
        rolling-p90 latency (one comparable basis). Near-tie groups share
        round-robin traffic. Returns (routing, info) or (None, {}) when
        no group has a routable replica for every segment (caller falls
        back to per-segment selection). Caller holds ``_pick_lock`` and
        has already refreshed heartbeat loads (outside the lock)."""
        cands = []  # (name, cover, members serving + routable)
        for name in sorted(snap["group_cover"]):
            cover = snap["group_cover"][name]
            members: set = set()
            ok = True
            for seg, within in cover.items():
                routable = [i for i in within if self.failures.is_healthy(i)]
                if not routable:
                    ok = False
                    break
                members.update(routable)
            if ok:
                cands.append((name, cover, sorted(members)))
        if not cands:
            return None, {}
        fresh = {name: [self.loads.score(i) for i in members]
                 for name, _c, members in cands}
        all_fresh = all(s is not None
                        for scores in fresh.values() for s in scores)
        scored = []
        for name, cover, members in cands:
            if all_fresh:
                score = max(fresh[name]) if fresh[name] else 0.0
            else:
                # stale pressure somewhere: rolling-p90 latency (ms) for
                # EVERY group so the comparison stays one-basis
                score = max((self.latency.p90_s(i) for i in members),
                            default=0.0) * 1e3 if self.latency is not None \
                    else 0.0
            scored.append((score, name, cover))
        best = min(s for s, _n, _c in scored)
        pool = [e for e in scored if e[0] <= best + self.LOAD_TIE_EPS]
        score, gname, cover = pool[offset % len(pool)]
        routing: dict = {}
        for seg, within in cover.items():
            routable = [i for i in within if self.failures.is_healthy(i)]
            healthy = [i for i in routable
                       if self.failures.state(i) == FailureDetector.ST_HEALTHY]
            ipool = healthy + [i for i in routable if i not in healthy]
            pick = ipool[offset % len(ipool)]
            if pick not in healthy and not self.failures.try_probe(pick):
                pick = healthy[offset % len(healthy)] if healthy else pick
            routing.setdefault(pick, []).append(seg)
        return routing, {
            "numReplicaGroupsQueried": 1,
            "replicaGroup": gname,
            "loadScore": round(float(score), 3),
            "loadBasis": "pressure" if all_fresh else "latency_p90",
        }


class _NoEngine:
    """Broker-side EXPLAIN stand-in: no local executor or segments —
    filter lines show generic PREDICATE operators (index choice is
    per-segment, server-side)."""

    device = None
    tables: dict = {}


class Broker:
    def __init__(self, registry: ClusterRegistry, broker_id: str = "broker_0",
                 timeout_s: float = 10.0, tls="auto", result_cache=None,
                 admission=None, device=None):
        self.registry = registry
        self.broker_id = broker_id
        self.timeout_s = timeout_s
        # stage 2 of a multi-stage query runs here, on the broker's own
        # ``device``: the CUDA card unless the caller asks for "cpu"; its
        # executor is built at the first multi-stage query
        self.device = device
        self._stage2_executor = None
        self._stage2_lock = threading.Lock()
        if tls == "auto":
            # layered config (pinot.tls.*) like the reference's TlsConfig
            from pinot_tpu_torch.common.tls import TlsConfig

            tls = TlsConfig.from_config()
        self.tls = tls
        from pinot_tpu_torch.common.metrics import get_metrics

        self.metrics = get_metrics("broker")
        self.quota = QueryQuotaManager(registry)
        self.failures = FailureDetector()
        # hedge-delay percentiles come from the SHARED metrics histogram
        # (one latency truth); the router reads the same p90s
        # as its stale-pressure load fallback
        self.latency = LatencyTracker(registry=self.metrics)
        self.routing = RoutingManager(registry, self.failures,
                                      latency=self.latency)
        self.routing.instances_fn = \
            lambda: self._server_instances().values()
        # structured slow/error query log (broker/querylog.py): JSONL +
        # the /debug/queries ring
        from pinot_tpu_torch.broker.querylog import QueryLogger

        self.querylog = QueryLogger.from_config()
        self.querylog.broker_id = broker_id
        # failure-handling knobs (reference: pinot.broker.* config keys):
        # retry re-sends a failed instance's segments to a replica before
        # declaring partialResult; hedging duplicates a slow request to a
        # second replica after the per-server rolling p90 (SET
        # useHedging=true overrides per query)
        from pinot_tpu_torch.common.config import Configuration

        conf = Configuration()
        self.retry_enabled = conf.get_bool(
            "pinot.broker.failure.retry.enabled", True)
        self.hedging_enabled = conf.get_bool(
            "pinot.broker.hedging.enabled", False)
        # fixed hedge delay override; <= 0 means adaptive (rolling p90)
        self.hedge_delay_s = conf.get_float(
            "pinot.broker.hedging.delay.ms", 0.0) / 1e3
        # broker result cache (broker/result_cache.py): OFF by
        # default — partial-result and chaos semantics (tests and the
        # fault bench deliberately repeat queries against faulted
        # replicas) must stay exact unless the operator opts in via
        # pinot.broker.resultcache.enabled / the constructor / SET
        # useResultCache=true
        from pinot_tpu_torch.broker.result_cache import BrokerResultCache

        self.result_cache_default = conf.get_bool(
            "pinot.broker.resultcache.enabled", False) \
            if result_cache is None else bool(result_cache)
        self.result_cache = BrokerResultCache(
            max_entries=int(conf.get_float(
                "pinot.broker.resultcache.max.entries", 512)),
            max_bytes=int(conf.get_float(
                "pinot.broker.resultcache.max.bytes", float(32 << 20))),
            stale_retention_s=conf.get_float(
                "pinot.broker.resultcache.stale.retention.s", 30.0))
        # feedback-driven plan advisor (engine/advisor.py):
        # the broker's own memo store — measured stage-1 build rows per
        # multi-stage template feed the distributed-demotion probe and
        # the join-strategy pick where the registry's doc-count estimate
        # used to decide alone. None when pinot.advisor.enabled=false.
        from pinot_tpu_torch.engine.advisor import PlanAdvisor

        self.advisor = PlanAdvisor.from_config(conf)
        # per-tenant priority admission + load shedding
        # (broker/admission.py): OFF by default — every existing
        # single-tenant deployment and test keeps its exact semantics
        # unless the operator opts in (pinot.broker.admission.enabled /
        # the constructor). ``admission`` may be a ready controller, a
        # truthy flag (config-built controller), or None (config decides).
        from pinot_tpu_torch.broker.admission import TenantAdmissionController

        if isinstance(admission, TenantAdmissionController):
            self.admission: Optional[TenantAdmissionController] = admission
        elif (admission if admission is not None
              else conf.get_bool("pinot.broker.admission.enabled", False)):
            self.admission = TenantAdmissionController.from_config(conf)
        else:
            self.admission = None
        # bounded-staleness degradation default (SET maxStalenessMs
        # overrides per query): how old a result-cache entry a SHED query
        # may be served instead of a 429. 0 = degrade only when the query
        # explicitly opts in.
        self.shed_max_staleness_ms = conf.get_float(
            "pinot.broker.shed.max.staleness.ms", 0.0)
        # per-table {instance: freshness epoch} observed piggybacked in
        # responses (merged with heartbeat epochs at validation time)
        self._epoch_obs: dict = {}
        self._epoch_lock = threading.Lock()
        # hot-path memos (the <5ms cache-hit budget AND the cluster
        # scaling gate: per-query broker CPU must stay far below per-query
        # server CPU): every registry-derived per-query lookup — table
        # names, physical-table split + hybrid time boundary — is cached
        # under ONE routing generation read per query (exact: all inputs
        # ride routing sections); the heartbeat epoch view keys on a
        # 0.25s clock (within the heartbeat transport delay itself)
        self._gen_memo: dict = {"gen": None}
        self._inst_memo: tuple = (-1.0, {})
        # optional TTL on the per-query routing-generation READ itself
        # (pinot.broker.routing.gen.ttl.ms, default 0 = always fresh):
        # on file-registry clusters the version read is a real syscall
        # round-trip per query; a small TTL trades that for an equally
        # small routing/invalidation delay (the reference's ZK-watch
        # propagation is asynchronous in just the same way)
        self.routing_gen_ttl_s = conf.get_float(
            "pinot.broker.routing.gen.ttl.ms", 0.0) / 1e3
        self._gen_ttl_memo = None  # (gen, monotonic ts)
        self._rc_gauges = []
        if self.result_cache_default:
            # cache-enabled brokers only: the process-global registry keys
            # gauges by (name, broker_id), and a cache-OFF broker sharing
            # this id (the common probe/bench pattern) would overwrite a
            # live cache's gauges — then delete them on its own close().
            # Two cache-ENABLED brokers in one process still need distinct
            # broker ids, like servers do for the gauge leak guard.
            for gname, fn in (
                    ("resultCacheEntries",
                     (lambda _c=self.result_cache: len(_c))),
                    ("resultCacheBytes",
                     (lambda _c=self.result_cache: _c.bytes))):
                self.metrics.gauge(gname, fn, tag=self.broker_id)
                self._rc_gauges.append(gname)
        self._channels: dict[str, QueryRouterChannel] = {}
        self._channels_lock = threading.Lock()
        self._request_id = itertools.count(1)
        self._pool = futures.ThreadPoolExecutor(max_workers=16)
        # fleet front door: a draining broker answers typed
        # (errorCode 503 / HTTP 503) so rotating clients move to a peer;
        # queries_served feeds the heartbeat-piggybacked QPS counter
        self.draining = False
        self.queries_served = 0

    def drain_response(self) -> dict:
        """Typed refusal a draining broker returns instead of executing:
        clients rotate to a live peer on sight of it (the HTTP surface
        maps it to a 503)."""
        return {
            "resultTable": None, "numDocsScanned": 0, "timeUsedMs": 0.0,
            "brokerDraining": True, "brokerId": self.broker_id,
            "exceptions": [{
                "errorCode": 503,
                "message": f"broker {self.broker_id} is draining",
            }],
        }

    def close(self) -> None:
        for gname in self._rc_gauges:
            self.metrics.remove_gauge(gname, tag=self.broker_id)
        self._rc_gauges = []
        for ch in self._channels.values():
            ch.close()
        self._pool.shutdown(wait=False)

    def _routing_gen(self) -> int:
        """The per-query routing-generation read, optionally TTL-memoized
        (see routing_gen_ttl_s). TTL 0 reads the registry every query."""
        ttl = self.routing_gen_ttl_s
        if ttl <= 0:
            return self.registry.routing_generation()
        now = time.monotonic()
        memo = self._gen_ttl_memo
        if memo is not None and now - memo[1] < ttl:
            return memo[0]
        gen = self.registry.routing_generation()
        self._gen_ttl_memo = (gen, now)
        return gen

    def _note_abandoned(self, fut, inst: str) -> None:
        """A straggler attempt resolved AFTER its entry settled (hedge
        loser, cancelled-too-late retry): its outcome still feeds the
        failure detector — a blackholed replica must not stay HEALTHY
        just because a hedge won every race."""
        from pinot_tpu_torch.engine.datatable import (
            ServerQueryError,
            ServerShuttingDown,
        )

        try:
            exc = fut.exception()
        except futures.CancelledError:
            return
        # ServerShuttingDown is a ServerQueryError on the wire but a
        # FAILURE to the detector (same treatment harvest gives it): a
        # draining server must stay backed off, not bounce back healthy
        if exc is None or (isinstance(exc, ServerQueryError)
                           and not isinstance(exc, ServerShuttingDown)):
            self.failures.mark_success(inst)
        else:
            self.failures.mark_failure(inst)

    def _server_instances(self) -> dict:
        """{instance id: InstanceInfo} for servers, memoized 0.25s — the
        scatter path's endpoint lookups and the result cache's heartbeat
        epoch view share one instances read per tick instead of one per
        query. A restarted server's stale endpoint surfaces as a transport
        failure inside the window; the replica retry path absorbs it."""
        now = time.monotonic()
        ts, info = self._inst_memo
        if now - ts > 0.25:
            info = {i.instance_id: i
                    for i in self.registry.instances(Role.SERVER)}
            self._inst_memo = (now, info)
        return info

    def _channel(self, instance_id: str) -> Optional[QueryRouterChannel]:
        info = self._server_instances().get(instance_id)
        if info is None:
            return None
        with self._channels_lock:  # pool threads race per-instance channels
            ch = self._channels.get(instance_id)
            if ch is None or ch.endpoint != info.endpoint:
                if ch is not None:
                    ch.close()
                ch = QueryRouterChannel(info.endpoint, tls=self.tls)
                self._channels[instance_id] = ch
            return ch

    # ---- per-generation registry view ------------------------------------
    def _gen_view(self, gen=None) -> dict:
        """The per-query registry lookups, memoized per routing
        generation. One generation read (``gen=None``) — or zero, when the
        caller already holds it — replaces the table-name walk and the
        per-table physical split on every query of a steady cluster."""
        if gen is None:
            gen = self.registry.routing_generation()
        view = self._gen_memo
        if view.get("gen") != gen:
            view = {"gen": gen, "tables": set(self.registry.tables()),
                    "phys": {}}
            self._gen_memo = view
        return view

    def _tables_set(self, gen=None) -> set:
        return self._gen_view(gen)["tables"]

    def _hb_epochs(self) -> dict:
        """{logical table: {instance: epoch}} from server heartbeats —
        rides the shared 0.25s instances memo, so the added staleness
        window is the same order as the heartbeat transport delay (sync
        tick) it rides on."""
        out: dict = {}
        for i in self._server_instances().values():
            for base, ep in (getattr(i, "table_epochs", None)
                             or {}).items():
                if ep:
                    out.setdefault(base, {})[i.instance_id] = int(ep)
        return out

    # piggybacked epoch observations not corroborated by a heartbeat
    # expire after this window: a restarted server (fresh process, no
    # epochs yet) stops heartbeating the table, and its old ratcheted
    # observation must not keep pre-restart cache entries valid forever
    EPOCH_OBS_TTL_S = 10.0

    def _epoch_view(self, raw_table: str) -> dict:
        """{instance: freshness epoch} for the logical table: live server
        heartbeat epochs merged with (possibly fresher) piggybacked
        response reports — the staleness contract a cached entry is
        validated against on every hit."""
        from pinot_tpu_torch.common import freshness

        base = freshness.base_table(raw_table)
        view = dict(self._hb_epochs().get(base, {}))
        now = time.monotonic()
        with self._epoch_lock:
            for inst, (ep, seen) in self._epoch_obs.get(base, {}).items():
                # nonzero only: an epoch-0 (never-mutated) observation is
                # restart-stable — post-restart state is identical, and
                # segment-set changes ride the routing generation — and
                # cache hits don't scatter, so expiring it would force a
                # spurious refill miss every TTL on immutable tables
                if ep and inst not in view \
                        and now - seen > self.EPOCH_OBS_TTL_S:
                    continue
                if ep > view.get(inst, -1):
                    view[inst] = ep
        return view

    def _note_epoch(self, physical_table: str, instance_id: str,
                    epoch: int) -> None:
        if epoch is None or epoch < 0:
            return
        from pinot_tpu_torch.common import freshness

        base = freshness.base_table(physical_table)
        with self._epoch_lock:
            per = self._epoch_obs.setdefault(base, {})
            # last-write-wins, no ratchet: the server is authoritative for
            # its own epoch, and a LOWER value is how a restarted process
            # (fresh counter) surfaces under traffic — ratcheting past it
            # would keep pre-restart cache entries validating forever. An
            # out-of-order older response regressing the view briefly just
            # invalidates an entry spuriously (conservative, self-heals on
            # the next response)
            per[instance_id] = (epoch, time.monotonic())

    def _result_cache_key(self, q, for_explain: bool = False,
                          precomputed=None):
        """Cache key for this query, or None when the query must not ride
        the cache (disabled, traced, chaos-armed, or explicitly opted
        out). ``for_explain`` keys the underlying query of an EXPLAIN so
        the plan can render CACHED_RESULT. ``precomputed``: a key the
        caller already derived via ``key_for`` (the admission path's
        adm_key) — reused so the template walk + digest run once per
        query."""
        opts = q.options_ci()
        # quoted SET values arrive as strings: 'false' must opt OUT, not
        # truthy-enable a stale-tolerant path the user refused — the
        # shared helper folds them uniformly (common/options.py)
        enabled = bool_option(opts, "useresultcache",
                              self.result_cache_default)
        if not enabled or faults.ACTIVE:
            # chaos harness armed: fault tests repeat queries on purpose
            # and must observe every injected failure, not a cached hit
            return None
        if q.explain and not for_explain:
            return None
        if opts.get("trace") or opts.get("faultinject"):
            return None
        if precomputed is not None:
            return precomputed
        from pinot_tpu_torch.broker.querylog import template_key

        return self.result_cache.key_for(q, template_key(q))

    def _max_load_score(self):
        """Broker-wide overload signal: the worst decayed LoadTracker
        score across known servers (None when every score is stale — the
        shed ladder then stands down rather than shedding blind)."""
        scores = (self.routing.loads.score(i)
                  for i in self._server_instances())
        vals = [s for s in scores if s is not None]
        return max(vals) if vals else None

    def _shed_response(self, sql: str, q, decision, adm_key,
                       t0: float) -> dict:
        """Load-shedding with graceful degradation: a query
        admission refused is first offered a BOUNDED-STALENESS result-
        cache read — ``SET maxStalenessMs`` (or the broker's configured
        default) caps how old an entry may serve; the response is flagged
        ``servedStale`` with the entry's age and a typed
        ``sheddingReason``, never silently degraded. Only when no
        eligible entry exists does the broker answer 429 — with
        ``retryAfterSeconds`` computed from the TENANT's actual bucket
        refill time (capped at 5 s), and the tenant + priority class in
        the response and the query log."""
        self.metrics.count("queriesShed")
        opts = q.options_ci()
        max_stale_ms = opts.get("maxstalenessms")
        if max_stale_ms is None:
            max_stale_ms = self.shed_max_staleness_ms
        try:
            max_stale_ms = float(max_stale_ms)
        except (TypeError, ValueError):
            max_stale_ms = 0.0
        if max_stale_ms > 0 and adm_key is not None:
            stale, age_s = self.result_cache.get_stale(
                adm_key, max_stale_ms / 1e3)
            if stale is not None:
                self.metrics.count("queriesShedStaleServed")
                self.admission.num_shed_stale_served += 1
                resp = dict(stale)
                resp.pop("__epochView__", None)
                resp["servedStale"] = True
                resp["staleAgeMs"] = round(age_s * 1e3, 1)
                resp["sheddingReason"] = decision.reason
                resp["tenant"] = decision.tenant
                resp["priorityClass"] = decision.priority
                resp["requestId"] = next(self._request_id)
                resp["timeUsedMs"] = round((time.time() - t0) * 1000, 3)
                self.metrics.time_ms("query", resp["timeUsedMs"])
                return self._log_query(sql, q, resp, t0)
        self.metrics.count("queriesAdmissionRejected")
        retry_s = max(0.05, float(decision.retry_after_s))
        return self._log_query(sql, q, {
            "exceptions": [{
                "errorCode": 429,
                "message": f"admission rejected for tenant "
                           f"{decision.tenant!r} "
                           f"(priority {decision.priority}): "
                           f"{decision.reason}"}],
            "retryAfterSeconds": round(retry_s, 3),
            "sheddingReason": decision.reason,
            "tenant": decision.tenant,
            "priorityClass": decision.priority,
        }, t0)

    # ---- request handling ------------------------------------------------
    def execute(self, sql: str, principal: str = None) -> dict:
        """HTTP POST /query/sql equivalent (PinotClientRequest →
        BaseBrokerRequestHandler.handleRequest). ``principal``: the
        authenticated identity (broker HTTP basic auth) — the tenant key
        for priority admission when enabled; queries may also
        self-identify via ``SET workloadName``."""
        from pinot_tpu_torch.common import trace

        t0 = time.time()
        self.metrics.count("queries")
        if self.draining:
            # fleet drain: typed refusal, never a hang or a
            # half-executed query — rotating clients retry a live peer
            self.metrics.count("queriesRefusedDraining")
            return self.drain_response()
        if sql.strip().rstrip(";").strip().upper() == "SHOW TABLES":
            # catalog surface for standards clients (the JDBC driver's
            # DatabaseMetaData.getTables role, backed by the controller's
            # /tables REST in the reference): logical names, type suffix
            # stripped, hybrid halves collapsed
            names = sorted({
                t[: -len(suffix)] if t.endswith(suffix) else t
                for t in self.registry.tables()
                for suffix in ("_OFFLINE", "_REALTIME")
                if t.endswith(suffix)
            } | {t for t in self.registry.tables()
                 if not t.endswith(("_OFFLINE", "_REALTIME"))})
            return {
                "resultTable": {
                    "dataSchema": {"columnNames": ["tableName"],
                                   "columnDataTypes": ["STRING"]},
                    "rows": [[n] for n in names],
                },
                "exceptions": [],
                "numDocsScanned": 0,
                "totalDocs": 0,
                "timeUsedMs": round((time.time() - t0) * 1000, 3),
            }
        tracer = None
        q = None
        try:
            from pinot_tpu_torch.sql.compiler import compile_select, is_multistage
            from pinot_tpu_torch.sql.parser import parse_sql

            stmt = parse_sql(sql)
            if is_multistage(stmt):
                # join / window query: two-stage execution — stage-1 leaf
                # scans ride the ordinary scatter-gather below (recursive
                # single-stage queries, each debiting admission/quota as
                # its own first-class query), stage 2 runs broker-local
                return self._execute_multistage(stmt, sql, t0,
                                                principal=principal)
            q = optimize_query(compile_select(stmt))
            # ONE routing-generation read serves this whole query: quota
            # rate memo, table-name fold, physical split, routing snapshot
            # and the result cache all share it
            gen = self._routing_gen()
            q = self._resolve_table_case(q, gen)
            if q.explain and getattr(q, "analyze", False):
                # EXPLAIN ANALYZE: execute the underlying
                # query through the FULL scatter path (traced, so the
                # per-server phase ladder and roofline records fill),
                # then render the plan annotated with the actuals
                return self._explain_analyze_single(sql, q)
            if q.explain:
                from pinot_tpu_torch.engine.explain import explain_plan

                plan = explain_plan(_NoEngine(), q)
                ck = self._result_cache_key(q, for_explain=True)
                if ck is not None and self.result_cache.peek_fresh(
                        ck, self._epoch_view(q.table_name), gen):
                    # the very next execution of this query would serve
                    # from the broker result cache — surface it on top
                    rows = plan["resultTable"]["rows"]
                    lines = ["CACHED_RESULT(broker result cache: "
                             "fresh entry)"] + [r[0] for r in rows]
                    plan["resultTable"]["rows"] = [
                        [ln, i, i - 1] for i, ln in enumerate(lines)]
                return plan
            # tenant + priority resolution: the authenticated
            # principal wins, then SET workloadName, then the shared
            # 'default' bucket; ``adm_key`` is the literal digest the
            # sub-RTT queue-jump memo and the bounded-staleness shed
            # path key on (computed regardless of the fresh cache's
            # trace/chaos gating — shedding must find entries even when
            # the FRESH path is opted out)
            tenant = pclass = None
            adm_key = None
            if self.admission is not None:
                from pinot_tpu_torch.broker.querylog import template_key

                tenant, pclass = self.admission.resolve(q, principal)
                adm_key = self.result_cache.key_for(q, template_key(q))
            cache_key = self._result_cache_key(q, precomputed=adm_key)
            cache_gen = None
            cache_view = None
            if cache_key is not None:
                # the generation and epoch view are captured BEFORE the
                # scatter: a cluster change mid-flight stores an entry
                # that can never validate (conservative), not one that
                # serves stale
                cache_gen = gen
                cache_view = self._epoch_view(q.table_name)
                cached = self.result_cache.get(
                    cache_key, cache_view, cache_gen)
                if cached is not None:
                    # queue jumping: a fresh result-cache hit
                    # costs no server work, so it bypasses BOTH tenant
                    # admission and the table quota — sub-RTT serving
                    # never waits behind (or is starved by) cold scans —
                    # and marks this literal digest sub-RTT so its
                    # repeats admit at a fraction of a token
                    self.metrics.count("resultCacheHits")
                    resp = dict(cached)
                    resp["resultCacheHit"] = True
                    if self.admission is not None:
                        self.admission.note_sub_rtt(adm_key)
                        resp["tenant"] = tenant
                        resp["priorityClass"] = pclass
                    resp["requestId"] = next(self._request_id)
                    resp["timeUsedMs"] = round((time.time() - t0) * 1000, 3)
                    self.metrics.time_ms("query", resp["timeUsedMs"])
                    return self._log_query(sql, q, resp, t0)
                self.metrics.count("resultCacheMisses")
            if self.admission is not None:
                decision = self.admission.try_admit(
                    tenant, pclass, load_score=self._max_load_score(),
                    sub_rtt=self.admission.is_sub_rtt(adm_key))
                if not decision.admitted:
                    # degrade before rejecting: bounded-staleness cache
                    # read (SET maxStalenessMs), else a typed 429 whose
                    # Retry-After is THIS tenant's actual refill time
                    return self._shed_response(sql, q, decision,
                                               adm_key, t0)
            if not self.quota.acquire(q.table_name, gen):
                # quota rejection before any fan-out
                # (BaseBrokerRequestHandler's quota check placement)
                self.metrics.count("queriesQuotaExceeded")
                return self._log_query(sql, q, {"exceptions": [{
                    "errorCode": 429,
                    "message": f"query quota exceeded for table "
                               f"{q.table_name!r}"}],
                    # pacing hint for clients (Retry-After analog): the
                    # token bucket refills within about a second
                    "retryAfterSeconds": 0.5}, t0)
            if q.options_ci().get("trace"):
                tracer = trace.start_trace()
            resp = self._scatter_gather(q, sql, gen, tenant=tenant,
                                        priority=pclass)
            if tracer is not None:
                resp.setdefault("traceInfo", {})["broker"] = tracer.to_json()
                if tracer.trace_id:
                    resp["traceId"] = tracer.trace_id
        except Exception as e:  # noqa: BLE001 — in-band errors like the reference
            self.metrics.count("queryErrors")
            return self._log_query(sql, q, {"exceptions": [{
                "errorCode": 450,
                "message": f"{type(e).__name__}: {e}"}]}, t0)
        finally:
            if tracer is not None:
                trace.end_trace()
        own_epochs = resp.pop("__epochView__", None)
        resp["timeUsedMs"] = round((time.time() - t0) * 1000, 3)
        self.metrics.time_ms("query", resp["timeUsedMs"])
        if self.admission is not None:
            resp["tenant"] = tenant
            resp["priorityClass"] = pclass
            if resp.get("partialsCacheHit"):
                # a server answered from its device partials cache: this
                # literal digest is sub-RTT — its repeats queue-jump
                self.admission.note_sub_rtt(adm_key)
        if cache_key is not None:
            resp["resultCacheHit"] = False
            if not resp.get("exceptions") and not resp.get("partialResult"):
                # only COMPLETE successes cache. The recorded view is the
                # PRE-scatter view overlaid with the epochs THIS query's
                # own partials piggybacked — never the global observation
                # state at put time, which may already hold epochs newer
                # than the data these rows reflect (a concurrent ingest +
                # query landing mid-gather would stamp stale rows fresh)
                put_view = dict(cache_view or {})
                put_view.update(own_epochs or {})
                self.result_cache.put(cache_key, resp, put_view, cache_gen)
        return self._log_query(sql, q, resp, t0)

    # ---- streaming result delivery ----------------------------
    # One chunked front door for every query shape: eligible single-stage
    # selections ride the per-segment server DataTable streams end to end
    # (server → broker → client with bounded broker RSS — each block is
    # decoded, reduced, trimmed, yielded, freed), everything else
    # (aggregations, ORDER BY, joins, SHOW TABLES, traced queries) falls
    # back to the buffered execute() re-chunked, so a client can use the
    # cursor API unconditionally. Chunk protocol:
    #   {"type": "schema", "columnNames": [...], "columnDataTypes": [...]}
    #   {"type": "rows", "rows": [[...], ...]}     (0..N chunks)
    #   {"type": "final", ...response stats/exceptions, no resultTable}
    # Rows are converted per block by the SAME reduce/finalize code the
    # buffered path uses (offset/limit neutralized per block, applied
    # broker-globally), so the concatenated chunks are bit-identical to
    # the buffered resultTable rows.

    STREAM_CHUNK_ROWS = 50_000

    def execute_stream(self, sql: str, principal: str = None,
                       chunk_rows: int = 0):
        """Generator form of execute(): yields schema / rows / final
        chunks (see the protocol above). The broker never materializes
        the full result — RSS is bounded by one server block plus one
        yielded chunk."""
        t0 = time.time()
        chunk_rows = int(chunk_rows) or self.STREAM_CHUNK_ROWS
        if self.draining:
            self.metrics.count("queries")
            self.metrics.count("queriesRefusedDraining")
            yield {"type": "final", **self.drain_response()}
            return
        q = None
        eligible = False
        try:
            from pinot_tpu_torch.sql.compiler import compile_select, is_multistage
            from pinot_tpu_torch.sql.parser import parse_sql

            if sql.strip().rstrip(";").strip().upper() != "SHOW TABLES":
                stmt = parse_sql(sql)
                if not is_multistage(stmt):
                    q = optimize_query(compile_select(stmt))
                    opts = q.options_ci()
                    # same eligibility rule as the unary path's
                    # server-stream branch: any-subset selection
                    # semantics, untraced, not opted out
                    eligible = (not q.explain and not q.aggregations()
                                and not q.distinct and not q.order_by
                                and opts.get("streaming") is not False
                                and not opts.get("trace"))
        except Exception as e:  # noqa: BLE001 — in-band, like execute()
            self.metrics.count("queries")
            self.metrics.count("queryErrors")
            yield {"type": "final", **self._log_query(sql, None, {
                "exceptions": [{"errorCode": 450,
                                "message": f"{type(e).__name__}: {e}"}],
            }, t0)}
            return
        if not eligible:
            # buffered fallback (execute() counts the query + logs it)
            resp = self.execute(sql, principal=principal)
            yield from self._chunk_buffered(resp, chunk_rows)
            return
        self.metrics.count("queries")
        yield from self._stream_single_stage(q, sql, principal, t0,
                                             chunk_rows)

    @staticmethod
    def _chunk_buffered(resp: dict, chunk_rows: int):
        """Re-chunk a buffered response onto the streaming protocol."""
        rt = resp.get("resultTable")
        if rt:
            schema = rt.get("dataSchema") or {}
            yield {"type": "schema",
                   "columnNames": schema.get("columnNames") or [],
                   "columnDataTypes": schema.get("columnDataTypes") or []}
            rows = rt.get("rows") or []
            for i in range(0, len(rows), chunk_rows):
                yield {"type": "rows", "rows": rows[i:i + chunk_rows]}
        final = {k: v for k, v in resp.items() if k != "resultTable"}
        final["type"] = "final"
        yield final

    def _stream_single_stage(self, q: QueryContext, sql: str,
                             principal: str, t0: float, chunk_rows: int):
        """Admission/quota bracket for the streaming scatter — the same
        decisions as execute(), but a rejection is a typed final chunk
        (no stale-cache degrade: streaming skips the result cache)."""
        gen = self._routing_gen()
        try:
            q = self._resolve_table_case(q, gen)
            tenant = pclass = None
            if self.admission is not None:
                from pinot_tpu_torch.broker.querylog import template_key

                tenant, pclass = self.admission.resolve(q, principal)
                adm_key = self.result_cache.key_for(q, template_key(q))
                decision = self.admission.try_admit(
                    tenant, pclass, load_score=self._max_load_score(),
                    sub_rtt=self.admission.is_sub_rtt(adm_key))
                if not decision.admitted:
                    self.metrics.count("queriesAdmissionRejected")
                    retry_s = max(0.05, float(decision.retry_after_s))
                    yield {"type": "final", **self._log_query(sql, q, {
                        "exceptions": [{
                            "errorCode": 429,
                            "message": f"admission rejected for tenant "
                                       f"{decision.tenant!r} (priority "
                                       f"{decision.priority}): "
                                       f"{decision.reason}"}],
                        "retryAfterSeconds": round(retry_s, 3),
                        "sheddingReason": decision.reason,
                        "tenant": decision.tenant,
                        "priorityClass": decision.priority,
                    }, t0)}
                    return
            if not self.quota.acquire(q.table_name, gen):
                self.metrics.count("queriesQuotaExceeded")
                yield {"type": "final", **self._log_query(sql, q, {
                    "exceptions": [{
                        "errorCode": 429,
                        "message": f"query quota exceeded for table "
                                   f"{q.table_name!r}"}],
                    "retryAfterSeconds": 0.5}, t0)}
                return
        except Exception as e:  # noqa: BLE001
            self.metrics.count("queryErrors")
            yield {"type": "final", **self._log_query(sql, q, {
                "exceptions": [{"errorCode": 450,
                                "message": f"{type(e).__name__}: {e}"}],
            }, t0)}
            return
        reserved: list = []
        try:
            yield from self._stream_scatter(q, sql, reserved, gen, t0,
                                            tenant, pclass, chunk_rows)
        finally:
            self.routing.release(reserved)

    def _stream_scatter(self, q: QueryContext, sql: str, reserved: list,
                        gen, t0: float, tenant, priority, chunk_rows: int):
        """The streaming scatter body: route like the unary path, then
        walk the scatter entries SEQUENTIALLY, turning each server's
        per-segment DataTable blocks into row chunks as they arrive.
        Sequential order is what makes the output bit-identical to the
        buffered reduce (results concatenate in the same entry/block
        order) AND what bounds RSS to one in-flight block."""
        from pinot_tpu_torch.common.trace import span

        q = self._expand_star(q)
        request_id = next(self._request_id)
        trace_id = f"{self.broker_id}-{request_id}"
        opts = q.options_ci()
        timeout_s = self.timeout_s
        if "timeoutms" in opts:
            timeout_s = max(0.001, float(opts["timeoutms"]) / 1000.0)
        deadline = Deadline(timeout_s)
        # per-block finalize runs with offset/limit neutralized — the
        # broker applies the query's real offset/limit globally below
        q_all = dataclasses.replace(q, offset=0, limit=1 << 62)

        exceptions: list = []
        totals = {"numDocsScanned": 0, "totalDocs": 0,
                  "numSegmentsQueried": 0, "numSegmentsProcessed": 0,
                  "numSegmentsMatched": 0, "numSegmentsPrunedByServer": 0}
        n_servers: set = set()
        responded: set = set()
        sent_schema = False
        skip = q.offset
        remaining = q.limit
        rows_streamed = 0

        scatter = []  # (instance, physical, segments, time_filter)
        replicas: dict = {}
        fully_pruned = []
        try:
            with span("broker.route"):
                for physical, tf in self._physical_tables(q.table_name,
                                                          gen):
                    routing, reps, rinfo = \
                        self.routing.routing_with_replicas(
                            physical, reserve=True, gen=gen)
                    reserved.extend(rinfo.get("reserved", ()))
                    if not routing:
                        continue
                    for seg, insts in reps.items():
                        replicas[(physical, seg)] = insts
                    records, time_col = self._pruning_inputs(physical, gen)
                    for inst, segs in routing.items():
                        kept, _pruned, _bv = prune_segments(
                            q, records, segs, time_col, tf)
                        if kept:
                            scatter.append((inst, physical, kept, tf))
                        else:
                            fully_pruned.append(
                                (inst, physical, segs[:1], tf))
            if not scatter and fully_pruned:
                scatter.append(fully_pruned[0])
            if not scatter:
                raise KeyError(
                    f"no routing entry for table {q.table_name!r}")

            def open_stream(inst, phys, segs, tf, attempt):
                if faults.ACTIVE:
                    faults.inject("transport.submit", target=inst,
                                  bound_ms=deadline.remaining_ms())
                ch = self._channel(inst)
                if ch is None:
                    raise ConnectionError(
                        f"server {inst} not registered")
                budget_ms = max(1.0, deadline.remaining_ms())
                payload = make_instance_request(
                    sql, segs, request_id, self.broker_id, table=phys,
                    time_filter=tf, timeout_ms=budget_ms, trace=False,
                    trace_id=trace_id, attempt=attempt,
                    workload=tenant, priority=priority)
                return ch.submit_streaming(payload, budget_ms / 1e3 + 0.25)

            with span("broker.stream"), self.metrics.timed("scatterMs"):
                for inst, phys, segs, tf in scatter:
                    if remaining <= 0 or deadline.expired():
                        break
                    attempt, kind = inst, "primary"
                    entry_tried = {inst}
                    entry_yielded = False
                    while True:
                        n_servers.add(attempt)
                        stream = None
                        try:
                            stream = open_stream(attempt, phys, segs, tf,
                                                 kind)
                            for block in stream:
                                r = decode(bytes(block))
                                st = r.stats
                                if st.server_pressure >= 0 or \
                                        st.server_inflight >= 0:
                                    self.routing.loads.observe(
                                        attempt,
                                        max(0, st.server_pressure),
                                        max(0, st.server_inflight))
                                self._note_epoch(phys, attempt,
                                                 st.table_epoch)
                                totals["numDocsScanned"] += \
                                    st.num_docs_scanned
                                totals["totalDocs"] += st.total_docs
                                totals["numSegmentsQueried"] += \
                                    st.num_segments_queried
                                totals["numSegmentsProcessed"] += \
                                    st.num_segments_processed
                                totals["numSegmentsMatched"] += \
                                    st.num_segments_matched
                                totals["numSegmentsPrunedByServer"] += \
                                    st.num_segments_pruned
                                if not r.rows:
                                    continue
                                table = finalize(
                                    q_all, merge_intermediates(
                                        q_all, [r]))
                                if not sent_schema:
                                    yield {"type": "schema",
                                           "columnNames":
                                               table.column_names,
                                           "columnDataTypes":
                                               table.column_types}
                                    sent_schema = True
                                rows = table.rows
                                if skip:
                                    if skip >= len(rows):
                                        skip -= len(rows)
                                        rows = []
                                    else:
                                        rows = rows[skip:]
                                        skip = 0
                                if rows:
                                    entry_yielded = True
                                    if len(rows) > remaining:
                                        rows = rows[:remaining]
                                    remaining -= len(rows)
                                    rows_streamed += len(rows)
                                    for i in range(0, len(rows),
                                                   chunk_rows):
                                        yield {"type": "rows",
                                               "rows": [list(x) for x in
                                                        rows[i:i +
                                                             chunk_rows]]}
                                # drop this block's row materializations
                                # NOW — locals otherwise pin the previous
                                # block's tuples/arrays until the next
                                # loop iteration rebinds them, doubling
                                # the streaming high-water mark
                                rows = table = r = None
                                if remaining <= 0:
                                    stream.cancel()
                                    break
                                if deadline.expired():
                                    stream.cancel()
                                    exceptions.append({
                                        "errorCode": 250,
                                        "message":
                                            f"QUERY_TIMEOUT: {attempt} "
                                            f"stream cut at the "
                                            f"{timeout_s * 1e3:.0f}ms "
                                            f"query budget"})
                                    break
                            responded.add(attempt)
                            self.failures.mark_success(attempt)
                            break  # entry done
                        except Exception as exc:  # noqa: BLE001
                            from pinot_tpu_torch.engine.datatable import (
                                NoSegmentsHosted,
                                QueryTimeoutError,
                                ServerQueryError,
                            )

                            if isinstance(exc, NoSegmentsHosted):
                                self.failures.mark_success(attempt)
                                responded.add(attempt)
                                break
                            if isinstance(exc, QueryTimeoutError):
                                self.failures.mark_success(attempt)
                                exceptions.append({
                                    "errorCode": 250,
                                    "message": f"{attempt}: {exc}"})
                                break
                            if isinstance(exc, ServerQueryError):
                                # query-level error: in-band, no retry
                                self.failures.mark_success(attempt)
                                yield {"type": "final",
                                       **self._log_query(sql, q, {
                                           "exceptions": [{
                                               "errorCode": 200,
                                               "message":
                                                   f"{attempt}: {exc}"}],
                                       }, t0)}
                                return
                            self.failures.mark_failure(attempt)
                            # retry on a whole-entry replica ONLY while
                            # none of this entry's rows were yielded —
                            # a mid-entry replay would duplicate rows
                            alt = None
                            if self.retry_enabled and not entry_yielded \
                                    and not deadline.expired():
                                cands = None
                                for seg in segs:
                                    insts = set(replicas.get(
                                        (phys, seg), ()))
                                    cands = insts if cands is None \
                                        else cands & insts
                                pool = [i for i in (cands or ())
                                        if i not in entry_tried]
                                healthy = [i for i in pool
                                           if self.failures.is_healthy(i)]
                                alt = (healthy or pool or [None])[0]
                            if alt is None:
                                exceptions.append({
                                    "errorCode": 427,
                                    "message": f"SERVER_NOT_RESPONDING: "
                                               f"{attempt}: {exc}"})
                                break
                            self.metrics.count("retriedRequests")
                            entry_tried.add(alt)
                            attempt, kind = alt, "retry"
                    if exceptions and exceptions[-1].get(
                            "errorCode") == 250:
                        break  # budget gone: no further entries
        except Exception as e:  # noqa: BLE001 — routing/compile errors
            self.metrics.count("queryErrors")
            yield {"type": "final", **self._log_query(sql, q, {
                "exceptions": [{"errorCode": 450,
                                "message": f"{type(e).__name__}: {e}"}],
            }, t0)}
            return
        if not sent_schema and not exceptions:
            # zero matching rows anywhere: still surface the shape
            # (column names from the query; types unknown → STRING)
            yield {"type": "schema",
                   "columnNames": [
                       q.column_name(i)
                       for i in range(len(q.select_expressions))],
                   "columnDataTypes":
                       ["STRING"] * len(q.select_expressions)}
        if any(x["errorCode"] == 250 for x in exceptions):
            self.metrics.count("queryTimeouts")
        resp = {
            "exceptions": exceptions,
            "partialResult": bool(exceptions),
            "streamed": True,
            "numRowsStreamed": rows_streamed,
            "numServersQueried": len(n_servers),
            "numServersResponded": len(responded),
            "requestId": request_id,
            "traceId": trace_id,
            "timeUsedMs": round((time.time() - t0) * 1000, 3),
        }
        resp.update(totals)
        self.metrics.time_ms("query", resp["timeUsedMs"])
        if self.admission is not None:
            resp["tenant"] = tenant
            resp["priorityClass"] = priority
        yield {"type": "final", **self._log_query(sql, q, resp, t0)}

    def _explain_analyze_single(self, sql: str, q: QueryContext) -> dict:
        """Single-stage EXPLAIN ANALYZE: strip the keyword pair, re-enter
        execute() with tracing forced on (routing / retry / hedging /
        quota / logging all apply to the real run), annotate the static
        plan with the response's actuals. The executed response rides as
        ``analyzedResponse`` — callers verify its rows are bit-identical
        to the plain form."""
        from pinot_tpu_torch.engine.explain import explain_plan

        return self._explain_analyze_via(
            sql, lambda: explain_plan(_NoEngine(), q))

    def _explain_analyze_via(self, sql: str, render_static) -> dict:
        """The shared EA sequence (single-stage AND multistage): strip
        ``EXPLAIN ANALYZE``, re-execute with trace forced on and the
        partials cache bypassed (the kernel must actually RUN to be
        measured; results are bit-identical either way), pass errors
        through verbatim, annotate the static plan from
        ``render_static()``, attach the executed response."""
        from pinot_tpu_torch.engine.explain import annotate_analyze
        from pinot_tpu_torch.sql.parser import strip_explain_analyze

        stripped = strip_explain_analyze(sql)
        if stripped == sql:  # nothing stripped: render the static plan
            return render_static()
        inner = self.execute(
            "SET trace = true; SET usePartialsCache = false; " + stripped)
        if inner.get("exceptions"):
            return inner
        out = annotate_analyze(render_static(), inner)
        out["analyzedResponse"] = inner
        return out

    def _execute_multistage(self, stmt, sql: str, t0: float,
                            principal: str = None) -> dict:
        """Two-stage (join / window) execution at the broker. Stage-1 leaf
        scans are plain single-stage SELECT queries issued through
        ``self.execute`` — so routing, replica retry, hedging, the failure
        detector and per-table quotas all apply to them unchanged — and
        the join + window + stage-2 reduce run broker-local through the
        SAME query2 runner the embedded engine uses. The build side must
        be a broker-routable table (dimension tables replicated across
        servers: the star-schema shape this engine targets)."""
        import numpy as np

        from pinot_tpu_torch.query2.logical import (
            BROADCAST_MAX_BUILD_ROWS,
            _sql_ident,
            compile_plan,
            to_sql,
        )
        from pinot_tpu_torch.query2.columns import host_col
        from pinot_tpu_torch.query2.runner import (
            MAX_STAGE1_ROWS,
            needed_columns,
            run_plan,
        )

        def _table_keys(table: str):
            """Exact registry keys first, then the same case-insensitive
            fold _resolve_table_case applies to single-stage queries."""
            keys = [table, f"{table}_OFFLINE", f"{table}_REALTIME"]
            names = set(self.registry.tables())
            if not (set(keys) & names):
                low = table.lower()
                for n in names:
                    if n.lower() in (low, f"{low}_offline",
                                     f"{low}_realtime"):
                        keys.append(n)
            return keys

        def _schema_for(table: str):
            for key in _table_keys(table):
                schema = self.registry.table_schema(key)
                if schema is not None:
                    return schema
            return None

        def catalog(table: str):
            schema = _schema_for(table)
            if schema is None:
                raise KeyError(table)
            cfg = None
            for key in _table_keys(table):
                cfg = self.registry.table_config(key)
                if cfg is not None:
                    break
            is_dim = bool(cfg is not None
                          and getattr(cfg, "is_dim_table", False))
            return tuple(schema.column_names()), is_dim

        plan = compile_plan(stmt, catalog)

        # plan-advisor hookup: measured build rows from past
        # executions of this template sharpen the demotion probe and the
        # join-strategy pick; SET useAdvisor=false bypasses both
        advisor, adv_key = None, None
        adv_notes: list = []
        if self.advisor is not None:
            from pinot_tpu_torch.engine.advisor import advisor_enabled
            from pinot_tpu_torch.broker.querylog import template_key

            try:
                if advisor_enabled(plan.stage2.options_ci()):
                    advisor = self.advisor
                    adv_key = template_key(plan)
            except Exception:  # noqa: BLE001 — advice is optional
                pass

        # ---- distributed stage-2 demotion probe --------------
        # A fact-fact join whose build side is past the broadcast cap is
        # exactly the shape where the broker-local shuffle stops scaling:
        # every build row funnels through this one process no matter how
        # many servers host the table. Demote it to the server-side
        # mailbox exchange (query2/exchange.py) when the fleet can route
        # it. SET joinStrategy='distributed' forces the path; a forced-
        # but-unroutable plan (hybrid split, unknown table, no live
        # servers) falls through to the broker-local mirror and the
        # response reports the EFFECTIVE strategy. The probe runs BEFORE
        # the EXPLAIN early-return below, so the static plan text renders
        # the EFFECTIVE (post-demotion) strategy in STAGE_BOUNDARY —
        # previously only the response/querylog saw the demotion. The
        # advisor's MEASURED stage-1 build rows (post-pushdown) replace
        # the registry's raw doc-count estimate once converged — a heavy
        # pushdown filter no longer demotes a join whose build side
        # actually arrives small. Quota/admission are not debited on the
        # distributed path: it has no per-table leaf queries, and stage-1
        # cost lands on the servers' own schedulers.
        dist = None
        if len(plan.joins) == 1 and not plan.windows:
            want = plan.strategy == "DISTRIBUTED"
            if not want and plan.strategy == "SHUFFLE" \
                    and not plan.strategy_forced:
                build = plan.joins[0].build
                est = self._estimated_docs(build.table, _table_keys)
                build_docs = est
                if advisor is not None:
                    measured = advisor.measured_build_rows(
                        adv_key, build.alias)
                    if measured is not None:
                        build_docs = measured
                        if (measured > BROADCAST_MAX_BUILD_ROWS) \
                                != (est > BROADCAST_MAX_BUILD_ROWS):
                            adv_notes.append(
                                f"ADVISOR(distributedDemotion="
                                f"{'on' if measured > BROADCAST_MAX_BUILD_ROWS else 'off'}: "
                                f"measured={measured} default={est})")
                want = build_docs > BROADCAST_MAX_BUILD_ROWS
            if want and not plan.explain:
                try:
                    dist = self._distributed_spec(plan, _table_keys,
                                                  _schema_for)
                except Exception:  # noqa: BLE001 — probe must not fail
                    log.exception("distributed routability probe failed; "
                                  "falling back to broker-local join")
                    dist = None
            elif want and plan.explain:
                # EXPLAIN renders the routable outcome without paying
                # the full spec build when the probe fails
                try:
                    dist = self._distributed_spec(plan, _table_keys,
                                                  _schema_for)
                except Exception:  # noqa: BLE001 — display only
                    dist = None
        if dist is not None and plan.strategy != "DISTRIBUTED":
            # demotion mutates the plan so EXPLAIN's STAGE_BOUNDARY, the
            # query log's template_key, and the strategy column all see
            # what actually ran
            plan.strategy = "DISTRIBUTED"
            dist["demoted"] = True

        if plan.explain:
            from pinot_tpu_torch.engine.explain import explain_multistage

            if not getattr(plan, "analyze", False):
                return explain_multistage(None, plan)
            # EXPLAIN ANALYZE on a join/window plan: execute the real
            # two-stage query (leaves traced through the ordinary
            # scatter-gather), then annotate the static plan tree
            return self._explain_analyze_via(
                sql, lambda: explain_multistage(None, plan))

        # the user's SET options (trace, numGroupsLimit, ...) ride every
        # leaf scan — the scatter-gather below is where the deadline
        # and tracing contracts live. joinStrategy is stage-2-only, and
        # timeoutMs is rewritten per leaf to the REMAINING budget (leaves
        # run sequentially; each full-budget leaf would let a 2-join query
        # take 3x its deadline). Quota is debited by each leaf's own
        # execute (once per referenced table); a second probe-table
        # acquire here would double-charge joins. Note each leaf ALSO
        # counts as its own broker query in metrics and may log its own
        # querylog entry — deliberate: leaves are first-class queries and
        # hiding them would understate broker load.
        base_opts = []
        budget_ms = None
        for k, v in plan.stage2.options:
            kl = str(k).lower()
            if kl == "joinstrategy":
                continue
            if kl == "timeoutms":
                budget_ms = float(v)
                continue
            base_opts.append((str(k), v))

        def _set_prefix():
            opts = list(base_opts)
            if budget_ms is not None:
                remaining = budget_ms - (time.time() - t0) * 1000
                if remaining <= 0:
                    return None  # expired
                opts.append(("timeoutMs", int(max(1, remaining))))
            prefix = ""
            for k, v in opts:
                if isinstance(v, bool):
                    lit = "TRUE" if v else "FALSE"
                elif isinstance(v, str):
                    lit = "'" + v.replace("'", "''") + "'"
                else:
                    lit = str(v)
                prefix += f"SET {_sql_ident(k)} = {lit}; "
            return prefix

        def _timeout_resp():
            self.metrics.count("queryTimeouts")
            return self._log_query(sql, plan, {"exceptions": [{
                "errorCode": 250,
                "message": f"query timeout: multi-stage budget "
                           f"({budget_ms:.0f} ms) exhausted"}]}, t0)

        # ---- distributed stage-2 dispatch ----------
        # the demotion probe ran above (before the EXPLAIN early-return);
        # here the routable plan hands off to the mailbox exchange
        if dist is not None:
            if adv_key is not None and advisor is not None:
                advisor.observe(adv_key, join_strategy="DISTRIBUTED",
                                demoted=bool(dist.get("demoted")))
                dist["adv_key"] = adv_key
            if adv_notes:
                dist["adv_notes"] = adv_notes
            return self._execute_distributed(plan, sql, t0, budget_ms,
                                             dist)

        counters = {"numDocsScanned": 0, "numSegmentsQueried": 0,
                    "numServersQueried": 0, "numServersResponded": 0,
                    "numRetries": 0, "numHedges": 0, "totalDocs": 0,
                    "numSegmentsCold": 0}
        leaf_partial = False
        trace_info: dict = {}
        table_rows = {}
        leaf_rows: dict = {}       # alias -> stage-1 row count (ANALYZE)
        roofline_recs: list = []   # leaf + join-step roofline flights
        need = needed_columns(plan)
        for src in plan.sources:
            cols = need[src.alias]
            push = plan.pushdown.get(src.alias)
            set_prefix = _set_prefix()
            if set_prefix is None:
                return _timeout_resp()
            leaf = (f"{set_prefix}SELECT "
                    f"{', '.join(_sql_ident(c) for c in cols)} "
                    f"FROM {_sql_ident(src.table)}")
            if push is not None:
                leaf += f" WHERE {to_sql(push)}"
            # cap + 1 so an exact-cap row set is distinguishable from a
            # truncated one (the embedded path's strict > check)
            leaf += f" LIMIT {MAX_STAGE1_ROWS + 1}"
            r = self.execute(leaf, principal=principal)
            if r.get("traceInfo"):
                trace_info[f"leaf:{src.alias}"] = r["traceInfo"]
            for rec in r.get("roofline") or ():
                roofline_recs.append(
                    {**rec, "kernel": f"leaf:{src.alias}:"
                                      f"{rec.get('kernel', 'kernel')}"})
            if r.get("exceptions"):
                # surface the leaf's typed error verbatim (429 keeps its
                # retryAfterSeconds pacing hint, 250 stays a timeout)
                # with the stage-1 context prepended
                excs = [dict(e) for e in r["exceptions"]]
                for e in excs:
                    e["message"] = (f"stage-1 scan of table "
                                    f"{src.table!r}: "
                                    f"{e.get('message', 'unknown')}")
                resp = {"exceptions": excs}
                if r.get("retryAfterSeconds") is not None:
                    resp["retryAfterSeconds"] = r["retryAfterSeconds"]
                if r.get("partialResult"):
                    resp["partialResult"] = True
                return self._log_query(sql, plan, resp, t0)
            # a cold-tier leaf partial has NO exception (honest rows +
            # numSegmentsCold) — the join result built on it is partial
            # too, and must say so
            if r.get("partialResult"):
                leaf_partial = True
            for k in counters:
                counters[k] += int(r.get(k) or 0)
            rows = r["resultTable"]["rows"]
            leaf_rows[src.alias] = len(rows)
            if len(rows) > MAX_STAGE1_ROWS:
                raise RuntimeError(
                    f"stage-1 row set for table {src.table!r} hit the "
                    f"{MAX_STAGE1_ROWS}-row cap; add a more selective "
                    f"filter")
            arrays: dict = {}
            if rows:
                for c, vals in zip(cols, zip(*rows)):
                    arrays[c] = np.asarray(vals)
            else:
                schema = _schema_for(src.table)
                for c in cols:
                    spec = getattr(schema, "fields", {}).get(c)
                    dt = spec.data_type.np_dtype if spec is not None \
                        else np.float64
                    arrays[c] = np.empty(0, dtype=dt)
            table_rows[src.alias] = arrays

        if budget_ms is not None and \
                (time.time() - t0) * 1000 >= budget_ms:
            # leaves consumed the whole budget: a late broker-local join
            # would return a success AFTER the client's deadline
            return _timeout_resp()
        ex = self._stage2()
        result, meta = run_plan(
            plan, {alias: {c: host_col(a, ex.device) for c, a in cols.items()}
                   for alias, cols in table_rows.items()},
            ex, advisor=advisor, advisor_key=adv_key)
        roofline_recs.extend(meta.get("roofline") or ())
        adv_notes.extend(meta.get("advisorDecisions") or ())
        resp = result.to_json()
        resp.update(counters)
        resp.update({
            "exceptions": [],
            "partialResult": leaf_partial,
            "requestId": f"{self.broker_id}_{next(self._request_id)}",
            "numStages": meta["numStages"],
            "numJoinedRows": meta["numJoinedRows"],
            "leafRows": leaf_rows,
            "timeUsedMs": round((time.time() - t0) * 1000, 3),
        })
        if roofline_recs:
            resp["roofline"] = roofline_recs
        if trace_info:
            resp["traceInfo"] = trace_info
        if meta["joinStrategy"]:
            resp["joinStrategy"] = meta["joinStrategy"]
            # partition fan-out of the executed join — the broker-local
            # SHUFFLE baseline column next to the distributed exchange's
            # partition count (previously only the strategy name showed)
            resp["joinFanout"] = meta["joinFanout"]
        if adv_notes:
            resp["advisorDecisions"] = list(dict.fromkeys(adv_notes))
        self.metrics.time_ms("query", resp["timeUsedMs"])
        return self._log_query(sql, plan, resp, t0)

    # ---- the distributed stage-2 exchange ---------------------------------
    def _estimated_docs(self, raw: str, table_keys) -> int:
        """Registry-metadata doc count for the demotion heuristic: the
        sum of SegmentRecord.n_docs over the table's physical keys (same
        per-generation memo the pruner reads — no segment I/O)."""
        names = set(self.registry.tables())
        total = 0
        for key in dict.fromkeys(table_keys(raw)):
            if key not in names:
                continue
            records, _ = self._pruning_inputs(key)
            for rec in records.values():
                total += int(getattr(rec, "n_docs", 0) or 0)
        return total

    def _distributed_spec(self, plan, table_keys, schema_for):
        """Routability probe for the distributed exchange. Returns the
        per-alias replica maps + wire dtypes, or None when the plan
        cannot run fleet-side — hybrid time-boundary split, unknown
        table, or a segment with no live replica — and the caller falls
        back to the broker-local join."""
        import numpy as np

        from pinot_tpu_torch.query2.runner import needed_columns

        names = set(self.registry.tables())
        need = needed_columns(plan)
        insts = self._server_instances()
        routing: dict = {}
        for src in plan.sources:
            matches = [k for k in dict.fromkeys(table_keys(src.table))
                       if k in names]
            if len(matches) != 1:
                # hybrid tables need the broker's time-boundary split;
                # their joins stay on the broker-local path
                return None
            physical = matches[0]
            rmap, replicas, _ = \
                self.routing.routing_with_replicas(physical)
            if rmap is None:
                return None
            # only servers with a live endpoint can host a mailbox
            replicas = {seg: [i for i in ins if i in insts]
                        for seg, ins in replicas.items()}
            if any(not ins for ins in replicas.values()):
                return None
            schema = schema_for(src.table)
            fields = getattr(schema, "fields", {}) if schema else {}
            dtypes = {}
            for c in need[src.alias]:
                spec = fields.get(c)
                dt = spec.data_type.np_dtype if spec is not None \
                    else np.dtype(np.float64)
                # np dtype wire names ('<i8', '|O', ...): the worker
                # casts zero-row scans so even an empty payload ships
                # correctly typed (the empty-leaf dtype guard)
                dtypes[c] = np.dtype(dt).str
            routing[src.alias] = {"table": physical,
                                  "replicas": replicas,
                                  "dtypes": dtypes}
        return {"routing": routing}

    def _distributed_assign(self, dist: dict, excluded: set):
        """One attempt's worker assignment: per alias, each segment goes
        to one live, non-excluded replica (healthy instances first); the
        partition space is 2x the worker count, owners round-robin. None
        when some segment has no usable replica left — coverage is
        impossible and the query must settle as a typed partial."""
        import zlib

        insts = self._server_instances()
        # the stage-2 fleet: EVERY live, non-excluded instance holding a
        # replica of any involved table — partition ownership must span
        # the fleet even when the segment scans land on fewer servers
        # (the whole point of the exchange is that join+agg scale with
        # the server count, not with where stage 1 happened to read)
        fleet: set = set()
        for route in dist["routing"].values():
            for replicas in route["replicas"].values():
                fleet.update(i for i in replicas
                             if i not in excluded and i in insts)
        if not fleet:
            return None
        # healthy-first at the fleet level too: a struck-but-live
        # instance drops out of partition ownership until it recovers
        # (the detector's adaptive routing), unless nothing healthy
        # remains
        healthy_fleet = {i for i in fleet
                         if self.failures.is_healthy(i)} or fleet
        load = {w: 0 for w in fleet}
        used: set = set()
        segments: dict = {}
        for alias, route in dist["routing"].items():
            per: dict = {}
            for seg, replicas in sorted(route["replicas"].items()):
                pool = [i for i in replicas
                        if i not in excluded and i in insts]
                if not pool:
                    return None
                healthy = [i for i in pool
                           if self.failures.is_healthy(i)]
                cands = healthy or pool
                # least-loaded deterministic spread, crc32 tie-break
                # (not hash(): stable across processes) — independent
                # per-segment picks can all collapse onto one replica,
                # serializing stage 1 behind a single server
                pick = min(cands, key=lambda i: (
                    load[i], zlib.crc32(f"{seg}|{i}".encode())))
                load[pick] += 1
                used.add(pick)
                per.setdefault(pick, []).append(seg)
            segments[alias] = per
        # every scan host must run the stage; union covers the segment
        # whose only surviving replica is an unhealthy instance
        worker_list = sorted(healthy_fleet | used)
        n_parts = max(1, 2 * len(worker_list))
        owners = {str(p): worker_list[p % len(worker_list)]
                  for p in range(n_parts)}
        endpoints = {w: insts[w].endpoint for w in worker_list}
        return {"workers": worker_list, "partitions": n_parts,
                "owners": owners, "segments": segments,
                "endpoints": endpoints}

    def _execute_distributed(self, plan, sql: str, t0: float,
                             budget_ms, dist: dict) -> dict:
        """Scatter one ExecuteStage request per worker: each scans its
        routed stage-1 segments, hash-partitions by join key, ships the
        partitions peer-to-peer (query2/exchange.py mailboxes), joins +
        partially aggregates its owned partitions, and answers ONE
        mergeable DataTable — the broker only merges and finalizes, the
        same division of labor stage 1 always had.

        Failure handling mirrors the scatter-gather's replica retry: a
        typed EXCHANGE_TRANSFER_FAILED names the implicated PEER (the
        answering worker is healthy), the broker excludes that instance,
        re-picks the assignment from the replica maps, and re-runs the
        whole exchange ONCE under a fresh exchange id (partial mailboxes
        are not resumable). No coverage or a second failure settles as a
        typed partialResult — never a hang past the deadline."""
        import json as _json
        import re

        from pinot_tpu_torch.engine.datatable import (
            ServerQueryError,
            ServerShuttingDown,
            decode,
        )
        from pinot_tpu_torch.engine.reduce import finalize, merge_intermediates

        total_ms = budget_ms if budget_ms is not None \
            else self.timeout_s * 1000.0
        trace_on = any(str(k).lower() == "trace" and bool(v)
                       for k, v in plan.stage2.options)
        request_id = f"{self.broker_id}_{next(self._request_id)}"
        max_attempts = 2 if self.retry_enabled else 1
        excluded: set = set()
        retries = 0
        last_err = "no routable workers"
        for attempt in range(1, max_attempts + 1):
            remaining = total_ms - (time.time() - t0) * 1000.0
            if remaining <= 0:
                self.metrics.count("queryTimeouts")
                return self._log_query(sql, plan, {
                    "exceptions": [{
                        "errorCode": 250,
                        "message": f"query timeout: distributed stage-2 "
                                   f"budget ({total_ms:.0f} ms) "
                                   f"exhausted"}],
                    "partialResult": True,
                    "joinStrategy": "DISTRIBUTED",
                    "numRetries": retries}, t0)
            assign = self._distributed_assign(dist, excluded)
            if assign is None:
                last_err = (f"segment coverage impossible with "
                            f"{sorted(excluded)} excluded ({last_err})")
                break
            workers = assign["workers"]
            # keep retry headroom on the first attempt (when one is still
            # possible): the stage deadline is what bounds a blackholed
            # transfer, so the retry must have budget left after it fires
            can_retry = self.retry_enabled and attempt < max_attempts
            stage_ms = max(remaining / 2.0, remaining - 2000.0) \
                if can_retry else remaining
            exchange_id = f"ex_{request_id}_{attempt}"
            reqs = {}
            for w in workers:
                reqs[w] = _json.dumps({
                    "exchangeId": exchange_id,
                    "sql": sql,
                    "requestId": request_id,
                    "brokerId": self.broker_id,
                    "timeoutMs": stage_ms,
                    "traceEnabled": trace_on,
                    "traceId": f"{request_id}:{attempt}",
                    "partitions": assign["partitions"],
                    "partitionOwners": assign["owners"],
                    "endpoints": assign["endpoints"],
                    "senders": assign["workers"],
                    "routing": {
                        alias: {
                            "table": route["table"],
                            "segments":
                                assign["segments"][alias].get(w, []),
                            "dtypes": route["dtypes"],
                        } for alias, route in dist["routing"].items()},
                }).encode("utf-8")

            def _call(w, payload):
                ch = self._channel(w)
                if ch is None:
                    raise RuntimeError(f"no endpoint for {w}")
                # RPC timeout rides above the server-side stage deadline:
                # the typed in-band answer must win over DEADLINE_EXCEEDED
                return decode(ch.execute_stage(
                    payload, timeout_s=stage_ms / 1e3 + 2.0))

            futs = {w: self._pool.submit(_call, w, reqs[w])
                    for w in workers}
            parts, failures = {}, {}
            for w, fut in futs.items():
                try:
                    parts[w] = fut.result()
                except Exception as e:  # noqa: BLE001 — typed below
                    failures[w] = e
            if not failures:
                return self._distributed_response(
                    plan, sql, t0, dist, assign, parts, request_id,
                    retries, merge_intermediates, finalize)
            # attribution: a typed transfer failure names the PEER; the
            # answering worker is healthy (same convention as harvest —
            # ServerQueryError that isn't ShuttingDown marks success)
            implicated = None
            for w, e in failures.items():
                m = re.search(r"EXCHANGE_TRANSFER_FAILED peer=(\S+?):",
                              str(e))
                if m:
                    implicated = m.group(1)
                    break
            if implicated is None:
                implicated = next(iter(failures))
            for w, e in failures.items():
                if w == implicated:
                    continue
                if isinstance(e, ServerQueryError) \
                        and not isinstance(e, ServerShuttingDown):
                    self.failures.mark_success(w)
                else:
                    self.failures.mark_failure(w)
            self.failures.mark_failure(implicated)
            for w in parts:
                self.failures.mark_success(w)
            excluded.add(implicated)
            last_err = "; ".join(
                f"{w}: {type(e).__name__}: {e}"
                for w, e in list(failures.items())[:3])
            if attempt < max_attempts:
                retries += 1
                self.metrics.count("exchangeRetries")
                log.warning("distributed stage-2 attempt %d failed "
                            "(implicated %s); retrying without it: %s",
                            attempt, implicated, last_err)
        self.metrics.count("queryErrors")
        expired = (total_ms - (time.time() - t0) * 1000.0) <= 0
        return self._log_query(sql, plan, {
            "exceptions": [{
                "errorCode": 250 if expired else 200,
                "message": f"distributed stage-2 failed after "
                           f"{retries + 1} attempt(s): {last_err}"}],
            "partialResult": True,
            "requestId": request_id,
            "joinStrategy": "DISTRIBUTED",
            "numRetries": retries,
            "timeUsedMs": round((time.time() - t0) * 1000, 3)}, t0)

    def _distributed_response(self, plan, sql, t0, dist, assign, parts,
                              request_id, retries, merge_intermediates,
                              finalize) -> dict:
        """Merge worker partials, finalize stage 2 (HAVING/ORDER/LIMIT
        run here, broker-side, exactly like the broker-local path), and
        assemble the response with the exchange counters."""
        workers = assign["workers"]
        merged = merge_intermediates(
            plan.stage2, [parts[w] for w in workers])
        st = merged.stats
        for w in parts:
            self.failures.mark_success(w)
        resp = finalize(plan.stage2, merged).to_json()
        elapsed = round((time.time() - t0) * 1000, 3)
        per_server = {w: {
            "stage2Rows": int(parts[w].stats.stage2_rows),
            "shippedPartitions":
                int(parts[w].stats.exchange_partitions_shipped),
            "shippedBytes": int(parts[w].stats.exchange_bytes_shipped),
            "spills": int(parts[w].stats.exchange_spill_count),
            "leafRows": {a: int(v) for a, v
                         in (parts[w].stats.leaf_rows or {}).items()},
        } for w in workers}
        resp.update({
            "exceptions": [],
            "partialResult": st.num_segments_cold > 0,
            "requestId": request_id,
            "numStages": 2,
            "numServersQueried": len(workers),
            "numServersResponded": len(parts),
            "numRetries": retries,
            "numHedges": 0,
            "numDocsScanned": int(st.num_docs_scanned),
            "numSegmentsQueried": int(st.num_segments_queried),
            "numSegmentsCold": int(st.num_segments_cold),
            "totalDocs": int(st.total_docs),
            "numJoinedRows": int(st.stage2_rows),
            "leafRows": {a: int(v)
                         for a, v in (st.leaf_rows or {}).items()},
            "joinStrategy": "DISTRIBUTED",
            "joinFanout": int(assign["partitions"]),
            "numPartitionsShipped": int(st.exchange_partitions_shipped),
            "exchangeBytes": int(st.exchange_bytes_shipped),
            "exchangeSpillCount": int(st.exchange_spill_count),
            "exchange": {
                "partitions": int(assign["partitions"]),
                "numWorkers": len(workers),
                "servers": per_server,
            },
            "timeUsedMs": elapsed,
        })
        if dist.get("demoted"):
            resp["joinStrategyDemoted"] = True
        # plan-advisor: stamp probe overrides + any worker-side
        # decisions, and feed the MEASURED per-alias leaf rows back so the
        # next demotion probe decides from observation, not the registry
        adv_lines = list(dist.get("adv_notes") or [])
        for line in (st.advisor_decisions or []):
            if line not in adv_lines:
                adv_lines.append(line)
        if adv_lines:
            resp["advisorDecisions"] = adv_lines
        adv_key = dist.get("adv_key")
        if adv_key and self.advisor is not None and st.leaf_rows:
            self.advisor.observe(
                adv_key,
                build_rows={a: int(v) for a, v in st.leaf_rows.items()})
        trace_info = {f"stage2:{w}": parts[w].trace
                      for w in workers if parts[w].trace}
        if trace_info:
            resp["traceInfo"] = trace_info
        self.metrics.count("exchangeQueries")
        self.metrics.count("exchangeBytes",
                           int(st.exchange_bytes_shipped))
        self.metrics.count("exchangePartitionsShipped",
                           int(st.exchange_partitions_shipped))
        if st.exchange_spill_count:
            self.metrics.count("exchangeSpills",
                               int(st.exchange_spill_count))
        self.metrics.time_ms("query", elapsed)
        return self._log_query(sql, plan, resp, t0)

    def _stage2(self):
        """The executor stage 2 runs on: the broker's device, built once."""
        with self._stage2_lock:
            if self._stage2_executor is None:
                from pinot_tpu_torch.engine.device import DeviceExecutor

                self._stage2_executor = DeviceExecutor(self.device)
            return self._stage2_executor

    def _log_query(self, sql: str, q, resp: dict, t0: float) -> dict:
        """Feed the structured query log on EVERY terminal broker path
        (success, partial, error, quota) and pass the response through.
        Logging must never fail a query."""
        time_used = resp.get("timeUsedMs")
        if time_used is None:
            time_used = round((time.time() - t0) * 1000, 3)
        # fleet attribution: every terminal response says WHICH
        # broker answered — rotation tests and merged fleet query logs
        # both key on it — and feeds this broker's heartbeat QPS counter
        resp.setdefault("brokerId", self.broker_id)
        self.queries_served += 1
        try:
            from pinot_tpu_torch.broker.querylog import template_key

            self.querylog.record(
                sql, resp, time_used,
                table=q.table_name if q is not None else None,
                # deferred: the keep policy drops most healthy fast
                # queries before the template tree walk would run
                template=(lambda _q=q: template_key(_q))
                if q is not None else None)
        except Exception:  # noqa: BLE001
            log.exception("query log record failed")
        return resp

    def _resolve_table_case(self, q: QueryContext,
                            gen=None) -> QueryContext:
        """Case-insensitive table resolution against the registry
        (BaseBrokerRequestHandler.java:245-254 / TableCache's
        ignore-case lookup): FROM mytable matches a registered MyTable.
        Exact matches win; ambiguous case-folds keep the literal name."""
        raw = q.table_name
        names = self._tables_set(gen)
        candidates = {raw, f"{raw}_OFFLINE", f"{raw}_REALTIME"}
        if candidates & names:
            return q
        low = raw.lower()
        # physical-name fold first (FROM sAlEs_OFFLINE → sales_OFFLINE),
        # then the base-name fold (FROM SALES → sales)
        physical = {n for n in names if n.lower() == low}
        base = {QueryQuotaManager._base_name(n) for n in names}
        matches = physical or {b for b in base if b.lower() == low}
        if len(matches) != 1:
            return q
        return dataclasses.replace(q, table_name=matches.pop())

    def _expand_star(self, q: QueryContext) -> QueryContext:
        """SELECT * resolves against the registry schema (looked up via the
        physical table key) so the broker's reduce sees the same select
        positions the servers produced."""
        from pinot_tpu_torch.query.rewrite import expand_star

        if not any(e.is_identifier and e.name == "*"
                   for e in q.select_expressions):
            return q  # no star: don't pay a schema read per query
        schema = None
        for key in (q.table_name, f"{q.table_name}_OFFLINE", f"{q.table_name}_REALTIME"):
            schema = self.registry.table_schema(key)
            if schema is not None:
                break
        if schema is None:
            return q
        return expand_star(q, schema.column_names())

    def _physical_tables(self, raw: str, gen=None) -> list:
        """Raw table name → [(physical key, time filter or None)].

        A hybrid table (both _OFFLINE and _REALTIME registered) is split at
        the time boundary = max offline segment end time: offline answers
        time <= boundary, realtime answers time > boundary
        (routing/timeboundary/TimeBoundaryManager.java +
        BaseBrokerRequestHandler.java:387-395).

        Memoized per routing generation (exact: the name set, table config
        and boundary inputs all ride routing sections) — the steady-state
        hot path pays a dict lookup, not a registry walk per query."""
        view = self._gen_view(gen)
        hit = view["phys"].get(raw)
        if hit is not None:
            return hit
        out = self._split_physical(raw, view["tables"])
        view["phys"][raw] = out
        return out

    def _pruning_inputs(self, physical: str, gen=None) -> tuple:
        """(segment records, time column) for broker-side pruning,
        memoized per routing generation like the physical split (segment
        records and table config both ride routing sections)."""
        view = self._gen_view(gen)
        hit = view.get(("prune", physical))
        if hit is not None:
            return hit
        records = self.registry.segments(physical)
        cfg = self.registry.table_config(physical)
        out = (records, cfg.time_column if cfg is not None else None)
        view[("prune", physical)] = out
        return out

    def _split_physical(self, raw: str, tables: set) -> list:
        if raw in tables:
            return [(raw, None)]
        off, rt = f"{raw}_OFFLINE", f"{raw}_REALTIME"
        out = []
        boundary = None
        if off in tables and rt in tables:
            cfg = self.registry.table_config(off)
            if cfg is not None and cfg.time_column is not None:
                # boundary counts only SERVABLE offline segments: a freshly
                # pushed segment (e.g. a realtimeToOffline move) must not
                # advance the boundary before any server can answer for it,
                # or its window would transiently vanish from hybrid results
                view, records, _ = self.registry.routing_snapshot(off)
                ends = [
                    r.end_time
                    for name, r in records.items()
                    if r.end_time is not None and name in view
                ]
                if ends:
                    # TimeBoundaryManager semantics: back off one time unit
                    # from the max offline end time — realtime rows with
                    # ts <= maxEnd not yet pushed offline would otherwise be
                    # invisible to both sides (offline lacks them, gt filter
                    # excludes them).
                    bval = max(ends)
                    if isinstance(bval, int):
                        bval -= 1
                    else:
                        # float time columns: back off one ULP so ts == maxEnd
                        # rows route to realtime (same semantics as minus one
                        # unit at float resolution)
                        import math

                        bval = math.nextafter(float(bval), -math.inf)
                    boundary = (cfg.time_column, bval)
        if off in tables:
            tf = None if boundary is None else                 {"column": boundary[0], "op": "le", "value": boundary[1]}
            out.append((off, tf))
        if rt in tables:
            tf = None if boundary is None else                 {"column": boundary[0], "op": "gt", "value": boundary[1]}
            out.append((rt, tf))
        if not out:
            raise KeyError(f"table {raw!r} not found")
        return out

    def _scatter_gather(self, q: QueryContext, sql: str, gen=None,
                        tenant: str = None, priority: str = None) -> dict:
        """Thin reservation bracket around the scatter body: routing
        reserves the picked instances' outstanding counts atomically with
        the pick (concurrent queries balance instead of herding), and the
        release is guaranteed here however the query settles.
        ``tenant``/``priority`` stamp every instance request
        so the servers' weighted-fair schedulers isolate tenants."""
        reserved: list = []
        try:
            return self._scatter_gather_inner(q, sql, reserved, gen,
                                              tenant, priority)
        finally:
            self.routing.release(reserved)

    def _scatter_gather_inner(self, q: QueryContext, sql: str,
                              reserved: list, gen=None,
                              tenant: str = None,
                              priority: str = None) -> dict:
        from pinot_tpu_torch.common.trace import active, span

        q = self._expand_star(q)
        request_id = next(self._request_id)
        # trace id: minted per request, stamped into EVERY scatter
        # request (primary + retries + hedges, each tagged with its
        # attempt kind) so per-server spans join back to one query
        tracer = active()
        trace_id = f"{self.broker_id}-{request_id}"
        if tracer is not None:
            tracer.trace_id = trace_id
        trace_on = tracer is not None
        # per-query failure-handling counters (the query log's view; the
        # registry counters aggregate the same events process-wide)
        attempt_counts = {"retries": 0, "hedges": 0}
        # per-query timeout override (SET timeoutMs = N — the reference's
        # timeoutMs query option). The Deadline is THE budget: every
        # scatter request ships the remaining window, every gather wait is
        # clamped to it, and expiry yields a typed QUERY_TIMEOUT partial.
        opts = q.options_ci()
        timeout_s = self.timeout_s
        if "timeoutms" in opts:
            timeout_s = max(0.001, float(opts["timeoutms"]) / 1000.0)
        deadline = Deadline(timeout_s)
        # SET faultInject='point[@target]=mode[:arg][#times];...' arms the
        # chaos harness from a query (one-shot per entry unless the spec
        # says otherwise) — the SQL-driven face of PINOT_TPU_FAULTS
        fi = opts.get("faultinject")
        if fi:
            for f in faults.parse_spec(str(fi)):
                if f.times is None:
                    f.times = 1
                faults.install(f)

        scatter = []  # (instance, physical table, segments, time_filter)
        replicas: dict = {}  # (physical, segment) -> serving instances
        n_servers = set()
        num_pruned = 0
        num_pruned_value = 0  # excluded by per-column min/max stats alone
        fully_pruned = []  # fallback: keep one segment so reduce sees a shape
        # replica-group attribution: how many groups
        # this query's routing touched + the chosen group's load score, so
        # the query log and bench can attribute tail latency to routing
        rg_queried = 0
        rg_load_score = None
        rg_name = None
        # freshness epochs piggybacked by THIS query's own partials — the
        # result cache records these (merged over the pre-scatter view),
        # never the global observation state at put time, which can hold
        # epochs newer than the data this query actually scanned
        own_epochs: dict = {}
        with span("broker.route"):
            for physical, time_filter in self._physical_tables(q.table_name,
                                                               gen):
                routing, reps, rinfo = \
                    self.routing.routing_with_replicas(physical,
                                                       reserve=True,
                                                       gen=gen)
                reserved.extend(rinfo.get("reserved", ()))
                rg_queried += int(rinfo.get("numReplicaGroupsQueried", 0)
                                  or 0)
                if rinfo.get("loadScore") is not None and \
                        (rg_load_score is None
                         or rinfo["loadScore"] > rg_load_score):
                    rg_load_score = rinfo["loadScore"]
                    rg_name = rinfo.get("replicaGroup")
                if not routing:
                    continue
                for seg, insts in reps.items():
                    replicas[(physical, seg)] = insts
                records, time_col = self._pruning_inputs(physical, gen)
                for inst, segs in routing.items():
                    kept, pruned, by_value = prune_segments(
                        q, records, segs, time_col, time_filter)
                    num_pruned += pruned
                    num_pruned_value += by_value
                    if kept:
                        scatter.append((inst, physical, kept, time_filter))
                        n_servers.add(inst)
                    else:
                        fully_pruned.append(
                            (inst, physical, segs[:1], time_filter))
        if not scatter and fully_pruned:
            # every segment pruned: query one anyway — the server's min/max
            # pruner short-circuits it, and the reduce gets a typed empty
            # result instead of a synthesized one
            inst, phys, segs, tf = fully_pruned[0]
            num_pruned -= len(segs)
            # the re-queried segment no longer counts as pruned in EITHER
            # number; the clamp is exact — by-value can only exceed the new
            # total when the re-added segment itself was value-pruned
            num_pruned_value = min(num_pruned_value, max(0, num_pruned))
            scatter.append((inst, phys, segs, tf))
            n_servers.add(inst)
        if not scatter:
            raise KeyError(f"no routing entry for table {q.table_name!r}")

        # Streaming execution (StreamingReduceService analog): selection
        # without ORDER BY has any-subset semantics, so servers stream one
        # DataTable block per segment and the broker cancels every stream
        # as soon as offset+limit rows arrived — no full materialization on
        # either side. SET streaming = false forces the unary path.
        use_streaming = (
            not q.aggregations() and not q.distinct and not q.order_by
            and opts.get("streaming") is not False
            # tracing rides the unary DataTable header; streaming blocks
            # don't carry spans, so a traced query takes the unary path
            and not opts.get("trace")
        )
        row_budget = q.offset + q.limit
        rows_seen = [0]
        rows_lock = threading.Lock()

        def call(instance_id: str, physical: str, segments: list, time_filter,
                 attempt: str = "primary"):
            if faults.ACTIVE:
                # chaos seam: drop / delay / blackhole this replica's RPC
                # (a blackhole sleeps at most the remaining budget — the
                # gRPC deadline would have freed the thread the same way)
                faults.inject("transport.submit", target=instance_id,
                              bound_ms=deadline.remaining_ms())
            ch = self._channel(instance_id)
            if ch is None:
                raise ConnectionError(f"server {instance_id} not registered")
            # ship the REMAINING budget, not the original timeout: the
            # server bounds every downstream wait by it and answers a
            # typed QUERY_TIMEOUT instead of computing an abandoned result
            budget_ms = max(1.0, deadline.remaining_ms())
            payload = make_instance_request(
                sql, segments, request_id, self.broker_id,
                table=physical, time_filter=time_filter,
                timeout_ms=budget_ms,
                # every attempt ships the trace flag + id, tagged with its
                # kind, so a retried/hedged query still traces end to end
                trace=trace_on, trace_id=trace_id, attempt=attempt,
                # tenant + priority class: the server's
                # weighted-fair scheduler groups slots by tenant
                workload=tenant, priority=priority,
            )
            # small grace past the shipped budget: the server's own
            # deadline fires first; the RPC deadline is the backstop
            rpc_timeout_s = budget_ms / 1e3 + 0.25
            t0 = time.perf_counter()
            if not use_streaming:
                parts = [decode(ch.submit(payload, rpc_timeout_s))]
            else:
                stream = ch.submit_streaming(payload, rpc_timeout_s)
                parts = []
                contributed = 0
                try:
                    for block in stream:
                        r = decode(bytes(block))
                        parts.append(r)
                        n = len(next(iter(r.rows.values()))) if r.rows else 0
                        with rows_lock:
                            rows_seen[0] += n
                            contributed += n
                            done = rows_seen[0] >= row_budget
                        if done:
                            stream.cancel()
                            break
                except BaseException:
                    # a failed attempt's blocks are DISCARDED: roll their
                    # rows back out of the shared budget, or a successful
                    # retry would report a "complete" result that silently
                    # stopped other entries' streams short of LIMIT
                    with rows_lock:
                        rows_seen[0] -= contributed
                    raise
            # rolling latency feeds the adaptive hedge delay (p90)
            self.latency.record(instance_id, time.perf_counter() - t0)
            return parts

        from pinot_tpu_torch.engine.datatable import (
            NoSegmentsHosted,
            QueryTimeoutError,
            ServerQueryError,
            ServerShuttingDown,
        )

        # ---- scatter with per-entry failure handling ---------------------
        # Each scatter entry tracks every attempt (primary + retry +
        # hedge) WITH the segment list that attempt covers: a retry may
        # have to SPLIT the failed instance's segments across several
        # replicas when no single replica serves them all, and the reduce
        # must never count a segment twice when both a primary and its
        # hedge answer. Transient failures of a fully-served entry are
        # dropped (the result is complete); only unrecovered failures
        # surface as partialResult exceptions.
        entries_lock = threading.Lock()
        entries = []

        def submit_attempt(e, inst, segs=None, kind="primary"):
            segs = e["segs"] if segs is None else segs
            fut = self._pool.submit(call, inst, e["phys"], segs, e["tf"],
                                    kind)
            with entries_lock:
                e["futs"].append((fut, inst, frozenset(segs), kind))
            fut.add_done_callback(lambda _f, _ev=e["ev"]: _ev.set())
            return fut

        def alternate_for(e):
            """A not-yet-attempted replica serving EVERY segment of the
            entry (healthy first, then backing-off as a last resort).
            None when no single replica covers the list (hedging skips;
            retry falls back to a split — retry_groups)."""
            cands = None
            for seg in e["segs"]:
                insts = set(replicas.get((e["phys"], seg), ()))
                cands = insts if cands is None else cands & insts
            cands = [i for i in (cands or ()) if i not in e["attempted"]]
            healthy = [i for i in cands if self.failures.is_healthy(i)]
            pool = healthy or cands
            return pool[0] if pool else None

        def retry_groups(e):
            """{instance: [segments]} re-covering the entry's list on
            not-yet-attempted replicas, split per segment when needed
            (healthy replicas first; fewest instances greedily). Segments
            with no remaining replica are left out — they surface as the
            partial's exceptions."""
            groups: dict = {}
            for seg in e["segs"]:
                cands = [i for i in replicas.get((e["phys"], seg), ())
                         if i not in e["attempted"]]
                healthy = [i for i in cands if self.failures.is_healthy(i)]
                pool = healthy or cands
                if not pool:
                    continue
                pick = next((i for i in pool if i in groups), pool[0])
                groups.setdefault(pick, []).append(seg)
            return groups

        # hedging (SET useHedging=true / pinot.broker.hedging.enabled):
        # after the target replica's rolling p90 (or the configured fixed
        # delay), duplicate a still-unanswered request to a second
        # replica; first complete wins, the loser is cancelled/ignored.
        # Streaming selections don't hedge — the duplicate's blocks would
        # double-count against the shared row budget.
        hedging = (not use_streaming) and (
            bool_option(opts, "usehedging", None) is True
            or (self.hedging_enabled
                and bool_option(opts, "usehedging", None) is not False))

        for inst, phys, segs, tf in scatter:
            entries.append({
                "inst": inst, "phys": phys, "segs": segs, "tf": tf,
                "futs": [], "ev": threading.Event(), "attempted": {inst},
                "consumed": set(),
            })
        if len(entries) == 1 and not hedging and not faults.ACTIVE:
            # replica-group routing's common case: the WHOLE query goes to
            # one server. Run the primary attempt inline on this thread —
            # the pool handoff + event wakeup are pure overhead (several
            # cross-thread futex round-trips per query, each a sentry trip
            # under sandboxed kernels) when there is nothing to overlap.
            # Failures still flow through harvest's retry machinery via
            # the pre-resolved future. Chaos runs keep the pool path: the
            # deadline-bounded event wait is what bounds a blackholed RPC.
            e = entries[0]
            fut: futures.Future = futures.Future()
            try:
                fut.set_result(call(e["inst"], e["phys"], e["segs"],
                                    e["tf"], "primary"))
            except BaseException as exc:  # noqa: BLE001 — future carries it
                fut.set_exception(exc)
            with entries_lock:
                e["futs"].append(
                    (fut, e["inst"], frozenset(e["segs"]), "primary"))
            e["ev"].set()
        else:
            for e in entries:
                submit_attempt(e, e["inst"])

        def maybe_hedge(e):
            if deadline.expired():
                return
            with entries_lock:
                if any(f.done() for f, _i, _s, _k in e["futs"]):
                    return
                alt = alternate_for(e)
                # no single replica covers the list: hedge the split form
                # (disjoint subsets — the coverage-aware resolve composes
                # them exactly like a split retry)
                groups = {alt: e["segs"]} if alt is not None \
                    else retry_groups(e)
                if not groups:
                    return
                e["attempted"].update(groups)
            self.metrics.count("hedgedRequests")
            attempt_counts["hedges"] += 1
            for inst2, segs2 in groups.items():
                submit_attempt(e, inst2, segs2, kind="hedge")

        timers = []
        if hedging:
            for e in entries:
                fixed = self.hedge_delay_s
                delay = fixed if fixed > 0 else self.latency.p90_s(e["inst"])
                delay = max(0.005, min(delay, deadline.remaining_s() * 0.5))
                t = threading.Timer(delay, maybe_hedge, args=(e,))
                t.daemon = True
                t.start()
                timers.append(t)

        results, exceptions = [], []
        query_errors = []
        server_traces = {}
        server_roofline = []  # per-flight roofline records, instance-tagged
        responded = set()  # instances whose response was USED
        attempted_all = set()

        def harvest(e):
            """Resolve one entry within the deadline → (successes, errors)
            where successes is a list of (parts, inst) whose segment
            coverage is DISJOINT (no segment reduced twice even when both
            a primary and its hedge answered) and errors is the
            unrecovered (errorCode, message) list — empty when the entry
            was fully served."""
            retried = False
            errors = []  # (errorCode, message) — dropped if fully served
            successes = []  # (covered frozenset, parts, inst)
            all_segs = frozenset(e["segs"])

            def resolved():
                """Disjoint success subset covering the whole entry, or
                None. A single full-coverage attempt (primary or hedge)
                wins outright; split retries compose by disjoint union."""
                full = next((s for s in successes if s[0] >= all_segs),
                            None)
                if full is not None:
                    return [full]
                chosen, covered = [], set()
                for s in successes:
                    if not (s[0] & covered):
                        chosen.append(s)
                        covered |= s[0]
                return chosen if covered >= all_segs else None

            def best_partial():
                """Maximal disjoint subset when full coverage is out of
                reach (partialResult: honest parts + honest exceptions)."""
                chosen, covered = [], set()
                for s in successes:
                    if not (s[0] & covered):
                        chosen.append(s)
                        covered |= s[0]
                return chosen

            def try_retry():
                nonlocal retried
                if not self.retry_enabled or retried or deadline.expired():
                    return
                groups = retry_groups(e)
                if not groups:
                    return
                retried = True
                self.metrics.count("retriedRequests")
                attempt_counts["retries"] += 1
                with entries_lock:
                    e["attempted"].update(groups)
                for inst2, segs2 in groups.items():
                    submit_attempt(e, inst2, segs2, kind="retry")

            def finish(done):
                """Cancel/ignore still-pending attempts, settle errors.
                Attempts that can no longer be cancelled (already
                running — e.g. the blackholed loser of a won hedge race)
                still report their eventual outcome to the failure
                detector, so a dead replica doesn't stay HEALTHY just
                because a hedge always wins first."""
                with entries_lock:
                    futs = list(e["futs"])
                for f, i, _s, _k in futs:
                    if id(f) in e["consumed"]:
                        continue
                    if f.cancel():
                        # the attempt never ran: if its routing claimed a
                        # half-open probe slot, free it — no outcome will
                        self.failures.release_probe(i)
                    else:
                        f.add_done_callback(
                            lambda _f, _i=i: self._note_abandoned(_f, _i))
                if done is not None:
                    if errors:
                        # a replica answered after a failure: recovered —
                        # the result is complete, no partialResult
                        self.metrics.count("recoveredRequests")
                    return [(s[1], s[2], s[3]) for s in done], []
                return [(s[1], s[2], s[3]) for s in best_partial()], errors

            while True:
                with entries_lock:
                    futs = list(e["futs"])
                ready = [t for t in futs
                         if t[0].done() and id(t[0]) not in e["consumed"]]
                if not ready:
                    done = resolved()
                    if done is not None:
                        return finish(done)
                    live = [t for t in futs if id(t[0]) not in e["consumed"]]
                    if not live:
                        return finish(None)  # every attempt consumed
                    left = deadline.remaining_s()
                    if left <= 0:
                        # budget gone with attempts still in flight:
                        # typed QUERY_TIMEOUT per pending instance — the
                        # broker answers within deadline + grace, never
                        # hangs on a straggler
                        errors.extend(
                            (250, f"QUERY_TIMEOUT: {i} did not respond "
                                  f"within the {timeout_s * 1e3:.0f}ms "
                                  f"query budget")
                            for _f, i, _s, _k in live)
                        return finish(None)
                    e["ev"].wait(min(left, 0.25))
                    e["ev"].clear()
                    continue
                for fut, inst, segs_of, kind in ready:
                    e["consumed"].add(id(fut))
                    if fut.cancelled():
                        continue
                    try:
                        parts = fut.result()
                    except NoSegmentsHosted:
                        # benign routing/sync race: segments moved between
                        # the external-view read and the RPC; not a
                        # failure — the attempt's share counts covered
                        self.failures.mark_success(inst)
                        successes.append((segs_of, [], inst, kind))
                        continue
                    except QueryTimeoutError as exc:
                        # server-side typed timeout: the server is healthy,
                        # the budget just ran out there
                        self.failures.mark_success(inst)
                        errors.append((250, f"{inst}: {exc}"))
                        continue  # a hedge may still win
                    except ServerShuttingDown as exc:
                        # retriable by contract: the submit was rejected
                        # before any execution touched the data
                        self.failures.mark_failure(inst)
                        errors.append(
                            (427, f"SERVER_NOT_RESPONDING: {inst}: {exc}"))
                        try_retry()
                        continue
                    except ServerQueryError as exc:
                        # query-level error (bad column etc.): the server
                        # is healthy; report in-band, don't poison the
                        # detector, and don't retry — a replica would fail
                        # identically
                        self.failures.mark_success(inst)
                        query_errors.append(
                            {"errorCode": 200, "message": f"{inst}: {exc}"})
                        return finish(None)
                    except Exception as exc:  # noqa: BLE001 — transport
                        self.failures.mark_failure(inst)
                        errors.append(
                            (427, f"SERVER_NOT_RESPONDING: {inst}: {exc}"))
                        try_retry()
                        continue
                    self.failures.mark_success(inst)
                    successes.append((segs_of, parts, inst, kind))
                done = resolved()
                if done is not None:
                    return finish(done)

        with span("broker.scatter_gather"), self.metrics.timed("scatterMs"):
            for e in entries:
                served, errs = harvest(e)
                attempted_all |= e["attempted"]
                exceptions.extend(
                    {"errorCode": code, "message": msg}
                    for code, msg in errs)
                for parts, inst, kind in served:
                    # traceInfo keyed by instance, retry/hedge attempts
                    # tagged; a server answering several entries (hybrid
                    # split, split retries) MERGES its span lists — no
                    # duplicate and no dropped server spans
                    tkey = inst if kind == "primary" else f"{inst} ({kind})"
                    for r in parts:
                        if r.trace is not None:
                            server_traces.setdefault(tkey, []).extend(r.trace)
                        # roofline flight records: instance-
                        # tagged for EXPLAIN ANALYZE / the query log
                        for rec in getattr(r, "roofline", None) or ():
                            server_roofline.append(
                                {**rec, "instance": tkey})
                        # piggybacked load + freshness: feed
                        # the decayed load score and the result cache's
                        # per-table epoch view BEFORE stats merge away
                        # the per-instance values
                        st = r.stats
                        if st.server_pressure >= 0 or st.server_inflight >= 0:
                            self.routing.loads.observe(
                                inst, max(0, st.server_pressure),
                                max(0, st.server_inflight))
                        self._note_epoch(e["phys"], inst, st.table_epoch)
                        if st.table_epoch is not None and \
                                st.table_epoch > own_epochs.get(inst, -1):
                            own_epochs[inst] = st.table_epoch
                        results.append(r)
                    if parts:
                        responded.add(inst)
        for t in timers:
            t.cancel()
        if any(x["errorCode"] == 250 for x in exceptions):
            self.metrics.count("queryTimeouts")
        if query_errors:
            return {"exceptions": query_errors}
        if not results:
            self.metrics.count("serverFailures", len(exceptions))
            if any(x["errorCode"] == 250 for x in exceptions):
                # nothing answered before the budget expired: a typed
                # in-band QUERY_TIMEOUT response, delivered promptly —
                # not an opaque ConnectionError after N server waits
                resp_timeout = {
                    "exceptions": exceptions,
                    "partialResult": True,
                    "numServersQueried": len(n_servers | attempted_all),
                    "numServersResponded": len(responded),
                    "numRetries": attempt_counts["retries"],
                    "numHedges": attempt_counts["hedges"],
                    "numReplicaGroupsQueried": rg_queried,
                    "requestId": request_id,
                }
                if rg_load_score is not None:
                    resp_timeout["loadScore"] = rg_load_score
                    resp_timeout["replicaGroup"] = rg_name
                return resp_timeout
            raise ConnectionError(f"all servers failed: {exceptions}")

        with span("broker.reduce"):
            merged = merge_intermediates(q, results)
            table = finalize(q, merged)
        resp = table.to_json()
        if server_traces:
            resp["traceInfo"] = server_traces
        stats = merged.stats
        resp.update(
            {
                "exceptions": exceptions,
                # a cold-tier segment answered as an in-flight partial:
                # the rows are honest-but-incomplete, so the response is
                # partial (which also keeps it OUT of the result cache)
                "partialResult": bool(exceptions)
                or stats.num_segments_cold > 0,
                # queried counts every instance the broker dispatched to
                # (primary fan-out + retries + hedges); responded counts
                # the instances whose answers the reduce actually used
                "numServersQueried": len(n_servers | attempted_all),
                "numServersResponded": len(responded),
                "numRetries": attempt_counts["retries"],
                "numHedges": attempt_counts["hedges"],
                # replica-group routing attribution: groups
                # touched + the chosen group's load score at pick time
                "numReplicaGroupsQueried": rg_queried,
                "numDocsScanned": stats.num_docs_scanned,
                "numEntriesScannedInFilter": stats.num_entries_scanned_in_filter,
                "numEntriesScannedPostFilter": stats.num_entries_scanned_post_filter,
                "numSegmentsQueried": stats.num_segments_queried,
                "numSegmentsPrunedByBroker": num_pruned,
                "numSegmentsPrunedByValue": num_pruned_value,
                "numSegmentsPrunedByServer": stats.num_segments_pruned,
                "numBlocksPruned": stats.num_blocks_pruned,
                # cold-tier segments served as honest in-flight partials
                # while their deep-store hydration proceeds —
                # non-zero means a repeat of this query will cover more
                "numSegmentsCold": stats.num_segments_cold,
                "numSegmentsProcessed": stats.num_segments_processed,
                "numSegmentsMatched": stats.num_segments_matched,
                "totalDocs": stats.total_docs,
                "numGroupsLimitReached": stats.num_groups_limit_reached,
                # any server partial answered from its device partials
                # cache (sub-RTT serving; querylog --per-template
                # aggregates this into per-template hit rates)
                "partialsCacheHit": stats.partials_cache_hit,
                # summed across servers, like the reference's V3 metadata
                "threadCpuTimeNs": stats.thread_cpu_time_ns,
                "schedulerWaitMs": round(stats.scheduler_wait_ms, 3),
                # kernel roofline accounting, summed across
                # server partials; the per-flight detail rides "roofline"
                "deviceBytesMoved": stats.device_bytes_moved,
                "deviceKernelMs": round(stats.device_kernel_ms, 3),
                "deviceLinkMs": round(stats.device_link_ms, 3),
                "requestId": request_id,
            }
        )
        if server_roofline:
            resp["roofline"] = server_roofline
        if stats.advisor_decisions:
            # plan-advisor stamps: the decisions the answering
            # servers' launches ran with, deduped by the stats merge
            resp["advisorDecisions"] = list(stats.advisor_decisions)
        if rg_load_score is not None:
            resp["loadScore"] = rg_load_score
            resp["replicaGroup"] = rg_name
        # internal side channel for the result cache's put (stripped by
        # execute before the response leaves the broker)
        resp["__epochView__"] = own_epochs
        return resp
