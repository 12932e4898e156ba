"""Server role: segment hosting + per-segment query execution.

Equivalent of the reference's server stack (pinot-server/: BaseServerStarter
wiring InstanceDataManager + QueryExecutor + transport, ServerInstance.java:
79-128; the Helix OFFLINE→ONLINE/CONSUMING state model,
SegmentOnlineOfflineStateModelFactory.java:75-235) — re-shaped for the
registry's level-triggered model: a sync loop reconciles locally-loaded
segments against the registry's assignment (download/load new, unload
removed), replacing push-based Helix state transitions, and starts stream
consumers for assigned realtime partitions.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from pinot_tpu_torch.cluster.registry import (
    ClusterRegistry,
    InstanceInfo,
    Role,
    SegmentRecord,
    SegmentState,
)
from pinot_tpu_torch.common import faults
from pinot_tpu_torch.common.deadline import Deadline, QueryTimeout
from pinot_tpu_torch.engine.datatable import encode, encode_error
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.reduce import trim_group_by
from pinot_tpu_torch.engine.scheduler import (
    SchedulerSaturated,
    make_scheduler,
)
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.sql.compiler import compile_query
from pinot_tpu_torch.storage.segment import ImmutableSegment
from pinot_tpu_torch.transport.grpc_transport import QueryServerTransport, parse_instance_request

log = logging.getLogger("pinot_tpu_torch.server")


def _apply_request_overrides(q, req: dict):
    """Physical-table override + the hybrid time-boundary predicate from
    the instance request, shared by the unary and streaming paths (dropping
    the timeFilter on either path double-reads the hybrid overlap)."""
    import dataclasses

    from pinot_tpu_torch.query.context import (
        Expression,
        FilterNode,
        Predicate,
        PredicateType,
    )

    if req.get("table"):
        q = dataclasses.replace(q, table_name=req["table"])
    tf = req.get("timeFilter")
    if tf:
        pred = Predicate(
            PredicateType.RANGE, Expression.identifier(tf["column"]),
            upper=tf["value"] if tf["op"] == "le" else None,
            lower=tf["value"] if tf["op"] == "gt" else None,
            lower_inclusive=False,
        )
        node = FilterNode.pred(pred)
        new_filter = node if q.filter is None else FilterNode.and_(q.filter, node)
        q = dataclasses.replace(q, filter=new_filter)
    return q


def _hbm_peak_if_probed():
    """Scrape-safe HBM-peak gauge (ops/roofline.py): the cached probe
    value or None — never triggers the measurement from a metrics poll."""
    from pinot_tpu_torch.ops import roofline

    return roofline.peak_if_probed()


class ServerInstance:
    def __init__(self, instance_id: str, registry: ClusterRegistry,
                 data_dir: str, host: str = "127.0.0.1", port: int = 0,
                 sync_interval_s: float = 0.2, device=None,
                 max_concurrent_queries: int = 8, max_queued_queries: int = 32,
                 group_trim_size: int = 5000, scheduler_name: str = None,
                 tls="auto", tags=(), compile_concurrency: int = None,
                 tier_overrides: dict = None,
                 exchange_buffer_bytes: int = None):
        self.instance_id = instance_id
        self.registry = registry
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        # the port's engine on ``device``: the CUDA card unless the
        # caller asks for "cpu" (there is no host-only engine)
        self.engine = QueryEngine(device=device, host_name=instance_id)
        # transport threads must cover running + queued queries, or requests
        # queue invisibly in grpc's executor and time out as transport
        # failures (poisoning the broker's failure detector) before the
        # scheduler's in-band rejection can ever fire
        if tls == "auto":
            from pinot_tpu_torch.common.tls import TlsConfig

            tls = TlsConfig.from_config()
        from pinot_tpu_torch.server.peer import serve_segment_tar

        self.transport = QueryServerTransport(
            self._handle_submit, host=host, port=port,
            max_workers=max_concurrent_queries + max_queued_queries + 2,
            submit_streaming_fn=self._handle_submit_streaming,
            fetch_segment_fn=lambda req: serve_segment_tar(self, req),
            execute_stage_fn=self._handle_execute_stage,
            exchange_transfer_fn=self._handle_exchange_transfer,
            tls=tls,
        )
        self._tls = tls
        # distributed stage-2 mailboxes ( query2/exchange.py):
        # per-exchange receive buffers with a byte ceiling past which
        # payloads spill to mmap'd .npy files under the data dir (the
        # warm-tier spill idea) — the test knob ``exchange_buffer_bytes``
        # simulates a build side exceeding one process's RAM budget
        from pinot_tpu_torch.query2.exchange import ExchangeRegistry

        self.exchange_buffer_bytes = int(
            exchange_buffer_bytes if exchange_buffer_bytes is not None
            else os.environ.get("PINOT_TPU_EXCHANGE_BUFFER_BYTES",
                                256 << 20))
        self.exchanges = ExchangeRegistry(
            os.path.join(data_dir, "exchange_spill"),
            self.exchange_buffer_bytes)
        # server→server transfer channels, one per peer endpoint (the
        # broker's per-instance channel pool pattern); closed in stop()
        self._peer_channels: dict = {}
        self._peer_lock = threading.Lock()
        self.sync_interval_s = sync_interval_s
        from pinot_tpu_torch.common.config import Configuration

        conf = Configuration()
        if scheduler_name is None:
            # config-selected like the reference's
            # pinot.server.query.scheduler.name (fcfs | tokenbucket)
            scheduler_name = conf.get(
                "pinot.server.query.scheduler.name", "fcfs")
        # graceful-shutdown drain window (the reference's
        # pinot.server.shutdown.timeout.ms shutdown hook): stop() rejects
        # NEW submits immediately (SERVER_SHUTTING_DOWN — retriable at the
        # broker) and waits up to this long for in-flight queries to drain
        self.drain_timeout_s = conf.get_float(
            "pinot.server.shutdown.drain.timeout.ms", 10_000.0) / 1e3
        # adopt-path peer-fetch retry window + per-attempt peer download
        # timeout (previously hardcoded 10 s / 60 s)
        self.peer_retry_timeout_s = conf.get_float(
            "pinot.server.segment.peer.retry.timeout.ms", 10_000.0) / 1e3
        self.peer_download_timeout_s = conf.get_float(
            "pinot.server.segment.peer.download.timeout.ms", 60_000.0) / 1e3
        # registry heartbeat cadence (load + freshness view), decoupled
        # from the (faster) segment-sync tick — see _sync_loop
        self.heartbeat_interval_s = conf.get_float(
            "pinot.server.heartbeat.interval.ms", 2_000.0) / 1e3
        # per-segment access-temperature telemetry (server/heat.py): decayed
        # access/bytes counters updated on every query, piggybacked in the
        # heartbeat like scheduler pressure and aggregated at the controller
        # (/tables/{t}/heat) — the input the tier lifecycle's
        # promotion/demotion policy (server/tiering.py) consumes
        from pinot_tpu_torch.server.heat import SegmentHeatTracker

        self.heat = SegmentHeatTracker(
            half_life_s=conf.get_float(
                "pinot.server.heat.halflife.ms", 300_000.0) / 1e3,
            max_entries=int(conf.get_float(
                "pinot.server.heat.max.segments", 8192)))
        self.heat_top_per_table = int(conf.get_float(
            "pinot.server.heat.heartbeat.top.segments", 32))
        # tiered segment lifecycle ( server/tiering.py): the
        # TierManager consumes the heat tracker's UNCAPPED iter_all plus
        # the device batch hit/miss counters and drives hot/warm/cold
        # transitions from the sync loop; opt-in
        # (pinot.server.tier.enabled) so tier-less deployments keep the
        # all-hot behavior byte-for-byte
        from pinot_tpu_torch.server.tiering import TierManager

        self.tiers = TierManager(self, overrides=tier_overrides)
        self._last_serving = None  # last published ExternalView payload
        self._shutting_down = False
        self._inflight_queries = 0
        self._inflight_cond = threading.Condition()
        self.scheduler = make_scheduler(
            scheduler_name, max_concurrent=max_concurrent_queries,
            max_queued=max_queued_queries)
        # pre-admission compile bound: SQL compiles on the gRPC transport
        # thread BEFORE scheduler admission (group/timeout come from the
        # compiled context), previously limited only by grpc max_workers —
        # a saturated server could burn every transport thread parsing
        # queries it would then reject
        self._compile_sem = threading.BoundedSemaphore(
            compile_concurrency if compile_concurrency is not None
            else max(2, max_concurrent_queries))
        self._compile_timeout_s = 5.0
        # launch coalescer gate: micro-batch windows open only under real
        # scheduler pressure (engine/inflight.py LaunchCoalescer)
        dev = getattr(self.engine, "device", None)
        if dev is not None and getattr(dev, "coalescer", None) is not None:
            dev.coalescer.pressure_fn = self.scheduler.pressure
        self.group_trim_size = group_trim_size
        from pinot_tpu_torch.common.metrics import get_metrics

        self.metrics = get_metrics("server")
        # every callable gauge this instance registers is TRACKED so
        # stop() can unregister the lot — get_metrics registries are
        # process-global, and a forgotten gauge closure pins the stopped
        # instance (and its segments) forever while reporting stale
        # values for a restarted one (the lifecycle audit)
        self._registered_gauges: list = []
        self._register_gauge("segmentsLoaded", lambda: sum(
            len(t.segments) for t in self.engine.tables.values()))
        self._register_gauge("schedulerRejected",
                             lambda: self.scheduler.num_rejected)
        # temperature + roofline gauges: tracked segments and
        # the per-process HBM peak (None until the first accounted device
        # flight probes it — a metrics scrape never spends device time)
        self._register_gauge("heatTrackedSegments",
                             lambda: self.heat.size())
        self._register_gauge("hbmPeakGbps", _hbm_peak_if_probed)
        # HBM / batch-LRU accounting (DeviceExecutor.hbm_stats): resident
        # bytes, cache traffic, and bytes the width planning saved — the
        if self.tiers.enabled:
            # tier lifecycle visibility (registered only on tiering
            # servers — same no-churn rule as the result-cache gauges)
            self._register_gauge(
                "tierColdSegments",
                (lambda _t=self.tiers: _t.stats()["cold_segments"]))
            self._register_gauge(
                "tierHydrations",
                (lambda _t=self.tiers: _t.hydrations))
            self._register_gauge(
                "tierDemotions",
                (lambda _t=self.tiers: _t.demotions_warm
                 + _t.demotions_cold))
        # HBM / batch-LRU accounting (DeviceExecutor.hbm_stats): resident
        # bytes, cache traffic, and bytes the width planning saved — the
        # operational view of the width narrowing (a shrinking
        # deviceNarrowSavedBytes alongside rising evictions means batches
        # stopped fitting)
        if dev is not None:
            # the device-reduce trim and the server's host trim must keep
            # ONE policy bound (engine/reduce.py trim_bound)
            dev.group_trim_size = group_trim_size
            # counters are plain executor ints (GIL-atomic reads); only
            # the byte gauges walk the batch list — one lightweight sum
            # each, not a full hbm_stats() snapshot 5x per scrape
            for gname, attr in (("deviceBatchHits", "batch_hits"),
                                ("deviceBatchMisses", "batch_misses"),
                                ("deviceBatchEvictions", "batch_evictions"),
                                ("deviceLaunchFailures", "launch_failures"),
                                # device partials cache (sub-RTT serving):
                                # repeat-query hit traffic + resident
                                # bytes the cached packed buffers pin
                                ("devicePartialsCacheBytes",
                                 "partials_bytes"),
                                ("devicePartialsCacheHits", "partials_hits"),
                                ("devicePartialsCacheMisses",
                                 "partials_misses"),
                                ("devicePartialsCacheEvictions",
                                 "partials_evictions")):
                self._register_gauge(
                    gname, (lambda _a=attr, _d=dev: getattr(_d, _a)))
            self._register_gauge(
                "deviceResidentBytes",
                (lambda _d=dev: _d.resident_bytes()))
            self._register_gauge(
                "deviceNarrowSavedBytes",
                (lambda _d=dev: _d.narrow_saved_bytes()))
            # quarantine breaker visibility: pipelines the device-error
            # recovery has routed to host (a non-zero value alongside
            # rising deviceLaunchFailures = a poisoned template/batch)
            self._register_gauge(
                "deviceQuarantinedPipelines",
                (lambda _d=dev: _d.hbm_stats()["quarantined_pipelines"]))
        self._stop = threading.Event()
        self._sync_thread: Optional[threading.Thread] = None
        self._realtime_managers: dict = {}  # table -> RealtimeTableDataManager
        self.queries_served = 0
        self.tags = tuple(tags)  # tier placement tags (Helix tag analog)

    def _register_gauge(self, name: str, fn) -> None:
        """Callable gauge tagged with this instance id, recorded for
        symmetric teardown in stop() (removeGauge-on-shutdown audit)."""
        self.metrics.gauge(name, fn, tag=self.instance_id)
        self._registered_gauges.append(name)

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self.transport.start()
        from pinot_tpu_torch.common.environment import failure_domain_tag

        tags = list(self.tags)
        fd_tag = failure_domain_tag()
        if fd_tag and fd_tag not in tags:
            tags.append(fd_tag)  # assigner spreads replicas across domains
        self.registry.register_instance(
            InstanceInfo(self.instance_id, Role.SERVER,
                         host=self.transport.host, grpc_port=self.transport.port,
                         tags=tags)
        )
        self._sync_once()  # load assigned segments before serving
        self._sync_thread = threading.Thread(
            target=self._sync_loop, name=f"sync-{self.instance_id}", daemon=True
        )
        self._sync_thread.start()

    def stop(self, drain_timeout_s: float = None) -> None:
        """Graceful shutdown: reject NEW submits immediately with a
        retriable SERVER_SHUTTING_DOWN (the broker re-routes their
        segment lists to replicas), then drain in-flight queries for up
        to the configured window
        (``pinot.server.shutdown.drain.timeout.ms``; the old behavior
        was an unconditional hard stop) before tearing transport down."""
        drain = self.drain_timeout_s if drain_timeout_s is None \
            else drain_timeout_s
        self._shutting_down = True
        drain_deadline = time.monotonic() + max(0.0, drain)
        with self._inflight_cond:
            while self._inflight_queries > 0:
                left = drain_deadline - time.monotonic()
                if left <= 0:
                    log.warning(
                        "shutdown drain window (%.1fs) elapsed with %d "
                        "queries in flight", drain, self._inflight_queries)
                    break
                self._inflight_cond.wait(min(left, 0.1))
        self._stop.set()
        # drop EVERY callable gauge this instance registered (tracked in
        # _register_gauge): their closures would otherwise pin this
        # instance (and its loaded segments) in the process-global
        # registry, and a restarted same-id instance would alias them
        for gname in self._registered_gauges:
            self.metrics.remove_gauge(gname, tag=self.instance_id)
        self._registered_gauges = []
        if self._sync_thread is not None:
            self._sync_thread.join(5)
        self.tiers.stop()
        for mgr in self._realtime_managers.values():
            mgr.stop(commit_remaining=False)
        self.transport.stop()
        self.exchanges.close()
        with self._peer_lock:
            peers, self._peer_channels = \
                list(self._peer_channels.values()), {}
        for ch in peers:
            try:
                ch.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.registry.drop_instance(self.instance_id)

    # ---- query path ------------------------------------------------------
    @staticmethod
    def _request_deadline(req: dict, q=None):
        """Per-query Deadline. The broker-shipped REMAINING budget
        (``timeoutMs`` in the instance request — what the broker had left
        at send time) wins; ``SET timeoutMs`` from the compiled options
        covers direct/embedded submits that never crossed a broker. Every
        downstream wait (compile semaphore, scheduler admission, device
        fetch, host fallback gate) is bounded by it and aborts with a
        typed QUERY_TIMEOUT instead of running to completion after the
        client gave up. None = no budget."""
        v = req.get("timeoutMs")
        if v is None and q is not None:
            v = q.options_ci().get("timeoutms")
        if v is None:
            return None
        return Deadline.after_ms(max(1.0, float(v)))

    @staticmethod
    def _scheduler_group(q, req: dict) -> str:
        """Tenant key for token-bucket priority. The broker-resolved
        WORKLOAD (auth principal / SET workloadName) wins when
        the instance request carries one, so the server's weighted-fair
        slot accounting isolates TENANTS, not just tables. Fallback: the
        COMPILED table name (TableBasedGroupMapper analog) — a regex over
        raw SQL would let a literal containing " FROM x" misattribute the
        query to the wrong bucket. Normalized (lowercase, physical-type
        suffix stripped) so offline/realtime halves of one table share
        ONE bucket — distinct raw strings would each mint a fresh
        full-burst group and defeat fairness."""
        wl = req.get("workload")
        if wl:
            return f"tenant:{str(wl).lower()}"
        name = (req.get("table") or q.table_name or "default").lower()
        for suffix in ("_offline", "_realtime"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        return name

    @staticmethod
    def _scheduler_weight(q, req: dict) -> float:
        """Weighted-fair slot weight from the request's priority class
        (broker-stamped; SET priorityClass covers direct submits).
        Unknown/absent class = weight 1.0 — today's behavior exactly."""
        from pinot_tpu_torch.engine.scheduler import PRIORITY_WEIGHTS

        prio = req.get("priority") or q.options_ci().get("priorityclass")
        return PRIORITY_WEIGHTS.get(str(prio), 1.0) if prio else 1.0

    def _compile_admitted(self, sql: str, deadline: Deadline = None):
        """SQL compile bounded by a small semaphore: compile
        runs pre-admission on the transport thread, so without a bound a
        saturated server burns unbounded CPU parsing queries it will
        reject. The semaphore wait ships as the ``compileQueueMs`` timer;
        waiting out the bound is a scheduling rejection, not a server
        fault — unless the query's own deadline expired first, which is a
        QUERY_TIMEOUT."""
        t0 = time.perf_counter()
        wait_s = self._compile_timeout_s if deadline is None \
            else deadline.clamp(self._compile_timeout_s)
        if not self._compile_sem.acquire(timeout=wait_s):
            if deadline is not None and deadline.expired():
                raise QueryTimeout(
                    "QUERY_TIMEOUT at compile admission: budget exhausted "
                    "waiting for a compile slot")
            raise SchedulerSaturated(
                f"compile queue full (no compile slot within "
                f"{self._compile_timeout_s}s)")
        try:
            self.metrics.time_ms(
                "compileQueueMs", (time.perf_counter() - t0) * 1e3)
            return optimize_query(compile_query(sql))
        finally:
            self._compile_sem.release()

    def _handle_submit(self, request: bytes) -> bytes:
        """Unary query submit, split into a LAUNCH phase under the
        scheduler slot (compile → admission → segment acquire → device
        dispatch + host partials) and a FETCH phase AFTER the slot is
        released (the blocking device_get link wait + trim + encode):
        N concurrent queries overlap their host↔device round trips
        instead of holding N slots through them
        (engine.execute_segments_async / engine/inflight.py).

        The ``queries`` metric counts at RECEIVE time, before SQL compile,
        so ``queryErrors`` (which a parse error increments) can never
        exceed ``queries`` on the dashboard. Compile runs BEFORE admission
        — the scheduler group and timeout come from the compiled context,
        and a parse error must not burn a concurrency slot — bounded by
        the compile semaphore (_compile_admitted).

        Shutdown drain: once stop() flips ``_shutting_down``, new submits
        are rejected immediately with a retriable SERVER_SHUTTING_DOWN
        (the broker re-routes them to replicas) while queries already
        counted in ``_inflight_queries`` drain inside the configured
        window."""
        req = parse_instance_request(request)
        with self._inflight_cond:
            if self._shutting_down:
                self.metrics.count("queriesRejected")
                return encode_error(
                    "server_shutting_down",
                    f"SERVER_SHUTTING_DOWN: {self.instance_id} is "
                    f"draining for shutdown")
            self._inflight_queries += 1
        try:
            return self._submit_inner(req)
        finally:
            with self._inflight_cond:
                self._inflight_queries -= 1
                self._inflight_cond.notify_all()

    def _submit_inner(self, req: dict) -> bytes:
        from pinot_tpu_torch.common import trace

        deadline = self._request_deadline(req)
        # broker-stamped tracing (traceEnabled + traceId ride the
        # instance request, retries/hedges included): the tracer exists
        # BEFORE compile so the compile phase itself is a span. A direct
        # submit that only carries SET trace=true in its SQL gets its
        # tracer after compile (no compile span) in _handle_submit_launch.
        tracer = trace.Tracer(req.get("traceId")) \
            if req.get("traceEnabled") else None
        try:
            self.metrics.count("queries")
            with trace.span("server.compile", tracer):
                q = self._compile_admitted(req["sql"], deadline)
            if deadline is None:
                # no broker-shipped budget: fall back to SET timeoutMs
                # from the now-compiled options (embedded submits)
                deadline = self._request_deadline(req, q)
            # NOTE: the latency timer lives inside the launch/fetch pair —
            # wrapping the scheduler here would fold rejection queue-waits
            # into server.query and poison latency dashboards under load
            if faults.ACTIVE:
                # scheduler.admit chaos seam: starve admission
                # deterministically — an injected error is a typed
                # scheduling rejection (the server is healthy; the broker
                # must see the same QUERY_SCHEDULING_TIMEOUT shape a real
                # full queue produces, never a transport fault or a hang)
                try:
                    faults.inject("scheduler.admit",
                                  target=self.instance_id,
                                  bound_ms=None if deadline is None
                                  else deadline.remaining_ms())
                except faults.FaultInjected as e:
                    raise SchedulerSaturated(
                        f"admission starved (injected): {e}") from e
            acct: dict = {}
            finish = self.scheduler.run(
                lambda: self._handle_submit_launch(req, q, acct, deadline,
                                                   tracer),
                queue_timeout_s=None if deadline is None
                else max(0.001, deadline.remaining_s()),
                group=self._scheduler_group(q, req),
                stats_out=acct,
                weight=self._scheduler_weight(q, req))
            # slot released: the link wait below must not hold admission
            return finish()
        except faults.FaultInjected:
            # injected server crash: escape the in-band error path — the
            # RPC must die at the transport level, like a process kill
            raise
        except QueryTimeout as e:
            # the propagated deadline expired at one of the waits: typed
            # in-band partial (errorCode 250 shape); the server is healthy
            self.metrics.count("queryTimeouts")
            return encode_error("query_timeout", str(e))
        except SchedulerSaturated as e:
            if deadline is not None and deadline.expired():
                self.metrics.count("queryTimeouts")
                return encode_error(
                    "query_timeout",
                    f"QUERY_TIMEOUT at scheduler admission: {e}")
            # admission rejection is a query-level error: the server is
            # healthy (broker must not poison its failure detector)
            self.metrics.count("queriesRejected")
            return encode_error("query_error", f"QUERY_SCHEDULING_TIMEOUT: {e}")
        except Exception as e:  # noqa: BLE001 — query errors ship in-band
            self.metrics.count("queryErrors")
            return encode_error("query_error", f"{type(e).__name__}: {e}")

    def _handle_submit_launch(self, req: dict, q, acct: dict = None,
                              deadline: Deadline = None, tracer=None):
        """LAUNCH phase (runs under the scheduler slot) → zero-arg FETCH
        closure the transport thread invokes after the slot is released.
        Segment refs, the latency timer, and the tracer span BOTH phases;
        cleanup lives in the closure's finally (launch failures clean up
        here and re-raise into the submit error path).

        The tracer is EXPLICIT (common/trace.py): it was minted in
        _submit_inner from the broker-stamped traceEnabled/traceId (or
        here, for direct submits whose SQL says SET trace=true) and rides
        by reference through the engine, the device launch handles, and
        the fetch closure — the launch/fetch thread split and
        coalesced cohorts record onto the right query's trace."""
        import time as _time

        from pinot_tpu_torch.common import trace
        from pinot_tpu_torch.common.trace import span

        t_cpu = _time.thread_time_ns()
        # "queries" was already counted at receive time (_handle_submit),
        # before compile/admission
        timer = self.metrics.timed("query")
        timer.__enter__()
        if tracer is None and q.options_ci().get("trace"):
            tracer = trace.Tracer(req.get("traceId"))
        if tracer is not None and acct:
            # the scheduler published its admission wait before running
            # this fn — back-fill it as the queue phase
            tracer.add_ms("server.queue", acct.get("scheduler_wait_ms", 0.0))
        tdm, acquired = None, []

        def cleanup():
            if tdm is not None:
                tdm.release(acquired)
            timer.__exit__()

        try:
            q = _apply_request_overrides(q, req)
            tdm = self.engine.tables.get(q.table_name)
            wanted = set(req["segments"])
            acquired = [] if tdm is None else tdm.acquire()
            segments = [s for s in acquired if s.name in wanted]
            if not segments:
                # benign routing race (segments moved since the broker's
                # external-view read): broker skips this partial
                err = encode_error(
                    "no_segments",
                    f"server {self.instance_id} hosts none of the "
                    f"requested segments for table {q.table_name!r}",
                )

                def finish_missing():
                    try:
                        return err
                    finally:
                        cleanup()

                return finish_missing
            # requested-but-missing segments (assignment raced ahead of
            # loading) are simply absent from this partial, like the
            # reference's missing-segment accounting
            if faults.ACTIVE:
                # injected mid-query server crash: segments acquired, the
                # query is "executing" — the raise escapes in-band
                # handling (see _submit_inner) and kills the RPC at the
                # transport level; cleanup() still runs via the
                # BaseException path so the process itself stays sound
                faults.inject("server.crash", target=self.instance_id)
            from pinot_tpu_torch.common import freshness

            # freshness snapshot BEFORE the scan: a mutation landing
            # mid-query must make the recorded epoch look stale to the
            # broker result cache (conservative re-scatter), never stamp
            # pre-mutation rows with the post-mutation epoch
            epoch_at_start = freshness.epoch(q.table_name)
            with span("server.execute", tracer):
                # the fetch-time host fallback (sorted-table overflow) is
                # heavy CPU work on a slot-free thread: re-admit it
                # through the scheduler so a fallback storm can't escape
                # the concurrency cap (saturation rejects it in-band);
                # the admission wait is bounded by the query's REMAINING
                # deadline at gate time, not the original budget
                gate = (lambda fn: self.scheduler.run(
                    fn, queue_timeout_s=None if deadline is None
                    else max(0.001, deadline.remaining_s()),
                    group=self._scheduler_group(q, req),
                    weight=self._scheduler_weight(q, req)))
                fetch_merged = self.engine.execute_segments_async(
                    q, segments, fallback_gate=gate, deadline=deadline,
                    tracer=tracer)
        except BaseException:
            cleanup()
            raise

        def finish() -> bytes:
            try:
                # the blocking link wait lives here, OUTSIDE the slot
                with span("server.fetch", tracer):
                    merged = fetch_merged()
                with span("server.trim", tracer):
                    merged = trim_group_by(q, merged, self.group_trim_size)
                # per-query resource accounting shipped in the partial's
                # stats (the reference's DataTable V3 threadCpuTimeNs
                # metadata); same transport thread runs both phases, so
                # thread_time spans launch + fetch
                merged.stats.thread_cpu_time_ns = \
                    _time.thread_time_ns() - t_cpu
                if acct:
                    merged.stats.scheduler_wait_ms = acct.get(
                        "scheduler_wait_ms", 0.0)
                # load + freshness piggyback: every response
                # carries this server's current pressure/in-flight depth
                # (the broker's load-aware replica-group pick) and the
                # table's freshness epoch as of scan START (the broker
                # result cache's staleness signal)
                merged.stats.server_pressure = self.scheduler.pressure()
                merged.stats.server_inflight = self._inflight_queries
                merged.stats.table_epoch = epoch_at_start
                self.queries_served += 1
                # segment-temperature telemetry: every routed
                # segment of this query heats up — bytes are the
                # rows x referenced-columns x 4 admission-cost proxy
                try:
                    ncols = max(1, len(q.columns()))
                    for s in segments:
                        self.heat.note(
                            q.table_name, s.name,
                            bytes_scanned=int(
                                getattr(s, "n_docs", 0)) * ncols * 4)
                except Exception:  # noqa: BLE001 — telemetry never fails a query
                    log.exception("segment heat accounting failed")
                if tracer is not None:
                    # encode itself can't appear in the trace: the spans
                    # are serialized INTO the payload encode produces.
                    # server.total is the reconciliation denominator —
                    # tracer birth (request entry) to now; the phase
                    # ladder's top-level spans must cover >=90% of it
                    tracer.add_ms("server.total", tracer.elapsed_ms())
                    merged.trace = tracer.to_json()
                return encode(merged)
            finally:
                cleanup()

        return finish

    # ---- distributed stage-2 exchange ( mailbox leapfrog) -------
    def _peer_channel(self, endpoint: str):
        """One cached QueryRouterChannel per peer endpoint for
        ExchangeTransfer sends (the broker's per-instance pool pattern,
        server-side)."""
        with self._peer_lock:
            ch = self._peer_channels.get(endpoint)
            if ch is None:
                from pinot_tpu_torch.transport.grpc_transport import (
                    QueryRouterChannel,
                )

                ch = QueryRouterChannel(endpoint, tls=self._tls)
                self._peer_channels[endpoint] = ch
            return ch

    def _handle_exchange_transfer(self, request: bytes) -> bytes:
        """Receive one exchange payload (or a sender's done marker) into
        the addressed mailbox. Errors answer in-band as {"ok": false} —
        the SENDING server converts that into a typed
        EXCHANGE_TRANSFER_FAILED with peer attribution, so the broker's
        retry can exclude the right instance."""
        import json as _json

        from pinot_tpu_torch.query2 import exchange as ex

        try:
            msg = ex.decode_transfer(request)
            buf = self.exchanges.get_or_create(msg["id"])
            if msg["done"]:
                buf.mark_done(msg["sender"], msg.get("expected") or {})
                ack = {"ok": True, "spilled": False, "softLimit": False}
            else:
                ack = buf.offer(msg["sender"], msg["alias"],
                                msg["partition"], msg["cols"], msg["n"])
                self.metrics.count("exchangeTransfers")
                if ack.get("spilled"):
                    self.metrics.count("exchangeSpills")
            return _json.dumps(ack).encode("utf-8")
        except Exception as e:  # noqa: BLE001 — in-band, sender attributes
            self.metrics.count("exchangeTransferErrors")
            return _json.dumps(
                {"ok": False,
                 "error": f"{type(e).__name__}: {e}"}).encode("utf-8")

    def _handle_execute_stage(self, request: bytes) -> bytes:
        """Run this worker's slice of a DISTRIBUTED stage 2
        (query2/runner.run_exchange_stage): scan routed segments, ship
        hash partitions to their owners, join + partially aggregate the
        owned partitions, answer ONE mergeable DataTable. Same
        shutdown-drain/in-flight accounting and typed error ladder as
        the unary submit; no scheduler slot is held — the exchange
        barrier can wait on PEERS, and a fleet-wide stage parked on
        every server's scheduler would deadlock regular traffic behind
        a slow worker."""
        import json as _json

        from pinot_tpu_torch.query2.exchange import ExchangeTransferError

        req = _json.loads(request.decode("utf-8"))
        with self._inflight_cond:
            if self._shutting_down:
                self.metrics.count("queriesRejected")
                return encode_error(
                    "server_shutting_down",
                    f"SERVER_SHUTTING_DOWN: {self.instance_id} is "
                    f"draining for shutdown")
            self._inflight_queries += 1
        try:
            self.metrics.count("exchangeStages")
            return self._execute_stage_inner(req)
        except faults.FaultInjected:
            # injected crash mode: die at the transport level, like a
            # process kill (matches the unary submit's contract)
            raise
        except QueryTimeout as e:
            self.metrics.count("queryTimeouts")
            return encode_error("query_timeout", str(e))
        except ExchangeTransferError as e:
            # typed with PEER attribution: the broker excludes the
            # implicated instance (not this healthy worker) on retry
            self.metrics.count("queryErrors")
            return encode_error(
                "query_error",
                f"EXCHANGE_TRANSFER_FAILED peer={e.peer}: {e}")
        except Exception as e:  # noqa: BLE001 — stage errors ship in-band
            self.metrics.count("queryErrors")
            return encode_error("query_error", f"{type(e).__name__}: {e}")
        finally:
            with self._inflight_cond:
                self._inflight_queries -= 1
                self._inflight_cond.notify_all()

    def _execute_stage_inner(self, req: dict) -> bytes:
        import json as _json

        from pinot_tpu_torch.common import trace
        from pinot_tpu_torch.query2 import exchange as ex
        from pinot_tpu_torch.query2.logical import compile_plan
        from pinot_tpu_torch.query2.runner import _tdm_for, run_exchange_stage
        from pinot_tpu_torch.sql.parser import parse_sql

        deadline = self._request_deadline(req) or Deadline(30.0)
        tracer = trace.Tracer(req.get("traceId")) \
            if req.get("traceEnabled") else None
        exchange_id = req["exchangeId"]
        endpoints = req["endpoints"]
        owners = {int(p): o for p, o in req["partitionOwners"].items()}
        mailbox = self.exchanges.get_or_create(exchange_id)
        shipped = {"parts": 0, "bytes": 0}

        def send(owner: str, alias: str, partition: int, cols: dict,
                 n: int) -> None:
            if faults.ACTIVE:
                # exchange.transfer chaos seam: targets the RECEIVING
                # instance, so blackholing one server starves every
                # sender addressing it — including its own self-send —
                # and the typed failure names it for the broker's retry
                try:
                    faults.inject("exchange.transfer", target=owner,
                                  bound_ms=deadline.remaining_ms())
                except faults.FaultInjected as e:
                    raise ex.ExchangeTransferError(
                        owner, f"injected transfer fault: {e}") from e
            if owner == self.instance_id:
                # self-offer straight into the local mailbox: no wire,
                # not counted as shipped
                mailbox.offer(self.instance_id, alias, partition, cols, n)
                return
            payload = ex.encode_transfer(
                exchange_id, self.instance_id, alias, partition, cols, n)
            try:
                ch = self._peer_channel(endpoints[owner])
                ack = _json.loads(ch.transfer(
                    payload, timeout_s=max(0.1, deadline.remaining_s())))
            except Exception as e:  # noqa: BLE001 — typed for the broker
                raise ex.ExchangeTransferError(
                    owner, f"transfer to {owner} failed: "
                           f"{type(e).__name__}: {e}") from e
            if not ack.get("ok"):
                raise ex.ExchangeTransferError(
                    owner, f"transfer to {owner} rejected: "
                           f"{ack.get('error')}")
            shipped["parts"] += 1
            shipped["bytes"] += len(payload)
            if ack.get("softLimit"):
                # receiver mailbox running hot: pace the pipe (bounded
                # backpressure, never past the budget)
                time.sleep(min(0.005, max(0.0, deadline.remaining_s())))

        def done() -> None:
            # unary transfers from this thread are ordered, so done-last
            # is a valid completeness marker; each sender ships exactly
            # ONE payload per (alias, partition) — empty included — so
            # the receiver's expected count per slot is always 1
            aliases = list(req["routing"])
            for receiver in sorted(set(owners.values())):
                owned = [p for p, o in owners.items() if o == receiver]
                expected = {a: {str(p): 1 for p in owned}
                            for a in aliases}
                if receiver == self.instance_id:
                    mailbox.mark_done(self.instance_id, expected)
                    continue
                payload = ex.encode_transfer(
                    exchange_id, self.instance_id, "", -1, {}, 0,
                    done=True, expected=expected)
                try:
                    ch = self._peer_channel(endpoints[receiver])
                    ack = _json.loads(ch.transfer(
                        payload,
                        timeout_s=max(0.1, deadline.remaining_s())))
                except Exception as e:  # noqa: BLE001
                    raise ex.ExchangeTransferError(
                        receiver, f"done marker to {receiver} failed: "
                                  f"{type(e).__name__}: {e}") from e
                if not ack.get("ok"):
                    raise ex.ExchangeTransferError(
                        receiver, f"done marker to {receiver} rejected: "
                                  f"{ack.get('error')}")

        def catalog(table: str):
            tdm = _tdm_for(self.engine, table)
            segs = tdm.acquire()
            try:
                if not segs:
                    raise ValueError(f"table {table!r} has no segments")
                cols = tuple(segs[0].column_names())
            finally:
                tdm.release(segs)
            return cols, bool(getattr(tdm, "is_dim_table", False))

        spec = {
            "partitions": int(req["partitions"]),
            "partitionOwners": req["partitionOwners"],
            "senders": list(req["senders"]),
            "selfId": self.instance_id,
            "routing": req["routing"],
        }
        timer = self.metrics.timed("exchangeStage")
        timer.__enter__()
        try:
            with trace.span("server.compile", tracer):
                plan = compile_plan(parse_sql(req["sql"]), catalog)
            with trace.span("server.exchange", tracer):
                merged = run_exchange_stage(
                    self.engine, plan, spec, mailbox, send, done,
                    deadline, ex=self.engine.device)
            merged.stats.exchange_partitions_shipped = shipped["parts"]
            merged.stats.exchange_bytes_shipped = shipped["bytes"]
            merged.stats.exchange_spill_count = mailbox.spill_count
            merged.stats.server_pressure = self.scheduler.pressure()
            merged.stats.server_inflight = self._inflight_queries
            self.metrics.count("exchangeBytesShipped", shipped["bytes"])
            self.queries_served += 1
            if tracer is not None:
                tracer.add_ms("server.total", tracer.elapsed_ms())
                merged.trace = tracer.to_json()
            return encode(merged)
        finally:
            timer.__exit__()
            # the barrier guarantees every peer payload addressed to
            # this worker has arrived before the stage returns, so the
            # mailbox (and its spill files) can be reclaimed here; a
            # broker retry mints a fresh exchange id
            self.exchanges.release(exchange_id)

    # ---- streaming query path (GrpcQueryServer streaming Submit) ---------
    def _handle_submit_streaming(self, request: bytes):
        """Generator: one DataTable block per executed segment, so large
        selection results never materialize whole server-side (the
        reference's streaming operator + StreamingReduceService contract).
        The per-request row budget (offset+limit) stops segment execution
        early — selection without ORDER BY is any-subset semantics."""
        req = parse_instance_request(request)
        with self._inflight_cond:
            rejected = self._shutting_down
            if rejected:
                self.metrics.count("queriesRejected")
            else:
                self._inflight_queries += 1
        if rejected:
            # yield OUTSIDE the condition lock: the generator suspends at
            # the yield while gRPC writes the block, and a slow client
            # must not park the server-wide lock every submit acquires
            yield encode_error(
                "server_shutting_down",
                f"SERVER_SHUTTING_DOWN: {self.instance_id} is "
                f"draining for shutdown")
            return
        try:
            # count at receive time, pre-compile — same invariant as the
            # unary path: queryErrors <= queries even on parse errors;
            # compile rides the same pre-admission semaphore bound
            self.metrics.count("queries")
            deadline = self._request_deadline(req)
            q = self._compile_admitted(req["sql"], deadline)
            if deadline is None:
                deadline = self._request_deadline(req, q)
            yield from self.scheduler.run(
                lambda: self._stream_blocks(req, q, deadline),
                queue_timeout_s=None if deadline is None
                else max(0.001, deadline.remaining_s()),
                group=self._scheduler_group(q, req),
                weight=self._scheduler_weight(q, req),
            )
        except QueryTimeout as e:
            self.metrics.count("queryTimeouts")
            yield encode_error("query_timeout", str(e))
        except SchedulerSaturated as e:
            self.metrics.count("queriesRejected")
            yield encode_error("query_error", f"QUERY_SCHEDULING_TIMEOUT: {e}")
        except Exception as e:  # noqa: BLE001 — in-band, like unary
            self.metrics.count("queryErrors")
            yield encode_error("query_error", f"{type(e).__name__}: {e}")
        finally:
            with self._inflight_cond:
                self._inflight_queries -= 1
                self._inflight_cond.notify_all()

    def _stream_blocks(self, req: dict, q, deadline: Deadline = None):
        """Materialize the block list under the scheduler slot (bounded by
        the row budget), releasing the slot before slow network drain.
        Returning a LIST (not a generator) is load-bearing: the scheduler
        charges wall time and holds the concurrency slot for the duration
        of fn(), so block production stays inside both."""
        q = _apply_request_overrides(q, req)
        if q.aggregations() or q.distinct or q.order_by:
            raise ValueError(
                "streaming submit only serves selection-without-order queries"
            )
        tdm = self.engine.tables.get(q.table_name)
        wanted = set(req["segments"])
        acquired = [] if tdm is None else tdm.acquire()
        encoded = []
        # the most recent block stays UNENCODED until the next one arrives
        # (or the loop ends): the fleet-wide stats stamp lands on the LAST
        # block, and encoding eagerly lets each earlier block's column
        # arrays free as soon as its wire bytes exist — peak RSS is one
        # block's arrays + the encoded tail, not two copies of the result
        pending = None
        try:
            segments = [s for s in acquired if s.name in wanted]
            if not segments:
                return [encode_error(
                    "no_segments",
                    f"server {self.instance_id} hosts none of the requested "
                    f"segments for table {q.table_name!r}",
                )]
            q = self.engine._expand_star(q, segments[0])
            from pinot_tpu_torch.common import freshness

            # pre-scan snapshot, same contract as the unary path
            epoch_at_start = freshness.epoch(q.table_name)
            budget = q.offset + q.limit
            produced = 0
            pruned = 0
            cold = 0
            unexecuted_docs = 0  # pruned/budget-skipped: count toward totalDocs
            remaining = list(segments)
            while remaining:
                if deadline is not None:
                    deadline.check("streaming segment scan")
                seg = remaining.pop(0)
                if getattr(seg, "is_cold", False):
                    # cold tier: honest in-flight partial —
                    # the touch schedules the deep-store hydration, the
                    # stream never blocks on a download
                    cold += 1
                    unexecuted_docs += seg.n_docs
                    touch = getattr(seg, "touch", None)
                    if touch is not None:
                        touch()
                    continue
                if self.engine.pruner.prune(q, seg):
                    pruned += 1
                    unexecuted_docs += seg.n_docs
                    continue
                r = self.engine.execute_segments(q, [seg])
                r.stats.num_segments_queried = 0  # set once on the last block
                produced += len(next(iter(r.rows.values()))) if r.rows else 0
                if pending is not None:
                    encoded.append(encode(pending))
                pending = r
                if produced >= budget:
                    break  # row budget hit: remaining segments unprocessed
            if pending is None:
                from pinot_tpu_torch.engine.engine import _impossible

                base = next((s for s in segments
                             if not getattr(s, "is_cold", False)), None)
                empty = self.engine.execute_segments(
                    _impossible(q),
                    [base if base is not None
                     else segments[0].empty_view()])  # every segment cold
                if base is None:
                    empty.stats.num_segments_processed = 0
                    empty.stats.num_segments_queried = 0
                pending = empty
            # same stats contract as execute_segments: every requested
            # segment counts toward numSegmentsQueried and totalDocs, even
            # when pruning or the row budget skipped its execution
            last = pending.stats
            last.num_segments_queried = len(segments)
            last.num_segments_pruned = pruned
            last.num_segments_cold = cold
            last.total_docs += unexecuted_docs + sum(
                s.n_docs for s in remaining)
            last.server_pressure = self.scheduler.pressure()
            last.server_inflight = self._inflight_queries
            last.table_epoch = epoch_at_start
            self.queries_served += 1
            try:
                ncols = max(1, len(q.columns()))
                for s in segments:
                    self.heat.note(
                        q.table_name, s.name,
                        bytes_scanned=int(
                            getattr(s, "n_docs", 0)) * ncols * 4)
            except Exception:  # noqa: BLE001 — telemetry never fails a query
                log.exception("segment heat accounting failed")
            encoded.append(encode(pending))
            return encoded
        finally:
            if tdm is not None:
                tdm.release(acquired)

    # registry sections whose change obligates a full _sync_once — NOT
    # instances (peer heartbeats), leases (controller HA renewals), or
    # external_view (peers' publishes, and our own): those churn
    # constantly in a healthy cluster without changing what THIS server
    # should host
    _SYNC_SECTIONS = ("tables", "schemas", "segments", "assignment",
                      "partition_assignment", "segment_lineage")

    def _serving_map(self) -> dict:
        return {
            table: list(tdm.segments)
            for table, tdm in self.engine.tables.items() if tdm.segments
        }

    # ---- segment sync (state model replacement) --------------------------
    def _sync_loop(self) -> None:
        from pinot_tpu_torch.common import freshness

        last_hb = 0.0
        last_token = None
        while not self._stop.is_set():
            try:
                # a full reconcile tick is 7+ registry transactions; under
                # sandboxed kernels (gVisor-class gofer fs) each costs
                # ~10ms of open/stat/flock syscalls, which at a 200ms
                # cadence kept the sync thread nearly CONTINUOUSLY busy
                # and stole the query threads' cores (measured: 2-server
                # QPS flat vs 1 server until this skip). Poll only the
                # lock-free section-version token; reconcile when it (or
                # our own serving set) moved, or on the heartbeat cadence
                # as a self-heal backstop.
                now = time.time()
                hb_due = now - last_hb >= self.heartbeat_interval_s
                token = self.registry.sections_version(self._SYNC_SECTIONS)
                if hb_due or token != last_token \
                        or self._serving_map() != self._last_serving:
                    self._sync_once()
                    # re-read: _sync_once's own writes (segment state
                    # flips, seals) must not re-trigger next tick
                    last_token = self.registry.sections_version(
                        self._SYNC_SECTIONS)
                if hb_due:
                    # heartbeat carries the load + freshness view: brokers read
                    # pressure for load-aware routing when no fresher
                    # piggybacked response signal exists, and the table epochs
                    # keep their result caches honest even when no queries are
                    # flowing. Cadence is DECOUPLED from the sync tick: a
                    # heartbeat is a full locked read-modify-write of the
                    # registry file, and N servers writing it every 200ms
                    # serialize on the lock.
                    self.registry.heartbeat(
                        self.instance_id, pressure=self.scheduler.pressure(),
                        table_epochs=freshness.snapshot(),
                        # per-segment temperature snapshot,
                        # hottest-N per table so the payload stays
                        # bounded at million-segment scale
                        heat=self.heat.snapshot(
                            top_per_table=self.heat_top_per_table),
                        # per-segment tier map: the controller's
                        # tier-aware replica-group assignment reads it
                        tiers=(self.tiers.snapshot()
                               if self.tiers.enabled else None))
                    last_hb = now
                # tier lifecycle pass (interval-gated internally): heat
                # ranking, hot-budget admission, cold demotion
                self.tiers.maybe_tick(now)
            except Exception:
                log.exception("segment sync failed")
            self._stop.wait(self.sync_interval_s)

    def _local_segment_dir(self, table: str, name: str) -> str:
        return os.path.join(self.data_dir, "segments", table, name)

    def _download_segment(self, table: str, rec) -> str:
        """Deep store → local working copy before load, like the reference's
        BaseTableDataManager.downloadSegment: queries never mmap deep-store
        files that a controller delete (retention, minion swap) can rm mid-
        read. Paths already under this server's data_dir (own realtime
        seals) are served in place. Local copies are CRC-VERSIONED
        (``name__<crc>``): a refresh push lands in a fresh directory, and
        the old one is torn down through the refcounted unload path once
        the last in-flight query over it drains — never rmtree'd in place."""
        import shutil

        src = rec.location
        if os.path.commonpath([os.path.abspath(src),
                               os.path.abspath(self.data_dir)]) \
                == os.path.abspath(self.data_dir):
            return src
        dirname = rec.name if not rec.crc else f"{rec.name}__{rec.crc}"
        local = self._local_segment_dir(table, dirname)
        if os.path.isdir(local):
            return local
        os.makedirs(os.path.dirname(local), exist_ok=True)
        tmp = f"{local}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)  # debris from a dead copy
        try:
            shutil.copytree(src, tmp)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            if os.path.isdir(src):
                # source readable → the failure is LOCAL (disk full,
                # permissions): surface it loudly instead of
                # misdiagnosing it as deep-store-down and re-failing
                # the same way after a network download
                raise
            # deep store unreachable: fall back to a serving replica
            # (PeerServerSegmentFinder role — server/peer.py); the peer's
            # tar lands in the same CRC-versioned dir the copy would have
            from pinot_tpu_torch.server.peer import peer_download

            return peer_download(self.registry, table, rec.name, local,
                                 self.instance_id, tls=self._tls,
                                 timeout_s=self.peer_download_timeout_s)
        if os.path.isdir(local):  # another loader won the copy race
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, local)
        return local

    def _on_segment_unload(self, tdm, seg) -> None:
        """Last reference drained after an unload: drop the local copy
        (deferred teardown is what the refcount buys — an in-flight query
        finished with the mmap before the files went away). If the segment
        was REASSIGNED meanwhile and a live entry is serving from the same
        directory, the delete is skipped — removing it would orphan the
        re-added copy's lazily-mmap'd files."""
        import shutil

        local_root = os.path.abspath(os.path.join(self.data_dir, "segments"))
        seg_dir = os.path.abspath(seg.dir)
        if os.path.commonpath([seg_dir, local_root]) != local_root:
            return
        cur = tdm.segments.get(seg.name)
        if cur is not None and os.path.abspath(cur.dir) == seg_dir:
            return
        shutil.rmtree(seg_dir, ignore_errors=True)

    def _sync_once(self) -> None:
        assigned = self.registry.assigned_segments(self.instance_id)
        # load newly-assigned sealed segments (OFFLINE→ONLINE)
        for table, names in assigned.items():
            records = self.registry.segments(table)
            tdm = self.engine.table(table)
            if tdm.is_dim_table is None:
                cfg = self.registry.table_config(table)
                if cfg is not None:
                    tdm.is_dim_table = cfg.is_dim_table
            table_schema = self.registry.table_schema(table)
            if tdm.on_unload is None:
                tdm.on_unload = (
                    lambda seg, _tdm=tdm: self._on_segment_unload(_tdm, seg))
            for name in names:
                rec = records.get(name)
                if rec is None or rec.state != SegmentState.ONLINE:
                    continue
                cur = tdm.segments.get(name)
                if cur is not None:
                    # self-heal the unload/re-add race: if a deferred delete
                    # won and this entry's files vanished, drop it so the
                    # next tick re-downloads a fresh copy
                    if not os.path.isfile(os.path.join(cur.dir, "metadata.json")):
                        log.warning("segment %s lost its local files; "
                                    "reloading", name)
                        tdm.remove_segment(name)
                        continue
                    if rec.crc and cur.metadata.crc \
                            and cur.metadata.crc != rec.crc:
                        # refresh push: retire the old copy via the doomed/
                        # unload path and load the new CRC's dir this tick
                        tdm.remove_segment(name)
                    else:
                        continue
                try:
                    seg = ImmutableSegment(self._download_segment(table, rec))
                    if table_schema is not None:
                        seg.table_schema = table_schema
                    tdm.add_segment(seg)
                except Exception:
                    log.exception("failed to load segment %s from %s",
                                  name, rec.location)
        # schema evolution: EVERY hosted segment — offline downloads,
        # sealed realtime, and consuming mutables — carries the CURRENT
        # table schema so queries over columns added after a segment was
        # built synthesize default values (reference: segment reload after
        # a Schema REST update)
        for table, tdm in list(self.engine.tables.items()):
            table_schema = self.registry.table_schema(table)
            if table_schema is not None:
                for seg in list(tdm.segments.values()):
                    seg.table_schema = table_schema
        # unload segments no longer assigned (ONLINE→OFFLINE/DROPPED);
        # consuming (mutable) segments belong to the realtime managers
        for table, tdm in list(self.engine.tables.items()):
            keep = set(assigned.get(table, ()))
            for name, seg in list(tdm.segments.items()):
                if name not in keep and not getattr(seg, "is_mutable", False):
                    tdm.remove_segment(name)
        self._sync_realtime()
        # publish what this instance can actually answer for (ExternalView)
        serving = self._serving_map()
        self.registry.update_external_view(self.instance_id, serving)
        self._last_serving = serving

    def _sync_realtime(self) -> None:
        """Reconcile stream consumers against the (multi-replica) partition
        assignment: start consumers for newly-assigned partitions, stop
        reassigned ones (CONSUMING state analog, level-triggered)."""
        for table in self.registry.tables():
            pa = self.registry.partition_assignment(table)
            mine = sorted(
                int(p) for p, insts in pa.items() if self.instance_id in insts
            )
            mgr = self._realtime_managers.get(table)
            if mgr is None:
                if not mine:
                    continue
                cfg = self.registry.table_config(table)
                schema = self.registry.table_schema(table)
                if cfg is None or cfg.stream is None:
                    continue
                from pinot_tpu_torch.realtime.completion import SegmentCompletionClient
                from pinot_tpu_torch.realtime.manager import RealtimeTableDataManager

                mgr = RealtimeTableDataManager(
                    schema, cfg, self.engine.table(table),
                    os.path.join(self.data_dir, f"rt_{table}"),
                    completion_client=SegmentCompletionClient(
                        self.registry, table, self.instance_id
                    ),
                    peer_fetch=lambda seg, dest, _t=table:
                        self._peer_fetch(_t, seg, dest),
                )
                # callbacks publish under the PHYSICAL registry key
                # (clicks_REALTIME), not the raw table name the manager carries
                mgr.start(
                    partitions=mine,
                    on_commit=lambda _t, p, seg, _k=table: self._publish_committed(_k, p, seg),
                    on_consuming=lambda _t, p, seg, _k=table: self._publish_consuming(_k, p, seg),
                )
                self._realtime_managers[table] = mgr
            else:
                current = set(mgr.partition_managers)
                for p in mine:
                    if p not in current:
                        mgr.add_partition(p)
                for p in current - set(mine):
                    mgr.stop_partition(p)

    def _peer_fetch(self, table: str, segment_name: str, dest_dir: str) -> str:
        """Adopt-path fallback when the winner's published location is
        unreachable: download from a serving replica. Retries briefly —
        the external view can lag the winner's publish by a sync tick.
        The retry window is config-driven
        (``pinot.server.segment.peer.retry.timeout.ms``; was a hardcoded
        10 s) and the SAME Deadline bounds every per-replica stream
        inside peer_download, so a hung peer can't hold the consume loop
        past the window."""
        from pinot_tpu_torch.server.peer import peer_download

        deadline = Deadline(self.peer_retry_timeout_s)
        while True:
            try:
                return peer_download(self.registry, table, segment_name,
                                     dest_dir, self.instance_id,
                                     tls=self._tls,
                                     timeout_s=self.peer_download_timeout_s,
                                     deadline=deadline)
            except Exception:
                if deadline.expired():
                    raise
                time.sleep(0.3)

    def _publish_consuming(self, table: str, partition: int, segment) -> None:
        """Consuming segments are routable (brokers send them queries while
        rows stream in — RealtimeSegmentSelector analog)."""
        self.registry.add_segment(
            SegmentRecord(
                name=segment.name, table=table, n_docs=0,
                location="", state=SegmentState.CONSUMING,
            ),
            [self.instance_id],
            merge_instances=True,
        )

    def _publish_committed(self, table: str, partition: int, sealed) -> None:
        """Committed realtime segments become cluster-visible (the
        Server2Controller commit → ZK metadata step)."""
        meta = sealed.metadata
        from pinot_tpu_torch.controller.controller import (
            _column_stats_fields,
            _partition_record_fields,
        )

        self.registry.add_segment(
            SegmentRecord(
                name=sealed.name, table=table, n_docs=sealed.n_docs,
                location=sealed.dir, state=SegmentState.ONLINE,
                start_time=meta.start_time, end_time=meta.end_time,
                **_partition_record_fields(meta),
                **_column_stats_fields(meta),
            ),
            [self.instance_id],
            merge_instances=True,
        )
