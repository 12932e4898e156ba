"""In-flight launch handles and cross-query launch coalescing.

Counterpart of pinot_tpu/engine/inflight.py. The device executor's hot
path splits into a **launch** phase (template build, column gather, the
pipeline's torch ops and kernels enqueued on the current CUDA stream,
then one device-to-host copy of the packed outputs into pinned memory,
also enqueued) and a **fetch** phase that waits for that copy and turns
the outputs into the canonical IntermediateResult. ``InflightLaunch`` is
the handle between the two: N concurrent queries overlap their device
work and copies instead of serializing them.

``LaunchCoalescer`` rides on top: concurrent queries sharing one cohort
key (one batch, one template, the same parameter shapes: the dashboard
fan-out, one SQL shape with different literals) stack their parameters
on a leading member axis and run as ONE launch per kernel
(engine/cohort.py), whose outputs cross to the host in ONE copy. The
window opens only under pressure (another query in flight on the
executor) or when ``force`` is set: an idle executor dispatches at once.

The synchronization is host code, the reference's as it is. A fetch that
fails on a device runtime error goes through the executor's recovery
(``DeviceExecutor.on_fetch_device_error``: a strike against the launch's
template and batch, the batch evicted, an in-band refusal); a successful
one clears the strikes and carries the plan advisor's decision stamps
into the result's stats.
"""

from __future__ import annotations

import threading
import time

from pinot_tpu_torch.common.trace import span


class InflightLaunch:
    """A dispatched, not yet fetched device launch.

    ``fetch()`` waits for the launch's copy to the host (the only
    blocking step), then ``finish`` turns the host outputs into the
    canonical IntermediateResult. The batch the launch reads is pinned
    against LRU eviction until the fetch completes or the handle is
    released (``DeviceExecutor._retain_launch`` / ``_release_launch``)."""

    def __init__(self, executor, batch_key, resolve, finish):
        self._executor = executor
        self._batch_key = batch_key
        self._resolve = resolve
        self._finish = finish
        self._done = False
        # the query's Deadline (common/deadline.py), set by the engine: an
        # expired budget aborts BEFORE the blocking wait
        self.deadline = None
        # the query's explicit Tracer (common/trace.py): the fetch may run
        # on another thread than the launch, or ride a cohort another
        # member resolves; its spans land on this query's trace
        self.tracer = None
        # served from the device partials cache: no gather, no kernel;
        # the fetch copies a cached packed buffer again
        self.cache_hit = False
        # roofline flight dict, filled by the resolve with its record;
        # cohort members other than the leader carry an unfilled one
        self.flight = None
        # the launch's device template (None for the host path's shape):
        # the quarantine breaker counts fetch failures against it
        self.template = None
        # plan advisor (engine/advisor.py): the launch's template key
        # (None when bypassed) and the ADVISOR(...) stamps it ran with
        self.adv_key = None
        self.advisor_notes = ()

    def fetch(self):
        """Blocking phase → IntermediateResult. Raises QueryTimeout when
        the deadline expired before the wait began, and the executor's
        ``HostShapeRerun`` where the query leaves the device shape at
        fetch time. One-shot: the batch pin drops either way."""
        if self._done:
            raise RuntimeError("InflightLaunch.fetch() called twice")
        self._done = True
        try:
            if self.deadline is not None:
                try:
                    self.deadline.check("device fetch")
                except BaseException:
                    # this member will never run the shared resolve: it
                    # counts as abandoned, or an all-timed-out cohort
                    # leaves fetch_done unset for the next stream window
                    self._note_abandoned()
                    raise
            try:
                if self.tracer is not None:
                    with span("device_fetch", self.tracer):
                        outs = self._resolve()
                else:
                    outs = self._resolve()
            except Exception as e:  # noqa: BLE001 — may convert in-band
                # a device runtime error (an out-of-memory, an injected
                # fault) counts toward the quarantine breaker and comes
                # back as an in-band refusal; anything else re-raises
                self._executor.on_fetch_device_error(
                    e, self.template, self._batch_key)
                raise
            # success clears the breaker's strike count: it trips on
            # failures close together, not on two transient ones far apart
            self._executor._note_device_success(self.template,
                                                self._batch_key)
            result = self._finish(outs)
            result.stats.partials_cache_hit = self.cache_hit
            if self.advisor_notes:
                result.stats.advisor_decisions.extend(self.advisor_notes)
            advisor = getattr(self._executor, "advisor", None)
            if self.adv_key is not None and advisor is not None:
                advisor.observe(self.adv_key, partials_hit=self.cache_hit)
            rec = None if self.flight is None else self.flight.get("record")
            if rec is not None:
                result.roofline = [rec]
                st = result.stats
                st.device_bytes_moved += int(rec.get("bytesMoved") or 0)
                st.device_kernel_ms += float(rec.get("kernelMs") or 0.0)
                st.device_link_ms += float(rec.get("linkMs") or 0.0)
            return result
        finally:
            self._executor._release_launch(self._batch_key)

    def _note_abandoned(self):
        """Tell a cohort this member will never fetch (cohort resolves
        carry the ``abandon`` hook; solo resolves do not)."""
        abandon = getattr(self._resolve, "abandon", None)
        if abandon is not None:
            try:
                abandon()
            except Exception:  # noqa: BLE001 — bookkeeping must not mask
                pass

    def release(self):
        """Abandon without fetching: drop the batch pin. Callers that fail
        between launch and fetch must call this, or the batch stays
        unevictable and the executor's in-flight count (the coalescer's
        pressure signal) never drains. Idempotent with fetch()."""
        if not self._done:
            self._done = True
            self._note_abandoned()
            self._executor._release_launch(self._batch_key)


class _Cohort:
    """One coalesced launch: the leader stacks every member's params and
    launches once; the shared packed buffer is fetched once (the first
    ``resolve_member`` wins) and each member takes its own outputs."""

    # a member waits as long as the leader THREAD is alive, but not
    # forever on a leader that died mid-window
    READY_POLL_S = 5.0

    def __init__(self, launch_fn):
        self._launch_fn = launch_fn
        self.leader_thread = threading.current_thread()  # creator leads
        self.members = []          # per-member params, join order
        self.open = True           # False once the window closed
        self.full = threading.Event()  # hit max_cohort: leader stops waiting
        self.ready = threading.Event()
        # set once the shared buffer reached the host (or the cohort
        # failed): the successor cohort's stream window keys off it
        self.fetch_done = threading.Event()
        self.error = None          # the leader's launch failure, if any
        self._shared_resolve = None
        self._fetch_lock = threading.Lock()
        self._outs = None
        self._exc = None
        self._fetched = False
        self._abandoned = 0        # members released without fetching

    def dispatch(self):
        """Leader only: one stacked launch for the whole cohort."""
        try:
            self._shared_resolve = self._launch_fn(self.members)
        except BaseException as e:  # noqa: BLE001 — members must observe it
            self.error = e
            self.fetch_done.set()  # nothing will ever fetch
        finally:
            self.ready.set()
            with self._fetch_lock:
                self._check_all_abandoned()

    def note_abandoned(self):
        """A member released its handle without fetching. When EVERY
        member abandons, nothing runs the shared fetch: fetch_done must
        still fire, or the next same-key stream window waits its cap."""
        with self._fetch_lock:
            self._abandoned += 1
            self._check_all_abandoned()

    def _check_all_abandoned(self):
        """Caller holds _fetch_lock. Membership is final once ready is
        set."""
        if (self.ready.is_set() and not self._fetched
                and self._abandoned >= len(self.members)):
            self.fetch_done.set()

    def resolve_member(self, idx: int) -> dict:
        """Member ``idx``'s host outputs. The shared buffer crosses to the
        host ONCE; every member's outputs are views of that one copy."""
        while not self.ready.wait(self.READY_POLL_S):
            if not self.leader_thread.is_alive():
                raise RuntimeError(
                    "coalesced launch leader died before dispatch")
        if self.error is not None:
            raise self.error
        with self._fetch_lock:
            if not self._fetched:
                try:
                    self._outs = self._shared_resolve()
                except BaseException as e:  # noqa: BLE001 — shared failure
                    self._exc = e
                self._fetched = True
                self.fetch_done.set()  # link free: successor may dispatch
        if self._exc is not None:
            raise self._exc
        return self._outs[idx]


class LaunchCoalescer:
    """Micro-batches concurrent same-template launches into one stacked
    launch. Pure synchronization: the executor supplies the stacked-launch
    closure (``DeviceExecutor._cohort_launch``)."""

    def __init__(self, window_s: float = 0.003, max_cohort: int = 8,
                 stream_cap_s: float = 0.25):
        self.enabled = True
        self.window_s = window_s      # leader's micro-batch window
        self.max_cohort = max_cohort  # member-axis width cap
        # double-buffered launch / fetch: while cohort N's buffer is on
        # its way to the host, cohort N+1's leader holds its window open
        # until N's fetch completes (capped at stream_cap_s for the
        # abandoned-handle case), so arrivals meanwhile join ONE launch
        self.stream_cap_s = stream_cap_s
        self.force = False            # tests / bench: window regardless
        self._lock = threading.Lock()
        self._pending: dict = {}      # cohort key -> open _Cohort
        # cohort key -> the last dispatched cohort's fetch_done EVENT,
        # never the _Cohort (it holds the batch's columns and buffers)
        self._last_dispatched: dict = {}
        self.cohorts_launched = 0
        self.queries_coalesced = 0    # members that joined past the leader
        self.stream_windows = 0       # windows that keyed off a predecessor

    def should_window(self, executor_inflight: int) -> bool:
        """Open a window only when a partner is likely: ``executor_inflight``
        counts launches between dispatch and fetch INCLUDING the asking
        one, hence > 1."""
        if not self.enabled:
            return False
        if self.force:
            return True
        return executor_inflight > 1

    def join(self, key, params, launch_fn, window_s=None):
        """Join (or open) the cohort for ``key`` → (cohort, member index).

        The FIRST arrival leads: it holds the window open for
        ``window_s`` (None: ``self.window_s``; the plan advisor sizes it
        from the template's observed cohort sizes), then closes the
        cohort and runs one stacked launch built by ``launch_fn(members)``.
        Later arrivals append their params and return at once; they block
        only in ``resolve_member`` (their fetch)."""
        with self._lock:
            c = self._pending.get(key)
            if c is not None and c.open:
                idx = len(c.members)
                c.members.append(params)
                if len(c.members) >= self.max_cohort:
                    c.open = False
                    self._pending.pop(key, None)
                    c.full.set()  # the leader dispatches at once
                self.queries_coalesced += 1
                return c, idx
            c = _Cohort(launch_fn)
            c.members.append(params)
            self._pending[key] = c
            pred_done = self._last_dispatched.get(key)
            if pred_done is not None and pred_done.is_set():
                self._last_dispatched.pop(key, None)  # link already free
                pred_done = None
        if pred_done is not None:
            # stream window: wait for the predecessor's fetch (capped)
            self.stream_windows += 1
            deadline = time.monotonic() + self.stream_cap_s
            while not c.full.is_set() and not pred_done.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                c.full.wait(min(0.002, left))
        else:
            c.full.wait(self.window_s if window_s is None else window_s)
        with self._lock:
            c.open = False
            if self._pending.get(key) is c:
                self._pending.pop(key, None)
            self.cohorts_launched += 1
            self._last_dispatched.pop(key, None)
            self._last_dispatched[key] = c.fetch_done
            while len(self._last_dispatched) > 64:  # bound stale keys
                self._last_dispatched.pop(next(iter(self._last_dispatched)))
        c.dispatch()
        return c, 0
