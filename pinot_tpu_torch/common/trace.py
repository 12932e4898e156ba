"""Request tracing: per-query phase spans surfaced in the response.

A copy of pinot_tpu/common/trace.py (the port imports nothing of the JAX
package).

Equivalent of the reference's trace SPI
(pinot-spi/.../trace/Tracing.java:32 + RequestContext /
DefaultRequestContext and the broker's ``trace`` query option): a tracer
records named phase spans (nesting flattened to dotted names); when the
query sets ``SET trace = true`` the spans ride back in the broker
response as ``traceInfo``, the reference's BrokerResponse trace payload.

The tracer is an EXPLICIT, wire-portable object, not thread state: the
broker mints one per request (stamping a ``trace_id`` that ships in every
scatter request, retries and hedges included), the server threads it
through the async launch/fetch split (``InflightLaunch`` and the
``execute_segments_async`` fetch closure carry it by reference), and the
per-server span lists ride home in DataTable metadata. A thread-local
slot remains for call sites that span the CURRENT request without
plumbing (``span(name)`` with no tracer), but a span recorded against an
explicit tracer lands on that tracer no matter which thread runs it —
a fetch on another thread than its launch and coalesced cohort launches
record correctly. Tracing off costs one attribute read per span.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_local = threading.local()


class Tracer:
    """One query's span collection. Thread-safe: the launch thread, the
    fetch thread, and a cohort leader may all record concurrently.
    Nesting (dotted names) is tracked PER THREAD so concurrent recorders
    can't mangle each other's phase names."""

    __slots__ = ("trace_id", "spans", "_t0", "_lock", "_tls")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id
        self.spans: list = []  # (name, start_ms_rel, duration_ms)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread nesting stack

    # ---- recording -------------------------------------------------------
    def span(self, name: str) -> "Tracer._Span":
        return Tracer._Span(self, name)

    def record(self, name: str, t_start: float, t_end: float) -> None:
        """Append one span from perf_counter endpoints (internal)."""
        with self._lock:
            self.spans.append((
                name,
                round((t_start - self._t0) * 1000, 3),
                round((t_end - t_start) * 1000, 3),
            ))

    def add_ms(self, name: str, duration_ms: float) -> None:
        """Record a phase that JUST ENDED and lasted ``duration_ms`` —
        for waits measured by someone else (the scheduler publishes its
        admission wait before the admitted fn runs; the fn back-fills the
        queue span from it)."""
        now = time.perf_counter()
        self.record(name, now - duration_ms / 1000.0, now)

    def elapsed_ms(self) -> float:
        """Wall time since this tracer was created (the request entry)."""
        return (time.perf_counter() - self._t0) * 1000.0

    class _Span:
        __slots__ = ("tracer", "name", "t0")

        def __init__(self, tracer, name):
            self.tracer, self.name = tracer, name

        def __enter__(self):
            t = self.tracer
            if t is not None:
                stack = getattr(t._tls, "stack", None)
                if stack is None:
                    stack = t._tls.stack = []
                stack.append(self.name)
                self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            t = self.tracer
            if t is not None:
                stack = t._tls.stack
                name = ".".join(stack)
                stack.pop()
                t.record(name, self.t0, time.perf_counter())
            return False

    # ---- export ----------------------------------------------------------
    def to_json(self) -> list:
        with self._lock:
            return [{"phase": n, "startMs": s, "durationMs": d}
                    for n, s, d in self.spans]


def start_trace(trace_id: Optional[str] = None) -> Tracer:
    """Install a tracer for this thread (request entry point). The
    returned object should ALSO be carried explicitly across thread
    seams — the thread-local slot only covers same-thread call sites."""
    t = Tracer(trace_id)
    _local.tracer = t
    return t


def end_trace() -> None:
    _local.tracer = None


def active() -> Optional[Tracer]:
    return getattr(_local, "tracer", None)


def span(name: str, tracer: Optional[Tracer] = None) -> "Tracer._Span":
    """Context manager recording a phase on ``tracer`` (explicit — works
    from any thread) or, when omitted, on the calling thread's active
    tracer; a no-op (shared constant-cost object) when tracing is off."""
    return Tracer._Span(tracer if tracer is not None else active(), name)


def top_level_spans(spans: list) -> list:
    """The top-level phases of a span list-of-dicts — what the waterfall
    and the phase-sum/wall reconciliation sum over. Span names are
    ``role.phase`` at the top and gain a dotted segment per nesting level
    (``server.execute.gather``), so top-level == at most one dot. The
    synthetic ``<role>.total`` span is excluded (it IS the wall)."""
    return [s for s in spans
            if s["phase"].count(".") <= 1
            and not s["phase"].endswith(".total")]
