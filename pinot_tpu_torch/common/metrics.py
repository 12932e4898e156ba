"""Metrics registry: counters, gauges, timers + latency histograms.

Equivalent of the reference's metrics SPI
(pinot-common/.../metrics/AbstractMetrics.java + BrokerMetrics /
ServerMetrics / ControllerMetrics / MinionMetrics over yammer): named
meters/gauges/timers keyed ``component.name[.tag]``, aggregated
in-process and exported as a snapshot dict or Prometheus text. The
yammer backend is replaced by lock-cheap python primitives — emission to
an external system is a reporter's job (register one with
``add_reporter``), matching the SPI split.

Every timer key ALSO maintains a log-bucketed :class:`Histogram` (the
yammer ``Histogram``/``Timer`` percentile role): p50/p90/p99/p999 ride
the snapshot and the Prometheus exposition emits a real ``histogram``
family (``_bucket{le=...}``/``_sum``/``_count`` + ``# HELP``/``# TYPE``)
per key. One update feeds both — there is ONE latency truth; consumers
that need a quantile (the broker's adaptive hedge delay, dashboards)
read it from here instead of keeping private sample windows.
"""

from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Callable, Optional

# ---------------------------------------------------------------------------
# histogram buckets: geometric (log-spaced) bounds shared by every
# Histogram instance — factor 2**0.25 (~19% bucket width) from 10 µs to
# ~2.8 hours, so quantile interpolation error is bounded by one bucket
# (<~19% relative) across the whole range a query path can produce.
# ---------------------------------------------------------------------------
_HIST_FACTOR = 2.0 ** 0.25
_HIST_MIN_MS = 1e-2
_HIST_NBUCKETS = 120  # upper bound of last finite bucket ≈ 1e7 ms
HIST_BOUNDS_MS = tuple(_HIST_MIN_MS * _HIST_FACTOR ** i
                       for i in range(_HIST_NBUCKETS))


class Histogram:
    """Log-bucketed latency histogram (ms). Fixed global bounds keep
    updates O(log B) and merging trivial; quantiles interpolate linearly
    inside the containing bucket and clamp to the observed min/max."""

    __slots__ = ("counts", "count", "total_ms", "min_ms", "max_ms")

    def __init__(self):
        # counts[i] observes (bounds[i-1], bounds[i]]; the last slot is
        # the overflow bucket above the final finite bound
        self.counts = [0] * (_HIST_NBUCKETS + 1)
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0

    def update(self, ms: float) -> None:
        self.counts[bisect.bisect_left(HIST_BOUNDS_MS, ms)] += 1
        self.count += 1
        self.total_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile with in-bucket linear interpolation;
        0.0 when empty (callers that need a default should check
        ``count`` first)."""
        if self.count == 0:
            return 0.0
        import math

        target = max(1, min(self.count, math.ceil(q * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else HIST_BOUNDS_MS[i - 1]
                hi = HIST_BOUNDS_MS[i] if i < _HIST_NBUCKETS else self.max_ms
                frac = (target - cum) / c
                val = lo + frac * (hi - lo)
                return float(min(max(val, self.min_ms), self.max_ms))
            cum += c
        return float(self.max_ms)

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "p50Ms": 0.0, "p90Ms": 0.0, "p99Ms": 0.0,
                    "p999Ms": 0.0}
        return {
            "count": self.count,
            "p50Ms": round(self.quantile(0.50), 3),
            "p90Ms": round(self.quantile(0.90), 3),
            "p99Ms": round(self.quantile(0.99), 3),
            "p999Ms": round(self.quantile(0.999), 3),
        }


class Timer:
    """count / total / min / max over observed durations (ms)."""

    __slots__ = ("count", "total_ms", "min_ms", "max_ms")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0

    def update(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        if ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    def snapshot(self) -> dict:
        avg = self.total_ms / self.count if self.count else 0.0
        return {"count": self.count, "totalMs": round(self.total_ms, 3),
                "avgMs": round(avg, 3),
                "minMs": round(self.min_ms, 3) if self.count else 0.0,
                "maxMs": round(self.max_ms, 3)}


# Prometheus metric names must match [a-zA-Z_:][a-zA-Z0-9_:]* — but
# registry keys carry free-form tags (instance ids, traceInfo-derived
# attempt keys like "inst (retry)", table names with dots). EVERY
# illegal character maps to "_" so the exposition stays parseable by a
# real scraper; the "pinot_tpu_" prefix keeps the first character legal.
_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize(k: str) -> str:
    """Registry key → legal Prometheus metric name (spaces/parens in
    instance-keyed names previously emitted an
    exposition prometheus_client refuses to parse)."""
    return "pinot_tpu_" + _PROM_NAME_RE.sub("_", k)


class MetricsRegistry:
    def __init__(self, component: str = ""):
        self.component = component
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, Callable | float] = {}
        self._timers: dict[str, Timer] = {}
        self._hists: dict[str, Histogram] = {}
        self._reporters: list[Callable] = []

    def _key(self, name: str, tag: Optional[str]) -> str:
        parts = [p for p in (self.component, name, tag) if p]
        return ".".join(parts)

    # ---- meters (addMeteredTableValue analog) ---------------------------
    def count(self, name: str, value: float = 1, tag: Optional[str] = None) -> None:
        key = self._key(name, tag)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    # ---- gauges (setOrUpdateGauge analog) -------------------------------
    def gauge(self, name: str, value, tag: Optional[str] = None) -> None:
        """``value``: a number, or a zero-arg callable sampled at snapshot
        time (the reference's Gauge<Long> suppliers)."""
        with self._lock:
            self._gauges[self._key(name, tag)] = value

    def remove_gauge(self, name: str, tag: Optional[str] = None) -> None:
        """Unregister (removeGauge analog) — component teardown MUST call
        this for callable gauges, or their closures pin the dead component
        (and everything it references) in the process-global registry."""
        with self._lock:
            self._gauges.pop(self._key(name, tag), None)

    def gauge_keys(self, tag: str) -> list:
        """Registered gauge keys carrying ``tag`` as their last segment —
        the leak audit surface: after a component's stop(), this must be
        empty for its instance id."""
        suffix = "." + tag
        with self._lock:
            return [k for k in self._gauges if k.endswith(suffix)]

    # ---- timers + histograms (addTimedTableValue analog) ----------------
    def time_ms(self, name: str, ms: float, tag: Optional[str] = None) -> None:
        """One observation feeds BOTH the legacy count/avg/min/max timer
        and the log-bucketed histogram under the same key."""
        key = self._key(name, tag)
        with self._lock:
            t = self._timers.get(key)
            if t is None:
                t = self._timers[key] = Timer()
                self._hists[key] = Histogram()
            t.update(ms)
            self._hists[key].update(ms)

    # observe() is the histogram-forward alias: same storage, same key —
    # call sites that think in distributions rather than timers read better
    observe = time_ms

    def quantile(self, name: str, q: float,
                 tag: Optional[str] = None) -> Optional[float]:
        """Histogram quantile in ms for ``name[.tag]``; None when no
        sample was ever recorded (callers supply their own default)."""
        with self._lock:
            h = self._hists.get(self._key(name, tag))
            if h is None or h.count == 0:
                return None
            return h.quantile(q)

    class _Span:
        __slots__ = ("reg", "name", "tag", "t0")

        def __init__(self, reg, name, tag):
            self.reg, self.name, self.tag = reg, name, tag

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.reg.time_ms(self.name, (time.perf_counter() - self.t0) * 1000,
                             self.tag)
            return False

    def timed(self, name: str, tag: Optional[str] = None) -> "_Span":
        return self._Span(self, name, tag)

    # ---- lifecycle ------------------------------------------------------
    def reset(self) -> None:
        """Drop every counter/gauge/timer/histogram (reporters stay).
        Component teardown in tests calls this so a RESTARTED instance
        can't double-count against the process-global registry."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._hists.clear()

    # ---- export ---------------------------------------------------------
    def add_reporter(self, fn: Callable[[dict], None]) -> None:
        self._reporters.append(fn)

    def report(self) -> None:
        snap = self.snapshot()
        for fn in self._reporters:
            fn(snap)

    def snapshot(self) -> dict:
        with self._lock:
            gauges = {}
            for k, v in self._gauges.items():
                try:
                    gauges[k] = v() if callable(v) else v
                except Exception:  # noqa: BLE001 — sampling must not throw
                    gauges[k] = None
            return {
                "counters": dict(self._counters),
                "gauges": gauges,
                "timers": {k: t.snapshot() for k, t in self._timers.items()},
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def prometheus_text(self) -> str:
        """Prometheus exposition format (the common reporter target).
        Timers export as real ``histogram`` families: cumulative
        ``_bucket{le=...}`` lines (only buckets where the cumulative
        count advances, plus ``+Inf`` — a sparse but valid exposition),
        ``_sum``/``_count``, and a separate untyped ``_max`` sample."""

        lines = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = []
            for k, v in sorted(self._gauges.items()):
                try:
                    gauges.append((k, v() if callable(v) else v))
                except Exception:  # noqa: BLE001 — sampling must not throw
                    gauges.append((k, None))
            hists = [(k, h.counts[:], h.count, h.total_ms, h.max_ms)
                     for k, h in sorted(self._hists.items())]
        for k, v in counters:
            base = sanitize(k) + "_total"
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base} {v}")
        for k, v in gauges:
            if v is not None:
                base = sanitize(k)
                lines.append(f"# TYPE {base} gauge")
                lines.append(f"{base} {v}")
        for k, counts, count, total_ms, max_ms in hists:
            base = sanitize(k) + "_ms"
            lines.append(f"# HELP {base} latency distribution of {k} "
                         f"in milliseconds")
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for i, c in enumerate(counts):
                if c == 0 or i >= _HIST_NBUCKETS:
                    continue
                cum += c
                lines.append(
                    f'{base}_bucket{{le="{HIST_BOUNDS_MS[i]:.6g}"}} {cum}')
            lines.append(f'{base}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{base}_sum {round(total_ms, 3)}")
            lines.append(f"{base}_count {count}")
            lines.append(f"{base}_max {round(max_ms, 3)}")
        return "\n".join(lines) + "\n"


# process-wide default registries, one per role (BrokerMetrics.get() style)
_registries: dict[str, MetricsRegistry] = {}
_reg_lock = threading.Lock()


def get_metrics(component: str) -> MetricsRegistry:
    with _reg_lock:
        reg = _registries.get(component)
        if reg is None:
            reg = _registries[component] = MetricsRegistry(component)
        return reg


def reset_metrics(component: Optional[str] = None) -> None:
    """Reset one component's registry (or ALL when None). Registry
    OBJECTS survive — components hold references to them — only their
    contents clear. The test-isolation / restart story: process-global
    registries otherwise accumulate across ServerInstance lifecycles."""
    with _reg_lock:
        regs = ([_registries[component]] if component in _registries
                else [] if component is not None
                else list(_registries.values()))
    for reg in regs:
        reg.reset()


def all_snapshots() -> dict:
    with _reg_lock:
        return {name: reg.snapshot() for name, reg in _registries.items()}


def all_prometheus_text() -> str:
    with _reg_lock:
        regs = list(_registries.values())
    return "".join(reg.prometheus_text() for reg in regs)
