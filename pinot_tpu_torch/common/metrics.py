"""Metrics registry: counters, timers and latency histograms.

The part of pinot_tpu/common/metrics.py the device executor uses: named
counters and timers keyed ``component.name[.tag]``, each timer backed by
a log-bucketed :class:`Histogram` (p50 / p90 / p99 / p999), one registry
per component (``get_metrics("server")``), and a snapshot dict. The
gauges, reporters and the Prometheus exposition come with the cluster
tier.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Optional

# geometric bucket bounds shared by every Histogram: factor 2**0.25 (~19 %
# bucket width) from 10 µs to ~2.8 hours, so a quantile is off by at most
# one bucket
_HIST_FACTOR = 2.0 ** 0.25
_HIST_MIN_MS = 1e-2
_HIST_NBUCKETS = 120
HIST_BOUNDS_MS = tuple(_HIST_MIN_MS * _HIST_FACTOR ** i
                       for i in range(_HIST_NBUCKETS))


class Histogram:
    """Log-bucketed histogram. Quantiles interpolate linearly inside the
    containing bucket and clamp to the observed min / max."""

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
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile with in-bucket interpolation; 0.0 when
        empty."""
        if self.count == 0:
            return 0.0
        target = max(1, min(self.count, math.ceil(q * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else HIST_BOUNDS_MS[i - 1]
                hi = HIST_BOUNDS_MS[i] if i < _HIST_NBUCKETS else self.max_ms
                val = lo + (target - cum) / c * (hi - lo)
                return float(min(max(val, self.min_ms), self.max_ms))
            cum += c
        return float(self.max_ms)

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "p50Ms": 0.0, "p90Ms": 0.0, "p99Ms": 0.0,
                    "p999Ms": 0.0}
        return {"count": self.count,
                "p50Ms": round(self.quantile(0.50), 3),
                "p90Ms": round(self.quantile(0.90), 3),
                "p99Ms": round(self.quantile(0.99), 3),
                "p999Ms": round(self.quantile(0.999), 3)}


class MetricsRegistry:
    def __init__(self, component: str = ""):
        self.component = component
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    def _key(self, name: str, tag: Optional[str]) -> str:
        return ".".join(p for p in (self.component, name, tag) if p)

    def count(self, name: str, value: float = 1,
              tag: Optional[str] = None) -> None:
        key = self._key(name, tag)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def time_ms(self, name: str, ms: float, tag: Optional[str] = None) -> None:
        """One observation into the histogram under ``name[.tag]``."""
        key = self._key(name, tag)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.update(ms)

    # the histogram-forward alias: same storage, same key
    observe = time_ms

    def quantile(self, name: str, q: float,
                 tag: Optional[str] = None) -> Optional[float]:
        """Quantile of ``name[.tag]``; None when nothing was observed."""
        with self._lock:
            h = self._hists.get(self._key(name, tag))
            if h is None or h.count == 0:
                return None
            return h.quantile(q)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters),
                    "histograms": {k: h.snapshot()
                                   for k, h in self._hists.items()}}


_registries: dict[str, MetricsRegistry] = {}
_reg_lock = threading.Lock()


def get_metrics(component: str) -> MetricsRegistry:
    with _reg_lock:
        reg = _registries.get(component)
        if reg is None:
            reg = _registries[component] = MetricsRegistry(component)
        return reg


def reset_metrics(component: Optional[str] = None) -> None:
    """Clear one component's registry (or all): the objects survive, only
    their contents go."""
    with _reg_lock:
        regs = ([_registries[component]] if component in _registries
                else [] if component is not None
                else list(_registries.values()))
    for reg in regs:
        reg.reset()
