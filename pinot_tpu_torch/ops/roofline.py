"""Memory peak probe: the denominator of every roofline line.

Counterpart of pinot_tpu/ops/roofline.py. One per-process answer to
"what does this device's memory system sustain", measured lazily once
and cached:

- ``PINOT_TPU_HBM_PEAK_GBPS`` overrides it entirely (no device work);
- the first caller of :func:`hbm_peak_gbps` pays the measurement: a
  device copy of ``PROBE_BYTES`` into a second buffer, read plus write
  bytes over the copy's time, best of ``_PROBE_REPEATS``. On the card the
  time is CUDA-event time; on the CPU (the tests, which may set
  ``PINOT_TPU_HBM_PROBE_BYTES`` small) the host clock's;
- :func:`peak_if_probed` never triggers the measurement.

The working set must be several times the last-level cache, or the probe
reads the cache's bandwidth and every percentage of peak comes out low:
an H100's L2 is 50 MB, so the default is 512 MiB a side (the reference's
16 MB would fit it).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("pinot_tpu_torch.ops.roofline")

PROBE_BYTES = int(os.environ.get("PINOT_TPU_HBM_PROBE_BYTES", 512 << 20))
# the host's caches are smaller: the CPU probe (the tests) keeps the
# process small unless the variable asks for more
CPU_PROBE_BYTES = int(os.environ.get("PINOT_TPU_HBM_PROBE_BYTES", 32 << 20))
_PROBE_REPEATS = 5

_lock = threading.Lock()
_peak_gbps: Optional[float] = None


def _env_peak() -> Optional[float]:
    v = os.environ.get("PINOT_TPU_HBM_PEAK_GBPS")
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        return None


def reset_probe() -> None:
    """Forget the cached measurement (tests)."""
    global _peak_gbps
    with _lock:
        _peak_gbps = None


def peak_if_probed() -> Optional[float]:
    """The cached peak (or the env override) WITHOUT triggering a
    measurement; None when nothing was measured yet."""
    env = _env_peak()
    if env is not None:
        return env
    return _peak_gbps


def hbm_peak_gbps(device=None) -> float:
    """Per-process memory peak in GB/s (read + write bytes counted),
    measured once on ``device`` (default: the card when there is one)
    and cached. Returns 0.0 when the probe cannot run: consumers treat
    <= 0 as "peak unknown" and skip the percentage."""
    global _peak_gbps
    env = _env_peak()
    if env is not None:
        return env
    with _lock:
        if _peak_gbps is None:
            try:
                _peak_gbps = _measure(device)
            except Exception:  # noqa: BLE001 — accounting never fails a query
                log.exception("memory peak probe failed; roofline %% off")
                _peak_gbps = 0.0
        return _peak_gbps


def _measure(device=None) -> float:
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    n = max(1 << 16, (PROBE_BYTES if device.type == "cuda"
                      else CPU_PROBE_BYTES) // 4)
    src = torch.ones(n, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)  # first touch
    bytes_moved = 2 * n * 4  # one read + one write of the buffer
    best = 0.0
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(_PROBE_REPEATS):
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
            best = max(best, bytes_moved / max(dt, 1e-9) / 1e9)
    else:
        for _ in range(_PROBE_REPEATS):
            t0 = time.perf_counter()
            dst.copy_(src)
            dt = time.perf_counter() - t0
            best = max(best, bytes_moved / max(dt, 1e-9) / 1e9)
    log.info("memory peak probe: %.2f GB/s over %d MiB (%s)", best,
             (n * 4) >> 20, device)
    return best


def pct_of_peak(gbps: Optional[float],
                peak: Optional[float] = None) -> Optional[float]:
    """``gbps`` as a percentage of ``peak`` (default: the cached probe),
    or None when either side is unknown."""
    if gbps is None:
        return None
    if peak is None:
        peak = peak_if_probed()
    if not peak or peak <= 0:
        return None
    return round(100.0 * gbps / peak, 3)
