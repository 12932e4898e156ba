"""Fault-injection harness: named injection points at the failure seams
(a copy of pinot_tpu/common/faults.py for the port).

The robustness tier (deadline propagation, replica retry + hedging,
device-error recovery) is only trustworthy if every failure mode it claims
to survive can be *produced on demand* — the reference proves its broker
stack with ChaosMonkey-style integration tests
(OfflineClusterIntegrationTest server kills, PeerDownloadLLCRealtime...);
this module is the in-process equivalent. Production code calls
``inject(point, target=...)`` at its seams; with no faults installed the
call never happens (callers gate on the module-level ``ACTIVE`` bool — one
attribute read), so the harness is zero-overhead when disabled.

Points wired in this codebase:

    transport.submit     broker→server RPC, per server instance
                         (drop / delay / blackhole a replica)
    server.crash         server dies mid-query (RPC fails at the
                         transport level, NOT in-band)
    device.launch        device launch failure (a simulated runtime error:
                         RESOURCE_EXHAUSTED)
    device.fetch         failure on the blocking wait for the copy
    chunklet.promote     consuming-segment chunklet promotion failure
    peer.fetch           peer segment download failure
    scheduler.admit      admission starvation (modes
                         error|delay). Two seams share the point: the
                         broker's tenant admission controller (target =
                         tenant name) — an injected error sheds the
                         query through the typed degrade-or-429 path —
                         and the server's scheduler admission (target =
                         instance id) — an injected error becomes a
                         typed QUERY_SCHEDULING_TIMEOUT, never a hang
                         or a transport fault
    exchange.transfer    distributed stage-2 partition ship (
                         target = the RECEIVING instance id): fired in
                         the SENDING server before every mailbox offer
                         — self-sends included — so blackholing one
                         server starves every sender addressing it. The
                         sender converts the fault into a typed
                         EXCHANGE_TRANSFER_FAILED naming the peer; the
                         broker excludes that instance and retries the
                         exchange on replicas, or settles as a typed
                         partialResult inside the deadline

Installation: programmatic (``install(Fault(...))`` — what the chaos
suite uses), or the ``PINOT_TPU_FAULTS`` env var parsed once at first
use: ``point[@target]=mode[:arg][#times]`` entries joined by ``;``, e.g.

    PINOT_TPU_FAULTS="transport.submit@server_1=blackhole;
                      transport.submit@server_2=delay:200"

Modes: ``error`` (raise FaultInjected), ``crash`` (raise — callers place
the seam so the exception escapes in-band handling), ``delay:<ms>``
(sleep, then proceed), ``blackhole[:<ms>]`` (sleep the full window —
default 60s — then raise: the caller's own deadline fires first, like a
dropped-packets replica). ``#N`` fires the fault at most N times then
disarms (e.g. ``device.launch=error#2`` poisons exactly the launch and
its retry).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("pinot_tpu_torch.faults")

# fast-path gate: seams check ``if faults.ACTIVE:`` before calling
# inject() — with no faults installed, production pays one module-attr
# read and a falsy test per seam
ACTIVE = False

_BLACKHOLE_DEFAULT_MS = 60_000.0


class FaultInjected(RuntimeError):
    """An injected failure (transport/server/promotion seams)."""


class InjectedDeviceError(RuntimeError):
    """Injected device-runtime failure. Deliberately NOT a FaultInjected
    subclass: the device recovery path must treat it exactly like a real
    runtime error (an out-of-memory) it cannot tell apart from it."""


@dataclasses.dataclass
class Fault:
    point: str                      # injection point name
    target: Optional[str] = None    # substring match on the seam's target
    mode: str = "error"             # error | crash | delay | blackhole
    delay_ms: float = 0.0
    times: Optional[int] = None     # fire at most N times; None = always
    fired: int = 0                  # observability: how often it fired

    def matches(self, point: str, target) -> bool:
        if self.point != point:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.target is None:
            return True
        return target is not None and self.target in str(target)


_lock = threading.Lock()
_faults: list[Fault] = []
_env_loaded = False


def install(fault: Fault) -> Fault:
    """Arm a fault. Returns it (the caller can read ``fired`` later)."""
    global ACTIVE
    with _lock:
        _faults.append(fault)
        ACTIVE = True
    return fault


def clear(point: Optional[str] = None) -> None:
    """Disarm faults (all, or just one point's)."""
    global ACTIVE
    with _lock:
        if point is None:
            _faults.clear()
        else:
            _faults[:] = [f for f in _faults if f.point != point]
        ACTIVE = bool(_faults)


def active_faults() -> list:
    with _lock:
        return list(_faults)


def parse_spec(spec: str) -> list:
    """``point[@target]=mode[:arg][#times]`` entries joined by ``;``."""
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        lhs, rhs = entry.split("=", 1)
        point, _, target = lhs.partition("@")
        target = target or None
        times = None
        if "#" in rhs:
            rhs, times_s = rhs.rsplit("#", 1)
            times = int(times_s)
        mode, _, arg = rhs.partition(":")
        delay_ms = float(arg) if arg else (
            _BLACKHOLE_DEFAULT_MS if mode == "blackhole" else 0.0)
        out.append(Fault(point=point.strip(),
                         target=target.strip() if target is not None
                         else None,
                         mode=mode.strip(), delay_ms=delay_ms, times=times))
    return out


def install_from_env(env_var: str = "PINOT_TPU_FAULTS") -> int:
    """Parse the env spec once; safe to call repeatedly."""
    global _env_loaded
    with _lock:
        if _env_loaded:
            return 0
        _env_loaded = True
    spec = os.environ.get(env_var, "")
    if not spec:
        return 0
    faults = parse_spec(spec)
    for f in faults:
        install(f)
    if faults:
        log.warning("fault injection ARMED from %s: %s", env_var, faults)
    return len(faults)


# arm env-configured faults at import: the seams' ACTIVE check must see
# them without every process having to call install_from_env explicitly
install_from_env()


def inject(point: str, target=None, bound_ms: float = None) -> None:
    """Fire any armed fault matching (point, target). Called by seams
    only when ``ACTIVE`` is truthy. ``delay`` sleeps then returns;
    ``blackhole`` sleeps its window then raises; ``error``/``crash``
    raise immediately. ``device.*`` points raise InjectedDeviceError so
    the recovery path exercises its real runtime-error handling.

    ``bound_ms``: the caller's own deadline — a blackhole sleeps at most
    this long before failing (a real blackholed RPC would be cut by the
    transport deadline the same way; without the bound, every blackholed
    call would pin a broker pool thread for the full window)."""
    with _lock:
        hit = next((f for f in _faults if f.matches(point, target)), None)
        if hit is None:
            return
        hit.fired += 1
    msg = f"injected fault at {point}" + \
        (f" (target {target})" if target is not None else "")
    if hit.mode == "delay":
        time.sleep(hit.delay_ms / 1000.0)
        return
    if hit.mode == "blackhole":
        window_ms = hit.delay_ms or _BLACKHOLE_DEFAULT_MS
        if bound_ms is not None:
            window_ms = max(0.0, min(window_ms, bound_ms))
        time.sleep(window_ms / 1000.0)
        raise FaultInjected(f"{msg}: blackhole window elapsed")
    if point.startswith("device."):
        raise InjectedDeviceError(f"{msg}: RESOURCE_EXHAUSTED (simulated)")
    raise FaultInjected(msg)
