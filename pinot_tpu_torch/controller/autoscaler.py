"""Controller autoscaler: pressure-driven server elasticity.

The closing of the overload loop: the heartbeats piggyback every
server's scheduler ``pressure()`` (admitted + queued queries) into the
registry; this periodic task watches those signals and

- **scales OUT** when the live fleet's mean pressure stays above the
  high-water mark for ``sustain_ticks`` consecutive ticks: it asks the
  deployment's ``spawn_fn`` for one more server, then republishes
  replica-group membership through the minimal-movement rebalance
  (``run_replica_group_repair``) so only the segments the new member
  must carry actually move;
- **scales IN** when mean pressure stays below the low-water mark: the
  least-loaded server drains FIRST (``drain_fn`` → the graceful
  ``ServerInstance.stop()`` — new submits answer retriable
  SERVER_SHUTTING_DOWN and the broker re-routes, so scale-in causes
  zero query errors), and membership republishes afterward.

Heartbeat-STALE instances (no heartbeat within ``hb_stale_s`` — the
same 3-interval rule the broker's LoadTracker applies) contribute
neither capacity nor pressure: a crashed server must read as missing
capacity (scale out), never as an idle peer (scale in).

The reference has no autoscaler at all — Pinot clusters resize by
operator action + manual rebalance; this is the ``QueryScheduler``
survey's missing elasticity leg built on our registry/heartbeat seams.

Deployment wiring: ``spawn_fn() -> instance_id | None`` and
``drain_fn(instance_id) -> bool`` abstract HOW servers start/stop —
in-process ``ServerInstance`` for tests/bench, ``admin start-server``
subprocesses or a k8s scale call in production. Attach via
``Controller.attach_autoscaler``; the controller's periodic loop runs
``tick()`` on the global-lead holder only, and every tick publishes the
autoscaler's state into the registry (``tools/clusterstat.py --load``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from pinot_tpu_torch.cluster.registry import HB_STALE_S, Role

log = logging.getLogger("pinot_tpu_torch.autoscaler")


class ControllerAutoscaler:
    def __init__(self, controller,
                 spawn_fn: Callable[[], Optional[str]],
                 drain_fn: Callable[[str], bool],
                 min_servers: int = 1, max_servers: int = 4,
                 high_water: float = 4.0, low_water: float = 0.5,
                 sustain_ticks: int = 3, cooldown_ticks: int = 2,
                 hb_stale_s: float = HB_STALE_S):
        if low_water >= high_water:
            raise ValueError("low_water must sit below high_water "
                             f"({low_water} >= {high_water})")
        self.controller = controller
        self.registry = controller.registry
        self.spawn_fn = spawn_fn
        self.drain_fn = drain_fn
        self.min_servers = max(1, int(min_servers))
        self.max_servers = max(self.min_servers, int(max_servers))
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.sustain_ticks = max(1, int(sustain_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.hb_stale_s = float(hb_stale_s)
        self._above = 0
        self._below = 0
        self._cooldown = 0
        self.actions: list = []   # bounded history of scale decisions
        self.num_scale_out = 0
        self.num_scale_in = 0

    # ---- signal ----------------------------------------------------------
    def _live_pressure(self) -> tuple:
        """([live instance ids sorted by pressure], mean pressure).
        Heartbeat-stale instances are excluded from BOTH sides: a crashed
        server is missing capacity, not an idle peer."""
        now_ms = time.time() * 1000
        live = []
        for i in self.registry.instances(Role.SERVER):
            age_s = max(0.0, (now_ms - i.last_heartbeat_ms) / 1e3)
            if age_s <= self.hb_stale_s:
                live.append((float(getattr(i, "pressure", 0.0) or 0.0),
                             i.instance_id))
        live.sort()
        mean = sum(p for p, _ in live) / len(live) if live else 0.0
        return [inst for _p, inst in live], mean

    # ---- the control loop ------------------------------------------------
    def tick(self) -> Optional[dict]:
        """One autoscale decision; returns the action taken (or None).
        Called from the controller periodic loop on the global lead."""
        live, mean = self._live_pressure()
        n = len(live)
        action = None
        if self._cooldown > 0:
            # let the previous action's rebalance + routing settle before
            # judging pressure again — scaling on a half-moved cluster's
            # transient pressure would oscillate
            self._cooldown -= 1
        else:
            if mean >= self.high_water and n < self.max_servers:
                self._above += 1
                self._below = 0
            elif mean <= self.low_water and n > self.min_servers:
                self._below += 1
                self._above = 0
            else:
                self._above = self._below = 0
            if self._above >= self.sustain_ticks:
                action = self._scale_out(n, mean)
            elif self._below >= self.sustain_ticks:
                action = self._scale_in(live, mean)
        self._publish(n, mean, action)
        return action

    def _scale_out(self, n: int, mean: float) -> Optional[dict]:
        try:
            new_id = self.spawn_fn()
        except Exception:
            log.exception("autoscaler spawn failed")
            new_id = None
        self._above = 0
        self._cooldown = self.cooldown_ticks
        if new_id is None:
            return None
        self.num_scale_out += 1
        # grow replica groups for the hot tables with MINIMAL movement:
        # the repair rebuilds membership over the new live set and
        # moves only the segments the group change requires
        try:
            self.controller.run_replica_group_repair()
        except Exception:
            log.exception("post-scale-out replica-group repair failed")
        return self._note("scale_out", new_id, n + 1, mean)

    def _scale_in(self, live: list, mean: float) -> Optional[dict]:
        # drain the LEAST-loaded live server (live is pressure-sorted);
        # the graceful drain is the exit path: in-flight queries
        # finish, new submits re-route — zero query errors by contract
        victim = live[0]
        try:
            ok = bool(self.drain_fn(victim))
        except Exception:
            log.exception("autoscaler drain of %s failed", victim)
            ok = False
        self._below = 0
        self._cooldown = self.cooldown_ticks
        if not ok:
            return None
        self.num_scale_in += 1
        try:
            self.controller.run_replica_group_repair()
        except Exception:
            log.exception("post-scale-in replica-group repair failed")
        return self._note("scale_in", victim, len(live) - 1, mean)

    def _note(self, kind: str, instance: str, n_after: int,
              mean: float) -> dict:
        action = {"action": kind, "instance": instance,
                  "servers_after": n_after,
                  "mean_pressure": round(mean, 2),
                  "ts": round(time.time(), 1)}
        self.actions.append(action)
        del self.actions[:-16]  # bounded history
        log.info("autoscaler %s %s (fleet -> %d, pressure %.2f)",
                 kind, instance, n_after, mean)
        return action

    def _publish(self, n: int, mean: float, action) -> None:
        """Registry-published state: what clusterstat --load renders."""
        try:
            self.registry.set_autoscaler_state({
                "servers": n,
                "min": self.min_servers, "max": self.max_servers,
                "meanPressure": round(mean, 2),
                "highWater": self.high_water, "lowWater": self.low_water,
                "aboveTicks": self._above, "belowTicks": self._below,
                "cooldownTicks": self._cooldown,
                "scaleOuts": self.num_scale_out,
                "scaleIns": self.num_scale_in,
                "lastAction": action or (self.actions[-1]
                                         if self.actions else None),
            })
        except Exception:
            log.exception("autoscaler state publish failed")
