"""Broker fleet membership: registration, liveness, drain, spend gossip.

the front door. The reference's ``BrokerStarter`` registers every
broker as a Helix BROKER-resource participant so clients and the
controller discover the fleet through ZK; ours registers under the
registry's existing ``Role.BROKER`` with the same heartbeat plumbing the
servers use — no second channel. Each heartbeat piggybacks a ``stats``
dict on the broker's ``InstanceInfo``:

    {"url": "http://host:port",      # the query endpoint clients rotate over
     "draining": bool,               # drain state (typed 503s while set)
     "qps": float,                   # served QPS over the last interval
     "queries": int,                 # cumulative queries served
     "cacheHits"/"cacheMisses": int, # broker result-cache counters
     "cacheHitRate": float,          # hits / (hits + misses)
     "tenantSpend": {tenant: cum}}   # admission gossip (see below)

Three consumers ride that one dict: the DB-API client's registry
discovery (rotate across live, non-draining ``url``s), ``clusterstat
--brokers`` (fleet health at a glance), and the admission controllers'
**spend gossip** — each broker publishes its cumulative per-tenant
admitted cost and debits every peer's delta from its own buckets
(broker/admission.py ``observe_peer_spend``), so N brokers share ONE
logical per-tenant budget with over-admit bounded by one heartbeat of
refill. Gossip is symmetric and leaderless: there is no budget
coordinator to elect or lose.

Drain (``BrokerFleetMember.drain()``) flips the broker to typed 503s,
publishes ``draining: true`` immediately (not at the next tick), and
keeps heartbeating so peers see a LIVE-but-draining broker — rotation
skips it, in-flight queries finish, and ``stop()`` deregisters cleanly.

Config: ``pinot.broker.fleet.heartbeat.interval.ms`` (default 2000 —
the same cadence as server heartbeats, and the bound in "a stale cache
entry on broker B dies within one heartbeat of an ingest through A").
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from pinot_tpu_torch.cluster.registry import HB_STALE_S, InstanceInfo, Role

log = logging.getLogger("pinot_tpu_torch.broker.fleet")


def live_brokers(registry, include_draining: bool = False) -> list:
    """Live BROKER-role instances (heartbeat within HB_STALE_S), newest
    registration order as the registry returns them. ``include_draining``
    keeps draining members (they still answer /health, not queries)."""
    out = []
    for info in registry.instances(Role.BROKER,
                                   live_ttl_ms=int(HB_STALE_S * 1000)):
        if not include_draining and (info.stats or {}).get("draining"):
            continue
        out.append(info)
    return out


def discover_broker_urls(registry) -> list:
    """The rotation list a DB-API client builds from a registry: every
    live, non-draining broker's published query URL."""
    urls = []
    for info in live_brokers(registry):
        url = (info.stats or {}).get("url")
        if url:
            urls.append(url)
    return urls


class BrokerFleetMember:
    """One broker's fleet membership: registers the broker under
    Role.BROKER, heartbeats liveness + piggybacked stats, applies peer
    spend gossip to the local admission controller, and owns the drain
    lifecycle. Composition, not inheritance — the Broker object stays
    usable standalone (tests, embedded connections) and joins a fleet by
    being wrapped."""

    def __init__(self, registry, broker, http_url: Optional[str] = None,
                 heartbeat_interval_ms: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.broker = broker
        self.http_url = http_url
        self.host = host
        self.port = int(port)
        if heartbeat_interval_ms is None:
            from pinot_tpu_torch.common.config import Configuration

            heartbeat_interval_ms = Configuration().get_float(
                "pinot.broker.fleet.heartbeat.interval.ms", 2_000.0)
        self.heartbeat_interval_s = max(0.01, heartbeat_interval_ms / 1e3)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # last cumulative queries_served + wall clock → interval QPS
        self._last_queries = 0
        self._last_tick = time.monotonic()

    @property
    def instance_id(self) -> str:
        return self.broker.broker_id

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "BrokerFleetMember":
        self.registry.register_instance(InstanceInfo(
            instance_id=self.instance_id, role=Role.BROKER,
            host=self.host, grpc_port=self.port,
            stats=self._stats()))
        self._last_tick = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-hb-{self.instance_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Deregister cleanly: peers re-discover without waiting out the
        liveness TTL, and their gossip last-seen snapshot for this broker
        is dropped on their next tick (a rejoin starts a fresh counter)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            self.registry.drop_instance(self.instance_id)
        except Exception:  # noqa: BLE001 — best-effort on teardown
            log.exception("fleet deregistration failed")

    # ---- drain -----------------------------------------------------------
    def drain(self) -> None:
        """Typed 503s from now on; the drain state publishes IMMEDIATELY
        (clients must stop landing here within one rotation, not one
        heartbeat)."""
        self.broker.draining = True
        self._beat()

    def undrain(self) -> None:
        self.broker.draining = False
        self._beat()

    # ---- heartbeat -------------------------------------------------------
    def _stats(self) -> dict:
        b = self.broker
        now = time.monotonic()
        queries = b.queries_served
        dt = max(1e-6, now - self._last_tick)
        qps = max(0, queries - self._last_queries) / dt
        self._last_queries = queries
        self._last_tick = now
        rc = b.result_cache
        hits, misses = rc.hits, rc.misses
        stats = {
            "url": self.http_url,
            "draining": bool(b.draining),
            "qps": round(qps, 3),
            "queries": queries,
            "cacheHits": hits,
            "cacheMisses": misses,
            "cacheHitRate": round(hits / (hits + misses), 4)
            if (hits + misses) else 0.0,
        }
        if b.admission is not None:
            spend = b.admission.spend_snapshot()
            if spend:
                stats["tenantSpend"] = spend
        return stats

    def _beat(self) -> None:
        """One tick: publish stats, ingest every live peer's gossip."""
        try:
            self.registry.heartbeat(self.instance_id, stats=self._stats())
        except Exception:  # noqa: BLE001 — a registry hiccup must not
            log.exception("fleet heartbeat failed")  # kill the loop
            return
        if self.broker.admission is None:
            return
        try:
            live_ids = set()
            for peer in live_brokers(self.registry, include_draining=True):
                if peer.instance_id == self.instance_id:
                    continue
                live_ids.add(peer.instance_id)
                spend = (peer.stats or {}).get("tenantSpend")
                if spend:
                    self.broker.admission.observe_peer_spend(
                        peer.instance_id, spend)
            # departed peers: drop their last-seen gossip snapshot so a
            # rejoin's fresh counter isn't diffed against the old one
            for gone in (set(self.broker.admission._peer_spend_seen)
                         - live_ids):
                self.broker.admission.forget_peer(gone)
        except Exception:  # noqa: BLE001
            log.exception("fleet gossip failed")

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            self._beat()
