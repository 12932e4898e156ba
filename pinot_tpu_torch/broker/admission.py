"""Per-tenant admission control: priority-classed token buckets + shedding.

The reference's only overload defenses are the
server-side ``QueryScheduler`` family (FCFS / resource-aware token
buckets) and the per-table QPS quota — neither knows WHO is asking, so a
single spiking tenant starves everyone behind one shared 429 wall. This
module puts a workload-isolation layer in FRONT of the
``QueryQuotaManager``:

- **Tenant resolution**: the authenticated principal (broker HTTP basic
  auth) wins; a query may also self-identify via ``SET workloadName =
  'dashboards'`` (the reference's ``workloadName`` query option); else
  the shared ``default`` bucket.
- **Priority classes**: ``interactive`` > ``dashboard`` > ``adhoc``
  (weights 4/2/1). The query's class (``SET priorityClass``, else the
  tenant's configured default) ships to the servers as the
  weighted-fair slot weight (engine/scheduler.py) and picks the
  load-shed rung; the tenant's CONFIGURED class
  (``pinot.broker.admission.tenant.<name>.priority``) scales its bucket
  refill — a client cannot self-upgrade its own refill budget with a
  per-query SET.
- **Token buckets**: one per tenant, class-scaled rate. A dry bucket
  does NOT immediately 429: the broker first tries a bounded-staleness
  result-cache read (``SET maxStalenessMs`` — broker/broker.py
  ``_shed_response``), and only rejects when no eligible entry exists,
  with ``retryAfterSeconds`` computed from THIS tenant's actual refill
  time (capped at 5 s), never the table-quota's fixed hint.
- **Queue jumping**: literal digests whose last execution was sub-RTT
  (broker result cache or device partials cache hit) are remembered;
  such queries admit at a fraction of a token and ride the
  ``interactive`` weight server-side — repeat dashboard panels never
  wait behind a cold scan's admission debt.
- **Load shedding**: the broker-wide decayed ``LoadTracker`` score
  (max across servers) crossing ``shed_threshold`` sheds ``adhoc``
  first, ``dashboard`` at 1.5x, ``interactive`` only at 2x — graceful
  brownout instead of a cliff.

Config (common/config.py keys, all ``pinot.broker.admission.*``):

    enabled (false), rate.qps (20), burst (40),
    default.priority (dashboard), shed.load.threshold (0 = off),
    tenant.<name>.rate / .burst / .priority

Chaos: the ``scheduler.admit`` fault point (common/faults.py, modes
error|delay) fires inside ``try_admit`` with the tenant as target, so
tests can starve admission deterministically and prove the typed
429/degraded contract.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

from pinot_tpu_torch.common import faults

# one notion of priority end to end: the SAME weights drive the tenant
# bucket's refill scaling here and the server scheduler's weighted-fair
# slot share (single-sourced in engine/scheduler.py)
from pinot_tpu_torch.engine.scheduler import PRIORITY_WEIGHTS

RETRY_AFTER_CAP_S = 5.0

# sub-RTT queries (known cache-hit digests) charge this fraction of a
# token: serving them is two orders of magnitude cheaper than a cold
# scan, and charging full price would let admission starve exactly the
# traffic the caches made nearly free
SUBRTT_COST = 0.1


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    tenant: str
    priority: str
    # typed shed reason carried through responses + the query log
    # (None when admitted): tenant_bucket_dry | load_shed |
    # admission_fault
    reason: Optional[str] = None
    # seconds until this tenant's bucket refills one token (already
    # capped at RETRY_AFTER_CAP_S) — the 429 Retry-After basis
    retry_after_s: float = 0.0
    sub_rtt: bool = False


class _TenantBucket:
    __slots__ = ("tokens", "last", "rate", "burst", "admitted", "shed",
                 "spent")

    def __init__(self, rate: float, burst: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst  # cold tenants start with full burst
        self.last = time.monotonic()
        self.admitted = 0
        self.shed = 0
        # cumulative admitted token cost — the fleet-gossip counter
        #: peers read it from broker heartbeats and debit the
        # DELTA from their own bucket so N brokers share one logical
        # per-tenant budget
        self.spent = 0.0

    def refill(self, now: float) -> None:
        dt = now - self.last
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + self.rate * dt)
            self.last = now


class TenantAdmissionController:
    MAX_TENANTS = 1024      # overflow tenants share one bucket
    MAX_SUBRTT_DIGESTS = 512

    def __init__(self, rate_qps: float = 20.0, burst: float = 40.0,
                 default_priority: str = "dashboard",
                 shed_load_threshold: float = 0.0,
                 tenant_overrides: Optional[dict] = None):
        if default_priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"unknown priority class {default_priority!r} "
                f"({'|'.join(sorted(PRIORITY_WEIGHTS))})")
        self.rate_qps = float(rate_qps)
        self.burst = float(burst)
        self.default_priority = default_priority
        # broker-wide load score at which shedding begins (0 = load
        # shedding off; bucket admission still applies)
        self.shed_load_threshold = float(shed_load_threshold)
        # {tenant: {"rate": .., "burst": .., "priority": ..}}
        self.tenant_overrides = dict(tenant_overrides or {})
        self._lock = threading.Lock()
        self._buckets: dict[str, _TenantBucket] = {}
        # literal-digest -> last-seen ts for queries whose previous
        # execution was sub-RTT (result-cache or device-partials hit)
        self._subrtt: "collections.OrderedDict" = collections.OrderedDict()
        self.num_admitted = 0
        self.num_shed = 0
        self.num_shed_stale_served = 0  # bumped by the broker's shed path
        # fleet-gossip bookkeeping: last-seen cumulative spend
        # per peer broker, {peer_id: {tenant: cum_spend}} — deltas against
        # it are debited locally so the fleet shares one logical budget
        self._peer_spend_seen: dict = {}

    @classmethod
    def from_config(cls, conf) -> "TenantAdmissionController":
        # per-tenant overrides ride explicit config keys; the tenant list
        # itself comes from pinot.broker.admission.tenants (csv) since a
        # flat Configuration cannot enumerate key prefixes
        overrides: dict = {}
        names = str(conf.get("pinot.broker.admission.tenants", "") or "")
        for name in (n.strip() for n in names.split(",")):
            if not name:
                continue
            ent: dict = {}
            rate = conf.get(f"pinot.broker.admission.tenant.{name}.rate")
            if rate is not None:
                ent["rate"] = float(rate)
            burst = conf.get(f"pinot.broker.admission.tenant.{name}.burst")
            if burst is not None:
                ent["burst"] = float(burst)
            prio = conf.get(f"pinot.broker.admission.tenant.{name}.priority")
            if prio is not None:
                ent["priority"] = str(prio)
            overrides[name] = ent
        return cls(
            rate_qps=conf.get_float("pinot.broker.admission.rate.qps", 20.0),
            burst=conf.get_float("pinot.broker.admission.burst", 40.0),
            default_priority=str(conf.get(
                "pinot.broker.admission.default.priority", "dashboard")),
            shed_load_threshold=conf.get_float(
                "pinot.broker.admission.shed.load.threshold", 0.0),
            tenant_overrides=overrides,
        )

    # ---- tenant / priority resolution ------------------------------------
    def resolve(self, q, principal: Optional[str] = None) -> tuple:
        """(tenant, priority class) for a compiled query: the auth
        principal wins, then ``SET workloadName``, then ``default``;
        ``SET priorityClass`` overrides the tenant's configured default
        class. Unknown class names fall back to the controller default
        rather than erroring — a typo'd dashboard must not break."""
        opts = q.options_ci()
        tenant = principal or None
        if not tenant:
            wl = opts.get("workloadname")
            tenant = str(wl) if wl else "default"
        prio = opts.get("priorityclass")
        if prio is not None and str(prio) in PRIORITY_WEIGHTS:
            return tenant, str(prio)
        cfg = self.tenant_overrides.get(tenant, {})
        prio = cfg.get("priority")
        if prio in PRIORITY_WEIGHTS:
            return tenant, prio
        return tenant, self.default_priority

    def _bucket(self, tenant: str) -> _TenantBucket:
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.MAX_TENANTS:
                tenant = "__overflow__"
                b = self._buckets.get(tenant)
                if b is not None:
                    return b
            cfg = self.tenant_overrides.get(tenant, {})
            # the bucket's refill scales by the TENANT'S CONFIGURED
            # class (override, else controller default) — never the
            # requesting query's class: a per-query SET priorityClass
            # must change slot weight and shed rung, not let a client
            # self-upgrade its own refill budget (and the first query's
            # class must not freeze the tenant's rate forever)
            prio = cfg.get("priority")
            if prio not in PRIORITY_WEIGHTS:
                prio = self.default_priority
            weight = PRIORITY_WEIGHTS[prio]
            rate = float(cfg.get("rate", self.rate_qps * weight /
                                 PRIORITY_WEIGHTS[self.default_priority]))
            burst = float(cfg.get("burst", max(1.0, self.burst)))
            b = self._buckets[tenant] = _TenantBucket(rate, burst)
        return b

    # ---- sub-RTT digest memo (queue jumping) -----------------------------
    def note_sub_rtt(self, digest) -> None:
        """Record a literal digest whose execution was sub-RTT (broker
        result-cache or device partials-cache hit): its repeats admit at
        SUBRTT_COST and ride the interactive slot weight server-side."""
        if digest is None:
            return
        with self._lock:
            self._subrtt[digest] = time.monotonic()
            self._subrtt.move_to_end(digest)
            while len(self._subrtt) > self.MAX_SUBRTT_DIGESTS:
                self._subrtt.popitem(last=False)

    def is_sub_rtt(self, digest) -> bool:
        if digest is None:
            return False
        with self._lock:
            return digest in self._subrtt

    # ---- the admission decision ------------------------------------------
    def try_admit(self, tenant: str, priority: str,
                  load_score: Optional[float] = None,
                  sub_rtt: bool = False) -> AdmissionDecision:
        """One non-blocking decision: charge the tenant's bucket, apply
        the load-shed ladder, fire the ``scheduler.admit`` chaos seam.
        Never waits (the broker has no admission queue — degrade-or-429
        IS the backpressure); ``delay``-mode faults sleep here to model a
        slow admission path deterministically."""
        if faults.ACTIVE:
            try:
                faults.inject("scheduler.admit", target=tenant)
            except faults.FaultInjected:
                with self._lock:
                    self.num_shed += 1
                return AdmissionDecision(
                    False, tenant, priority, reason="admission_fault",
                    retry_after_s=min(RETRY_AFTER_CAP_S, 1.0),
                    sub_rtt=sub_rtt)
        weight = PRIORITY_WEIGHTS.get(priority, 1.0)
        # load-shed ladder: adhoc sheds at the threshold, dashboard at
        # 1.5x, interactive at 2x; known-sub-RTT repeats are exempt
        # (they cost no server slot worth protecting)
        if (self.shed_load_threshold > 0 and load_score is not None
                and not sub_rtt):
            bar = self.shed_load_threshold * (
                2.0 if priority == "interactive"
                else 1.5 if priority == "dashboard" else 1.0)
            if load_score >= bar:
                with self._lock:
                    b = self._bucket(tenant)
                    b.shed += 1
                    self.num_shed += 1
                return AdmissionDecision(
                    False, tenant, priority, reason="load_shed",
                    retry_after_s=min(RETRY_AFTER_CAP_S, 1.0),
                    sub_rtt=sub_rtt)
        cost = SUBRTT_COST if sub_rtt else 1.0
        now = time.monotonic()
        with self._lock:
            b = self._bucket(tenant)
            b.refill(now)
            if b.tokens >= cost:
                b.tokens -= cost
                b.admitted += 1
                b.spent += cost
                self.num_admitted += 1
                return AdmissionDecision(True, tenant, priority,
                                         sub_rtt=sub_rtt)
            # dry: Retry-After from THIS bucket's actual refill time —
            # (cost - tokens) / rate seconds until the query could pass
            need = max(0.0, cost - b.tokens)
            retry = need / b.rate if b.rate > 0 else RETRY_AFTER_CAP_S
            b.shed += 1
            self.num_shed += 1
        return AdmissionDecision(
            False, tenant, priority, reason="tenant_bucket_dry",
            retry_after_s=min(RETRY_AFTER_CAP_S, retry), sub_rtt=sub_rtt)

    # ---- fleet spend gossip -----------------------------------
    # Every broker keeps the tenant's FULL refill rate but debits what its
    # peers admitted since the last heartbeat: at equilibrium each broker
    # nets (rate − fleet_admit_rate_elsewhere) tokens/s, so the fleet as a
    # whole admits at ONE logical rate regardless of how a tenant sprays
    # its queries. The budget is eventual — a peer's spend lands one
    # heartbeat late — so the worst-case over-admit is bounded by one
    # heartbeat of refill (plus each broker's independent cold-start
    # burst, a one-time transient).

    def spend_snapshot(self) -> dict:
        """{tenant: cumulative admitted token cost} — published in the
        broker's fleet heartbeat for peers to diff against."""
        with self._lock:
            return {name: round(b.spent, 3)
                    for name, b in self._buckets.items() if b.spent > 0}

    def observe_peer_spend(self, peer_id: str, spend: dict) -> None:
        """Debit a peer broker's admitted spend since its last gossip.

        ``spend`` is the peer's cumulative {tenant: cost} snapshot; the
        delta vs the last-seen snapshot comes out of the local bucket's
        tokens (floored at -burst so a hot peer can dent but not
        permanently bankrupt this broker). A peer whose counter went
        BACKWARD restarted — treat its full counter as fresh spend once
        rather than ignoring it."""
        if not peer_id or not spend:
            return
        with self._lock:
            seen = self._peer_spend_seen.setdefault(peer_id, {})
            for tenant, cum in spend.items():
                try:
                    cum = float(cum)
                except (TypeError, ValueError):
                    continue
                last = seen.get(tenant, 0.0)
                delta = cum if cum < last else cum - last
                seen[tenant] = cum
                if delta <= 0:
                    continue
                b = self._bucket(tenant)
                b.refill(time.monotonic())
                b.tokens = max(-b.burst, b.tokens - delta)

    def forget_peer(self, peer_id: str) -> None:
        """Drop a departed peer's last-seen snapshot (a rejoining broker
        starts a fresh counter and must not be double-debited)."""
        with self._lock:
            self._peer_spend_seen.pop(peer_id, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "admitted": self.num_admitted,
                "shed": self.num_shed,
                "shed_stale_served": self.num_shed_stale_served,
                "tenants": {
                    name: {
                        "tokens": round(b.tokens, 2),
                        "rate": b.rate, "burst": b.burst,
                        "admitted": b.admitted, "shed": b.shed,
                        "spent": round(b.spent, 2),
                    } for name, b in self._buckets.items()
                },
            }
