"""Cluster registry: the Helix/ZooKeeper replacement.

The reference coordinates everything through Helix IdealState/ExternalView in
ZK (SURVEY.md §1: PinotHelixResourceManager writes IdealState, brokers watch
ExternalView, servers run the OFFLINE/CONSUMING/ONLINE state model). The TPU
build replaces that with a small registry of durable maps:

- instances (role, endpoint, heartbeat)       — LiveInstance analog
- tables (config + schema JSON)               — PROPERTYSTORE configs
- segments (metadata + deep-store URI + state)— SegmentZKMetadata
- assignment {table: {segment: [instanceId]}} — IdealState
- external view {table: {segment: [instanceId]}} — what servers actually
  serve (brokers route on this, exactly like the reference's brokers watch
  ExternalView, BrokerRoutingManager.java:87)
- partition assignment for realtime tables    — LLC partition → server

Two implementations share the interface: in-memory (single process, tests)
and file-backed JSON-with-lock (multi-process on a shared filesystem). A
proper multi-host deployment would swap in an etcd-backed impl behind the
same surface — state transitions are polled by servers (sync loop), not
pushed, which replaces Helix messages with level-triggered reconciliation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import threading
import time
from typing import Optional

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig


class Role:
    SERVER = "SERVER"
    BROKER = "BROKER"
    CONTROLLER = "CONTROLLER"
    MINION = "MINION"


class UnresolvableSegmentLocation(ValueError):
    """``SegmentRecord.location`` names a URI scheme no registered
    PinotFS plugin resolves: raised at
    ``add_segment`` time so a bad deep-store URI fails at registration —
    not at the first cold-tier download, hours later on a different
    host."""


def _validate_location(location: str) -> None:
    """Scheme-resolvability check against the PinotFS plugin registry.
    Bare paths and ``file://`` always resolve (LocalFS is built in);
    anything else must have a registered ``fs`` factory. The registry
    lookup is a lock + dict probe after the one-time plugin bootstrap,
    so this is cheap enough for the ingest-path add_segment callers."""
    if not location:
        return  # consuming segments register location-less
    from urllib.parse import urlparse

    scheme = urlparse(location).scheme
    if scheme in ("", "file") or "://" not in location:
        # absolute/relative paths (a lone drive-letter-style colon parses
        # as a scheme but is still a path) and the built-in file scheme
        return
    from pinot_tpu_torch.common.plugins import plugin_registry

    try:
        plugin_registry.load("fs", scheme)
    except KeyError as e:
        raise UnresolvableSegmentLocation(
            f"segment location {location!r}: no PinotFS plugin registered "
            f"for scheme {scheme!r} ({e})") from None


class SegmentState:
    ONLINE = "ONLINE"
    CONSUMING = "CONSUMING"
    OFFLINE = "OFFLINE"


# heartbeat-staleness rule, single-sourced: an instance that
# missed 3 heartbeat intervals (default 2 s cadence) is presumed
# crashed/wedged. The broker's LoadTracker expires its load sample, the
# controller autoscaler counts it as missing capacity, and the
# /cluster/load endpoint renders it STALE — all off THIS constant.
HB_STALE_S = 6.0


@dataclasses.dataclass
class InstanceInfo:
    instance_id: str
    role: str
    host: str = "127.0.0.1"
    grpc_port: int = 0
    last_heartbeat_ms: int = 0
    # instance tags (Helix tag analog): tier placement targets one tag
    tags: list = dataclasses.field(default_factory=list)
    # load signal published with the heartbeat (scheduler pressure():
    # admitted + queued queries) — the broker's load-aware routing reads
    # it when no fresher piggybacked response signal exists
    pressure: float = 0.0
    # {logical table: freshness epoch} (common/freshness.py) — the broker
    # result cache's staleness view when queries aren't flowing
    table_epochs: dict = dataclasses.field(default_factory=dict)
    # per-segment access-temperature snapshot (server/heat.py
    # SegmentHeatTracker.snapshot(): {table: {segment: {rate, bytesRate,
    # accesses, bytes, lastAccessTs}}}, hottest-N per table) — the controller
    # aggregates it behind /tables/{t}/heat, the input the tier
    # lifecycle's promotion/demotion (server/tiering.py) consumes
    heat: dict = dataclasses.field(default_factory=dict)
    # per-segment tier map (server/tiering.py TierManager
    # .snapshot(): {table: {segment: "hot"|"warm"|"cold"}}) — the
    # controller's tier-aware replica-group assignment reads it
    # (controller.py aggregate_tiers / rebalance_tiered)
    tiers: dict = dataclasses.field(default_factory=dict)
    # role-specific heartbeat-piggybacked counters: brokers
    # publish {url, draining, qps, cacheHitRate, tenantSpend, ...} here so
    # clients discover query URLs, clusterstat --brokers renders fleet
    # health, and admission gossip shares one logical per-tenant budget
    # across the fleet — all without a second channel
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.grpc_port}"


@dataclasses.dataclass
class SegmentRecord:
    name: str
    table: str
    n_docs: int = 0
    location: str = ""          # deep-store URI (directory path for localfs)
    state: str = SegmentState.ONLINE
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    partition_column: Optional[str] = None
    partition_ids: Optional[list] = None
    partition_function: Optional[str] = None
    num_partitions: Optional[int] = None
    crc: Optional[str] = None
    push_time_ms: int = 0
    # per-column {"min": v, "max": v} from segment metadata (JSON-plain
    # values) — broker-side value pruning (broker/segment_pruner.py)
    column_stats: Optional[dict] = None


def _to_json(state: dict) -> dict:
    return {
        "instances": {k: dataclasses.asdict(v) for k, v in state["instances"].items()},
        "tables": state["tables"],
        "schemas": state["schemas"],
        "segments": {
            t: {n: dataclasses.asdict(r) for n, r in segs.items()}
            for t, segs in state["segments"].items()
        },
        "assignment": state["assignment"],
        "external_view": state["external_view"],
        "partition_assignment": state["partition_assignment"],
        "segment_completion": state.get("segment_completion", {}),
        "tasks": state.get("tasks", {}),
        "task_metadata": state.get("task_metadata", {}),
        "segment_lineage": state.get("segment_lineage", {}),
        "replica_groups": state.get("replica_groups", {}),
        "autoscaler": state.get("autoscaler", {}),
    }


def _from_json(d: dict) -> dict:
    return {
        "instances": {k: InstanceInfo(**v) for k, v in d.get("instances", {}).items()},
        "tables": d.get("tables", {}),
        "schemas": d.get("schemas", {}),
        "segments": {
            t: {n: SegmentRecord(**r) for n, r in segs.items()}
            for t, segs in d.get("segments", {}).items()
        },
        "assignment": d.get("assignment", {}),
        "external_view": d.get("external_view", {}),
        "partition_assignment": d.get("partition_assignment", {}),
        "segment_completion": d.get("segment_completion", {}),
        "tasks": d.get("tasks", {}),
        "task_metadata": d.get("task_metadata", {}),
        "segment_lineage": d.get("segment_lineage", {}),
        "replica_groups": d.get("replica_groups", {}),
        "autoscaler": d.get("autoscaler", {}),
    }


class ClusterRegistry:
    """In-memory registry (single-process clusters and tests)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._state = {
            "instances": {},
            "tables": {},
            "schemas": {},
            "segments": {},
            "assignment": {},
            "external_view": {},
            "partition_assignment": {},
            "replica_groups": {},
            "leases": {},
        }
        # bumped by every mutation that can change what a query routes to
        # or reads (segments, assignment, external view, lineage, replica
        # groups — NOT heartbeats): the broker's routing snapshot cache
        # and result cache key on it
        self._routing_gen = 0
        self._write_ver = 0  # any-write token (state_version)

    def _note_routing_change(self) -> None:
        with self._lock:
            self._routing_gen += 1

    def routing_generation(self) -> int:
        """Cheap monotonic token: while it holds still, a broker may
        reuse its cached routing snapshot and serve fresh-epoch cached
        results (FileRegistry overrides this with per-section version
        counters so the token is cross-process)."""
        with self._lock:
            return self._routing_gen

    def state_version(self) -> int:
        """Change token over the whole state: pollers skip work while it
        holds still. The in-memory form bumps on EVERY write tx (an
        over-approximation — heartbeats count — but in-process polls are
        nanoseconds; FileRegistry narrows it to real section changes)."""
        with self._lock:
            return self._write_ver

    def sections_version(self, sections) -> int:
        """Section-subset change token (FileRegistry refines this to the
        named sections' version counters; in-memory, any write bumps)."""
        with self._lock:
            return self._write_ver

    # ---- tx plumbing (overridden by FileRegistry) ------------------------
    def _read(self) -> dict:
        return self._state

    def _write(self, state: dict) -> None:
        self._state = state

    def _tx(self, fn, write: bool = True):
        with self._lock:
            state = self._read()
            out = fn(state)
            if write:
                self._write(state)
                self._write_ver += 1
            return out

    def _tx_read(self, fn):
        return self._tx(fn, write=False)

    # ---- instances -------------------------------------------------------
    def register_instance(self, info: InstanceInfo) -> None:
        info.last_heartbeat_ms = int(time.time() * 1000)
        self._tx(lambda s: s["instances"].__setitem__(info.instance_id, info))

    def heartbeat(self, instance_id: str, pressure: float = None,
                  table_epochs: dict = None, heat: dict = None,
                  tiers: dict = None, stats: dict = None) -> None:
        """Liveness tick, optionally carrying the instance's current load
        (scheduler pressure), per-table freshness epochs, the per-segment
        heat snapshot, the per-segment tier map,
        and role-specific counters (broker fleet stats) — the
        passive half of the broker's load/staleness view (the active half
        rides piggybacked in every DataTable response) and the
        controller's temperature/tier aggregation input."""

        def fn(s):
            info = s["instances"].get(instance_id)
            if info is not None:
                info.last_heartbeat_ms = int(time.time() * 1000)
                if pressure is not None:
                    info.pressure = float(pressure)
                if table_epochs is not None:
                    info.table_epochs = dict(table_epochs)
                if heat is not None:
                    info.heat = dict(heat)
                if tiers is not None:
                    info.tiers = dict(tiers)
                if stats is not None:
                    info.stats = dict(stats)

        self._tx(fn)

    def expire_heartbeat(self, instance_id: str) -> None:
        """Drop an instance from every liveness window immediately (clean
        quorum exit: peers re-quota without waiting out the TTL)."""

        def fn(s):
            if instance_id in s["instances"]:
                s["instances"][instance_id].last_heartbeat_ms = 0

        self._tx(fn)

    def instances(self, role: Optional[str] = None, live_ttl_ms: Optional[int] = None):
        def fn(s):
            out = list(s["instances"].values())
            if role is not None:
                out = [i for i in out if i.role == role]
            if live_ttl_ms is not None:
                now = int(time.time() * 1000)
                out = [i for i in out if now - i.last_heartbeat_ms <= live_ttl_ms]
            return out

        return self._tx_read(fn)

    # ---- autoscaler state -------------------------------------
    def set_autoscaler_state(self, state: dict) -> None:
        """Publish the controller autoscaler's current view (phase,
        pressure, watermarks, last actions) so operators can read it from
        ANY process — ``tools/clusterstat.py --load`` renders it. One
        shared doc: a single controller leads the autoscale duty."""
        self._tx(lambda s: (s.setdefault("autoscaler", {}).clear(),
                            s["autoscaler"].update(dict(state))))

    def autoscaler_state(self) -> dict:
        return self._tx_read(
            lambda s: dict(s.setdefault("autoscaler", {})))

    # ---- leases (controller HA: Helix leader-election role) --------------
    def try_acquire_lease(self, name: str, holder: str, ttl_ms: int) -> dict:
        """Atomically acquire or renew a named lease: granted when free,
        expired, or already held by ``holder``. Returns the current lease
        ``{"holder", "expires_ms"}`` either way — callers check
        ``lease["holder"] == holder``. This is the whole election
        protocol: the registry tx IS the arbiter (the role ZK ephemeral
        nodes play for Helix leader election,
        pinot-controller/.../LeadControllerManager.java:1)."""
        now = int(time.time() * 1000)

        def fn(s):
            leases = s.setdefault("leases", {})
            cur = leases.get(name)
            if cur is None or cur["holder"] == holder \
                    or now > cur["expires_ms"]:
                leases[name] = {"holder": holder, "expires_ms": now + ttl_ms}
            return dict(leases[name])

        return self._tx(fn)

    def lease_tick(self, holder: str, wanted: list, max_held: int,
                   ttl_ms: int, heartbeat: bool = True) -> set:
        """ONE transaction per HA tick (N separate renewal txs would churn
        the flock + section version once per lease): walk ``wanted`` in
        order, renewing/acquiring until ``max_held`` leases are held, and
        RELEASE any of ``wanted`` held beyond that — the fair-share yield
        that lets live controllers actually split the lead partitions.
        Callers list currently-held names first so renewal is stable.
        Returns the names now held."""
        now = int(time.time() * 1000)

        def fn(s):
            leases = s.setdefault("leases", {})
            held = set()
            for name in wanted:
                cur = leases.get(name)
                mine = cur is not None and cur["holder"] == holder
                if len(held) >= max_held:
                    if mine:
                        leases.pop(name)  # yield the excess
                    continue
                if cur is None or mine or now > cur["expires_ms"]:
                    leases[name] = {"holder": holder,
                                    "expires_ms": now + ttl_ms}
                    held.add(name)
            if heartbeat and holder in s["instances"]:
                s["instances"][holder].last_heartbeat_ms = now
            return held

        return self._tx(fn)

    def release_lease(self, name: str, holder: str) -> None:
        """Voluntary release (clean shutdown hands leadership over without
        waiting out the TTL)."""

        def fn(s):
            cur = s.setdefault("leases", {}).get(name)
            if cur is not None and cur["holder"] == holder:
                s["leases"].pop(name)

        self._tx(fn)

    def lease_holder(self, name: str) -> Optional[str]:
        now = int(time.time() * 1000)

        def fn(s):
            cur = s.setdefault("leases", {}).get(name)
            if cur is None or now > cur["expires_ms"]:
                return None
            return cur["holder"]

        return self._tx_read(fn)

    def drop_instance(self, instance_id: str) -> None:
        def fn(s):
            s["instances"].pop(instance_id, None)
            for table, ev in s["external_view"].items():
                for seg in list(ev):
                    if instance_id in ev[seg]:
                        ev[seg] = [i for i in ev[seg] if i != instance_id]

        self._tx(fn)
        self._note_routing_change()

    # ---- tables ----------------------------------------------------------
    def add_table(self, config: TableConfig, schema: Schema,
                  key: Optional[str] = None) -> None:
        key = key or config.table_name

        def fn(s):
            s["tables"][key] = config.to_json()
            s["schemas"][key] = schema.to_json()
            s["segments"].setdefault(key, {})
            s["assignment"].setdefault(key, {})

        self._tx(fn)
        self._note_routing_change()

    def drop_table(self, table: str) -> None:
        def fn(s):
            for key in ("tables", "schemas", "segments", "assignment",
                        "external_view", "partition_assignment",
                        "replica_groups"):
                s[key].pop(table, None)

        self._tx(fn)
        self._note_routing_change()

    def update_schema(self, table: str, schema: Schema) -> None:
        """Schema evolution: replace a registered table's schema (the
        reference's Schema REST update; validation happens at the
        controller)."""

        def fn(s):
            if table not in s["schemas"]:
                raise KeyError(f"table {table!r} not found")
            s["schemas"][table] = schema.to_json()

        self._tx(fn)

    def table_config(self, table: str) -> Optional[TableConfig]:
        d = self._tx_read(lambda s: s["tables"].get(table))
        return None if d is None else TableConfig.from_json(d)

    def set_table_config(self, table: str, config: TableConfig) -> None:
        """Hot config update (controller REST table-config PUT analog);
        servers pick it up level-triggered on their next sync."""

        def fn(s):
            if table not in s["tables"]:
                raise KeyError(f"table {table!r} not found")
            s["tables"][table] = config.to_json()

        self._tx(fn)
        # config rides the tables section: broker memos keyed on the
        # routing generation (quota rates, table-name sets) must refresh
        self._note_routing_change()

    def table_schema(self, table: str) -> Optional[Schema]:
        d = self._tx_read(lambda s: s["schemas"].get(table))
        return None if d is None else Schema.from_json(d)

    def tables(self) -> list:
        return self._tx_read(lambda s: list(s["tables"]))

    # ---- segments + assignment ------------------------------------------
    def add_segment(self, record: SegmentRecord, instance_ids: list,
                    merge_instances: bool = False) -> None:
        """Register a segment + its replica assignment.

        ``merge_instances=True`` unions ``instance_ids`` into the existing
        assignment instead of replacing it — the multi-replica realtime
        commit path needs this: EVERY replica of a stream partition
        publishes the same committed segment under its own instance id
        (winner via finish, losers via adopt), and replace semantics would
        make the last publisher the only replica, silently dropping
        replication to 1 (the reference instead has the controller write
        the full ideal-state replica set once at commit)."""
        # deep-store URI must resolve NOW (typed error), not at the first
        # cold-tier download
        _validate_location(record.location)
        record.push_time_ms = record.push_time_ms or int(time.time() * 1000)

        def fn(s):
            s["segments"].setdefault(record.table, {})[record.name] = record
            assign = s["assignment"].setdefault(record.table, {})
            if merge_instances:
                cur = assign.setdefault(record.name, [])
                for i in instance_ids:
                    if i not in cur:
                        cur.append(i)
            else:
                assign[record.name] = list(instance_ids)

        self._tx(fn)
        self._note_routing_change()

    def remove_segment(self, table: str, name: str) -> None:
        def fn(s):
            s["segments"].get(table, {}).pop(name, None)
            s["assignment"].get(table, {}).pop(name, None)

        self._tx(fn)
        self._note_routing_change()

    def segments(self, table: str) -> dict:
        return self._tx_read(lambda s: dict(s["segments"].get(table, {})))

    def assignment(self, table: str) -> dict:
        return self._tx_read(lambda s: {k: list(v) for k, v in s["assignment"].get(table, {}).items()})

    def set_assignment(self, table: str, mapping: dict) -> None:
        self._tx(lambda s: s["assignment"].__setitem__(
            table, {k: list(v) for k, v in mapping.items()}
        ))
        self._note_routing_change()

    # ---- replica groups (ReplicaGroupSegmentAssignment analog) -----------
    def set_replica_groups(self, table: str, groups: dict) -> None:
        """{group name: [instance ids]} — each group holds ONE complete
        replica of the table; the broker routes a whole query to one
        group's instances (InstanceSelector over replica-group instance
        partitions in the reference)."""
        self._tx(lambda s: s["replica_groups"].__setitem__(
            table, {str(k): list(v) for k, v in groups.items()}
        ))
        self._note_routing_change()

    def replica_groups(self, table: str) -> dict:
        return self._tx_read(
            lambda s: {k: list(v) for k, v in
                       s["replica_groups"].get(table, {}).items()}
        )

    def assigned_segments(self, instance_id: str) -> dict:
        """{table: [segment names]} hosted by this instance (server sync)."""

        def fn(s):
            out: dict = {}
            for table, mapping in s["assignment"].items():
                names = [seg for seg, inst in mapping.items() if instance_id in inst]
                if names:
                    out[table] = names
            return out

        return self._tx_read(fn)

    # ---- external view (server-reported serving state) -------------------
    def update_external_view(self, instance_id: str, serving: dict) -> None:
        """``serving``: {table: [segment names]} this instance can answer
        for right now (loaded immutable + live consuming segments)."""

        def fn(s):
            # change-tracked: the steady-state sync tick (same serving set
            # every 200ms) must not churn the routing generation and blow
            # the broker's routing/result caches
            changed = False
            ev_all = s["external_view"]
            for table, ev in ev_all.items():
                keep = set(serving.get(table, ()))
                for seg in list(ev):
                    if instance_id in ev[seg] and seg not in keep:
                        ev[seg] = [i for i in ev[seg] if i != instance_id]
                        changed = True
            for table, names in serving.items():
                ev = ev_all.setdefault(table, {})
                for name in names:
                    lst = ev.setdefault(name, [])
                    if instance_id not in lst:
                        lst.append(instance_id)
                        changed = True
            return changed

        if self._tx(fn):
            self._note_routing_change()

    def scrub_instances(self, instance_ids) -> None:
        """Remove hard-dead instances from every external-view entry in one
        transaction — a killed server can't deregister itself, and stale EV
        entries keep brokers routing at it (the reference gets this from
        Helix dropping the dead participant's ephemeral node). The
        ASSIGNMENT (ideal state) is deliberately untouched: stripping it
        would make a transiently-stalled server delete its local copies on
        return; assignment ghosts are cleaned by the controller's
        rebalance-on-dead repair, which restores replication on live
        servers in the same move."""
        ids = set(instance_ids)
        if not ids:
            return

        def fn(s):
            for table, ev in s["external_view"].items():
                for seg, insts in list(ev.items()):
                    if ids & set(insts):
                        ev[seg] = [i for i in insts if i not in ids]

        self._tx(fn)
        self._note_routing_change()

    def external_view(self, table: str) -> dict:
        return self._tx_read(
            lambda s: {k: list(v) for k, v in s["external_view"].get(table, {}).items() if v}
        )

    # ---- realtime partition assignment ----------------------------------
    def set_partition_assignment(self, table: str, mapping: dict) -> None:
        """{partition(str): [instance_ids]} — every listed replica consumes
        the partition (multi-replica LLC consumption)."""

        def norm(v):
            return [v] if isinstance(v, str) else list(v)

        self._tx(lambda s: s["partition_assignment"].__setitem__(
            table, {str(k): norm(v) for k, v in mapping.items()}
        ))

    def partition_assignment(self, table: str) -> dict:
        out = self._tx_read(
            lambda s: dict(s["partition_assignment"].get(table, {}))
        )
        return {k: ([v] if isinstance(v, str) else list(v)) for k, v in out.items()}

    # ---- segment completion FSM (SegmentCompletionManager analog) --------
    # state: {table: {partition: {sequence: entry}}} where entry =
    # {committer, state: COMMITTING|DONE, segment, location, offset, ts_ms}
    # The first replica to reach its flush threshold CAS-claims the commit;
    # losers HOLD until the entry goes DONE, then adopt the committed
    # segment. A stale COMMITTING entry (committer died mid-build) can be
    # taken over.

    def try_claim_commit(self, table: str, partition: int, sequence: int,
                         instance_id: str, segment_name: str) -> dict:
        """CAS: claim the commit for (partition, sequence). Returns the
        current entry — caller won iff entry['committer'] == instance_id
        and entry['state'] == 'COMMITTING'."""

        def fn(s):
            part = s.setdefault("segment_completion", {}) \
                .setdefault(table, {}).setdefault(str(partition), {})
            entry = part.get(str(sequence))
            if entry is None:
                entry = {
                    "committer": instance_id, "state": "COMMITTING",
                    "segment": segment_name, "location": None, "offset": None,
                    "ts_ms": int(time.time() * 1000),
                }
                part[str(sequence)] = entry
            return dict(entry)

        return self._tx(fn)

    def finish_commit(self, table: str, partition: int, sequence: int,
                      instance_id: str, segment_name: str, location: str,
                      end_offset: str) -> bool:
        """Committer publishes the built segment; False if it lost the claim
        (a takeover happened while it was building). ``segment_name`` is
        re-recorded: after a takeover the new committer's segment replaces
        the dead claimer's."""

        def fn(s):
            part = s.get("segment_completion", {}).get(table, {}) \
                .get(str(partition), {})
            entry = part.get(str(sequence))
            if entry is None or entry["committer"] != instance_id:
                return False
            entry.update(state="DONE", segment=segment_name, location=location,
                         offset=end_offset, ts_ms=int(time.time() * 1000))
            return True

        return self._tx(fn)

    def commit_entry(self, table: str, partition: int, sequence: int):
        def fn(s):
            e = s.get("segment_completion", {}).get(table, {}) \
                .get(str(partition), {}).get(str(sequence))
            return None if e is None else dict(e)

        return self._tx_read(fn)

    def takeover_commit(self, table: str, partition: int, sequence: int,
                        instance_id: str, stale_ms: int) -> dict:
        """If the entry is COMMITTING and untouched for ``stale_ms``, replace
        the (presumed dead) committer. Returns the current entry."""

        def fn(s):
            part = s.setdefault("segment_completion", {}) \
                .setdefault(table, {}).setdefault(str(partition), {})
            entry = part.get(str(sequence))
            now = int(time.time() * 1000)
            if entry is None:
                entry = {
                    "committer": instance_id, "state": "COMMITTING",
                    "segment": None, "location": None, "offset": None,
                    "ts_ms": now,
                }
                part[str(sequence)] = entry
            elif entry["state"] == "COMMITTING" and now - entry["ts_ms"] >= stale_ms:
                entry.update(committer=instance_id, ts_ms=now)
            return dict(entry)

        return self._tx(fn)


    # ---- minion task queue (PinotHelixTaskResourceManager analog) --------
    # tasks: {task_id: {id, type, table, config, state, worker, ts_ms, output}}
    # States: PENDING -> RUNNING -> DONE | FAILED. Minions claim via CAS
    # (the registry tx is the arbiter, replacing Helix's task framework).

    class TaskState:
        PENDING = "PENDING"
        RUNNING = "RUNNING"
        DONE = "DONE"
        FAILED = "FAILED"

    def submit_task(self, task_type: str, table: str, config: dict) -> str:
        def fn(s):
            tasks = s.setdefault("tasks", {})
            task_id = f"task_{task_type}_{len(tasks)}_{int(time.time() * 1000)}"
            tasks[task_id] = {
                "id": task_id, "type": task_type, "table": table,
                "config": dict(config), "state": self.TaskState.PENDING,
                "worker": None, "ts_ms": int(time.time() * 1000), "output": None,
            }
            return task_id

        return self._tx(fn)

    def claim_task(self, instance_id: str,
                   task_types: Optional[list] = None) -> Optional[dict]:
        """CAS-claim the oldest PENDING task (optionally restricted by type)."""

        def fn(s):
            pending = sorted(
                (t for t in s.get("tasks", {}).values()
                 if t["state"] == self.TaskState.PENDING
                 and (task_types is None or t["type"] in task_types)),
                key=lambda t: t["ts_ms"],
            )
            if not pending:
                return None
            t = pending[0]
            t["state"] = self.TaskState.RUNNING
            t["worker"] = instance_id
            t["ts_ms"] = int(time.time() * 1000)
            return dict(t)

        return self._tx(fn)

    def finish_task(self, task_id: str, ok: bool, output: Optional[str] = None) -> None:
        def fn(s):
            t = s.get("tasks", {}).get(task_id)
            if t is not None:
                t["state"] = self.TaskState.DONE if ok else self.TaskState.FAILED
                t["output"] = output
                t["ts_ms"] = int(time.time() * 1000)

        self._tx(fn)

    def touch_task(self, task_id: str) -> None:
        """Executor heartbeat: a healthy long-running task refreshes ts_ms
        so requeue_stale_tasks never requeues live work."""

        def fn(s):
            t = s.get("tasks", {}).get(task_id)
            if t is not None and t["state"] == self.TaskState.RUNNING:
                t["ts_ms"] = int(time.time() * 1000)

        self._tx(fn)

    def prune_terminal_tasks(self, ttl_ms: int = 3_600_000) -> int:
        """GC DONE/FAILED tasks older than ``ttl_ms`` — the tasks map rides
        every FileRegistry transaction, so history must stay bounded."""

        def fn(s):
            tasks = s.get("tasks", {})
            cutoff = int(time.time() * 1000) - ttl_ms
            dead = [tid for tid, t in tasks.items()
                    if t["state"] in (self.TaskState.DONE, self.TaskState.FAILED)
                    and t["ts_ms"] < cutoff]
            for tid in dead:
                del tasks[tid]
            return len(dead)

        return self._tx(fn)

    def requeue_stale_tasks(self, stale_ms: int, max_attempts: int = 3) -> list:
        """Repair path for dead minions (stale-COMMITTING analog of the
        completion FSM): RUNNING tasks untouched for ``stale_ms`` go back to
        PENDING (or FAILED once ``max_attempts`` claims burned)."""

        def fn(s):
            now = int(time.time() * 1000)
            changed = []
            for t in s.get("tasks", {}).values():
                if t["state"] == self.TaskState.RUNNING \
                        and now - t["ts_ms"] >= stale_ms:
                    attempts = t.get("attempts", 1)
                    if attempts >= max_attempts:
                        t["state"] = self.TaskState.FAILED
                        t["output"] = f"abandoned after {attempts} stale claims"
                    else:
                        t["state"] = self.TaskState.PENDING
                        t["worker"] = None
                        t["attempts"] = attempts + 1
                    t["ts_ms"] = now
                    changed.append(dict(t))
            return changed

        return self._tx(fn)

    def tasks(self, table: Optional[str] = None,
              state: Optional[str] = None) -> list:
        def fn(s):
            out = [dict(t) for t in s.get("tasks", {}).values()]
            if table is not None:
                out = [t for t in out if t["table"] == table]
            if state is not None:
                out = [t for t in out if t["state"] == state]
            return sorted(out, key=lambda t: t["ts_ms"])

        return self._tx_read(fn)

    # ---- per-table task metadata (watermarks etc.; ZK minion metadata) ---
    def task_metadata_get(self, table: str, task_type: str) -> dict:
        return self._tx_read(
            lambda s: dict(s.get("task_metadata", {}).get(table, {}).get(task_type, {}))
        )

    def task_metadata_set(self, table: str, task_type: str, meta: dict) -> None:
        self._tx(lambda s: s.setdefault("task_metadata", {})
                 .setdefault(table, {}).__setitem__(task_type, dict(meta)))

    # ---- segment lineage (SegmentLineage analog: atomic replace) ---------
    # {table: {lineage_id: {from: [...], to: [...], state, ts_ms}}}
    # IN_PROGRESS: brokers route the FROM set (TO still loading);
    # COMPLETED:   brokers route the TO set (FROM await deletion).
    # The single-tx flip is what makes a merge swap atomic to queries.

    def start_lineage(self, table: str, from_segments: list, to_segments: list) -> str:
        def fn(s):
            lin = s.setdefault("segment_lineage", {}).setdefault(table, {})
            lid = f"lineage_{len(lin)}_{int(time.time() * 1000)}"
            lin[lid] = {
                "from": list(from_segments), "to": list(to_segments),
                "state": "IN_PROGRESS", "ts_ms": int(time.time() * 1000),
            }
            return lid

        lid = self._tx(fn)
        self._note_routing_change()
        return lid

    def complete_lineage(self, table: str, lineage_id: str) -> bool:
        """CAS flip IN_PROGRESS → COMPLETED. Returns False if the entry was
        concurrently aborted/repaired — the caller MUST then abandon the
        swap (deleting the FROM set after a lost flip loses both copies)."""

        def fn(s):
            e = s.get("segment_lineage", {}).get(table, {}).get(lineage_id)
            if e is None or e["state"] != "IN_PROGRESS":
                return False
            e["state"] = "COMPLETED"
            e["ts_ms"] = int(time.time() * 1000)
            return True

        out = self._tx(fn)
        if out:
            self._note_routing_change()
        return out

    def try_abort_lineage(self, table: str, lineage_id: str) -> bool:
        """CAS IN_PROGRESS → ABORTING (controller repair claims the unwind).
        ABORTING keeps the TO set routing-excluded while its segments are
        deleted; False means the executor already flipped to COMPLETED."""

        def fn(s):
            e = s.get("segment_lineage", {}).get(table, {}).get(lineage_id)
            if e is None or e["state"] == "COMPLETED":
                return False
            e["state"] = "ABORTING"
            e["ts_ms"] = int(time.time() * 1000)
            return True

        out = self._tx(fn)
        if out:
            self._note_routing_change()
        return out

    def revert_lineage(self, table: str, lineage_id: str) -> bool:
        """Drop a non-COMPLETED entry (failed/aborted replace). A COMPLETED
        entry is never dropped here — prune_lineage GCs it once the FROM
        set is fully gone."""

        def fn(s):
            lin = s.get("segment_lineage", {}).get(table, {})
            e = lin.get(lineage_id)
            if e is None or e["state"] == "COMPLETED":
                return False
            del lin[lineage_id]
            return True

        out = self._tx(fn)
        if out:
            self._note_routing_change()
        return out

    def lineage(self, table: str) -> dict:
        return self._tx_read(
            lambda s: {k: dict(v) for k, v in
                       s.get("segment_lineage", {}).get(table, {}).items()}
        )

    def stale_in_progress_lineage(self, table: str, stale_ms: int) -> dict:
        """Non-COMPLETED entries untouched for ``stale_ms`` (the executor —
        or a previous repair — died mid-swap); the controller unwinds them."""
        now = int(time.time() * 1000)
        return {
            lid: e for lid, e in self.lineage(table).items()
            if e["state"] != "COMPLETED" and now - e["ts_ms"] >= stale_ms
        }

    def routing_snapshot(self, table: str) -> tuple:
        """(external_view, segment records, lineage) in ONE read tx — the
        broker's per-query read; a single FileRegistry parse instead of
        three, and no cross-read consistency window."""

        def fn(s):
            view = {k: list(v) for k, v in
                    s["external_view"].get(table, {}).items() if v}
            records = dict(s["segments"].get(table, {}))
            lineage = {k: dict(v) for k, v in
                       s.get("segment_lineage", {}).get(table, {}).items()}
            return view, records, lineage

        return self._tx_read(fn)

    def prune_lineage(self, table: str) -> int:
        """GC COMPLETED entries whose FROM segments are fully deleted."""

        def fn(s):
            lin = s.get("segment_lineage", {}).get(table, {})
            segs = s.get("segments", {}).get(table, {})
            ev = s.get("external_view", {}).get(table, {})
            gone = 0
            for lid in list(lin):
                e = lin[lid]
                if e["state"] == "COMPLETED" and not any(
                    f in segs or ev.get(f) for f in e["from"]
                ):
                    del lin[lid]
                    gone += 1
            return gone

        return self._tx(fn)


_SECTIONS = (
    "instances", "tables", "schemas", "segments", "assignment",
    "external_view", "partition_assignment", "segment_completion",
    "tasks", "task_metadata", "segment_lineage", "replica_groups",
    "leases", "autoscaler",
)

# sections whose change means "what a query routes to (or would read)
# moved" — the FileRegistry's routing generation sums exactly these
# version counters, so heartbeats/leases/tasks never blow broker caches
_ROUTING_SECTIONS = (
    "tables", "segments", "assignment", "external_view",
    "segment_lineage", "replica_groups",
)


def _section_to_json(name: str, data: dict):
    # vars() over dataclasses.asdict: fields are flat scalars/lists and
    # asdict's recursive deep-copy dominates section-write cost at
    # thousands of segments
    if name == "instances":
        return {k: dict(vars(v)) for k, v in data.items()}
    if name == "segments":
        return {t: {n: dict(vars(r)) for n, r in segs.items()}
                for t, segs in data.items()}
    return data


def _section_from_json(name: str, d):
    d = d or {}
    if name == "instances":
        return {k: InstanceInfo(**v) for k, v in d.items()}
    if name == "segments":
        return {t: {n: SegmentRecord(**r) for n, r in segs.items()}
                for t, segs in d.items()}
    return d


class _LazyState:
    """Dict-like view over the registry's section files: sections load on
    first access within a transaction, and only ACCESSED sections are
    written back — a heartbeat touches instances.json alone instead of
    rewriting (and re-parsing) the whole cluster state."""

    def __init__(self, reg: "FileRegistry"):
        self._reg = reg
        self.accessed: set = set()

    def _section(self, key: str) -> dict:
        if key not in _SECTIONS:
            raise KeyError(key)
        self.accessed.add(key)
        return self._reg._load_section(key)

    def __getitem__(self, key: str) -> dict:
        return self._section(key)

    def get(self, key: str, default=None):
        return self._section(key)

    def setdefault(self, key: str, default=None):
        return self._section(key)

    def __contains__(self, key: str) -> bool:
        return key in _SECTIONS


class FileRegistry(ClusterRegistry):
    """File-backed registry with advisory locking: the durable cluster
    state for multi-process single-host clusters (the role ZK plays).

    Layout: ``<path>.d/<section>.json`` — one file per state section plus a
    monotonically-bumped ``version`` stamp. Transactions hold one flock,
    load only the sections they touch, and rewrite only those (atomic
    tmp+rename). A version-validated in-process cache makes the poll paths
    (server sync, broker routing) parse nothing but the tiny version file
    while the cluster is quiescent — the FileRegistry equivalent of ZK
    watches."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self.dir = path + ".d"
        os.makedirs(self.dir, exist_ok=True)
        self._version_path = os.path.join(self.dir, "version")
        self._lock_path = os.path.join(self.dir, ".lock")
        self._cache: dict = {}      # section -> parsed state
        self._raw: dict = {}        # section -> serialized text (dirty check)
        self._sig: dict = {}        # section -> file stat signature
        self._lock_fh = None        # persistent flock fd (see _locked)
        self._migrate_legacy()

    def _migrate_legacy(self) -> None:
        """One-time split of a pre-section single-JSON state file."""
        with self._locked(write=True):
            if os.path.exists(self._version_path):
                return
            legacy = {}
            if os.path.isfile(self.path):
                try:
                    with open(self.path) as f:
                        legacy = _from_json(json.load(f))
                except (json.JSONDecodeError, OSError):
                    legacy = {}
            for name in _SECTIONS:
                self._write_section(name, legacy.get(name, {}))
            self._bump_version()

    # ---- file plumbing ---------------------------------------------------
    @contextlib.contextmanager
    def _locked(self, write: bool):
        with self._lock:
            # the lock fd is opened ONCE and kept: under sandboxed kernels
            # (gVisor-class gofer fs) every open() is an ~ms RPC, and the
            # old open-per-tx pattern made the file lock itself the most
            # expensive part of an otherwise cached read tx. self._lock
            # already serializes threads, so one fd per process is safe.
            lf = self._lock_fh
            if lf is None or lf.closed:
                lf = self._lock_fh = open(self._lock_path, "a+")
            fcntl.flock(lf, fcntl.LOCK_EX if write else fcntl.LOCK_SH)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _read_versions(self) -> dict:
        """Per-section change counters — one tiny file read per tx; a
        heartbeat bump invalidates peers' cached instances section only,
        not their (large) segments/assignment caches."""
        try:
            with open(self._version_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return {}

    def _bump_version(self, sections=None) -> dict:
        v = self._read_versions()
        for name in (sections if sections is not None else _SECTIONS):
            v[name] = v.get(name, 0) + 1
        tmp = f"{self._version_path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(v, f)
        os.replace(tmp, self._version_path)
        return v

    def _section_path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.json")

    def _file_sig(self, name: str):
        try:
            st = os.stat(self._section_path(name))
            return (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _load_section(self, name: str) -> dict:
        if name in self._cache:
            return self._cache[name]
        try:
            with open(self._section_path(name)) as f:
                text = f.read()
            data = _section_from_json(name, json.loads(text))
        except (OSError, json.JSONDecodeError):
            text, data = "", _section_from_json(name, {})
        self._cache[name] = data
        self._raw[name] = text
        self._sig[name] = self._file_sig(name)
        return data

    def _stage_section(self, name: str, data: dict):
        """Serialize ONE section to a tmp file; returns (tmp_path, text), or
        None (skipping the disk write) when the content is byte-identical to
        what's on disk — read-shaped write txs (empty claim_task polls, no-op
        heartbeats) must not churn files or invalidate peer caches.

        Staging is separate from publishing (the os.replace in _tx) so a
        multi-section tx hits its slow/fallible part — serialization + data
        writes — before ANY section becomes visible to peers; the publish
        pass is metadata-only renames."""
        # dumps-then-write hits the C encoder; json.dump's streaming
        # iterencode is ~10x slower on large sections
        text = json.dumps(_section_to_json(name, data))
        if text == self._raw.get(name):
            return None
        tmp = f"{self._section_path(name)}.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(text)
        except Exception:
            # a partial tmp (ENOSPC mid-write) must not linger — debris
            # accumulates exactly when the disk is already full
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return tmp, text

    def _publish_staged(self, name: str, tmp: str, text: str) -> None:
        """Atomically swap a staged tmp into place + refresh cache
        bookkeeping (single publication contract for both the one-section
        and multi-section write paths)."""
        os.replace(tmp, self._section_path(name))
        self._raw[name] = text
        self._sig[name] = self._file_sig(name)

    def _write_section(self, name: str, data: dict) -> bool:
        """Stage + publish ONE section (single-section callers like legacy
        migration, where cross-section atomicity doesn't apply)."""
        s = self._stage_section(name, data)
        if s is None:
            return False
        self._publish_staged(name, *s)
        return True

    def _drop_cache(self) -> None:
        self._cache.clear()
        self._raw.clear()
        self._sig.clear()

    # ---- transactions ----------------------------------------------------
    def _tx(self, fn, write: bool = True):
        with self._locked(write):
            # stat-signature validation: survives a peer crashing between
            # its section writes and version bump (the file itself is the
            # truth, not the counter)
            for name in list(self._cache):
                if self._file_sig(name) != self._sig.get(name):
                    del self._cache[name]
                    self._raw.pop(name, None)
                    self._sig.pop(name, None)
            state = _LazyState(self)
            try:
                out = fn(state)
                if write and state.accessed:
                    # two-phase write-back: stage every dirty section fully,
                    # THEN publish with a tight rename-only loop, so a crash
                    # or serialization error mid-tx leaves peers seeing either
                    # none or all of a cross-section transaction (the advisor
                    # case: segments updated but external_view not)
                    staged = []
                    try:
                        for name in state.accessed:
                            s = self._stage_section(name, self._cache[name])
                            if s is not None:
                                staged.append((name, *s))
                        for name, tmp, text in staged:
                            self._publish_staged(name, tmp, text)
                    except Exception:
                        # staging failure → nothing published; publish
                        # failure → torn state is unavoidable (renames are
                        # metadata-only, so this is a pathological fs), but
                        # at least don't leak the unpublished tmps
                        for _, tmp, _ in staged:
                            try:
                                os.unlink(tmp)
                            except OSError:
                                pass
                        raise
                    if staged:
                        self._bump_version([name for name, _, _ in staged])
            except Exception:
                # fn (or a failed write-back) may have left cached sections
                # diverged from disk: never serve them again
                self._drop_cache()
                raise
            return out

    def state_version(self) -> int:
        """Cheap change token: pollers can skip work while it holds still
        (the ZK-watch analog for file-backed clusters). Lock-free like
        routing_generation: the version file is replaced atomically, so a
        torn read is impossible and the flock would only add syscalls to
        the hot polling path."""
        return sum(self._read_versions().values())

    def sections_version(self, sections) -> int:
        """Change token over a CHOSEN section subset — the server sync
        loop polls (tables, schemas, segments, assignment,
        partition_assignment, ...) without being re-triggered by every
        controller lease renewal, peer heartbeat, or external-view
        publish (lock-free, see state_version)."""
        v = self._read_versions()
        return sum(v.get(name, 0) for name in sections)

    def routing_generation(self) -> int:
        """Cross-process routing-change token: the sum of the ROUTING
        section version counters (the version file is written atomically,
        so this reads lock-free). Heartbeats touch only instances.json and
        don't move it — byte-identical section writes are skipped at
        staging, so a steady-state sync tick bumps nothing."""
        v = self._read_versions()
        return sum(v.get(name, 0) for name in _ROUTING_SECTIONS)
