"""Controller role: table/segment lifecycle + assignment + maintenance.

Equivalent of the reference's controller (pinot-controller/:
PinotHelixResourceManager table/segment/instance CRUD, segment assignment
strategies under assignment/segment/, TableRebalancer minimal-movement
rebalance, RetentionManager, PinotLLCRealtimeSegmentManager creating
consuming partitions). Helix writes become registry transactions; servers
reconcile by polling (server/server.py sync loop).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from typing import Optional

import numpy as np

from pinot_tpu_torch.cluster.registry import (
    ClusterRegistry,
    InstanceInfo,
    Role,
    SegmentRecord,
    SegmentState,
)
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig, TableType
from pinot_tpu_torch.storage.segment import ImmutableSegment

log = logging.getLogger("pinot_tpu_torch.controller")

def aggregate_heat(registry: ClusterRegistry, table: str) -> dict:
    """Cluster-wide segment-temperature view for one table:
    merges every server heartbeat's piggybacked heat snapshot
    (server/heat.py) across instances and the table's physical variants
    — decayed rates sum (a 2-replica hot segment is twice as hot to the
    cluster), lifetime counters sum, last access takes the max.  The
    payload behind ``GET /tables/{t}/heat``; the ranking a tier
    lifecycle's promotion/demotion policy (server/tiering.py) consumes."""
    candidates = {table, f"{table}_OFFLINE", f"{table}_REALTIME"}
    segs: dict = {}
    reporting = 0
    for info in registry.instances(Role.SERVER):
        h = getattr(info, "heat", None) or {}
        seen = False
        for t in candidates:
            per = h.get(t)
            if not per:
                continue
            seen = True
            for seg, rec in per.items():
                agg = segs.setdefault(seg, {
                    "rate": 0.0, "bytesRate": 0.0, "accesses": 0,
                    "bytes": 0, "lastAccessTs": 0.0, "instances": 0})
                agg["rate"] = round(
                    agg["rate"] + float(rec.get("rate") or 0.0), 4)
                agg["bytesRate"] = round(
                    agg["bytesRate"] + float(rec.get("bytesRate") or 0.0), 1)
                agg["accesses"] += int(rec.get("accesses") or 0)
                agg["bytes"] += int(rec.get("bytes") or 0)
                agg["lastAccessTs"] = max(
                    agg["lastAccessTs"], float(rec.get("lastAccessTs") or 0))
                agg["instances"] += 1
        if seen:
            reporting += 1
    return {
        "table": table,
        "instancesReporting": reporting,
        "segments": dict(sorted(segs.items(),
                                key=lambda kv: -kv[1]["rate"])),
    }


_TIER_RANK = {"hot": 0, "warm": 1, "cold": 2}


def aggregate_tiers(registry: ClusterRegistry, table: str) -> dict:
    """Cluster-wide per-segment tier view for one table:
    merges every server heartbeat's piggybacked tier map
    (server/tiering.py TierManager.snapshot()) across instances and the
    table's physical variants. A segment's cluster tier is the HOTTEST
    any replica reports — one hot replica means the cluster still pays
    (and benefits from) hot-tier serving, and the tier-aware assignment
    must not strip it. The payload behind ``GET /tables/{t}/tiers`` and
    ``tools/clusterstat.py --tiers``."""
    candidates = {table, f"{table}_OFFLINE", f"{table}_REALTIME"}
    segs: dict = {}
    reporting = 0
    for info in registry.instances(Role.SERVER):
        tiers = getattr(info, "tiers", None) or {}
        seen = False
        for t in candidates:
            per = tiers.get(t)
            if not per:
                continue
            seen = True
            for seg, tier in per.items():
                ent = segs.setdefault(seg, {"tier": tier, "instances": {}})
                ent["instances"][info.instance_id] = tier
                if _TIER_RANK.get(tier, 1) < _TIER_RANK.get(ent["tier"], 1):
                    ent["tier"] = tier
        if seen:
            reporting += 1
    return {
        "table": table,
        "instancesReporting": reporting,
        "segments": segs,
    }


def _column_stats_fields(meta) -> dict:
    """Per-column min/max from segment metadata, JSON-plain, for the
    SegmentRecord the broker prunes on (SegmentZKMetadata's column
    min/max role). Non-scalar values (bytes) are skipped — the broker
    treats missing stats as "may match"."""
    stats = {}
    for cm in meta.columns.values():
        mn, mx = cm.min_value, cm.max_value
        if isinstance(mn, np.generic):
            mn = mn.item()
        if isinstance(mx, np.generic):
            mx = mx.item()
        if mn is None or mx is None or \
                isinstance(mn, bytes) or isinstance(mx, bytes):
            continue
        stats[cm.name] = {"min": mn, "max": mx}
    return {"column_stats": stats} if stats else {}


def _partition_record_fields(meta) -> dict:
    """Partition metadata of the first partitioned column, for broker-side
    pruning (SegmentPartitionConfig → SegmentZKMetadata partition metadata
    in the reference)."""
    for cm in meta.columns.values():
        if cm.partition_function and cm.partitions:
            return {
                "partition_column": cm.name,
                "partition_ids": list(cm.partitions),
                "partition_function": cm.partition_function,
                "num_partitions": cm.num_partitions,
            }
    return {}


class SegmentAssigner:
    """Balanced assignment: each segment gets `replication` replicas on the
    least-loaded live servers (assignment/segment/OfflineSegmentAssignment +
    SegmentAssignmentUtils balanced strategy). Liveness = heartbeat within
    ``live_ttl_ms`` (servers heartbeat from their sync loop), so hard-dead
    instances never receive new segments."""

    def __init__(self, registry: ClusterRegistry, live_ttl_ms: int = 30_000):
        self.registry = registry
        self.live_ttl_ms = live_ttl_ms

    def _live_servers(self):
        return self.registry.instances(Role.SERVER, live_ttl_ms=self.live_ttl_ms)

    def _load(self) -> dict:
        counts: dict[str, int] = {
            i.instance_id: 0 for i in self._live_servers()
        }
        for table in self.registry.tables():
            for seg, instances in self.registry.assignment(table).items():
                for inst in instances:
                    if inst in counts:
                        counts[inst] += 1
        return counts

    def assign(self, replication: int) -> list:
        counts = self._load()
        if not counts:
            raise RuntimeError("no live servers to assign to")
        ordered = sorted(counts, key=lambda i: counts[i])
        want = max(1, min(replication, len(ordered)))
        # failure-domain spread (AzureEnvironmentProvider role,
        # common/environment.py): replicas prefer DISTINCT fd: domains so
        # one fault boundary can't take out every copy; falls back to
        # pure least-loaded when domains are absent or too few
        from pinot_tpu_torch.common.environment import domain_of

        infos = {i.instance_id: i for i in self._live_servers()}
        picked, seen_fd = [], set()
        for inst in ordered:
            fd = domain_of(infos.get(inst))
            if fd is not None and fd in seen_fd:
                continue
            picked.append(inst)
            if fd is not None:
                seen_fd.add(fd)
            if len(picked) >= want:
                return picked
        for inst in ordered:  # not enough distinct domains: top up by load
            if inst not in picked:
                picked.append(inst)
                if len(picked) >= want:
                    break
        return picked

    def rebalance(self, table: str, replication: int,
                  servers: Optional[list] = None) -> dict:
        """Minimal-movement rebalance (rebalance/TableRebalancer.java): keep
        existing replicas where possible, move only to fix replication or
        heavy skew. ``servers`` overrides the liveness-derived target set
        (the dead-instance repair passes the conservative hard-live set so
        a merely-slow server isn't stripped of its replicas)."""
        if servers is None:
            servers = [i.instance_id for i in self._live_servers()]
        if not servers:
            return {}
        current = self.registry.assignment(table)
        target_total = sum(max(1, min(replication, len(servers))) for _ in current)
        per_server = -(-target_total // len(servers))  # ceil: balanced load cap
        counts = {s: 0 for s in servers}
        new: dict[str, list] = {}
        # first pass: keep existing placements that still fit
        for seg, instances in current.items():
            kept = []
            for inst in instances:
                if inst in counts and counts[inst] < per_server and len(kept) < replication:
                    kept.append(inst)
                    counts[inst] += 1
            new[seg] = kept
        # second pass: top up replication from least-loaded servers
        for seg, kept in new.items():
            want = max(1, min(replication, len(servers)))
            for inst in sorted(counts, key=lambda s: counts[s]):
                if len(kept) >= want:
                    break
                if inst not in kept:
                    kept.append(inst)
                    counts[inst] += 1
        self.registry.set_assignment(table, new)
        return new

    # ---- replica groups ---------------------------------------
    # assignment/segment/ReplicaGroupSegmentAssignmentStrategy +
    # InstanceReplicaGroupPartitionSelector analog: live servers are
    # partitioned into R named groups, each holding ONE complete replica
    # of the table; every segment places exactly one copy in each group.
    # The broker then routes a whole query to a single group's instances
    # (instead of ad-hoc per-segment replica picks), which is what makes
    # per-group load attribution — and near-linear multi-server QPS —
    # possible.

    def build_replica_groups(self, table: str, replication: int) -> dict:
        """Minimal-change group membership for the live server set: keep
        every surviving member in its current group, fill new servers into
        the smallest groups, and only then level residual skew. Returns
        {group name: [instance ids]} (empty when no live servers)."""
        live = sorted(i.instance_id for i in self._live_servers())
        if not live:
            return {}
        r = max(1, min(replication, len(live)))
        names = [f"rg_{i}" for i in range(r)]
        old = self.registry.replica_groups(table)
        groups: dict = {}
        assigned: set = set()
        for name in names:
            members = [m for m in old.get(name, ())
                       if m in live and m not in assigned]
            groups[name] = members
            assigned.update(members)
        for inst in live:
            if inst not in assigned:
                smallest = min(names, key=lambda n: (len(groups[n]), n))
                groups[smallest].append(inst)
        # level heavy skew (dissolved groups / uneven survivors): move one
        # member at a time from the largest to the smallest group
        while True:
            small = min(names, key=lambda n: (len(groups[n]), n))
            big = max(names, key=lambda n: (len(groups[n]), n))
            if len(groups[big]) - len(groups[small]) <= 1:
                break
            groups[small].append(groups[big].pop())
        return groups

    def _plan_replica_group_assignment(self, table: str,
                                       replication: int) -> tuple:
        """Pure planning half of the replica-group rebalance: the
        (groups, assignment) a rebalance WOULD write, computed without
        touching the registry — tier-aware callers (rebalance_tiered)
        post-process the plan and publish only real changes, so a
        steady-state periodic pass never churns the routing generation."""
        groups = self.build_replica_groups(table, replication)
        if not groups:
            return {}, {}
        records = self.registry.segments(table)
        current = self.registry.assignment(table)
        seg_names = sorted(set(records) | set(current))
        new: dict = {}
        for name in sorted(groups):
            members = groups[name]
            if not members:
                continue
            cap = -(-max(1, len(seg_names)) // len(members))
            counts = {m: 0 for m in members}
            placed: dict = {}
            mset = set(members)
            # pass 1: partition-determined + sticky placements
            for seg in seg_names:
                rec = records.get(seg)
                cur = [i for i in current.get(seg, ()) if i in mset]
                if rec is not None and rec.partition_ids:
                    pick = members[int(rec.partition_ids[0]) % len(members)]
                elif cur and counts[cur[0]] < cap:
                    pick = cur[0]
                else:
                    continue  # homeless: place in pass 2, least-loaded
                placed[seg] = pick
                counts[pick] += 1
            # pass 2: everything else goes least-loaded
            for seg in seg_names:
                if seg in placed:
                    continue
                pick = min(members, key=lambda m: (counts[m], m))
                placed[seg] = pick
                counts[pick] += 1
            for seg, pick in placed.items():
                new.setdefault(seg, []).append(pick)
        return groups, new

    def rebalance_replica_groups(self, table: str, replication: int) -> dict:
        """(Re)build groups + per-group segment placement; writes both the
        group map and the assignment. Movement is minimal: membership
        keeps survivors in place, and unpartitioned segments move only to
        fix replication or to fill a joined server up to its fair share
        (ceil(n_segments / group size)). Partitioned segments place
        DETERMINISTICALLY by partition id — co-partitioned segments land
        on the same member, so a partition-EQ query (which the broker
        prunes with the same common/pruning.py algebra the server uses)
        touches exactly one instance per group."""
        groups, new = self._plan_replica_group_assignment(table, replication)
        if not groups:
            return {}
        self.registry.set_replica_groups(table, groups)
        self.registry.set_assignment(table, new)
        return new

    def rebalance_tiered(self, table: str, replication: int,
                         tiers: dict) -> dict:
        """Tier-aware replica-group assignment: hot/warm
        segments keep the full R-way replica-group placement (device- and
        host-backed serving capacity chases the hot set); COLD segments
        trim to a SINGLE copy — the object store is their durability, so
        extra replicas only burn disk and sync traffic. ``tiers`` maps
        segment → tier (or → the aggregate_tiers per-segment dict).

        Movement is minimal twice over: the underlying plan is the replica-group
        sticky rebalance (unflipped segments keep their placement), a
        cold segment keeps its first surviving current replica (the copy
        already on disk somewhere), and NOTHING is published unless the
        plan actually differs from the registry — a steady-state periodic
        pass bumps no routing generation and blows no broker caches. A
        temperature flip therefore moves exactly the flipped segments."""
        groups, new = self._plan_replica_group_assignment(table, replication)
        if not groups:
            return {}
        current = self.registry.assignment(table)
        for seg, tinfo in tiers.items():
            tier = tinfo.get("tier") if isinstance(tinfo, dict) else tinfo
            if tier != "cold" or seg not in new:
                continue
            keep = [i for i in current.get(seg, ()) if i in new[seg]][:1] \
                or new[seg][:1]
            new[seg] = keep
        if groups != self.registry.replica_groups(table):
            self.registry.set_replica_groups(table, groups)
        if {k: sorted(v) for k, v in new.items()} != \
                {k: sorted(v) for k, v in current.items()}:
            self.registry.set_assignment(table, new)
        return new

    def assign_with_groups(self, table: str, rec) -> Optional[list]:
        """Upload-path placement when a replica-group map exists: one
        member per group (partition-aware, else least-loaded by current
        assignment). None when the table has no usable group map — the
        caller falls back to the balanced legacy strategy."""
        groups = self.registry.replica_groups(table)
        live = {i.instance_id for i in self._live_servers()}
        groups = {n: [m for m in ms if m in live] for n, ms in groups.items()}
        groups = {n: ms for n, ms in groups.items() if ms}
        if not groups:
            return None
        current = self.registry.assignment(table)
        counts: dict = {}
        for insts in current.values():
            for i in insts:
                counts[i] = counts.get(i, 0) + 1
        out = []
        for name in sorted(groups):
            members = groups[name]
            if rec is not None and rec.partition_ids:
                pick = members[int(rec.partition_ids[0]) % len(members)]
            else:
                pick = min(members, key=lambda m: (counts.get(m, 0), m))
            counts[pick] = counts.get(pick, 0) + 1
            if pick not in out:
                out.append(pick)
        return out


class Controller:
    def __init__(self, registry: ClusterRegistry, deep_store_dir: str,
                 controller_id: str = "controller_0"):
        from pinot_tpu_torch.storage.fs import create_fs

        self.registry = registry
        self.deep_store = deep_store_dir
        # deep-store IO routes through the PinotFS SPI: swapping the scheme
        # (s3://, gs://) swaps the storage backend via the plugin registry
        self.fs = create_fs(deep_store_dir)
        self.fs.mkdir(deep_store_dir)
        self.assigner = SegmentAssigner(registry)
        self.controller_id = controller_id
        registry.register_instance(InstanceInfo(controller_id, Role.CONTROLLER))
        # HA state (start_ha): which lead partitions this controller holds.
        # HA never started → is_lead_for() says yes to everything (the
        # single-controller deployment needs no election); HA STOPPED is a
        # tombstone that leads NOTHING — a drained controller whose
        # periodic loop hasn't been torn down yet must not fall back to
        # "I lead everything" and split-brain with the survivor.
        self._ha_thread: Optional[threading.Thread] = None
        self._ha_stopped = False
        self._held_partitions: set = set()
        # pressure-driven elasticity (controller/autoscaler.py)
        # — attach_autoscaler wires it; run_autoscale rides the periodic
        # loop as a cluster-wide (global-lead) duty
        self.autoscaler = None

    def table_heat(self, table: str) -> dict:
        """Aggregated per-segment access temperature for ``table``
        — the GET /tables/{t}/heat payload."""
        return aggregate_heat(self.registry, table)

    def table_tiers(self, table: str) -> dict:
        """Aggregated per-segment tier view for ``table`` —
        the GET /tables/{t}/tiers payload."""
        return aggregate_tiers(self.registry, table)

    def attach_autoscaler(self, spawn_fn, drain_fn, **kwargs):
        """Wire the pressure-driven autoscaler: ``spawn_fn()``
        starts one more server (returns its instance id), ``drain_fn(id)``
        gracefully drains one (ServerInstance.stop's drain contract).
        Watermarks/sustain knobs ride ``kwargs`` — see
        controller/autoscaler.py. Returns the attached instance."""
        from pinot_tpu_torch.controller.autoscaler import ControllerAutoscaler

        self.autoscaler = ControllerAutoscaler(
            self, spawn_fn, drain_fn, **kwargs)
        return self.autoscaler

    def run_autoscale(self):
        """One autoscaler tick (periodic-loop step, global-lead only —
        two controllers scaling the same fleet would double-spawn)."""
        if self.autoscaler is None or not self._leads_global():
            return None
        return self.autoscaler.tick()

    def run_tier_rebalance(self) -> dict:
        """Tier-aware placement pass: replica-group tables
        whose servers report per-segment tiers re-place so COLD segments
        hold a single copy and hot/warm segments keep full replication.
        Publishes nothing when the plan matches the registry (see
        rebalance_tiered), so running it every periodic tick is free in
        the steady state. Returns {table: [segments whose replica set
        changed]}."""
        changed: dict = {}
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA)
            if not self.registry.replica_groups(table):
                continue  # tier-aware placement rides replica groups
            tiers = aggregate_tiers(self.registry, table).get("segments", {})
            if not tiers:
                continue  # no server reports tiering for this table
            cfg = self.registry.table_config(table)
            if cfg is None:
                continue
            before = self.registry.assignment(table)
            after = self.assigner.rebalance_tiered(
                table, self._table_replication(cfg), tiers)
            moved = sorted(
                seg for seg in set(before) | set(after)
                if sorted(before.get(seg, ())) != sorted(after.get(seg, ())))
            if moved:
                changed[table] = moved
        return changed

    # ---- HA: lease-based leader election + lead-controller partitioning --
    # The reference runs N controllers with Helix leader election and
    # per-table lead-controller partitioning (pinot-controller/.../
    # LeadControllerManager.java:1, lead-controller resource). Here the
    # registry's atomic lease tx is the arbiter: tables hash onto
    # LEAD_PARTITIONS lease slots; each live controller (re)acquires what
    # it can every tick, so slots of a dead controller expire and
    # survivors absorb them within one lease TTL. Client-initiated calls
    # (add_table, upload_segment, rebalance) stay valid on ANY controller,
    # exactly like the reference's REST surface — only background duties
    # are partitioned.

    LEAD_PARTITIONS = 4

    @staticmethod
    def _lead_lease_name(p: int) -> str:
        return f"controller/lead/{p}"

    def start_ha(self, lease_ttl_ms: int = 3000,
                 interval_s: float = 0.5) -> None:
        """Join the controller quorum: acquire/renew lead-partition leases
        on a timer. Safe to call on every controller process; they split
        the partitions and fail over on lease expiry."""
        if self._ha_thread is not None:
            return
        self._ha_ttl_ms = lease_ttl_ms
        self._ha_stopped = False
        self._ha_stop = threading.Event()

        def loop():
            while not self._ha_stop.wait(interval_s):
                try:
                    self._ha_tick()
                except Exception:
                    log.exception("HA lease tick failed")

        self._ha_tick()  # hold leases before the thread's first wait
        self._ha_thread = threading.Thread(
            target=loop, name=f"ha-{self.controller_id}", daemon=True)
        self._ha_thread.start()

    def _ha_tick(self) -> None:
        # fair share: live controllers split the partitions (ceil so every
        # slot has an eligible holder); a dead peer's heartbeat stales out
        # of the live set, its quota-raised survivors absorb the expired
        # leases. One registry tx renews/acquires/yields + heartbeats.
        live = {i.instance_id for i in self.registry.instances(
            Role.CONTROLLER, live_ttl_ms=max(3 * self._ha_ttl_ms, 2000))}
        live.add(self.controller_id)
        quota = -(-self.LEAD_PARTITIONS // len(live))
        order = sorted(range(self.LEAD_PARTITIONS),
                       key=lambda p: (p not in self._held_partitions, p))
        held_names = self.registry.lease_tick(
            self.controller_id, [self._lead_lease_name(p) for p in order],
            quota, self._ha_ttl_ms)
        held = {p for p in range(self.LEAD_PARTITIONS)
                if self._lead_lease_name(p) in held_names}
        if held != self._held_partitions:
            log.info("controller %s lead partitions: %s -> %s",
                     self.controller_id, sorted(self._held_partitions),
                     sorted(held))
        self._held_partitions = held

    def stop_ha(self, release: bool = True) -> None:
        """``release=False`` models a crash: leases stay until TTL expiry,
        which is exactly what a standby's takeover test needs."""
        if self._ha_thread is None:
            return
        self._ha_stop.set()
        self._ha_thread.join(5)
        self._ha_thread = None
        self._ha_stopped = True  # tombstone: lead NOTHING from now on
        if release:
            for p in list(self._held_partitions):
                self.registry.release_lease(
                    self._lead_lease_name(p), self.controller_id)
            # leave the quorum's liveness window too, so survivors
            # re-quota immediately instead of waiting out the TTL
            self.registry.expire_heartbeat(self.controller_id)
        self._held_partitions = set()

    def _ha_active(self) -> bool:
        return self._ha_thread is not None or self._ha_stopped

    def is_lead_for(self, table: str) -> bool:
        """Does this controller own the background duties for ``table``?"""
        if not self._ha_active():
            return True  # HA never started: single controller leads all
        p = zlib.crc32(table.encode("utf-8")) % self.LEAD_PARTITIONS
        return p in self._held_partitions

    def _leads_global(self) -> bool:
        """Cluster-wide (non-table-scoped) duties run on the partition-0
        holder only."""
        return not self._ha_active() or 0 in self._held_partitions

    # ---- table lifecycle -------------------------------------------------
    def add_table(self, config: TableConfig, schema: Schema) -> None:
        """Tables register under their type-suffixed physical name
        (sales_OFFLINE / sales_REALTIME) — a raw name with both parts is a
        hybrid table and the broker splits queries at the time boundary."""
        self.registry.add_table(config, schema, key=config.table_name_with_type)
        if config.table_type == TableType.REALTIME and config.stream is not None:
            self._assign_stream_partitions(config)

    def drop_table(self, table: str) -> None:
        self.registry.drop_table(table)

    def update_schema(self, table: str, schema: Schema) -> None:
        """Additive schema evolution (SchemaUtils.validate backward-compat
        rules): new columns may be added; existing columns must keep their
        type and single/multi-value shape. Servers pick up the new schema
        on their next sync tick and synthesize default values for columns
        absent from old segments."""
        # hybrid tables evolve BOTH physical variants in step — a stale
        # realtime schema would serve KeyErrors for the new columns
        keys = [k for k in (table, f"{table}_OFFLINE", f"{table}_REALTIME")
                if self.registry.table_schema(k) is not None]
        if not keys:
            raise KeyError(f"table {table!r} not found")
        for key in keys:
            old = self.registry.table_schema(key)
            for name in old.column_names():
                new_field = schema.fields.get(name)
                if new_field is None:
                    raise ValueError(
                        f"schema evolution cannot drop column {name!r}")
                old_field = old.field(name)
                if new_field.data_type is not old_field.data_type or \
                        new_field.single_value != old_field.single_value or \
                        new_field.role is not old_field.role:
                    raise ValueError(
                        f"schema evolution cannot change column {name!r} "
                        f"(type/shape/role must stay fixed)")
        for key in keys:
            self.registry.update_schema(key, schema)

    def _realtime_replication(self, config: TableConfig) -> int:
        """Replica consumers per partition. Upsert tables pin to 1: each
        replica maintains independent validDocIds state, and adopted
        segments would desync it (the reference requires strict replica
        routing for upsert for the same reason)."""
        if config.upsert.mode != "NONE":
            return 1
        return max(1, config.replication)

    def _assign_stream_partitions(self, config: TableConfig) -> None:
        """Stream partition → [servers], replication-aware round-robin
        (PinotLLCRealtimeSegmentManager's consuming-segment creation; every
        listed replica consumes, commits arbitrate via the completion FSM)."""
        from pinot_tpu_torch.stream.spi import create_consumer_factory

        servers = sorted(
            i.instance_id
            for i in self.registry.instances(Role.SERVER,
                                             live_ttl_ms=self.assigner.live_ttl_ms)
        )
        if not servers:
            raise RuntimeError("no servers available for realtime partitions")
        n = create_consumer_factory(config.stream).partition_count()
        reps = min(self._realtime_replication(config), len(servers))
        mapping = {
            p: [servers[(p + r) % len(servers)] for r in range(reps)]
            for p in range(n)
        }
        self.registry.set_partition_assignment(config.table_name_with_type, mapping)

    def run_realtime_repair(self) -> dict:
        """RealtimeSegmentValidationManager analog: re-home partitions whose
        consumers died so ingestion continues (the new owner resumes from
        the last completed commit in the registry)."""
        live = sorted(
            i.instance_id
            for i in self.registry.instances(Role.SERVER,
                                             live_ttl_ms=self.assigner.live_ttl_ms)
        )
        changed = {}
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA partitioning)
            cfg = self.registry.table_config(table)
            if cfg is None or cfg.stream is None:
                continue
            pa = self.registry.partition_assignment(table)
            if not pa or not live:
                continue
            want = min(self._realtime_replication(cfg), len(live))
            new_pa = {}
            dirty = False
            for p, insts in pa.items():
                alive = [i for i in insts if i in live]
                if len(alive) < want:
                    for cand in live:
                        if len(alive) >= want:
                            break
                        if cand not in alive:
                            alive.append(cand)
                    dirty = True
                elif len(alive) != len(insts):
                    dirty = True
                new_pa[p] = alive
            if dirty:
                self.registry.set_partition_assignment(table, new_pa)
                changed[table] = new_pa
        # Hard-dead repair (the reference gets this from Helix dropping the
        # dead participant's ephemeral node + the periodic validators):
        # 1. scrub dead instances from the external view — a killed server
        #    can't deregister itself, and stale EV entries keep brokers
        #    routing (and 427-ing) at it;
        # 2. rebalance tables whose ASSIGNMENT references a dead instance,
        #    against the conservatively-live server set — this restores
        #    replication on live servers AND bounds the assignment ghosts
        #    merge_instances publishing would otherwise accumulate.
        # Conservative cut: 2x the liveness TTL — a server mid-way through
        # a long segment download heartbeats late but isn't dead — and
        # never sweep when NO server looks live (host suspend/resume makes
        # every heartbeat stale at once; a routing blackout is worse than
        # stale entries).
        if live:
            hard_live = {
                i.instance_id
                for i in self.registry.instances(
                    Role.SERVER, live_ttl_ms=self.assigner.live_ttl_ms * 2)
            }
            registered = {i.instance_id
                          for i in self.registry.instances(Role.SERVER)}
            dead = registered - hard_live
            if dead:
                self.registry.scrub_instances(dead)
                for table in self.registry.tables():
                    if not self.is_lead_for(table):
                        continue  # another controller leads this table (HA partitioning)
                    assign = self.registry.assignment(table)
                    if not any(dead & set(v) for v in assign.values()):
                        continue
                    cfg = self.registry.table_config(table)
                    if cfg is None:
                        continue
                    if self.registry.replica_groups(table):
                        self.assigner.rebalance_replica_groups(
                            table, self._table_replication(cfg))
                    else:
                        self.assigner.rebalance(
                            table, self._table_replication(cfg),
                            servers=sorted(hard_live),
                        )
        return changed

    # ---- segment lifecycle -----------------------------------------------
    def resolve(self, table: str) -> str:
        """Raw name → physical registry key (OFFLINE preferred for pushes)."""
        tables = set(self.registry.tables())
        if table in tables:
            return table
        for suffix in ("_OFFLINE", "_REALTIME"):
            if f"{table}{suffix}" in tables:
                return f"{table}{suffix}"
        raise KeyError(f"table {table!r} not found")

    def upload_segment(self, table: str, segment_dir: str,
                       copy_to_deep_store: bool = True) -> SegmentRecord:
        """Segment push (PinotSegmentUploadDownloadRestletResource →
        PinotHelixResourceManager.addNewSegment → IdealState update)."""
        table = self.resolve(table)
        cfg = self.registry.table_config(table)
        if cfg is None:
            raise KeyError(f"table {table!r} not found")
        seg = ImmutableSegment(segment_dir)
        location = segment_dir
        if copy_to_deep_store:
            location = os.path.join(self.deep_store, table, seg.name)
            if os.path.abspath(location) != os.path.abspath(segment_dir):
                self.fs.copy(segment_dir, location)
        meta = seg.metadata
        record = SegmentRecord(
            name=seg.name, table=table, n_docs=seg.n_docs, location=location,
            state=SegmentState.ONLINE, start_time=meta.start_time,
            end_time=meta.end_time, crc=meta.crc,
            **_partition_record_fields(meta),
            **_column_stats_fields(meta),
        )
        instances = self.assigner.assign_with_groups(table, record)
        if instances is None:
            instances = self.assigner.assign(self._table_replication(cfg))
        self.registry.add_segment(record, instances)
        return record

    @staticmethod
    def _table_replication(cfg: TableConfig) -> int:
        # dim tables replicate everywhere (DimensionTableDataManager model);
        # assign() caps at the live-server count
        return 1_000_000 if cfg.is_dim_table else cfg.replication

    def delete_segment(self, table: str, name: str) -> None:
        table = self.resolve(table)
        rec = self.registry.segments(table).get(name)
        self.registry.remove_segment(table, name)
        if rec is not None and rec.location.startswith(self.deep_store):
            self.fs.delete(rec.location)

    def rebalance(self, table: str) -> dict:
        table = self.resolve(table)
        cfg = self.registry.table_config(table)
        if cfg is None:
            raise KeyError(f"table {table!r} not found")
        if self.registry.replica_groups(table):
            # replica-group-aware tables stay replica-group-aware: a plain
            # rebalance must not silently collapse the group structure
            return self.assigner.rebalance_replica_groups(
                table, self._table_replication(cfg))
        return self.assigner.rebalance(table, self._table_replication(cfg))

    def setup_replica_groups(self, table: str) -> dict:
        """Opt a table into replica-group segment assignment:
        partitions the live servers into ``replication`` named groups and
        places every segment once per group. From here on uploads place
        group-aware and ``rebalance``/the periodic repair keep the group
        map consistent with membership. Returns the new assignment."""
        table = self.resolve(table)
        cfg = self.registry.table_config(table)
        if cfg is None:
            raise KeyError(f"table {table!r} not found")
        return self.assigner.rebalance_replica_groups(
            table, self._table_replication(cfg))

    def run_replica_group_repair(self) -> list:
        """Rebalance-on-join/leave for replica-group tables: when the live
        server set no longer matches a table's group membership (a server
        joined, died, or deregistered), rebuild the groups with minimal
        movement. Runs from the periodic loop like the other repairs."""
        live = {i.instance_id for i in self.assigner._live_servers()}
        fixed = []
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA partitioning)
            groups = self.registry.replica_groups(table)
            if not groups:
                continue
            members = {m for ms in groups.values() for m in ms}
            if members != live and live:
                cfg = self.registry.table_config(table)
                if cfg is None:
                    continue
                self.assigner.rebalance_replica_groups(
                    table, self._table_replication(cfg))
                fixed.append(table)
        return fixed

    # ---- minion task generation (PinotTaskManager analog) ----------------
    def run_task_generation(self, now_ms: Optional[int] = None) -> list:
        """Scan table task_configs and enqueue due minion tasks."""
        from pinot_tpu_torch.minion.generator import generate_tasks

        return generate_tasks(self.registry, now_ms)

    def run_task_repair(self, stale_ms: int = 600_000) -> dict:
        """Repair after a minion death (TaskMetricsEmitter/stale-task sweep
        analog, mirroring the completion FSM's stale-COMMITTING takeover):

        - RUNNING tasks untouched for ``stale_ms`` requeue as PENDING
          (FAILED once their claim attempts are exhausted);
        - IN_PROGRESS lineage entries untouched for ``stale_ms`` unwind —
          their TO segments are routing-excluded, so deleting them first and
          then dropping the entry can never double-route.
        """
        # Unwind stale swaps BEFORE requeueing their tasks: a re-claimed
        # task starts a fresh lineage + uploads a fresh replacement, and a
        # later unwind of the OLD entry must never race with (or delete
        # segments belonging to) the new attempt.
        reverted = []
        # no per-table lead guard here: task generation/repair run as ONE
        # cluster-wide duty on the partition-0 holder (periodic loop), so
        # the stale-task sweep and the lineage unwind can't split brains
        for table in self.registry.tables():
            for lid, entry in self.registry.stale_in_progress_lineage(
                    table, stale_ms).items():
                # CAS-claim the unwind first: if the executor completed the
                # flip in the meantime, the TO set is live data — touching
                # it would delete the only remaining copy.
                if not self.registry.try_abort_lineage(table, lid):
                    continue
                for name in entry["to"]:
                    if name in self.registry.segments(table):
                        self.delete_segment(table, name)
                self.registry.revert_lineage(table, lid)
                reverted.append((table, lid))
        requeued = self.registry.requeue_stale_tasks(stale_ms)
        return {"requeued_tasks": requeued, "reverted_lineage": reverted}

    def run_segment_relocation(self, now_ms: Optional[int] = None) -> dict:
        """Tier storage relocation (relocation/SegmentRelocator.java
        analog): segments older than a tier's segment_age_ms move to live
        servers carrying the tier's server_tag (Helix-tag analog on
        InstanceInfo.tags); servers reconcile the new assignment on their
        next sync (download there, refcounted unload here). Returns
        {table: {segment: {tier, to}}}."""
        import time as _time

        now = now_ms if now_ms is not None else int(_time.time() * 1000)
        live = self.registry.instances(
            Role.SERVER, live_ttl_ms=self.assigner.live_ttl_ms)
        by_tag: dict = {}
        for i in live:
            for t in getattr(i, "tags", ()) or ():
                by_tag.setdefault(t, []).append(i.instance_id)
        moved: dict = {}
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA partitioning)
            cfg = self.registry.table_config(table)
            tiers = getattr(cfg, "tiers", None) if cfg else None
            if not tiers:
                continue
            assign = self.registry.assignment(table)
            recs = self.registry.segments(table)
            new = {k: list(v) for k, v in assign.items()}
            dirty = False
            repl = self._table_replication(cfg)
            for name, rec in recs.items():
                # age by the segment's data END TIME like run_retention and
                # the reference's TimeBasedTierSegmentSelector — push time
                # only when the table has no time column (a backfilled
                # segment of old data must tier by its data, not its push)
                basis = rec.end_time if rec.end_time is not None \
                    else rec.push_time_ms
                age = now - (basis or now)
                tier = None
                # oldest-threshold tier wins when several match
                for t in sorted(tiers, key=lambda t: t["segment_age_ms"],
                                reverse=True):
                    if age >= t["segment_age_ms"]:
                        tier = t
                        break
                if tier is None:
                    continue
                targets = sorted(by_tag.get(tier["server_tag"], []))
                if not targets:
                    continue  # no capacity on the tier: stay put
                k = max(1, min(repl, len(targets)))
                # spread segments across the tier (balanced like the
                # reference relocator) — a fixed prefix would pile every
                # segment onto the lexicographically-first tagged server
                start = zlib.crc32(name.encode()) % len(targets)
                want = sorted(targets[(start + j) % len(targets)]
                              for j in range(k))
                if sorted(new.get(name, [])) != want:
                    new[name] = want
                    dirty = True
                    moved.setdefault(table, {})[name] = {
                        "tier": tier["name"], "to": want}
            if dirty:
                self.registry.set_assignment(table, new)
        return moved

    def recommend_config(self, schema, sample_queries,
                         qps: float = 100.0) -> dict:
        """Workload-driven config advisor (recommender/RecommenderDriver
        role) — advisory, nothing is applied."""
        from pinot_tpu_torch.controller.advisor import recommend_config

        return recommend_config(schema, sample_queries, qps)

    def tune_table(self, table: str) -> dict:
        """Observed-metadata config tuner (tuner/TableConfigTuner role):
        grows the registered table's IndexingConfig from hosted segment
        stats and persists the update."""
        from pinot_tpu_torch.controller.advisor import tune_table
        from pinot_tpu_torch.storage.segment import ImmutableSegment

        table = self.resolve(table)
        segs = []
        for name, rec in self.registry.segments(table).items():
            if rec.location and os.path.isdir(rec.location):
                segs.append(ImmutableSegment(rec.location))
                break  # stats from one representative segment suffice
        return tune_table(self.registry, table, segs)

    def start_periodic_tasks(self, interval_s: float = 60.0) -> None:
        """ControllerPeriodicTaskScheduler analog: retention, realtime
        repair, minion task generation and stale-task repair on a timer
        (the reference schedules RetentionManager, RealtimeSegmentValidation-
        Manager and PinotTaskManager the same way)."""
        if getattr(self, "_periodic_thread", None) is not None:
            return
        self._periodic_stop = threading.Event()

        def loop():
            while not self._periodic_stop.wait(interval_s):
                # table-scoped duties filter per table (is_lead_for inside
                # their loops); cluster-wide duties run on the partition-0
                # holder only
                steps = [self.run_retention, self.run_realtime_repair,
                         self.run_dim_table_replication,
                         self.run_replica_group_repair,
                         self.run_segment_relocation,
                         self.run_tier_rebalance]
                if self._leads_global():
                    steps += [self.run_task_generation, self.run_task_repair,
                              self.run_autoscale]
                for step in steps:
                    try:
                        step()
                    except Exception:
                        log.exception("periodic task %s failed", step.__name__)

        self._periodic_thread = threading.Thread(
            target=loop, name="controller-periodic", daemon=True
        )
        self._periodic_thread.start()

    def stop_periodic_tasks(self) -> None:
        if getattr(self, "_periodic_thread", None) is not None:
            self._periodic_stop.set()
            self._periodic_thread.join(5)
            self._periodic_thread = None

    def run_dim_table_replication(self) -> list:
        """Keep dimension tables replicated to EVERY live server as
        membership changes (the reference re-assigns dim tables on server
        join; without this, LOOKUP fails on fact segments placed on a
        server that joined after the dim upload)."""
        live = {i.instance_id for i in self.assigner._live_servers()}
        fixed = []
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA partitioning)
            cfg = self.registry.table_config(table)
            if cfg is None or not cfg.is_dim_table:
                continue
            assignment = self.registry.assignment(table)
            if any(set(insts) != live for insts in assignment.values()):
                self.assigner.rebalance(table, self._table_replication(cfg))
                fixed.append(table)
        return fixed

    # ---- periodic maintenance (RetentionManager analog) ------------------
    def run_retention(self, now_ms: Optional[int] = None) -> list:
        """Drop segments whose time range fell out of the retention window."""
        from pinot_tpu_torch.minion.generator import _busy_segments

        now_ms = now_ms or int(time.time() * 1000)
        dropped = []
        for table in self.registry.tables():
            if not self.is_lead_for(table):
                continue  # another controller leads this table (HA partitioning)
            cfg = self.registry.table_config(table)
            if cfg is None or cfg.retention_days is None:
                continue
            cutoff = now_ms - cfg.retention_days * 86_400_000
            # segments mid-swap or claimed by a minion task are off limits:
            # deleting a FROM segment while its replace is IN_PROGRESS would
            # drop rows from routed results mid-swap (they age out of the
            # busy set once the task/lineage resolves, and get deleted then)
            busy = _busy_segments(self.registry, table)
            for name, rec in self.registry.segments(table).items():
                if name in busy:
                    continue
                if rec.end_time is not None and rec.end_time < cutoff:
                    self.delete_segment(table, name)
                    dropped.append((table, name))
        return dropped
