"""Tiered segment lifecycle: temperature-driven hot/warm/cold storage.

The storage tier of a server (the port of pinot_tpu.server.tiering). Every
segment a server hosts lives in exactly one of three tiers:

- **hot**   — current behavior: host-resident working copy, eligible for
  the device ``BatchContext`` path (columns uploaded to HBM, batch LRU,
  partials cache). The capacity tier the narrow-width planning and
  sub-RTT machinery serve from.
- **warm**  — local working copy on disk, columns lazily mmap'd PER QUERY
  through :class:`LazySegmentView` (only the ``.npy`` planes a query
  touches are mapped — ``PinotDataBuffer.mapFile`` semantics, PAPER.md
  layer 1). Warm segments run on the host scan path and never occupy HBM.
- **cold**  — deep-store only (the PinotFS SPI, PAPER.md layer 7): the
  local plane files are evicted (``metadata.json`` stays so the sync loop
  and schema surface keep working) and ``SegmentRecord.location`` is the
  source of truth. A query that routes a cold segment gets an HONEST
  in-flight partial (``numSegmentsCold`` counter) while the touch kicks
  off an asynchronous re-download (PinotFS with the deadline/retry
  contract, peer-download fallback) — the scheduler slot is never blocked
  on a deep-store fetch.

The :class:`TierManager` drives promotion/demotion from the 
``SegmentHeatTracker`` decayed rates plus the ``hbm_stats`` batch
hit/miss counters, with NARROW-WIDTH-AWARE admission cost: a segment's
hot-tier charge is its modeled ColPlan bytes (``segment_plan_bytes``) —
a uint8 dict-id plane costs 4x less than the int32 the legacy LRU
implicitly assumed — so the hot set holds what actually fits in HBM.

Divergence from the reference: Pinot tiers by TIME (TierConfig
``segment_age_ms`` + ``RealtimeToOfflineSegmentsTask``); this lifecycle
tiers by measured TEMPERATURE, with the controller's tier-aware
replica-group assignment (controller.py ``rebalance_tiered``) shrinking
cold segments to a single copy behind the object store.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
import time
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from pinot_tpu_torch.common.config import Configuration
from pinot_tpu_torch.common.deadline import Deadline
from pinot_tpu_torch.storage.segment import (
    METADATA_FILE,
    Encoding,
    ImmutableSegment,
    SegmentMetadata,
)

log = logging.getLogger("pinot_tpu_torch.server.tiering")


class Tier:
    HOT = "hot"
    WARM = "warm"
    COLD = "cold"


_TIER_RANK = {Tier.HOT: 0, Tier.WARM: 1, Tier.COLD: 2}


def segment_plan_bytes(seg) -> int:
    """Modeled DEVICE bytes of a segment's column planes — the hot-tier
    admission charge. Mirrors the ColPlan width rules (engine/params.py)
    without importing jax: dict-id planes at uint8/uint16/int32 by
    cardinality, raw integer planes at the frame-of-reference width their
    metadata bounds allow, floats at the device f32 width, MV id blocks
    at int32 x entries. Zone maps (~1/4096 of a plane) and the opt-in
    sub-byte tier are ignored — this is an admission COST MODEL, not an
    allocator; what matters is that a narrow segment charges what it
    actually occupies (4-8x less than logical width) so the hot budget
    admits 4-8x more of them."""
    total = 0
    n = int(seg.n_docs)
    for m in seg.metadata.columns.values():
        entries = int(m.total_number_of_entries or n) if not m.single_value \
            else n
        if m.encoding == Encoding.DICT:
            if not m.single_value:
                total += 4 * entries  # MV (S, L, K) blocks stay int32
                continue
            c = max(1, int(m.cardinality))
            total += entries * (1 if c <= 255 else 2 if c <= 65535 else 4)
            continue
        dt = m.data_type.np_dtype
        if dt.kind == "f":
            total += entries * 4  # device float space is f32
            continue
        if dt.kind in ("i", "u") and isinstance(m.min_value, (int, np.integer)) \
                and isinstance(m.max_value, (int, np.integer)):
            lo, hi = int(m.min_value), int(m.max_value)
            rng = hi - lo
            if rng < (1 << 8) and dt.itemsize > 1:
                total += entries
            elif rng < (1 << 16) and dt.itemsize > 2:
                total += entries * 2
            elif rng < (1 << 32) and dt.itemsize > 4:
                total += entries * 4
            else:
                total += entries * dt.itemsize
            continue
        total += entries * max(1, dt.itemsize)
    return total


class LazySegmentView(ImmutableSegment):
    """Warm-tier reader: an ImmutableSegment whose plane loads are
    OBSERVED (the ``plane_load_hook`` seam in storage/segment.py) so the
    warm contract — a query touching 2 of 20 columns maps only those
    planes — is assertable, and whose decoded caches can be released
    (``release_planes``) without tearing the segment down. The mmaps
    themselves are page-cache-backed, so released planes cost a re-map,
    not a re-read."""

    def __init__(self, segment_dir: str):
        super().__init__(segment_dir)
        self.tier = Tier.WARM
        self.planes_loaded: set = set()
        self.plane_loads = 0
        self.plane_load_hook = self._on_plane_load

    def _on_plane_load(self, fname: str) -> None:
        self.planes_loaded.add(fname)
        self.plane_loads += 1

    def release_planes(self) -> None:
        """Drop every cached plane handle (decoded packed/compressed
        columns included) — the warm tier's host-RAM bound."""
        self._fwd_cache.clear()
        self._dict_cache.clear()
        self._json_cache.clear()
        self._text_cache.clear()
        for attr in ("_fst_cache", "_geo_cache"):
            if hasattr(self, attr):
                getattr(self, attr).clear()


class _EmptyColdView:
    """Zero-doc reader over a cold segment's METADATA — the schema donor
    for synthesizing an empty partial when EVERY routed segment is cold
    (the host executor needs a segment to shape the empty result by, and
    a cold segment's plane files are gone)."""

    is_mutable = False
    valid_docs_mask = None
    n_docs = 0

    def __init__(self, ref: "ColdSegmentRef"):
        self.metadata = ref.metadata
        self.dir = ref.dir
        self.table_schema = getattr(ref, "table_schema", None)

    @property
    def name(self) -> str:
        return self.metadata.segment_name

    def column_names(self) -> list:
        return list(self.metadata.columns)

    def column_metadata(self, col: str):
        return self.metadata.columns[col]

    def values(self, col: str) -> np.ndarray:
        return np.empty(0, dtype=self.metadata.columns[col].data_type.np_dtype)

    def flat_values(self, col: str) -> np.ndarray:
        return self.values(col)

    def forward(self, col: str) -> np.ndarray:
        return np.empty(0, dtype=np.int32)

    def mv_offsets(self, col: str):
        if self.metadata.columns[col].single_value:
            return None
        return np.zeros(1, dtype=np.int64)

    def dictionary(self, col: str):
        # the port's device context reads a dictionary column's
        # dictionary even at zero docs: an empty one of the column's type
        m = self.metadata.columns[col]
        if not m.has_dictionary:
            return None
        from pinot_tpu_torch.storage.dictionary import Dictionary

        return Dictionary(np.empty(0, dtype=m.data_type.np_dtype))

    def inverted(self, col: str):
        return None

    def bloom(self, col: str):
        return None

    def zone_map(self, col: str):
        return None

    def range_index(self, col: str):
        return None

    def json_index(self, col: str):
        return None

    def text_index(self, col: str):
        return None

    def fst_index(self, col: str):
        return None

    def geo_index(self, col: str):
        return None

    def null_vector(self, col: str):
        return None

    def has_star_tree(self) -> bool:
        return False


class ColdSegmentRef:
    """Cold-tier placeholder hosted in the TableDataManager: keeps the
    segment ROUTABLE (external view, broker fan-out) and its metadata
    queryable while the plane files live only in the deep store. The
    engine splits these out at ``execute_segments_async`` — they count as
    ``numSegmentsCold`` in the partial and their ``touch()`` enqueues an
    asynchronous hydration, so a query never blocks its scheduler slot on
    a deep-store download."""

    is_mutable = False
    valid_docs_mask = None
    is_cold = True
    tier = Tier.COLD

    def __init__(self, table: str, metadata: SegmentMetadata, seg_dir: str,
                 manager: Optional["TierManager"] = None):
        self.table = table
        self.metadata = metadata
        self.dir = seg_dir
        self.manager = manager
        self.table_schema = None

    @property
    def name(self) -> str:
        return self.metadata.segment_name

    @property
    def n_docs(self) -> int:
        return self.metadata.n_docs

    def column_names(self) -> list:
        return list(self.metadata.columns)

    def column_metadata(self, col: str):
        return self.metadata.columns[col]

    def has_star_tree(self) -> bool:
        return False

    def touch(self) -> None:
        """A query routed this cold segment: schedule its re-download
        (never blocks the caller)."""
        if self.manager is not None:
            self.manager.request_hydration(self.table, self.name)

    def empty_view(self) -> _EmptyColdView:
        return _EmptyColdView(self)


# plane files that survive a cold demotion: the metadata keeps the sync
# loop / schema surface honest, creation meta is a few bytes of provenance
_COLD_KEEP = (METADATA_FILE, "creation.meta.json")


class TierManager:
    """Per-server tier lifecycle manager.

    Inputs: the ``SegmentHeatTracker``'s decayed per-segment rates
    (``iter_all`` — the UNCAPPED export, demotion needs the cold tail the
    heartbeat's top-N drops) and the device executor's batch hit/miss
    counters. Each ``tick``:

    1. Ranks sealed segments by decayed rate and admits the hottest into
       the hot tier until the NARROW-WIDTH-AWARE byte budget
       (``segment_plan_bytes``) is spent; the rest demote to warm.
    2. Scales the effective hot budget by the observed batch-cache hit
       ratio: a miss-dominated window means the hot set thrashes the LRU
       (shrink toward 0.25x), a hit-dominated one recovers toward 1x.
    3. Demotes warm segments idle past ``cold.idle.ms`` with rate under
       ``cold.max.rate`` to cold — ONLY when the registry's
       ``SegmentRecord.location`` is a durable copy outside this server's
       data dir (own realtime seals never demote their only copy).
    4. Hydrates requested cold segments on a background worker (PinotFS
       download bounded by the deadline contract, peer-download
       fallback), landing them WARM.

    Config (``pinot.server.tier.*``): ``enabled`` (default off),
    ``interval.ms``, ``hot.bytes`` (default: the device executor's byte
    budget), ``hot.min.rate``, ``cold.max.rate``, ``cold.idle.ms``,
    ``download.timeout.ms``.
    """

    def __init__(self, server, overrides: Optional[dict] = None):
        self.server = server
        conf = Configuration(overrides=overrides)
        self.enabled = conf.get_bool("pinot.server.tier.enabled", False)
        self.interval_s = conf.get_float(
            "pinot.server.tier.interval.ms", 5_000.0) / 1e3
        dev = getattr(server.engine, "device", None)
        default_budget = getattr(dev, "MAX_CACHED_BYTES", 0) if dev is not None \
            else 0
        self.hot_budget_bytes = int(conf.get_float(
            "pinot.server.tier.hot.bytes", float(default_budget)))
        # minimum decayed rate for hot admission: segments colder than
        # this stay warm even when the budget has room (uploading a
        # never-queried segment to HBM is pure waste)
        self.hot_min_rate = conf.get_float(
            "pinot.server.tier.hot.min.rate", 0.05)
        self.cold_max_rate = conf.get_float(
            "pinot.server.tier.cold.max.rate", 0.01)
        self.cold_idle_s = conf.get_float(
            "pinot.server.tier.cold.idle.ms", 600_000.0) / 1e3
        self.download_timeout_s = conf.get_float(
            "pinot.server.tier.download.timeout.ms", 60_000.0) / 1e3
        self._budget_scale = 1.0
        self._last_hits = self._last_misses = 0
        self._last_tick = 0.0
        self._lock = threading.Lock()
        self._cold: dict = {}        # (table, name) -> ColdSegmentRef
        # (table, name) -> (seg dir, modeled device bytes): the dir keys
        # refresh pushes (same name, new CRC dir) to a re-model
        self._plan_bytes: dict = {}
        # when the lifecycle first saw a segment: a never-queried segment
        # idles from its LOAD, not from the epoch — without this, freshly
        # assigned segments (no heat entry yet) would demote to cold on
        # the first tick
        self._first_seen: dict = {}
        self._hydrate_q: "queue.Queue" = queue.Queue()
        self._hydrating: set = set()
        self._hydrator: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # lifecycle counters (bench detail.tiering + tests)
        self.demotions_warm = 0
        self.demotions_cold = 0
        self.promotions_hot = 0
        self.hydrations = 0
        self.hydration_failures = 0

    # ---- observability ---------------------------------------------------
    def snapshot(self) -> dict:
        """{table: {segment: tier}} — the per-segment tier map the
        heartbeat piggybacks (cluster/registry.py InstanceInfo.tiers) and
        the controller's tier-aware assignment consumes."""
        out: dict = {}
        for table, tdm in list(self.server.engine.tables.items()):
            for name, seg in list(tdm.segments.items()):
                if getattr(seg, "is_mutable", False):
                    continue  # consuming segments live outside the lifecycle
                out.setdefault(table, {})[name] = getattr(
                    seg, "tier", None) or Tier.HOT
        return out

    def stats(self) -> dict:
        return {
            "demotions_warm": self.demotions_warm,
            "demotions_cold": self.demotions_cold,
            "promotions_hot": self.promotions_hot,
            "hydrations": self.hydrations,
            "hydration_failures": self.hydration_failures,
            "cold_segments": len(self._cold),
            "budget_scale": round(self._budget_scale, 3),
            "hot_budget_bytes": self.hot_budget_bytes,
        }

    def cold_segments(self, table: str) -> set:
        with self._lock:
            return {n for (t, n) in self._cold if t == table}

    # ---- tick ------------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Interval-gated tick for the server's sync loop."""
        if not self.enabled:
            return False
        now = time.time() if now is None else now
        if now - self._last_tick < self.interval_s:
            return False
        self._last_tick = now
        try:
            self.tick(now=now)
        except Exception:  # noqa: BLE001 — lifecycle must never kill the sync loop
            log.exception("tier tick failed")
        return True

    def _effective_budget(self) -> int:
        """Hot budget scaled by batch-cache behavior (the hbm_stats
        half of the policy): a tick window dominated by batch MISSES means
        the admitted hot set is churning the device LRU — what we called
        hot does not fit — so the effective budget contracts until the
        re-launch traffic calms; hit-dominated windows recover it."""
        dev = getattr(self.server.engine, "device", None)
        if dev is None:
            return 0
        hits, misses = dev.batch_hits, dev.batch_misses
        dh, dm = hits - self._last_hits, misses - self._last_misses
        self._last_hits, self._last_misses = hits, misses
        if dh + dm >= 4:  # ignore idle / tiny windows
            if dm > dh:
                self._budget_scale = max(0.25, self._budget_scale * 0.8)
            elif dh >= 4 * dm:
                # hit-dominated window (a trickle of natural churn misses
                # must not pin the scale at the floor forever): recover
                self._budget_scale = min(1.0, self._budget_scale * 1.1)
        return int(self.hot_budget_bytes * self._budget_scale)

    def _records(self, table: str) -> dict:
        try:
            return self.server.registry.segments(table)
        except Exception:  # noqa: BLE001 — registry hiccups skip a tick
            return {}

    def tick(self, now: Optional[float] = None) -> dict:
        """One full promotion/demotion pass; returns {edge: [names]} of
        the transitions applied (bench/test visibility)."""
        now = time.time() if now is None else now
        heat = {}
        for t, s, rec in self.server.heat.iter_all(now=now):
            heat[(t, s)] = rec
        # prune cold entries the sync loop unloaded (segment unassigned
        # while cold): a later hydration must not resurrect them
        with self._lock:
            for key in list(self._cold):
                tdm = self.server.engine.tables.get(key[0])
                if tdm is None or \
                        tdm.segments.get(key[1]) is not self._cold[key]:
                    del self._cold[key]
        budget = self._effective_budget()
        applied = {"to_hot": [], "to_warm": [], "to_cold": []}
        seen_keys: set = set()
        # rank GLOBALLY across tables: the hot budget models the one
        # device LRU every table shares — a per-table pass would admit
        # N tables x budget and thrash exactly the cache it protects
        candidates = []
        for table, tdm in list(self.server.engine.tables.items()):
            for name, seg in list(tdm.segments.items()):
                if getattr(seg, "is_mutable", False) \
                        or getattr(seg, "is_cold", False):
                    continue
                candidates.append(
                    (float(heat.get((table, name), {}).get("rate", 0.0)),
                     table, name, seg))
        candidates.sort(key=lambda c: (-c[0], c[1], c[2]))
        records_cache: dict = {}
        spent = 0
        for rate, table, name, seg in candidates:
            rec = heat.get((table, name), {})
            last = float(rec.get("lastAccessTs", 0.0))
            seen_keys.add((table, name))
            first = self._first_seen.setdefault((table, name), now)
            cost = self._plan_cost(table, name, seg)
            cur = getattr(seg, "tier", None) or Tier.HOT
            want_hot = (budget > 0 and rate >= self.hot_min_rate
                        and spent + cost <= budget)
            if want_hot:
                spent += cost
                if cur != Tier.HOT:
                    if self.promote_to_hot(table, name):
                        applied["to_hot"].append(name)
                continue
            idle_s = now - max(last, first)
            if rate <= self.cold_max_rate and idle_s >= self.cold_idle_s:
                if table not in records_cache:
                    records_cache[table] = self._records(table)
                if self.demote_to_cold(table, name,
                                       rec=records_cache[table].get(name)):
                    applied["to_cold"].append(name)
                    continue
            if cur == Tier.HOT:
                if self.demote_to_warm(table, name):
                    applied["to_warm"].append(name)
            elif isinstance(seg, LazySegmentView) \
                    and idle_s >= self.cold_idle_s:
                # cold-ineligible (no durable copy) or cold-refused warm
                # segments still shed their decoded plane caches — the
                # warm tier's host-RAM bound is enforced here, not just
                # at tier-transition swaps
                seg.release_planes()
        # forget unloaded segments so the first-seen map stays bounded
        for key in [k for k in self._first_seen if k not in seen_keys]:
            del self._first_seen[key]
        for key in [k for k in self._plan_bytes if k not in seen_keys]:
            del self._plan_bytes[key]
        return applied

    def _plan_cost(self, table: str, name: str, seg) -> int:
        key = (table, name)
        seg_dir = getattr(seg, "dir", "")
        cached = self._plan_bytes.get(key)
        if cached is not None and cached[0] == seg_dir:
            return cached[1]
        # (re)model on first sight AND on a refresh push (same name, new
        # CRC-versioned dir — widths/cardinalities may have changed)
        try:
            cost = segment_plan_bytes(seg)
        except Exception:  # noqa: BLE001 — stats-less segments charge raw
            cost = int(seg.n_docs) * 4 * max(
                1, len(seg.metadata.columns))
        self._plan_bytes[key] = (seg_dir, cost)
        return cost

    # ---- transitions -----------------------------------------------------
    def _tdm(self, table: str):
        return self.server.engine.tables.get(table)

    def demote_to_warm(self, table: str, name: str) -> bool:
        """hot → warm: swap in a fresh LazySegmentView (drops any decoded
        host caches) and evict the segment's device batches so its HBM
        frees NOW, not at LRU depth. Refuses while a query holds the
        segment (retried next tick)."""
        tdm = self._tdm(table)
        if tdm is None:
            return False
        seg = tdm.segments.get(name)
        if seg is None or getattr(seg, "is_mutable", False) \
                or getattr(seg, "is_cold", False):
            return False
        try:
            view = LazySegmentView(seg.dir)
        except Exception:  # noqa: BLE001 — unreadable dir: leave as-is
            log.exception("warm demotion of %s/%s failed to open",
                          table, name)
            return False
        view.table_schema = getattr(seg, "table_schema", None)
        if not tdm.replace_if_idle(name, view):
            return False
        self._evict_device(seg.dir)
        self.demotions_warm += 1
        return True

    def promote_to_hot(self, table: str, name: str) -> bool:
        """warm → hot: flip the routing flag — the next device launch
        re-admits the segment's planes at their ColPlan widths (the
        admission charge ``tick`` already accounted)."""
        tdm = self._tdm(table)
        seg = tdm.segments.get(name) if tdm is not None else None
        if seg is None or getattr(seg, "is_cold", False) \
                or getattr(seg, "is_mutable", False):
            return False
        if (getattr(seg, "tier", None) or Tier.HOT) == Tier.HOT:
            return False
        seg.tier = Tier.HOT
        self.promotions_hot += 1
        return True

    def demote_to_cold(self, table: str, name: str, rec=None) -> bool:
        """warm/hot → cold: evict the local plane files (metadata stays),
        host a ColdSegmentRef so the segment remains routable, deep store
        becomes the only copy. Refuses when the registry record's
        ``location`` is missing or IS this server's working copy (own
        realtime seals: evicting would delete the only copy), or while a
        query holds the segment."""
        tdm = self._tdm(table)
        if tdm is None:
            return False
        seg = tdm.segments.get(name)
        if seg is None or getattr(seg, "is_mutable", False) \
                or getattr(seg, "is_cold", False):
            return False
        if rec is None:
            rec = self._records(table).get(name)
        location = getattr(rec, "location", "") if rec is not None else ""
        if not location:
            return False
        seg_dir = os.path.abspath(seg.dir)
        data_root = os.path.abspath(self.server.data_dir)
        # path-shaped locations (bare paths AND file:// URIs) must point
        # at a copy OUTSIDE this server before the local planes may go —
        # a record whose location IS the working copy (own realtime
        # seals) would otherwise lose its only copy
        local_like = "://" not in location or location.startswith("file://")
        if local_like:
            loc_path = os.path.abspath(
                urlparse(location).path if location.startswith("file://")
                else location)
            if loc_path == seg_dir:
                return False  # the local copy IS the record's location
            if os.path.commonpath([loc_path, data_root]) == data_root:
                return False  # durability would point back into this server
        ref = ColdSegmentRef(table, seg.metadata, seg.dir, manager=self)
        ref.table_schema = getattr(seg, "table_schema", None)
        if not tdm.replace_if_idle(name, ref):
            return False
        with self._lock:
            self._cold[(table, name)] = ref
        self._evict_device(seg.dir)
        # planes go, metadata stays (sync loop + schema surface): only
        # files inside the local working copy are ever deleted
        if os.path.commonpath([seg_dir, data_root]) == data_root:
            for fname in os.listdir(seg.dir):
                if fname in _COLD_KEEP:
                    continue
                p = os.path.join(seg.dir, fname)
                try:
                    if os.path.isdir(p):
                        shutil.rmtree(p, ignore_errors=True)
                    else:
                        os.unlink(p)
                except OSError:
                    pass
        self.demotions_cold += 1
        return True

    def _evict_device(self, seg_dir: str) -> None:
        dev = getattr(self.server.engine, "device", None)
        if dev is not None:
            try:
                dev.evict_segment_dir(seg_dir)
            except Exception:  # noqa: BLE001 — eviction is best-effort
                log.exception("device eviction for %s failed", seg_dir)

    # ---- hydration (cold → warm) -----------------------------------------
    def request_hydration(self, table: str, name: str) -> bool:
        """Enqueue an async re-download of a cold segment (deduped); the
        query that touched it proceeds with an honest partial."""
        key = (table, name)
        with self._lock:
            if key not in self._cold or key in self._hydrating:
                return False
            self._hydrating.add(key)
        if self._hydrator is None or not self._hydrator.is_alive():
            self._hydrator = threading.Thread(
                target=self._hydrate_loop,
                name=f"tier-hydrate-{self.server.instance_id}", daemon=True)
            self._hydrator.start()
        self._hydrate_q.put(key)
        return True

    def _hydrate_loop(self) -> None:
        while not self._stop.is_set():
            try:
                key = self._hydrate_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._hydrate_one(*key)
            except Exception:  # noqa: BLE001 — one failed download ≠ dead worker
                self.hydration_failures += 1
                log.exception("hydration of %s/%s failed", *key)
            finally:
                with self._lock:
                    self._hydrating.discard(key)

    def _hydrate_one(self, table: str, name: str) -> None:
        """Deep-store download → local planes → re-host WARM. Bounded by
        the deadline contract; falls back to a serving peer when the
        deep store is unreachable (server/peer.py)."""
        with self._lock:
            ref = self._cold.get((table, name))
        if ref is None:
            return
        rec = self._records(table).get(name)
        location = getattr(rec, "location", "") if rec is not None else ""
        local = ref.dir
        tmp = f"{local}.hydrate{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        deadline = Deadline(self.download_timeout_s)
        try:
            try:
                if not location:
                    raise FileNotFoundError(
                        f"segment {table}/{name} has no deep-store location")
                from pinot_tpu_torch.storage.fs import create_fs

                create_fs(location).copy(location, tmp)
                deadline.check("deep-store hydration")
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                if deadline.expired():
                    raise
                # deep store unreachable: a serving replica may still hold
                # the planes (PeerServerSegmentFinder role)
                from pinot_tpu_torch.server.peer import peer_download

                peer_download(self.server.registry, table, name, tmp,
                              self.server.instance_id,
                              tls=self.server._tls,
                              timeout_s=self.download_timeout_s,
                              deadline=deadline)
            # move plane files INTO the cold dir one rename at a time —
            # metadata.json is replaced last-wins and the dir never loses
            # it, so the sync loop's lost-files self-heal can't misfire
            os.makedirs(local, exist_ok=True)
            for fname in os.listdir(tmp):
                os.replace(os.path.join(tmp, fname),
                           os.path.join(local, fname))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        view = LazySegmentView(local)
        view.table_schema = getattr(ref, "table_schema", None)
        tdm = self._tdm(table)
        if tdm is None or tdm.segments.get(name) is not ref:
            # unassigned (or replaced) while downloading: don't resurrect
            with self._lock:
                self._cold.pop((table, name), None)
            return
        # the cold ref holds no file handles: a plain add replaces it even
        # under in-flight references
        tdm.add_segment(view)
        with self._lock:
            self._cold.pop((table, name), None)
        self.hydrations += 1
        log.info("segment %s/%s hydrated cold->warm", table, name)

    def wait_hydrated(self, table: str, name: str, timeout_s: float = 10.0) -> bool:
        """Test/bench helper: block until a requested hydration lands."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            with self._lock:
                if (table, name) not in self._cold:
                    return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._hydrator is not None:
            self._hydrator.join(2)
