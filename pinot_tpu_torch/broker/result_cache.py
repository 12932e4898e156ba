"""Broker result cache: serve repeat dashboard queries without a scatter.

Entries are keyed by ``(table, literal-free
template key, literal digest)`` — template keys are literal-free,
so the template key attributes entries per dashboard panel while the
literal digest (a blake2b over the compiled QueryContext, literals
included) pins the exact query. Freshness is validated at GET time, not
TTL-guessed, against two tokens recorded when the entry was filled:

- the registry's ROUTING GENERATION (cluster/registry.py) — any segment
  add/remove/move, lineage flip, or replica-group change bumps it, so a
  cached answer computed over a different segment set never serves;
- the per-table EPOCH VIEW ``{instance: epoch}`` (common/freshness.py) —
  servers bump their table epoch on every in-place mutation (consuming
  appends, chunklet promotion, upsert invalidation, seal) and report it
  piggybacked in every DataTable partial plus the sync heartbeat; any
  drift between the recorded and current view invalidates the entry.

The reference has no broker result cache (its star-tree and segment
caches live server-side) — this is a leapfrog the literal-free template
keys and the invalidation seams made nearly free.

LRU bounded by entries AND bytes (``pinot.broker.resultcache.max.entries``
/ ``.max.bytes``); per-query opt-out via ``SET useResultCache = false``.
Off by default (``pinot.broker.resultcache.enabled``): partial-result and
chaos semantics (deliberately repeated queries against faulted replicas)
must stay exact unless an operator opts the broker in.
"""

from __future__ import annotations

import collections
import copy
import hashlib
import json
import threading
import time


class BrokerResultCache:
    def __init__(self, max_entries: int = 512, max_bytes: int = 32 << 20,
                 stale_retention_s: float = 30.0):
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        # how long a FRESHNESS-stale entry is kept for bounded-staleness
        # load shedding: get() used to drop stale entries on
        # sight, which would leave the shed path nothing to degrade to —
        # now a stale entry lingers this long for get_stale() before the
        # fresh path's drop-on-sight applies (0 restores the old drop)
        self.stale_retention_s = float(stale_retention_s)
        self._lock = threading.Lock()
        # key -> {resp, nbytes, epoch_view, routing_gen, ts}
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.stale_hits = 0

    # ---- keying ----------------------------------------------------------
    # SET options that change WHO asks / HOW the broker admits, never
    # WHAT the rows are: stripped from the digest so tenant
    # admission's queue-jump memo and the bounded-staleness shed path
    # match the entry the same panel filled without them
    _NON_SEMANTIC_OPTIONS = frozenset(
        ("workloadname", "priorityclass", "maxstalenessms"))

    @classmethod
    def key_for(cls, q, template: str) -> tuple:
        """(table, template key, literal digest). The digest covers the
        WHOLE compiled context repr — filter literals, select/order
        shapes, limit/offset, and SET options (minus the admission-only
        options above) — so two queries share an entry only when a
        broker would answer them identically."""
        import dataclasses

        opts = tuple((k, v) for k, v in q.options
                     if str(k).lower() not in cls._NON_SEMANTIC_OPTIONS)
        canon = dataclasses.replace(q, explain=False, options=opts)
        digest = hashlib.blake2b(
            repr(canon).encode("utf-8"), digest_size=16).hexdigest()
        return (q.table_name, template, digest)

    # ---- lookup / fill ---------------------------------------------------
    def _fresh(self, ent: dict, epoch_view: dict, routing_gen: int) -> bool:
        return (ent["routing_gen"] == routing_gen
                and ent["epoch_view"] == epoch_view)

    def get(self, key: tuple, epoch_view: dict, routing_gen: int):
        """The cached response dict, or None. A stale entry (routing or
        epoch drift) is never served FRESH; it lingers for
        ``stale_retention_s`` AFTER FIRST BEING OBSERVED STALE (so the
        shed path's bounded-staleness ``get_stale`` has something to
        serve — an entry that was fresh for minutes before an epoch bump
        still earns its full linger window) and is dropped past that."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if not self._fresh(ent, epoch_view, routing_gen):
                now = time.time()
                stale_since = ent.setdefault("stale_since", now)
                if now - stale_since > self.stale_retention_s:
                    self._drop(key)
                self.invalidations += 1
                self.misses += 1
                return None
            # fresh again (e.g. the recorded epoch view re-validated):
            # the entry is not on the stale clock anymore
            ent.pop("stale_since", None)
            self._entries.move_to_end(key)
            self.hits += 1
            # deep copy both ways (here and in put): callers that post-
            # process a response in place (sorting rows, appending a
            # footer) must not poison the stored entry for later hits
            return copy.deepcopy(ent["resp"])

    def get_stale(self, key: tuple, max_age_s: float):
        """Bounded-staleness read for the load-shedding degradation path:
        ``(response copy, age_s)`` when an entry exists no
        older than ``max_age_s`` — REGARDLESS of epoch/routing freshness
        (that's the contract: the client opted into ``maxStalenessMs``-
        bounded data rather than a 429) — else ``(None, None)``. No LRU
        touch: a shed query must not keep pinning the stale entry past
        entries that still validate fresh."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None, None
            age_s = max(0.0, time.time() - ent["ts"])
            if age_s > max(0.0, max_age_s):
                return None, None
            self.stale_hits += 1
            return copy.deepcopy(ent["resp"]), age_s

    def peek_fresh(self, key: tuple, epoch_view: dict,
                   routing_gen: int) -> bool:
        """EXPLAIN's view (CACHED_RESULT line): would this query serve
        from cache right now? No LRU touch, no counters."""
        with self._lock:
            ent = self._entries.get(key)
            return ent is not None and \
                self._fresh(ent, epoch_view, routing_gen)

    def put(self, key: tuple, resp: dict, epoch_view: dict,
            routing_gen: int) -> None:
        try:
            nbytes = len(json.dumps(resp, default=str))
        except (TypeError, ValueError):
            return  # unserializable response: not worth caching
        if nbytes > self.max_bytes:
            return  # one giant selection must not wipe the whole cache
        with self._lock:
            if key in self._entries:
                self._drop(key)
            self._entries[key] = {
                "resp": copy.deepcopy(resp), "nbytes": nbytes,
                "epoch_view": dict(epoch_view), "routing_gen": routing_gen,
                "ts": time.time(),
            }
            self.bytes += nbytes
            while (len(self._entries) > self.max_entries
                   or self.bytes > self.max_bytes):
                old_key = next(iter(self._entries))
                self._drop(old_key)
                self.evictions += 1

    def _drop(self, key: tuple) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.bytes -= ent["nbytes"]

    # ---- maintenance -----------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries), "bytes": self.bytes,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "stale_hits": self.stale_hits,
            }
