"""Query engine entry point: SQL → Pinot-shaped response, over the
segments of tables held in this process (sealed, consuming and
upsert-masked), executed on the card.

Counterpart of pinot_tpu/engine/engine.py for the single-stage path:
parse → compile → optimize → per-segment fast paths → device launches →
merge → finalize. The fast paths come first, as in the reference
(AggregationPlanNode.java:186-210): a segment answers COUNT(*) / MIN /
MAX with no filter and no group-by from its metadata, with no launch;
else a segment whose star-tree cube fits the query (engine/startree_exec.py)
joins the cubes of its tree signature, and each signature runs as ONE
device launch over all its cubes. The remaining sealed segments run as
one device batch, a consuming segment's clean chunklets as another, and
its tail, dirty chunklets and the upsert-masked segments each alone in
the host path's shape with a valid-docs plane (``execute_segments_async``).
``SET useStarTree = false`` opts out of the cubes. Each table is a
``TableDataManager``: a query acquires its segments and releases them
when it ends, so an unload meanwhile waits for it.

Segments that ``SegmentPruner`` proves empty from their metadata stay in
the device batch, dead (Level 1; a pruned cube segment is dropped and
counted as pruned); the device skips zone-map blocks inside the rest
(Level 2, ops/blockskip.py). When the device batch is the sole partial
of the query it runs the on-device top-K trim (ops/device_reduce.py)
unless ``SET useDeviceReduce = false``, and a terminal one finalizes its
sketches on the card. There is no host scan: the shapes the reference
answers on its host, at launch or after its fetch, run in that path's
shape on the card (engine/rows.py), and a query shape the port does not
run comes back as an in-band ``DeviceUnsupported`` exception in the
response, as every other error does.

``execute_segments_async`` is the launch phase: everything up to the
device launch (engine/device.py ``DeviceExecutor.launch``, which returns
an ``InflightLaunch`` handle), then a zero-argument fetch closure that
waits for the device, merges and returns the partial. It carries the
query's ``Deadline`` (checked before each blocking fetch and each
fetch-time re-run) and ``Tracer`` (the phases ``gather``, ``dispatch``,
``device_fetch``, ``kernel``, ``link`` and ``merge``) by reference, and
releases every still-pinned handle when anything between launch and
fetch raises. EXPLAIN PLAN renders the plan and EXPLAIN ANALYZE runs the
query traced and renders its actuals (engine/explain.py). Join and window
queries run through the multi-stage engine (query2/runner.py), and
``LOOKUP`` reads a dimension table through ``dim_table_lookup``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

from pinot_tpu_torch.common.pruning import interval_may_match, \
    provably_absent
from pinot_tpu_torch.common.trace import Tracer, span
from pinot_tpu_torch.engine.device import (
    DeviceExecutor,
    HostShapeRerun,
    segment_device_eligible,
)
from pinot_tpu_torch.engine.explain import annotate_analyze, explain_plan
from pinot_tpu_torch.engine.params import DeviceUnsupported
from pinot_tpu_torch.engine.reduce import finalize, merge_intermediates
from pinot_tpu_torch.engine.result import IntermediateResult
from pinot_tpu_torch.engine.startree_exec import (
    execute_star_tree_group,
    fitting_tree,
    try_metadata_only,
)
from pinot_tpu_torch.query.context import (
    FilterNode,
    FilterNodeType,
    PredicateType,
    QueryContext,
)
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.query.rewrite import expand_star
from pinot_tpu_torch.realtime.chunklet import split_for_query
from pinot_tpu_torch.sql.compiler import compile_select, is_multistage
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment

log = logging.getLogger("pinot_tpu_torch.engine")


class SegmentPruner:
    """Server-side pruning on column metadata min/max + bloom filters
    (query/pruner/ColumnValueSegmentPruner.java analog; a copy of the
    reference's engine.SegmentPruner). The device executor evaluates it
    per segment at launch: a pruned segment stays in the batch, dead."""

    def prune(self, q: QueryContext, seg: ImmutableSegment) -> bool:
        """True → segment cannot match; skip it."""
        f = q.filter
        if f is None:
            return False
        return self._cannot_match(f, seg)

    def _cannot_match(self, f: FilterNode, seg: ImmutableSegment) -> bool:
        if f.type is FilterNodeType.CONSTANT_FALSE:
            return True
        if f.type is FilterNodeType.AND:
            return any(self._cannot_match(c, seg) for c in f.children)
        if f.type is FilterNodeType.OR:
            return all(self._cannot_match(c, seg) for c in f.children)
        if f.type is not FilterNodeType.PREDICATE:
            return False
        p = f.predicate
        if not p.lhs.is_identifier or p.lhs.name not in seg.metadata.columns:
            return False
        meta = seg.column_metadata(p.lhs.name)
        # min/max interval exclusion, strict about incomparable literals,
        # so a mis-typed literal surfaces from the scan instead of
        # silently pruning to empty
        if p.type in (PredicateType.EQ, PredicateType.IN,
                      PredicateType.RANGE):
            if not interval_may_match(p, meta.min_value, meta.max_value):
                return True
        if p.type is PredicateType.EQ and \
                provably_absent(seg, p.lhs.name, [p.value]):
            return True
        if p.type is PredicateType.IN and p.values and \
                provably_absent(seg, p.lhs.name, list(p.values)):
            return True
        return False


class TableDataManager:
    """Segments of one table (a copy of the reference's
    engine.TableDataManager, the data/manager OfflineTableDataManager
    analog): acquire / release refcounts, so an unload during an
    in-flight query defers its teardown until the last reference drops
    (``on_unload`` fires then); ``replace_if_idle`` swaps a segment only
    when no query holds it; ``generation`` counts adds and removes. A
    segment added under a name already held replaces it (a consuming
    segment's commit swaps in its sealed one)."""

    def __init__(self, name: str, host_name: Optional[str] = None):
        self.name = name
        self.segments: dict = {}
        self._refs: dict[str, int] = {}
        self._doomed: dict = {}
        self._lock = threading.Lock()
        self.on_unload = None  # callback(segment) after the last ref drops
        self.host_name = host_name  # stamps $hostName on hosted segments
        self.generation = 0  # bumped on add / remove; LOOKUP's cache key
        # None = unknown (an embedded engine allows LOOKUP on any local
        # table); a server sets True / False from the table's config
        self.is_dim_table = None

    def add_segment(self, seg) -> None:
        if self.host_name is not None \
                and getattr(seg, "host_name", None) is None:
            seg.host_name = self.host_name
        with self._lock:
            self.segments[seg.name] = seg
            self.generation += 1
            self._doomed.pop(seg.name, None)  # a re-add wins over an unload

    def replace_if_idle(self, name: str, seg) -> bool:
        """Swap the hosted object for ``name`` when NO query holds it; a
        held reference refuses the swap (False: the caller retries). The
        doomed map is untouched: a swap is not an unload."""
        with self._lock:
            if name not in self.segments or self._refs.get(name, 0) > 0:
                return False
            if self.host_name is not None \
                    and getattr(seg, "host_name", None) is None:
                seg.host_name = self.host_name
            self.segments[name] = seg
            self.generation += 1
            return True

    def remove_segment(self, name: str) -> None:
        with self._lock:
            seg = self.segments.pop(name, None)
            if seg is None:
                return
            self.generation += 1
            if self._refs.get(name, 0) > 0:
                self._doomed[name] = seg  # teardown deferred to release()
                return
            self._refs.pop(name, None)
        self._fire_unload(seg)

    def acquire(self) -> list:
        with self._lock:
            segs = list(self.segments.values())
            for s in segs:
                self._refs[s.name] = self._refs.get(s.name, 0) + 1
            return segs

    def release(self, segments) -> None:
        to_unload = []
        with self._lock:
            for s in segments:
                left = self._refs.get(s.name, 1) - 1
                if left > 0:
                    self._refs[s.name] = left
                    continue
                self._refs.pop(s.name, None)
                doomed = self._doomed.pop(s.name, None)
                if doomed is not None:
                    to_unload.append(doomed)
        for seg in to_unload:
            self._fire_unload(seg)

    def _fire_unload(self, seg) -> None:
        if self.on_unload is not None:
            try:
                self.on_unload(seg)
            except Exception:  # noqa: BLE001 — unload cleanup is best-effort
                log.exception("segment unload callback failed for %s",
                              seg.name)


class QueryEngine:
    """SQL in, response out, over in-process tables on one device.

    ``device``: None → the CUDA card (raises when there is none); pass
    ``"cpu"`` to run the kernels' plain versions (the tests).
    ``host_name``: the server instance name ``$hostName`` reads on the
    segments added here (None: the machine's host name).
    ``device_executor``: an executor to run on instead, as the
    reference's (e.g. ``DeviceExecutor(mesh=make_mesh(8))``, the segment
    axis sharded over a mesh)."""

    def __init__(self, device=None, num_groups_limit: int = 100_000,
                 host_name: str | None = None, device_executor=None):
        self.device = device_executor if device_executor is not None \
            else DeviceExecutor(device, num_groups_limit=num_groups_limit)
        self.pruner = SegmentPruner()
        self.tables: dict[str, TableDataManager] = {}
        self.host_name = host_name
        self._dim_cache: dict = {}  # (table, pk, value) -> (generation, map)
        self.device.lookup_resolver = self.dim_table_lookup

    def table(self, name: str) -> TableDataManager:
        if name not in self.tables:
            self.tables[name] = TableDataManager(name,
                                                 host_name=self.host_name)
        return self.tables[name]

    def add_segment(self, table: str, seg) -> None:
        self.table(table).add_segment(seg)

    def execute(self, sql: str) -> dict:
        t0 = time.time()
        try:
            stmt = parse_sql(sql)
            if is_multistage(stmt):
                from pinot_tpu_torch.query2.runner import execute_multistage

                return execute_multistage(self, stmt, t0)
            q = optimize_query(compile_select(stmt))
            if q.explain:
                if q.analyze:
                    return self._explain_analyze(q, t0)
                return explain_plan(self, q)
            result, merged = self._execute_merged(q)
        except Exception as e:  # noqa: BLE001 — exceptions are reported in-band
            return {"exceptions": [{"errorCode": 200,
                                    "message": f"{type(e).__name__}: {e}"}]}
        return self._stats_response(result, merged, t0)

    @staticmethod
    def _stats_response(result, merged, t0: float) -> dict:
        """The response of a finalized result and its merged partial (the
        one execute and EXPLAIN ANALYZE share)."""
        stats = merged.stats
        resp = result.to_json()
        resp.update({
            "exceptions": [],
            "numDocsScanned": stats.num_docs_scanned,
            "numEntriesScannedInFilter": stats.num_entries_scanned_in_filter,
            "numEntriesScannedPostFilter":
                stats.num_entries_scanned_post_filter,
            "numSegmentsQueried": stats.num_segments_queried,
            "numSegmentsProcessed": stats.num_segments_processed,
            "numSegmentsMatched": stats.num_segments_matched,
            "numSegmentsPrunedByServer": stats.num_segments_pruned,
            "numBlocksPruned": stats.num_blocks_pruned,
            # cold-tier segments that answered as in-flight partials
            "numSegmentsCold": stats.num_segments_cold,
            "numGroupsLimitReached": stats.num_groups_limit_reached,
            "partialsCacheHit": stats.partials_cache_hit,
            "totalDocs": stats.total_docs,
            # roofline accounting: modeled bytes, kernel and link time
            "deviceBytesMoved": stats.device_bytes_moved,
            "deviceKernelMs": round(stats.device_kernel_ms, 3),
            "deviceLinkMs": round(stats.device_link_ms, 3),
            "timeUsedMs": round((time.time() - t0) * 1000, 3),
        })
        if getattr(merged, "roofline", None):
            resp["roofline"] = merged.roofline
        return resp

    def execute_query(self, q: QueryContext, tracer=None):
        """(finalized ResultTable, merged stats) of a compiled query."""
        result, merged = self._execute_merged(q, tracer=tracer)
        return result, merged.stats

    def _execute_merged(self, q: QueryContext, tracer=None):
        """(finalized ResultTable, merged IntermediateResult): the inner
        execute path, which keeps the merged partial's stats, trace and
        roofline records for callers that render more than rows."""
        tdm = self.tables.get(q.table_name)
        if tdm is None:
            raise KeyError(f"table {q.table_name!r} not found")
        segments = tdm.acquire()
        try:
            if not segments:
                raise ValueError(f"table {q.table_name!r} has no segments")
            q = expand_star(q, segments[0].column_names())
            merged = self.execute_segments_async(q, segments, terminal=True,
                                                 tracer=tracer)()
            return finalize(q, merged), merged
        finally:
            tdm.release(segments)

    def execute_segments(self, q: QueryContext, segments,
                         terminal: bool = False,
                         trim_ok: bool = True) -> IntermediateResult:
        """Partial execution over an explicit segment list → the merged,
        unfinalized IntermediateResult (what a server ships to a broker).
        ``execute_segments_async(...)()``."""
        return self.execute_segments_async(q, segments, terminal,
                                           trim_ok=trim_ok)()

    def execute_segments_async(self, q: QueryContext, segments,
                               terminal: bool = False, fallback_gate=None,
                               deadline=None, tracer=None,
                               trim_ok: bool = True):
        """LAUNCH phase of ``execute_segments`` → a zero-argument fetch
        closure returning the merged, unfinalized IntermediateResult.

        Per segment: the metadata-only answer, else a fitting star-tree
        (pruned cube segments drop, counted as pruned), else the scan. The
        scan splits as the reference's does (engine/device.py
        ``segment_device_eligible``): sealed segments without a valid-docs
        mask form ONE device batch (pruned ones stay in it, dead); a
        consuming segment whose chunklet path applies
        (realtime/chunklet.py ``split_for_query``) gives its clean
        chunklets, which form a batch of their own (promotion changes the
        chunklet set every 64k rows, and one key for both would evict and
        re-upload the stable sealed planes), and its host parts: the
        unfrozen tail and the upsert-dirtied chunklets. A host part, a
        consuming segment the split does not apply to and an upsert-masked
        sealed segment each launch alone, in the reference host path's
        shape on the card, with a valid-docs plane
        (``DeviceExecutor.launch_host_part``). A pruned segment the device
        batch cannot take drops, counted as pruned. Everything is launched
        here and fetched in the closure. ``terminal``: nothing merges
        after this result, so a sole device batch may finalize sketches
        on the card. ``trim_ok = False`` turns the on-device trim off for
        callers whose finalize runs under another QueryContext (the
        star-tree substitution).

        ``deadline`` (common/deadline.py): checked before each host-part
        launch, the blocking fetches and a fetch-time re-run; an expired
        budget raises QueryTimeout and releases the pinned handles.
        ``tracer`` (common/trace.py): carried by reference into the
        handles and the closure, so spans recorded on another thread land
        on this query's trace. ``fallback_gate`` (callable(fn) → fn()):
        wraps a fetch-time run in the host path's shape (a sorted table
        past its cap, numGroupsLimit under a trim), so a server can put it
        back under its admission control. A cold-tier placeholder
        (``is_cold``) is refused: the tiers come with the cluster tier."""
        if any(getattr(s, "is_cold", False) for s in segments):
            raise DeviceUnsupported(
                "cold-tier segments come with a later slice of the port "
                "(ROADMAP queue 1, item m)")
        results, executed, scan = [], [], []
        scan_pruned: set = set()  # id(s) of batch segments the pruner excluded
        st_groups: dict = {}
        pruned = 0
        for s in segments:
            is_pruned = self.pruner.prune(q, s)
            if not is_pruned:
                r = try_metadata_only(q, s)
                if r is not None:
                    results.append(r)
                    executed.append(s)
                    continue
            hit = fitting_tree(q, s)
            if hit is not None:
                if is_pruned:
                    pruned += 1
                    continue
                sig, meta, st_seg = hit
                grp = st_groups.setdefault(sig, {"meta": meta, "sts": [],
                                                 "docs": 0})
                grp["sts"].append(st_seg)
                grp["docs"] += s.n_docs
                executed.append(s)
                continue
            if is_pruned:
                # a sealed segment stays in the device batch, dead, so the
                # batch key does not depend on which literals pruned what;
                # the others drop here
                if not segment_device_eligible(s):
                    pruned += 1
                    continue
                scan_pruned.add(id(s))
            scan.append(s)
            executed.append(s)
        plan, dropped = self._scan_plan(q, scan, scan_pruned)
        if dropped:
            pruned += len(dropped)
            executed = [s for s in executed if id(s) not in dropped]
        launch_q = q
        if not plan and not results and not st_groups:
            # every segment pruned where it cannot stay in a batch: as the
            # reference, an empty partial of the whole first segment under
            # a FALSE filter
            launch_q = dataclasses.replace(q, filter=FilterNode.FALSE)
            executed = [segments[0]]
            plan = [("batch", [segments[0]], [True], False)
                    if segment_device_eligible(segments[0])
                    else ("part", segments[0])]
        # a lone star-tree group with nothing to merge against stays
        # terminal: its cube launch may finalize sketches on the card
        st_terminal = terminal and not results and not plan \
            and len(st_groups) == 1
        for grp in st_groups.values():
            results.append(execute_star_tree_group(
                self, q, grp["meta"], grp["sts"], grp["docs"],
                terminal=st_terminal))
        # a device batch is the sole partial when nothing else answers:
        # only then may it finalize on the card or trim
        sole = not results and len(plan) == 1 and plan[0][0] == "batch"
        reduce_mode = None
        if trim_ok and sole:
            reduce_mode = "terminal" if terminal else "partial"
        handles = []
        try:
            for step in plan:
                if step[0] == "batch":
                    # the sealed batch takes the pruner's verdicts computed
                    # above; the chunklets their own, per chunklet (the
                    # consuming segment was pruned as a whole)
                    _, g, alive, host = step
                    h = self.device.launch(
                        launch_q, g, final=terminal and sole,
                        reduce_mode=reduce_mode, alive=alive, tracer=tracer,
                        host=host)
                else:
                    if deadline is not None:
                        deadline.check("host-path shape launch")
                    h = self.device.launch_host_part(launch_q, step[1],
                                                     tracer=tracer)
                h.deadline = deadline
                handles.append(h)
        except BaseException:
            for h in handles:
                h.release()
            raise

        def fetch():
            res = list(results)
            try:
                for h in handles:
                    try:
                        res.append(h.fetch())
                    except HostShapeRerun as r:
                        if deadline is not None:
                            deadline.check("host-path shape re-run")
                        res.append(r.rerun() if fallback_gate is None
                                   else fallback_gate(r.rerun))
            finally:
                for h in handles:
                    h.release()  # a no-op once fetched
            with span("merge", tracer):
                merged = merge_intermediates(q, res)
            # the per-flight roofline records, across partials
            roofs = [rec for r in res if getattr(r, "roofline", None)
                     for rec in r.roofline]
            if roofs:
                merged.roofline = roofs
            merged.stats.num_segments_pruned += pruned
            merged.stats.num_segments_queried = len(segments)
            # pruned segments still count toward totalDocs (reference
            # semantics)
            ran = {id(s) for s in executed}
            merged.stats.total_docs += sum(s.n_docs for s in segments
                                           if id(s) not in ran)
            return merged

        return fetch

    def _scan_plan(self, q: QueryContext, scan, scan_pruned) -> tuple:
        """The scan's launches in merge order, each ("batch", segments,
        alive verdicts or None, host path's shape forced) or ("part",
        segment), and the ids of segments dropped as pruned.

        Sealed segments form one batch (with the pruner's verdicts), a
        consuming segment's clean chunklets another (verdicts of their
        own), and the host parts follow. Where the reference's device
        refuses the query over a batch, its engine runs the whole scan on
        its host, segment by segment, a consuming segment unsplit: the
        sealed segments then run in the host path's shape, in runs of
        consecutive ones so the merge keeps the segments' order, and a
        run the pruner excluded whole drops, as the reference drops each
        of its segments."""
        sealed, chunklets, host_parts = [], [], []
        for s in scan:
            if segment_device_eligible(s):
                sealed.append(s)
                continue
            split = split_for_query(s)
            if split is None:
                host_parts.append(s)
            else:
                chunklets.extend(split[0])
                host_parts.extend(split[1])
        batches = [g for g in (sealed, chunklets) if g]
        if len(batches) + len(host_parts) <= 1 or not any(
                self.device.refuses(q, g) for g in batches):
            plan = [("batch", g, [id(s) not in scan_pruned for s in g]
                     if g is sealed else None, False) for g in batches]
            return plan + [("part", s) for s in host_parts], set()
        plan, run, dropped = [], [], set()
        for s in scan + [None]:
            if s is not None and segment_device_eligible(s):
                run.append(s)
                continue
            if run and all(id(r) in scan_pruned for r in run):
                dropped |= {id(r) for r in run}
            elif run:
                plan.append(("batch", run,
                             [id(r) not in scan_pruned for r in run], True))
            run = []
            if s is not None:
                plan.append(("part", s))
        return plan, dropped

    def dim_table_lookup(self, dim_table: str, value_col: str, pk_col: str):
        """(pk value → value_col value, miss default) over every hosted
        segment of a dimension table (a copy of the reference's, the
        DimensionTableDataManager analog), cached until the table's
        segment set changes. The miss default is the value column's TYPE
        default, so an empty table keeps numeric semantics."""
        tdm = self.tables.get(dim_table) \
            or self.tables.get(f"{dim_table}_OFFLINE")
        if tdm is None:
            raise KeyError(f"dimension table {dim_table!r} not hosted here")
        if getattr(tdm, "is_dim_table", None) is False:
            # a regular table's segments spread across servers: a local pk
            # map would be silently incomplete
            raise ValueError(f"LOOKUP target {dim_table!r} is not a "
                             f"dimension table (is_dim_table=false)")
        key = (tdm.name, pk_col, value_col)
        cached = self._dim_cache.get(key)
        if cached is not None and cached[0] == tdm.generation:
            return cached[1], cached[2]
        import numpy as np

        gen = tdm.generation
        mapping: dict = {}
        segs = tdm.acquire()
        try:
            if not segs:
                raise KeyError(f"dimension table {dim_table!r} has no "
                               f"segments loaded here")
            dt = segs[0].column_metadata(value_col).data_type
            default = "" if dt.is_string_like else dt.np_dtype.type(0).item()
            for seg in segs:
                pks = np.asarray(seg.values(pk_col))
                vals = np.asarray(seg.values(value_col))
                for k, v in zip(pks.tolist(), vals.tolist()):
                    mapping[k] = v
        finally:
            tdm.release(segs)
        self._dim_cache[key] = (gen, mapping, default)
        return mapping, default

    def _explain_analyze(self, q: QueryContext, t0: float) -> dict:
        """EXPLAIN ANALYZE: run the query for real, traced and with the
        partials cache bypassed (a hit would skip the kernel ANALYZE
        measures), then render the plan annotated with the actuals. The
        executed response rides along as ``analyzedResponse``."""
        q_run = dataclasses.replace(
            q, explain=False, analyze=False,
            options=q.options + (("usePartialsCache", False),))
        tracer = Tracer("analyze")
        result, merged = self._execute_merged(q_run, tracer=tracer)
        resp = self._stats_response(result, merged, t0)
        resp["traceInfo"] = {"server": tracer.to_json()}
        out = annotate_analyze(explain_plan(self, q), resp)
        out["analyzedResponse"] = resp
        return out
