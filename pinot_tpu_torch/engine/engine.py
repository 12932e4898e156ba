"""Query engine entry point: SQL → Pinot-shaped response, over sealed
segments held in this process, executed on the card.

Counterpart of pinot_tpu/engine/engine.py for the single-stage path:
parse → compile → optimize → per-segment fast paths → device launches →
merge → finalize. The fast paths come first, as in the reference
(AggregationPlanNode.java:186-210): a segment answers COUNT(*) / MIN /
MAX with no filter and no group-by from its metadata, with no launch;
else a segment whose star-tree cube fits the query (engine/startree_exec.py)
joins the cubes of its tree signature, and each signature runs as ONE
device launch over all its cubes. The remaining segments run as one
device batch. ``SET useStarTree = false`` opts out of the cubes.

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
query traced and renders its actuals (engine/explain.py); multi-stage
queries come with a later slice.
"""

from __future__ import annotations

import dataclasses
import time

from pinot_tpu_torch.common.pruning import interval_may_match, \
    provably_absent
from pinot_tpu_torch.common.trace import Tracer, span
from pinot_tpu_torch.engine.device import DeviceExecutor, HostShapeRerun
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
from pinot_tpu_torch.sql.compiler import compile_select, is_multistage
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment


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


class QueryEngine:
    """SQL in, response out, over in-process tables on one device.

    ``device``: None → the CUDA card (raises when there is none); pass
    ``"cpu"`` to run the kernels' plain versions (the tests).
    ``host_name``: the server instance name ``$hostName`` reads on the
    segments added here (None: the machine's host name)."""

    def __init__(self, device=None, num_groups_limit: int = 100_000,
                 host_name: str | None = None):
        self.device = DeviceExecutor(device, num_groups_limit=num_groups_limit)
        self.pruner = SegmentPruner()
        self.tables: dict[str, list] = {}
        self.host_name = host_name

    def add_segment(self, table: str, seg: ImmutableSegment) -> None:
        if self.host_name is not None \
                and getattr(seg, "host_name", None) is None:
            seg.host_name = self.host_name
        self.tables.setdefault(table, []).append(seg)

    def execute(self, sql: str) -> dict:
        t0 = time.time()
        try:
            stmt = parse_sql(sql)
            if is_multistage(stmt):
                raise DeviceUnsupported(
                    "multi-stage queries come with a later slice of the port "
                    "(ROADMAP queue 1, item l)")
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
        segments = self.tables.get(q.table_name)
        if not segments:
            raise KeyError(f"table {q.table_name!r} not found")
        q = expand_star(q, segments[0].column_names())
        merged = self.execute_segments_async(q, segments, terminal=True,
                                             tracer=tracer)()
        return finalize(q, merged), merged

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
        (pruned cube segments drop, counted as pruned), else the device
        batch, launched here and fetched in the closure. ``terminal``:
        nothing merges after this result, so a sole partial may finalize
        sketches on the card. ``trim_ok = False`` turns the on-device trim
        off for callers whose finalize runs under another QueryContext
        (the star-tree substitution).

        ``deadline`` (common/deadline.py): checked before the blocking
        fetch and before a fetch-time re-run; an expired budget raises
        QueryTimeout and releases the pinned handle. ``tracer``
        (common/trace.py): carried by reference into the handle and the
        closure, so spans recorded on another thread land on this query's
        trace. ``fallback_gate`` (callable(fn) → fn()): wraps a fetch-time
        run in the host path's shape (a sorted table past its cap,
        numGroupsLimit under a trim), so a server can put it back under
        its admission control. A cold-tier placeholder (``is_cold``) is
        refused: the tiers come with the cluster tier."""
        if any(getattr(s, "is_cold", False) for s in segments):
            raise DeviceUnsupported(
                "cold-tier segments come with a later slice of the port "
                "(ROADMAP queue 1, item m)")
        results, executed, remaining, alive = [], [], [], []
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
            remaining.append(s)
            alive.append(not is_pruned)
            executed.append(s)
        launch_q = q
        if not results and not remaining and not st_groups:
            # every segment is a pruned cube segment: as the reference,
            # an empty partial from the first segment under a FALSE filter
            launch_q = dataclasses.replace(q, filter=FilterNode.FALSE)
            remaining, alive, executed = [segments[0]], [True], [segments[0]]
        # a lone star-tree group with nothing to merge against stays
        # terminal: its cube launch may finalize sketches on the card
        st_terminal = (terminal and not results and not remaining
                       and len(st_groups) == 1)
        for grp in st_groups.values():
            results.append(execute_star_tree_group(
                self, q, grp["meta"], grp["sts"], grp["docs"],
                terminal=st_terminal))
        handle = None
        if remaining:
            # the device batch is the sole partial when nothing else
            # answered: only then may it finalize on the card or trim
            sole = not results
            reduce_mode = None
            if trim_ok and sole:
                reduce_mode = "terminal" if terminal else "partial"
            handle = self.device.launch(
                launch_q, remaining, final=terminal and sole,
                reduce_mode=reduce_mode, alive=alive, tracer=tracer)
            handle.deadline = deadline

        def fetch():
            res = list(results)
            if handle is not None:
                try:
                    try:
                        res.append(handle.fetch())
                    except HostShapeRerun as r:
                        if deadline is not None:
                            deadline.check("host-path shape re-run")
                        res.append(r.rerun() if fallback_gate is None
                                   else fallback_gate(r.rerun))
                finally:
                    handle.release()  # a no-op once fetched
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
