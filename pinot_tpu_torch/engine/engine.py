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
response, as every other error does. Multi-stage queries and EXPLAIN ANALYZE come with later slices;
EXPLAIN PLAN renders the plan (engine/explain.py).
"""

from __future__ import annotations

import dataclasses
import time

from pinot_tpu_torch.common.pruning import interval_may_match, \
    provably_absent
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.explain import explain_plan
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
                    raise DeviceUnsupported(
                        "EXPLAIN ANALYZE comes with a later slice of the "
                        "port (ROADMAP queue 1, item i)")
                return explain_plan(self, q)
            segments = self.tables.get(q.table_name)
            if not segments:
                raise KeyError(f"table {q.table_name!r} not found")
            q = expand_star(q, segments[0].column_names())
            merged = self.execute_segments(q, segments, terminal=True)
            result = finalize(q, merged)
        except Exception as e:  # noqa: BLE001 — exceptions are reported in-band
            return {"exceptions": [{"errorCode": 200,
                                    "message": f"{type(e).__name__}: {e}"}]}
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
            "totalDocs": stats.total_docs,
            "timeUsedMs": round((time.time() - t0) * 1000, 3),
        })
        return resp

    def execute_segments(self, q: QueryContext, segments,
                         terminal: bool = False,
                         trim_ok: bool = True) -> IntermediateResult:
        """Partial execution over an explicit segment list → the merged,
        unfinalized IntermediateResult (what a server ships to a broker).

        Per segment: the metadata-only answer, else a fitting star-tree
        (pruned cube segments drop, counted as pruned), else the device
        batch. ``terminal``: nothing merges after this result, so a sole
        partial may finalize sketches on the card. ``trim_ok = False``
        turns the on-device trim off for callers whose finalize runs
        under another QueryContext (the star-tree substitution)."""
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
        if remaining:
            # the device batch is the sole partial when nothing else
            # answered: only then may it finalize on the card or trim
            sole = not results
            reduce_mode = None
            if trim_ok and sole:
                reduce_mode = "terminal" if terminal else "partial"
            results.append(self.device.fetch(self.device.launch(
                launch_q, remaining, final=terminal and sole,
                reduce_mode=reduce_mode, alive=alive)))
        merged = merge_intermediates(q, results)
        merged.stats.num_segments_pruned += pruned
        merged.stats.num_segments_queried = len(segments)
        # pruned segments still count toward totalDocs (reference
        # semantics)
        ran = {id(s) for s in executed}
        merged.stats.total_docs += sum(s.n_docs for s in segments
                                       if id(s) not in ran)
        return merged
