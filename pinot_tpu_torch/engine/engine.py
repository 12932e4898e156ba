"""Query engine entry point: SQL → Pinot-shaped response, over sealed
segments held in this process, executed on the card.

Counterpart of pinot_tpu/engine/engine.py for the single-stage path:
parse → compile → optimize → ONE device launch over the table's sealed
segments (engine/device.py) → merge → finalize. There is no host scan:
a query shape this slice does not run on the device comes back as an
in-band ``DeviceUnsupported`` exception in the response, as every other
error does. Multi-stage queries, EXPLAIN, star-tree substitution and the
metadata-only fast path come with later slices; ``SET useStarTree`` is
accepted and has no effect.
"""

from __future__ import annotations

import time

from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.params import DeviceUnsupported
from pinot_tpu_torch.engine.reduce import finalize, merge_intermediates
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.query.rewrite import expand_star
from pinot_tpu_torch.sql.compiler import compile_select, is_multistage
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment


class QueryEngine:
    """SQL in, response out, over in-process tables on one device.

    ``device``: None → the CUDA card (raises when there is none); pass
    ``"cpu"`` to run the kernels' plain versions (the tests)."""

    def __init__(self, device=None, num_groups_limit: int = 100_000):
        self.device = DeviceExecutor(device, num_groups_limit=num_groups_limit)
        self.tables: dict[str, list] = {}

    def add_segment(self, table: str, seg: ImmutableSegment) -> None:
        self.tables.setdefault(table, []).append(seg)

    def execute(self, sql: str) -> dict:
        t0 = time.time()
        try:
            stmt = parse_sql(sql)
            if is_multistage(stmt):
                raise DeviceUnsupported(
                    "multi-stage queries come with a later slice of the port")
            q = optimize_query(compile_select(stmt))
            if q.explain:
                raise DeviceUnsupported(
                    "EXPLAIN comes with a later slice of the port")
            segments = self.tables.get(q.table_name)
            if not segments:
                raise KeyError(f"table {q.table_name!r} not found")
            q = expand_star(q, segments[0].column_names())
            merged = merge_intermediates(q, [self.device.execute(q, segments)])
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
            "numGroupsLimitReached": stats.num_groups_limit_reached,
            "totalDocs": stats.total_docs,
            "timeUsedMs": round((time.time() - t0) * 1000, 3),
        })
        return resp
