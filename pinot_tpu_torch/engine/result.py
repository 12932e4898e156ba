"""Result containers: the DataTable / BrokerResponse analogs.

``IntermediateResult`` is the mergeable per-executor result (reference:
DataTable, pinot-core/.../common/datatable/) in *value space* — group keys
are actual values, aggregation states are canonical mergeable partials
(engine/aggspec.py). ``ResultTable`` is the final broker response payload
(reference: BrokerResponseNative's resultTable).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ExecutionStats:
    """Per-query execution statistics (ExecutionStatistics.java analog)."""

    num_docs_scanned: int = 0
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    num_segments_queried: int = 0
    num_segments_processed: int = 0
    num_segments_matched: int = 0
    num_segments_pruned: int = 0
    # zone-map blocks the device block-skip path never gathered
    # (engine/device.py; 0 when the dense path ran or pruning was off)
    num_blocks_pruned: int = 0
    # cold-tier segments (server/tiering.py) this execution
    # routed but could not scan: their planes live only in the deep
    # store, the touch scheduled an async hydration, and the result is
    # an honest in-flight partial (numSegmentsCold in responses)
    num_segments_cold: int = 0
    total_docs: int = 0
    time_used_ms: float = 0.0
    # per-query resource accounting (reference: DataTable V3 metadata
    # threadCpuTimeNs + scheduler wait) — filled by the server's scheduler
    thread_cpu_time_ns: int = 0
    scheduler_wait_ms: float = 0.0
    # groups dropped by numGroupsLimit: the result is plan-dependent
    # partial (reference numGroupsLimitReached response metadata)
    num_groups_limit_reached: bool = False
    # the device partials cache served this execution (engine/device.py):
    # no gather/dispatch/kernel ran — the fetch re-read a cached packed
    # buffer. Surfaces as partialsCacheHit in responses + the query log.
    partials_cache_hit: bool = False
    # load signal piggybacked on every server partial: the
    # answering server's scheduler pressure() and in-flight query depth
    # at fetch time. -1 = not a server partial. The broker reads these
    # PER INSTANCE before the reduce merges stats (max survives).
    server_pressure: int = -1
    server_inflight: int = -1
    # the answering server's freshness epoch for the queried table
    # (common/freshness.py): the broker result cache's staleness signal
    table_epoch: int = -1
    # kernel roofline accounting: modeled HBM bytes the device
    # pipeline moved (ColPlan-width column planes scaled by the block-skip
    # gather ratio, plus the trimmed fetch buffer) and the measured
    # kernel/link wall — achieved GB/s = bytes / kernel time, computed at
    # export against the per-process HBM peak (ops/roofline.py). Summed
    # across partials on merge; per-flight detail rides
    # IntermediateResult.roofline.
    device_bytes_moved: int = 0
    device_kernel_ms: float = 0.0
    device_link_ms: float = 0.0
    # distributed stage-2 exchange accounting (query2/exchange.py):
    # partitions/bytes this worker SHIPPED to peers
    # (self-offers to its own mailbox don't count), payloads its mailbox
    # spilled to the warm tier's spill dir, joined rows its stage-2
    # partials aggregated, and per-alias stage-1 leaf row counts. All
    # sum-merged; the broker surfaces them as numPartitionsShipped /
    # exchangeBytes / exchangeSpillCount response counters.
    exchange_partitions_shipped: int = 0
    exchange_bytes_shipped: int = 0
    exchange_spill_count: int = 0
    stage2_rows: int = 0
    leaf_rows: dict = dataclasses.field(default_factory=dict)
    # plan-advisor decision stamps (engine/advisor.py): one
    # "ADVISOR(<decision>: measured=X default=Y)" line per measurement-
    # driven override this execution ran with. Merged with order-
    # preserving dedup (partials of one query repeat the same stamps);
    # surfaced as advisorDecisions in responses, the query log, and
    # EXPLAIN ANALYZE.
    advisor_decisions: list = dataclasses.field(default_factory=list)

    def merge(self, other: "ExecutionStats") -> None:
        self.num_docs_scanned += other.num_docs_scanned
        self.num_entries_scanned_in_filter += other.num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter += other.num_entries_scanned_post_filter
        self.num_segments_queried += other.num_segments_queried
        self.num_segments_processed += other.num_segments_processed
        self.num_segments_matched += other.num_segments_matched
        self.num_segments_pruned += other.num_segments_pruned
        self.num_blocks_pruned += other.num_blocks_pruned
        self.num_segments_cold += other.num_segments_cold
        self.total_docs += other.total_docs
        self.thread_cpu_time_ns += other.thread_cpu_time_ns
        self.scheduler_wait_ms += other.scheduler_wait_ms
        self.num_groups_limit_reached |= other.num_groups_limit_reached
        self.partials_cache_hit |= other.partials_cache_hit
        self.server_pressure = max(self.server_pressure,
                                   other.server_pressure)
        self.server_inflight = max(self.server_inflight,
                                   other.server_inflight)
        self.table_epoch = max(self.table_epoch, other.table_epoch)
        self.device_bytes_moved += other.device_bytes_moved
        self.device_kernel_ms += other.device_kernel_ms
        self.device_link_ms += other.device_link_ms
        self.exchange_partitions_shipped += other.exchange_partitions_shipped
        self.exchange_bytes_shipped += other.exchange_bytes_shipped
        self.exchange_spill_count += other.exchange_spill_count
        self.stage2_rows += other.stage2_rows
        for alias, rows in (other.leaf_rows or {}).items():
            self.leaf_rows[alias] = self.leaf_rows.get(alias, 0) + int(rows)
        for line in (other.advisor_decisions or []):
            if line not in self.advisor_decisions:
                self.advisor_decisions.append(line)


@dataclasses.dataclass
class IntermediateResult:
    """Mergeable executor output. Exactly one of the shapes is populated:

    - aggregation:      ``agg_partials`` (list, one per aggregation)
    - group-by:         ``group_keys`` (tuple of value arrays, one per
                        group-by expr) + ``agg_partials`` (per-group arrays)
    - selection:        ``rows`` (dict col->np array of selected docs)
    - distinct:         ``group_keys`` only
    """

    shape: str  # "aggregation" | "group_by" | "selection" | "distinct"
    agg_partials: Optional[list] = None
    group_keys: Optional[tuple] = None
    rows: Optional[dict] = None
    stats: ExecutionStats = dataclasses.field(default_factory=ExecutionStats)
    trace: Optional[list] = None  # phase spans when SET trace = true
    # per-flight roofline records: one dict per device launch
    # this partial folded in ({kernel, bytesMoved, kernelMs, linkMs,
    # gbps, peakGbps, pctOfPeak, cacheHit}) — concatenated across
    # partials, shipped in DataTable metadata like ``trace``
    roofline: Optional[list] = None


@dataclasses.dataclass
class ResultTable:
    column_names: list
    column_types: list  # DataType names (strings)
    rows: list  # list of tuples of python values

    def to_json(self) -> dict:
        return {
            "resultTable": {
                "dataSchema": {
                    "columnNames": self.column_names,
                    "columnDataTypes": self.column_types,
                },
                "rows": [list(r) for r in self.rows],
            }
        }


def py_value(v):
    """numpy scalar → python value for the JSON layer. MV cells (per-doc
    arrays) become JSON lists, the reference's MV response shape."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v
