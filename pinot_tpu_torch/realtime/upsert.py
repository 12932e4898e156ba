"""Upsert metadata: primary-key → latest-record tracking + validDocIds
(a copy of pinot_tpu/realtime/upsert.py for the port).

Equivalent of the reference's ``PartitionUpsertMetadataManager``
(pinot-segment-local/.../upsert/PartitionUpsertMetadataManager.java:67-117):
a per-partition map primaryKey → RecordLocation with compare-and-swap on the
comparison column; losers get their doc flipped out of the segment's
validDocIds bitmap. Queries AND validDocIds into the filter
(FilterPlanNode.java:94-100 analog — engine/rows.py ANDs the snapshot
the launch uploads).

Restart recovery: ``add_segment`` rebuilds the map from sealed segments in
commit order, exactly like the reference re-adds segments on server start.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class RecordLocation:
    segment: object  # Mutable/ImmutableSegment with invalidate()/valid mask
    doc_id: int
    comparison_value: object


import numpy as np


def _invalidate(segment, doc_id: int) -> None:
    if hasattr(segment, "invalidate"):
        segment.invalidate(doc_id)
        return
    # sealed segment: flip the in-memory valid mask, materializing it on
    # first use (segments freshly loaded from disk start with mask=None ==
    # all-valid; the mask is rebuilt from the upsert map on restart)
    mask = getattr(segment, "valid_docs_mask", None)
    if mask is None:
        mask = np.ones(segment.n_docs, dtype=bool)
        segment.valid_docs_mask = mask
    mask[doc_id] = False


class PartitionUpsertMetadataManager:
    def __init__(self, comparison_column: Optional[str] = None):
        self.comparison_column = comparison_column
        self._map: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._map)

    def get_location(self, key: tuple) -> Optional[RecordLocation]:
        """Current winner for a key (partial-upsert previous-version read).
        Safe under the single-consumer-per-partition writer contract."""
        with self._lock:
            return self._map.get(key)

    def add_record(self, segment, doc_id: int, key: tuple, comparison_value) -> bool:
        """CAS semantics (reference :102-117): the record with the greater
        comparison value wins; ties go to the newer record."""
        with self._lock:
            loc = self._map.get(key)
            if loc is None or comparison_value >= loc.comparison_value:
                if loc is not None:
                    _invalidate(loc.segment, loc.doc_id)
                self._map[key] = RecordLocation(segment, doc_id, comparison_value)
                return True
            _invalidate(segment, doc_id)
            return False

    def add_segment(self, segment, keys, comparison_values) -> None:
        """Bulk (re)register a sealed segment's rows (restart rebuild)."""
        for doc_id, (k, c) in enumerate(zip(keys, comparison_values)):
            self.add_record(segment, doc_id, tuple(k), c)

    def replace_segment(self, old_segment, new_segment) -> None:
        """Consuming → sealed handoff: doc ids are preserved (no compaction
        at commit, matching the reference), so locations just re-point."""
        with self._lock:
            for loc in self._map.values():
                if loc.segment is old_segment:
                    loc.segment = new_segment
