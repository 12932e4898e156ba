"""Partial-upsert mergers: combine an incoming row with the previous
version of its primary key (a copy of pinot_tpu/realtime/merger.py for
the port).

Equivalent of the reference's ``upsert/merger/`` package
(pinot-segment-local/.../upsert/merger/PartialUpsertHandler.java and the
per-strategy mergers OverwriteMerger/IgnoreMerger/IncrementMerger/
AppendMerger/UnionMerger/MaxMerger/MinMerger): each non-key column gets a
merge strategy; unlisted columns default to OVERWRITE. Primary-key columns
and the comparison column are never merged — the reference excludes them
the same way.

The merged row is what gets indexed, so sealed segments durably hold merged
values and restart replay (manager._reconcile_committed) reconstructs the
same state with no special casing.
"""

from __future__ import annotations

import numpy as np


def _as_list(v) -> list:
    if isinstance(v, (list, tuple, np.ndarray)):
        return list(v)
    return [v]


def _overwrite(prev, new):
    return new


def _ignore(prev, new):
    return prev


def _increment(prev, new):
    return prev + new


def _append(prev, new):
    return _as_list(prev) + _as_list(new)


def _union(prev, new):
    out = _as_list(prev)
    seen = set(out)
    for v in _as_list(new):
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def _max(prev, new):
    return max(prev, new)


def _min(prev, new):
    return min(prev, new)


STRATEGIES = {
    "OVERWRITE": _overwrite,
    "IGNORE": _ignore,
    "INCREMENT": _increment,
    "APPEND": _append,
    "UNION": _union,
    "MAX": _max,
    "MIN": _min,
}


class PartialUpsertMerger:
    """Merges the previous version of a row into the incoming one."""

    def __init__(self, schema, upsert_config):
        strategies = dict(upsert_config.partial_upsert_strategies)
        unknown = set(strategies.values()) - set(STRATEGIES)
        if unknown:
            raise ValueError(f"unknown partial-upsert strategies: {sorted(unknown)}")
        protected = set(schema.primary_key_columns)
        if upsert_config.comparison_column:
            protected.add(upsert_config.comparison_column)
        bad = protected & set(strategies)
        if bad:
            raise ValueError(
                f"partial-upsert strategies not allowed on key/comparison "
                f"columns: {sorted(bad)}")
        self._mergers = {
            col: STRATEGIES[strategies.get(col, "OVERWRITE")]
            for col in schema.column_names()
            if col not in protected
        }

    def merge(self, prev_row: dict, new_row: dict) -> dict:
        out = dict(new_row)
        for col, fn in self._mergers.items():
            prev_val = prev_row.get(col)
            new_val = new_row.get(col)
            if new_val is None:
                # absent or explicit null: previous value carries over
                # (the reference's mergers keep the previous value when the
                # incoming one is null)
                out[col] = prev_val
            elif prev_val is None:
                # previous value was null: take the incoming value unmerged
                out[col] = new_val
            else:
                out[col] = fn(prev_val, new_val)
        return out


def read_row(segment, doc_id: int, columns) -> dict:
    """Previous-version read: one row's values out of the segment currently
    holding the key (mutable in the common case). Null columns come back as
    None so merge() can distinguish them from default-fill values."""
    out = {}
    for col in columns:
        out[col] = segment.row_value(col, doc_id)
    return out
