"""The broker's query log, as far as the port has it: ``template_key``
(a copy of the function of pinot_tpu/broker/querylog.py), which keys the
plan advisor's memos (engine/advisor.py). The rotating JSONL log and its
ring buffer come with the broker.
"""

from __future__ import annotations


def template_key(q) -> str:
    """Literal-independent shape key for a compiled QueryContext — the
    same normalization that keeps device template/cohort keys stable
    under changing filter literals: table + result shape + agg
    names + group-by columns + filter STRUCTURE (ops and columns, no
    values). Two dashboard queries differing only in literals share a
    key, so the summarizer can aggregate latency per template.

    Multi-stage plans (query2/ joins + windows) key on the stage-2 shape
    PLUS the join chain (kind, strategy, build alias, key columns — no
    literals) and the window function/partition signature, so two-stage
    dashboard queries group per template exactly like single-stage ones."""
    try:
        if hasattr(q, "stage2") and hasattr(q, "joins"):
            inner = template_key(q.stage2)
            joins = ";".join(
                f"{j.kind}:{q.strategy}:{j.build.alias}"
                f"({','.join(str(k) for k in j.left_keys)})"
                for j in q.joins)
            wins = ",".join(
                f"{w.fn}[{','.join(str(p) for p in w.partition_by)}]"
                for w in q.windows)
            parts = [inner]
            if joins:
                parts.append(f"joins[{joins}]")
            if wins:
                parts.append(f"windows[{wins}]")
            return "|".join(parts)
        aggs = ",".join(a.name for a in q.aggregations())
        group = ",".join(g.name if g.is_identifier else "expr"
                         for g in (q.group_by or ()))
        shape = ("distinct" if q.distinct
                 else "group_by" if q.group_by
                 else "aggregation" if q.aggregations()
                 else "selection")

        def _filter_sig(f) -> str:
            if f is None:
                return ""
            from pinot_tpu_torch.query.context import FilterNodeType

            if f.type is FilterNodeType.PREDICATE:
                p = f.predicate
                col = p.lhs.name if p.lhs.is_identifier else "expr"
                return f"{p.type.name}({col})"
            kids = ",".join(_filter_sig(c) for c in (f.children or ()))
            return f"{f.type.name}[{kids}]"

        return f"{q.table_name}|{shape}|{aggs}|{group}|{_filter_sig(q.filter)}"
    except Exception:  # noqa: BLE001 — a log key must never fail a query
        return "unknown"
