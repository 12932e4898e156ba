"""Config recommender + table tuner (controller long-tail).

Reference analogs:
- recommender (pinot-controller/.../recommender/RecommenderDriver.java):
  workload description (schema + sample queries + QPS) → suggested
  indexing config, via per-rule engines (inverted/sorted/bloom/no-dict);
- tuner (pinot-controller/.../tuner/TableConfigTuner.java): adjust an
  EXISTING table's config from observed segment metadata.

Both produce an IndexingConfig delta + human-readable rationale; the
tuner can apply its suggestion through the registry (the reference's
recommender is advisory too — it returns config, users apply it).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from pinot_tpu_torch.common.table_config import IndexingConfig
from pinot_tpu_torch.query.context import FilterNodeType, PredicateType


def _walk_predicates(f, out):
    if f is None:
        return
    if f.type is FilterNodeType.PREDICATE:
        out.append(f.predicate)
        return
    for c in f.children or ():
        _walk_predicates(c, out)


def recommend_config(schema, sample_queries, qps: float = 100.0) -> dict:
    """Workload-driven indexing recommendation (RecommenderDriver role).

    Rules (each mirrors a reference rule engine):
    - EQ/IN-filtered dimensions → inverted index; the most-filtered one →
      sorted-column candidate (the reference's FlagQueryRuleParams +
      InvertedSortedIndexJointRule);
    - RANGE-filtered columns → range index (RangeIndexRule);
    - high-selectivity EQ columns → bloom filter (BloomFilterRule);
    - repeated GROUP BY shape with SUM/COUNT/MIN/MAX/DISTINCTCOUNTHLL →
      star-tree config (the aggregate-metrics rule);
    - LIKE/REGEXP-filtered dimensions → fst (trigram) index.
    """
    from pinot_tpu_torch.sql.compiler import compile_query

    eq_cols: Counter = Counter()
    range_cols: Counter = Counter()
    regex_cols: Counter = Counter()
    groupby_shapes: Counter = Counter()
    st_pairs: dict = {}
    for sql in sample_queries:
        try:
            q = compile_query(sql)
        except Exception:  # noqa: BLE001 — advisory: skip unparsable input
            continue
        preds = []
        _walk_predicates(q.filter, preds)
        for p in preds:
            if not p.lhs.is_identifier:
                continue
            col = p.lhs.name
            if p.type in (PredicateType.EQ, PredicateType.IN,
                          PredicateType.NOT_EQ, PredicateType.NOT_IN):
                eq_cols[col] += 1
            elif p.type is PredicateType.RANGE:
                range_cols[col] += 1
            elif p.type in (PredicateType.LIKE, PredicateType.REGEXP_LIKE):
                regex_cols[col] += 1
        if q.group_by and all(g.is_identifier for g in q.group_by):
            dims = tuple(sorted(g.name for g in q.group_by))
            aggs = q.aggregations()
            if aggs and all(a.name in ("count", "sum", "min", "max", "avg",
                                       "distinctcounthll") for a in aggs):
                groupby_shapes[dims] += 1
                pairs = st_pairs.setdefault(dims, set())
                for a in aggs:
                    if a.name == "count":
                        pairs.add("COUNT__*")
                    elif a.name == "avg":
                        if a.args and a.args[0].is_identifier:
                            pairs.add(f"SUM__{a.args[0].name}")
                            pairs.add("COUNT__*")
                    elif a.args and a.args[0].is_identifier:
                        pairs.add(f"{a.name.upper()}__{a.args[0].name}")

    from pinot_tpu_torch.common.datatypes import FieldRole

    dim_names = {n for n, s in schema.fields.items()
                 if s.role is not FieldRole.METRIC}
    inverted = [c for c, _ in eq_cols.most_common() if c in dim_names]
    sorted_candidate = inverted[0] if inverted else None
    rationale = []
    if inverted:
        rationale.append(
            f"inverted index on {inverted}: EQ/IN filters seen "
            f"{dict(eq_cols)} times")
    if sorted_candidate:
        rationale.append(
            f"sort segments on {sorted_candidate!r}: most-filtered "
            f"dimension (binary-search doc runs beat bitmaps)")
    rng = [c for c in range_cols if range_cols[c] >= 2]
    if rng:
        rationale.append(f"range index on {rng}: repeated range filters")
    bloom = [c for c in eq_cols if eq_cols[c] >= 2]
    fst = list(regex_cols)
    if fst:
        rationale.append(f"fst (trigram) index on {fst}: LIKE/REGEXP filters")
    star_tree_configs = []
    for dims, count in groupby_shapes.most_common(1):
        if count >= 2 and qps >= 10:
            from pinot_tpu_torch.common.table_config import StarTreeIndexConfig

            star_tree_configs.append(StarTreeIndexConfig(
                dimensions_split_order=list(dims),
                function_column_pairs=sorted(st_pairs[dims]),
            ))
            rationale.append(
                f"star-tree over {list(dims)}: group-by shape repeated "
                f"{count}x at {qps} QPS")
    return {
        "indexing": IndexingConfig(
            inverted_index_columns=inverted,
            range_index_columns=rng,
            bloom_filter_columns=bloom,
            fst_index_columns=fst,
            star_tree_configs=star_tree_configs,
        ),
        "sorted_column": sorted_candidate,
        "rationale": rationale,
    }


def tune_table(registry, table: str, segments) -> dict:
    """Observed-metadata tuner (TableConfigTuner role): inspect hosted
    segments' column stats and grow the table's IndexingConfig; returns
    {indexing, changes} and writes the updated config back when anything
    changed."""
    cfg = registry.table_config(table)
    if cfg is None:
        raise KeyError(f"table {table!r} not found")
    idx = cfg.indexing
    changes = []
    bloom = set(idx.bloom_filter_columns)
    inverted = set(idx.inverted_index_columns)
    if segments:
        seg = segments[0]
        n = max(1, seg.n_docs)
        for col in seg.column_names():
            meta = seg.column_metadata(col)
            card = meta.cardinality or 0
            if not meta.single_value:
                continue
            # high-selectivity point-lookup columns: bloom pays
            if card > 0.5 * n and col not in bloom and meta.has_dictionary:
                bloom.add(col)
                changes.append(
                    f"bloom on {col!r} (cardinality {card} ~ docs {n})")
            # low-card dimensions: inverted postings are tiny and beat scans
            if 1 < card <= 1000 and col not in inverted \
                    and meta.has_dictionary and not meta.is_sorted:
                inverted.add(col)
                changes.append(
                    f"inverted on {col!r} (cardinality {card})")
    new_idx = dataclasses.replace(
        idx,
        bloom_filter_columns=sorted(bloom),
        inverted_index_columns=sorted(inverted),
    )
    if changes:
        new_cfg = dataclasses.replace(cfg, indexing=new_idx)
        registry.set_table_config(table, new_cfg)
    return {"indexing": new_idx, "changes": changes}
