"""Star-tree pre-aggregation index: a copy of pinot_tpu/storage/startree.py.

Reference (Apache Pinot's star-tree v2 index,
pinot-segment-spi/.../index/startree/StarTreeV2.java): sort by a dimension
split order, build an on-disk tree whose star-nodes pre-aggregate doc
ranges; queries traverse the tree level by level.

As in the JAX package, the index here is a **materialized aggregate
segment** (a cube): docs grouped by the full split-order dimension set,
with one pre-aggregated metric column per function-column pair
(``sum__revenue``, ``count__star``, ...), stored as a normal child
segment under ``<segment>/startree/st<i>/``. A fitting query
(engine/startree_exec.py) runs against the cube through the same device
pipeline, re-aggregating the pre-aggregated rows: filters and group-bys
on split dimensions stay exact because every split dimension is carried
through. Work drops from O(rows) to O(distinct dimension combinations).

The cube is built on the host in numpy at segment creation, with the
same value hashing, digests and serializations as the JAX package, so a
segment directory written by either package's creator loads in the
other's ``load_star_trees`` with the same columns, dtypes, encodings and
values.

If the cube has more groups than rows/2 the index is skipped
(pre-aggregation would not pay).
"""

from __future__ import annotations

import json
import os

import numpy as np

STARTREE_DIR = "startree"
META_FILE = "startree_meta.json"

# function-column pair name separator (reference: AggregationFunctionColumnPair)
SEP = "__"

SUPPORTED_FUNCTIONS = {"sum", "count", "min", "max", "distinctcounthll",
                       "percentiletdigest", "distinctcountbitmap",
                       "percentileest", "sumprecision"}


def parse_pair(pair: str):
    """'SUM__revenue' → ('sum', 'revenue'); 'COUNT__*' → ('count', '*')."""
    fn, col = pair.split(SEP, 1)
    return fn.lower(), col


def pair_column(fn: str, col: str) -> str:
    return f"{fn.lower()}{SEP}{'star' if col == '*' else col}"


def build_star_trees(segment, star_tree_configs) -> None:
    """Build all configured star-tree aggregate segments for a sealed
    segment (the creator's last step, after the base segment is
    written, as in the reference)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.engine.host import factorize_multi
    from pinot_tpu_torch.storage.creator import build_segment

    for i, cfg in enumerate(star_tree_configs):
        dims = list(cfg.dimensions_split_order)
        pairs = [parse_pair(p) for p in cfg.function_column_pairs]
        for fn, col in pairs:
            if fn not in SUPPORTED_FUNCTIONS:
                raise ValueError(f"star-tree function {fn} unsupported")

        dim_values = [np.asarray(segment.values(d)) for d in dims]
        keys, ginv = factorize_multi(dim_values)
        n_groups = len(keys[0])
        if n_groups > max(1, segment.n_docs // 2):
            continue  # cube nearly as big as the data: not worth it

        out_cols: dict = {d: k for d, k in zip(dims, keys)}
        dim_specs = []
        metric_specs = []
        for d in dims:
            meta = segment.column_metadata(d)
            dim_specs.append((d, meta.data_type))
        hll_log2m = None
        tdigest_compression = None
        percentileest_compression = None
        for fn, col in pairs:
            name = pair_column(fn, col)
            if fn == "count":
                acc = np.zeros(n_groups, dtype=np.int64)
                np.add.at(acc, ginv, 1)
                metric_specs.append((name, DataType.LONG))
            elif fn == "distinctcounthll":
                # sketch pre-aggregation (DistinctCountHLLValueAggregator):
                # one int8 register plane per cube row, stored as a
                # fixed-width BYTES metric; queries re-merge planes by max
                # through the HLLMERGE rewrite (engine/startree_exec.py).
                # Same value hashing as the scan path (ops/hll.registers_np)
                # so cube and scan estimates are bit-identical.
                from pinot_tpu_torch.ops import hll as hll_ops

                hll_log2m = hll_ops.DEFAULT_LOG2M
                regs = hll_ops.registers_np(
                    np.asarray(segment.values(col)), ginv, n_groups,
                    hll_log2m,
                )
                m = 1 << hll_log2m
                acc = np.ascontiguousarray(
                    regs.astype(np.uint8)).view(f"S{m}").reshape(n_groups)
                metric_specs.append((name, DataType.BYTES))
            elif fn == "distinctcountbitmap":
                # exact distinct-set pre-aggregation
                # (DistinctCountBitmapValueAggregator.java:1): one
                # serialized VALUE set per cube row (values, not dict ids —
                # planes in local id space could not merge across
                # segments), re-merged at query time by BITMAPMERGE
                from pinot_tpu_torch.engine.aggspec import set_to_bytes

                v = np.asarray(segment.values(col))
                per_group = [set() for _ in range(n_groups)]
                for g, x in zip(ginv.tolist(), v.tolist()):
                    per_group[g].add(x)
                blobs = [set_to_bytes(s) for s in per_group]
                width = max((len(b) for b in blobs), default=2)
                acc = np.asarray(
                    [b.ljust(width, b"\x00") for b in blobs],
                    dtype=f"S{width}")
                metric_specs.append((name, DataType.BYTES))
            elif fn == "sumprecision":
                # exact arbitrary-precision partial sums
                # (SumPrecisionValueAggregator.java:1): one decimal string
                # per cube row, re-summed by SUMPRECISIONMERGE
                from pinot_tpu_torch.engine.aggspec import SumPrecisionSpec

                v = np.asarray(segment.values(col))
                sums = [0] * n_groups
                for g, x in zip(ginv.tolist(), v.tolist()):
                    sums[g] = sums[g] + SumPrecisionSpec._exact(x)
                strs = [str(s).encode("ascii") for s in sums]
                width = max((len(s) for s in strs), default=1)
                acc = np.asarray(
                    [s.ljust(width, b"\x00") for s in strs], dtype=f"S{width}")
                metric_specs.append((name, DataType.BYTES))
            elif fn in ("percentiletdigest", "percentileest"):
                # digest pre-aggregation (PercentileTDigestValueAggregator):
                # one serialized t-digest per cube row, re-merged at query
                # time by TDIGESTMERGE. Pre-agg digests are approximate
                # like the reference's — cube and scan answers agree within
                # the digest's rank-error bound, not bit-exactly.
                from pinot_tpu_torch.ops import quantile_digest as qd

                if fn == "percentiletdigest":
                    tdigest_compression = float(cfg.tdigest_compression)
                    if tdigest_compression <= 0:
                        raise ValueError(
                            f"tdigest_compression must be > 0, got "
                            f"{cfg.tdigest_compression}")
                    compression = tdigest_compression
                else:
                    # PERCENTILEEST pair: the PERCENTILE/PERCENTILEEST
                    # family's default digest resolution
                    # (PercentileEstValueAggregator's QuantileDigest role)
                    percentileest_compression = float(qd.DEFAULT_COMPRESSION)
                    compression = percentileest_compression
                v = np.asarray(segment.values(col), dtype=np.float64)
                per_group = {}
                if len(v):
                    order = np.argsort(ginv, kind="stable")
                    gs = np.asarray(ginv)[order]
                    vs = v[order]
                    bounds = np.flatnonzero(np.diff(gs)) + 1
                    starts = np.concatenate([[0], bounds])
                    ends = np.concatenate([bounds, [len(gs)]])
                    for s, e in zip(starts, ends):
                        m, w = qd.add_values([], [], vs[s:e], compression)
                        per_group[int(gs[s])] = qd.digest_to_bytes(m, w)
                empty = qd.digest_to_bytes([], [])
                blobs = [per_group.get(g, empty) for g in range(n_groups)]
                width = max((len(b) for b in blobs), default=len(empty))
                acc = np.asarray(
                    [b.ljust(width, b"\x00") for b in blobs],
                    dtype=f"S{width}")
                metric_specs.append((name, DataType.BYTES))
            else:
                v = np.asarray(segment.values(col), dtype=np.float64)
                if fn == "sum":
                    acc = np.zeros(n_groups)
                    np.add.at(acc, ginv, v)
                elif fn == "min":
                    acc = np.full(n_groups, np.inf)
                    np.minimum.at(acc, ginv, v)
                else:
                    acc = np.full(n_groups, -np.inf)
                    np.maximum.at(acc, ginv, v)
                metric_specs.append((name, DataType.DOUBLE))
            out_cols[name] = acc

        st_schema = Schema.build(
            name=f"{segment.name}_st{i}",
            dimensions=dim_specs,
            metrics=metric_specs,
        )
        out_dir = os.path.join(segment.dir, STARTREE_DIR, f"st{i}")
        build_segment(
            st_schema, out_cols, out_dir,
            TableConfig(table_name=st_schema.name), f"{segment.name}_st{i}",
        )
        with open(os.path.join(out_dir, META_FILE), "w") as f:
            json.dump(
                {
                    "dimensions_split_order": dims,
                    "function_column_pairs": list(cfg.function_column_pairs),
                    "max_leaf_records": cfg.max_leaf_records,
                    "hll_log2m": hll_log2m,
                    "tdigest_compression": tdigest_compression,
                    "percentileest_compression": percentileest_compression,
                },
                f,
            )


def load_star_trees(segment) -> list:
    """[(metadata dict, ImmutableSegment)] for a sealed segment."""
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    root = os.path.join(segment.dir, STARTREE_DIR)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        meta_path = os.path.join(d, META_FILE)
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            out.append((meta, ImmutableSegment(d)))
    return out
