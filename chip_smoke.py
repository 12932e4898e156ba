#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # the full run: 8 x 12.5M rows
    python3 chip_smoke.py --rows 400000        # a quick rehearsal

Phases, all on ``cuda:0``:

1. the card's name and power limit; the kernels built from
   ``pinot_tpu_torch/csrc/`` (one ``nvcc`` per source, started together),
   with each kernel's registers, shared memory and spills from
   ``-Xptxas -v``.
2. The SSB lineorder table is generated from seed 7 with bench.py's
   columns and distributions; it and a copy stably sorted by
   ``lo_orderdate`` (``lineorder_by_date``: Pinot's sorted-column layout
   for time-ordered ingestion) are written by the port's creator in
   worker processes, while the GPU holds each kernel against its plain
   PyTorch version at the main paths' shapes: K1 group plane sums from
   the stored planes at q1's, q5's, q4_no_hll's, a wide float and the
   sorted HLL build's shapes through both entries (integer planes
   bit-exact, float planes within rtol 1e-6), K2 group min/max
   (bit-exact), K3 HLL register max from the hash plane at 1024, 35,840
   and 2^20 slots (bit-exact) and K4 fused filter + gather + aggregate
   at the full candidate bound (bit-exact). CUDA-event times of the
   kernel, of the torch ops it absorbed (K1's channel build, K3's hash
   split), of its plain version and of one library call computing the
   same function (``index_add_`` / ``scatter_reduce_``; for K4, which no
   single call computes, the port's generic gathered form), beside the
   memory bound.
3. Both tables are loaded into one ``QueryEngine(device="cuda")``; K4 is
   held against its plain version once more at the block-skip path's
   own candidates, and three paths run: the six SSB scan/filter/group-by
   queries, the five HLL and DISTINCTCOUNT queries, and the six
   block-skip queries on the sorted table. Every answer is checked
   against a numpy oracle over the generated columns (HLL estimates from
   registers the oracle builds itself; for the block-skip path also the
   pruned segments, pruned blocks and entries scanned, from per-segment
   and per-block min/max, and the ``SET useBlockSkip = false`` twin's
   answer), and the per-query p50 of 5 runs printed. The launch counts,
   per kernel and per entry, are zeroed just before each path and read
   just after; every kernel and entry of the path must have launched.
   Then the cost block-skip eligibility adds to the unsorted table's
   filtered queries (the zone verdict and one scalar read before the
   dense form): p50 with and without ``SET useBlockSkip = false``.
4. A ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result line, without a CUDA card, outside a
checkout of the repository, or when any phase fails. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "_smoke_data")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM 32-bit rate outside the tensor cores

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDEAST"])
NATIONS = np.array([f"nation_{i:02d}" for i in range(25)])
IN_SUPP = (11, 234, 567, 890, 1203, 1456, 1789)

QUERIES = {
    "q1_scan_agg": (
        "SET useStarTree = false; "
        "SELECT lo_suppkey, SUM(lo_revenue) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) DESC LIMIT 10"),
    "q2_range_sum": (
        "SELECT SUM(lo_revenue) FROM lineorder WHERE "
        "lo_orderdate BETWEEN 19930101 AND 19931231 "
        "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"),
    "q3_in_range": (
        "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE "
        "lo_suppkey IN (11, 234, 567, 890, 1203, 1456, 1789) "
        "AND lo_discount BETWEEN 4 AND 6"),
    "q4_no_hll": (
        "SELECT lo_suppkey, COUNT(*), AVG(lo_quantity) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10"),
    "q5_scan": (
        "SET useStarTree = false; "
        "SELECT d_year, c_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "q6_minmax": (
        "SELECT d_year, s_nation, MIN(lo_revenue), MAX(lo_revenue), "
        "MINMAXRANGE(lo_quantity), COUNT(*) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year, s_nation "
        "ORDER BY d_year, s_nation LIMIT 200"),
}

Q4_HLL = ("SELECT lo_suppkey, COUNT(*), AVG(lo_quantity), "
          "DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
          "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10")
HLL_QUERIES = {
    # bench.py's q4 scan forms: the cached sorted projection, then a
    # per-query sort (chunked dedup) with the projection turned off
    "q4_scan_hll": "SET useStarTree = false; " + Q4_HLL,
    "q4_scan_hll_cold": ("SET useStarTree = false; "
                         "SET useSortedProjection = false; " + Q4_HLL),
    "hll_scalar": (
        "SELECT COUNT(*), DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3"),
    "hll_small_group": (
        "SELECT d_year, c_region, DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "distinct_count": (
        "SELECT d_year, DISTINCTCOUNT(lo_suppkey) FROM lineorder "
        "WHERE lo_quantity < 10 GROUP BY d_year ORDER BY d_year"),
}
LOG2M = 10  # DISTINCTCOUNTHLL's default register count 2^10

# the block-skip path: the same rows stably sorted by lo_orderdate
BS_TABLE = "lineorder_by_date"
BS_QUERIES = {
    "bs_month_fused": (
        "SELECT COUNT(*), SUM(lo_quantity), MIN(lo_revenue), MAX(lo_revenue) "
        f"FROM {BS_TABLE} WHERE lo_orderdate BETWEEN 19930301 AND 19930328"),
    "bs_q12_shape": (
        "SELECT COUNT(*), SUM(lo_quantity), MAX(lo_revenue) "
        f"FROM {BS_TABLE} WHERE lo_orderdate BETWEEN 19940101 AND 19940128 "
        "AND lo_discount BETWEEN 4 AND 6 AND lo_quantity BETWEEN 26 AND 35"),
    "bs_or_in_not": (
        f"SELECT COUNT(*), MIN(lo_revenue) FROM {BS_TABLE} WHERE "
        "(lo_orderdate BETWEEN 19950601 AND 19950607 "
        "OR lo_orderdate IN (19970102, 19970215)) AND NOT lo_discount = 0"),
    "bs_sum_revenue": (
        f"SELECT COUNT(*), SUM(lo_revenue) FROM {BS_TABLE} "
        "WHERE lo_orderdate BETWEEN 19930301 AND 19930328"),
    "bs_group_month": (
        f"SELECT lo_discount, COUNT(*), SUM(lo_quantity) FROM {BS_TABLE} "
        "WHERE lo_orderdate BETWEEN 19960101 AND 19960228 "
        "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"),
    "bs_year_overflow": QUERIES["q2_range_sum"].replace(
        "FROM lineorder", f"FROM {BS_TABLE}"),
}
# the same filters as interval trees for the oracle: ("range", col, lo,
# hi) inclusive, ("in", col, values), ("and" | "or", ...), ("not", x)
BS_FILTERS = {
    "bs_month_fused": ("range", "lo_orderdate", 19930301, 19930328),
    "bs_q12_shape": ("and", ("range", "lo_orderdate", 19940101, 19940128),
                     ("range", "lo_discount", 4, 6),
                     ("range", "lo_quantity", 26, 35)),
    "bs_or_in_not": ("and", ("or",
                             ("range", "lo_orderdate", 19950601, 19950607),
                             ("in", "lo_orderdate", (19970102, 19970215))),
                     ("not", ("in", "lo_discount", (0,)))),
    "bs_sum_revenue": ("range", "lo_orderdate", 19930301, 19930328),
    "bs_group_month": ("range", "lo_orderdate", 19960101, 19960228),
    "bs_year_overflow": ("and", ("range", "lo_orderdate", 19930101, 19931231),
                         ("range", "lo_discount", 1, 3),
                         ("range", "lo_quantity", -2**31, 24)),
}
# the unsorted table's filtered queries, which are block-skip eligible and
# overflow the candidate bound: their cost against SET useBlockSkip=false
OVERFLOW_QUERIES = ("q2_range_sum", "q3_in_range", "q6_minmax",
                    "hll_scalar", "distinct_count")

# kernels each path must launch, and the entries (the TPU kernels they
# replace: pinot_tpu's Pallas rows) each path must reach
PATHS = {
    "ssb": (QUERIES, ("group_plane_sums", "group_minmax"),
            ((3, "group_scatter", "plane_group_sums"),
             (4, "group_scatter", "group_minmax"))),
    "hll": (HLL_QUERIES, ("group_plane_sums", "hll_register_max"),
            ((1, "groupby_mm", "group_sums"),
             (2, "groupby_mm", "hll_registers"),
             (5, "group_scatter", "hll_register_max"))),
    "blockskip": (BS_QUERIES, ("fused_filter_agg", "group_plane_sums"),
                  ((6, "group_scatter", "fused_filter_agg"),
                   (3, "group_scatter", "plane_group_sums"))),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data: bench.py's SSB lineorder generator (seed 7), region and nation kept
# as their drawn indexes until a segment is written
# ---------------------------------------------------------------------------


def generate(segments: int, rows: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(segments):
        n = rows
        out.append({
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "c_region": rng.integers(0, 5, n).astype(np.int8),
            "s_nation": rng.integers(0, 25, n).astype(np.int8),
            "lo_suppkey": rng.integers(0, 2000, n).astype(np.int32),
            "lo_custkey": rng.integers(0, 100_000, n).astype(np.int32),
            "lo_orderdate": (
                19920101
                + (rng.integers(0, 7, n) * 10000)
                + (rng.integers(0, 12, n) * 100)
                + rng.integers(0, 28, n)
            ).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int32),
        })
    return out


def sort_by_date(data: list) -> list:
    """The same rows stably sorted by lo_orderdate, cut into as many
    segments of the same sizes."""
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    order = np.argsort(c["lo_orderdate"], kind="stable")
    c = {k: v[order] for k, v in c.items()}
    cuts = np.cumsum([len(d["lo_orderdate"]) for d in data])[:-1]
    return [dict(zip(c, parts))
            for parts in zip(*(np.split(v, cuts) for v in c.values()))]


def write_segment(i: int, seg: dict, table: str = "lineorder") -> str:
    """Writes segment ``s<i>`` of ``table`` with the port's creator (run
    in a worker process)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.storage.creator import build_segment

    schema = Schema.build(
        name="lineorder",
        dimensions=[
            ("d_year", DataType.INT), ("c_region", DataType.STRING),
            ("s_nation", DataType.STRING), ("lo_suppkey", DataType.INT),
            ("lo_custkey", DataType.INT), ("lo_orderdate", DataType.INT),
            ("lo_discount", DataType.INT),
        ],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT)])
    cols = dict(seg)
    cols["c_region"] = REGIONS[cols["c_region"]]
    cols["s_nation"] = NATIONS[cols["s_nation"]]
    out = os.path.join(DATA_DIR, table, f"s{i}")
    build_segment(schema, cols, out, TableConfig(table_name=table), f"s{i}")
    return out


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


def fmix32(keys: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer over the int32 bits of ``keys``."""
    h = keys.astype(np.int32).view(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def hll_idx_rho(h: np.ndarray, log2m: int):
    """Register index (top bits) and rank (leading zeros of the rest + 1,
    capped by a sentinel bit), rank exact from the float64 exponent."""
    idx = (h >> np.uint32(32 - log2m)).astype(np.int64)
    w = ((h.astype(np.uint64) << np.uint64(log2m)) & np.uint64(0xFFFFFFFF)) \
        | np.uint64(1 << (log2m - 1))
    _, e = np.frexp(w.astype(np.float64))
    return idx, (33 - e).astype(np.int8)


def hll_estimates(idx, rho, gid, num_groups: int, log2m: int) -> np.ndarray:
    """(G,) HLL estimates over rows with gid >= 0: registers by rank in
    ascending order (a later, larger rank overwrites), then the standard
    estimate with the small- and large-range corrections."""
    m = 1 << log2m
    keep = gid >= 0
    slot = gid[keep].astype(np.int64) * m + idx[keep]
    r = rho[keep]
    regs = np.zeros(num_groups * m, np.int8)
    for k in range(1, 34 - log2m):
        regs[slot[r == k]] = k
    regs = regs.reshape(num_groups, m)
    alpha = 0.7213 / (1 + 1.079 / m)
    raw = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)), axis=1)
    zeros = np.sum(regs == 0, axis=1)
    small = (raw <= 2.5 * m) & (zeros > 0)
    lin = m * np.log(m / np.maximum(zeros, 1))
    big = raw > (1 << 32) / 30.0
    large = -float(1 << 32) * np.log(1.0 - raw / float(1 << 32))
    est = np.where(small, lin, np.where(big, large, raw))
    return np.round(est).astype(np.int64)


def oracle(data: list) -> dict:
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    year, region, nation = c["d_year"], c["c_region"], c["s_nation"]
    supp, od, disc = c["lo_suppkey"], c["lo_orderdate"], c["lo_discount"]
    qty, rev = c["lo_quantity"], c["lo_revenue"].astype(np.int64)
    want = {}

    s = np.bincount(supp, weights=rev, minlength=2000)  # exact: < 2^53
    top = sorted(range(2000), key=lambda k: (-s[k], k))[:10]
    want["q1_scan_agg"] = ([[k, float(s[k])] for k in top], len(supp))

    m = (od >= 19930101) & (od <= 19931231) & (disc >= 1) & (disc <= 3) \
        & (qty < 25)
    want["q2_range_sum"] = ([[float(rev[m].sum())]], int(m.sum()))

    m = np.isin(supp, IN_SUPP) & (disc >= 4) & (disc <= 6)
    want["q3_in_range"] = ([[int(m.sum()), float(rev[m].sum())]],
                           int(m.sum()))

    cnt = np.bincount(supp, minlength=2000)
    qs = np.bincount(supp, weights=qty.astype(np.int64), minlength=2000)
    top = sorted((k for k in range(2000) if cnt[k]),
                 key=lambda k: (-cnt[k], k))[:10]
    want["q4_no_hll"] = ([[k, int(cnt[k]), float(qs[k]) / float(cnt[k])]
                          for k in top], len(supp))

    g = (year - 1992).astype(np.int64) * 5 + region
    cnt = np.bincount(g, minlength=35)
    rs = np.bincount(g, weights=rev, minlength=35)
    want["q5_scan"] = ([[1992 + k // 5, str(REGIONS[k % 5]), float(rs[k]),
                         int(cnt[k])] for k in range(35) if cnt[k]],
                       len(supp))

    m = (disc >= 1) & (disc <= 3)
    g = (year[m] - 1992).astype(np.int64) * 25 + nation[m]
    r, q = rev[m], qty[m].astype(np.int64)
    cnt = np.bincount(g, minlength=175)
    rmin = np.full(175, np.iinfo(np.int64).max)
    rmax = np.full(175, np.iinfo(np.int64).min)
    qmin, qmax = rmin.copy(), rmax.copy()
    np.minimum.at(rmin, g, r)
    np.maximum.at(rmax, g, r)
    np.minimum.at(qmin, g, q)
    np.maximum.at(qmax, g, q)
    want["q6_minmax"] = ([[1992 + k // 25, str(NATIONS[k % 25]),
                           float(rmin[k]), float(rmax[k]),
                           float(qmax[k] - qmin[k]), int(cnt[k])]
                          for k in range(175) if cnt[k]], int(m.sum()))

    idx, rho = hll_idx_rho(fmix32(c["lo_custkey"]), LOG2M)
    est = hll_estimates(idx, rho, supp, 2000, LOG2M)
    q4 = [row + [int(est[row[0]])] for row in want["q4_no_hll"][0]]
    want["q4_scan_hll"] = want["q4_scan_hll_cold"] = (q4, len(supp))

    m = (disc >= 1) & (disc <= 3)
    est = hll_estimates(idx, rho, np.where(m, 0, -1), 1, LOG2M)
    want["hll_scalar"] = ([[int(m.sum()), int(est[0])]], int(m.sum()))

    g = (year - 1992).astype(np.int64) * 5 + region
    cnt = np.bincount(g, minlength=35)
    est = hll_estimates(idx, rho, g, 35, LOG2M)
    want["hll_small_group"] = ([[1992 + k // 5, str(REGIONS[k % 5]),
                                 int(est[k])] for k in range(35) if cnt[k]],
                               len(supp))

    m = qty < 10
    pairs = np.unique((year[m] - 1992).astype(np.int64) * 2000 + supp[m])
    dc = np.bincount(pairs // 2000, minlength=7)
    want["distinct_count"] = ([[1992 + y, int(dc[y])] for y in range(7)
                               if dc[y]], int(m.sum()))
    return want


def _rows_mask(tree, c) -> np.ndarray:
    kind = tree[0]
    if kind == "range":
        v = c[tree[1]]
        return (v >= tree[2]) & (v <= tree[3])
    if kind == "in":
        return np.isin(c[tree[1]], tree[2])
    if kind == "not":
        return ~_rows_mask(tree[1], c)
    ms = [_rows_mask(t, c) for t in tree[1:]]
    return np.logical_and.reduce(ms) if kind == "and" \
        else np.logical_or.reduce(ms)


def _may_match(tree, lo: dict, hi: dict) -> np.ndarray:
    """May an interval [lo, hi] per column hold a matching row: AND all,
    OR any, NOT always (the segment pruner's and the zone verdict's
    algebra)."""
    kind = tree[0]
    if kind == "range":
        return (hi[tree[1]] >= tree[2]) & (lo[tree[1]] <= tree[3])
    if kind == "in":
        return np.logical_or.reduce([(lo[tree[1]] <= v) & (hi[tree[1]] >= v)
                                     for v in tree[2]])
    if kind == "not":
        return np.ones(next(iter(lo.values())).shape, dtype=bool)
    ms = [_may_match(t, lo, hi) for t in tree[1:]]
    return np.logical_and.reduce(ms) if kind == "and" \
        else np.logical_or.reduce(ms)


def _tree_columns(tree) -> set:
    if tree[0] in ("range", "in"):
        return {tree[1]}
    return set().union(*(_tree_columns(t) for t in tree[1:]))


def bs_oracle(data: list, pad_to: int) -> dict:
    """The block-skip path's answers from the sorted columns, with the
    stats the engine must report: segments pruned from per-segment
    min/max, and blocks pruned and entries scanned from per-4096-row-block
    min/max under the candidate bound (none pruned past it)."""
    R, frac = 4096, 16
    sizes = [len(d["lo_orderdate"]) for d in data]
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    cols = ("lo_orderdate", "lo_discount", "lo_quantity")
    seg_lo = {k: np.array([d[k].min() for d in data]) for k in cols}
    seg_hi = {k: np.array([d[k].max() for d in data]) for k in cols}
    starts = [np.arange(0, n, R) for n in sizes]
    blk_lo = {k: np.concatenate([np.minimum.reduceat(d[k], st)
                                 for d, st in zip(data, starts)]) for k in cols}
    blk_hi = {k: np.concatenate([np.maximum.reduceat(d[k], st)
                                 for d, st in zip(data, starts)]) for k in cols}
    blk_seg = np.concatenate([np.full(len(st), i) for i, st in
                              enumerate(starts)])
    blk_rows = np.concatenate([np.minimum(R, n - st)
                               for n, st in zip(sizes, starts)])
    total = len(data) * (pad_to // R)
    bound = min(total, max(1, -(-total // frac)))
    qty, rev = c["lo_quantity"].astype(np.int64), \
        c["lo_revenue"].astype(np.int64)
    want = {}
    for name, tree in BS_FILTERS.items():
        m = _rows_mask(tree, c)
        alive = _may_match(tree, seg_lo, seg_hi)
        cand = _may_match(tree, blk_lo, blk_hi) & alive[blk_seg]
        blocks_total = int(alive[blk_seg].sum())
        if cand.sum() > bound:  # overflow: the dense form over alive rows
            scanned, rows = blocks_total, int(blk_rows[alive[blk_seg]].sum())
        else:
            scanned, rows = int(cand.sum()), int(blk_rows[cand].sum())
        stats = {"numSegmentsPrunedByServer": int((~alive).sum()),
                 "numBlocksPruned": blocks_total - scanned,
                 "numEntriesScannedInFilter": rows * len(_tree_columns(tree))}
        n = int(m.sum())
        if name == "bs_group_month":
            d = c["lo_discount"][m]
            cnt = np.bincount(d, minlength=11)
            qs = np.bincount(d, weights=qty[m], minlength=11)
            out = [[k, int(cnt[k]), float(qs[k])] for k in range(11) if cnt[k]]
        elif name == "bs_year_overflow":
            out = [[float(rev[m].sum())]]
        elif name == "bs_sum_revenue":
            out = [[n, float(rev[m].sum())]]
        elif name == "bs_or_in_not":
            out = [[n, float(rev[m].min())]]
        elif name == "bs_q12_shape":
            out = [[n, float(qty[m].sum()), float(rev[m].max())]]
        else:
            out = [[n, float(qty[m].sum()), float(rev[m].min()),
                    float(rev[m].max())]]
        want[name] = (out, n, stats)
    return want


def rows_equal(got, want) -> bool:
    """Strings and integers exactly; every number here is an integer
    below 2^53 except AVG, which both sides divide the same exact sum and
    count for, so 1e-12 relative separates any integer difference."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, str):
                if x != y:
                    return False
            elif abs(float(x) - float(y)) > 1e-12 * max(1.0, abs(float(y))):
                return False
    return True


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _k1_shapes(n: int, dev) -> list:
    """K1's main-path shapes, as (label, entry, G, sources, count, ids):
    q1 and q5 (SUM of the stored i32 lo_revenue plane, query offset
    1000, three byte planes, with the count), q4_no_hll (AVG of the
    stored u8 lo_quantity plane, offset 1, one byte plane), the wide
    float shape (G = 6240: an f32 source and an i32 source of two byte
    planes) and the sorted HLL build's three bf16 power-of-two channels
    through the single-accumulator entry. Ids include the overflow id
    G."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops.kernels import PlaneSource

    gen = torch.Generator(device=dev).manual_seed(11)

    def ids(G):
        return torch.randint(0, G + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)

    def off(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    rev = torch.randint(1000, 6_000_000, (n,), generator=gen,
                        dtype=torch.int32, device=dev)
    qty = torch.randint(1, 51, (n,), generator=gen, dtype=torch.int32,
                        device=dev).to(torch.uint8)
    fv = torch.rand((n,), generator=gen, device=dev) * 8
    iv = torch.randint(0, 65536, (n,), generator=gen, dtype=torch.int32,
                       device=dev)
    end = torch.rand((n,), generator=gen, device=dev) < 0.05
    pw = torch.exp2(torch.randint(0, 12, (n,), generator=gen,
                                  device=dev).float())
    lo = torch.rand((n,), generator=gen, device=dev) < 0.5
    hll_ch = [end.to(torch.bfloat16),
              torch.where(end & lo, pw, 0.0).to(torch.bfloat16),
              torch.where(end & ~lo, pw, 0.0).to(torch.bfloat16)]
    del end, pw, lo
    rev_src = PlaneSource(rev, "int", 3, minus=off(1000))
    return [
        ("q1: G=2000, i32 lo_revenue, 3 byte planes + count",
         ps.plane_group_sums, 2000, [rev_src], True, ids(2000)),
        ("q5: G=35, i32 lo_revenue, 3 byte planes + count",
         ps.plane_group_sums, 35, [rev_src], True, ids(35)),
        ("q4_no_hll: G=2000, u8 lo_quantity, 1 byte plane + count",
         ps.plane_group_sums, 2000,
         [PlaneSource(qty, "int", 1, minus=off(1))], True, ids(2000)),
        ("wide: G=6240, f32 (3 float planes) + i32 (2 byte planes) + count",
         ps.plane_group_sums, 6240,
         [PlaneSource(fv, "float"), PlaneSource(iv, "int", 2, minus=off(0))],
         True, ids(6240)),
        ("sorted HLL: G=2000, 3 bf16 power-of-two channels (single "
         "accumulator entry)", mm.group_sums, 2000,
         [PlaneSource(c, "bf16") for c in hll_ch], False, ids(2000)),
    ]


def absorbed_channels(sources, count: bool):
    """The (A, n) bf16 channel tensor the port built before K1 split the
    values itself, by the same torch ops: decode, ``int_planes`` /
    ``float_planes``, one copy per plane. Timed beside K1 as the passes
    it absorbed."""
    import torch
    from pinot_tpu_torch.ops import kernels

    n = sources[0].values.numel()
    rows = int(count) + sum(s.nplanes for s in sources)
    ch = torch.empty((rows, n), dtype=torch.bfloat16,
                     device=sources[0].values.device)
    r = 0
    if count:
        ch[0].fill_(1)
        r = 1
    for s in sources:
        for p in kernels.source_channels(s):
            ch[r].copy_(p)
            r += 1
    return ch


def check_split_dtypes(dev, n: int = 1_000_003) -> None:
    """Every stored dtype K1 reads (u8, u16, u32, i8, i16, i32, i64, with
    an int32 or int64 FOR offset and a negative query offset, both ends of
    the dtype's range) and K3 with group ids and a mask together, at a
    row count that leaves a ragged last quad: bit-exact against the plain
    versions. The main-path shapes above use only i32, u8, f32 and bf16."""
    import torch
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.kernels import PlaneSource

    gen = torch.Generator(device=dev).manual_seed(29)
    G = 300
    gid = torch.randint(-1, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    for dt, fo in ((torch.uint8, -1000), (torch.uint16, 70_000),
                   (torch.uint32, -(1 << 33)), (torch.int8, None),
                   (torch.int16, None), (torch.int32, None),
                   (torch.int64, None)):
        lo, hi = (0, 255) if dt == torch.uint8 else \
            (0, (1 << 32) - 1) if dt == torch.uint32 else \
            (-(1 << 40), 1 << 40) if dt == torch.int64 else \
            (torch.iinfo(dt).min, torch.iinfo(dt).max)
        v = torch.randint(lo, hi + 1, (n,), generator=gen,
                          dtype=torch.int64, device=dev)
        v[:4] = torch.tensor([lo, hi, lo, hi], device=dev)
        stored = v.to(torch.int32).view(torch.uint32) \
            if dt == torch.uint32 else v.to(dt)
        plus = None if fo is None else torch.tensor(
            fo, dtype=torch.int64 if dt == torch.uint32 else torch.int32,
            device=dev)
        off = lo + (fo or 0) - 7
        nplanes = max(1, (hi - lo + 7).bit_length() + 7 >> 3)
        src = PlaneSource(stored, "int", nplanes, plus,
                          torch.tensor(off, dtype=torch.int64, device=dev))
        got = kernels.group_plane_sums(gid, [src], G, count=True)
        want = kernels.group_plane_sums_plain(gid, [src], G, True)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs on a stored {dt} plane")
    h = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < 0.5
    for log2m in (4, 12, 16):
        got = kernels.hll_register_max(h, log2m, 3, gid=gid, mask=mask)
        want = kernels.hll_register_max_plain(h, log2m, 3, gid, mask)
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs with ids and a mask at "
                                 f"log2m {log2m}")
    log(f"K1 on every stored dtype (u8 u16 u32 i8 i16 i32 i64, FOR and "
        f"query offsets) and K3 with ids and a mask at log2m 4/12/16, "
        f"n={n}: bit-exact")


def check_k1(n: int, dev) -> dict:
    """K1 at each main-path shape against its plain version: integer rows
    bit-exact, float planes and their sum within rtol 1e-6; q5 once more
    with a flush every 65,536 rows. Times: the kernel, the channel build
    it absorbed, the plain version and one ``index_add_`` of the widened
    values; the bound is the ids' and the stored values' bytes read once
    and the output written once. Returns q1's numbers with every shape's
    under ``shapes``."""
    import torch
    from pinot_tpu_torch.ops import kernels

    shapes = []
    for label, entry, G, sources, count, gid in _k1_shapes(n, dev):
        got = entry(gid, sources, G, count=count)
        want = kernels.group_plane_sums_plain(gid, sources, G, count)
        torch.cuda.synchronize()
        layout = kernels.plane_layout(sources, count)
        int_rows = [a for a, (region, _r) in enumerate(layout)
                    if region == "int" or any(s.kind == "bf16"
                                              for s in sources)]
        flt_rows = [a for a in range(len(layout)) if a not in int_rows]
        err = float((got - want).abs().max())
        if not torch.equal(got[int_rows], want[int_rows]):
            raise AssertionError(f"K1 {label}: integer rows differ, max abs "
                                 f"err {err}")
        rel = 0.0
        if flt_rows:
            g, w = got[flt_rows], want[flt_rows]
            rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()),
                      float(((g.sum(0) - w.sum(0)).abs()
                             / w.sum(0).abs().clamp_min(1e-30)).max()))
            if not rel <= 1e-6:
                raise AssertionError(f"K1 {label}: float planes off by "
                                     f"{rel} relative (tolerance 1e-6)")
        if G == 35:
            seg = kernels.group_plane_sums(gid, sources, G, count=count,
                                           seg_rows=65536)
            if not torch.equal(seg, want):
                raise AssertionError("K1 q5 with a flush every 65,536 rows "
                                     "differs")
        ms = cuda_ms(lambda: entry(gid, sources, G, count=count), 10)
        absorbed_ms = cuda_ms(lambda: absorbed_channels(sources, count), 5)
        plain_ms = cuda_ms(lambda: kernels.group_plane_sums_plain(
            gid, sources, G, count), 3)
        vals = ([torch.ones(n, dtype=torch.float64, device=dev)]
                if count else []) + [
            s.values.to(torch.float64) for s in sources]
        V = torch.stack(vals)
        del vals
        lib_out = torch.zeros((V.shape[0], G + 1), dtype=torch.float64,
                              device=dev)
        lib_ms = cuda_ms(lambda: lib_out.index_add_(1, gid, V), 5)
        del V, lib_out
        A = len(layout)
        nbytes = 4 * n + n * sum(s.values.element_size() for s in sources) \
            + 8 * A * G
        b, by = bound_ms(nbytes, n * A)
        shapes.append(dict(shape=f"n={n} {label}", max_abs_err=err,
                           float_max_rel_err=rel, ms=ms,
                           absorbed_ms=absorbed_ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by, library_ms=lib_ms))
        log(f"K1 {shapes[-1]['shape']}: {ms:.4f} ms, absorbed channel build "
            f"{absorbed_ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
            f"{lib_ms:.4f} ms, bound {b:.4f} ms; integer rows bit-exact"
            + (f", float planes max rel err {rel:.3e}" if flt_rows else ""))
        del got, want
    return dict(shapes[0], shapes=shapes)


def check_k3(n: int, dev) -> list:
    """K3 from 32-bit hashes at the HLL path's register spaces: 1024 slots
    (scalar HLL with a mask, through the small-slot entry, Pallas row 5),
    35,840 = 35 x 1024 (d_year x c_region, the group entry, row 2) and
    2^20 = 1024 x 1024 slots (the reference's bound for row 2, several
    partitions; no query reaches it, PERF.md). Ids include the overflow
    id. Bit-exact. Times: the kernel, the split it absorbed (``hll_slots``:
    ``hll_idx_rho`` and the where), the plain version and one
    ``scatter_reduce_`` over the split's slots and ranks."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import hll as hll_ops
    from pinot_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(19)
    h = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < 3 / 11
    out = []
    for G, entry, call_gid, use_mask, call in (
            (1, "group_scatter.hll_register_max", False, True,
             lambda g: ps.hll_register_max(h, LOG2M, mask=mask)),
            (35, "groupby_mm.hll_registers", True, False,
             lambda g: mm.hll_registers(h, g, 35, LOG2M)),
            (1024, "kernels.hll_register_max", True, False,
             lambda g: kernels.hll_register_max(h, LOG2M, 1024, gid=g))):
        nslots = G << LOG2M
        gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                            device=dev) if call_gid else None
        m = mask if use_mask else None
        got = call(gid).reshape(-1)
        want = kernels.hll_register_max_plain(h, LOG2M, G, gid, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs at {nslots} slots, max abs "
                                 f"err {err}")
        ms = cuda_ms(lambda: call(gid), 10)
        absorbed_ms = cuda_ms(lambda: hll_ops.hll_slots(h, LOG2M, G, gid, m),
                              5)
        plain_ms = cuda_ms(lambda: kernels.hll_register_max_plain(
            h, LOG2M, G, gid, m), 3)
        slot, rho = hll_ops.hll_slots(h, LOG2M, G, gid, m)
        s64 = slot.long()
        lib = torch.zeros(nslots + 1, dtype=torch.int32, device=dev)
        lib_ms = cuda_ms(lambda: lib.scatter_reduce_(0, s64, rho, "amax"), 5)
        del slot, rho, s64, lib
        nbytes = 4 * n + (4 * n if call_gid else 0) + (n if use_mask else 0) \
            + 4 * nslots
        b, by = bound_ms(nbytes, n)
        out.append(dict(shape=f"n={n} slots={nslots} via {entry}"
                              + (" (masked)" if use_mask else ""),
                        nslots=nslots,
                        partitions=kernels.hll_partitions(nslots),
                        max_abs_err=err, ms=ms, absorbed_ms=absorbed_ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=lib_ms))
        log(f"K3 {out[-1]['shape']} ({out[-1]['partitions']} partitions): "
            f"{ms:.4f} ms, absorbed split {absorbed_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scatter_reduce_ amax {lib_ms:.4f} ms, bound "
            f"{b:.4f} ms, bit-exact")
    return out


def check_k2(n: int, dev) -> dict:
    """K2 at q6's shape: G=175 (7 years x 25 nations), int32 min + max;
    and the same shape over float32 with signed zeros, bit-exact."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(13)
    G = 175
    gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    v = torch.randint(1000, 6_000_000, (n,), generator=gen,
                      dtype=torch.int32, device=dev)
    fills = (2**31 - 1, -2**31)
    ops = ("min", "max")
    got = ps.group_minmax(gid, v, G, ops, fills=fills)
    want = kernels.group_minmax_plain(gid, v, G, ops, fills)
    torch.cuda.synchronize()
    err = max(float((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K2 int32 differs, max abs err {err}")
    ms = cuda_ms(lambda: ps.group_minmax(gid, v, G, ops, fills=fills), 10)
    plain_ms = cuda_ms(lambda: kernels.group_minmax_plain(
        gid, v, G, ops, fills), 3)
    g64 = gid.long()
    lo = torch.full((G + 1,), fills[0], dtype=torch.int32, device=dev)
    hi = torch.full((G + 1,), fills[1], dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: lo.scatter_reduce_(0, g64, v, "amin"), 5) \
        + cuda_ms(lambda: hi.scatter_reduce_(0, g64, v, "amax"), 5)
    del g64
    b, by = bound_ms(8 * n + 4 * G * len(ops), n * len(ops))

    fv = torch.randn((n,), generator=gen, device=dev)
    fv[::1000] = -0.0
    fv[1::1000] = 0.0
    ffills = (float("inf"), float("-inf"))
    got = ps.group_minmax(gid, fv, G, ops, fills=ffills)
    want = kernels.group_minmax_plain(gid, fv, G, ops, ffills)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want)):
        raise AssertionError("K2 float32 differs")
    log(f"K2 float32 shape n={n} G={G}: bit-exact with signed zeros")
    return dict(shape=f"n={n} G={G} int32 min+max", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms)


def kernel_device_ms(fn, reps: int, name_part: str):
    """Mean device time of the kernels whose name holds ``name_part`` over
    ``reps`` calls, from torch.profiler (a kernel of a few microseconds
    is shorter than its wrapper's host time, which CUDA events around
    back-to-back calls would measure); None when the trace shows none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name_part in e.key]
    if not ev:
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3 / reps


def gather_branch(cand, rows_in, col_arrays, par_arrays, plan):
    """The port's generic gathered form over K4's candidates, for its
    time: gather every plane's candidate blocks (ops/blockskip.py), the
    filter as torch ops (engine/device.py ``_eval_filter``) and masked
    reductions (ops/agg.py). No single PyTorch call computes K4's
    function, so this stands as its yardstick."""
    import torch
    from pinot_tpu_torch.engine.device import _eval_filter
    from pinot_tpu_torch.ops import agg as agg_ops
    from pinot_tpu_torch.ops import blockskip as bs

    R = bs.BLOCK_ROWS
    g = {}
    for k, v in col_arrays.items():
        x = bs.gather_blocks(v, cand, 1, R)
        g[k] = x if x.is_floating_point() else x.to(torch.int32)
    rowid = torch.arange(R, dtype=torch.int32, device=cand.device)
    mask = _eval_filter(plan.filter_tpl, g, par_arrays,
                        (cand.shape[0], R), cand.device) \
        & (rowid[None, :] < rows_in[:, None])
    reduce = {"sum": agg_ops.agg_sum, "min": agg_ops.agg_min,
              "max": agg_ops.agg_max}
    return [mask.sum()] + [reduce[op](g[ck], mask)
                           for (_i, op, ck, _b, _s, _f) in plan.aggs]


def check_k4(label: str, cand, rows_in, col_arrays, par_arrays, plan) -> dict:
    """K4 against its plain version on one set of candidates, bit-exact;
    kernel device time (profiler), the plain version's and the generic
    gathered form's (CUDA events), and the bytes bound: each candidate
    row that holds data read once per plane, candidate ids and row counts
    read, the per-candidate partials written."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import kernels

    args = ps.lower_fused(plan, col_arrays, par_arrays)
    got_i, got_f = kernels.fused_filter_agg(cand, rows_in, *args)
    want_i, want_f = kernels.fused_filter_agg_plain(cand, rows_in, *args)
    torch.cuda.synchronize()
    err = float((got_i.long() - want_i.long()).abs().max())
    same = torch.equal(got_i, want_i)
    if want_f is not None:
        err = max(err, float((got_f - want_f).abs().max()))
        same = same and torch.equal(got_f.view(torch.int32),
                                    want_f.view(torch.int32))
    if not same:
        raise AssertionError(f"K4 differs at {label}, max abs err {err}")
    branch = gather_branch(cand, rows_in, col_arrays, par_arrays, plan)
    if int(branch[0]) != int(got_i[:, 0].sum()):
        raise AssertionError(f"K4 {label}: the gathered form counts "
                             f"{int(branch[0])} rows, K4 "
                             f"{int(got_i[:, 0].sum())}")

    def call():
        return kernels.fused_filter_agg(cand, rows_in, *args)

    event_ms = cuda_ms(call, 20)
    dev_ms = kernel_device_ms(call, 20, "fused_kernel")
    plain_ms = cuda_ms(lambda: kernels.fused_filter_agg_plain(
        cand, rows_in, *args), 3)
    lib_ms = cuda_ms(lambda: gather_branch(cand, rows_in, col_arrays,
                                           par_arrays, plan), 5)
    cols, _lits, prog, aggs, ki, kf = args
    rows = int(rows_in.sum())
    B = cand.shape[0]
    nbytes = rows * sum(c.element_size() for c in cols) + 8 * B \
        + 4 * B * (ki + kf)
    b, by = bound_ms(nbytes, rows * (len(prog) + len(aggs) + 1))
    n_valid = int((rows_in > 0).sum())
    res = dict(shape=f"{label}: B={B} candidates ({n_valid} holding "
                     f"{rows} rows), {len(cols)} planes "
                     f"({', '.join(str(c.dtype).replace('torch.', '') for c in cols)}), "
                     f"{len(prog)} instructions, {len(aggs)} aggregates",
               max_abs_err=err, ms=dev_ms if dev_ms is not None else event_ms,
               call_ms=event_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=lib_ms,
               library_is="the port's generic gathered form (no single "
                          "PyTorch call computes K4's function)")
    log(f"K4 {res['shape']}: kernel {res['ms']:.4f} ms (device, profiler), "
        f"call {event_ms:.4f} ms (CUDA events), plain {plain_ms:.4f} ms, "
        f"gathered form {lib_ms:.4f} ms, bound {b:.4f} ms, bit-exact")
    return res


def check_k4_bound(n_blocks: int, dev) -> dict:
    """K4 at the full static candidate bound B = ceil(n_blocks / 16) over
    a batch of n_blocks zone blocks: u16 and u8 dict-id planes, an i32
    decoded plane, a synthetic f32 plane (float MIN/MAX) and an i16 raw
    plane (raw-space predicates); random distinct candidates, the last
    one a partial block."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps

    R = ps.FUSED_BLOCK_ROWS
    gen = torch.Generator(device=dev).manual_seed(23)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n_blocks, R), generator=gen,
                             dtype=torch.int32, device=dev).to(dtype)

    cols = {"lo_orderdate": ints(0, 2352, torch.uint16),
            "lo_discount": ints(0, 11, torch.uint8),
            "dv::lo_revenue": ints(1000, 6_000_000, torch.int32),
            "fv": torch.randn((n_blocks, R), generator=gen, device=dev),
            "r16": ints(-30000, 30000, torch.int16)}
    widths = {"lo_orderdate": ("<u2", 0, False, ""),
              "lo_discount": ("|u1", 0, False, ""),
              "dv::lo_revenue": ("<i4", 0, False, ""),
              "fv": ("<f4", 0, False, ""), "r16": ("<i2", 0, False, "")}
    ftpl = ("and", ("range_dict", "lo_orderdate", "p0", "p1"),
            ("in_dict", "lo_discount", "p2", 4),
            ("not", ("eq_raw", ("raw", "r16"), "p3")),
            ("range_raw", ("raw", "r16"), "p4", "p5", True, True, True, False))
    aggs = (("count", None, None),
            ("sum", ("raw", "lo_discount"), (1, 1 << 20)),
            ("minmaxrange", ("dictval", "lo_revenue"), None),
            ("minmaxrange", ("raw", "fv"), None),
            ("max", ("raw", "r16"), None))
    plan = ps.plan_fused(ftpl, aggs, widths)

    def lit(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    params = {"p0": lit(200), "p1": lit(1800), "p2": lit(1, 3, 5, 7),
              "p3": lit(0), "p4": lit(-20000), "p5": lit(20000)}
    if plan is None or not ps.fused_params_ok(plan, params):
        raise AssertionError("K4 bound shape: the fused plan declined")
    B = min(n_blocks, max(1, -(-n_blocks // 16)))
    cand = torch.randperm(n_blocks, generator=gen, device=dev)[:B] \
        .sort().values.to(torch.int32)
    rows_in = torch.full((B,), R, dtype=torch.int32, device=dev)
    rows_in[-1] = 1000
    return check_k4("full candidate bound", cand, rows_in,
                    {k: cols[k] for k in plan.cols}, params, plan)


def capture_fused(engine, sql: str) -> tuple:
    """The arguments the engine hands K4's entry for ``sql``: (cand,
    rows_in, col_arrays, par_arrays, plan)."""
    from pinot_tpu_torch.ops import group_scatter as ps

    seen = []
    entry = ps.fused_filter_agg

    def grab(*args):
        seen.append(args)
        return entry(*args)

    ps.fused_filter_agg = grab
    try:
        resp = engine.execute(sql)
    finally:
        ps.fused_filter_agg = entry
    if resp["exceptions"] or len(seen) != 1:
        raise AssertionError(f"K4 was not reached once by {sql!r}: "
                             f"{resp['exceptions']}, {len(seen)} calls")
    return seen[0]


def overflow_cost(engine, runs: int) -> dict:
    """The unsorted table's block-skip-eligible queries overflow the
    candidate bound: p50 with block skip on (zone verdict + one scalar
    read, then the dense form) and off, in alternating order."""
    out = {}
    sqls = dict(QUERIES, **HLL_QUERIES)
    for name in OVERFLOW_QUERIES:
        on, off = sqls[name], "SET useBlockSkip = false; " + sqls[name]
        r_on, r_off = engine.execute(on), engine.execute(off)
        if r_on["resultTable"] != r_off["resultTable"] \
                or r_on["numBlocksPruned"] != 0:
            raise AssertionError(f"{name}: block skip on and off differ")
        times = {on: [], off: []}
        for _ in range(runs):
            for sql in (on, off, off, on):
                t = time.perf_counter()
                engine.execute(sql)
                times[sql].append((time.perf_counter() - t) * 1e3)
        p_on = float(np.percentile(times[on], 50))
        p_off = float(np.percentile(times[off], 50))
        out[name] = {"skip_eligible_p50_ms": p_on, "forced_dense_p50_ms": p_off}
        log(f"overflow cost {name}: p50 {p_on:.3f} ms eligible, {p_off:.3f} "
            f"ms with useBlockSkip=false ({p_on - p_off:+.3f} ms over "
            f"{2 * runs} runs each)")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def profile_query(engine, name: str, sql: str, top: int = 8) -> None:
    """One traced run: wall time, the summed device time of its kernels
    (their share of the wall time is the device's busy share, kernels not
    overlapping on one stream) and the operations that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.execute(sql)
        wall_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    # device-side events only: the aten ops that launched them repeat
    # their kernels' device time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    ev.sort(key=lambda e: -e.self_device_time_total)
    parts = ", ".join(f"{e.key[:48]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f}" for e in ev[:top])
    # host side: the CUDA runtime calls and aten ops with the most self
    # time, where a host-bound query's wall time goes
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    hparts = ", ".join(f"{e.key[:32]} x{e.count} "
                       f"{e.self_cpu_time_total / 1e3:.3f}" for e in host[:6])
    log(f"profile {name}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms "
        f"(busy {dev_ms / wall_ms:.1%}); top device ms: {parts}; traced "
        f"host ops {host_ms:.3f} ms, top host ms: {hparts}")


def launch_tables() -> dict:
    """The launch counters: per kernel, and per entry of the two modules
    whose entries stand for different TPU kernels."""
    from pinot_tpu_torch.ops import group_scatter, groupby_mm, kernels

    return {"kernels": kernels.launches, "group_scatter": group_scatter.launches,
            "groupby_mm": groupby_mm.launches}


def run_path(engine, path: str, want: dict, total: int, runs: int,
             profile: bool) -> tuple:
    """One main path: zero every launch count, run each query once
    against the oracle and ``runs`` more times for its p50 (plus a traced
    run with ``profile``), read the counts. Fails when an answer differs
    or a kernel or entry of the path never launched. Returns (p50 by
    query, kernel launches)."""
    queries, kernel_names, entries = PATHS[path]
    tables = launch_tables()
    for table in tables.values():
        for key in table:
            table[key] = 0
    p50 = {}
    for name, sql in queries.items():
        resp = engine.execute(sql)
        if resp["exceptions"]:
            raise AssertionError(f"{name}: {resp['exceptions']}")
        rows_want, scanned = want[name][:2]
        got = resp["resultTable"]["rows"]
        if not rows_equal(got, rows_want):
            raise AssertionError(f"{name}: rows {got[:5]} want "
                                 f"{rows_want[:5]}")
        if resp["numDocsScanned"] != scanned or resp["totalDocs"] != total:
            raise AssertionError(
                f"{name}: numDocsScanned {resp['numDocsScanned']} / "
                f"totalDocs {resp['totalDocs']}, want {scanned} / {total}")
        if len(want[name]) > 2:  # pruning stats, and the force-dense twin
            for key, val in want[name][2].items():
                if resp[key] != val:
                    raise AssertionError(f"{name}: {key} {resp[key]}, "
                                         f"want {val}")
            twin = engine.execute("SET useBlockSkip = false; " + sql)
            if twin["resultTable"] != resp["resultTable"] \
                    or twin["numDocsScanned"] != scanned:
                raise AssertionError(f"{name}: the useBlockSkip = false twin "
                                     f"answers {twin['resultTable']}")
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            engine.execute(sql)
            times.append((time.perf_counter() - t) * 1e3)
        p50[name] = float(np.percentile(times, 50))
        log(f"{name}: matches the oracle ({len(got)} rows, "
            f"numDocsScanned {scanned}); p50 {p50[name]:.3f} ms over "
            f"{runs} runs")
        if profile:
            profile_query(engine, name, sql)
    counts = {k: dict(v) for k, v in tables.items()}
    log(f"{path} path launches: {json.dumps(counts)}")
    for name in kernel_names:
        if counts["kernels"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} path")
    for row, module, entry in entries:
        if counts[module][entry] <= 0:
            raise AssertionError(f"{module}.{entry} (Pallas row {row}) never "
                                 f"launched on the {path} path")
    return p50, counts["kernels"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--rows", type=int, default=12_500_000,
                    help="rows per segment")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed runs per query")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed runs, trace one more run of each "
                         "query with torch.profiler and print its device "
                         "time by operation")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pinot_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(pinot_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.storage.device import padded_len
    from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS, \
        ImmutableSegment

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t = time.perf_counter()
    kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t:.2f} s "
        f"({', '.join(kernels.SOURCES.values())})")
    for name, out in kernels.build_log.items():
        for line in out.splitlines():
            if any(k in line for k in ("registers", "spill", "smem")):
                log(f"ptxas {name}: {line.strip()}")

    S, rows = args.segments, args.rows
    log(f"table: SSB lineorder, {S} segments x {rows} rows = {S * rows} "
        f"rows, seed 7")
    t = time.perf_counter()
    data = generate(S, rows)
    log(f"generate: {time.perf_counter() - t:.2f} s")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    t_write = time.perf_counter()
    workers = min(S, os.cpu_count() or 1)
    pool = mp.get_context("spawn").Pool(workers)
    try:
        pending = pool.starmap_async(write_segment, enumerate(data))
        t = time.perf_counter()
        bs_data = sort_by_date(data)
        log(f"sort by lo_orderdate: {time.perf_counter() - t:.2f} s")
        pending_bs = pool.starmap_async(
            write_segment, [(i, seg, BS_TABLE) for i, seg in
                            enumerate(bs_data)])

        dev = torch.device("cuda", 0)
        pad = padded_len(rows, max(1024, ZONE_BLOCK_ROWS))
        n = S * pad
        check_split_dtypes(dev)
        k1 = check_k1(n, dev)
        torch.cuda.empty_cache()
        k2 = check_k2(n, dev)
        log(f"K2 {k2['shape']}: {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f}"
            f" ms, scatter_reduce_ amin+amax {k2['library_ms']:.4f} ms, "
            f"bound {k2['bound_ms']:.4f} ms, bit-exact")
        torch.cuda.empty_cache()
        k3_sizes = check_k3(n, dev)
        # the kernel line's main numbers: the group entry's 35 x 1024 slots
        k3 = dict(k3_sizes[1], sizes=k3_sizes)
        torch.cuda.empty_cache()
        k4_bound = check_k4_bound(n // ZONE_BLOCK_ROWS, dev)
        torch.cuda.empty_cache()

        dirs = pending.get()
        bs_dirs = pending_bs.get()
        log(f"write segments (port creator, {workers} processes, both "
            f"tables): {time.perf_counter() - t_write:.2f} s")
    finally:
        pool.terminate()
        pool.join()

    t = time.perf_counter()
    want = oracle(data)
    want.update(bs_oracle(bs_data, pad))
    total = S * rows
    del data, bs_data
    log(f"numpy oracle: {time.perf_counter() - t:.2f} s")

    segs = [ImmutableSegment(d) for d in dirs]
    bs_segs = [ImmutableSegment(d) for d in bs_dirs]
    engine = QueryEngine(device="cuda")
    for s in segs:
        engine.add_segment("lineorder", s)
    for s in bs_segs:
        engine.add_segment(BS_TABLE, s)
    t = time.perf_counter()
    ctx = engine.device.batch_for(segs)
    for c in ("d_year", "c_region", "s_nation", "lo_suppkey",
              "lo_orderdate", "lo_discount", "lo_quantity"):
        ctx.column(c)
    for c in ("lo_quantity", "lo_revenue"):
        ctx.decoded_column(c)
    ctx.prehashed_column("lo_custkey")
    bs_ctx = engine.device.batch_for(bs_segs)
    for c in ("lo_orderdate", "lo_discount", "lo_quantity"):
        bs_ctx.column(c)
    for c in ("lo_quantity", "lo_revenue"):
        bs_ctx.decoded_column(c)
    torch.cuda.synchronize()
    log(f"upload (global dictionaries, zone maps + {ctx.resident_bytes} "
        f"+ {bs_ctx.resident_bytes} device bytes): "
        f"{time.perf_counter() - t:.2f} s")

    k4 = check_k4("the block-skip path's bs_month_fused",
                  *capture_fused(engine, BS_QUERIES["bs_month_fused"]))
    k4["sizes"] = [dict(k4), k4_bound]

    p50, launches = {}, {name: 0 for name in kernels.launches}
    for path in PATHS:
        path_p50, counts = run_path(engine, path, want, total, args.runs,
                                    args.profile)
        p50.update(path_p50)
        for name, count in counts.items():
            launches[name] += count
    overflow = overflow_cost(engine, args.runs)

    entries = []
    for name, res, replaces in (
            ("group_plane_sums", k1, "pinot_tpu/ops/pallas_scatter.py:244 "
             "(and pinot_tpu/ops/groupby_mm.py:225)"),
            ("group_minmax", k2, "pinot_tpu/ops/pallas_scatter.py:349"),
            ("hll_register_max", k3, "pinot_tpu/ops/pallas_scatter.py:455 "
             "(and pinot_tpu/ops/groupby_mm.py:225 in rho_mode)"),
            ("fused_filter_agg", k4, "pinot_tpu/ops/pallas_scatter.py:792")):
        entry = {"name": name, "route": "cuda",
                 "source": f"pinot_tpu_torch/csrc/{kernels.SOURCES[name]}",
                 "replaces": replaces, "launches": launches[name]}
        entry.update(res)
        entries.append(entry)
    log(json.dumps({"query_p50_ms": p50, "rows": total,
                    "overflow_cost": overflow}))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failure fails the run
        traceback.print_exc()
        rc = 1
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    sys.exit(rc)
