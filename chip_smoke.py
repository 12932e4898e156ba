#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # the full run: 8 x 12.5M rows
    python3 chip_smoke.py --rows 1000000       # a quick rehearsal

Phases, all on ``cuda:0``:

1. the card's name and power limit; the kernels built from
   ``pinot_tpu_torch/csrc/`` (one ``nvcc`` per source, started together).
2. The SSB lineorder table is generated from seed 7 with bench.py's
   columns and distributions and written by the port's creator in worker
   processes, while the GPU holds each kernel of the path against its
   plain PyTorch version at the main path's shapes: K1 group plane sums
   (integer planes bit-exact, float planes within rtol 1e-6) and K2 group
   min/max (bit-exact). CUDA-event times of the kernel, of its plain
   version and of one library call computing the same function
   (``index_add_`` / ``scatter_reduce_``), beside the memory bound.
3. The table is loaded into ``QueryEngine(device="cuda")`` and the slice's
   six queries run: every answer is checked against a numpy oracle over
   the generated columns, and the per-query p50 of 5 runs printed. The
   kernels' launch counts are zeroed just before and read just after;
   each kernel must have launched.
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


def write_segment(i: int, seg: dict) -> str:
    """Writes segment ``s<i>`` of the table with the port's creator (run in
    a worker process)."""
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
    out = os.path.join(DATA_DIR, f"s{i}")
    build_segment(schema, cols, out, TableConfig(table_name="lineorder"),
                  f"s{i}")
    return out


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


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


def check_k1(n: int, dev) -> dict:
    """K1 at q1's shape (G=2000, count + 3 revenue byte planes) and at a
    wide float shape (G=6240, count + 3 f32 planes + 2 int planes)."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(11)
    res = {}

    G = 2000
    gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    rev = torch.randint(1000, 6_000_000, (n,), generator=gen,
                        dtype=torch.int32, device=dev)
    ch = torch.stack([torch.ones(n, dtype=torch.bfloat16, device=dev)]
                     + mm.int_planes(rev, 1000, 3))
    del rev
    A = ch.shape[0]
    got = ps.plane_group_sums(gid, ch, G, first_channel_ones=True)
    want = kernels.group_plane_sums_plain(gid, ch, G, True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K1 integer planes differ, max abs err {err}")
    ms = cuda_ms(lambda: ps.plane_group_sums(gid, ch, G,
                                             first_channel_ones=True), 10)
    plain_ms = cuda_ms(lambda: kernels.group_plane_sums_plain(
        gid, ch, G, True), 3)
    ch32 = ch.float()
    lib_out = torch.zeros((A, G + 1), dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: lib_out.index_add_(1, gid, ch32), 5)
    del ch32, lib_out
    b, by = bound_ms(4 * n + 2 * n * (A - 1) + 8 * A * G, n * A)
    res.update(shape=f"n={n} G={G} A={A} int planes", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms)
    del gid, ch, got, want

    G = 6240
    gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    fv = torch.rand((n,), generator=gen, device=dev) * 8
    iv = torch.randint(0, 65536, (n,), generator=gen, dtype=torch.int32,
                       device=dev)
    ch = torch.stack([torch.ones(n, dtype=torch.bfloat16, device=dev)]
                     + mm.float_planes(fv) + mm.int_planes(iv, 0, 2))
    del fv, iv
    got = ps.plane_group_sums(gid, ch, G, first_channel_ones=True)
    want = kernels.group_plane_sums_plain(gid, ch, G, True)
    torch.cuda.synchronize()
    int_rows = [0, 4, 5]
    if not torch.equal(got[int_rows], want[int_rows]):
        raise AssertionError("K1 integer planes differ at G=6240")
    rel = float(((got[1:4] - want[1:4]).abs()
                 / want[1:4].abs().clamp_min(1e-30)).max())
    tot_rel = float(((got[1:4].sum(0) - want[1:4].sum(0)).abs()
                     / want[1:4].sum(0).abs().clamp_min(1e-30)).max())
    if not (rel <= 1e-6 and tot_rel <= 1e-6):
        raise AssertionError(f"K1 float planes off: plane rel {rel}, "
                             f"total rel {tot_rel} (tolerance 1e-6)")
    ms2 = cuda_ms(lambda: ps.plane_group_sums(gid, ch, G,
                                              first_channel_ones=True), 10)
    A2 = ch.shape[0]
    b2, _ = bound_ms(4 * n + 2 * n * (A2 - 1) + 8 * A2 * G, n * A2)
    log(f"K1 wide shape n={n} G={G} A={A2} (3 float planes): "
        f"{ms2:.4f} ms, bound {b2:.4f} ms, float plane max rel err {rel:.3e}, "
        f"recombined max rel err {tot_rel:.3e}, int planes bit-exact")
    res.update(wide_shape=f"n={n} G={G} A={A2} float planes", wide_ms=ms2,
               wide_bound_ms=b2, float_max_rel_err=max(rel, tot_rel))
    return res


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
    log(f"profile {name}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms "
        f"(busy {dev_ms / wall_ms:.1%}); top device ms: {parts}")


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

        dev = torch.device("cuda", 0)
        n = S * padded_len(rows, max(1024, ZONE_BLOCK_ROWS))
        k1 = check_k1(n, dev)
        log(f"K1 {k1['shape']}: {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f}"
            f" ms, index_add_ {k1['library_ms']:.4f} ms, bound "
            f"{k1['bound_ms']:.4f} ms, bit-exact")
        k2 = check_k2(n, dev)
        log(f"K2 {k2['shape']}: {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f}"
            f" ms, scatter_reduce_ amin+amax {k2['library_ms']:.4f} ms, "
            f"bound {k2['bound_ms']:.4f} ms, bit-exact")
        torch.cuda.empty_cache()

        dirs = pending.get()
        log(f"write segments (port creator, {workers} processes): "
            f"{time.perf_counter() - t_write:.2f} s")
    finally:
        pool.terminate()
        pool.join()

    t = time.perf_counter()
    want = oracle(data)
    total = S * rows
    del data
    log(f"numpy oracle: {time.perf_counter() - t:.2f} s")

    segs = [ImmutableSegment(d) for d in dirs]
    engine = QueryEngine(device="cuda")
    for s in segs:
        engine.add_segment("lineorder", s)
    t = time.perf_counter()
    ctx = engine.device.batch_for(segs)
    for c in ("d_year", "c_region", "s_nation", "lo_suppkey",
              "lo_orderdate", "lo_discount", "lo_quantity"):
        ctx.column(c)
    for c in ("lo_quantity", "lo_revenue"):
        ctx.decoded_column(c)
    torch.cuda.synchronize()
    log(f"upload (global dictionaries + {ctx.resident_bytes} device bytes):"
        f" {time.perf_counter() - t:.2f} s")

    for name in kernels.launches:
        kernels.launches[name] = 0
    p50 = {}
    for name, sql in QUERIES.items():
        resp = engine.execute(sql)
        if resp["exceptions"]:
            raise AssertionError(f"{name}: {resp['exceptions']}")
        rows_want, scanned = want[name]
        got = resp["resultTable"]["rows"]
        if not rows_equal(got, rows_want):
            raise AssertionError(f"{name}: rows {got[:5]} want "
                                 f"{rows_want[:5]}")
        if resp["numDocsScanned"] != scanned or resp["totalDocs"] != total:
            raise AssertionError(
                f"{name}: numDocsScanned {resp['numDocsScanned']} / "
                f"totalDocs {resp['totalDocs']}, want {scanned} / {total}")
        times = []
        for _ in range(args.runs):
            t = time.perf_counter()
            engine.execute(sql)
            times.append((time.perf_counter() - t) * 1e3)
        p50[name] = float(np.percentile(times, 50))
        log(f"{name}: matches the oracle ({len(got)} rows, "
            f"numDocsScanned {scanned}); p50 {p50[name]:.3f} ms over "
            f"{args.runs} runs")
        if args.profile:
            profile_query(engine, name, sql)
    launches = dict(kernels.launches)
    log(f"main-path launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")

    entries = []
    for name, res, replaces in (
            ("group_plane_sums", k1, "pinot_tpu/ops/pallas_scatter.py:244 "
             "(and pinot_tpu/ops/groupby_mm.py:225)"),
            ("group_minmax", k2, "pinot_tpu/ops/pallas_scatter.py:349")):
        entry = {"name": name, "route": "cuda",
                 "source": f"pinot_tpu_torch/csrc/{kernels.SOURCES[name]}",
                 "replaces": replaces, "launches": launches[name]}
        entry.update(res)
        entries.append(entry)
    log(json.dumps({"query_p50_ms": p50, "rows": total}))
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
