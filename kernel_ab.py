#!/usr/bin/env python3
"""Time the port's kernels at chip_smoke.py's main-path shapes, for an A/B
of two trees on one card.

    python3 kernel_ab.py                     # this checkout's kernels
    python3 kernel_ab.py --root OTHER_TREE   # another checkout's

K1 (group plane sums) at q1, q5, q4_no_hll, the wide float shape and the
sorted HLL build; K3 (HLL register max) at 1024, 35,840 and 2^20 slots;
K2 (group min/max) at q6's shape; K4 (fused filter + aggregate) at
bs_month_fused's candidates and at the full candidate bound; K5 (ordered
cluster sums) at the digest queries' run shapes over integer values and
over the same values plus 0.5, with a checksum of its output bits so two
trees' sums can be compared, the clusters each of its regimes summed and
the one-thread DADD latency that bounds its chain regime
(``--k5-only``: K5 alone).

K1, K2 and K3 changed their inputs over time: K1 read an (A, n) bf16
channel tensor that torch ops built from the stored planes, K3 int32
slot and rank tensors split from the hash plane, and K2 one int32 value
tensor per aggregate, narrow planes widened (and FOR-decoded) by torch,
in one launch per aggregate; now K1 and K3 read the stored planes and
split in registers, and K2 reads every aggregate's stored plane in one
launch. For a tree of the former kind this times the kernel on prebuilt
operands (for K2 the three launches q6 made) and, apart, the torch ops
that build them ("absorbed", the same ops engine/device.py ran before
each launch); for the latter the kernel alone. K4 keeps its interface:
its device time from torch.profiler (a few microseconds, shorter than
its wrapper's host time). Inputs come from fixed torch.Generator seeds,
so both trees see the same rows. CUDA-event means over 20 calls after a
warm-up. Prints the card line and one JSON object per shape, then
{"ok": true, ...} last. Run the trees in turns (A, B, B, A) in one call
to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from chip_smoke import cuda_ms, kernel_device_ms

N = 8 * 12_500_992   # chip_smoke.py's 8 segments x 12,500,992 padded rows
LOG2M = 10


def k2_q6(ps, kernels, n: int, dev) -> None:
    """K2 at q6's shape: G = 175, an i32 plane with MIN and MAX, a u8
    plane with an int32 FOR offset (decoded to int32) with MIN and MAX.
    A tree with one source per launch runs q6's three launches (MIN, MAX
    of the i32 values; MIN and MAX of the decoded u8) on the widened
    values, the widening and FOR add timed apart."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(13)
    G = 175
    gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    rev = torch.randint(1000, 6_000_000, (n,), generator=gen,
                        dtype=torch.int32, device=dev)
    qty = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32,
                        device=dev).to(torch.uint8)
    fo = torch.tensor(1, dtype=torch.int32, device=dev)
    fills = (2**31 - 1, -2**31)
    multi = hasattr(ps, "group_minmax_sources")
    if multi:
        srcs = [kernels.MinMaxSource(rev, ("min", "max"), fills,
                                     dtype=torch.int32),
                kernels.MinMaxSource(qty, ("min", "max"), fills, fo,
                                     torch.int32)]

        def call():
            return ps.group_minmax_sources(gid, srcs, G)
        build = None
    else:
        def build():
            return qty.to(torch.int32) + fo
        wide = build()

        def call():
            return (ps.group_minmax(gid, rev, G, ("min",), fills[:1]),
                    ps.group_minmax(gid, rev, G, ("max",), fills[1:]),
                    ps.group_minmax(gid, wide, G, ("min", "max"), fills))
    res = {"kernel": "K2", "shape": "q6", "one_launch": multi,
           "kernel_ms": cuda_ms(call, 20),
           "absorbed_ms": cuda_ms(build, 5) if build else 0.0}
    res["total_ms"] = res["kernel_ms"] + res["absorbed_ms"]
    print(json.dumps(res), flush=True)


def k4_shapes(ps, kernels, n: int, dev) -> None:
    """K4 at bs_month_fused's shape (1,526 candidates, the first 291 whole
    blocks of a month of the date-sorted table, the rest padding; a u16
    date-id plane under one RANGE, SUM of a u8 plane, MIN and MAX of an
    i32 plane) and at chip_smoke.py's full candidate bound (five planes,
    an and/in/not/range program, eight aggregates)."""
    import torch

    R = ps.FUSED_BLOCK_ROWS
    nb = n // R
    B = min(nb, max(1, -(-nb // 16)))
    gen = torch.Generator(device=dev).manual_seed(23)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (nb, R), generator=gen,
                             dtype=torch.int32, device=dev).to(dtype)

    def lit(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    # bs_month_fused: sorted date ids, the month [430, 458) of them
    date = torch.sort(ints(0, 2406, torch.int32).reshape(-1)).values \
        .reshape(nb, R).to(torch.uint16)
    first = int((date[:, -1].to(torch.int32) < 430).sum())
    cand = torch.zeros(B, dtype=torch.int32, device=dev)
    rows_in = torch.zeros(B, dtype=torch.int32, device=dev)
    nv = min(291, B, nb - first)
    cand[:nv] = torch.arange(first, first + nv, dtype=torch.int32,
                             device=dev)
    rows_in[:nv] = R
    month = (
        {"lo_orderdate": date, "lo_quantity": ints(1, 51, torch.uint8),
         "dv::lo_revenue": ints(1000, 6_000_000, torch.int32)},
        {"lo_orderdate": ("<u2", 0, False, ""),
         "lo_quantity": ("|u1", 0, False, "<i4"),
         "dv::lo_revenue": ("<i4", 0, False, "")},
        ("range_dict", "lo_orderdate", "p0", "p1"),
        (("count", None, None), ("sum", ("raw", "lo_quantity"), (1, 1 << 20)),
         ("min", ("dictval", "lo_revenue"), None),
         ("max", ("dictval", "lo_revenue"), None)),
        {"p0": lit(430), "p1": lit(458)}, cand, rows_in)
    # the full bound: chip_smoke.py check_k4_bound's planes and program
    bcand = torch.randperm(nb, generator=gen, device=dev)[:B] \
        .sort().values.to(torch.int32)
    brows = torch.full((B,), R, dtype=torch.int32, device=dev)
    brows[-1] = 1000
    bound = (
        {"lo_orderdate": ints(0, 2352, torch.uint16),
         "lo_discount": ints(0, 11, torch.uint8),
         "dv::lo_revenue": ints(1000, 6_000_000, torch.int32),
         "fv": torch.randn((nb, R), generator=gen, device=dev),
         "r16": ints(-30000, 30000, torch.int16)},
        {"lo_orderdate": ("<u2", 0, False, ""),
         "lo_discount": ("|u1", 0, False, ""),
         "dv::lo_revenue": ("<i4", 0, False, ""),
         "fv": ("<f4", 0, False, ""), "r16": ("<i2", 0, False, "")},
        ("and", ("range_dict", "lo_orderdate", "p0", "p1"),
         ("in_dict", "lo_discount", "p2", 4),
         ("not", ("eq_raw", ("raw", "r16"), "p3")),
         ("range_raw", ("raw", "r16"), "p4", "p5", True, True, True, False)),
        (("count", None, None),
         ("sum", ("raw", "lo_discount"), (1, 1 << 20)),
         ("minmaxrange", ("dictval", "lo_revenue"), None),
         ("minmaxrange", ("raw", "fv"), None),
         ("max", ("raw", "r16"), None)),
        {"p0": lit(200), "p1": lit(1800), "p2": lit(1, 3, 5, 7),
         "p3": lit(0), "p4": lit(-20000), "p5": lit(20000)}, bcand, brows)
    for name, (cols, widths, ftpl, aggs, params, c, r) in (
            ("bs_month_fused", month), ("full_bound", bound)):
        plan = ps.plan_fused(ftpl, aggs, widths)
        args = ps.lower_fused(plan, {k: cols[k] for k in plan.cols}, params)

        def call():
            return kernels.fused_filter_agg(c, r, *args)
        res = {"kernel": "K4", "shape": name, "candidates": B,
               "rows": int(r.sum()),
               "kernel_ms": kernel_device_ms(call, 20, "fused_kernel"),
               "call_ms": cuda_ms(call, 20)}
        print(json.dumps(res), flush=True)


def k5_inputs(dev):
    """K5's inputs at chip_smoke.py's digest runs, as (name, values,
    offsets): pct_scalar's 8 runs of 12.5M values (delta 200),
    pct_raw_month's 8 of 148,750 (delta 100) and pct_tdigest_supp's
    16,000 of 6,250 (delta 100); the clusters are ``digest.schedule``'s,
    the values random integers as lo_revenue's, then the same values plus
    0.5 (no cluster proves exact: the chain regime alone)."""
    import numpy as np
    import torch
    from pinot_tpu_torch.ops import digest

    gen = torch.Generator(device=dev).manual_seed(13)
    for name, runs, n_run, delta in (("pct_scalar", 8, 12_500_000, 200.0),
                                     ("pct_raw_month", 8, 148_750, 100.0),
                                     ("pct_tdigest_supp", 16_000, 6_250,
                                      100.0)):
        sizes = np.tile(np.asarray(digest.schedule(n_run, delta)), runs)
        off = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).to(dev)
        v = torch.randint(1000, 6_000_000, (runs * n_run,), generator=gen,
                          device=dev).to(torch.float64)
        yield name, v, off
        yield name + "+0.5", v + 0.5, off
        del v
        torch.cuda.empty_cache()


def device_us_by_kernel(call, reps: int) -> dict:
    """Device microseconds a call by kernel name (torch.profiler's
    device time over ``reps`` calls), and the host's microseconds a call
    to enqueue them (no synchronisation between calls)."""
    import re
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        call()
    enqueue_us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or 0
        m = re.search(r"(\w+)\(", e.key)
        if us and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / reps
    return {"device_us": out, "enqueue_us": enqueue_us}


def k5_shapes(kernels, dev) -> None:
    """K5 at ``k5_inputs``' shapes, with a checksum of its output bits so
    two trees' sums can be compared, ``torch.segment_reduce``'s time on
    the same clusters, and, for a tree with K5's regimes, the clusters
    each regime summed; first the one-thread DADD micro (ns an addition),
    and with it each shape's chain bound: its longest chain-regime
    cluster times that; and each launch's device time by the profiler,
    beside the host's time to enqueue a call."""
    import torch

    ns = None
    if hasattr(kernels, "dadd_chain_ns"):
        micro = kernels.dadd_chain_ns(dev)
        ns = micro["ns"]
        print(json.dumps({"kernel": "DADD", "shape": "one thread, dependent",
                          **micro}), flush=True)
    for name, v, off in k5_inputs(dev):
        sizes = torch.diff(off)
        res = {"kernel": "K5", "shape": name, "clusters": sizes.numel(),
               "largest": int(sizes.max())}
        if hasattr(kernels, "cluster_regimes"):
            kernels.reset_cluster_regimes()
        out = kernels.cluster_sums(v, off)
        res["bits_sum"] = int(out.view(torch.int64).sum())
        if hasattr(kernels, "cluster_regimes"):
            res["regimes"] = kernels.cluster_regimes()
            chain = kernels.cluster_regimes_plain(v, off) != 0
            res["chain_largest"] = int(sizes.cpu()[chain].max()) \
                if bool(chain.any()) else 0
            if ns is not None:
                res["chain_bound_ms"] = res["chain_largest"] * ns * 1e-6
        res["kernel_ms"] = cuda_ms(lambda: kernels.cluster_sums(v, off), 20)
        res["segment_reduce_ms"] = cuda_ms(
            lambda: torch.segment_reduce(v, "sum", lengths=sizes), 20)
        res.update(device_us_by_kernel(
            lambda: kernels.cluster_sums(v, off), 10))
        print(json.dumps(res), flush=True)
        del out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose pinot_tpu_torch is timed")
    ap.add_argument("--rows", type=int, default=N)
    ap.add_argument("--k5-only", action="store_true", help="time K5 alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import hll as hll_ops
    from pinot_tpu_torch.ops import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels.build_all()
    split = hasattr(kernels, "PlaneSource")  # the kernels split in registers
    dev = torch.device("cuda", 0)
    n = args.rows
    if args.k5_only:
        k5_shapes(kernels, dev)
        print(json.dumps({"ok": True, "root": args.root, "card": card}))
        return 0
    gen = torch.Generator(device=dev).manual_seed(11)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32,
                             device=dev)

    rev = ints(1000, 6_000_000)
    qty = ints(1, 51).to(torch.uint8)
    fv = torch.rand((n,), generator=gen, device=dev) * 8
    iv = ints(0, 65536)
    end = torch.rand((n,), generator=gen, device=dev) < 0.05
    pw = torch.exp2(torch.randint(0, 12, (n,), generator=gen,
                                  device=dev).float())
    lo = torch.rand((n,), generator=gen, device=dev) < 0.5
    hll_ch = [end.to(torch.bfloat16),
              torch.where(end & lo, pw, 0.0).to(torch.bfloat16),
              torch.where(end & ~lo, pw, 0.0).to(torch.bfloat16)]
    del end, pw, lo
    h = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < 3 / 11
    gids = {G: ints(0, G + 1) for G in (35, 2000, 6240, 1024)}

    def off(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    # K1 shapes: (name, G, entry, count, [(values, kind, nplanes, offset)])
    k1 = [("q1", 2000, "ps", True, [(rev, "int", 3, 1000)]),
          ("q5", 35, "ps", True, [(rev, "int", 3, 1000)]),
          ("q4_no_hll", 2000, "ps", True, [(qty, "int", 1, 1)]),
          ("wide", 6240, "ps", True, [(fv, "float", 3, None),
                                      (iv, "int", 2, 0)]),
          ("sorted_hll", 2000, "mm", False, [(c, "bf16", 1, None)
                                             for c in hll_ch])]
    for name, G, entry, count, specs in k1:
        gid = gids[G]
        if split:
            srcs = [kernels.PlaneSource(v, kind, k, minus=None if o is None
                                        else off(o))
                    for v, kind, k, o in specs]
            fn = ps.plane_group_sums if entry == "ps" else mm.group_sums

            def call():
                return fn(gid, srcs, G, count=count)
            build = None
        else:
            def build():
                chans = [torch.ones(n, dtype=torch.bfloat16,
                                    device=dev)] if count else []
                for v, kind, k, o in specs:
                    chans += mm.int_planes(v.to(torch.int32), off(o), k) \
                        if kind == "int" else mm.float_planes(v) \
                        if kind == "float" else [v]
                ch = torch.empty((len(chans), n), dtype=torch.bfloat16,
                                 device=dev)
                for r, c in enumerate(chans):
                    ch[r].copy_(c)
                return ch
            ch = build()
            fn = ps.plane_group_sums if entry == "ps" else mm.group_sums

            def call():
                return fn(gid, ch, G, first_channel_ones=count)
        res = {"kernel": "K1", "shape": name, "split_in_kernel": split,
               "kernel_ms": cuda_ms(call, 20)}
        # the sorted build's bf16 channels are made the same way before
        # and after: nothing absorbed there
        res["absorbed_ms"] = cuda_ms(build, 5) \
            if build is not None and name != "sorted_hll" else 0.0
        res["total_ms"] = res["kernel_ms"] + res["absorbed_ms"]
        print(json.dumps(res), flush=True)
        if not split:
            del ch
        torch.cuda.empty_cache()

    # K3 shapes: (name, G, entry)
    for name, G, entry in (("scalar_1024_masked", 1, "ps"),
                           ("group_35840", 35, "mm"),
                           ("group_2^20", 1024, "kernels")):
        gid = gids[G] if G > 1 else None
        m = mask if G == 1 else None
        if split:
            call = {"ps": lambda: ps.hll_register_max(h, LOG2M, mask=m),
                    "mm": lambda: mm.hll_registers(h, gid, G, LOG2M),
                    "kernels": lambda: kernels.hll_register_max(
                        h, LOG2M, G, gid=gid)}[entry]
            build = None
        else:
            def build():
                idx, rho = hll_ops.hll_idx_rho(h, LOG2M)
                slot = idx if gid is None else gid * (1 << LOG2M) + idx
                keep = m if m is not None else gid < G
                return torch.where(keep, slot, G << LOG2M), rho
            slot, rho = build()
            call = {"ps": lambda: ps.hll_register_max(slot, rho, 1 << LOG2M),
                    "mm": lambda: mm.hll_registers(slot, rho, G, LOG2M),
                    "kernels": lambda: kernels.hll_register_max(
                        slot, rho, G << LOG2M)}[entry]
        res = {"kernel": "K3", "shape": name, "split_in_kernel": split,
               "kernel_ms": cuda_ms(call, 20),
               "absorbed_ms": cuda_ms(build, 5) if build else 0.0}
        res["total_ms"] = res["kernel_ms"] + res["absorbed_ms"]
        print(json.dumps(res), flush=True)
    del gids, h, mask, hll_ch, fv, iv
    torch.cuda.empty_cache()
    k2_q6(ps, kernels, n, dev)
    k4_shapes(ps, kernels, n, dev)
    if hasattr(kernels, "cluster_sums"):
        k5_shapes(kernels, dev)
    print(json.dumps({"ok": True, "root": args.root, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
