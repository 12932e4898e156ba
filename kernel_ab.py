#!/usr/bin/env python3
"""Time the port's K1 and K3 at chip_smoke.py's main-path shapes, for an
A/B of two trees on one card.

    python3 kernel_ab.py                     # this checkout's kernels
    python3 kernel_ab.py --root OTHER_TREE   # another checkout's

K1 (group plane sums) and K3 (HLL register max) changed their inputs:
before, K1 read an (A, n) bf16 channel tensor that torch ops built from
the stored planes, and K3 read int32 slot and rank tensors that torch
ops split from the hash plane; now both read the stored planes and split
in registers. For a tree of the former kind this times the kernel on
prebuilt operands and, apart, the torch ops that build them ("absorbed",
the same ops engine/device.py ran before each launch); for the latter
the kernel alone. Inputs come from fixed torch.Generator seeds, so both
trees see the same rows. CUDA-event means over 20 calls after a warm-up.
Prints the card line and one JSON object per shape, then
{"ok": true, ...} last. Run the trees in turns (A, B, B, A) in one call
to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N = 8 * 12_500_992   # chip_smoke.py's 8 segments x 12,500,992 padded rows
LOG2M = 10


def cuda_ms(fn, reps: int = 20) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose pinot_tpu_torch is timed")
    ap.add_argument("--rows", type=int, default=N)
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
               "kernel_ms": cuda_ms(call)}
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
               "kernel_ms": cuda_ms(call),
               "absorbed_ms": cuda_ms(build, 5) if build else 0.0}
        res["total_ms"] = res["kernel_ms"] + res["absorbed_ms"]
        print(json.dumps(res), flush=True)
    print(json.dumps({"ok": True, "root": args.root, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
