"""Mesh-parallel execution: the segment axis sharded over devices.

Counterpart of pinot_tpu/parallel/mesh.py. The reference is one
controller: a single process ``shard_map``s a batch's segment axis over a
``jax.sharding.Mesh`` and merges the shards' accumulators with XLA
collectives. So is this: one process drives every shard. A ``Mesh`` is a
list of ``torch.device``s (``cuda:0 … cuda:{n-1}`` on a machine with n
cards, ``[cpu] * 8`` in the CPU tests, the same card several times where
one card stands in for several); engine/device.py splits a batch's
segments over them as the reference's ``pad_to_multiple`` lays them out
(``shard_slices``: the segment axis padded to a multiple of the mesh,
each shard a contiguous run, the padding segments absent), builds each
shard's planes on its own device from its own segments (engine/params.py
``ShardContext``, the batch's global dictionaries and width plans
shared), runs the solo pipeline, kernels included, on each, and combines
here:

- sums, counts and ``doc_count`` add, ``_min`` takes the minimum,
  ``_max`` / ``_pres`` / ``_regs`` the maximum, ``seg_matched`` is the
  shards' vectors end to end (the batch's (S,));
- FIRST/LASTWITHTIME's (time, value) pair combines as one: the winning
  time, then the largest value among the shards at it (engine/aggspec.py
  ``FirstLastWithTimeSpec``'s tie rule);
- the sorted regime's keyed tables merge by key (ops/radix_groupby.py
  ``merge_tables``) into a D·K table, its total forced past K where any
  shard's table overflowed, so the fetch re-runs the query as the single
  device does (``_combine_sorted_table``).

Each shard's answer-sized accumulators are copied to the mesh's first
device, where the combine runs; float sums add there in float64, as the
reference's outer reduce does. Terminal finalize (registers → estimates)
and the device trim (ops/device_reduce.py) run after the combine, on the
combined tables. Group-by accumulators live in global dictionary id
space, so the dense combine is elementwise: no key exchange.

``check_placement`` holds every tensor a shard reads to that shard's
device: a stray tensor on the first card goes unnoticed on a mesh of one
card repeated, and fails only across several.
"""

from __future__ import annotations

import math

import torch

SEG_AXIS = "segments"


class Mesh:
    """A 1-D mesh over the segment axis: the devices, in shard order (a
    device may appear more than once)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def key(self) -> tuple:
        """The mesh in cache keys: its devices, in order."""
        return tuple(str(d) for d in self.devices)

    def __repr__(self) -> str:
        return f"Mesh({list(self.key)}, axis={SEG_AXIS!r})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the segment axis: ``devices`` as given, else the
    visible cards (``cuda:0 … cuda:{n-1}``, the first ``n_devices``), else,
    without a card, ``n_devices`` (default 1) shards on the CPU."""
    if devices is not None:
        return Mesh(devices)
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"make_mesh({n}): only {count} cards are "
                             f"visible; pass devices= to repeat one")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    return Mesh([torch.device("cpu")] * (n_devices or 1))


def shard_slices(S: int, D: int) -> list:
    """(lo, hi) segment ranges of each shard: the segment axis padded to a
    multiple of D (the reference's ``pad_to_multiple``) and cut into D
    equal runs; a run past S is empty (padding only)."""
    per = max(1, math.ceil(S / D))
    return [(min(d * per, S), min((d + 1) * per, S)) for d in range(D)]


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (a CUDA device without an index is the
    current one; the CPU has one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def check_placement(shard: int, device, tensors: dict) -> None:
    """Every tensor of ``tensors`` must sit on the shard's device."""
    for k, t in tensors.items():
        if isinstance(t, torch.Tensor) and not same_device(t.device, device):
            raise AssertionError(
                f"mesh shard {shard}: {k!r} is on {t.device}, not on the "
                f"shard's device {device}")


def shard_params(params: dict, lo: int, hi: int, device) -> dict:
    """One shard's params: the per-segment ones (``ps`` prefix, e.g. the
    Level-1 ``ps_alive`` vector) cut to its segments, every other one
    (literals, LUTs, the batch's ``fo::`` offsets) replicated, all on the
    shard's device."""
    return {k: (v[lo:hi] if k.startswith("ps") else v).to(device)
            for k, v in params.items()}


def _max(vs: list) -> torch.Tensor:
    st = torch.stack(vs)
    return st.any(0) if st.dtype == torch.bool else st.amax(0)


def _min(vs: list) -> torch.Tensor:
    st = torch.stack(vs)
    return st.all(0) if st.dtype == torch.bool else st.amin(0)


def _sum(vs: list) -> torch.Tensor:
    st = torch.stack(vs)
    if st.is_floating_point():
        return st.to(torch.float64).sum(0).to(st.dtype)
    return st.sum(0, dtype=st.dtype)


def combine_outs(outs_list: list, aggs, dest) -> dict:
    """The shards' pipeline outputs (``outs_list`` in shard order) → one
    dict on ``dest``: the reference's ``_combine_outs``."""
    outs_list = [{k: v.to(dest) for k, v in o.items()} for o in outs_list]
    if len(outs_list) == 1:
        return outs_list[0]
    if "skeys" in outs_list[0]:
        return _combine_sorted_table(outs_list)
    first = {f"a{i}" for i, (name, _a, _e) in enumerate(aggs)
             if name == "firstwithtime"}
    last = {f"a{i}" for i, (name, _a, _e) in enumerate(aggs)
            if name == "lastwithtime"}
    combined = {}
    for k in outs_list[0]:
        vs = [o[k] for o in outs_list]
        base = k.rsplit("_", 1)[0]
        if k == "seg_matched":
            combined[k] = torch.cat(vs)
        elif base in first or base in last:
            if k.endswith("_t"):
                continue
            combined[base + "_t"], combined[k] = _time_pair(
                [o[base + "_t"] for o in outs_list], vs, base in first)
        elif k.endswith("_min"):
            combined[k] = _min(vs)
        elif k.endswith(("_max", "_pres", "_regs")):
            combined[k] = _max(vs)
        else:   # doc_count, gcount, n_alive, the block counts, *_sum
            combined[k] = _sum(vs)
    return combined


def _time_pair(ts: list, vs: list, is_first: bool) -> tuple:
    """FIRST/LASTWITHTIME across shards: the global winning time, then the
    largest value among the shards that hold it (a shard's value at its
    own winning time is already its largest non-NaN one; -inf or
    INT64_MIN where it has none)."""
    from pinot_tpu_torch.ops import agg as agg_ops

    t, v = torch.stack(ts), torch.stack(vs)
    tg = t.amin(0) if is_first else t.amax(0)
    nw = torch.full((), agg_ops._no_winner(v), dtype=v.dtype,
                    device=v.device)
    return tg, torch.where(t == tg, v, nw).amax(0)


def _combine_sorted_table(outs_list: list) -> dict:
    """The sorted regime's KEYED tables: each shard's (K,) table holds its
    groups in slots keyed by ``skeys``, so a group sits in different
    slots on different shards. The (D, K) tables merge by key
    (``merge_tables``) into a D·K table: merged distinct groups may
    outnumber any one shard's table. Where a shard's table overflowed (its
    total past K, its table truncated) the merged total is forced past K,
    so the fetch re-runs the query in the host path's shape as the single
    device does."""
    from pinot_tpu_torch.ops import radix_groupby as radix_ops
    from pinot_tpu_torch.ops.device_reduce import STAT_KEYS

    stat_keys = STAT_KEYS | {"skeys"}
    skeys = torch.stack([o["skeys"] for o in outs_list])
    D, K = skeys.shape
    reds, cols = {}, {}
    for k in outs_list[0]:
        if k in stat_keys:
            continue
        reds[k] = "min" if k.endswith("_min") \
            else "max" if k.endswith("_max") else "sum"
        cols[k] = torch.stack([o[k] for o in outs_list])
    merged, fk, empty, merged_distinct = radix_ops.merge_tables(
        skeys, cols, reds, D * K)
    totals = torch.stack([o["n_groups_total"] for o in outs_list])
    overflow = torch.where(totals > K, totals, 0).amax()
    combined = {
        "doc_count": _sum([o["doc_count"] for o in outs_list]),
        "seg_matched": torch.cat([o["seg_matched"] for o in outs_list]),
        "skeys": torch.where(empty, radix_ops.INT64_SENTINEL, fk),
        "n_groups_total": torch.maximum(merged_distinct, overflow),
    }
    for k in ("n_alive", "rows_filter", "blocks_total", "blocks_scanned"):
        if k in outs_list[0]:
            combined[k] = _sum([o[k] for o in outs_list])
    combined.update(merged)
    return combined

