"""Device query executor on torch: one pipeline over the whole (S, L)
segment batch,

    filter masks → global-id group keys → dense aggregation

counterpart of pinot_tpu/engine/device.py. The template (literals
parameterized out, as in the reference) is evaluated eagerly as torch ops
on CUDA tensors; there is no compile step to cache. Group-by runs in
global dictionary id space (engine/params.py), so the dense (G,)
accumulator is the ARRAY_BASED group-key regime and its merge at once.

Dense COUNT/SUM/AVG route through the group plane-sum kernel K1,
MIN/MAX/MINMAXRANGE through the group min/max kernel K2 and the
DISTINCTCOUNTHLL register builds through the register-max kernel K3
(ops/group_scatter.py, ops/groupby_mm.py), with the reference's
pallas-tier routing and minimum batch; other shapes use the torch
scatters of ops/agg.py where the reference uses XLA's.

DISTINCTCOUNTHLL and the DISTINCTCOUNT family run over dict columns: a
presence vector over global ids, and HLL registers from per-doc hashes
computed at upload. A TERMINAL launch (``final``: nothing merges after
it, as for ``QueryEngine.execute``) finalizes them on the card —
popcounts and estimates instead of G x C presence or G x m registers —
and builds large-G HLL register-free from sorted keys
(``_hll_sorted_sums``); a non-terminal launch returns the mergeable
presence sets and registers.

Pruning, as in the reference. Level 1: ``SegmentPruner`` (engine/engine.py)
proves segments empty from their metadata at launch; they stay in the
batch, dead (the ``ps_alive`` param), and a fully pruned launch runs
nothing on the card. Level 2: a filter with interval structure takes the
zone-map block skip (ops/blockskip.py): per-block verdicts over the
batch's zone maps, the candidate blocks compacted under a static bound,
then either the generic gathered form (filter + aggregation over the
(B, R) candidate rows) or, for scalar templates in its surface, the fused
filter + gather + aggregate kernel K4 (ops/group_scatter.py). Where the
reference branches on the device (``lax.cond``), the port reads the
candidate count to the host, one scalar sync, and runs the dense form
when it overflows the bound.

HLLMERGE re-merges a star-tree cube's register planes (a fixed-width
BYTES dict column, uploaded as an (S, L, m) uint8 plane) by a
scatter-max, as the reference leaves it to XLA. A launch that is the sole
partial of its query (``reduce_mode``) trims a group-by to its ORDER BY's
top rows on the card (ops/device_reduce.py), so the fetch copies those
rows only; all leaves come to the host in one copy.

FIRSTWITHTIME / LASTWITHTIME run as torch scatters (a scatter-min or
-max of the times, then a scatter-max of the values at the winning time),
as the reference leaves them to XLA. DISTINCT over dict columns is the
group machinery with no aggregation: presence is the count channel (K1).

A dict group-by whose key space passes ``MAX_DENSE_GROUPS`` takes the
reference's sorted high-cardinality regime (``groupby_sorted``) when
every aggregation is in ``SORTED_AGGS``: packed keys, chunked sorts and
run-end partials (ops/radix_groupby.py) into a keyed (K,) table, K =
min(numGroupsLimit, ``MAX_SORTED_GROUPS``), which the device trim
orders like a dense one.

``launch`` decides the shape first (``host_shape``): the reference's
device template, or, where the reference's device refuses a shape and
its host path answers it (selection, DISTINCT over other columns, group
keys over expressions, raw or virtual columns, DISTINCTCOUNT and
DISTINCTCOUNTHLL over raw columns, the sketches and the star-tree's
merge aggregations), that path's shape, still on the card
(engine/rows.py). Where the reference leaves its device at fetch time,
the fetch does too, on a count the launch made: a sorted table holding
more groups than K, or a trimmed table more present groups than
numGroupsLimit keeps; the query then runs again in the host path's
shape on the card, whose per-segment numGroupsLimit the reference's
host applies. There is no fallback ladder: a device or kernel error
propagates to the caller.

``launch`` returns an ``InflightLaunch`` (engine/inflight.py): the
pipeline's ops and kernels and ONE copy of the packed leaves into pinned
host memory are enqueued on the current stream, and the handle's
``fetch`` waits on CUDA events, first for the launch's last kernel, then
for the copy. The executor's RLock guards the batch LRU, the pins a
launch holds on its batch until its fetch or release, the counters and
the caches. Under pressure, launches of one cohort key run as one
launch per kernel (``LaunchCoalescer``, engine/cohort.py). A repeat of a
solo launch copies its cached packed buffer again and runs nothing (the
device partials cache). Each launch in the reference's device shape
carries a roofline flight: its modeled bytes over its kernel time
against the probed memory peak (ops/roofline.py).

A batch takes segments the reference's device takes
(``segment_device_eligible``): sealed, without an upsert valid-docs
mask; a consuming segment's clean chunklets form a batch of their own.
The parts the reference answers on its host (a consuming segment's tail
or the whole segment, an upsert-dirtied chunklet, an upsert-masked
sealed segment) launch alone through ``launch_host_part``, in the host
path's shape with a valid-docs plane snapshot at launch; a part without
a directory builds a context that neither enters the batch LRU nor
caches partials. Promotion, an upsert that dirties a chunklet and a
seal drop the cached partials of the batches they retire
(``invalidate_cached_partials``, reached from realtime/chunklet.py).

With a ``mesh`` (parallel/mesh.py) the executor shards every batch's
segment axis over the mesh's devices, as the reference's
``shard_pipeline`` does: each shard's planes live on its device
(``params.ShardContext``), each shard runs the solo pipeline, kernels
included, with the template's finalize left out, and the accumulators
combine on the mesh's first device (``mesh.combine_outs``) before the
finalize and the trim; a cohort runs its member-axis launch per shard,
then a combine per member. The host path's shapes run on the first
device, as the reference answers them off its mesh, and a part launched
alone on the device its directory hashes to.
"""

from __future__ import annotations

import hashlib
import math
import os
import threading
import time
import weakref

import numpy as np
import torch

from pinot_tpu_torch import resolve_device
from pinot_tpu_torch.common.metrics import get_metrics
from pinot_tpu_torch.common.options import bool_option
from pinot_tpu_torch.common.trace import span
from pinot_tpu_torch.engine import aggspec, cohort, rows
from pinot_tpu_torch.engine.inflight import InflightLaunch, LaunchCoalescer
from pinot_tpu_torch.engine.params import (
    BatchContext,
    DeviceUnsupported,
    ShardContext,
    build_expr,
    build_filter,
    expr_bounds,
    expr_on_device,
    filter_on_device,
    stored_column,
    to_device,
)
from pinot_tpu_torch.engine.result import ExecutionStats, IntermediateResult
from pinot_tpu_torch.engine.snapshot import SnapshotSegment
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import blockskip as bs_ops
from pinot_tpu_torch.ops import device_reduce as dr_ops
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import hll as hll_ops
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops import masks as mask_ops
from pinot_tpu_torch.ops import radix_groupby as radix_ops
from pinot_tpu_torch.ops import selection as sel_ops
from pinot_tpu_torch.ops.transform import get_function
from pinot_tpu_torch.parallel import mesh as mesh_ops
from pinot_tpu_torch.query.context import Expression, QueryContext
from pinot_tpu_torch.storage.segment import Encoding, ImmutableSegment

DEVICE_AGGS = {"count", "sum", "min", "max", "avg", "minmaxrange",
               "distinctcount", "distinctcounthll", "hllmerge",
               "firstwithtime", "lastwithtime"}
# what the reference's sorted high-cardinality regime runs
SORTED_AGGS = ("count", "sum", "avg", "min", "max", "minmaxrange")
WITH_TIME_AGGS = ("firstwithtime", "lastwithtime")
SKETCH_AGGS = ("distinctcount", "distinctcounthll")
# aggregations whose state is per-group presence or registers: they
# finalize on the card in a terminal launch
STATE_AGGS = SKETCH_AGGS + ("hllmerge", "distinctcount_v")
# answered as DISTINCTCOUNT over a dict column, as in the reference
DISTINCTCOUNT_ALIASES = ("distinctcountbitmap",
                         "segmentpartitioneddistinctcount")

MAX_DENSE_GROUPS = 1 << 22        # ARRAY_BASED regime guard (~4M groups)
# the sorted regime's group-table cap (K = min(numGroupsLimit, this));
# a table that overflows K answers in the host path's shape
MAX_SORTED_GROUPS = 1 << 17
MAX_PRESENCE_CELLS = 1 << 24      # per-group distinct/HLL state guard


def segment_device_eligible(seg) -> bool:
    """Whether a segment rides a device batch (a copy of the reference's
    rule): sealed, without an upsert valid-docs mask, in the hot tier. A
    consuming segment re-enters through its chunklets
    (realtime/chunklet.py), which pass while clean; an upsert
    invalidation inside one gives it a mask, and it fails. The others run
    in the host path's shape (``DeviceExecutor.launch_host_part``)."""
    return not getattr(seg, "is_mutable", False) and \
        getattr(seg, "valid_docs_mask", None) is None and \
        (getattr(seg, "tier", None) or "hot") == "hot"


def valid_docs_snapshot(seg, n: int):
    """A copy of a segment's upsert valid-docs over its first ``n`` docs,
    or None when it has none: a sealed segment's or a dirty chunklet's
    ``valid_docs_mask``, a consuming segment's or a tail's
    ``valid_docs(n)``. Copied, as the reference's host copies it before
    it evaluates the filter: the writer flips it meanwhile."""
    vd = getattr(seg, "valid_docs_mask", None)
    if vd is not None:
        return np.asarray(vd)[:n].copy()
    if hasattr(seg, "valid_docs"):
        m = seg.valid_docs(n)
        return None if m is None else np.asarray(m)[:n].copy()
    return None


def _torch_dtype(np_str: str) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(np_str))).dtype


# ---------------------------------------------------------------------------
# template evaluation
# ---------------------------------------------------------------------------


def _ids_col(cols, key):
    """Dict-id plane widened to int32: literal ids and the group-id
    arithmetic must never wrap at a uint8/uint16 plane's width."""
    return cols[key].to(torch.int32)


def _data_col(cols, params, key, widths):
    """Raw / decoded (dv::) value plane DECODED to its plan's wide dtype:
    frame-of-reference planes add the per-batch "fo::<key>" offset. The
    plane stays narrow on the card; decoding always widens, so two narrow
    planes multiplied in an expression do not wrap."""
    v = cols[key]
    w = (widths or {}).get(key)
    if w is None or not w[3]:
        return v
    v = v.to(_torch_dtype(w[3]))
    if w[2]:
        v = v + params["fo::" + key]
    return v


def _eval_expr(tpl, cols, params, widths=None):
    kind = tpl[0]
    if kind == "lit":
        return params[tpl[1]]
    if kind == "raw":
        return _data_col(cols, params, tpl[1], widths)
    if kind == "val":  # computed in value space (engine/values.py)
        return params[tpl[1]]
    if kind == "dictval":
        # decoded on the host at upload (BatchContext.decoded_column)
        return _data_col(cols, params, "dv::" + tpl[1], widths)
    if kind == "cast":
        return get_function("cast").torch_fn(
            _eval_expr(tpl[1], cols, params, widths), tpl[2])
    fn = get_function(kind)
    args = [_eval_expr(a, cols, params, widths) for a in tpl[1:]]
    return fn.torch_fn(*args)


def eval_filter(tpl, cols, params, shape, device, widths=None):
    kind = tpl[0]
    if kind == "true":
        return torch.ones(shape, dtype=torch.bool, device=device)
    if kind == "false":
        return torch.zeros(shape, dtype=torch.bool, device=device)
    if kind == "mask":  # computed in value space (engine/rows.py)
        return params[tpl[1]]
    if kind in ("and", "or"):
        m = eval_filter(tpl[1], cols, params, shape, device, widths)
        for c in tpl[2:]:
            mc = eval_filter(c, cols, params, shape, device, widths)
            m = (m & mc) if kind == "and" else (m | mc)
        return m
    if kind == "not":
        return ~eval_filter(tpl[1], cols, params, shape, device, widths)
    if kind == "mv_any":
        # per-entry mask over the (S, L, K) id block, the -1 padding masked
        # out, reduced match-any over K
        ids = cols[tpl[1]]
        m = eval_filter(tpl[2], cols, params, ids.shape, device, widths)
        return (m & (ids >= 0)).any(dim=-1)
    if kind == "eq_dict":
        return mask_ops.eq_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "in_dict":
        return mask_ops.in_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "range_dict":
        return mask_ops.range_dict(
            _ids_col(cols, tpl[1]), params[tpl[2]], params[tpl[3]])
    if kind == "lut_dict":
        return mask_ops.lut_dict(_ids_col(cols, tpl[1]), params[tpl[2]])
    if kind == "eq_raw":
        return mask_ops.eq_raw(
            _eval_expr(tpl[1], cols, params, widths), params[tpl[2]])
    if kind == "in_raw":
        return mask_ops.in_raw(
            _eval_expr(tpl[1], cols, params, widths), params[tpl[2]])
    if kind == "range_raw":
        _, expr_tpl, klo, khi, has_lo, has_hi, lo_inc, hi_inc = tpl
        return mask_ops.range_raw(
            _eval_expr(expr_tpl, cols, params, widths), params[klo],
            params[khi], lo_inc, hi_inc, has_lo, has_hi,
        )
    raise AssertionError(f"bad filter template node {kind}")


def _bare_key(argt):
    """The cols key of an aggregate argument that is a bare column
    (``raw`` / ``dictval``), else None (an expression or a literal)."""
    if argt[0] == "raw":
        return argt[1]
    if argt[0] == "dictval":
        return "dv::" + argt[1]
    return None


def _sum_operand(argt, cols, params, widths):
    """(values, FOR offset or None) of one SUM/AVG argument for K1: a bare
    column's plane AS STORED, with the frame-of-reference offset
    ``_data_col`` would add (K1 adds it in registers; the offset stays on
    the card), or an expression evaluated as torch ops."""
    key = _bare_key(argt)
    if key is not None and key in cols:
        w = (widths or {}).get(key)
        return cols[key], (params["fo::" + key] if w and w[3] and w[2]
                           else None)
    return _eval_expr(argt, cols, params, widths), None


def _kernel_operand(v, gid, members: bool):
    """A value operand as K1 / K2 take it, contiguous: at the rows' shape
    (``gid``'s), e.g. SUM(3) broadcast; in a cohort the plane every
    member shares (``gid.shape[1:]``) or each member's own rows
    (``gid.shape``)."""
    if members and tuple(v.shape) == tuple(gid.shape) and v.is_contiguous():
        return v
    rows = gid.shape[1:] if members else gid.shape
    if tuple(v.shape) != tuple(rows) or not v.is_contiguous():
        v = torch.broadcast_to(v, rows).contiguous()
    return v


def members_scatter(fn, ids, num_slots: int, *values):
    """One of ops/agg.py's scatters, ``fn(ids, *values, num_slots)``, for
    a cohort: member m's (M, ...) ids land in its own ``num_slots + 1``
    slots (its overflow slot last) of one table, after member m - 1's;
    values shared by the members broadcast to the ids' shape. Returns
    (M, num_slots)."""
    M = ids.shape[0]
    width = num_slots + 1
    off = torch.arange(M, dtype=torch.int64, device=ids.device) * width
    flat = ids.reshape(M, -1).to(torch.int64) + off[:, None]
    vals = [torch.broadcast_to(v, ids.shape).reshape(M, -1) for v in values]
    return fn(flat, *vals, M * width).reshape(M, width)[:, :num_slots]


def _try_mm_groupby(aggs, gid, cols, params, num_groups, outs, widths,
                    min_rows: int, members: bool = False):
    """Route COUNT/SUM/AVG through ONE K1 launch when eligible: the
    partitioned entry (ops/group_scatter.py plane_group_sums) when
    ``sums_supported``, else the single-accumulator entry
    (ops/groupby_mm.py group_sums) when ``mm_supported`` — the reference's
    pallas-tier routing. K1 reads each bare column's plane as stored and
    splits it in registers: no channel tensor is built. Fills
    outs["gcount"] + outs[f"a{i}_sum"] and returns the set of agg indexes
    handled; the torch scatters cover the rest.

    ``members``: a cohort's launch (engine/cohort.py): ``gid`` is (M,
    ...), each member's own ids, ``params`` hold each member's offsets
    on a leading axis, K1 runs ONCE for the M members through its
    member-axis entry, and the outputs gain the leading axis."""
    if (gid[0].numel() if members else gid.numel()) < min_rows:
        return set()
    plans = []  # (i, PlaneSource)
    total_ch = 1  # the count channel
    for i, (name, argt, extra) in enumerate(aggs):
        if name not in ("sum", "avg"):
            continue
        nplanes_int = extra[0]  # extra = (nplanes, rows per block)
        v, plus = _sum_operand(argt, cols, params, widths)
        v = _kernel_operand(v, gid, members)
        if v.is_floating_point():
            src = kernels.PlaneSource(v.to(torch.float32), "float")
        elif nplanes_int is None:  # unknown range → exact scatter instead
            continue
        else:
            if v.dtype not in kernels.K1_INT_DTYPES:
                v = v.to(torch.int64)
            src = kernels.PlaneSource(v, "int", nplanes_int, plus,
                                      params[f"off{i}"])
        if total_ch + src.nplanes > mm.MAX_CHANNELS + 1:
            continue
        plans.append((i, src))
        total_ch += src.nplanes
    use_ps = ps.sums_supported(num_groups, total_ch)
    if not use_ps and not mm.mm_supported(num_groups, total_ch - 1):
        return set()
    # every group-by takes its counts here, even one that aggregates none
    # (DISTINCT's presence is the count): few groups would contend in a
    # histogram

    srcs = [src for _i, src in plans]
    if members:
        entry = ps.plane_group_sums_members if use_ps \
            else mm.group_sums_members
        sums = entry(gid.reshape(gid.shape[0], -1), srcs, num_groups,
                     count=True)
    else:
        entry = ps.plane_group_sums if use_ps else mm.group_sums
        sums = entry(gid.reshape(-1), srcs, num_groups, count=True)
    # (A, G), or (M, A, G) for a cohort: the channels are the middle axis
    gcount = torch.round(sums[..., 0, :]).to(torch.int64)
    outs["gcount"] = gcount
    done = set()
    row = 1
    for i, src in plans:
        planes = [sums[..., j, :] for j in range(row, row + src.nplanes)]
        if src.kind == "int":
            off = params[f"off{i}"]
            outs[f"a{i}_sum"] = mm.recombine_int(
                planes, gcount, off[:, None] if members else off)
        else:
            outs[f"a{i}_sum"] = mm.recombine_float(planes)
        done.add(i)
        row += src.nplanes
    return done


def _minmax_operand(argt, cols, params, widths):
    """(values, FOR offset or None, decoded dtype, source key) of one
    MIN/MAX argument for K2: a bare column's plane AS STORED with the
    frame-of-reference offset and wide dtype ``_data_col`` would decode it
    to (K2 decodes in registers; the offset stays on the card), or an
    expression evaluated as torch ops. Arguments with one source key read
    one plane."""
    key = _bare_key(argt)
    if key is not None and key in cols:
        v = cols[key]
        w = (widths or {}).get(key)
        if w is None or not w[3]:
            return v, None, v.dtype, key
        return (v, params["fo::" + key] if w[2] else None,
                _torch_dtype(w[3]), key)
    v = _eval_expr(argt, cols, params, widths)
    return v, None, v.dtype, argt


def _group_extremes(aggs, gid, cols, params, num_groups: int, outs, widths,
                    min_rows: int, members: bool = False) -> None:
    """Per-group MIN / MAX / MINMAXRANGE of every aggregate: the ones in
    K2's regime (decoded dtype and group count, ``minmax_supported``, and
    the batch at ``min_rows``) through ONE launch of K2
    (ops/group_scatter.py group_minmax_sources), one source per distinct
    argument with the union of its ops; the rest through the torch
    scatters. Empty-group fills are the decoded dtype's extremes on both
    paths, so results are bit-identical. Fills outs[f"a{i}_{op}"].
    ``members``: a cohort's launch, as ``_try_mm_groupby`` takes it: one
    launch of K2's member-axis entry for the M members."""
    rows = gid[0].numel() if members else gid.numel()
    wanted = []     # (agg index, ops, source key)
    srcs = {}       # source key -> [values, plus, dtype, ops]
    for i, (name, argt, _extra) in enumerate(aggs):
        if name not in ("min", "max", "minmaxrange"):
            continue
        ops = ("min", "max") if name == "minmaxrange" else (name,)
        v, plus, dt, key = _minmax_operand(argt, cols, params, widths)
        if ps.minmax_supported(num_groups, dt) and rows >= min_rows:
            src = srcs.setdefault(key, [_kernel_operand(v, gid, members),
                                        plus, dt, set()])
            src[3].update(ops)
            wanted.append((i, ops, key))
            continue
        if plus is not None or dt != v.dtype:
            v = _data_col(cols, params, key, widths)
        for op in ops:
            fn = agg_ops.group_min if op == "min" else agg_ops.group_max
            outs[f"a{i}_{op}"] = members_scatter(fn, gid, num_groups, v) \
                if members else fn(gid, v, num_groups)
    if not srcs:
        return
    keys = list(srcs)
    sources = []
    for key in keys:
        v, plus, dt, ops = srcs[key]
        ops = tuple(op for op in ("min", "max") if op in ops)
        if dt.is_floating_point:
            fills = tuple(agg_ops.POS_INF if op == "min" else agg_ops.NEG_INF
                          for op in ops)
        else:
            info = torch.iinfo(dt)
            fills = tuple(info.max if op == "min" else info.min for op in ops)
        sources.append(kernels.MinMaxSource(v, ops, fills, plus, dt))
    res = {}
    entry = ps.group_minmax_members if members else ps.group_minmax_sources
    for c0 in range(0, len(sources), kernels.K2_MAX_SOURCES):
        part = sources[c0:c0 + kernels.K2_MAX_SOURCES]
        got = entry(gid, part, num_groups)
        for key, s, r in zip(keys[c0:], part, got):
            res[key] = dict(zip(s.ops, r))
    for i, ops, key in wanted:
        for op in ops:
            outs[f"a{i}_{op}"] = res[key][op]


def _hll_regs(h, gid, mask, num_groups: int, log2m: int, min_rows: int,
              members: int = 0):
    """(num_groups, m) int8 HLL registers from the int32 hash plane ``h``,
    the group ids (None: one group) and the mask (None: ``gid`` carries
    it as the overflow id): K3 through the small-slot entry
    (ops/group_scatter.py, the reference's presence kernel) when the slot
    space is in its regime, else through the group entry
    (ops/groupby_mm.py hll_registers, the reference's rho-mode kernel) —
    both split the hashes in the kernel — else the torch scatter-max over
    ``hll_slots``; all the exact max of rho, so bit-identical. int8 holds
    every rho (<= 33 - log2m) and keeps the register plane a quarter of
    int32's size.

    ``members``: a cohort of that many queries: gid and mask are each
    member's own (M, ...), ``h`` the stored plane every member shares or
    each member's gathered rows (M, ...); one launch for all, registers
    (M, num_groups, m)."""
    m = 1 << log2m
    nslots = num_groups * m
    lead = (members,) if members else ()
    by = gid if gid is not None else mask   # each member's rows
    if (by[0].numel() if members else h.numel()) >= min_rows:
        if members:
            hk = h.reshape(-1) if h.dim() < by.dim() \
                else h.reshape(members, -1)
            gk = None if gid is None else gid.reshape(members, -1)
            mk = None if mask is None else mask.reshape(members, -1)
        if ps.hll_supported(nslots, mm.hll_nrho(log2m)):
            regs = ps.hll_register_max_members(
                hk, log2m, members, num_groups=num_groups, gid=gk,
                mask=mk) if members else ps.hll_register_max(
                h, log2m, num_groups=num_groups, gid=gid, mask=mask)
            return regs.reshape(lead + (num_groups, m)).to(torch.int8)
        if mm.hll_supported(num_groups, log2m):
            regs = mm.hll_registers_members(
                hk, gk, members, num_groups, log2m, mask=mk) if members \
                else mm.hll_registers(h, gid, num_groups, log2m, mask=mask)
            return regs.to(torch.int8)
    if members:
        h = torch.broadcast_to(h, by.shape)
    slot, rho = hll_ops.hll_slots(h, log2m, num_groups, gid, mask)
    regs = members_scatter(agg_ops.slot_max, slot, nslots, rho) \
        if members else agg_ops.slot_max(slot, rho, nslots)
    return regs.reshape(lead + (num_groups, m)).to(torch.int8)


def _hll_sums_from_sorted(sk, num_groups: int, log2m: int):
    """(3, G) float64 scaled register sums from SORTED packed keys
    (slot << 5 | rho): each slot's run ends at its max rho; three bf16
    power-of-two channels over the run ends go through ONE launch of K1's
    single-accumulator entry (ops/groupby_mm.py group_sums), which takes
    each as it is. See ops/hll.py ``estimate_from_sums_torch`` for why the
    sums are exact."""
    m = 1 << log2m
    rho_max = 33 - log2m
    split = rho_max // 2
    slot_s = sk >> 5
    e = torch.ones_like(slot_s, dtype=torch.bool)
    e[:-1] = slot_s[1:] != slot_s[:-1]
    valid = slot_s < num_groups * m  # masked rows pack the overflow slot
    e &= valid
    rho_s = (sk & 31).to(torch.float32)
    gid_s = torch.where(valid, slot_s >> log2m, num_groups).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=sk.device)
    chans = (e, torch.where(e & (rho_s <= split), torch.exp2(split - rho_s),
                            zero),
             torch.where(e & (rho_s > split), torch.exp2(rho_max - rho_s),
                         zero))
    return mm.group_sums(gid_s, [kernels.PlaneSource(c.to(torch.bfloat16),
                                                     "bf16") for c in chans],
                         num_groups)


def _hll_sorted_sums(slot, rho, num_groups: int, log2m: int):
    """TERMINAL-only register-free HLL build for group counts too large
    for the register kernel's regime: chunk-local sorts of packed
    (slot << 5 | rho) int32 keys dedupe (register, rank) pairs down to
    per-slot maxima (ops/radix_groupby.py hll_chunked_sorted_keys), then
    ``_hll_sums_from_sorted``. Not mergeable (one slot on two batches
    would count twice), hence terminal-only; filterless queries skip the
    sort through the batch's cached sorted projection
    (BatchContext.sorted_hll_keys)."""
    key = (slot.reshape(-1).to(torch.int32) << 5) \
        | rho.reshape(-1).to(torch.int32)
    sk = radix_ops.hll_chunked_sorted_keys(key, num_groups * (1 << log2m))
    return _hll_sums_from_sorted(sk, num_groups, log2m)


def _hll_sort_eligible(final: bool, num_groups: int, log2m: int) -> bool:
    """The reference's gate for the sorted terminal HLL build, shared by
    the pipeline and the executor's column resolution: terminal, past
    the register kernel's regime, packed keys fit int32, and the three
    sums fit K1's single accumulator."""
    m = 1 << log2m
    return (final and not mm.hll_supported(num_groups, log2m)
            and num_groups * m < (1 << 26)
            and mm.mm_supported(num_groups, 3))


def _finalize_sketch_outs(outs: dict, agg_tpls) -> None:
    """TERMINAL finalize on the card, in place: distinct presence →
    int64 popcounts, HLL registers or sorted sums → int64 estimates, so
    only answer-sized arrays are copied to the host."""
    for i, (name, _argt, extra) in enumerate(agg_tpls):
        k = f"a{i}"
        if name == "distinctcount":
            outs[f"{k}_cnt"] = outs.pop(f"{k}_pres").sum(dim=-1,
                                                          dtype=torch.int64)
        elif name == "distinctcounthll" and f"{k}_hs" in outs:
            outs[f"{k}_est"] = hll_ops.estimate_from_sums_torch(
                outs.pop(f"{k}_hs"), extra)
        elif name in ("distinctcounthll", "hllmerge"):
            regs = outs.pop(f"{k}_regs")
            est = hll_ops.estimate_torch(regs.reshape(-1, 1 << extra))
            outs[f"{k}_est"] = est[0] if regs.dim() == 1 else est


def with_time_partial(name: str, outs: dict, k: str, present):
    """The (time, value) leaves of FIRSTWITHTIME / LASTWITHTIME → the
    canonical {"val", "time"} partial: an empty group keeps the time
    sentinel and a NaN value, and -inf (no non-NaN winner) becomes NaN.
    Exact integer values (the host path's shape) become the host's
    object array of Python ints, None where a group is empty."""
    t = np.asarray(outs[f"{k}_t"]).reshape(-1).astype(np.int64)
    v = np.asarray(outs[f"{k}_v"]).reshape(-1)
    if present is not None:
        t, v = t[present], v[present]
    sentinel = agg_ops.INT64_MAX if name == "firstwithtime" \
        else agg_ops.INT64_MIN
    if v.dtype.kind in "iu":
        val = np.empty(len(v), dtype=object)
        val[:] = [None if tt == sentinel else int(x)
                  for tt, x in zip(t.tolist(), v.tolist())]
        return {"val": val, "time": t}
    v = v.astype(np.float64)
    return {"val": np.where((t == sentinel) | np.isneginf(v), np.nan, v),
            "time": t}


def _fused_params(plan, params, widths) -> dict:
    """K4's literals: id-space params as int32; raw-space params shifted
    into the plane's storage space (minus its "fo::" offset) and clipped
    to the storage dtype's range ±1, in int64 before the int32 cast —
    storage values are a strict subset, so every comparison survives."""
    out = {}
    for key, (ck, kindp) in plan.pred_params.items():
        p = params[key].reshape(-1)
        if kindp == "storage":
            w = widths[ck]
            p64 = p.to(torch.int64)
            if w[2] and "fo::" + ck in params:
                p64 = p64 - params["fo::" + ck].to(torch.int64)
            info = np.iinfo(np.dtype(w[0]))
            p = torch.clamp(p64, int(info.min) - 1, int(info.max) + 1)
        out[key] = p.to(torch.int32)
    return out


def _fused_outs(plan, ints, flts, params, widths, outs) -> None:
    """K4's per-candidate partials → the dense form's leaves, in place.
    K4 aggregates STORAGE values; decode applies at answer scale —
    Σ(v + fo) = Σv + fo·n and min(v + fo) = min(v) + fo are exact — and
    an empty int extreme takes the wide dtype's fill, so dtypes and
    values equal the dense form's."""
    dc = outs["doc_count"]
    for (i, op, ck, buf, slot, _fill) in plan.aggs:
        key = f"a{i}_{op}"
        w = widths[ck]
        wide = _torch_dtype(w[3] or w[0])
        fo = params.get("fo::" + ck) if w[2] else None
        if op == "sum":
            tot = ints[:, slot].to(torch.int64).sum()
            outs[key] = tot if fo is None else tot + fo.to(torch.int64) * dc
        elif buf == "int":
            col = ints[:, slot]
            red = (col.min() if op == "min" else col.max()).to(wide)
            if fo is not None:
                red = red + fo
            info = torch.iinfo(wide)
            empty = torch.full((), info.max if op == "min" else info.min,
                               dtype=wide, device=red.device)
            outs[key] = torch.where(dc > 0, red, empty)
        else:
            col = flts[:, slot]
            outs[key] = (col.min() if op == "min" else col.max()).to(wide)


def plan_fused(template, widths, blockskip: bool):
    """K4's plan for a template's block-skip form, or None where the
    generic gather form runs: scalar templates only, and K4 reads one
    zone block per candidate, so a retuned ZONE_BLOCK_ROWS must decline
    the plan, not read a prefix of every block."""
    shape, filter_tpl, _g, _c, aggs, _k, _final = template
    if blockskip and shape == "agg" \
            and bs_ops.BLOCK_ROWS == ps.FUSED_BLOCK_ROWS:
        return ps.plan_fused(filter_tpl, aggs, widths or {})
    return None


def build_pipeline(template, widths=None, min_rows: int = ps.PALLAS_MIN_ROWS,
                   blockskip: bool = False):
    """template → fn(cols, n_docs, params) → outputs dict of tensors.

    ``widths``: the batch's column width plan {cols key: ColPlan.sig()}.
    ``min_rows``: batches below this row count take the torch scatters
    instead of the kernels (the reference's PALLAS_MIN_ROWS gate; the CPU
    tests pass 0 to reach the kernels' plain versions, as the reference's
    interpret mode ignores its gate). ``blockskip``: the filter's zone
    maps ride in ``cols`` (``zlo::`` / ``zhi::`` keys) and the pipeline
    takes the block-skip forms while the candidates fit the bound.

    Every form emits the same stat leaves (``_stat_outs``) and agrees
    with the dense form exactly."""
    shape, filter_tpl, group_cols, group_cards, aggs, sorted_k, final = \
        template
    if shape not in ("agg", "groupby", "groupby_sorted"):
        raise DeviceUnsupported(f"pipeline shape {shape}")
    num_groups = math.prod(group_cards)
    fused_plan = plan_fused(template, widths, blockskip)

    def pipeline(cols, n_docs, params):
        # zone maps are (S, NB), sorted projections (sk::) 1-D and byte
        # planes (bp::) (S, L, W): any plane's leading axes give (S, L)
        data_cols = {k: v for k, v in cols.items()
                     if not k.startswith((bs_ops.ZLO, bs_ops.ZHI))}
        planes = [v for k, v in data_cols.items() if not k.startswith("sk::")]
        if filter_tpl[0] == "mask":   # engine/rows.py's value-space filter
            planes.append(params[filter_tpl[1]])
        S, L = planes[0].shape[:2]
        dev = n_docs.device
        alive = params.get("ps_alive")
        alive_b = torch.ones(S, dtype=torch.bool, device=dev) \
            if alive is None else alive.to(torch.bool)
        nd64 = n_docs.to(torch.int64)
        R = bs_ops.BLOCK_ROWS

        def _stat_outs(seg_matched, rows_filter, blocks_total,
                       blocks_scanned):
            return {
                "doc_count": seg_matched.sum(),
                "seg_matched": seg_matched,
                "n_alive": alive_b.sum(dtype=torch.int64),
                "rows_filter": rows_filter,
                "blocks_total": blocks_total,
                "blocks_scanned": blocks_scanned,
            }

        def _aggregate(rows_cols, mask, outs):
            if shape == "groupby_sorted":
                _sorted(rows_cols, params, mask, outs)
            elif shape == "groupby":
                _groupby(rows_cols, params, mask, outs)
            else:
                _scalar(rows_cols, params, mask, outs)
            if final:
                _finalize_sketch_outs(outs, aggs)
            return outs

        def dense(blocks_total):
            valid = mask_ops.valid_mask(n_docs, L) & alive_b[:, None]
            mask = eval_filter(filter_tpl, data_cols, params, (S, L), dev,
                               widths) & valid
            outs = _stat_outs(
                mask.sum(dim=1, dtype=torch.int64),
                torch.where(alive_b, nd64, 0).sum(), blocks_total,
                blocks_total)
            return _aggregate(data_cols, mask, outs)

        if not blockskip or L % R:
            return dense(torch.zeros((), dtype=torch.int64, device=dev))

        # ---- zone-map block skip (ops/blockskip.py) ----------------------
        NB = L // R
        blocks_total = torch.where(alive_b, (nd64 + R - 1) // R, 0).sum()
        verdict = bs_ops.zone_verdict(filter_tpl, cols, params, (S, NB),
                                      widths)
        block_start = torch.arange(NB, dtype=torch.int64, device=dev) * R
        verdict = verdict & (block_start[None, :] < nd64[:, None]) \
            & alive_b[:, None]
        flat = verdict.reshape(-1)
        B = bs_ops.cand_bound(S * NB)
        n_cand = flat.sum(dtype=torch.int64)
        # the reference picks the form on the device (lax.cond); eager
        # torch reads the candidate count to the host: one scalar sync
        if int(n_cand) > B:
            return dense(blocks_total)
        cand, cand_valid = bs_ops.compact_candidates(flat, B)
        seg_of = (cand // NB).long()
        block_row0 = (cand % NB).long() * R
        seg_slot = torch.where(cand_valid, seg_of, S)

        def seg_sums(block_matched):
            return torch.zeros(S + 1, dtype=torch.int64, device=dev) \
                .index_add_(0, seg_slot, block_matched)[:S]

        if fused_plan is not None and ps.fused_params_ok(fused_plan, params):
            # K4 (ops/group_scatter.py): the gather buffer of the generic
            # form never exists
            rows_in = torch.where(
                cand_valid, torch.clamp(nd64[seg_of] - block_row0, 0, R),
                0).to(torch.int32)
            ints, flts = ps.fused_filter_agg(
                cand, rows_in,
                {k: data_cols[k].reshape(S * NB, R) for k in fused_plan.cols},
                _fused_params(fused_plan, params, widths), fused_plan)
            outs = _stat_outs(seg_sums(ints[:, 0].to(torch.int64)),
                              rows_in.sum(dtype=torch.int64), blocks_total,
                              n_cand)
            _fused_outs(fused_plan, ints, flts, params, widths, outs)
            return outs
        row_idx = block_row0[:, None] \
            + torch.arange(R, dtype=torch.int64, device=dev)[None, :]
        rvalid = cand_valid[:, None] & (row_idx < nd64[seg_of][:, None])
        g_cols = {k: bs_ops.gather_blocks(v, cand, NB, R)
                  for k, v in data_cols.items()}
        mask = eval_filter(filter_tpl, g_cols, params, (B, R), dev,
                           widths) & rvalid
        outs = _stat_outs(seg_sums(mask.sum(dim=1, dtype=torch.int64)),
                          rvalid.sum(dtype=torch.int64), blocks_total, n_cand)
        return _aggregate(g_cols, mask, outs)

    def _group_hll(k, argt, log2m, gid, mask, cols, outs):
        sort = _hll_sort_eligible(final, num_groups, log2m)
        sk_key = f"sk::{argt}::{log2m}"
        if sort and filter_tpl == ("true",) and sk_key in cols:
            # filterless: the batch's cached sorted projection already
            # holds the packed keys, no per-query sort
            outs[f"{k}_hs"] = _hll_sums_from_sorted(cols[sk_key], num_groups,
                                                    log2m)
            return
        h = cols["hh::" + argt]
        if sort:
            slot, rho = hll_ops.hll_slots(h, log2m, num_groups, gid, mask)
            outs[f"{k}_hs"] = _hll_sorted_sums(slot, rho, num_groups, log2m)
        else:
            # gid carries the mask (masked rows hold the overflow id)
            outs[f"{k}_regs"] = _hll_regs(h, gid, None, num_groups, log2m,
                                          min_rows)

    def _sorted(cols, params, mask, outs):
        """The radix-partitioned high-cardinality regime (the MAP_BASED
        analog of DictionaryBasedGroupKeyGenerator): dense accumulators
        would not fit past MAX_DENSE_GROUPS, so the packed key rides
        ops/radix_groupby.py's chunked sorts into a keyed (K,) table,
        each distinct argument carried through the level-1 sort once.
        Empty slots hold each reduction's neutral fill, so tables from
        several devices merge exactly (``merge_tables``); the table is
        (K,) on every form, so it needs no padding (the reference's
        ``_pad_table``)."""
        per_col = [_ids_col(cols, c) for c in group_cols]
        key = radix_ops.pack_keys(per_col, group_cards, mask)
        payloads, pname_of = {}, {}
        sums, mins, maxs = set(), set(), set()
        for name, argt, _extra in aggs:
            if name == "count":
                continue
            if argt not in pname_of:
                v = torch.broadcast_to(
                    _eval_expr(argt, cols, params, widths), mask.shape)
                # integer arguments accumulate exactly in int64, floats
                # in float64 (widened after the sort gathers the rows)
                pname = f"p{len(payloads)}"
                pname_of[argt] = pname
                payloads[pname] = (v.reshape(-1), "float"
                                   if v.is_floating_point() else "int")
            pname = pname_of[argt]
            if name in ("sum", "avg"):
                sums.add(pname)
            if name in ("min", "minmaxrange"):
                mins.add(pname)
            if name in ("max", "minmaxrange"):
                maxs.add(pname)
        tbl = radix_ops.chunked_group_aggregate(
            key.reshape(-1), payloads, sums, mins, maxs, sorted_k)
        outs["n_groups_total"] = tbl["n_groups_total"]
        outs["skeys"] = tbl["skeys"]
        outs["gcount"] = tbl["gcount"]
        for i, (name, argt, _extra) in enumerate(aggs):
            if name == "count":
                continue
            pname = pname_of[argt]
            for op, wanted in (("sum", ("sum", "avg")),
                               ("min", ("min", "minmaxrange")),
                               ("max", ("max", "minmaxrange"))):
                if name in wanted:
                    outs[f"a{i}_{op}"] = tbl[f"{op}::{pname}"]

    def _groupby(cols, params, mask, outs):
        # columns are already global ids: the group key IS the column
        per_col = [cols[c] for c in group_cols]
        gid = agg_ops.group_ids_combine(per_col, group_cards, mask,
                                        num_groups)
        done = _try_mm_groupby(aggs, gid, cols, params, num_groups, outs,
                               widths, min_rows)
        if "gcount" not in outs:
            outs["gcount"] = agg_ops.group_count(gid, num_groups)
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if i in done or name == "count":
                continue
            if name == "distinctcount":
                sub = torch.clamp(_ids_col(cols, argt), 0, extra - 1)
                cell = torch.where(mask, gid * extra + sub, num_groups * extra)
                outs[f"{k}_pres"] = agg_ops.distinct_presence(
                    cell, num_groups * extra).reshape(num_groups, extra)
                continue
            if name == "distinctcounthll":
                _group_hll(k, argt, extra, gid, mask, cols, outs)
                continue
            if name == "hllmerge":
                # cube rows carry whole register planes: a scatter-max of
                # the (rows, m) planes into (G, m); rows are distinct
                # dimension combinations, so the work is answer-sized
                m = 1 << extra
                planes = cols["bp::" + argt].reshape(-1, m).to(torch.int32)
                idx = gid.reshape(-1, 1).to(torch.int64).expand(-1, m)
                regs = torch.zeros((num_groups + 1, m), dtype=torch.int32,
                                   device=planes.device)
                regs.scatter_reduce_(0, idx, planes, "amax")
                outs[f"{k}_regs"] = regs[:num_groups]
                continue
            if name in WITH_TIME_AGGS:
                outs[f"{k}_t"], outs[f"{k}_v"] = agg_ops.group_arg_time(
                    gid, _eval_expr(argt[0], cols, params, widths),
                    _eval_expr(argt[1], cols, params, widths), num_groups,
                    name == "firstwithtime", extra == "exact")
                continue
            if name == "distinctcount_v":
                # a value key plane (engine/rows.py): distinct (group,
                # value) pairs, counted per group when terminal (but for
                # STUNION, whose answer is the set)
                vk = cols[argt].reshape(-1)
                if final and extra != "sets":
                    outs[f"{k}_cnt"] = sel_ops.distinct_pair_counts(
                        gid.reshape(-1), vk, num_groups)
                else:
                    outs[f"{k}_pg"], outs[f"{k}_pv"] = sel_ops.distinct_pairs(
                        gid.reshape(-1), vk, num_groups)
                continue
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = agg_ops.group_sum(
                    gid, _eval_expr(argt, cols, params, widths), num_groups)
        _group_extremes(aggs, gid, cols, params, num_groups, outs, widths,
                        min_rows)

    def _scalar(cols, params, mask, outs):
        for i, (name, argt, extra) in enumerate(aggs):
            k = f"a{i}"
            if name == "count":
                continue  # doc_count reused
            if name == "distinctcount":
                sub = torch.clamp(_ids_col(cols, argt), 0, extra - 1)
                outs[f"{k}_pres"] = agg_ops.distinct_presence(
                    torch.where(mask, sub, extra), extra)
                continue
            if name == "distinctcounthll":
                outs[f"{k}_regs"] = _hll_regs(cols["hh::" + argt], None,
                                              mask, 1, extra, min_rows)[0]
                continue
            if name == "hllmerge":
                planes = cols["bp::" + argt].to(torch.int32)
                outs[f"{k}_regs"] = torch.where(
                    mask[..., None], planes, 0).amax(dim=(0, 1))
                continue
            if name in WITH_TIME_AGGS:
                outs[f"{k}_t"], outs[f"{k}_v"] = agg_ops.agg_arg_time(
                    _eval_expr(argt[0], cols, params, widths),
                    _eval_expr(argt[1], cols, params, widths), mask,
                    name == "firstwithtime", extra == "exact")
                continue
            if name == "distinctcount_v":
                vk = cols[argt][mask]
                if final and extra != "sets":
                    outs[f"{k}_cnt"] = torch.tensor(
                        torch.unique(vk).numel(), dtype=torch.int64,
                        device=vk.device)
                else:
                    outs[f"{k}_pv"] = torch.unique(vk)
                continue
            v = _eval_expr(argt, cols, params, widths)
            if name in ("sum", "avg"):
                outs[f"{k}_sum"] = agg_ops.agg_sum(v, mask)
            if name in ("min", "minmaxrange"):
                outs[f"{k}_min"] = agg_ops.agg_min(v, mask)
            if name in ("max", "minmaxrange"):
                outs[f"{k}_max"] = agg_ops.agg_max(v, mask)

    return pipeline


def _neutral_outs(pipeline, cols, params, S: int) -> dict:
    """Outputs of a FULLY pruned launch, computed on the host: the dense
    form over one row of the batch with every segment dead gives each
    leaf the exact fill the card's kernels give under an all-false mask;
    ``seg_matched`` widens back to the batch's S segments."""
    one = {k: v[:1, :1].cpu() for k, v in cols.items()
           if not k.startswith((bs_ops.ZLO, bs_ops.ZHI))}
    host_params = {k: v.cpu() for k, v in params.items()}
    host_params["ps_alive"] = torch.zeros(1, dtype=torch.bool)
    outs = pipeline(one, torch.zeros(1, dtype=torch.int32), host_params)
    outs["seg_matched"] = torch.zeros(S, dtype=torch.int64)
    return outs


def needed_columns(tpl) -> set:
    out = set()

    def walk(t):
        if not isinstance(t, tuple):
            return
        if t[0] == "raw":
            out.add(t[1])
            return
        if t[0] == "dictval":
            out.add("dv::" + t[1])
            return
        if t[0] in ("eq_dict", "in_dict", "range_dict", "lut_dict",
                    "mv_any"):
            out.add(t[1])
        for x in t[1:]:
            walk(x)

    walk(tpl)
    return out


def agg_columns(tpl) -> set:
    """The cols keys one aggregation template reads (a value-space plane
    made for the launch, ``__``-prefixed, is not a batch column)."""
    name, argt, _extra = tpl
    if name == "distinctcount":
        out = {argt}
    elif name == "distinctcounthll":
        out = {"hh::" + argt}
    elif name == "hllmerge":
        out = {"bp::" + argt}
    elif name in WITH_TIME_AGGS:
        out = needed_columns(argt[0]) | needed_columns(argt[1])
    elif name == "distinctcount_v" or argt is None:
        out = set()
    else:
        out = needed_columns(argt)
    return {c for c in out if not c.startswith("__")}


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class HostShapeRerun(Exception):
    """Raised by a fetch where the reference leaves its device at fetch
    time, on a count the launch made: a sorted table holding more groups
    than its cap K, or a trimmed table more present groups than
    numGroupsLimit keeps. ``rerun()`` runs the query again in the host
    path's shape on the card (engine/rows.py), which applies
    numGroupsLimit per segment in doc order as the reference's host does;
    the engine runs it through the caller's ``fallback_gate``."""

    def __init__(self, rerun):
        super().__init__("fetch-time re-run in the host path's shape")
        self.rerun = rerun


def _np_dtype(dt: torch.dtype):
    return torch.empty(0, dtype=dt).numpy().dtype


class _Transfer:
    """One launch's outputs on their way to the host: the leaves of every
    member packed into ONE device buffer (byte views joined on the card),
    ONE copy of it enqueued into pinned host memory, and the events that
    time the kernels and the copy. On the CPU the pack is the copy and
    the times are the host clock's."""

    def __init__(self, outs_list, k_events=None, kernel_s: float = 0.0,
                 packed=None):
        t0 = time.perf_counter()
        if packed is None:
            packed = _pack(outs_list)
        self.dev, self.layouts = packed
        self.k_events = k_events
        self.kernel_s = kernel_s
        self.nbytes = int(self.dev.numel())
        if self.dev.device.type == "cuda":
            self.host = torch.empty(self.nbytes, dtype=torch.uint8,
                                    pin_memory=True)
            self.c_events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            self.c_events[0].record()
            self.host.copy_(self.dev, non_blocking=True)
            self.c_events[1].record()
            self.link_s = None
        else:
            self.host = self.dev.clone()
            self.c_events = None
            self.link_s = time.perf_counter() - t0

    def wait_kernel(self):
        if self.k_events is not None:
            self.k_events[1].synchronize()

    def wait_link(self):
        if self.c_events is not None:
            self.c_events[1].synchronize()

    def times_ms(self) -> tuple:
        """(kernel ms, link ms), after ``wait_link``: CUDA-event time from
        the launch's first kernel to its last, and of the copy."""
        kernel = self.k_events[0].elapsed_time(self.k_events[1]) \
            if self.k_events is not None else self.kernel_s * 1e3
        link = self.c_events[0].elapsed_time(self.c_events[1]) \
            if self.c_events is not None else self.link_s * 1e3
        return kernel, link

    def unpack(self) -> list:
        """Every member's leaves as numpy views of the one host copy."""
        buf = self.host.numpy()
        out = []
        for lay in self.layouts:
            host = {}
            for k, dt, shp, off, n in lay:
                host[k] = buf[off:off + n].view(dt).reshape(shp)
            out.append(host)
        return out


def _pack(outs_list) -> tuple:
    """(one flat uint8 device buffer, per member [(leaf, numpy dtype,
    shape, byte offset, bytes)]) of the members' leaves."""
    flat, layouts, off = [], [], 0
    dev = None
    for outs in outs_list:
        lay = []
        for k, v in outs.items():
            v = v.contiguous()
            dev = v.device
            n = v.numel() * v.element_size()
            lay.append((k, _np_dtype(v.dtype), tuple(v.shape), off, n))
            flat.append(v.reshape(-1).view(torch.uint8))
            off += n
        layouts.append(lay)
    buf = torch.cat(flat) if flat else torch.zeros(
        0, dtype=torch.uint8, device=dev or "cpu")
    return buf, layouts


class _KernelClock:
    """Times a launch's device work: CUDA events around it on the card
    (device time from its first kernel to its last), the host clock on
    the CPU, where the work is done when the ops return."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.events = None
        self.seconds = 0.0

    def __enter__(self):
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.events[1].record()
        self.seconds = time.perf_counter() - self._t0
        return False


_EXECUTORS: "weakref.WeakSet" = weakref.WeakSet()


def invalidate_cached_partials(match: str) -> None:
    """Drop every executor's cached partials whose batch holds a segment
    dir matching ``match``: the seam consuming segments, upserts and
    seals invalidate through."""
    for ex in list(_EXECUTORS):
        ex.invalidate_partials(match)


class DeviceExecutor:
    MAX_CACHED_BATCHES = 4  # LRU cap: a batch holds its columns on the card
    # and a cap on their resident bytes: planes are built lazily, so the
    # byte check runs again as each in-flight launch drains
    MAX_CACHED_BYTES = int(os.environ.get("PINOT_TPU_BATCH_CACHE_BYTES",
                                          6 << 30))

    def __init__(self, device=None, num_groups_limit: int = 100_000,
                 min_rows: int = ps.PALLAS_MIN_ROWS, mesh=None):
        # ``mesh`` (parallel/mesh.py): shard every batch's segment axis
        # over its devices and combine the shards' accumulators on its
        # first device, which is then this executor's device
        self.mesh = mesh
        self.device = resolve_device(
            device if mesh is None else mesh.devices[0])
        self.num_groups_limit = max(1, num_groups_limit)
        self.min_rows = min_rows
        self._batches: dict = {}  # segment-dir tuple -> BatchContext (LRU)
        self._pruner = None  # engine.SegmentPruner, made at first use
        # the server-partial trim bound (engine/reduce.py trim_bound's
        # min_trim_size), as in the reference
        self.group_trim_size = 5000
        # server query threads launch and fetch concurrently: one lock
        # guards the caches, the pins and the counters
        self._lock = threading.RLock()
        self._inflight_launches: dict = {}  # batch key -> in-flight count
        self.inflight = 0            # launches between dispatch and fetch
        self.coalescer = LaunchCoalescer()
        # fetch accounting: queries whose fetch read device-trimmed
        # leaves, and what every fetch copied to the host
        self.device_reduce_queries = 0
        self.fetch_bytes_total = 0
        self.fetch_leaves_total = 0
        self.last_get_wait_s = None
        # fetches that ran the query again in the host path's shape (a
        # sorted table past its cap, numGroupsLimit under a trim)
        self.host_shape_reruns = 0
        self.batch_hits = 0
        self.batch_misses = 0
        self.batch_evictions = 0
        # the device partials cache: a repeat execution (same template,
        # batch and forms, same literal values and ps_alive verdicts)
        # copies the cached packed output buffer again and runs nothing
        # on the card. Entries drop with their batch and through
        # ``invalidate_partials``.
        self.partials_cache_enabled = os.environ.get(
            "PINOT_TPU_PARTIALS_CACHE", "1") not in ("", "0")
        self.MAX_CACHED_PARTIALS = int(os.environ.get(
            "PINOT_TPU_PARTIALS_CACHE_ENTRIES", 256))
        self.MAX_PARTIALS_BYTES = int(os.environ.get(
            "PINOT_TPU_PARTIALS_CACHE_BYTES", 128 << 20))
        self.PARTIALS_ENTRY_MAX_BYTES = 4 << 20  # don't pin huge tables
        self._partials: dict = {}  # key -> (packed buffer, layouts, bytes)
        self.partials_bytes = 0
        self.partials_hits = 0
        self.partials_misses = 0
        self.partials_evictions = 0     # capacity pressure
        self.partials_invalidations = 0  # batch evictions, invalidations
        # per-pipeline-label roofline aggregates (``roofline_stats``)
        self._roofline: dict = {}
        self.metrics = get_metrics("server")
        # LOOKUP's dimension tables: (table, value column, pk column) ->
        # (pk -> value map, miss default); the engine sets its own
        self.lookup_resolver = None
        _EXECUTORS.add(self)

    @staticmethod
    def _batch_key(segments):
        return tuple(s.dir for s in segments)

    def batch_for(self, segments, retain: bool = False,
                  device=None) -> BatchContext:
        """The LRU-cached BatchContext of this segment set. ``retain``
        takes the in-flight pin with the cache insert, under one lock
        hold. ``device``: where a new context puts its planes (default
        the executor's)."""
        key = self._batch_key(segments)
        with self._lock:
            ctx = self._batches.pop(key, None)
            if ctx is None:
                ctx = BatchContext(segments, device or self.device)
                self.batch_misses += 1
            else:
                self.batch_hits += 1
            ctx.lookup_resolver = self.lookup_resolver
            self._batches[key] = ctx
            if retain:
                self._retain_launch(key)
            self._evict(keep=key)
        return ctx

    def _evict(self, keep=None) -> None:
        """LRU eviction past MAX_CACHED_BATCHES, or past MAX_CACHED_BYTES
        of resident planes while more than one batch is held. A batch an
        in-flight launch reads is pinned: it stays until the pin drops,
        and its cached partials go with it when it goes. The batches'
        byte counts are read without their locks."""
        with self._lock:
            while len(self._batches) > self.MAX_CACHED_BATCHES or (
                    len(self._batches) > 1
                    and sum(b.resident_bytes for b in self._batches.values())
                    > self.MAX_CACHED_BYTES):
                lru = next((k for k in self._batches
                            if k != keep and k not in self._inflight_launches),
                           None)
                if lru is None:
                    return  # every other batch is pinned
                self._batches.pop(lru)
                self.batch_evictions += 1
                self._drop_partials_for_batch(lru)

    def _retain_launch(self, key) -> None:
        with self._lock:
            self._inflight_launches[key] = \
                self._inflight_launches.get(key, 0) + 1
            self.inflight += 1

    def _release_launch(self, key) -> None:
        with self._lock:
            n = self._inflight_launches.get(key, 0) - 1
            if n > 0:
                self._inflight_launches[key] = n
            else:
                self._inflight_launches.pop(key, None)
            self.inflight -= 1
            self._evict(keep=key)

    # ---- device partials cache -------------------------------------------
    def _partials_get(self, key):
        with self._lock:
            ent = self._partials.pop(key, None)
            if ent is None:
                self.partials_misses += 1
                return None
            self._partials[key] = ent  # LRU touch
            self.partials_hits += 1
            return ent[0], ent[1]

    def _partials_put(self, key, packed) -> None:
        """Cache a solo launch's packed output buffer (the same device
        tensor its fetch copies; nothing writes it again). Entries past
        PARTIALS_ENTRY_MAX_BYTES are skipped."""
        buf, layouts = packed
        nbytes = int(buf.numel())
        if nbytes > self.PARTIALS_ENTRY_MAX_BYTES:
            return
        with self._lock:
            if key in self._partials:
                return
            self._partials[key] = (buf, layouts, nbytes)
            self.partials_bytes += nbytes
            while self._partials and (
                    len(self._partials) > self.MAX_CACHED_PARTIALS
                    or self.partials_bytes > self.MAX_PARTIALS_BYTES):
                self._partials_drop_locked(next(iter(self._partials)))

    def _partials_drop_locked(self, key, invalidation: bool = False) -> None:
        ent = self._partials.pop(key, None)
        if ent is not None:
            self.partials_bytes -= ent[2]
            if invalidation:
                self.partials_invalidations += 1
            else:
                self.partials_evictions += 1

    def _drop_partials_for_batch(self, batch_key) -> None:
        """Caller holds the lock: drop the entries of an evicted batch."""
        for k in [k for k in self._partials if k[1] == batch_key]:
            self._partials_drop_locked(k, invalidation=True)

    def invalidate_partials(self, match: str) -> None:
        """Drop entries whose batch holds a segment dir matching ``match``
        (a substring)."""
        with self._lock:
            for k in [k for k in self._partials
                      if any(match in d for d in k[1])]:
                self._partials_drop_locked(k, invalidation=True)

    def hbm_stats(self) -> dict:
        """Batch-LRU, partials-cache and roofline snapshot."""
        with self._lock:
            snap = {
                "batch_hits": self.batch_hits,
                "batch_misses": self.batch_misses,
                "batch_evictions": self.batch_evictions,
                "partials_cache_entries": len(self._partials),
                "partials_cache_bytes": self.partials_bytes,
                "partials_cache_hits": self.partials_hits,
                "partials_cache_misses": self.partials_misses,
                "partials_cache_evictions": self.partials_evictions,
                "partials_cache_invalidations": self.partials_invalidations,
                "device_reduce_queries": self.device_reduce_queries,
                "inflight": self.inflight,
            }
            batches = list(self._batches.values())
        snap["cached_batches"] = len(batches)
        snap["resident_bytes"] = sum(b.resident_bytes for b in batches)
        snap["max_cached_bytes"] = self.MAX_CACHED_BYTES
        snap["roofline"] = self.roofline_stats()
        return snap

    # ---- roofline flights ------------------------------------------------
    @staticmethod
    def _pipeline_label(template, blockskip: bool, trim, kernels_used: bool,
                        fused: bool = False) -> str:
        """The per-pipeline label the roofline aggregates key on: the
        template shape and the forms. ``+cuda`` marks a launch whose
        pipeline reaches the port's kernels, where the reference marks its
        Pallas tier ``+pallas``."""
        label = template[0]
        if blockskip:
            label += "+bskip"
        if fused:
            label += "+fused"
        if kernels_used:
            label += "+cuda"
        if trim is not None:
            label += "+trim"
        return label

    @staticmethod
    def _new_flight(label: str, fused: bool = False) -> dict:
        return {"label": label, "cache_hit": False, "fused": fused,
                "data_bytes": 0, "zone_bytes": 0, "record": None}

    def _note_flight(self, flight: dict, outs: dict, fetched_bytes: int,
                     kernel_ms: float, link_ms: float) -> None:
        """Fold one resolved flight into the roofline accounting, the
        reference's bytes-moved model: the column planes at their stored
        widths, data scaled by the block-skip gather ratio, the gather
        buffer's round trip (the fused K4 form does not pay it) and the
        fetched bytes, over the kernel time, against the probed peak.
        Cache hits count apart and are not rated."""
        from pinot_tpu_torch.ops import roofline as rl

        cache_hit = bool(flight.get("cache_hit"))
        ratio = 1.0
        bt, bs = outs.get("blocks_total"), outs.get("blocks_scanned")
        if bt is not None and bs is not None:
            total_b = float(np.sum(np.asarray(bt)))
            if total_b > 0:
                ratio = min(1.0, float(np.sum(np.asarray(bs))) / total_b)
        gather_bytes = 0
        if ratio < 1.0 and not flight.get("fused"):
            gather_bytes = int(2 * flight["data_bytes"] * ratio)
        bytes_moved = 0 if cache_hit else int(
            flight["zone_bytes"] + flight["data_bytes"] * ratio
            + gather_bytes + fetched_bytes)
        rec = {"kernel": flight["label"], "bytesMoved": bytes_moved,
               "bytesFetched": int(fetched_bytes),
               "kernelMs": round(kernel_ms, 3), "linkMs": round(link_ms, 3),
               "cacheHit": cache_hit}
        if gather_bytes:
            rec["gatherBytes"] = gather_bytes
        gbps = None
        if not cache_hit and kernel_ms > 1e-6:
            gbps = bytes_moved / (kernel_ms / 1e3) / 1e9
            rec["gbps"] = round(gbps, 3)
            peak = rl.hbm_peak_gbps(self.device)
            pct = rl.pct_of_peak(gbps, peak)
            if pct is not None:
                rec["peakGbps"] = round(peak, 1)
                rec["pctOfPeak"] = pct
        flight["record"] = rec
        with self._lock:
            agg = self._roofline.setdefault(
                flight["label"], {"queries": 0, "cache_hits": 0,
                                  "bytes_moved": 0, "kernel_ms": 0.0,
                                  "link_ms": 0.0})
            agg["queries"] += 1
            agg["link_ms"] += link_ms
            if cache_hit:
                agg["cache_hits"] += 1
            else:
                agg["bytes_moved"] += bytes_moved
                agg["kernel_ms"] += kernel_ms
        if gbps is not None:
            self.metrics.observe("deviceKernelGbps", gbps)

    def roofline_stats(self) -> dict:
        """Per-label roofline snapshot against the probed peak (None until
        a flight probed it: reading stats never runs the probe)."""
        from pinot_tpu_torch.ops import roofline as rl

        with self._lock:
            aggs = {k: dict(v) for k, v in self._roofline.items()}
        peak = rl.peak_if_probed()
        out = {}
        for label, agg in aggs.items():
            entry = dict(agg)
            entry["kernel_ms"] = round(entry["kernel_ms"], 3)
            entry["link_ms"] = round(entry["link_ms"], 3)
            if agg["kernel_ms"] > 0:
                gbps = agg["bytes_moved"] / (agg["kernel_ms"] / 1e3) / 1e9
                entry["gbps"] = round(gbps, 3)
                pct = rl.pct_of_peak(gbps, peak)
                if pct is not None:
                    entry["pct_of_peak"] = pct
            out[label] = entry
        return {"peak_gbps": round(peak, 1) if peak else None,
                "kernels": out}

    def _make_resolve(self, tr: _Transfer, tracer=None, flight=None):
        """The fetch-phase closure shared by solo and cohort launches: the
        blocking wait split into a kernel wait (on the event after the
        launch's last kernel) and a link wait (on the copy), recorded as
        the spans ``kernel`` and ``link``; then the accounting and each
        member's leaves as views of the one host copy. Returns the list
        of member leaves (one entry for a solo launch)."""
        def resolve():
            t0 = time.perf_counter()
            with span("kernel", tracer):
                tr.wait_kernel()
            with span("link", tracer):
                tr.wait_link()
            wait = time.perf_counter() - t0
            kernel_ms, link_ms = tr.times_ms()
            outs = tr.unpack()
            with self._lock:
                self.last_get_wait_s = wait
                self.fetch_bytes_total += tr.nbytes
                self.fetch_leaves_total += 1
            self.metrics.time_ms("deviceFetchMs", wait * 1e3)
            if flight is not None:
                self._note_flight(flight, outs[0], tr.nbytes, kernel_ms,
                                  link_ms)
            return outs

        return resolve

    def _agg_template(self, i: int, a: Expression, ctx: BatchContext,
                      params, counter):
        name = a.name
        if name in DISTINCTCOUNT_ALIASES:
            name = "distinctcount"
        if name not in DEVICE_AGGS:
            raise DeviceUnsupported(f"aggregation {name} not on device")
        if name == "count":
            return ("count", None, None)
        if name in SKETCH_AGGS:
            # DISTINCTCOUNT counts global dict ids; DISTINCTCOUNTHLL reads
            # the per-doc hashes of a dict column's values
            arg = a.args[0]
            if not arg.is_identifier \
                    or ctx.encoding(arg.name) != Encoding.DICT:
                raise DeviceUnsupported(f"{name} needs a dict column on "
                                        f"the device")
            if name == "distinctcount":
                return (name, arg.name, ctx.cardinality(arg.name))
            return (name, arg.name, aggspec.make_spec(a).log2m)
        if name == "hllmerge":
            # a star-tree cube's register planes: a dict BYTES column one
            # register plane (m bytes) wide
            arg = a.args[0]
            if not arg.is_identifier \
                    or ctx.encoding(arg.name) != Encoding.DICT:
                raise DeviceUnsupported("hllmerge needs a dict BYTES column")
            spec = aggspec.make_spec(a)
            width = ctx.bytes_width(arg.name)
            if width != spec.m:
                raise DeviceUnsupported(
                    f"hllmerge plane width {width} != m {spec.m}")
            return ("hllmerge", arg.name, spec.log2m)
        if name in WITH_TIME_AGGS:
            # a value and a time expression; a non-numeric value column
            # has no device form (build_expr refuses it), as in the
            # reference
            return (name, (build_expr(a.args[0], ctx, params, counter),
                           build_expr(a.args[1], ctx, params, counter)),
                    "pair")
        argt = build_expr(a.args[0], ctx, params, counter)
        if name not in ("sum", "avg"):
            return (name, argt, None)
        # metadata interval arithmetic sizes the kernel's byte planes and
        # bounds the fused plan's per-block int32 partials
        nplanes = rpb = None
        bounds = expr_bounds(a.args[0], ctx)
        # a NaN in the column makes its metadata bounds NaN: no byte planes
        if bounds is not None and all(map(math.isfinite, bounds)):
            rpb = agg_ops.rows_per_block_for(max(abs(bounds[0]),
                                                 abs(bounds[1])))
            nplanes = mm.int_planes_needed(bounds[0], bounds[1])
            params[f"off{i}"] = torch.tensor(
                math.floor(bounds[0]), dtype=torch.int64, device=ctx.device)
        return (name, argt, (nplanes, rpb))

    def supports(self, q: QueryContext) -> bool:
        """Whether the reference's device runs ``q`` (the static check its
        EXPLAIN names the backend by); the port runs every shape on the
        card, the others in the reference host path's shape."""
        aggs = q.aggregations()
        if q.distinct:
            return not aggs and all(e.is_identifier
                                    for e in q.select_expressions)
        if not aggs:
            return False
        return all(a.name in DEVICE_AGGS or a.name in DISTINCTCOUNT_ALIASES
                   for a in aggs)

    def host_shape(self, q: QueryContext, ctx: BatchContext) -> bool:
        """Whether the reference's device refuses ``q``, so that its host
        path answers it: the shape ``launch`` runs ``q`` in, decided before
        anything is built. The device takes aggregations or DISTINCT over
        dict-column keys, a filter and aggregation arguments with a device
        form (engine/params.py ``filter_on_device``, ``expr_on_device``),
        aggregations it has a form for, and per-group state within its
        guards."""
        aggs = q.aggregations()
        if not aggs and not q.distinct:
            return True  # selection
        keys = q.select_expressions if q.distinct else q.group_by or ()
        if not all(k.is_identifier and stored_column(k.name, ctx)
                   and ctx.device_encoding(k.name) == Encoding.DICT
                   for k in keys):
            return True  # incl. an MV key: the host expands its entries
        if q.filter is not None and not filter_on_device(q.filter, ctx):
            return True
        if not all(self._agg_on_device(a, ctx) for a in aggs):
            return True
        num_groups = math.prod(ctx.cardinality(k.name) for k in keys)
        if num_groups > MAX_DENSE_GROUPS:
            # past the dense regime only the sorted regime's aggregations
            # stay on the device, over a key that fits int64
            return num_groups >= (1 << 62) \
                or any(a.name not in SORTED_AGGS for a in aggs)
        return bool(keys) and any(
            num_groups * self._state_cells(a, ctx) > MAX_PRESENCE_CELLS
            for a in aggs)

    @staticmethod
    def _agg_on_device(a: Expression, ctx: BatchContext) -> bool:
        """Whether ``_agg_template`` has a device form for ``a``."""
        name = "distinctcount" if a.name in DISTINCTCOUNT_ALIASES else a.name
        if name not in DEVICE_AGGS:
            return False
        if name == "count":
            return True
        arg = a.args[0]
        if name in SKETCH_AGGS or name == "hllmerge":
            return arg.is_identifier and stored_column(arg.name, ctx) \
                and ctx.device_encoding(arg.name) == Encoding.DICT
        if name in WITH_TIME_AGGS:
            return expr_on_device(arg, ctx) and expr_on_device(a.args[1], ctx)
        return expr_on_device(arg, ctx)

    @staticmethod
    def _state_cells(a: Expression, ctx: BatchContext) -> int:
        """Per-group state cells of a presence or register aggregation."""
        if a.name in ("distinctcount",) + DISTINCTCOUNT_ALIASES:
            return ctx.cardinality(a.args[0].name)
        if a.name in ("distinctcounthll", "hllmerge"):
            return 1 << aggspec.make_spec(a).log2m
        return 0

    def alive_mask(self, q: QueryContext, segments, alive=None):
        """Level 1: per segment, not proved empty by the SegmentPruner
        (``alive`` passes verdicts the caller already has)."""
        if alive is not None:
            return np.asarray(alive, dtype=bool)
        out = np.ones(len(segments), dtype=bool)
        if q.filter is not None:
            if self._pruner is None:
                from pinot_tpu_torch.engine.engine import SegmentPruner

                self._pruner = SegmentPruner()
            for j, s in enumerate(segments):
                out[j] = not self._pruner.prune(q, s)
        return out

    def _template(self, q: QueryContext, ctx: BatchContext, params,
                  counter, final: bool) -> tuple:
        """The reference's device template for ``q``, a shape
        ``host_shape`` leaves on the device: past ``MAX_DENSE_GROUPS`` the
        sorted regime, with its table cap K (``sorted_k``) in the
        template."""
        aggs = q.aggregations()
        filter_tpl = ("true",) if q.filter is None else build_filter(
            q.filter, ctx, params, counter)
        group_cols = [g.name for g in
                      (q.select_expressions if q.distinct else q.group_by)
                      or ()]
        group_cards = [ctx.cardinality(c) for c in group_cols]
        shape = "groupby" if group_cols else "agg"
        if group_cols and math.prod(group_cards) > MAX_DENSE_GROUPS:
            # host_shape left only SORTED_AGGS here
            shape = "groupby_sorted"
        sorted_k = min(self.num_groups_limit, MAX_SORTED_GROUPS) \
            if shape == "groupby_sorted" else 0
        agg_tpls = tuple(self._agg_template(i, a, ctx, params, counter)
                         for i, a in enumerate(aggs))
        final = final and any(name in STATE_AGGS for name, _, _ in agg_tpls)
        return (shape, filter_tpl, tuple(group_cols), tuple(group_cards),
                agg_tpls, sorted_k, final)

    @staticmethod
    def gather_columns(ctx: BatchContext, needed, params, group_cols=(),
                       group_cards=()) -> tuple:
        """(widths, cols) for the cols keys ``needed``: each plane as the
        batch holds it, its width plan's signature, and its FOR offset
        added to ``params``."""
        widths, cols = {}, {}
        for c in sorted(needed):
            if c.startswith((bs_ops.ZLO, bs_ops.ZHI)):
                lo_hi = ctx.zone_map(c[len(bs_ops.ZLO):])
                cols[c] = lo_hi[c.startswith(bs_ops.ZHI)]
                continue
            if c.startswith("sk::"):
                _, colname, l2m = c.split("::")
                cols[c] = ctx.sorted_hll_keys(group_cols, group_cards,
                                              colname, int(l2m))
                continue
            if c.startswith("hh::"):
                cols[c] = ctx.prehashed_column(c[4:])
                continue
            if c.startswith("bp::"):
                cols[c] = ctx.bytes_plane_column(c[4:])
                continue
            if c.startswith("mv::"):
                cols[c] = ctx.mv_column(c[4:])
                continue
            plan = ctx.width_plan(c)
            widths[c] = plan.sig()
            if plan.offset is not None:
                params["fo::" + c] = to_device(
                    np.asarray(plan.offset, dtype=np.dtype(plan.wide)),
                    ctx.device)
            cols[c] = ctx.decoded_column(c[4:]) if c.startswith("dv::") \
                else ctx.column(c)
        return widths, cols

    def refuses(self, q: QueryContext, segments) -> bool:
        """Whether the reference's device refuses ``q`` over this batch at
        launch (``host_shape`` over its context), so that its engine runs
        the whole scan on its host."""
        return self.host_shape(q, self.batch_for(segments))

    def launch(self, q: QueryContext, segments, final: bool = False,
               reduce_mode=None, alive=None, tracer=None,
               host: bool = False) -> InflightLaunch:
        """LAUNCH phase: template build, column upload (cached per segment
        set), the pipeline's torch ops and kernel launches and ONE copy of
        the packed outputs to pinned host memory, all enqueued on the
        current stream. Returns an ``InflightLaunch`` whose ``fetch()``
        waits for the copy. Under pressure (another launch in flight, or
        ``coalescer.force``), launches of one cohort key coalesce into one
        launch per kernel (engine/cohort.py). A repeat of a cached launch
        copies its cached outputs again and runs nothing (the partials
        cache; ``SET usePartialsCache = false`` bypasses it).

        ``final``: the launch is terminal (nothing merges after it), so
        distinct counts and HLL finalize on the card. A shape the
        reference's device refuses runs in its host path's shape on the
        card (engine/rows.py); one this port does not run raises
        DeviceUnsupported. The fetch may ask for a run in the host path's
        shape (``HostShapeRerun``).

        ``reduce_mode``: None, or "terminal" / "partial" when this batch
        is the sole partial of its execution: a group-by then takes the
        on-device trim (ops/device_reduce.py) unless ``SET
        useDeviceReduce = false``.

        Level 1: segments the SegmentPruner proves empty stay in the
        batch, dead (``ps_alive``; ``alive`` passes verdicts the caller
        already has); when every segment is pruned nothing runs on the
        card. Level 2: a filter with interval structure takes the
        block-skip forms unless ``SET useBlockSkip = false``.

        ``tracer``: the query's explicit Tracer; the launch records
        ``gather`` and ``dispatch``, the resolve ``kernel`` and ``link``.
        The batch stays pinned from here until the handle is fetched or
        released. ``host``: run in the host path's shape whatever the
        shape (the engine's whole-scan run where the reference's device
        refuses another batch of the query). A consuming or upsert-masked
        segment launches alone (``launch_host_part``)."""
        t_launch = time.perf_counter()
        if q.distinct and q.aggregations():
            raise DeviceUnsupported("DISTINCT over aggregations")
        if not all(segment_device_eligible(s) for s in segments):
            if len(segments) == 1:
                return self.launch_host_part(q, segments[0], tracer=tracer)
            raise DeviceUnsupported(
                "a consuming or upsert-masked segment launches alone, in the "
                "host path's shape (the engine splits it from the batch)")
        batch_key = self._batch_key(segments)
        ctx = self.batch_for(segments, retain=True)
        try:
            handle = self._launch_pinned(q, ctx, batch_key, segments, final,
                                         reduce_mode, alive, tracer, host)
        except BaseException:
            self._release_launch(batch_key)
            raise
        handle.tracer = tracer
        self.metrics.time_ms("deviceLaunchMs",
                             (time.perf_counter() - t_launch) * 1e3)
        return handle

    def launch_host_part(self, q: QueryContext, part,
                         tracer=None) -> InflightLaunch:
        """Launch ``q`` over one part the reference answers on its host (a
        consuming segment, its unfrozen tail, an upsert-dirtied chunklet,
        an upsert-masked sealed segment) in that path's shape on the card
        (engine/rows.py), with its valid-docs plane ANDed into the rows
        the filter matched and the host path's stats.

        A sealed segment's planes come from the batch LRU (its directory
        is stable); its mask is not part of them, since the writer flips
        it: the launch snapshots it and uploads it with its parameters. A
        part without a directory builds a context of its own, which
        neither enters the LRU nor caches partials: a tail's key would
        change with every query, and a dirty chunklet's mask with every
        upsert. A consuming segment or a tail reads through a
        ``SnapshotSegment`` of the docs it publishes now. The partial is
        mergeable (the reference's host never finalizes)."""
        t_launch = time.perf_counter()
        ctx, key = self.part_context(part)
        try:
            valid = self.part_valid_plane(part, ctx)
            alive = np.ones(1, dtype=bool)
            with span("dispatch", tracer):
                with _KernelClock(ctx.device) as clock:
                    rl = rows.launch(self, q, ctx, False, None, alive,
                                     valid=valid)
                tr = _Transfer([rl.outs], clock.events, clock.seconds)
            handle = InflightLaunch(
                self, key, self._first(self._make_resolve(tr, tracer)),
                lambda host: rl.finish(host, self))
        except BaseException:
            self._release_launch(key)
            raise
        handle.tracer = tracer
        self.metrics.time_ms("deviceLaunchMs",
                             (time.perf_counter() - t_launch) * 1e3)
        return handle

    def part_context(self, part) -> tuple:
        """(BatchContext, pin key) of one part the reference reads on its
        host, pinned until ``_release_launch(key)``: a sealed segment's
        from the batch LRU, any other's of its own (a consuming segment
        or a tail through a ``SnapshotSegment`` of the docs it publishes
        now), outside the LRU."""
        if isinstance(part, ImmutableSegment):
            return self.batch_for([part], retain=True,
                                  device=self._part_device(part.dir)), \
                self._batch_key([part])
        view = SnapshotSegment(part) \
            if getattr(part, "is_mutable", False) else part
        key = ("host-part", view.dir)
        ctx = BatchContext([view], self._part_device(view.dir))
        ctx.lookup_resolver = self.lookup_resolver
        self._retain_launch(key)
        return ctx, key

    def _part_device(self, name: str):
        """The device a part launched alone runs on: on a mesh, the shard
        device its directory hashes to, so the host parts spread over the
        mesh with the sealed segments."""
        if self.mesh is None:
            return self.device
        import zlib

        return self.mesh.devices[zlib.crc32(str(name).encode())
                                 % self.mesh.size]

    def _shards(self, ctx) -> list:
        """(shard index, ``ShardContext``) of each mesh shard holding
        segments of the batch ``ctx``, made at first use and kept with
        the batch (parallel/mesh.py ``shard_slices``)."""
        with ctx._lock:
            shards = getattr(ctx, "_mesh_shards", None)
            if shards is None:
                shards = [(d, ShardContext(ctx, lo, hi, dev))
                          for d, ((lo, hi), dev) in enumerate(zip(
                              mesh_ops.shard_slices(ctx.S, self.mesh.size),
                              self.mesh.devices)) if hi > lo]
                ctx._mesh_shards = shards
        return shards

    def _shard_inputs(self, ctx, needed, params, group_cols,
                      group_cards) -> tuple:
        """(width plan signatures, [(shard index, ShardContext, cols,
        params)]): each shard's planes and params on its own device,
        checked there (``mesh_ops.check_placement``)."""
        widths, out = {}, []
        for d, sh in self._shards(ctx):
            p = mesh_ops.shard_params(params, sh.lo, sh.hi, sh.device)
            widths, cols = self.gather_columns(sh, needed, p, group_cols,
                                               group_cards)
            mesh_ops.check_placement(d, sh.device,
                                     {**cols, **p, "n_docs": sh.n_docs_dev})
            out.append((d, sh, cols, p))
        return widths, out

    @staticmethod
    def part_valid_plane(part, ctx):
        """The (1, L) bool upsert valid-docs plane of a part's context
        ``ctx`` (a snapshot of its mask now), or None when it has none."""
        n = int(ctx.n_docs[0])
        vd = valid_docs_snapshot(part, n)
        if vd is None:
            return None
        plane = np.zeros((1, ctx.pad_to), dtype=bool)
        plane[0, :n] = vd
        return to_device(plane, ctx.device)

    def _launch_pinned(self, q, ctx, batch_key, segments, final, reduce_mode,
                       alive, tracer, host=False) -> InflightLaunch:
        alive = self.alive_mask(q, segments, alive)
        if host or self.host_shape(q, ctx):
            # the reference answers this shape on its host: the card runs
            # it in that shape, solo and uncached, as the reference's host
            # path neither coalesces nor caches
            with span("dispatch", tracer):
                with _KernelClock(ctx.device) as clock:
                    rl = rows.launch(self, q, ctx, final, reduce_mode, alive)
                tr = _Transfer([rl.outs], clock.events, clock.seconds)
            return InflightLaunch(
                self, batch_key, self._first(self._make_resolve(tr, tracer)),
                lambda host: rl.finish(host, self))
        opts = q.options_ci()
        cacheable = self.partials_cache_enabled and bool_option(
            opts, "usepartialscache", None) is not False
        params: dict = {"__hostsig__": []} if cacheable else {}
        counter = [0]
        template = self._template(q, ctx, params, counter, final)
        host_sigs = params.pop("__hostsig__", None)
        shape, filter_tpl, group_cols, group_cards, agg_tpls, sorted_k, \
            final_tpl = template
        aggs = q.aggregations()
        num_groups = math.prod(group_cards)

        # Level-2 eligibility: the filter has interval structure the zone
        # maps can act on, the batch is block-aligned, and the query did
        # not opt out (SET useBlockSkip = false, the force-dense form)
        use_bs, zone_cols = False, set()
        if filter_tpl[0] not in ("true", "false") \
                and bool_option(opts, "useblockskip", None) is not False \
                and ctx.pad_to % bs_ops.BLOCK_ROWS == 0:
            prunable, zone_cols = bs_ops.prunable_columns(filter_tpl)
            use_bs = prunable and bool(zone_cols)
        # Level 1: a per-query vector param, pruned segments stay in the
        # batch
        params["ps_alive"] = to_device(alive, ctx.device)

        # on-device final reduce (ops/device_reduce.py): plan the ORDER BY
        # trim when this batch is the sole partial of its execution; the
        # exact keep count rides as the tr_k param
        trim, tr_k = None, None
        if reduce_mode is not None and group_cols:
            trim = dr_ops.plan_trim(
                q, q.group_by, aggs,
                sorted_k if shape == "groupby_sorted" else num_groups,
                reduce_mode, self.group_trim_size)
            if trim is not None:
                tr_k = dr_ops.trim_keep_count(q, reduce_mode,
                                              self.group_trim_size)
                params["tr_k"] = torch.tensor(tr_k, dtype=torch.int64,
                                              device=ctx.device)

        # SET useSortedProjection = false keeps the per-query sort (the
        # cold form); by default a filterless terminal HLL group-by reads
        # the batch's cached sorted projection
        sorted_proj_ok = bool_option(opts, "usesortedprojection",
                                     None) is not False
        needed = needed_columns(filter_tpl) | set(group_cols)
        for zc in zone_cols if use_bs else ():
            needed |= {bs_ops.ZLO + zc, bs_ops.ZHI + zc}
        for name, argt, extra in agg_tpls:
            # the sorted HLL build's sums do not combine across shards:
            # a mesh takes the registers (the reference's sorted_hll_ok)
            if (name == "distinctcounthll" and group_cols
                    and filter_tpl == ("true",) and sorted_proj_ok
                    and self.mesh is None
                    and _hll_sort_eligible(final_tpl, num_groups, extra)):
                needed.add(f"sk::{argt}::{extra}")
            else:
                needed |= agg_columns((name, argt, extra))
        if not needed:  # COUNT(*) no filter: one column carries the shape
            needed.add(segments[0].column_names()[0])

        def finish(host):
            return self._finish(q, ctx, template, host, final, reduce_mode,
                                alive)

        if not alive.any():
            # FULLY pruned: nothing runs on the card
            src = ctx if self.mesh is None else self._shards(ctx)[0][1]
            widths, cols = self.gather_columns(src, needed, params,
                                               group_cols, group_cards)
            outs = _neutral_outs(build_pipeline(template, widths,
                                                self.min_rows),
                                 cols, params, ctx.S)
            if trim is not None:
                outs = dr_ops.apply_trim(outs, params["tr_k"].cpu(),
                                         template, trim)
            tr = _Transfer([outs])
            return InflightLaunch(self, batch_key,
                                  self._first(self._make_resolve(tr)),
                                  finish)

        # the partials cache: the key digests the literals' host bytes,
        # taken before upload, and the ps_alive verdicts, so no launch
        # reads a device param back to hash it
        cache_key = None
        if cacheable and host_sigs is not None \
                and all(sig[3] is not None for sig in host_sigs):
            h = hashlib.blake2b(digest_size=16)
            for key, dt, shp, b in sorted(host_sigs, key=lambda e: e[0]):
                h.update(repr((key, dt, shp)).encode())
                h.update(b)
            h.update(b"ps_alive" + alive.tobytes())
            h.update(b"tr_k" + repr(tr_k).encode())
            cache_key = (template, batch_key, use_bs, trim, self.min_rows,
                         h.digest(),
                         None if self.mesh is None else self.mesh.key)
            hit = self._partials_get(cache_key)
            if hit is not None:
                flight = self._new_flight(self._pipeline_label(
                    template, use_bs, trim, self._uses_kernels(template,
                                                               ctx)))
                flight["cache_hit"] = True
                tr = _Transfer(None, packed=hit)
                handle = InflightLaunch(
                    self, batch_key,
                    self._first(self._make_resolve(tr, tracer, flight)),
                    finish)
                handle.cache_hit = True
                handle.flight = flight
                return handle

        with span("gather", tracer):
            if self.mesh is None:
                widths, cols = self.gather_columns(ctx, needed, params,
                                                   group_cols, group_cards)
                planes, p0 = [cols], params
            else:
                # cols: each shard's (index, context, planes, params)
                widths, cols = self._shard_inputs(ctx, needed, params,
                                                  group_cols, group_cards)
                planes, p0 = [c[2] for c in cols], cols[0][3]
        plan = plan_fused(template, widths, use_bs)
        fused = plan is not None and ps.fused_params_ok(plan, p0)
        flight = self._new_flight(self._pipeline_label(
            template, use_bs, trim, self._uses_kernels(template, ctx),
            fused), fused=fused)
        for cols_d in planes:
            for ck, cv in cols_d.items():
                nb = cv.numel() * cv.element_size()
                flight["zone_bytes" if ck.startswith((bs_ops.ZLO,
                                                      bs_ops.ZHI))
                       else "data_bytes"] += nb

        with span("dispatch", tracer):
            co = self.coalescer
            if cohort.cohort_supported(template) \
                    and co.should_window(self.inflight):
                resolve = self._join_cohort(template, batch_key, widths,
                                            use_bs, trim, cols, ctx, params,
                                            tracer, flight)
                handle = InflightLaunch(self, batch_key, resolve, finish)
                handle.flight = flight
                return handle
            with _KernelClock(ctx.device) as clock:
                outs = self._run_solo(template, widths, use_bs, trim, cols,
                                      ctx, params)
            tr = _Transfer([outs], clock.events, clock.seconds)
        if cache_key is not None:
            # cohort members never insert: their buffer is the cohort's
            self._partials_put(cache_key, (tr.dev, tr.layouts))
        handle = InflightLaunch(
            self, batch_key,
            self._first(self._make_resolve(tr, tracer, flight)), finish)
        handle.flight = flight
        return handle

    @staticmethod
    def _first(resolve):
        """A solo resolve: the one member's leaves."""
        def one():
            return resolve()[0]

        return one

    def _uses_kernels(self, template, ctx) -> bool:
        """Whether the pipeline's batch (on a mesh, its largest shard)
        is large enough for the kernels (the ``min_rows`` gate; the
        label's ``+cuda``)."""
        S = ctx.S if self.mesh is None else max(
            sh.S for _d, sh in self._shards(ctx))
        return S * ctx.pad_to >= self.min_rows

    def _run_solo(self, template, widths, use_bs, trim, cols, ctx, params):
        if self.mesh is not None:
            return self._run_mesh(template, widths, use_bs, trim, cols,
                                  [params])[0]
        outs = build_pipeline(template, widths, self.min_rows, use_bs)(
            cols, ctx.n_docs_dev, params)
        return self._post_combine(template, trim, outs, params.get("tr_k"),
                                  finalize=False)

    @staticmethod
    def _post_combine(template, trim, outs, tr_k, finalize=True) -> dict:
        """After the combine: the terminal finalize (a mesh's shards
        return registers and presence), then the device trim."""
        if finalize and template[6]:
            _finalize_sketch_outs(outs, template[4])
        if trim is not None:
            outs = dr_ops.apply_trim(outs, tr_k.to(outs["gcount"].device),
                                     template, trim)
        return outs

    def _run_mesh(self, template, widths, use_bs, trim, shard_in,
                  members) -> list:
        """A launch on the mesh, one member or a cohort: per shard the
        solo pipeline (or the cohort's member-axis launch) with the
        template's finalize left out, then per member the combine on the
        mesh's first device (parallel/mesh.py ``combine_outs``), the
        finalize and the trim. Every shard runs on its device or the
        launch raises."""
        stpl = template[:6] + (False,)
        per_shard = []
        for d, sh, cols, p in shard_in:
            fo = {k: v for k, v in p.items() if k.startswith("fo::")}
            mem = [dict(mesh_ops.shard_params(m, sh.lo, sh.hi, sh.device),
                        **fo) for m in members]
            for m in mem:
                mesh_ops.check_placement(d, sh.device, m)
            if len(mem) == 1:
                per_shard.append([build_pipeline(
                    stpl, widths, self.min_rows, use_bs)(
                        cols, sh.n_docs_dev, mem[0])])
            else:
                per_shard.append(cohort.run(stpl, widths, self.min_rows,
                                            use_bs, cols, sh.n_docs_dev,
                                            mem, None))
        return [self._post_combine(
            template, trim, mesh_ops.combine_outs(
                [outs[j] for outs in per_shard], template[4], self.device),
            members[j].get("tr_k")) for j in range(len(members))]

    def _join_cohort(self, template, batch_key, widths, use_bs, trim, cols,
                     ctx, params, tracer, flight):
        """Join (or lead) the cohort of this launch's key: the same
        template over the same batch in the same forms, the same columns
        and the same parameter shapes and dtypes. The leader runs ONE
        member-axis launch for all (engine/cohort.py); its kernel is
        attributed to its own trace and flight, once."""
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in params.items()))
        ckey = (template, batch_key, use_bs, trim, self.min_rows,
                tuple(sorted(cols if self.mesh is None else cols[0][2])),
                sig)

        def launch_fn(members):
            with _KernelClock(ctx.device) as clock:
                if self.mesh is not None:
                    outs_list = self._run_mesh(template, widths, use_bs,
                                               trim, cols, members)
                elif len(members) == 1:
                    outs_list = [self._run_solo(template, widths, use_bs,
                                                trim, cols, ctx, members[0])]
                else:
                    outs_list = cohort.run(template, widths, self.min_rows,
                                           use_bs, cols, ctx.n_docs_dev,
                                           members, trim)
            tr = _Transfer(outs_list, clock.events, clock.seconds)
            return self._make_resolve(tr, tracer, flight)

        c, idx = self.coalescer.join(ckey, params, launch_fn)

        def resolve():
            return c.resolve_member(idx)

        resolve.abandon = c.note_abandoned
        return resolve

    def _finish(self, q, ctx, template, host, final, reduce_mode, alive):
        """Host leaves → IntermediateResult, or ``HostShapeRerun`` where
        the reference leaves its device at fetch time (a sorted table
        past K, a trimmed table past numGroupsLimit)."""
        shape, sorted_k = template[0], template[5]
        if (shape == "groupby_sorted"
                and int(host["n_groups_total"]) > sorted_k) \
                or ("n_present_total" in host and int(
                    host["n_present_total"]) > self.groups_limit(q)):
            raise HostShapeRerun(lambda: self._rerun(q, ctx, final,
                                                     reduce_mode, alive))
        if "trim_keys" in host:
            with self._lock:
                self.device_reduce_queries += 1
        return self._to_intermediate(q, ctx, template, host)

    def _rerun(self, q, ctx, final, reduce_mode, alive):
        """The fetch-time run in the host path's shape, fetched at once."""
        with self._lock:
            self.host_shape_reruns += 1
        rl = rows.launch(self, q, ctx, final, reduce_mode, alive)
        tr = _Transfer([rl.outs])
        return rl.finish(self._make_resolve(tr)()[0], self)

    def groups_limit(self, q: QueryContext) -> int:
        """numGroupsLimit: the engine default or the per-query SET."""
        opts = q.options_ci()
        if "numgroupslimit" in opts:
            return max(1, int(opts["numgroupslimit"]))
        return self.num_groups_limit

    def fetch(self, handle) -> IntermediateResult:
        """A handle's result, with a fetch-time run in the host path's
        shape done in place (the engine runs that through its caller's
        ``fallback_gate`` instead)."""
        try:
            return handle.fetch()
        except HostShapeRerun as r:
            return r.rerun()

    def execute(self, q: QueryContext, segments, final: bool = False,
                reduce_mode=None) -> IntermediateResult:
        return self.fetch(self.launch(q, segments, final, reduce_mode))

    # ---- device outputs → canonical IntermediateResult -------------------
    def _to_intermediate(self, q, ctx: BatchContext, template, outs):
        shape, _, group_cols, group_cards, agg_tpls, _k, _final = template
        doc_count = int(outs["doc_count"])
        # honest under pruning, as the reference: entries count only the
        # alive segments' rows, and only the gathered blocks' rows when a
        # block-skip form ran; pruned segments still count in totalDocs
        n_alive = int(outs["n_alive"])
        entries_in_filter = 0
        if q.filter is not None:
            entries_in_filter = int(outs["rows_filter"]) \
                * len(q.filter.columns())
        entries_post = sum(
            doc_count * len(aggspec.make_spec(a).args)
            for a in q.aggregations())
        stats = ExecutionStats(
            num_docs_scanned=doc_count,
            num_entries_scanned_in_filter=entries_in_filter,
            num_entries_scanned_post_filter=entries_post,
            num_segments_processed=n_alive,
            num_segments_queried=ctx.S,
            num_segments_matched=int((outs["seg_matched"] > 0).sum()),
            num_segments_pruned=ctx.S - n_alive,
            num_blocks_pruned=int(outs["blocks_total"])
            - int(outs["blocks_scanned"]),
            total_docs=int(ctx.n_docs.sum()),
        )
        if shape == "agg":
            partials = [self._scalar_partial(i, t, outs, ctx)
                        for i, t in enumerate(agg_tpls)]
            return IntermediateResult("aggregation", agg_partials=partials,
                                      stats=stats)

        if "trim_keys" in outs:
            # the device trim ran (within numGroupsLimit, ``fetch``): the
            # fetched rows are already ordered and trimmed, keys packed
            present = np.arange(int(outs["trim_n"]))
            rem = outs["trim_keys"][present].astype(np.int64)
        else:
            # numGroupsLimit (engine default or per-query SET override):
            # excess groups drop in key order (the dense gid, the sorted
            # table's slots), and the stats flag says so
            present = np.nonzero(outs["gcount"] > 0)[0]
            limit = self.groups_limit(q)
            if len(present) > limit:
                present = present[:limit]
                stats.num_groups_limit_reached = True
            rem = outs["skeys"][present].astype(np.int64) \
                if shape == "groupby_sorted" else present.copy()
        # decode the combined key (dense: the gid itself; sorted: the key
        # recorded per table slot) → per-column global ids → values
        keys = []
        for card in reversed(group_cards[1:]):
            keys.append(rem % card)
            rem = rem // card
        keys.append(rem)
        keys.reverse()
        key_values = tuple(ctx.global_dict(col).take(k)
                           for col, k in zip(group_cols, keys))
        if q.distinct:
            return IntermediateResult("distinct", group_keys=key_values,
                                      stats=stats)
        partials = [self._group_partial(i, t, outs, ctx, present)
                    for i, t in enumerate(agg_tpls)]
        return IntermediateResult("group_by", group_keys=key_values,
                                  agg_partials=partials, stats=stats)

    @staticmethod
    def _scalar_partial(i, tpl, outs, ctx):
        name, argt, _extra = tpl
        k = f"a{i}"

        def one(key, dt=np.float64):
            return np.asarray([outs[key]], dtype=dt)

        if name == "count":
            return {"count": one("doc_count", np.int64)}
        if name == "sum":
            return {"sum": one(f"{k}_sum")}
        if name == "avg":
            return {"sum": one(f"{k}_sum"),
                    "count": one("doc_count", np.int64)}
        if name == "min":
            return {"min": one(f"{k}_min")}
        if name == "max":
            return {"max": one(f"{k}_max")}
        if name == "minmaxrange":
            return {"min": one(f"{k}_min"), "max": one(f"{k}_max")}
        if name in WITH_TIME_AGGS:
            return with_time_partial(name, outs, k, None)
        if name == "distinctcount":
            if f"{k}_cnt" in outs:  # terminal: popcount came from the card
                return {"cnt": one(f"{k}_cnt", np.int64)}
            vals = ctx.global_dict(argt).take(np.nonzero(outs[f"{k}_pres"])[0])
            sets = np.empty(1, dtype=object)
            sets[0] = set(np.asarray(vals).tolist())
            return {"sets": sets}
        if f"{k}_est" in outs:  # distinctcounthll, terminal
            return {"est": one(f"{k}_est", np.int64)}
        return {"regs": outs[f"{k}_regs"].reshape(1, -1)}

    @staticmethod
    def _group_partial(i, tpl, outs, ctx, present):
        name, argt, _extra = tpl
        k = f"a{i}"

        def sel(key, dt=np.float64):
            return outs[key][present].astype(dt)

        if name == "count":
            return {"count": sel("gcount", np.int64)}
        if name == "sum":
            return {"sum": sel(f"{k}_sum")}
        if name == "avg":
            return {"sum": sel(f"{k}_sum"),
                    "count": sel("gcount", np.int64)}
        if name == "min":
            return {"min": sel(f"{k}_min")}
        if name == "max":
            return {"max": sel(f"{k}_max")}
        if name == "minmaxrange":
            return {"min": sel(f"{k}_min"), "max": sel(f"{k}_max")}
        if name in WITH_TIME_AGGS:
            return with_time_partial(name, outs, k, present)
        if name == "distinctcount":
            if f"{k}_cnt" in outs:  # terminal: popcounts came from the card
                return {"cnt": sel(f"{k}_cnt", np.int64)}
            pres = outs[f"{k}_pres"][present]
            gvals = np.asarray(ctx.global_dict(argt).values)
            sets = np.empty(len(present), dtype=object)
            for j in range(len(present)):
                sets[j] = set(gvals[np.nonzero(pres[j])[0]].tolist())
            return {"sets": sets}
        if f"{k}_est" in outs:  # distinctcounthll, terminal
            return {"est": sel(f"{k}_est", np.int64)}
        return {"regs": outs[f"{k}_regs"][present]}
