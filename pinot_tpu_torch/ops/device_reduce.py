"""On-device final reduce: the ORDER-BY-aware group trim on the card.

Counterpart of pinot_tpu/ops/device_reduce.py. A group-by's accumulators
live on the card as (G, ...) tensors; copying all of them to the host
only for the host to keep the top-K rows makes the copy, not the
kernels, the cost of a top-K group-by. ``apply_trim`` runs after the
pipeline (and after the terminal sketch finalize) and

1. computes the query's ORDER BY keys from the accumulators: group-by
   COLUMNS order by their global-dict id component (the global
   dictionary is sorted, so id order is value order, strings included),
   aggregations by their finalized value in float64 (the host reduce
   compares finalized float64 partials, engine/reduce.py);
2. orders the table by (present-first, keys..., slot). The reference does
   it with one multi-operand ``lax.sort``; ``torch.sort`` takes one key,
   so ``lexsort_perm`` runs one stable sort per key from the last key to
   the first, which is the same lexicographic order, ties in slot order:
   the host's stable lexsort bit for bit;
3. keeps the first ``tr_k`` rows (a 0-d tensor on the card) under the
   static power-of-two bound ``T``, fills the rest with each leaf's
   neutral value, and emits the kept rows' packed group keys as
   ``trim_keys``.

The fetch then copies (T, ...) leaves instead of (G, ...) ones.

The policy is the reference's, single-sourced through
``reduce.trim_bound``:

- ``mode="terminal"`` (nothing merges after): keep ``offset+limit``,
  exact with or without ORDER BY;
- ``mode="partial"`` (the sole local partial, a broker merges after):
  keep ``max(5*(offset+limit), group_trim_size)``, ORDER BY only;
- HAVING / gapfill / post-aggregation order expressions / DISTINCT, or
  ``SET useDeviceReduce = false``: no trim.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.common.options import bool_option

INT64_SENTINEL = (1 << 63) - 1   # trimmed-away key slots

# per-launch scalars and (S,) vectors every pipeline emits: passed
# through the trim untouched (they are not group-table columns)
STAT_KEYS = frozenset((
    "doc_count", "seg_matched", "n_alive", "rows_filter",
    "blocks_total", "blocks_scanned", "n_groups_total",
))

# aggregations whose finalized value the device can order by
ORDER_AGG_FIELDS = {
    "count": "count",
    "sum": "sum",
    "avg": "avg",
    "min": "min",
    "max": "max",
    "minmaxrange": "range",
}


def next_pow2(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m <<= 1
    return m


def neutral_fill(name: str, dt):
    """The kernels' empty/masked fill for an output leaf, by naming
    convention: the key sentinel for sorted tables' and trimmed keys, the
    dtype's extremes for min / max planes, zero elsewhere."""
    dt = np.dtype(dt)
    if name in ("skeys", "trim_keys"):
        return INT64_SENTINEL
    if name.endswith("_min"):
        return np.iinfo(dt).max if dt.kind in "iu" else np.inf
    if name.endswith("_max"):
        return np.iinfo(dt).min if dt.kind in "iu" else -np.inf
    return 0


def trim_keep_count(q, mode: str, group_trim_size: int = 5000) -> int:
    """How many groups the trim keeps: the exact bound (the ``tr_k``
    param; the static bound is its power-of-two ceiling)."""
    if mode == "terminal":
        return q.offset + q.limit
    from pinot_tpu_torch.engine.reduce import trim_bound

    return trim_bound(q, group_trim_size)


def plan_trim(q, group_exprs, aggs, table_len: int, mode,
              group_trim_size: int = 5000):
    """Host-side static analysis of a group-by → trim spec ``(T,
    order_sig)`` or None.

    ``group_exprs`` / ``aggs`` are the template's enumerations (the
    order_sig indexes into them); ``table_len`` is the table the trim
    would shrink (the dense group count, or the sorted regime's cap K);
    ``mode`` is None (not a sole partial), "partial" or "terminal"."""
    if mode not in ("terminal", "partial"):
        return None
    if q.distinct or q.having is not None:
        return None
    opts = q.options_ci()
    if bool_option(opts, "usedevicereduce", None) is False:
        return None
    if opts.get("gapfillbucketms") is not None:
        return None  # gapfill synthesizes buckets from the FULL group set
    order = []
    if q.order_by:
        for ob in q.order_by:
            e = ob.expression
            ent = None
            for j, g in enumerate(group_exprs):
                if e == g:
                    ent = ("col", j, bool(ob.ascending))
                    break
            if ent is None:
                for i, a in enumerate(aggs):
                    if e == a and a.name in ORDER_AGG_FIELDS:
                        ent = ("agg", i, ORDER_AGG_FIELDS[a.name],
                               bool(ob.ascending))
                        break
            if ent is None:
                return None  # post-aggregation order expr: no trim
            order.append(ent)
    elif mode != "terminal":
        # a server partial without ORDER BY has no trim the broker merge
        # could survive
        return None
    k = trim_keep_count(q, mode, group_trim_size)
    if k <= 0:
        return None
    T = next_pow2(k)
    if T >= table_len:
        return None  # nothing to shrink; the full table is the answer
    return (T, tuple(order))


_LOW63 = (1 << 63) - 1


def order_key(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor whose order is ``v``'s order as numpy sorts it.
    Integers widen. Floats go through float64: -0.0 becomes +0.0 (numpy
    orders them equal) and every NaN the positive quiet NaN (numpy sorts
    NaN last), then the IEEE bits map to a monotone int64 (negative
    floats flip their magnitude bits), so the sort compares integers and
    no float comparison, on either device, decides a tie."""
    if not v.is_floating_point():
        return v.to(torch.int64)
    f = v.to(torch.float64)
    f = torch.where(f == 0, torch.zeros_like(f), f)
    f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
    bits = f.view(torch.int64)
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def lexsort_perm(keys) -> torch.Tensor:
    """The permutation that orders rows by ``keys`` (primary first, each
    a 1-D tensor ascending), ties in row order: ``np.lexsort`` of the
    keys in reverse, as one stable ``torch.sort`` per key from the last
    key to the first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        idx = torch.sort(order_key(k)[perm], stable=True).indices
        perm = perm[idx]
    return perm


def apply_trim(outs: dict, tr_k: torch.Tensor, template, spec,
               col_keys=None) -> dict:
    """outs (full table) → outs (T-row table), on the outputs' device.

    ``col_keys``: per group key, its (ascending, descending) (G,) int64
    order keys, for a factorized table (engine/rows.py) whose slot does
    not encode its keys; a dense table decodes them from the slot, a
    sorted regime's keyed (K,) table from its ``skeys`` (ascending, so
    slot order is key order, empties last).

    Emits

    - ``trim_keys``  (T,) int64 packed group keys (the dense gid, or the
      sorted table's key) of the kept rows, INT64_SENTINEL beyond
      ``trim_n``; a keyed table's ``skeys`` leaf gives way to it;
    - ``trim_n``     0-d int64 = min(n_present, tr_k);
    - ``n_present_total`` 0-d int64: the untrimmed non-empty group count,
      which the fetch holds against numGroupsLimit;
    - every group-table leaf gathered to (T, ...) with neutral fills
      beyond ``trim_n``; the stat leaves unchanged.
    """
    return _trim(outs, tr_k, template, spec, col_keys)


def apply_trim_members(outs: dict, tr_k: torch.Tensor, template,
                       spec) -> dict:
    """``apply_trim`` for a cohort (engine/cohort.py): every group-table
    leaf carries a leading member axis, (M, G, ...), and ``tr_k`` is (M,).
    The M tables are laid end to end and sorted once with the member as
    the primary key, so each member's rows keep the order, the ties and
    the leaves its own ``apply_trim`` gives; outputs (M, T, ...)."""
    return _trim(outs, tr_k, template, spec, members=outs["gcount"].shape[0])


def _trim(outs: dict, tr_k, template, spec, col_keys=None, members=None):
    group_cards = template[3]
    T, order = spec
    M = members or 1
    lead = 1 if members else 0
    gcount = outs["gcount"]
    G = gcount.shape[lead]
    dev = gcount.device
    table = {k: v if k in STAT_KEYS
             else v.reshape((M * G,) + tuple(v.shape[lead + 1:]))
             for k, v in outs.items()}
    gflat = table["gcount"]
    present = gflat > 0
    slots = torch.arange(G, dtype=torch.int64, device=dev).repeat(M)
    keys64 = table["skeys"] if "skeys" in table else slots

    def col_component(j: int):
        stride = 1
        for c in group_cards[j + 1:]:
            stride *= c
        return (keys64 // stride) % group_cards[j]

    def f64(v):
        return v.to(torch.float64)

    # empties last, then the ORDER BY keys; ties keep slot order
    keys = [(~present).to(torch.int64)]
    if members:  # each member's rows apart, members in order
        keys.insert(0, torch.arange(M, dtype=torch.int64,
                                    device=dev).repeat_interleave(G))
    for ent in order:
        if ent[0] == "col":
            _tag, j, asc = ent
            if col_keys is not None:
                keys.append(col_keys[j][0 if asc else 1])
                continue
            k = col_component(j)
        else:
            _tag, i, field, asc = ent
            if field == "count":
                k = gflat.to(torch.int64)
            elif field == "sum":
                k = f64(table[f"a{i}_sum"])
            elif field == "avg":
                k = f64(table[f"a{i}_sum"]) / f64(gflat)
            elif field == "min":
                k = f64(table[f"a{i}_min"])
            elif field == "max":
                k = f64(table[f"a{i}_max"])
            else:  # minmaxrange
                k = f64(table[f"a{i}_max"]) - f64(table[f"a{i}_min"])
        # descending: the host's negation (ints in int64, floats in f64;
        # slot components are non-negative, so negation is order-exact)
        keys.append(k if asc else -k)
    perm = lexsort_perm(keys).reshape(M, G)[:, :T]
    n_present = present.reshape(M, G).sum(dim=1, dtype=torch.int64)
    trim_n = torch.minimum(n_present, tr_k.reshape(-1).to(torch.int64))
    valid = torch.arange(T, dtype=torch.int64, device=dev)[None, :] \
        < trim_n[:, None]

    trimmed = {}
    for name, v in table.items():
        if name in STAT_KEYS:
            trimmed[name] = v
            continue
        if name == "skeys":
            continue  # replaced by trim_keys
        g = v[perm]
        fill = neutral_fill(name, torch.empty(0, dtype=g.dtype).numpy().dtype)
        mask = valid.reshape((M, T) + (1,) * (g.dim() - 2))
        g = torch.where(mask, g, torch.tensor(fill, dtype=g.dtype, device=dev))
        trimmed[name] = g if members else g[0]
    # a dense table's packed key is its slot: the permutation itself
    trim_keys = torch.where(
        valid, keys64[perm],
        torch.tensor(INT64_SENTINEL, dtype=torch.int64, device=dev))
    trimmed["trim_keys"] = trim_keys if members else trim_keys[0]
    trimmed["trim_n"] = trim_n if members else trim_n[0]
    trimmed["n_present_total"] = n_present if members else n_present[0]
    return trimmed
