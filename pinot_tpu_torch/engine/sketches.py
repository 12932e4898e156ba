"""The digest and sketch aggregations in the host path's shape, on the card.

The JAX package's device refuses the PERCENTILE family, the theta
sketches, SUMPRECISION, MODE, IDSET, DISTINCTCOUNTRAWHLL and
DISTINCTCOUNTSMARTHLL (its engine/device.py ``DEVICE_AGGS``); its host
path builds one partial per segment (engine/aggspec.py ``host_groups``)
and folds them in segment order (engine/reduce.py
``merge_intermediates``, the specs' ``scatter_merge``). engine/rows.py
runs these shapes on the card; this module gives each aggregation the
device leaves it fetches and the partial it finishes into: the
reference's own partial, keyed the same way, built by the port's copy of
the reference's specs wherever a state is merged.

Per aggregation, over the rows it takes (the filter, the group-by's
numGroupsLimit) keyed by run, ``segment * G + group``
(ops/sketch_build.py):

- PERCENTILE, PERCENTILEEST, PERCENTILE(SMART)TDIGEST, PERCENTILERAWEST,
  PERCENTILERAWTDIGEST: the values as float64 without NaN, sorted per run;
  each run's cluster schedule on the host (ops/digest.py), K5's ordered
  cluster sums and one division on the card: every segment's digest bit
  for bit, then the reference's fold over segments (``qd.merge``, an
  order-dependent re-compression: never over the whole batch at once);
- DISTINCTCOUNT(RAW)THETASKETCH: 63-bit hashes at the value's dtype, each
  run's k smallest distinct ones and its theta (the set form: one mask a
  filter, each compiled by engine/params.py ``build_filter``), folded by
  the reference's ``theta.merge``;
- SUMPRECISION over integers: the values after a frame-of-reference
  offset, split into byte planes and summed per group by K1 at any row
  and group count (exact integers below 2^53 each), recombined as Python
  ints; a span of 2^63 or more goes in as two 32-bit halves. Integer
  sums do not depend on order, so the batch is summed at once;
- MODE, IDSET, DISTINCTCOUNTSMARTHLL: each run's distinct values with
  counts and first rows; the host builds the reference's dicts and sets
  in the order it meets the values (the first of two equal zeros keeps
  its sign, every NaN row is its own key); a DISTINCTCOUNTSMARTHLL run
  past its threshold becomes K3 registers over its values' hashes at the
  dtype numpy gives the set's values (int64, float64 or strings);
- DISTINCTCOUNTRAWHLL, and DISTINCTCOUNTHLL over a raw column (the
  reference's device reads dict columns only): K3 registers over the
  batch's stored hash plane (register max is order-free);
- the star-tree's merges over a cube's serialized states
  (engine/startree_exec.py): SUMPRECISIONMERGE parses each dictionary
  entry's decimal string once and sums the rows' integers through K1's
  byte planes as SUMPRECISION does; BITMAPMERGE builds the (group,
  dictionary id) pairs present on the card and unions each present
  entry's value set, parsed once; TDIGESTMERGE orders the matched cube
  rows by (segment, group) on the card, keeping row order, and folds
  their digests with the port's copy of the reference's
  ``TDigestMergeSpec``, per group in row order, then over segments in
  segment order, so every digest is bit-equal.

The JAX package's device has no form for any of these, so none of its
gates (PALLAS_MIN_ROWS, the accumulator regimes) applies: on the card
every one launches its kernel, whatever the batch's size. Each leaf is
keyed ``s{i}_...`` by the aggregation's index in the query.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.engine import aggspec
from pinot_tpu_torch.engine.params import DeviceUnsupported, to_device
from pinot_tpu_torch.engine.values import (
    Rows,
    Val,
    ValueEvaluator,
    _torch_dtype,
    host_fails,
)
from pinot_tpu_torch.ops import digest
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops import sketch_build as sb
from pinot_tpu_torch.ops import theta as theta_ops
from pinot_tpu_torch.sql.compiler import _to_filter

PERCENTILES = ("percentile", "percentileest", "percentiletdigest",
               "percentilesmarttdigest", "percentilerawest",
               "percentilerawtdigest")
THETAS = ("distinctcountthetasketch", "distinctcountrawthetasketch")
CUBE_MERGES = ("tdigestmerge", "bitmapmerge", "sumprecisionmerge")
NAMES = PERCENTILES + THETAS + CUBE_MERGES + (
    "sumprecision", "mode", "idset", "distinctcountrawhll",
    "distinctcountsmarthll")

_INT63 = 1 << 63


class Batch:
    """The rows an aggregation takes over an (S, L) batch: ``mask`` (S*L,)
    bool, and ``gid`` (S*L,) int32 group ids with ``G`` the overflow id
    (None for one group)."""

    def __init__(self, ev: ValueEvaluator, mask, gid, G: int):
        self.ev, self.ctx = ev, ev.ctx
        self.S, self.L = ev.S, ev.L
        self.mask, self.gid, self.G = mask.reshape(-1), gid, G
        self.dev = ev.device

    @classmethod
    def joined(cls, ev: ValueEvaluator, gid, G: int) -> "Batch":
        """The multi-stage engine's joined rows laid out as a batch of one
        segment (``ev`` over them: S = 1, L = the row count), every row
        taken, ``gid`` their (n,) group ids (None: one group). Each
        sketch's one segment partial is then the answer, as the
        reference's stage 2 builds it from all joined rows at once."""
        mask = torch.ones(ev.L, dtype=torch.bool, device=ev.device)
        ids = None if gid is None else gid.reshape(-1).to(torch.int32)
        return cls(ev, mask, ids, G)

    def flat(self, t: torch.Tensor) -> torch.Tensor:
        return torch.broadcast_to(t, (self.S, self.L)).reshape(-1)

    def run_key(self, idx: torch.Tensor) -> torch.Tensor:
        """segment * G + group of flat rows ``idx``."""
        seg = idx // self.L
        if self.gid is None:
            return seg
        return seg * self.G + self.gid.reshape(-1)[idx].to(torch.int64)

    def kernel_ids(self):
        """(int32 ids with the overflow id on rows not taken, group
        count) for the kernels' group entries."""
        if self.gid is not None:
            return self.gid.reshape(-1), self.G
        return torch.where(self.mask, 0, 1).to(torch.int32), 1


def plan(i: int, a, ev: ValueEvaluator, filter_plane):
    """The sketch of aggregation ``a`` (index ``i``), checked before
    anything runs. ``filter_plane(FilterNode) -> (S, L) bool`` compiles
    the theta set form's filters."""
    spec = aggspec.make_spec(a)
    name = a.name
    if name in PERCENTILES:
        return _Percentile(i, spec, ev)
    if name in THETAS:
        return _Theta(i, spec, ev, filter_plane)
    if name == "sumprecision":
        return _SumPrecision(i, spec, ev)
    if name in ("distinctcountrawhll", "distinctcounthll", "fasthll"):
        return _RawHLL(i, spec, ev)
    if name == "sumprecisionmerge":
        return _SumPrecisionMerge(i, spec, ev)
    if name == "bitmapmerge":
        return _BitmapMerge(i, spec, ev)
    if name == "tdigestmerge":
        return _TDigestMerge(i, spec, ev)
    return _ValueSet(i, spec, ev)


def _numeric(spec, ev: ValueEvaluator, what: str):
    """The operand's values as the host's float64 read takes them
    (numeric strings parsed, engine/values.py ``numeric``)."""
    return ev.numeric(ev.eval(spec.args[0], Rows(ev.S, ev.L, ev.device)),
                      f"{what}({spec.args[0]})")


def _registers(h, gid, mask, G: int, log2m: int) -> torch.Tensor:
    """(G, m) int8 HLL registers through K3, from the int32 hash plane
    ``h``: the group entry for ids (rows with id G add nothing), the
    small-slot entry for one group under ``mask``."""
    if gid is None:
        regs = ps.hll_register_max(h, log2m, mask=mask)
    else:
        regs = mm.hll_registers(h, gid, G, log2m)
    return regs.reshape(G, 1 << log2m).to(torch.int8)


def _segment_parts(rk: np.ndarray, G: int) -> list:
    """Per segment in order, the slice of the rk-sorted runs it holds."""
    cuts = np.flatnonzero(np.diff(rk // G)) + 1
    bounds = [0, *cuts.tolist(), len(rk)]
    return [slice(s, e) for s, e in zip(bounds, bounds[1:]) if e > s]


def _fold(spec, G: int, present, parts, place: bool = False) -> dict:
    """The reference's merge of per-segment partials, in segment order:
    ``parts`` lists (groups, partial) of each segment that has runs;
    ``present`` the group ids of the result's rows (None: one group).
    ``place``: the one part is the answer (joined rows, ``Batch.joined``),
    put at its groups' rows, no merge (a digest merge re-compresses)."""
    n = 1 if present is None else len(present)
    pos = np.full(max(G, 1), -1, dtype=np.int64)
    pos[np.asarray([0] if present is None else present, dtype=np.int64)] \
        = np.arange(n)
    acc = spec.empty(n)
    for groups, part in parts:
        rows = pos[groups]
        if (rows < 0).any():
            raise AssertionError(
                f"{spec.name}: a run of group(s) "
                f"{np.asarray(groups)[rows < 0][:5].tolist()} has no row "
                "in the result")
        if place:
            for key, vals in part.items():
                if acc[key].dtype != np.asarray(vals).dtype:
                    acc[key] = acc[key].astype(object)
                acc[key][rows] = vals
        else:
            spec.scatter_merge(acc, rows, part)
    return acc


class _Sketch:
    def __init__(self, i: int, spec, ev: ValueEvaluator):
        self.i, self.spec, self.ev = i, spec, ev
        self.k = f"s{i}"

    def _fold(self, present, parts) -> dict:
        return _fold(self.spec, self.G, present, parts,
                     getattr(self.ev, "joined", False))

    def launch(self, b: Batch) -> dict:
        raise NotImplementedError

    def partial(self, host: dict, present) -> dict:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# PERCENTILE family: t-digests bit for bit
# ---------------------------------------------------------------------------


class _Percentile(_Sketch):
    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        self.v = _numeric(spec, ev, spec.name.upper())
        self.G = 1
        self.runs = np.zeros(0, dtype=np.int64)
        self.sizes: list = []

    def launch(self, b):
        x = b.flat(self.v.t).to(torch.float64)
        idx = torch.nonzero(b.mask & ~torch.isnan(x)).reshape(-1)
        sv, runs, lengths = sb.sorted_runs(b.run_key(idx), x[idx])
        host = torch.stack([runs, lengths]).cpu().numpy()
        self.G, self.runs = b.G, host[0]
        delta = float(self.spec.compression)
        self.sizes = [digest.schedule(int(n), delta) for n in host[1]]
        flat = np.fromiter((s for sz in self.sizes for s in sz),
                           dtype=np.int64)
        off = np.zeros(len(flat) + 1, dtype=np.int64)
        np.cumsum(flat, out=off[1:])
        sums = kernels.cluster_sums(sv, to_device(off, b.dev))
        return {f"{self.k}_means":
                sums / to_device(flat.astype(np.float64), b.dev)}

    def partial(self, host, present):
        means = np.asarray(host[f"{self.k}_means"])
        c0 = np.zeros(len(self.sizes) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in self.sizes], out=c0[1:])
        parts = []
        for sl in _segment_parts(self.runs, self.G):
            r = range(sl.start, sl.stop)
            m = aggspec._obj_array(len(r), list)
            w = aggspec._obj_array(len(r), list)
            for j, run in enumerate(r):
                m[j] = means[c0[run]:c0[run + 1]].tolist()
                w[j] = [float(s) for s in self.sizes[run]]
            parts.append((self.runs[sl] % self.G,
                          {"means": m, "weights": w}))
        return self._fold(present, parts)


# ---------------------------------------------------------------------------
# theta sketches
# ---------------------------------------------------------------------------


def _hash32(v, ev: ValueEvaluator, arg, b: Batch) -> torch.Tensor:
    """The 32-bit canonical hash of each row's value, int64 (S*L,)."""
    if v.kind == "dict" and arg.is_identifier:
        # the strings' murmur hashes, gathered at upload
        plane = b.ctx.prehashed_column(arg.name)
        return plane.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    return b.flat(ev.hash32(v))


class _Theta(_Sketch):
    def __init__(self, i, spec, ev, filter_plane):
        super().__init__(i, spec, ev)
        self.v = ev.eval(spec.args[0], Rows(ev.S, ev.L, ev.device))
        # the set form's filters: one more mask each
        self.filters = [filter_plane(_to_filter(f)) for f in spec.filters]
        self.G = 1

    def launch(self, b):
        self.G = b.G
        h = sb.hash63(_hash32(self.v, self.ev, self.spec.args[0], b))
        masks = [b.mask] if not self.filters else \
            [b.mask & f.reshape(-1) for f in self.filters]
        outs = {}
        for j, m in enumerate(masks):
            idx = torch.nonzero(m).reshape(-1)
            got = sb.kmv(b.run_key(idx), h[idx], self.spec.k)
            for name, t in zip(("rk", "h", "trk", "th"), got):
                outs[f"{self.k}_{j}_{name}"] = t
        return outs

    def partial(self, host, present):
        keys = self.spec._sketch_keys()
        max_hash = float(theta_ops.MAX_HASH)
        per_seg: dict = {}    # seg -> {group: {j: (theta, hashes)}}
        for j in range(len(keys)):
            rk = np.asarray(host[f"{self.k}_{j}_rk"])
            hs = np.asarray(host[f"{self.k}_{j}_h"])
            cuts = np.flatnonzero(np.diff(rk)) + 1
            for run_h, run_k in zip(np.split(hs, cuts), np.split(rk, cuts)):
                if len(run_k):
                    seg, g = divmod(int(run_k[0]), self.G)
                    per_seg.setdefault(seg, {}).setdefault(g, {})[j] = \
                        [max_hash, run_h.tolist()]
            for r, th in zip(np.asarray(host[f"{self.k}_{j}_trk"]).tolist(),
                             np.asarray(host[f"{self.k}_{j}_th"]).tolist()):
                seg, g = divmod(int(r), self.G)
                per_seg[seg][g][j][0] = float(th)
        parts = []
        for seg in sorted(per_seg):
            groups = sorted(per_seg[seg])
            part = self.spec.empty(len(groups))
            for row, g in enumerate(groups):
                for j, (th, hl) in per_seg[seg][g].items():
                    tk, hk = keys[j]
                    part[tk][row] = th
                    part[hk][row] = hl
            parts.append((np.asarray(groups, dtype=np.int64), part))
        return self._fold(present, parts)


# ---------------------------------------------------------------------------
# SUMPRECISION: K1's byte planes, exact decimals by one scale
# ---------------------------------------------------------------------------


def _int_sums(b: Batch, x: torch.Tensor, m: torch.Tensor):
    """(K1's (1 + planes, G) sums of the int64 values ``x`` over the rows
    ``m`` with the count in row 0, their layout: (offset, nplanes, shift)
    per source). The values after a frame-of-reference offset, split into
    byte planes; a span of 2^63 or more goes in as two 32-bit halves."""
    ids, G = b.kernel_ids()
    big = torch.iinfo(torch.int64)
    lo_hi = torch.stack([torch.where(m, x.to(torch.int64), big.max).min(),
                         torch.where(m, x.to(torch.int64), big.min).max()])
    lo, hi = (int(z) for z in lo_hi.cpu().tolist())
    if lo > hi:            # no row: every sum is 0
        lo = hi = 0
    if hi - lo < _INT63:
        parts = [(x, lo, mm.int_planes_needed(lo, hi), 0)]
    else:   # the span wraps int64: two 32-bit halves
        x64 = x.to(torch.int64)
        parts = [(x64 >> 32, -(1 << 31), 4, 32),
                 (x64 & 0xFFFFFFFF, 0, 4, 0)]
    sources = []
    for vals, off, nplanes, _shift in parts:
        if vals.dtype not in kernels.K1_INT_DTYPES:
            vals = vals.to(torch.int64)
        sources.append(kernels.PlaneSource(
            vals.contiguous(), "int", nplanes, None,
            torch.tensor(off, dtype=torch.int64, device=b.dev)))
    layout = [(off, nplanes, shift) for _v, off, nplanes, shift in parts]
    # K1 partitions any group count over its grid
    return ps.plane_group_sums(ids, sources, G, count=True), layout


def _recombine(sums: np.ndarray, cols, layout) -> list:
    """Python ints of ``_int_sums``' planes at the groups ``cols``."""
    # every plane sum is an exact integer below 2^53: int64, then Python
    # ints (object arrays) for the weighted recombination
    planes = np.rint(sums[:, cols]).astype(np.int64).astype(object)
    count = planes[0]
    tot = np.zeros(len(count), dtype=object)
    row = 1
    for off, nplanes, shift in layout:
        part = count * off
        for p in range(nplanes):
            part = part + (planes[row + p] << (8 * p))
        tot = tot + (part << shift)
        row += nplanes
    return [int(x) for x in tot.tolist()]


_FINITE, _NAN, _PINF, _NINF = 0, 1, 2, 3
_DEC_DIGITS = 28     # the default decimal context's precision
_LIMB_BITS = 62      # a scaled summand's limbs, each one K1 source
_MAX_LIMBS = 4


def _decimal_terms(table: list) -> tuple:
    """Per distinct exact summand (the reference's Python int or
    Decimal): (kind, coefficient, exponent), the exponent of an int 0,
    of a Decimal at most 0 (its sum with the int start has it)."""
    import decimal

    kinds, coefs, exps = [], [], []
    for x in table:
        if isinstance(x, decimal.Decimal) and not x.is_finite():
            kinds.append(_NAN if x.is_nan() else
                         _NINF if x.is_signed() else _PINF)
            coefs.append(0)
            exps.append(0)
            continue
        kinds.append(_FINITE)
        if isinstance(x, decimal.Decimal):
            sign, digits, e = x.as_tuple()
            c = int("".join(map(str, digits)) or "0")
            coefs.append(-c if sign else c)
            exps.append(int(e))
        else:
            coefs.append(int(x))
            exps.append(0)
    return kinds, coefs, exps


class _SumPrecision(_Sketch):
    """SUMPRECISION. Integers (and integral floats): K1's byte planes,
    order-free, the batch summed at once. Fractions, as the reference
    adds them (``Decimal(repr(v))`` one at a time into an int 0 under the
    28-digit context): each distinct value's exact decimal found once on
    the host, scaled by the batch's least exponent E to an int64 V; K1
    sums V and |V| per group, K2 takes each group's least exponent e_g.
    While a group's sum of |v| has at most 28 digits at e_g, no addition
    rounds in any order: its answer is the exact sum at e_g (an int where
    the group holds no fraction). NaN and the infinities follow Decimal:
    NaN absorbs, +inf meeting -inf before any NaN fails the reference."""

    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        self.v = _numeric(spec, ev, "SUMPRECISION")
        self.layout: list = []     # (offset, nplanes, shift) per source
        self.dec = None            # the decimal route's state

    def launch(self, b):
        x = b.flat(self.v.t)
        m = b.mask
        if x.is_floating_point():
            xm = torch.where(m, x.to(torch.float64), 0.0)
            exact = torch.isfinite(xm) & (xm == torch.trunc(xm)) \
                & (xm.abs() < float(_INT63))
            if not bool(exact.all()):
                return self._fractions(b, x.to(torch.float64))
            x = xm.to(torch.int64)
        elif x.dtype == torch.bool:
            x = x.to(torch.int64)
        sums, self.layout = _int_sums(b, x, m)
        return {f"{self.k}_planes": sums}

    def _fractions(self, b, x):
        from pinot_tpu_torch.ops.geo import float_bits

        idx = torch.nonzero(b.mask).reshape(-1)
        uniq, inv = torch.unique(float_bits(x[idx]), return_inverse=True)
        vals = uniq.cpu().numpy().view(np.float64).tolist()
        return self._decimal_launch(b, idx, inv, [
            aggspec.SumPrecisionSpec._exact(v) for v in vals])

    def _decimal_launch(self, b, idx, inv, table) -> dict:
        """The summands of the rows ``idx``: ``table[inv]``."""
        kinds, coefs, exps = _decimal_terms(table)
        E = min([min(e, 0) for e in exps] or [0])
        scaled = [c * 10 ** (e - E) for c, e in zip(coefs, exps)]
        # V in signed 62-bit limbs: V = sum_j limb_j << 62 j, each limb
        # with V's sign, so |V| = sum_j |limb_j| << 62 j
        bits = max([abs(v).bit_length() for v in scaled] or [0])
        n_limbs = max(1, -(-bits // _LIMB_BITS))
        if n_limbs > _MAX_LIMBS:
            raise DeviceUnsupported(
                "SUMPRECISION: a summand at the batch's least exponent "
                f"10^{E} is past 2^{_LIMB_BITS * _MAX_LIMBS}, which the "
                "port does not sum (ROADMAP queue 3)")
        dev, n = b.dev, b.S * b.L
        inv = inv.to(torch.int64)
        mask62 = (1 << _LIMB_BITS) - 1
        outs, layouts = {}, []
        for j in range(n_limbs):
            limb = [(-1 if v < 0 else 1) * ((abs(v) >> (_LIMB_BITS * j))
                                            & mask62) for v in scaled]
            V = torch.zeros(n, dtype=torch.int64, device=dev)
            V[idx] = to_device(np.asarray(limb, dtype=np.int64), dev)[inv]
            outs[f"{self.k}_planes{j}"], lay_v = _int_sums(b, V, b.mask)
            outs[f"{self.k}_abs{j}"], lay_a = _int_sums(b, V.abs(), b.mask)
            layouts.append((lay_v, lay_a))
        X = torch.zeros(n, dtype=torch.int32, device=dev)
        X[idx] = to_device(np.asarray([min(e, 0) for e in exps],
                                      dtype=np.int32), dev)[inv]
        ids, G = b.kernel_ids()
        if ps.minmax_supported(G, torch.int32):
            (emin,), = ps.group_minmax_sources(ids, [kernels.MinMaxSource(
                X, ("min",), (0,))], G)
        else:   # past K2's group bound: the torch scatter
            emin = torch.zeros(G + 1, dtype=torch.int32, device=dev) \
                .scatter_reduce_(0, ids.to(torch.int64), X, "amin")[:G]
        outs[f"{self.k}_emin"] = emin
        special = to_device(np.asarray(kinds, dtype=np.int64), dev)[inv]
        sp = torch.nonzero(special != _FINITE).reshape(-1)
        if sp.numel():
            # per (run, kind) the first row: where each NaN / infinity
            # enters the reference's additions
            key = b.run_key(idx[sp]) * 4 + special[sp]
            first, kinv = torch.unique(key, return_inverse=True)
            pos = torch.full((first.numel(),), n, dtype=torch.int64,
                             device=dev).scatter_reduce_(
                0, kinv, idx[sp], "amin")
            outs[f"{self.k}_spk"], outs[f"{self.k}_spp"] = first, pos
        self.dec = (E, layouts, b.G)
        return outs

    def partial(self, host, present):
        cols = [0] if present is None else present
        if self.dec is None:
            tot = _recombine(np.asarray(host[f"{self.k}_planes"]), cols,
                             self.layout)
        else:
            tot = self._decimals(host, cols)
        out = aggspec._obj_array(len(cols), int)
        out[:] = tot
        return {"psum": out}

    def _decimals(self, host, cols) -> list:
        import decimal

        E, layouts, G = self.dec
        tot = [0] * len(cols)
        mag = [0] * len(cols)
        for j, (lay_v, lay_a) in enumerate(layouts):
            t = _recombine(np.asarray(host[f"{self.k}_planes{j}"]), cols,
                           lay_v)
            a = _recombine(np.asarray(host[f"{self.k}_abs{j}"]), cols, lay_a)
            tot = [x + (y << (_LIMB_BITS * j)) for x, y in zip(tot, t)]
            mag = [x + (y << (_LIMB_BITS * j)) for x, y in zip(mag, a)]
        emin = np.asarray(host[f"{self.k}_emin"]).reshape(-1)[cols]
        states = self._special_states(host, G)
        out = []
        for j, g in enumerate(np.asarray(cols).tolist()):
            st = states.get(int(g))
            if st is not None:
                out.append(decimal.Decimal(st))
                continue
            eg = int(emin[j])
            if mag[j] >= 10 ** (_DEC_DIGITS + eg - E):
                raise DeviceUnsupported(
                    "SUMPRECISION: a group's sum needs more than 28 digits "
                    "at its exponent, where the reference's answer depends "
                    "on the order of its additions (ROADMAP queue 3)")
            if eg == 0:
                out.append(tot[j] // 10 ** (-E))
                continue
            c = abs(tot[j]) // 10 ** (eg - E)
            out.append(decimal.Decimal(
                (1 if tot[j] < 0 else 0, tuple(int(d) for d in str(c)), eg)))
        return out

    def _special_states(self, host, G: int) -> dict:
        """group -> "NaN" / "Infinity" / "-Infinity", the Decimal a group
        holding a NaN or an infinity ends at: per segment in row order,
        then over segments in order, as the reference adds and merges."""
        if f"{self.k}_spk" not in host:
            return {}
        keys = np.asarray(host[f"{self.k}_spk"]).tolist()
        pos = np.asarray(host[f"{self.k}_spp"]).tolist()
        first: dict = {}
        for k, p in zip(keys, pos):
            run, kind = divmod(int(k), 4)
            first.setdefault(run, {})[kind] = int(p)
        per_group: dict = {}
        for run in sorted(first):
            seg, g = divmod(run, G)
            fp = first[run]
            nan, pinf, ninf = (fp.get(x) for x in (_NAN, _PINF, _NINF))
            if pinf is not None and ninf is not None \
                    and (nan is None or nan > max(pinf, ninf)):
                raise _inf_clash()
            st = "NaN" if nan is not None else \
                "Infinity" if pinf is not None else "-Infinity"
            acc = per_group.get(g)
            if acc is not None and acc != st and "NaN" not in (acc, st):
                raise _inf_clash()
            per_group[g] = "NaN" if "NaN" in (acc, st) else st
        return per_group


def _inf_clash():
    import decimal

    from pinot_tpu_torch.engine.values import host_fails

    try:
        decimal.Decimal("Infinity") + decimal.Decimal("-Infinity")
    except decimal.InvalidOperation as err:
        return host_fails("SUMPRECISION adding +inf and -inf", err)
    raise AssertionError("Decimal adds +inf and -inf")


class _SumPrecisionMerge(_SumPrecision):
    """SUMPRECISIONMERGE: each cube row's decimal string, parsed once per
    dictionary entry the matched rows hold; integers through
    SUMPRECISION's byte planes, fractions through its decimal route."""

    def __init__(self, i, spec, ev):
        _Sketch.__init__(self, i, spec, ev)
        self.ids = _state_ids(spec, ev)
        self.layout = []
        self.dec = None

    def launch(self, b):
        from pinot_tpu_torch.engine.values import host_fails

        idx = torch.nonzero(b.mask).reshape(-1)
        used, inv = torch.unique(b.flat(self.ids.t)[idx].to(torch.int64),
                                 return_inverse=True)
        blobs = self.ev.ctx.global_dict(self.ids.meta).take(
            used.cpu().numpy())
        table = []
        for blob in np.asarray(blobs).tolist():
            try:
                table.append(aggspec.SumPrecisionMergeSpec._parse(blob))
            except Exception as err:  # noqa: BLE001 — the host's failure
                raise host_fails(f"SUMPRECISIONMERGE of {blob!r}",
                                 err) from err
        if all(isinstance(x, int) and -_INT63 <= x < _INT63
               for x in table):
            vals = to_device(np.asarray(table or [0], dtype=np.int64),
                             b.dev)
            x = torch.zeros(b.S * b.L, dtype=torch.int64, device=b.dev)
            x[idx] = vals[inv]
            sums, self.layout = _int_sums(b, x, b.mask)
            return {f"{self.k}_planes": sums}
        return self._decimal_launch(b, idx, inv, table)


def _state_ids(spec, ev: ValueEvaluator) -> Val:
    """The global dictionary ids of a cube's state column (a BYTES dict
    column, one serialized state per cube row)."""
    v = ev.eval(spec.args[0], Rows(ev.S, ev.L, ev.device))
    if v.kind != "dict":
        raise ValueError(f"{spec.name.upper()} reads a BYTES state column, "
                         f"got {spec.args[0]}")
    return v


class _BitmapMerge(_Sketch):
    """BITMAPMERGE: the (group, dictionary id) pairs present, built on the
    card; each present entry's value set parsed once and unioned per
    group (set union is order-free, so the batch folds at once)."""

    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        self.ids = _state_ids(spec, ev)
        self.D = max(len(ev.ctx.global_dict(self.ids.meta)), 1)

    def launch(self, b):
        idx = torch.nonzero(b.mask).reshape(-1)
        ids = b.flat(self.ids.t).reshape(-1)[idx].to(torch.int64)
        g = torch.zeros_like(ids) if b.gid is None \
            else b.gid.reshape(-1)[idx].to(torch.int64)
        return {f"{self.k}_pairs": torch.unique(g * self.D + ids)}

    def partial(self, host, present):
        pairs = np.asarray(host[f"{self.k}_pairs"])
        g, ids = pairs // self.D, pairs % self.D
        gvals = np.asarray(self.ev.ctx.global_dict(self.ids.meta).values)
        parsed = {int(d): aggspec.set_from_bytes(gvals[d])
                  for d in np.unique(ids).tolist()}
        groups = np.zeros(1, dtype=np.int64) if present is None else present
        pos = {int(x): j for j, x in enumerate(np.asarray(groups).tolist())}
        sets = aggspec._obj_array(len(groups), set)
        for gg, d in zip(g.tolist(), ids.tolist()):
            sets[pos[gg]] |= parsed[d]
        return {"sets": sets}


class _TDigestMerge(_Sketch):
    """TDIGESTMERGE: the matched cube rows ordered by (segment, group) on
    the card, row order kept; on the host each segment's digests fold by
    the reference's ``TDigestMergeSpec.host_groups`` (per group in row
    order), then the segments by ``_fold``."""

    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        self.ids = _state_ids(spec, ev)
        self.G = 1

    def launch(self, b):
        self.G = b.G
        idx = torch.nonzero(b.mask).reshape(-1)
        rk = b.run_key(idx)
        order = torch.sort(rk, stable=True).indices
        ids = b.flat(self.ids.t).reshape(-1)[idx]
        return {f"{self.k}_rk": rk[order], f"{self.k}_id": ids[order]}

    def partial(self, host, present):
        rk = np.asarray(host[f"{self.k}_rk"])
        ids = np.asarray(host[f"{self.k}_id"]).astype(np.int64)
        gvals = np.asarray(self.ev.ctx.global_dict(self.ids.meta).values)
        parts = []
        for sl in _segment_parts(rk, self.G):
            groups, local = np.unique(rk[sl] % self.G, return_inverse=True)
            parts.append((groups, self.spec.host_groups(
                [gvals[ids[sl]]], local, len(groups))))
        return self._fold(present, parts)


# ---------------------------------------------------------------------------
# DISTINCTCOUNTRAWHLL: K3 registers
# ---------------------------------------------------------------------------


class _RawHLL(_Sketch):
    """K3 registers over a column's stored hash plane, or over an
    expression's values hashed as the host hashes their dtype."""

    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        arg = spec.args[0]
        self.v = None
        if not arg.is_identifier or arg.name.startswith("$"):
            self.v = ev.eval(arg, Rows(ev.S, ev.L, ev.device))
        else:
            ev.column_dtype(arg.name)

    def launch(self, b):
        if self.v is None:
            h = b.ctx.prehashed_column(self.spec.args[0].name).reshape(-1)
        else:
            h = b.flat(self.ev.hash32(self.v)).to(torch.int32)
        if b.gid is None:
            regs = _registers(h, None, b.mask, 1, self.spec.log2m)
        else:
            regs = _registers(h, b.gid.reshape(-1), None, b.G,
                              self.spec.log2m)
        return {f"{self.k}_regs": regs}

    def partial(self, host, present):
        regs = np.asarray(host[f"{self.k}_regs"]).astype(np.int32)
        return {"regs": regs if present is None else regs[present]}


# ---------------------------------------------------------------------------
# MODE, IDSET, DISTINCTCOUNTSMARTHLL: each run's distinct values
# ---------------------------------------------------------------------------


class _ValueSet(_Sketch):
    def __init__(self, i, spec, ev):
        super().__init__(i, spec, ev)
        self.v = ev.materialize(ev.eval(spec.args[0],
                                        Rows(ev.S, ev.L, ev.device)))
        name = spec.name
        if name == "mode" and (self.v.kind != "num"
                               or self.v.dtype.kind not in "iuf"):
            raise ValueError(
                "MODE requires a numeric column (reference "
                "ModeAggregationFunction supports INT/LONG/FLOAT/DOUBLE "
                "only)")
        if self.v.kind == "list":
            raise host_fails(f"{name.upper()} over {spec.args[0]}",
                             TypeError("unhashable type: 'list'"))
        self.smart = name == "distinctcountsmarthll"
        self.G = 1

    def launch(self, b):
        self.G = b.G
        idx = torch.nonzero(b.mask).reshape(-1)
        # keys equal where the host's dict / set keys are: both zeros one
        # key, each NaN row apart, strings by global dictionary id
        vkey = self.ev.set_key(self.v, (b.S, b.L)).reshape(-1)
        rk, counts, first = sb.value_runs(b.run_key(idx), vkey[idx], idx)
        # numbers come back as values, anything else as its key
        rep = b.flat(self.v.t)[first] if self.v.kind == "num" \
            else vkey[first]
        outs = {f"{self.k}_rk": rk, f"{self.k}_cnt": counts,
                f"{self.k}_first": first, f"{self.k}_rep": rep}
        if self.smart:
            outs.update(self._past_threshold(b, rk, first, rep))
        return outs

    def _past_threshold(self, b, rk, first, rep) -> dict:
        """K3 registers of each run past the threshold, over its values
        hashed at the dtype numpy gives a set of them (Python ints:
        int64, floats: float64, bools: bool, strings: their murmur
        hashes)."""
        runs, inv, n_vals = torch.unique_consecutive(
            rk, return_inverse=True, return_counts=True)
        over = n_vals > self.spec.threshold
        over_runs = runs[over]
        oid = torch.cumsum(over.to(torch.int64), 0) - 1
        take = over[inv]
        if not bool(take.any()):
            return {f"{self.k}_over": over_runs}
        if self.v.kind != "num":
            h = b.flat(self.ev.hash32(self.v))[first[take]].to(torch.int32)
        else:
            wide = {"f": np.float64, "b": np.bool_}.get(self.v.dtype.kind,
                                                        np.int64)
            vals = rep[take].to(_torch_dtype(np.dtype(wide)))
            h = sb.hash32_values(vals, wide).to(torch.int32)
        regs = _registers(h.contiguous(), oid[inv][take].to(torch.int32),
                          None, int(over_runs.numel()), self.spec.log2m)
        return {f"{self.k}_over": over_runs, f"{self.k}_regs": regs}

    def _values(self, host) -> list:
        rep = np.asarray(host[f"{self.k}_rep"])
        if self.v.kind != "num":
            return self.ev.decode_key(self.v, rep).tolist()
        return self.ev.decode(self.v, rep).tolist()

    def partial(self, host, present):
        rk = np.asarray(host[f"{self.k}_rk"])
        counts = np.asarray(host[f"{self.k}_cnt"]).tolist()
        first = np.asarray(host[f"{self.k}_first"])
        vals = self._values(host)
        over, regs = {}, None
        if self.smart:
            over = {int(r): j for j, r in
                    enumerate(np.asarray(host[f"{self.k}_over"]).tolist())}
            regs = host.get(f"{self.k}_regs")
        # the order the host meets values in: by run, then first row
        order = np.lexsort((first, rk))
        parts = []
        for sl in _segment_parts(rk[order], self.G):
            rows = order[sl]
            run_of = rk[rows]
            cuts = np.flatnonzero(np.diff(run_of)) + 1
            groups, states = [], []
            for chunk in np.split(rows, cuts):
                r = int(rk[chunk[0]])
                groups.append(r % self.G)
                states.append(self._state(r, chunk, vals, counts, over,
                                          regs))
            part = self.spec.empty(len(groups))
            key = next(iter(part))
            for j, st in enumerate(states):
                part[key][j] = st
            parts.append((np.asarray(groups, dtype=np.int64), part))
        return self._fold(present, parts)

    def _state(self, r, chunk, vals, counts, over, regs):
        """One (segment, group)'s partial state, as its host_groups
        builds it."""
        if self.spec.name == "mode":
            d = {}
            for j in chunk.tolist():
                d[vals[j]] = counts[j]
            return d
        if r in over:
            return ("hll", np.asarray(regs[over[r]], dtype=np.int32))
        s = {vals[j] for j in chunk.tolist()}
        return ("set", s) if self.smart else s
