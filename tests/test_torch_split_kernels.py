"""K1 and K3 split their inputs in the kernel: the plain versions, the
kernels' descriptor lowering and the engine's hand-off, on the CPU.

K1 (group plane sums) takes the values as stored — a u8 / u16 / u32 / i8 /
i16 / i32 / i64 plane with its frame-of-reference offset and the query's
offset, an f32 plane, or a bf16 channel — and K3 (HLL register max) the
32-bit hash plane with group ids or a mask. Their plain versions build
the reference's operands with torch ops and must equal, bit for bit:

- the composition the engine ran before (decode, ``int_planes`` /
  ``float_planes``, the channel-tensor plain version; ``hll_idx_rho``,
  ``where``, the slot/rank plain version), kept here as the old code;
- the JAX package's kernels in Pallas interpret mode (``group_sums``,
  ``plane_group_sums``, ``hll_register_max``, ``hll_registers``) over the
  reference's own ``int_planes`` / ``float_planes`` / ``hll_idx_rho``.

The descriptor K1 takes by value is checked by a numpy emulation of the
kernel that reads only the descriptor's layout, and K3's in-register
rank (count leading zeros) by Python integers. Inputs come from seeded
numpy. Float planes are held to rtol 1e-6, everything else exactly.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.ops import groupby_mm as ref_mm
from pinot_tpu.ops import hll as ref_hll
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu_torch.engine import device as port_device
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import hll
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import PlaneSource

N = 6000

# stored dtype → (FOR offset applied on top, or None)
DTYPES = {"uint8": -1000, "uint16": 70_000, "uint32": -(1 << 33),
          "int8": None, "int16": None, "int32": None, "int64": None}


def _old_plain(gid, channels, num_groups, first_channel_ones):
    """K1's plain version before the split moved into the kernel: sums of
    an (A, n) bf16 channel tensor."""
    g = gid.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    ch = channels.to(torch.float64, copy=True)
    if first_channel_ones:
        ch[0] = 1.0
    out = torch.zeros((channels.shape[0], num_groups + 1),
                      dtype=torch.float64)
    out.index_add_(1, g, ch)
    return out[:, :num_groups]


def _ids(rng, G):
    """Ids with the overflow id G (masked rows) and -1 (padding)."""
    gid = rng.integers(0, G, N).astype(np.int32)
    gid[rng.random(N) < 0.1] = G
    gid[rng.random(N) < 0.02] = -1
    return gid


def _overflow(gid, G):
    """The ids as the reference takes them: padding (-1) on the overflow
    id, as engine/device.py's group ids always are."""
    return np.where(gid < 0, G, gid).astype(np.int32)


def _stored(rng, dtype):
    """A stored plane holding both ends of its dtype's range."""
    info = np.iinfo(np.dtype(dtype))
    lo, hi = (int(info.min), int(info.max)) if dtype != "int64" \
        else (-(1 << 40), 1 << 40)
    v = rng.integers(lo, hi, N, dtype=np.int64, endpoint=True)
    v[:4] = [lo, hi, lo, hi]
    return v.astype(np.dtype(dtype))


def _int_source(dtype, seed):
    """(PlaneSource over the stored plane, decoded int64 values, query
    offset, byte planes): the engine's arithmetic — decoded = stored + FOR
    offset, query offset = the decoded minimum, minus 7 so it is never the
    exact floor."""
    rng = np.random.default_rng(seed)
    stored = _stored(rng, dtype)
    fo = DTYPES[dtype]
    raw = stored.astype(np.int64) + (fo or 0)
    off = int(raw.min()) - 7
    nplanes = mm.int_planes_needed(off, int(raw.max()))
    t = torch.from_numpy(stored.view(np.int32) if dtype == "uint32"
                         else stored)
    if dtype == "uint32":
        t = t.view(torch.uint32)
    src = PlaneSource(t, "int", nplanes,
                      None if fo is None else torch.tensor(
                          fo, dtype=torch.int64 if dtype == "uint32"
                          else torch.int32),
                      torch.tensor(off, dtype=torch.int64))
    return src, raw, off, nplanes


# ---------------------------------------------------------------------------
# K1's plain version: old composition, reference kernels, oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 35, 2000, 6240])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_k1_int_source_matches_old_composition_and_reference(dtype, G):
    src, raw, off, nplanes = _int_source(dtype, seed=G + len(dtype))
    gid = _ids(np.random.default_rng(G), G)
    got = kernels.group_plane_sums_plain(torch.from_numpy(gid), [src], G,
                                         count=True)
    # the old composition: decode, int_planes, the channel-tensor sums
    chans = torch.stack([torch.ones(N, dtype=torch.bfloat16)] + mm.int_planes(
        torch.from_numpy(raw), torch.tensor(off), nplanes))
    np.testing.assert_array_equal(
        got.numpy(), _old_plain(torch.from_numpy(gid), chans, G, True).numpy())
    # the reference's planes through its partitioned kernel, interpret mode
    ref_ch = jnp.stack([jnp.ones(N, jnp.bfloat16)]
                       + ref_mm.int_planes(jnp.asarray(raw), off, nplanes))
    if ref_ps.sums_supported(G, nplanes + 1):
        want = np.asarray(ref_ps.plane_group_sums(
            jnp.asarray(_overflow(gid, G)), ref_ch, G, interpret=True,
            first_channel_ones=True))
        np.testing.assert_array_equal(got.numpy(), want)
    # and the answer: Σ over each group's rows
    cnt = torch.round(got[0]).to(torch.int64)
    tot = mm.recombine_int(list(got[1:]), cnt, torch.tensor(off)).numpy()
    oracle = np.zeros(G + 2, np.int64)
    np.add.at(oracle, np.where(gid < 0, G + 1, gid), raw)
    np.testing.assert_array_equal(tot, oracle[:G])


@pytest.mark.parametrize("G", [1, 35, 2000])
def test_k1_single_accumulator_entry_matches_reference(G):
    src, raw, off, nplanes = _int_source("int16", seed=G)
    gid = _ids(np.random.default_rng(G + 1), G)
    assert mm.mm_supported(G, nplanes) and ref_mm.mm_supported(G, nplanes)
    got = mm.group_sums(torch.from_numpy(gid), [src], G, count=True)
    want = np.asarray(ref_mm.group_sums(
        jnp.asarray(_overflow(gid, G)),
        jnp.stack([jnp.ones(N, jnp.bfloat16)]
                  + ref_mm.int_planes(jnp.asarray(raw), off, nplanes)),
        G, interpret=True, first_channel_ones=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G", [1, 35, 2000, 6240])
def test_k1_float_source_matches_reference(G):
    rng = np.random.default_rng(G)
    gid = _ids(rng, G)
    # positive (no cancellation for f32 sums to amplify), four decades,
    # and both ends of the f32 range
    val = (rng.uniform(1, 100, N) * 10.0 ** rng.integers(-2, 3, N)) \
        .astype(np.float32)
    val[:2] = [np.finfo(np.float32).tiny, 3.0e38]
    src = PlaneSource(torch.from_numpy(val), "float")
    got = kernels.group_plane_sums_plain(torch.from_numpy(gid), [src], G,
                                         count=True)
    ref_planes = ref_mm.float_planes(jnp.asarray(val))
    want = np.asarray(ref_ps.plane_group_sums(
        jnp.asarray(_overflow(gid, G)),
        jnp.stack([jnp.ones(N, jnp.bfloat16)] + ref_planes),
        G, interpret=True, first_channel_ones=True))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1:].numpy(), want[1:], rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(mm.recombine_float(list(got[1:])).numpy(),
                               want[1] + want[2] + want[3], rtol=1e-6)


def test_k1_mixed_sources_keep_their_output_rows():
    """count, then each source's planes, in order: one launch of an f32,
    a u16 FOR and a bf16 source equals three launches of one each."""
    rng = np.random.default_rng(3)
    G = 35
    gid = torch.from_numpy(_ids(rng, G))
    f = PlaneSource(torch.from_numpy(rng.uniform(-5, 5, N)
                                     .astype(np.float32)), "float")
    u, _raw, _off, _k = _int_source("uint16", seed=4)
    b = PlaneSource(torch.from_numpy(rng.integers(0, 4, N).astype(np.float32))
                    .to(torch.bfloat16), "bf16")
    got = kernels.group_plane_sums(gid, [f, u, b], G, count=True)
    want = torch.cat([kernels.group_plane_sums(gid, [f], G, count=True),
                      kernels.group_plane_sums(gid, [u], G),
                      kernels.group_plane_sums(gid, [b], G)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# K1's descriptor lowering, emulated on the CPU
# ---------------------------------------------------------------------------

_NP_OF_CODE = {0: np.uint8, 1: np.uint16, 2: np.int8, 3: np.int16,
               4: np.int32, 5: np.int64, 8: np.uint32}


def _emulate_k1(desc, tensors, gid, G):
    """The kernel's arithmetic in numpy, driven by the descriptor alone:
    each source's dtype code, kind, planes, offsets and first row in its
    region, and every region row's output row."""
    ints = np.zeros((desc.n_int, G), np.int64)
    flts = np.zeros((desc.n_flt, G), np.float64)
    ok = (gid >= 0) & (gid < G)
    g = gid[ok]
    if desc.count:
        np.add.at(ints[0], g, 1)
    for j in range(desc.n_src):
        s = desc.src[j]
        t = tensors[j]
        assert s.values == t["values"].data_ptr()
        if s.kind == 0:
            v = t["values"].numpy().view(_NP_OF_CODE[s.dtype])[ok] \
                .astype(np.int64)
            if s.plus:
                v = v + int(t["plus"])
            if s.minus:
                v = v - int(t["minus"])
            for k in range(s.nplanes):
                np.add.at(ints[s.row + k], g, (v >> (8 * k)) & 0xFF)
            continue
        x = t["values"].float().numpy()[ok]
        if s.kind == 2:
            np.add.at(flts[s.row], g, x.astype(np.float64))
            continue
        rest = x
        for k in range(3):
            m = (rest.view(np.uint32) & np.uint32(0xFFFF0000)) \
                .view(np.float32)
            np.add.at(flts[s.row + k], g, m.astype(np.float64))
            rest = rest - m
    out = np.zeros((desc.n_int + desc.n_flt, G), np.float64)
    for r in range(desc.n_int):
        out[desc.int_out[r]] = ints[r]
    for r in range(desc.n_flt):
        out[desc.flt_out[r]] = flts[r]
    return out


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("dtypes", [("uint8",), ("int32", "uint16"),
                                    ("int64", "float32", "uint32", "bf16"),
                                    ("bf16", "bf16", "bf16")])
def test_k1_descriptor_lowering_emulated(dtypes, count):
    rng = np.random.default_rng(len(dtypes) + count)
    G = 300
    gid = _ids(rng, G)
    sources, tensors = [], []
    for i, dt in enumerate(dtypes):
        if dt == "float32":
            s = PlaneSource(torch.from_numpy(
                rng.uniform(-1e4, 1e4, N).astype(np.float32)), "float")
        elif dt == "bf16":
            s = PlaneSource(torch.from_numpy(
                rng.integers(0, 64, N).astype(np.float32))
                .to(torch.bfloat16), "bf16")
        else:
            s = _int_source(dt, seed=i)[0]
        sources.append(s)
        tensors.append({"values": s.values, "plus": s.plus,
                        "minus": s.minus})
    desc = kernels.lower_plane_sums(sources, count)
    assert ctypes.sizeof(desc) == 15 * 48 + 2 * 16 * 4 + 4 * 4
    layout = kernels.plane_layout(sources, count)
    assert desc.n_int + desc.n_flt == len(layout)
    for j, s in enumerate(sources):
        d = desc.src[j]
        assert (d.nplanes, d.kind) == (s.nplanes, ["int", "float",
                                                   "bf16"].index(s.kind))
        assert bool(d.plus) == (s.plus is not None)
        assert d.plus_is64 == int(s.plus is not None
                                  and s.plus.dtype == torch.int64)
    got = _emulate_k1(desc, tensors, gid, G)
    want = kernels.group_plane_sums_plain(torch.from_numpy(gid), sources, G,
                                          count).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    int_rows = [a for a, (region, _r) in enumerate(layout) if region == "int"]
    np.testing.assert_array_equal(got[int_rows], want[int_rows])


def test_k1_flush_bound_and_span():
    """A block's int32 cells stay exact: at most floor((2^31 - 1) / 255)
    rows between flushes with a byte plane, a whole number of quads."""
    u = PlaneSource(torch.zeros(4, dtype=torch.uint8), "int", 1)
    f = PlaneSource(torch.zeros(4), "float")
    assert kernels.flush_rows([u]) == 8_421_504
    assert kernels.flush_rows([u]) * 255 <= 2**31 - 1
    assert kernels.flush_rows([f]) % 4 == 0
    # q1: count + 3 byte planes, G = 2000 in one partition; the wide float
    # shape (count + 2 byte planes + 3 f64 planes) too
    assert kernels.plane_span(4, 0) >= 2000
    assert kernels.plane_span(3, 3) >= 6240


def test_k1_lowering_refuses_what_the_kernel_cannot_read():
    with pytest.raises(TypeError):
        kernels.lower_plane_sums([PlaneSource(torch.zeros(4, dtype=torch.float64),
                                              "float")], True)
    with pytest.raises(TypeError):
        kernels.lower_plane_sums([PlaneSource(torch.zeros(4), "int", 1)], True)
    with pytest.raises(ValueError):
        kernels.lower_plane_sums([PlaneSource(torch.zeros(4), "float")] * 6,
                                 True)


# ---------------------------------------------------------------------------
# K3's plain version and its in-register split
# ---------------------------------------------------------------------------


def _hash_rows(seed, G, log2m, n=5000):
    """Hashes (half of them >= 2^31, plus 0 and 2^32 - 1), ids with the
    overflow id and -1, a mask; the reference's slot and rank."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h[:2] = [0, 2**32 - 1]
    gid = _ids(rng, G)[:n] if n <= N else rng.integers(0, G, n)
    gid = gid.astype(np.int32)
    mask = rng.random(n) >= 0.25
    idx, rho = ref_hll.hll_idx_rho(jnp.asarray(h), log2m)
    keep = mask & (gid >= 0) & (gid < G)
    slot = np.where(keep, gid.astype(np.int64) * (1 << log2m)
                    + np.asarray(idx), G << log2m)
    return h, gid, mask, slot, np.asarray(rho)


@pytest.mark.parametrize("log2m", list(range(4, 17)))
def test_k3_rank_in_registers_matches_hll_idx_rho(log2m):
    """idx = u >> (32 - log2m), rho = clz32((u << log2m) | 2^(log2m-1)) +
    1 in uint32 arithmetic, as the kernel computes them, equal
    hll_idx_rho's int64 / frexp split and the reference's."""
    h, *_ = _hash_rows(log2m, 1, log2m, n=3000)
    idx, rho = hll.hll_idx_rho(torch.from_numpy(h.view(np.int32)), log2m)
    ref_idx, ref_rho = ref_hll.hll_idx_rho(jnp.asarray(h), log2m)
    want_idx, want_rho = [], []
    for u in h.tolist():
        w = ((u << log2m) & 0xFFFFFFFF) | (1 << (log2m - 1))
        want_idx.append(u >> (32 - log2m))
        want_rho.append((32 - w.bit_length()) + 1)  # clz32(w) + 1
    assert idx.tolist() == want_idx == np.asarray(ref_idx).tolist()
    assert rho.tolist() == want_rho == np.asarray(ref_rho).tolist()


@pytest.mark.parametrize("G,log2m", [(1, 4), (1, 10), (1, 16), (3, 12),
                                     (35, 10), (200, 8), (2, 14)])
def test_k3_plain_version_matches_old_composition_and_oracle(G, log2m):
    h, gid, mask, slot, rho = _hash_rows(G * 31 + log2m, G, log2m)
    nslots = G << log2m
    got = kernels.hll_register_max_plain(
        torch.from_numpy(h.view(np.int32)), log2m, G,
        torch.from_numpy(gid), torch.from_numpy(mask))
    # the old composition: hll_idx_rho, where, then the per-slot max
    idx, r = hll.hll_idx_rho(torch.from_numpy(h.view(np.int32)), log2m)
    g = torch.from_numpy(gid)
    old_slot = torch.where(torch.from_numpy(mask) & (g >= 0) & (g < G),
                           g * (1 << log2m) + idx, nslots)
    old = torch.zeros(nslots + 1, dtype=torch.int32).scatter_reduce_(
        0, old_slot.long(), r, reduce="amax", include_self=True)[:nslots]
    np.testing.assert_array_equal(got.numpy(), old.numpy())
    oracle = np.zeros(nslots + 1, np.int32)
    np.maximum.at(oracle, slot, rho)
    np.testing.assert_array_equal(got.numpy(), oracle[:nslots])


@pytest.mark.parametrize("G,log2m", [(1, 12), (35, 10)])
def test_k3_entries_match_reference_kernels(G, log2m):
    h, gid, mask, slot, rho = _hash_rows(G + log2m, G, log2m)
    ht = torch.from_numpy(h.view(np.int32))
    nslots, nrho = G << log2m, mm.hll_nrho(log2m)
    if ps.hll_supported(nslots, nrho):
        got = ps.hll_register_max(ht, log2m, num_groups=G,
                                  gid=torch.from_numpy(gid),
                                  mask=torch.from_numpy(mask))
        want = ref_ps.hll_register_max(jnp.asarray(slot.astype(np.int32)),
                                       jnp.asarray(rho), nslots, nrho,
                                       interpret=True)
    else:
        got = mm.hll_registers(ht, torch.from_numpy(gid), G, log2m,
                               mask=torch.from_numpy(mask)).reshape(-1)
        want = ref_mm.hll_registers(jnp.asarray(slot.astype(np.int32)),
                                    jnp.asarray(rho), G, log2m,
                                    interpret=True).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hll_slots_drops_masked_and_out_of_range_rows():
    h = torch.tensor([0, -1, 5, 7], dtype=torch.int32)
    gid = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    mask = torch.tensor([True, False, True, True])
    slot, rho = hll.hll_slots(h, 4, 2, gid, mask)
    assert slot.dtype == torch.int32 and rho.dtype == torch.int32
    assert slot.tolist() == [0, 32, 32, 32]


# ---------------------------------------------------------------------------
# the engine hands the kernels what is stored
# ---------------------------------------------------------------------------


def _capture(monkeypatch, *entries):
    """The positional arguments of every call to the (module, name)
    entries, which still run."""
    seen = []
    for module, name in entries:
        real = getattr(module, name)

        def spy(*args, _real=real, **kwargs):
            seen.append(args)
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)
    return seen


def _forbid_splits(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("the engine split a plane before K1")
    monkeypatch.setattr(mm, "int_planes", boom)
    monkeypatch.setattr(mm, "float_planes", boom)


@pytest.mark.parametrize("G", [35, 2000])
@pytest.mark.parametrize("key,argt,plan", [
    ("lo_revenue", ("raw", "lo_revenue"), ("<i4", 0, False, "")),
    ("lo_quantity", ("raw", "lo_quantity"), ("|u1", 0, False, "<i4")),
    ("dv::lo_tax", ("dictval", "lo_tax"), ("<u2", 0, True, "<i4")),
])
def test_try_mm_groupby_hands_k1_the_stored_plane(monkeypatch, G, key, argt,
                                                  plan):
    """A bare-column SUM reaches K1 as its stored plane: no int_planes /
    float_planes in the engine, the FOR offset and the query offset left
    for the kernel, and the same sums as the decoded values give."""
    _forbid_splits(monkeypatch)
    seen = _capture(monkeypatch, (ps, "plane_group_sums"),
                    (mm, "group_sums"))
    rng = np.random.default_rng(G)
    S, L = 2, 4096
    dt = np.dtype(plan[0])
    stored = rng.integers(0, min(np.iinfo(dt).max, 60_000), (S, L)) \
        .astype(dt)
    cols = {key: torch.from_numpy(stored)}
    decoded = stored.astype(np.int64) + (-40_000 if plan[2] else 0)
    off = int(decoded.min()) - 77  # the query's offset, below the data
    params = {"off1": torch.tensor(off, dtype=torch.int64)}
    if plan[2]:
        params["fo::" + key] = torch.tensor(-40_000, dtype=torch.int32)
    nplanes = mm.int_planes_needed(off, int(decoded.max()))
    aggs = (("count", None, None), ("sum", argt, (nplanes, None)))
    gid = torch.from_numpy(rng.integers(0, G + 1, (S, L)).astype(np.int32))
    outs = {}
    done = port_device._try_mm_groupby(aggs, gid, cols, params, G, outs,
                                       {key: plan}, min_rows=0)
    assert done == {1}
    (args,) = seen
    (src,) = args[1]
    assert src.values is cols[key]
    assert src.minus is params["off1"]
    assert src.plus is params.get("fo::" + key)
    oracle = np.zeros(G + 1, np.int64)
    np.add.at(oracle, gid.numpy().reshape(-1), decoded.reshape(-1))
    np.testing.assert_array_equal(outs["a1_sum"].numpy(), oracle[:G])
    np.testing.assert_array_equal(
        outs["gcount"].numpy(),
        np.bincount(gid.numpy().reshape(-1), minlength=G + 1)[:G])


def test_hll_regs_hands_k3_the_hash_plane(monkeypatch):
    """The group HLL build reaches K3 with the hash plane and the ids: no
    slot or rank tensor is made in the engine."""
    def boom(*_a, **_k):
        raise AssertionError("the engine split the hashes before K3")
    seen = _capture(monkeypatch, (ps, "hll_register_max"),
                    (mm, "hll_registers"))
    h, gid, mask, slot, rho = _hash_rows(9, 35, 10)
    ht, gt = torch.from_numpy(h.view(np.int32)), torch.from_numpy(gid)
    monkeypatch.setattr(port_device.hll_ops, "hll_slots", boom)
    regs = port_device._hll_regs(ht, gt, None, 35, 10, min_rows=0)
    (args,) = seen
    assert args[0] is ht and args[1] is gt
    oracle = np.zeros((35 << 10) + 1, np.int32)
    keep = (gid >= 0) & (gid < 35)
    idx, r = ref_hll.hll_idx_rho(jnp.asarray(h), 10)
    np.maximum.at(oracle, np.where(keep, gid * 1024 + np.asarray(idx),
                                   35 << 10), np.asarray(r))
    np.testing.assert_array_equal(regs.numpy().reshape(-1),
                                  oracle[:35 << 10].astype(np.int8))


def test_try_mm_groupby_broadcasts_a_literal_sum():
    """SUM(<literal>) reaches K1 as a plane of the literal, as the
    channel build broadcast it before."""
    G, S, L = 35, 2, 4096
    rng = np.random.default_rng(8)
    gid = torch.from_numpy(rng.integers(0, G + 1, (S, L)).astype(np.int32))
    params = {"p0": torch.tensor(3, dtype=torch.int64),
              "off0": torch.tensor(3, dtype=torch.int64)}
    outs = {}
    done = port_device._try_mm_groupby(
        (("sum", ("lit", "p0"), (1, None)),), gid, {}, params, G, outs, {},
        min_rows=0)
    assert done == {0}
    np.testing.assert_array_equal(
        outs["a0_sum"].numpy(),
        3 * np.bincount(gid.numpy().reshape(-1), minlength=G + 1)[:G])
