"""K2 (group min/max over several stored sources in one launch) and K4
(fused filter + aggregate, the filter run per 32-row lane tile) on the
CPU: plain versions against the JAX package's kernels, the kernels'
launch-time arithmetic emulated in numpy, and the engine's hand-off.

K2 takes up to 8 sources, each a plane as stored (u8 / u16 / i8 / i16 /
i32 / f32) with its frame-of-reference offset and decoded dtype, or an
evaluated tensor, and returns every source's MIN and/or MAX in one
launch. Its plain version decodes (the engine's ``_data_col``) and runs
the order-key ``scatter_reduce_`` per source and op; it must equal the
reference's ``group_minmax`` in Pallas interpret mode, called once per
source and op on the decoded values. K2's descriptor is checked by a
numpy emulation of the kernel that reads only the descriptor.

K4's descriptor and lowering do not change; its kernel now evaluates the
postfix program once per lane tile of 32 rows (rows k * 32 + lane of a
1024-row chunk) as 32-bit row masks on a stack of masks. A numpy
emulation of that arithmetic, driven by the lowered program, with
garbage past each candidate's rows in the staged tile, must equal the
plain version and the reference kernel in interpret mode.

q6's SQL and a min/max set with a FOR-offset column, a float column and
two aggregates of one column run through the port's ``QueryEngine`` and
the reference engine on a small table: rows equal bit for bit, and one
K2 call per execution holding each stored plane once.

Integers and order keys are compared exactly, floats by their bits.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import device as port_device
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.ops.kernels import MinMaxSource
from pinot_tpu_torch.storage.segment import ImmutableSegment

N = 4096

# (stored dtype, decoded dtype, FOR offset or None)
SOURCES = {
    "u8": ("uint8", "uint8", None),
    "u8_wide": ("uint8", "int32", None),
    "u8_for": ("uint8", "int32", -1000),
    "u16": ("uint16", "uint16", None),
    "u16_for": ("uint16", "int32", 70_000),
    "i8": ("int8", "int8", None),
    "i8_for": ("int8", "int16", 300),
    "i16": ("int16", "int16", None),
    "i16_for": ("int16", "int32", -(1 << 20)),
    "i32": ("int32", "int32", None),
    "f32": ("float32", "float32", None),
}


def _ids(rng, G):
    """Even ids only (half the groups stay empty and keep their fill) and
    the overflow id G."""
    gid = (rng.integers(0, (G + 1) // 2, N) * 2) % G
    gid[rng.random(N) < 0.1] = G
    return gid.astype(np.int32)


def _stored(rng, dtype):
    """A stored plane holding both ends of its dtype's range; f32 with
    signed zeros and infinities."""
    if dtype == "float32":
        v = rng.uniform(-5, 5, N).astype(np.float32)
        v[:4] = [0.0, -0.0, np.inf, -np.inf]
        v[4::97] = -0.0
        return v
    info = np.iinfo(np.dtype(dtype))
    v = rng.integers(int(info.min), int(info.max), N, endpoint=True)
    v[:4] = [info.min, info.max, info.min, info.max]
    return v.astype(np.dtype(dtype))


def _source(name, rng, ops=("min", "max")):
    """(MinMaxSource, decoded numpy values, decoded dtype) of a case."""
    stored_dt, dec_dt, fo = SOURCES[name]
    stored = _stored(rng, stored_dt)
    decoded = (stored.astype(np.int64) + (fo or 0)).astype(dec_dt) \
        if dec_dt != "float32" else stored
    tdt = torch.from_numpy(np.zeros(0, dec_dt)).dtype
    plus = None if fo is None else torch.tensor(fo, dtype=tdt)
    if dec_dt == "float32":
        fills = tuple(float("inf") if op == "min" else float("-inf")
                      for op in ops)
    else:
        info = np.iinfo(np.dtype(dec_dt))
        fills = tuple(int(info.max) if op == "min" else int(info.min)
                      for op in ops)
    src = MinMaxSource(torch.from_numpy(stored), ops, fills, plus, tdt)
    return src, decoded, dec_dt


def _bits(x):
    """Integers widened to int64, floats as their bits: exact equality."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


# ---------------------------------------------------------------------------
# K2's plain version against the reference kernel, per source and op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [35, 2500])
@pytest.mark.parametrize("name", list(SOURCES))
def test_k2_plain_matches_reference_per_source_and_op(name, G):
    """Every stored dtype, with and without a FOR offset, against the
    reference's group_minmax on the decoded values (2500 groups: three of
    the reference's 1024-group partitions; the port's span forced to 300,
    which the card splits into nine)."""
    rng = np.random.default_rng(G + len(name))
    gid = _ids(rng, G)
    src, decoded, dec_dt = _source(name, rng)
    other, _, _ = _source("i32", rng, ("max",))
    got = ps.group_minmax_sources(torch.from_numpy(gid), [src, other], G,
                                  span=300)
    assert len(got) == 2 and len(got[0]) == 2 and len(got[1]) == 1
    for op, fill, res in zip(src.ops, src.fills, got[0]):
        assert res.dtype == src.dtype
        want, = ref_ps.group_minmax(jnp.asarray(gid), jnp.asarray(decoded), G,
                                    (op,), interpret=True, fills=(fill,))
        np.testing.assert_array_equal(
            _bits(res.numpy()), _bits(np.asarray(want).astype(dec_dt)))
    # an empty (even-less) group keeps its fill, not fill + offset
    assert _bits(got[0][0].numpy())[1] == _bits(np.array(
        src.fills[0], dtype=dec_dt))


def test_k2_one_source_entry_keeps_the_reference_signature():
    """ops/group_scatter.py group_minmax(gid, values, G, ops, fills) is the
    one-source case: narrow values are not widened before the call and
    the results come back in the kernel dtype, as the reference's do."""
    rng = np.random.default_rng(4)
    G = 300
    gid = _ids(rng, G)
    val = rng.integers(-100, 100, N).astype(np.int8)
    fills = (127, -128)
    got = ps.group_minmax(torch.from_numpy(gid), torch.from_numpy(val), G,
                          ("min", "max"), fills=fills)
    want = ref_ps.group_minmax(jnp.asarray(gid), jnp.asarray(val), G,
                               ("min", "max"), interpret=True, fills=fills)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k2_plain_ignores_ids_outside_range():
    gid = torch.tensor([-1, 0, 2, 3, 1, 0], dtype=torch.int32)
    v = torch.tensor([9, 5, 9, 9, 4, 200], dtype=torch.uint8)
    (mn, mx), = kernels.group_minmax_plain(
        gid, [MinMaxSource(v, ("min", "max"), plus=torch.tensor(
            -3, dtype=torch.int16), dtype=torch.int16)], 2)
    assert mn.tolist() == [2, 1] and mx.tolist() == [197, 1]
    assert mn.dtype == torch.int16


# ---------------------------------------------------------------------------
# K2's descriptor, emulated on the CPU
# ---------------------------------------------------------------------------

_NP_OF_CODE = {0: np.uint8, 1: np.uint16, 2: np.int8, 3: np.int16,
               4: np.int32, 5: np.float32}


def _emulate_k2(desc, sources, gid, G):
    """The kernel's arithmetic in numpy, driven by the descriptor alone:
    each source's stored dtype code, offset pointer and dtype, and cells;
    per cell its fill key and op. Returns the (n_cells, G) int32 keys the
    kernel leaves in its outputs."""
    keys = np.zeros((desc.n_cells, G + 1), np.int64)
    for c in range(desc.n_cells):
        keys[c] = desc.fill[c]
    g = np.where((gid >= 0) & (gid < G), gid, G)
    for j in range(desc.n_src):
        d, s = desc.src[j], sources[j]
        assert d.values == s.values.data_ptr()
        v = s.values.numpy().view(_NP_OF_CODE[d.dtype]).reshape(-1)
        if d.dtype == 5:
            b = v.view(np.int32).astype(np.int64)
            k = b ^ ((b >> 31) & 0x7FFFFFFF)
        else:
            k = v.astype(np.int64)
            if d.plus:
                assert d.plus == s.plus.data_ptr()
                k = k + int(s.plus.numpy().view(_NP_OF_CODE[d.plus_dtype]))
            k = (k + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 add
        for op in (0, 1):
            c = d.cell[op]
            if c < 0:
                continue
            assert desc.op[c] == op
            (np.minimum if op == 0 else np.maximum).at(keys[c], g, k)
    return keys[:, :G].astype(np.int32)


@pytest.mark.parametrize("names", [("i32", "u8_for"), ("f32",),
                                   ("u16_for", "i8_for", "u8", "f32", "i16",
                                    "u16", "i16_for", "u8_wide")])
def test_k2_descriptor_lowering_emulated(names):
    rng = np.random.default_rng(len(names))
    G = 175
    gid = _ids(rng, G)
    gid[:7] = -1
    ops_of = [("min", "max"), ("max",), ("min",)]
    sources = [_source(nm, rng, ops_of[i % 3])[0]
               for i, nm in enumerate(names)]
    cells = kernels.minmax_cells(sources)
    assert cells == [(j, op) for j, s in enumerate(sources) for op in s.ops]
    outs = torch.zeros((len(cells), G), dtype=torch.int32)
    desc = kernels.lower_minmax(sources, list(outs))
    assert ctypes.sizeof(kernels._MinMaxSource) == 32
    assert ctypes.sizeof(desc) == 8 * 32 + 16 * 8 + 16 * 4 * 2 + 2 * 4
    assert (desc.n_src, desc.n_cells) == (len(sources), len(cells))
    for c, (j, op) in enumerate(cells):
        s = sources[j]
        assert desc.out[c] == outs[c].data_ptr()
        assert desc.fill[c] == kernels._fill_key(s.fills[s.ops.index(op)],
                                                 s.dtype)
        assert desc.src[j].cell[kernels.K2_OPS[op]] == c
    for j, s in enumerate(sources):
        for op in set(kernels.K2_OPS) - set(s.ops):
            assert desc.src[j].cell[kernels.K2_OPS[op]] == -1
        assert bool(desc.src[j].plus) == (s.plus is not None)
    got = _emulate_k2(desc, sources, gid, G)
    want = kernels.group_minmax_plain(torch.from_numpy(gid), sources, G)
    c = 0
    for s, res in zip(sources, want):
        for r in res:
            np.testing.assert_array_equal(
                got[c], kernels._order_keys(r.to(torch.float32)
                                            if s.dtype.is_floating_point
                                            else r.to(torch.int32)).numpy())
            c += 1


def test_k2_lowering_refuses_what_the_kernel_cannot_read():
    outs = [torch.zeros(4, dtype=torch.int32)] * 16
    with pytest.raises(TypeError):
        kernels.lower_minmax([MinMaxSource(torch.zeros(4, dtype=torch.int64),
                                           ("min",))], outs)
    with pytest.raises(TypeError):  # a float plane decoded to an integer
        kernels.lower_minmax([MinMaxSource(torch.zeros(4), ("min",),
                                           dtype=torch.int32)], outs)
    with pytest.raises(TypeError):
        kernels.lower_minmax([MinMaxSource(
            torch.zeros(4, dtype=torch.uint8), ("min",),
            plus=torch.tensor(1, dtype=torch.int64), dtype=torch.int32)],
            outs)
    with pytest.raises(ValueError):
        kernels.lower_minmax([MinMaxSource(torch.zeros(4), ("min",))] * 9,
                             outs)
    with pytest.raises(ValueError):
        MinMaxSource(torch.zeros(4), ("min", "min"))


def test_k2_wrapper_refuses_mixed_devices_without_launching():
    before = dict(kernels.launches)
    gid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.group_minmax_sources(
            gid, [MinMaxSource(torch.zeros(4, device="meta"), ("min",))], 2)
    assert kernels.launches == before


# ---------------------------------------------------------------------------
# the engine: one K2 call per query, the stored planes handed over
# ---------------------------------------------------------------------------

Q6 = ("SELECT d_year, s_nation, MIN(lo_revenue), MAX(lo_revenue), "
      "MINMAXRANGE(lo_quantity), COUNT(*) FROM lineorder "
      "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year, s_nation "
      "ORDER BY d_year, s_nation LIMIT 200")
MIXED = ("SELECT d_year, MIN(lo_shipid), MAX(lo_shipid), MINMAXRANGE(lo_tax), "
         "MAX(lo_quantity), MIN(lo_quantity), MIN(ABS(lo_revenue)), "
         "MAX(lo_discount + 2) FROM lineorder GROUP BY d_year ORDER BY d_year")
# a group-by SUM of an expression in K1's regime: the argument is not a
# bare column (the lookup of its plane used to raise TypeError)
SUM_EXPR = ("SELECT d_year, SUM(lo_quantity * lo_discount), COUNT(*) "
            "FROM lineorder GROUP BY d_year ORDER BY d_year")


@pytest.fixture(scope="module")
def minmax_dirs(tmp_path_factory):
    """Two SSB-shaped segments; lo_shipid spans 200 values far from 0 (a
    u8 plane with a FOR offset), lo_tax is a DOUBLE (an f32 plane)."""
    schema = Schema.build(
        name="lineorder",
        dimensions=[("d_year", DataType.INT), ("s_nation", DataType.STRING),
                    ("lo_discount", DataType.INT)],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT),
                 ("lo_shipid", DataType.INT), ("lo_tax", DataType.DOUBLE)])
    rng = np.random.default_rng(29)
    nations = np.array([f"nation_{i:02d}" for i in range(25)])
    base = tmp_path_factory.mktemp("torch_minmax")
    dirs = []
    for i in range(2):
        n = 12_000
        cols = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "s_nation": nations[rng.integers(0, 25, n)],
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int32),
            "lo_shipid": rng.integers(100_000, 100_200, n).astype(np.int32),
            "lo_tax": np.round(rng.uniform(-4, 4, n), 2),
        }
        out = str(base / f"s{i}")
        build_segment(schema, cols, out, TableConfig(table_name="lineorder"),
                      f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def minmax_engines(minmax_dirs):
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0  # the kernels' plain versions, as interpret
    for d in minmax_dirs:
        ref.add_segment("lineorder", RefSegment(d))
        port.add_segment("lineorder", ImmutableSegment(d))
    return ref, port


@pytest.mark.parametrize("sql,n_sources", [(Q6, 2), (MIXED, 4)])
def test_engine_minmax_one_k2_call_bit_exact(minmax_engines, monkeypatch, sql,
                                              n_sources):
    """The query's MIN / MAX / MINMAXRANGE aggregates reach K2 in ONE call
    (the counting shim) with one source per distinct argument: the stored
    planes as they are (no widening, no FOR add before the call) and an
    evaluated expression; rows equal the reference engine's bit for
    bit."""
    ref, port = minmax_engines
    calls = []
    real = kernels.group_minmax_sources

    def shim(gid, sources, num_groups, **kw):
        calls.append(list(sources))
        return real(gid, sources, num_groups, **kw)
    monkeypatch.setattr(kernels, "group_minmax_sources", shim)
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == []
    assert got["resultTable"] == want["resultTable"]
    assert got["resultTable"]["rows"]
    (sources,) = calls
    assert len(sources) == n_sources
    stored = [s for s in sources if s.values.dim() == 2]  # (S, L) planes
    assert stored and all(s.values.dtype in kernels.K2_DTYPES
                          for s in sources)
    if sql == Q6:
        assert sorted(s.ops for s in sources) == [("min", "max")] * 2
        assert {s.values.dtype for s in sources} == {torch.int32,
                                                     torch.uint8}
    else:
        # lo_shipid's u8 plane with its FOR offset; MAX and MIN of
        # lo_quantity share one source; ABS(lo_revenue) evaluated as int32
        # joins the call (lo_discount + 2, int64, takes the scatter)
        assert any(s.plus is not None and s.values.dtype == torch.uint8
                   for s in sources)
        assert any(s.values.dtype == torch.float32 for s in sources)
        assert sum(s.ops == ("min", "max") for s in sources) == 3
        assert [s.ops for s in sources].count(("min",)) == 1


def test_engine_groupby_sum_of_expression_through_the_kernels(
        minmax_engines):
    ref, port = minmax_engines
    got, want = port.execute(SUM_EXPR), ref.execute(SUM_EXPR)
    assert got["exceptions"] == [] and want["exceptions"] == []
    assert got["resultTable"] == want["resultTable"]


def test_engine_minmax_past_the_gate_stays_on_the_scatter(minmax_dirs,
                                                          monkeypatch):
    """At the default gate this 24k-row batch takes the torch scatters
    (as the reference does), with the same rows as through K2."""
    def boom(*_a, **_k):
        raise AssertionError("K2 called below the gate")
    eng = QueryEngine(device="cpu")
    for d in minmax_dirs:
        eng.add_segment("lineorder", ImmutableSegment(d))
    monkeypatch.setattr(kernels, "group_minmax_sources", boom)
    scatter = eng.execute(MIXED)
    monkeypatch.undo()
    eng.device.min_rows = 0
    assert scatter["exceptions"] == []
    assert eng.execute(MIXED)["resultTable"] == scatter["resultTable"]


def test_group_extremes_splits_past_eight_sources():
    """More distinct arguments than K2's 8 sources take more than one
    call, each source's results where they belong."""
    rng = np.random.default_rng(6)
    G, S, L = 9, 1, 4096
    gid = torch.from_numpy(rng.integers(0, G + 1, (S, L)).astype(np.int32))
    cols, aggs = {}, []
    for j in range(10):
        cols[f"c{j}"] = torch.from_numpy(
            rng.integers(-50, 50, (S, L)).astype(np.int16))
        aggs.append(("max", ("raw", f"c{j}"), None))
    outs = {}
    port_device._group_extremes(tuple(aggs), gid, cols, {}, G, outs, {},
                                min_rows=0)
    for j in range(10):
        want = np.full(G + 1, np.iinfo(np.int16).min, np.int64)
        np.maximum.at(want, gid.numpy().reshape(-1),
                      cols[f"c{j}"].numpy().reshape(-1))
        np.testing.assert_array_equal(outs[f"a{j}_max"].numpy(), want[:G])
        assert outs[f"a{j}_max"].dtype == torch.int16


# ---------------------------------------------------------------------------
# K4: the lane-tile program, emulated on the CPU
# ---------------------------------------------------------------------------

KWIDTHS = {
    "a": ("uint8", 0, False, None), "b": ("uint16", 0, False, None),
    "c": ("int8", 0, False, None), "d": ("int16", 0, False, None),
    "e": ("int32", 0, False, None), "f": ("float32", 0, False, None),
}
KFILTERS = {
    "and_or_not_in8": (
        "and",
        ("or", ("eq_dict", "a", "p0"), ("in_dict", "b", "p1", 8)),
        ("not", ("range_raw", ("raw", "c"), "p2", "p3", True, True, True,
                 False)),
        ("range_dict", "e", "p4", "p5")),
    "in_raw_or_range": (
        "or", ("in_raw", ("raw", "d"), "p6", 3),
        ("range_raw", ("raw", "c"), "p2", "p3", False, True, False, True)),
    "deep_right": ("and", ("eq_dict", "a", "p0"),
                   ("or", ("not", ("eq_raw", ("raw", "d"), "p7")),
                    ("and", ("range_dict", "b", "p4", "p5"),
                     ("in_dict", "b", "p1", 8)))),
    "open_ranges": ("and", ("range_raw", ("raw", "d"), "p8", "p8", True,
                            False, True, True),
                    ("range_raw", ("raw", "c"), "p9", "p9", False, True,
                     False, False)),
    "true": ("true",),
}
KAGGS = (("count", None, None), ("sum", ("raw", "b"), (2, 1 << 20)),
         ("min", ("raw", "d"), None), ("minmaxrange", ("raw", "f"), None),
         ("max", ("raw", "c"), None), ("sum", ("raw", "e"), (2, 1 << 20)),
         ("max", ("raw", "a"), None))

_CHUNK = 1024


def _lane_words(bits):
    """(32 k, 32 lanes) bools → per lane the uint32 with bit k set."""
    w = np.zeros(32, np.uint64)
    for k in range(32):
        w |= bits[k].astype(np.uint64) << np.uint64(k)
    return w.astype(np.uint32)


def _emulate_k4(cand, rows_in, cols, lits, prog, aggs, ki, kf, rng):
    """The kernel's arithmetic in numpy: per candidate, 1024-row chunks
    staged with garbage past the rows that hold data; per lane the 32
    rows k * 32 + lane; the program once per lane tile as uint32 masks on
    a stack; aggregates under the final mask; int32 wrapping sums and
    order-key min / max. Returns (ints, flts, deepest stack)."""
    B = len(cand)
    ints = np.zeros((B, ki), np.int32)
    flts = np.zeros((B, kf), np.float32)
    depth, sp = 1, 0
    for op, *_ in prog:
        sp += {kernels.OP_AND: -1, kernels.OP_OR: -1,
               kernels.OP_NOT: 0}.get(op, 1)
        depth = max(depth, sp)
    lits = lits.numpy().astype(np.int64)
    planes = [c.numpy() for c in cols]
    for b in range(B):
        n = int(rows_in[b])
        acc = [0] + [0 if op == kernels.AGG_OPS["sum"] else
                     kernels._fill_key(fill, torch.float32 if is_f
                                       else torch.int32)
                     for op, _c, is_f, _s, fill in aggs]
        for c0 in range(0, n, _CHUNK):
            rows = min(_CHUNK, n - c0)
            staged = []
            for p in planes:
                x = p[cand[b], c0:c0 + _CHUNK].copy()
                junk = rng.integers(0, 256, x.nbytes, dtype=np.uint8)
                x.view(np.uint8)[rows * x.itemsize:] = \
                    junk[rows * x.itemsize:]
                x = x.view(np.int32) if x.dtype == np.float32 else x
                staged.append(x.astype(np.int64).reshape(32, 32))
            valid = _lane_words(np.arange(_CHUNK).reshape(32, 32) < rows)
            stack = []
            for op, col, a, bb, flags in prog:
                if op == kernels.OP_TRUE:
                    m = np.full(32, 0xFFFFFFFF, np.uint32)
                elif op == kernels.OP_FALSE:
                    m = np.zeros(32, np.uint32)
                elif op in (kernels.OP_AND, kernels.OP_OR):
                    y, x = stack.pop(), stack.pop()
                    m = (x & y) if op == kernels.OP_AND else (x | y)
                elif op == kernels.OP_NOT:
                    m = ~stack.pop()
                elif op == kernels.OP_IN:
                    m = np.zeros(32, np.uint32)
                    for q in range(bb):
                        m |= _lane_words(staged[col] == lits[a + q])
                else:
                    lo = lits[a] + (0 if flags & kernels.RANGE_LO_INC
                                    else 1) \
                        if flags & kernels.RANGE_HAS_LO else -(1 << 63)
                    hi = lits[bb] - (0 if flags & kernels.RANGE_HI_INC
                                     else 1) \
                        if flags & kernels.RANGE_HAS_HI else (1 << 63) - 1
                    m = _lane_words((staged[col] >= lo) & (staged[col] <= hi))
                stack.append(m)
                assert len(stack) <= depth
            mask = stack[0] & valid
            bits = ((mask[None, :].astype(np.uint64)
                     >> np.arange(32, dtype=np.uint64)[:, None]) & 1) \
                .astype(bool)
            acc[0] += int(bits.sum())
            for j, (op, col, is_f, _slot, _fill) in enumerate(aggs):
                v = staged[col]
                if is_f:
                    v = v ^ ((v >> 31) & 0x7FFFFFFF)
                if op == kernels.AGG_OPS["sum"]:
                    acc[1 + j] = (acc[1 + j] + int(v[bits].sum())
                                  + (1 << 31)) % (1 << 32) - (1 << 31)
                elif bits.any():
                    red = v[bits].min() if op == kernels.AGG_OPS["min"] \
                        else v[bits].max()
                    acc[1 + j] = min(acc[1 + j], int(red)) \
                        if op == kernels.AGG_OPS["min"] \
                        else max(acc[1 + j], int(red))
        ints[b, 0] = acc[0]
        for j, (op, _col, is_f, slot, _fill) in enumerate(aggs):
            if is_f:
                k = np.int32(acc[1 + j])
                flts[b, slot] = np.array(k ^ ((k >> 31) & 0x7FFFFFFF),
                                         np.int32).view(np.float32)
            else:
                ints[b, slot] = acc[1 + j]
    return ints, flts, depth


@pytest.mark.parametrize("filt", list(KFILTERS))
def test_k4_lane_tile_program_emulated(filt):
    """The lane-tile arithmetic equals K4's plain version and the
    reference kernel (interpret mode): six plane dtypes, and/or/not trees,
    IN lists up to 8, open and exclusive ranges, padding candidates, a
    block cut inside a chunk and one cut at a chunk's end."""
    rng = np.random.default_rng(43)
    R, NBLK = ps.FUSED_BLOCK_ROWS, 6
    planes = {
        "a": rng.integers(0, 40, (NBLK, R)).astype(np.uint8),
        "b": rng.integers(0, 3000, (NBLK, R)).astype(np.uint16),
        "c": rng.integers(-128, 128, (NBLK, R)).astype(np.int8),
        "d": rng.integers(-300, 300, (NBLK, R)).astype(np.int16),
        "e": rng.integers(0, 5000, (NBLK, R)).astype(np.int32),
        "f": rng.uniform(-1e3, 1e3, (NBLK, R)).astype(np.float32),
    }
    planes["f"][:, ::131] = -0.0
    params = {
        "p0": np.array([7], np.int32),
        "p1": rng.integers(0, 3000, 8).astype(np.int32),
        "p2": np.array([-20], np.int32), "p3": np.array([64], np.int32),
        "p4": np.array([1000], np.int32), "p5": np.array([4200], np.int32),
        "p6": np.array([-5, 17, 250], np.int32),
        "p7": np.array([3], np.int32), "p8": np.array([-100], np.int32),
        "p9": np.array([100], np.int32),
    }
    cand = np.array([4, 1, 5, 2, 0, 0, 0], np.int32)   # 3 padding
    rows_in = np.array([R, R, 1000, 2048, 0, 0, 0], np.int32)
    ftpl = KFILTERS[filt]
    pplan = ps.plan_fused(ftpl, KAGGS, KWIDTHS)
    assert pplan is not None
    used = {k: torch.from_numpy(v) for k, v in params.items()
            if k in pplan.pred_params}
    tcols = {k: torch.from_numpy(planes[k]) for k in pplan.cols}
    cols, lits, prog, aggs, ki, kf = ps.lower_fused(pplan, tcols, used)
    got_i, got_f, depth = _emulate_k4(cand, rows_in, cols, lits, prog, aggs,
                                      ki, kf, rng)
    assert depth == max(1, ps._stack_depth(pplan.program))
    want_i, want_f = kernels.fused_filter_agg_plain(
        torch.from_numpy(cand), torch.from_numpy(rows_in), cols, lits, prog,
        aggs, ki, kf)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_f.view(np.int32),
                                  want_f.numpy().view(np.int32))
    rplan = ref_ps.plan_fused(ftpl, KAGGS, KWIDTHS)
    ref_i, ref_f = ref_ps.fused_filter_agg(
        jnp.asarray(cand), jnp.asarray(rows_in),
        {k: jnp.asarray(planes[k].reshape(NBLK, R // 128, 128))
         for k in rplan.cols},
        {k: jnp.asarray(v.numpy()) for k, v in used.items()}, rplan,
        interpret=True)
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    np.testing.assert_array_equal(got_f.view(np.int32),
                                  np.asarray(ref_f).view(np.int32))


def test_k4_descriptor_layout_is_unchanged():
    """K4's redesign kept its descriptor: _FusedDesc mirrors struct
    FusedDesc field for field (8 plane pointers, 8 dtype codes, the
    literal table's pointer, 6 counts, 32 instructions and 8 aggregate
    specs of 5 int32 each)."""
    assert ctypes.sizeof(kernels._Instr) == 20
    assert ctypes.sizeof(kernels._Agg) == 20
    assert ctypes.sizeof(kernels._FusedDesc) == \
        8 * 8 + 8 * 4 + 8 + 6 * 4 + 32 * 20 + 8 * 20
    assert kernels.FUSED_MAX_STACK == 32
