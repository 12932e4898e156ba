"""Coalesced cohorts on the port against the JAX package.

The member-axis entries of K1-K4 (ops/kernels.py ``*_members``) run here
as their plain versions: each is held, at M = 1, 3 and 8 members, against
the reference's Pallas entry in interpret mode (M solo calls; at M = 8
one call under ``jax.vmap``, the reference's own cohort form, as an
interpret-mode call costs ~0.6 s whatever its size) and against M solo
calls of the port's plain version (integers bit for bit, float planes
within 1e-6 relative). Then the engine: same-template queries
released together through a forced window (``coalescer.force``) equal
their solo answers and the reference's, stats included; the terminal
DISTINCTCOUNT + DISTINCTCOUNTHLL cohort; members whose ``ps_alive``
differ; a block-skip cohort where one member overflows the candidate
bound; an idle executor opening no window; the stream windows and the
all-abandoned cohort (after tests/test_subrtt.py); and one call of each
member-axis wrapper per cohort.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.ops import groupby_mm as ref_mm
from pinot_tpu.ops import hll as ref_hll
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import cohort
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.inflight import LaunchCoalescer
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.query.rewrite import expand_star
from pinot_tpu_torch.sql.compiler import compile_select
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS, ImmutableSegment

MEMBERS = [1, 3, 8]
N = 4096


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def _reference(fn, *stacked):
    """``fn`` (a reference Pallas entry in interpret mode) per member:
    M solo calls up to 3 members, else one call under ``jax.vmap``.
    Returns numpy outputs with a leading member axis."""
    M = stacked[0].shape[0]
    if M > 3:
        out = jax.vmap(fn)(*(jnp.asarray(a) for a in stacked))
        return jax.tree_util.tree_map(np.asarray, out)
    per = [fn(*(jnp.asarray(a[m]) for a in stacked)) for m in range(M)]
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x)
                                                        for x in xs]), *per)


# ---------------------------------------------------------------------------
# the member-axis plain versions against the reference's Pallas entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", MEMBERS)
def test_k1_members_match_reference_plane_sums(M):
    G, nplanes = 300, 3
    rng = np.random.default_rng(M)
    gid = rng.integers(0, G + 1, (M, N)).astype(np.int32)
    val = rng.integers(-5_000_000, 5_000_000, N).astype(np.int64)
    offs = -5_000_000 - np.arange(M, dtype=np.int64) * 17
    flt = rng.uniform(1.0, 100.0, N).astype(np.float32)
    got = ps.plane_group_sums_members(
        torch.from_numpy(gid),
        [kernels.PlaneSource(torch.from_numpy(val), "int", nplanes,
                             minus=torch.from_numpy(offs)),
         kernels.PlaneSource(torch.from_numpy(flt), "float")], G, count=True)
    assert tuple(got.shape) == (M, 1 + nplanes + 3, G)

    def ref(g, off):
        ch = jnp.stack([jnp.ones(N, jnp.bfloat16)]
                       + ref_mm.int_planes(jnp.asarray(val), off, nplanes)
                       + ref_mm.float_planes(jnp.asarray(flt)))
        return ref_ps.plane_group_sums(g, ch, G, interpret=True,
                                       first_channel_ones=True)

    want = _reference(ref, gid, offs)
    np.testing.assert_array_equal(got[:, :1 + nplanes].numpy(),
                                  want[:, :1 + nplanes])
    np.testing.assert_allclose(got[:, 1 + nplanes:].numpy(),
                               want[:, 1 + nplanes:], rtol=1e-6)
    for m in range(M):
        solo = kernels.group_plane_sums_plain(
            torch.from_numpy(gid[m]),
            [kernels.PlaneSource(torch.from_numpy(val), "int", nplanes,
                                 minus=torch.tensor(int(offs[m]))),
             kernels.PlaneSource(torch.from_numpy(flt), "float")], G, True)
        assert torch.equal(got[m], solo)


@pytest.mark.parametrize("M", MEMBERS)
def test_k1_members_single_accumulator_entry(M):
    """The single-accumulator entry (the reference's ``group_sums``), each
    member's own values (a gathered block-skip plane)."""
    G = 255
    rng = np.random.default_rng(10 + M)
    gid = rng.integers(0, G + 1, (M, N)).astype(np.int32)
    val = rng.integers(0, 60000, (M, N)).astype(np.int32)
    got = mm.group_sums_members(
        torch.from_numpy(gid),
        [kernels.PlaneSource(torch.from_numpy(val), "int", 2,
                             minus=torch.tensor(0))], G, count=True)
    def ref(g, v):
        ch = jnp.stack([jnp.ones(N, jnp.bfloat16)] + ref_mm.int_planes(v, 0, 2))
        return ref_mm.group_sums(g, ch, G, interpret=True,
                                 first_channel_ones=True)

    np.testing.assert_array_equal(got.numpy(), _reference(ref, gid, val))


@pytest.mark.parametrize("M", MEMBERS)
def test_k2_members_match_reference_minmax(M):
    G = 500
    rng = np.random.default_rng(20 + M)
    gid = rng.integers(0, G + 1, (M, N)).astype(np.int32)
    ival = rng.integers(-1_000_000, 1_000_000, N).astype(np.int32)
    fval = rng.uniform(-5, 5, N).astype(np.float32)
    ifill = (np.iinfo(np.int32).max, np.iinfo(np.int32).min)
    ffill = (float("inf"), float("-inf"))
    got = ps.group_minmax_members(
        torch.from_numpy(gid),
        [kernels.MinMaxSource(torch.from_numpy(ival), ("min", "max"), ifill),
         kernels.MinMaxSource(torch.from_numpy(fval), ("min", "max"), ffill)],
        G)
    for (val, fills), res in zip(((ival, ifill), (fval, ffill)), got):
        want = _reference(lambda g, _v=val, _f=fills: tuple(ref_ps.group_minmax(
            g, jnp.asarray(_v), G, ("min", "max"), interpret=True, fills=_f)),
            gid)
        for g, w in zip(res, want):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.view(np.int32))
        for m in range(M):
            solo = kernels.group_minmax_plain(
                torch.from_numpy(gid[m]),
                [kernels.MinMaxSource(torch.from_numpy(val), ("min", "max"),
                                      fills)], G)[0]
            for g, s_ in zip(res, solo):
                assert torch.equal(g[m], s_)


@pytest.mark.parametrize("M", MEMBERS)
def test_k3_members_match_reference_registers(M):
    """The small-slot entry (the reference's presence kernel, per-member
    masks) and the group entry (rho mode, per-member ids)."""
    log2m = 8
    m_ = 1 << log2m
    rng = np.random.default_rng(30 + M)
    h = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    idx, rho = ref_hll.hll_idx_rho(jnp.asarray(h.view(np.uint32)), log2m)
    idx, rho = np.asarray(idx), np.asarray(rho)
    nrho = mm.hll_nrho(log2m)
    mask = rng.random((M, N)) >= 0.3
    got = ps.hll_register_max_members(torch.from_numpy(h), log2m, M,
                                      mask=torch.from_numpy(mask))
    G = 7
    gid = rng.integers(0, G + 1, (M, N)).astype(np.int32)
    got_g = mm.hll_registers_members(torch.from_numpy(h),
                                     torch.from_numpy(gid), M, G, log2m)
    slots = np.where(mask, idx[None], m_).astype(np.int32)
    want = _reference(lambda s_: ref_ps.hll_register_max(
        s_, jnp.asarray(rho), m_, nrho, interpret=True), slots)
    np.testing.assert_array_equal(got.numpy(), want)
    slots = np.where(gid < G, gid.astype(np.int64) * m_ + idx[None],
                     G * m_).astype(np.int32)
    want = _reference(lambda s_: ref_mm.hll_registers(
        s_, jnp.asarray(rho), G, log2m, interpret=True), slots)
    np.testing.assert_array_equal(got_g.numpy(), want)
    for m in range(M):
        assert torch.equal(got[m], kernels.hll_register_max_plain(
            torch.from_numpy(h), log2m, 1, mask=torch.from_numpy(mask[m])))


KWIDTHS = {"b": ("uint16", 0, False, None), "c": ("int8", 0, False, None),
           "e": ("int32", 0, False, None), "f": ("float32", 0, False, None)}
KFILTER = ("and", ("range_dict", "b", "p0", "p1"),
           ("not", ("eq_raw", ("raw", "c"), "p2")))
KAGGS = (("count", None, None), ("sum", ("raw", "b"), (2, 1 << 20)),
         ("min", ("raw", "e"), None), ("max", ("raw", "f"), None))


@pytest.mark.parametrize("M", MEMBERS)
def test_k4_members_match_reference_fused(M):
    """Each member's own candidates (padded with the invalid candidate),
    rows and literals over shared planes."""
    rng = np.random.default_rng(40 + M)
    R, NBLK, B = ZONE_BLOCK_ROWS, 6, 4
    planes = {"b": rng.integers(0, 3000, (NBLK, R)).astype(np.uint16),
              "c": rng.integers(0, 20, (NBLK, R)).astype(np.int8),
              "e": rng.integers(0, 50, (NBLK, R)).astype(np.int32),
              "f": rng.uniform(-1e3, 1e3, (NBLK, R)).astype(np.float32)}
    cand = np.zeros((M, B), np.int32)
    rows_in = np.zeros((M, B), np.int32)
    params = {"p0": [], "p1": [], "p2": []}
    for m in range(M):
        k = 1 + m % 3
        cand[m, :k] = rng.permutation(NBLK)[:k]
        rows_in[m, :k] = R
        rows_in[m, k - 1] = 1000 + 100 * m  # a partial last block
        params["p0"].append(np.array([100 * m], np.int32))
        params["p1"].append(np.array([2000 + 50 * m], np.int32))
        params["p2"].append(np.array([m], np.int32))
    rplan = ref_ps.plan_fused(KFILTER, KAGGS, KWIDTHS)
    pplan = ps.plan_fused(KFILTER, KAGGS, KWIDTHS)
    assert rplan is not None and pplan is not None
    got_i, got_f = ps.fused_filter_agg_members(
        torch.from_numpy(cand), torch.from_numpy(rows_in),
        {k: torch.from_numpy(planes[k]) for k in pplan.cols},
        {k: torch.from_numpy(np.stack(v)) for k, v in params.items()}, pplan)
    cols3 = {k: jnp.asarray(planes[k].reshape(NBLK, R // 128, 128))
             for k in rplan.cols}
    keys = sorted(params)
    want_i, want_f = _reference(
        lambda c, r, *p: tuple(ref_ps.fused_filter_agg(
            c, r, cols3, dict(zip(keys, p)), rplan, interpret=True)),
        cand, rows_in, *(np.stack(params[k]) for k in keys))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    for m in range(M):
        pm = {k: v[m] for k, v in params.items()}
        solo_i, solo_f = ps.fused_filter_agg(
            torch.from_numpy(cand[m]), torch.from_numpy(rows_in[m]),
            {k: torch.from_numpy(planes[k]) for k in pplan.cols},
            {k: torch.from_numpy(v) for k, v in pm.items()}, pplan)
        assert torch.equal(solo_i, got_i[m]) and torch.equal(solo_f, got_f[m])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

STRIP = ("timeUsedMs", "partialsCacheHit", "deviceBytesMoved",
         "deviceKernelMs", "deviceLinkMs", "roofline", "advisorDecisions")
STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned", "totalDocs",
         "numGroupsLimitReached")


def canonical(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in STRIP}


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
    return a == b


def _same_as_reference(got: dict, want: dict) -> None:
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert len(rows) == len(ref_rows)
    for a, b in zip(rows, ref_rows):
        assert all(_close(x, y) for x, y in zip(a, b)), (a, b)
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Four segments, ``ts`` sorted within each and ascending across them
    (a window prunes whole segments; zone blocks of 4096 rows)."""
    schema = Schema.build(
        name="t",
        dimensions=[("dim1", DataType.STRING), ("dim2", DataType.INT),
                    ("ts", DataType.LONG)],
        metrics=[("ivalue", DataType.INT), ("fv", DataType.FLOAT)])
    base = tmp_path_factory.mktemp("torch_coalesce")
    rng = np.random.default_rng(5)
    out = []
    for i in range(4):
        n = 9000
        d = str(base / f"s{i}")
        build_segment(schema, {
            "dim1": np.array([f"d{j:02d}" for j in range(20)])[
                rng.integers(0, 20, n)],
            "dim2": rng.integers(0, 7, n).astype(np.int32),
            "ts": np.sort(rng.integers(0, 10000, n) + 10000 * i).astype(
                np.int64),
            "ivalue": rng.integers(0, 10000, n).astype(np.int32),
            "fv": rng.random(n).astype(np.float32),
        }, d, None, f"s{i}")
        out.append(d)
    return out


@pytest.fixture(scope="module")
def engines(dirs):
    ref = RefEngine()
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0
    for d in dirs:
        ref.add_segment("t", RefSegment(d))
        port.add_segment("t", ImmutableSegment(d))
    return ref, port


def _cohort_run(port, sqls, window_s=2.0):
    """Solo answers first (coalescer off), then the same queries released
    together through a forced window that closes when the last of them
    has joined (``max_cohort``): the window only bounds a late member.
    Returns (solo, coalesced, cohorts launched, members joined)."""
    dev = port.device
    dev.partials_cache_enabled = False
    co = dev.coalescer
    co.enabled = False
    try:
        solo = [port.execute(s) for s in sqls]
    finally:
        co.enabled = True
    c0 = (co.cohorts_launched, co.queries_coalesced)
    got = [None] * len(sqls)
    errors = []
    barrier = threading.Barrier(len(sqls))

    def worker(i):
        try:
            barrier.wait()
            got[i] = port.execute(sqls[i])
        except BaseException as e:  # noqa: BLE001 — raised after the join
            errors.append(e)

    cap = co.max_cohort
    co.force, co.window_s, co.max_cohort = True, window_s, len(sqls)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(sqls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        co.force, co.window_s, co.max_cohort = False, 0.003, cap
        dev.partials_cache_enabled = True
    assert not errors, errors
    assert dev.inflight == 0 and not dev._inflight_launches
    return (solo, got, co.cohorts_launched - c0[0],
            co.queries_coalesced - c0[1])


COHORT_SQLS = [
    f"SELECT dim1, COUNT(*), SUM(ivalue), MIN(ivalue), MAX(fv) FROM t "
    f"WHERE ivalue > {lit} GROUP BY dim1 ORDER BY SUM(ivalue) DESC, dim1 "
    f"LIMIT 15" for lit in (100, 1500, 3000, 4500, 6000, 7500, 9000, 9900)]


def test_forced_window_cohort_equals_solo_and_reference(engines):
    ref, port = engines
    solo, got, launched, joined = _cohort_run(port, COHORT_SQLS)
    assert (launched, joined) == (1, len(COHORT_SQLS) - 1)
    for sql, s, g in zip(COHORT_SQLS, solo, got):
        assert canonical(g) == canonical(s), sql
        _same_as_reference(g, ref.execute(sql))


def test_terminal_sketch_cohort(engines):
    """DISTINCTCOUNT and DISTINCTCOUNTHLL finalize on the card per member
    under the member axis."""
    ref, port = engines
    sqls = [f"SELECT dim2, DISTINCTCOUNT(dim1), DISTINCTCOUNTHLL(dim1) "
            f"FROM t WHERE ivalue > {lit} GROUP BY dim2 ORDER BY dim2"
            for lit in (100, 3000, 6000, 9000)]
    solo, got, launched, joined = _cohort_run(port, sqls)
    assert (launched, joined) == (1, len(sqls) - 1)
    for sql, s, g in zip(sqls, solo, got):
        assert canonical(g) == canonical(s), sql
        _same_as_reference(g, ref.execute(sql))


def test_members_with_different_alive_segments(engines):
    """Windows that prune different segments: ps_alive is each member's
    own row of the stacked params."""
    ref, port = engines
    windows = [(100, 1500), (21000, 22000), (9000, 31000), (30500, 39000)]
    sqls = [f"SELECT dim2, COUNT(*), SUM(ivalue), SUM(fv) FROM t WHERE ts "
            f"BETWEEN {lo} AND {hi} AND ivalue < 9000 GROUP BY dim2 "
            f"ORDER BY dim2" for lo, hi in windows]
    solo, got, launched, joined = _cohort_run(port, sqls)
    assert (launched, joined) == (1, len(sqls) - 1)
    assert len({g["numSegmentsPrunedByServer"] for g in got}) > 1
    for sql, s, g in zip(sqls, solo, got):
        assert canonical(g) == canonical(s), sql
        _same_as_reference(g, ref.execute(sql))


@pytest.fixture
def member_calls(monkeypatch):
    """Calls of each member-axis wrapper and of the solo wrappers."""
    seen = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            seen[name] = seen.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("plane_group_sums_members", "group_minmax_members",
                 "hll_register_max_members", "fused_filter_agg_members",
                 "plane_group_sums", "group_minmax", "group_minmax_sources",
                 "hll_register_max", "fused_filter_agg"):
        spy(ps, name)
    for name in ("group_sums_members", "hll_registers_members", "group_sums",
                 "hll_registers"):
        spy(mm, name)
    return seen


def test_block_skip_cohort_splits_dense_and_skip(engines, member_calls):
    """Four members fit the candidate bound, one overflows it: the cohort
    splits into a skip sub-cohort (one K4 member-axis call) and a dense
    one, and every member's stats (blocks pruned, entries scanned) are
    its solo run's and the reference's."""
    ref, port = engines
    ranges = [(100, 900), (10100, 10500), (20300, 20800), (30000, 30400),
              (0, 39999)]
    sqls = [f"SELECT COUNT(*), SUM(ivalue), MIN(ivalue) FROM t WHERE "
            f"ts BETWEEN {lo} AND {hi}" for lo, hi in ranges]
    solo, got, launched, joined = _cohort_run(port, sqls)
    assert (launched, joined) == (1, len(sqls) - 1)
    for sql, s, g in zip(sqls, solo, got):
        assert canonical(g) == canonical(s), sql
        _same_as_reference(g, ref.execute(sql))
    assert got[0]["numBlocksPruned"] > 0 and got[-1]["numBlocksPruned"] == 0
    # the solo runs called K4's solo entry per member; the cohort once
    assert member_calls.get("fused_filter_agg_members") == 1
    assert member_calls.get("fused_filter_agg") == len(ranges) - 1


def test_one_call_per_kernel_per_cohort(engines, member_calls):
    """q6's shape: COUNT through K1's and MIN / MAX through K2's
    member-axis entry, once each for the cohort; a scalar HLL cohort
    through K3's once."""
    _ref, port = engines
    sqls = [f"SELECT dim2, MIN(ivalue), MAX(ivalue), COUNT(*) FROM t "
            f"WHERE ivalue BETWEEN {a} AND {a + 4000} GROUP BY dim2 "
            f"ORDER BY dim2" for a in (0, 2000, 4000, 6000)]
    _cohort_run(port, sqls)
    assert member_calls.get("plane_group_sums_members", 0) \
        + member_calls.get("group_sums_members", 0) == 1
    assert member_calls.get("group_minmax_members") == 1
    member_calls.clear()
    sqls = [f"SELECT COUNT(*), DISTINCTCOUNTHLL(dim1) FROM t WHERE "
            f"ivalue < {lit}" for lit in (1000, 4000, 7000)]
    _cohort_run(port, sqls)
    assert member_calls.get("hll_register_max_members", 0) \
        + member_calls.get("hll_registers_members", 0) == 1


def test_cohort_below_min_rows_takes_the_torch_scatters(engines,
                                                       member_calls):
    """Below ``min_rows`` a cohort routes as its solo launches do: every
    leaf through the torch scatters over member-offset ids, no kernel
    entry called, and each member's answer its solo run's and the
    reference's."""
    ref, port = engines
    sqls = [f"SELECT dim2, COUNT(*), SUM(ivalue), MINMAXRANGE(fv), "
            f"DISTINCTCOUNT(dim1), DISTINCTCOUNTHLL(dim1) FROM t WHERE "
            f"ivalue > {lit} GROUP BY dim2 ORDER BY dim2"
            for lit in (100, 3000, 6000, 9000)] \
        + [f"SELECT COUNT(*), MAX(ivalue), DISTINCTCOUNTHLL(dim1) FROM t "
           f"WHERE ivalue < {lit}" for lit in (1000, 4000, 7000)]
    dev = port.device
    dev.min_rows = 1 << 40
    try:
        for group in (sqls[:4], sqls[4:]):
            solo, got, launched, joined = _cohort_run(port, group)
            assert (launched, joined) == (1, len(group) - 1)
            for sql, s, g in zip(group, solo, got):
                assert canonical(g) == canonical(s), sql
                _same_as_reference(g, ref.execute(sql))
    finally:
        dev.min_rows = 0
    assert not member_calls, member_calls


def test_idle_executor_opens_no_window(engines):
    _ref, port = engines
    co = port.device.coalescer
    assert not co.should_window(1) and co.should_window(2)
    c0 = co.cohorts_launched
    t = time.perf_counter()
    port.execute(COHORT_SQLS[0].replace("100", "123"))
    assert co.cohorts_launched == c0
    assert time.perf_counter() - t < 30


def test_sorted_regime_and_host_shapes_dispatch_solo():
    """The templates a cohort covers (engine/cohort.py)."""
    dense = ("groupby", ("true",), ("a",), (10,), (("sum", ("raw", "x"),
                                                    (2, 256)),), 0, False)
    assert cohort.cohort_supported(dense)
    assert not cohort.cohort_supported(("groupby_sorted",) + dense[1:])
    with_time = dense[:4] + ((("firstwithtime", (("raw", "x"), ("raw", "t")),
                               "pair"),),) + dense[5:]
    assert not cohort.cohort_supported(with_time)
    lit_arg = dense[:4] + ((("sum", ("plus", ("raw", "x"), ("lit", "p0")),
                             (2, 256)),),) + dense[5:]
    assert not cohort.cohort_supported(lit_arg)


# ---------------------------------------------------------------------------
# stream windows (after tests/test_subrtt.py)
# ---------------------------------------------------------------------------


def test_successor_buffers_until_predecessor_fetch():
    co = LaunchCoalescer(window_s=0.001, stream_cap_s=5.0)
    co.force = True
    release = threading.Event()
    dispatched = []

    def launch_fn(members):
        dispatched.append(list(members))

        def resolve():
            release.wait(10)
            return [{"x": np.zeros(1)} for _ in members]

        return resolve

    c1, _ = co.join("k", {"p": 1}, launch_fn)
    t1 = threading.Thread(target=lambda: c1.resolve_member(0))
    t1.start()
    time.sleep(0.05)
    out = [None, None]

    def second(i):
        out[i] = co.join("k", {"p": 10 + i}, launch_fn)

    w0 = threading.Thread(target=second, args=(0,))
    w0.start()
    time.sleep(0.1)
    w1 = threading.Thread(target=second, args=(1,))
    w1.start()
    time.sleep(0.2)
    assert len(dispatched) == 1 and co.stream_windows == 1
    release.set()
    for t in (t1, w0, w1):
        t.join(10)
    assert len(dispatched) == 2 and len(dispatched[1]) == 2
    assert out[0][0] is out[1][0]
    out[0][0].resolve_member(0)


def test_stream_cap_bounds_abandoned_predecessor():
    co = LaunchCoalescer(window_s=0.001, stream_cap_s=0.05)
    co.force = True

    def launch_fn(members):
        return lambda: [{"x": np.zeros(1)} for _ in members]

    co.join("k", {"p": 1}, launch_fn)  # never fetched
    t0 = time.monotonic()
    c2, _ = co.join("k", {"p": 2}, launch_fn)
    assert time.monotonic() - t0 < 2.0
    assert c2.ready.is_set()


def test_all_abandoned_cohort_signals_fetch_done(engines):
    _ref, port = engines
    dev = port.device
    dev.partials_cache_enabled = False
    co = dev.coalescer
    q = optimize_query(compile_select(parse_sql(
        "SELECT dim2, COUNT(*) FROM t GROUP BY dim2")))
    segs = table_segs(port, "t")
    q = expand_star(q, segs[0].column_names())
    co.force = True
    try:
        handle = dev.launch(q, list(segs))
        handle.release()  # abandoned, never fetched
    finally:
        co.force = False
        dev.partials_cache_enabled = True
    done = list(co._last_dispatched.values())[-1]
    assert done.is_set()
    assert dev.inflight == 0 and not dev._inflight_launches
