"""A NaN under MIN / MAX: the port against the reference, in every shape
that reduces floats on order keys.

The reference propagates a NaN through MIN and MAX whatever its sign
bit (``.at[].min`` / ``.at[].max``, ``jnp.minimum`` / ``jnp.maximum`` in
its Pallas kernels, ``np.minimum.at`` on its host). The port reduces
floats on integer order keys (K2, K4, their plain versions, the torch
scatters, the sorted regime); under ``ops/agg.py float_keys`` a NaN of
either sign is the key that wins the op. Backends make NaN with
different bits (CUDA's ``sqrtf`` 0x7fffffff, numpy 0xffc00000, torch's
CPU ``sqrt`` 0x7fc00000), so the data holds NaN of both signs, stored
and computed.

The data is tests/test_torch_host_float64.py's schema with NaN written
into ``f`` (raw DOUBLE), ``fd`` (dict DOUBLE) and ``fl`` (raw FLOAT):
rows of ``d = 'a'`` hold only +NaN, ``d = 'b'`` only -NaN, ``d = 'c'``
and ``k >= 8`` none, and ±inf anywhere; sealed, consuming and warm. The
oracle is tests/test_torch_sweep.py's ``check``: the reference's
``QueryEngine()``, its host-only engine where that fails, an in-band
refusal where both fail; the port at the default kernel gate and at 0;
MIN / MAX / MINMAXRANGE bit for bit (NaN as NaN) with the same Python
type. Beside the engine cases: block skip over a time-sorted table (K4),
a group-by past the kernel gate (K2), cohorts of four (the member-axis
entries), stage 2 of a join, a two-shard mesh, a two-server cluster
whose NaN lie on one server, and the kernels' plain versions against
numpy.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_host_float64 as hf
import test_torch_join as tj
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.parallel.mesh import make_mesh
from test_torch_sweep import _select, check

TIERS = ("sealed", "consuming", "warm")
# NaN of each sign, as float64 and float32 bits (0x7fffffff: CUDA's)
POS_NAN64 = np.array(0x7FF8000000000000, np.uint64).view(np.float64)
NEG_NAN64 = np.array(0xFFF8000000000000, np.uint64).view(np.float64)
POS_NAN32 = np.array([0x7FC00000, 0x7FFFFFFF], np.uint32).view(np.float32)
NEG_NAN32 = np.array([0xFFC00000, 0xFFFFFFFF], np.uint32).view(np.float32)


def _nan_data(n: int, seed: int) -> dict:
    """hf._data with NaN of one sign per ``d`` value and ±inf in the
    float columns."""
    cols = hf._data(n, seed)
    rng = np.random.default_rng(seed + 1000)
    sign = np.select([cols["d"] == "a", cols["d"] == "b"], [1, -1], 0)
    sign[cols["k"] >= 8] = 0
    for c in ("f", "fd", "fl"):
        x = cols[c].copy()
        hit = (rng.random(n) < 0.05) & (sign != 0)
        pick = rng.integers(0, 2, n)
        if x.dtype == np.float32:
            x[hit & (sign > 0)] = POS_NAN32[pick[hit & (sign > 0)]]
            x[hit & (sign < 0)] = NEG_NAN32[pick[hit & (sign < 0)]]
        else:
            x[hit & (sign > 0)] = POS_NAN64
            x[hit & (sign < 0)] = NEG_NAN64
        inf = (rng.random(n) < 0.02) & ~hit
        x[inf] = np.where(rng.random(n) < 0.5, np.inf, -np.inf)[inf]
        cols[c] = x
    return cols


def _sealed(side, base, j: int) -> str:
    _sc, _dt, tc, creator = hf.MODS[side][:4]
    d = str(base / f"{side}{j}")
    creator.build_segment(
        hf._schema(side), _nan_data(hf.N, 40 + j), d,
        tc.TableConfig(table_name="t", indexing=tc.IndexingConfig(
            no_dictionary_columns=hf.RAW)), f"t{j}")
    return d


def _load(side, eng, tier: str, dirs: list):
    _sc, _dt, _tc, _cr, mut, tiering, segment = hf.MODS[side]
    if tier == "warm":
        for d in dirs:
            eng.add_segment("t", tiering.LazySegmentView(d))
        return eng
    eng.add_segment("t", segment.ImmutableSegment(dirs[0]))
    if tier == "sealed":
        eng.add_segment("t", segment.ImmutableSegment(dirs[1]))
    else:
        ms = mut.MutableSegment(hf._schema(side), "t__0__0__rt")
        ms.index_batch(hf._records(_nan_data(hf.N_CONSUMING, 77)))
        eng.add_segment("t", ms)
    return eng


@pytest.fixture(scope="module")
def nan_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_nan")
    return {side: [_sealed(side, base, j) for j in range(2)]
            for side in hf.MODS}


@pytest.fixture(scope="module", params=TIERS)
def engines(request, nan_dirs):
    """(reference, reference host-only, [port at each gate], tier)."""
    t = request.param
    return (_load("ref", hf._engine("ref"), t, nan_dirs["ref"]),
            _load("ref", RefEngine(device_executor=None), t,
                  nan_dirs["ref"]),
            [_load("port", hf._engine("port", g), t, nan_dirs["port"])
             for g in hf.GATES], t)


# ---------------------------------------------------------------------------
# MIN / MAX / MINMAXRANGE over stored and computed NaN, in every shape
# ---------------------------------------------------------------------------

EXTREMES = ("MIN({x})", "MAX({x})", "MINMAXRANGE({x})", "MAX({x}) - MIN({x})")
OPERANDS = {"f": "f", "fd": "fd", "fl": "fl", "sqrt_i": "SQRT(i)",
            "ln_i": "LN(i)", "i_div_0": "i / 0", "ln_fd": "LN(fd)",
            "sqrt_f_1": "SQRT(f - 1)", "f_div_0": "f / 0"}
SHAPES = {
    "scalar": (None, ""),
    "pos_nan_only": (None, "WHERE d = 'a'"),
    "neg_nan_only": (None, "WHERE d = 'b'"),
    "dict_key": ("d", ""),
    "docid": (None, "WHERE $docId < 1800"),
    "docid_dict_key": ("d", "WHERE $docId < 1800"),
    "expr_key": ("k + 0", ""),
}
HOST_SHAPES = ("docid", "docid_dict_key", "expr_key")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_extremes_propagate_nan(engines, operand, shape):
    """Bit for bit, but for the logarithm of a DOUBLE column's float32
    plane in the device shape, which the reference's XLA computes a last
    bit off libm's for some values (tests/test_torch_sweep_functions.py):
    there within ``rows_close``, NaN still as NaN."""
    x = OPERANDS[operand]
    f32_log = operand == "ln_fd" and shape not in HOST_SHAPES
    sql = _select(", ".join(a.format(x=x) for a in EXTREMES), SHAPES[shape])
    check(engines, sql, [not f32_log] * len(EXTREMES))


# the examples as first found (MIN / MAX over computed and stored NaN)
FOUND = [
    "SELECT MAX(SQRT(i)) FROM t",
    "SELECT MAX(i / 0) FROM t",
    "SELECT MIN(LN(i)), MAX(LN(i)) FROM t WHERE $docId < 1800",
    "SELECT SUM(f), MIN(f), MAX(f), AVG(f), COUNT(*) FROM t",
    "SELECT d, MIN(fl), MAX(fl) FROM t GROUP BY d ORDER BY d",
    "SELECT MIN(fd), MAX(fd), SUM(fd) FROM t",
]


@pytest.mark.parametrize("sql", FOUND)
def test_found_examples(engines, sql):
    exact = [not a.strip().startswith(("SUM", "AVG"))
             for a in sql.split(" FROM ")[0].split(",")]
    if sql.startswith("SELECT d,"):
        exact = exact[1:]
    check(engines, sql, exact)


# DISTINCTCOUNT, DISTINCTCOUNTHLL, MODE, GROUP BY and DISTINCT over NaN
# keys: one NaN, whatever its bits
KEYED = {
    "distinct": "SELECT DISTINCTCOUNT({x}), DISTINCTCOUNTHLL({x}) FROM t "
                "{w}",
    "mode": "SELECT MODE({x}) FROM t {w}",
    "group_by": "SELECT {x}, COUNT(*) FROM t {w} GROUP BY {x} "
                "ORDER BY {x} LIMIT 2000",
    "select_distinct": "SELECT DISTINCT {x} FROM t {w} ORDER BY {x} "
                       "LIMIT 2000",
}
KEYED_OPERANDS = {"fl": "fl", "sqrt_i": "SQRT(i)"}


@pytest.mark.parametrize("where", ["", "WHERE $docId < 1800"],
                         ids=["device", "docid"])
@pytest.mark.parametrize("operand", list(KEYED_OPERANDS))
@pytest.mark.parametrize("which", list(KEYED))
def test_nan_keys_count_once(engines, which, operand, where):
    sql = KEYED[which].format(x=KEYED_OPERANDS[operand], w=where)
    exact = [True] * (1 if which in ("mode", "select_distinct") else 2)
    check(engines, sql.replace("  ", " ").strip(), exact)


# ---------------------------------------------------------------------------
# a group-by past the kernel gate (K2's plain version at the default gate)
# ---------------------------------------------------------------------------

N_WIDE = 70_000   # two segments: past ps.PALLAS_MIN_ROWS together


def _wide_schema(side):
    sc, dt = hf.MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(name="w", dimensions=[("g", D.INT)],
                           metrics=[("x", D.FLOAT), ("y", D.DOUBLE)])


def _wide_data(j: int) -> dict:
    """Only positive NaN (as a CUDA-made one), in groups g < 40."""
    rng = np.random.default_rng(90 + j)
    g = rng.integers(0, 50, N_WIDE).astype(np.int32)
    x = rng.uniform(-1, 1, N_WIDE).astype(np.float32)
    y = rng.uniform(-1, 1, N_WIDE)
    hit = (rng.random(N_WIDE) < 0.01) & (g < 40)
    x[hit] = POS_NAN32[1]
    y[hit] = POS_NAN64
    return {"g": g, "x": x, "y": y}


def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def wrapped(*a, **k):
        seen[name] = seen.get(name, 0) + 1
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def wide_engines(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_nan_wide")
    dirs = {}
    for side in hf.MODS:
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        dirs[side] = []
        for j in range(2):
            d = str(base / f"{side}{j}")
            creator.build_segment(
                _wide_schema(side), _wide_data(j), d,
                tc.TableConfig(table_name="w", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["x", "y"])), f"w{j}")
            dirs[side].append(d)

    def load(side, eng):
        seg = hf.MODS[side][6]
        for d in dirs[side]:
            eng.add_segment("w", seg.ImmutableSegment(d))
        return eng
    return (load("ref", hf._engine("ref")),
            load("ref", RefEngine(device_executor=None)),
            [load("port", hf._engine("port", g)) for g in hf.GATES], "wide")


WIDE_SQL = {
    "k2": "SELECT g, MIN(x), MAX(x), MINMAXRANGE(y) FROM w GROUP BY g "
          "ORDER BY g LIMIT 100",
    "scalar": "SELECT MIN(x), MAX(y), MIN(y), MAX(x) - MIN(x) FROM w",
}


@pytest.mark.parametrize("which", list(WIDE_SQL))
def test_past_the_gate(wide_engines, which, monkeypatch):
    seen = {}
    _spy(monkeypatch, kernels, "group_minmax_plain", seen)
    sql = WIDE_SQL[which]
    want = check(wide_engines, sql, [True] * 4)
    if which == "k2":
        # K2's plain version at both gates, and a NaN in 40 of 50 groups
        assert seen.get("group_minmax_plain") == len(hf.GATES), seen
        rows = want["resultTable"]["rows"]
        assert sum(np.isnan(r[1]) for r in rows) == 40, rows


# ---------------------------------------------------------------------------
# block skip over a time-sorted table: K4's plain version
# ---------------------------------------------------------------------------

N_SORTED = 40_960   # ten zone blocks a segment: K4's bound B is 2


def _sorted_schema(side):
    sc, dt = hf.MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(name="s", dimensions=[("ts", D.LONG)],
                           metrics=[("fv", D.DOUBLE), ("fl", D.FLOAT),
                                    ("iv", D.INT)])


def _sorted_data(j: int) -> dict:
    """``ts`` ascends across the segments, two rows a value (so the
    batch's ``ts`` plane stays 16-bit, as K4's predicate planes must
    be); in each segment zone block 0 holds +NaN, block 1 -NaN, block 2
    both, the rest none; ±inf anywhere."""
    rng = np.random.default_rng(70 + j)
    n = N_SORTED
    fv = rng.uniform(-100, 100, n)
    fl = rng.uniform(-1, 1, n).astype(np.float32)
    blk = np.arange(n) // 4096
    some = rng.random(n) < 0.01
    half = rng.random(n) < 0.5
    pos = some & ((blk == 0) | ((blk == 2) & half))
    neg = some & ((blk == 1) | ((blk == 2) & ~half))
    fv[pos], fv[neg] = POS_NAN64, NEG_NAN64
    fl[pos] = POS_NAN32[rng.integers(0, 2, n)][pos]
    fl[neg] = NEG_NAN32[rng.integers(0, 2, n)][neg]
    inf = rng.random(n) < 0.002
    fv[inf] = np.inf
    fl[inf & half] = -np.inf
    return {"ts": ((j * n + np.arange(n)) // 2).astype(np.int64), "fv": fv,
            "fl": fl, "iv": rng.integers(0, 9000, n).astype(np.int32)}


@pytest.fixture(scope="module")
def sorted_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_nan_sorted")
    out = {}
    for side in hf.MODS:
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        out[side] = []
        for j in range(3):
            d = str(base / f"{side}{j}")
            creator.build_segment(
                _sorted_schema(side), _sorted_data(j), d,
                tc.TableConfig(table_name="s", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["ts"])), f"s{j}")
            out[side].append(d)
    return out


def _sorted_load(side, eng, dirs):
    seg = hf.MODS[side][6]
    for d in dirs[side]:
        eng.add_segment("s", seg.ImmutableSegment(d))
    return eng


@pytest.fixture(scope="module")
def sorted_engines(sorted_dirs):
    return (_sorted_load("ref", hf._engine("ref"), sorted_dirs),
            _sorted_load("ref", RefEngine(device_executor=None),
                         sorted_dirs),
            [_sorted_load("port", hf._engine("port", g), sorted_dirs)
             for g in hf.GATES], "sorted")


# ranges of one or two zone blocks (each a K4 candidate): +NaN only,
# -NaN only, one candidate of each sign, one block of both, none (±inf
# only), the next segment's +NaN block
RANGES = {"pos": (50, 2000), "neg": (2100, 4000),
          "pos_and_neg_blocks": (1500, 2500), "both": (4150, 6000),
          "none": (6200, 10000), "next_segment": (20530, 22500)}


@pytest.mark.parametrize("rng_", list(RANGES))
def test_block_skip_range(sorted_engines, rng_, monkeypatch):
    seen = {}
    _spy(monkeypatch, kernels, "fused_filter_agg_plain", seen)
    lo, hi = RANGES[rng_]
    sql = (f"SELECT COUNT(*), MIN(fv), MAX(fv), MIN(fl), MAX(fl), "
           f"MINMAXRANGE(fl) FROM s WHERE ts BETWEEN {lo} AND {hi}")
    want = check(sorted_engines, sql, [True] * 6)
    assert seen.get("fused_filter_agg_plain") == len(hf.GATES), seen
    row = want["resultTable"]["rows"][0]
    assert (row[1] is None) == (rng_ != "none"), row


# ---------------------------------------------------------------------------
# cohorts of four: K2's and K4's member-axis entries
# ---------------------------------------------------------------------------

def _cohort(port, sqls):
    """The solo answers, then the same queries released together through
    a forced window (tests/test_torch_coalesce.py's ``_cohort_run``)."""
    dev = port.device
    co = dev.coalescer
    co.enabled = False
    try:
        solo = [port.execute(s) for s in sqls]
    finally:
        co.enabled = True
    got = [None] * len(sqls)
    barrier = threading.Barrier(len(sqls))

    def worker(i):
        barrier.wait()
        got[i] = port.execute(sqls[i])

    c0 = co.cohorts_launched
    cap = co.max_cohort
    co.force, co.window_s, co.max_cohort = True, 2.0, len(sqls)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(sqls))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        co.force, co.window_s, co.max_cohort = False, 0.003, cap
    assert co.cohorts_launched - c0 == 1
    return solo, got


def _cohort_check(ref, port, sqls, monkeypatch, entry):
    seen = {}
    _spy(monkeypatch, ps, entry, seen)
    solo, got = _cohort(port, sqls)
    assert seen.get(entry) == 1, seen
    for sql, s, g in zip(sqls, solo, got):
        want = ref.execute(sql)
        hf.assert_host_answer(s, want, [True] * 3)
        hf.assert_host_answer(g, want, [True] * 3)


def test_k2_cohort(nan_dirs, monkeypatch):
    ref = _load("ref", hf._engine("ref"), "sealed", nan_dirs["ref"])
    port = _load("port", hf._engine("port", 0), "sealed", nan_dirs["port"])
    sqls = [f"SELECT d, MIN(fl), MAX(f), MINMAXRANGE(fd) FROM t WHERE "
            f"i > {lit} GROUP BY d ORDER BY d" for lit in (-900, -300, 0, 600)]
    _cohort_check(ref, port, sqls, monkeypatch, "group_minmax_members")


def test_k4_cohort(sorted_dirs, monkeypatch):
    ref = _sorted_load("ref", hf._engine("ref"), sorted_dirs)
    port = _sorted_load("port", hf._engine("port", 0), sorted_dirs)
    sqls = [f"SELECT MIN(fv), MAX(fl), MINMAXRANGE(fv) FROM s WHERE ts "
            f"BETWEEN {lo} AND {hi}" for lo, hi in RANGES.values()][:4]
    _cohort_check(ref, port, sqls, monkeypatch, "fused_filter_agg_members")


# ---------------------------------------------------------------------------
# stage 2 of a join, and a single stage over its fact table
# ---------------------------------------------------------------------------

def _nan_star(side):
    (fact, fcols), dim = hf._star(side)
    rng = np.random.default_rng(62)
    f = fcols["f"]
    hit = rng.random(len(f)) < 0.03
    # keys below 10 only +NaN, 10-19 only -NaN, the rest none
    f[hit & (fcols["key"] < 10)] = POS_NAN64
    f[hit & (fcols["key"] >= 10) & (fcols["key"] < 20)] = NEG_NAN64
    f[rng.random(len(f)) < 0.01] = -np.inf
    return (fact, fcols), dim


@pytest.fixture(scope="module")
def star_engines(tmp_path_factory):
    base = tmp_path_factory.mktemp("sweep_nan_star")
    out = []
    for side, eng in (("ref", hf._engine("ref")),
                      ("ref", RefEngine(device_executor=None)),
                      ("port", hf._engine("port", None)),
                      ("port", hf._engine("port", 0))):
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        (fs, fcols), (ds, dcols) = _nan_star(side)
        tag = f"{side}{len(out)}"
        half = hf.N_FACT // 2
        for j, sl in enumerate((slice(0, half), slice(half, hf.N_FACT))):
            eng.add_segment("fact", creator.build_segment(
                fs, {c: v[sl] for c, v in fcols.items()},
                str(base / f"{tag}f{j}"),
                tc.TableConfig(table_name="fact", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["big", "f"])), f"f{j}"))
        eng.add_segment("dim", creator.build_segment(
            ds, dcols, str(base / f"{tag}d"),
            tc.TableConfig(table_name="dim", is_dim_table=True), "d0"))
        eng.table("dim").is_dim_table = True
        out.append(eng)
    return out[0], out[1], out[2:], "star"


STAR_SQL = {
    "broadcast": "SET useAdvisor=false; SET joinStrategy='broadcast'; "
                 "SELECT dm.name, MIN(fa.f), MAX(fa.f), MINMAXRANGE(fa.f) "
                 "FROM fact fa JOIN dim dm ON fa.key = dm.key "
                 "GROUP BY dm.name ORDER BY dm.name",
    "shuffle": "SET useAdvisor=false; SET joinStrategy='shuffle'; "
               "SELECT dm.name, MIN(fa.f), MAX(fa.f), MINMAXRANGE(fa.f) "
               "FROM fact fa JOIN dim dm ON fa.key = dm.key "
               "GROUP BY dm.name ORDER BY dm.name",
    "scalar_join": "SET useAdvisor=false; SELECT MIN(fa.f), MAX(fa.f), "
                   "MAX(fa.f) - MIN(fa.f) FROM fact fa JOIN dim dm "
                   "ON fa.key = dm.key WHERE fa.key < 10",
    "single_stage": "SELECT key, MIN(f), MAX(f), MINMAXRANGE(f) FROM fact "
                    "GROUP BY key ORDER BY key LIMIT 100",
}


@pytest.mark.parametrize("which", list(STAR_SQL))
def test_join_fact_with_nan(star_engines, which):
    check(star_engines, STAR_SQL[which], [True] * 3)


@pytest.fixture(scope="module")
def orders_engines(tmp_path_factory):
    """tests/test_torch_join.py's tables, a +NaN price (the sign CUDA
    makes) on every 37th order and -inf on every 101st."""
    fact, parts, custs = tj.make_data(np.random.default_rng(11))
    price = fact["price"]
    price[::37], price[5::101] = POS_NAN64, -np.inf
    out = []
    for side, eng in (("ref", tj.new_engine("ref")),
                      ("ref", RefEngine(device_executor=None)),
                      ("port", hf._engine("port", None)),
                      ("port", hf._engine("port", 0))):
        out.append(tj.load(side, eng, tmp_path_factory.mktemp("nan_orders"),
                           fact, parts, custs))
    return out[0], out[1], out[2:], "orders"


ORDERS_SQL = {
    "single_stage": "SELECT status, MIN(price), MAX(price) FROM orders "
                    "GROUP BY status ORDER BY status",
    "join": "SELECT p.category, MIN(o.price), MAX(o.price) FROM orders o "
            "JOIN parts p ON o.partkey = p.pkey GROUP BY p.category "
            "ORDER BY p.category",
}


@pytest.mark.parametrize("strategy", ["broadcast", "shuffle"])
@pytest.mark.parametrize("which", list(ORDERS_SQL))
def test_orders_with_nan_prices(orders_engines, which, strategy):
    check(orders_engines, f"SET useAdvisor=false; SET joinStrategy="
          f"'{strategy}'; {ORDERS_SQL[which]}", [True] * 2)


# ---------------------------------------------------------------------------
# a two-shard mesh on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_engines(nan_dirs):
    def mesh_port(gate):
        ex = DeviceExecutor(device="cpu", mesh=make_mesh(2))
        ex.partials_cache_enabled = False
        if gate is not None:
            ex.min_rows = gate
        return _load("port", QueryEngine(device_executor=ex), "sealed",
                     nan_dirs["port"])
    return (_load("ref", hf._engine("ref"), "sealed", nan_dirs["ref"]),
            _load("ref", RefEngine(device_executor=None), "sealed",
                  nan_dirs["ref"]),
            [mesh_port(g) for g in hf.GATES], "mesh")


MESH_SQL = {
    "scalar": "SELECT MIN(f), MAX(fl), MINMAXRANGE(fd), MAX(SQRT(i)) FROM t",
    "pos_only": "SELECT MIN(f), MAX(fl), MINMAXRANGE(fd), MIN(fl) FROM t "
                "WHERE d = 'a'",
    "grouped": "SELECT d, MIN(f), MAX(fl), MINMAXRANGE(fd), MIN(fl) FROM t "
               "GROUP BY d ORDER BY d",
    "docid": "SELECT d, MIN(f), MAX(fl), MINMAXRANGE(fd), MIN(fl) FROM t "
             "WHERE $docId < 1800 GROUP BY d ORDER BY d",
}


@pytest.mark.parametrize("which", list(MESH_SQL))
def test_mesh(mesh_engines, which):
    check(mesh_engines, MESH_SQL[which], [True] * 4)


# ---------------------------------------------------------------------------
# a two-server cluster, the NaN on one server only
# ---------------------------------------------------------------------------

def _cluster(pkg: str, tmp) -> tuple:
    m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "broker.broker", "cluster.registry", "common.table_config",
        "controller.controller", "server.server", "storage.creator")}
    side = "ref" if pkg == "pinot_tpu" else "port"
    tc = m["common.table_config"]
    kw = {"device": "cpu"} if side == "port" else {}
    registry = m["cluster.registry"].ClusterRegistry()
    controller = m["controller.controller"].Controller(
        registry, str(tmp / "deepstore"))
    servers = [m["server.server"].ServerInstance(
        f"server_{i}", registry, str(tmp / f"srv{i}"), **kw)
        for i in range(2)]
    for s in servers:
        s.start()
    broker = m["broker.broker"].Broker(registry, timeout_s=20.0, **kw)
    cfg = tc.TableConfig(table_name="t", replication=1,
                         indexing=tc.IndexingConfig(
                             no_dictionary_columns=hf.RAW))
    controller.add_table(cfg, hf._schema(side))
    for j, cols in enumerate((_nan_data(hf.N, 40), hf._data(hf.N, 41))):
        d = str(tmp / f"up{j}")
        m["storage.creator"].build_segment(hf._schema(side), cols, d, cfg,
                                           f"t_{j}")
        controller.upload_segment("t", d)

    def placed():
        v = registry.external_view("t_OFFLINE")
        return len(v) == 2 and all(len(r) == 1 for r in v.values())

    t0 = time.time()
    while not placed() and time.time() - t0 < 20:
        time.sleep(0.05)
    view = registry.external_view("t_OFFLINE")
    # one segment a server: the NaN lie on one of them only
    assert len({s for r in view.values() for s in r}) == 2, view
    return broker, servers


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_nan_cluster")
    out = {pkg: _cluster(pkg, tmp / pkg)
           for pkg in ("pinot_tpu", "pinot_tpu_torch")}
    yield {pkg: broker for pkg, (broker, _servers) in out.items()}
    for broker, servers in out.values():
        broker.close()
        for s in servers:
            s.stop(drain_timeout_s=0)


CLUSTER_SQL = {
    "scalar": "SELECT MIN(f), MAX(fd), MINMAXRANGE(fl), MIN(fl) FROM t",
    "grouped": "SELECT d, MIN(f), MAX(fd), MINMAXRANGE(fl), MIN(fl) FROM t "
               "GROUP BY d ORDER BY d",
    "docid": "SELECT k, MIN(f), MAX(fd), MAX(fl) - MIN(fl), MAX(fl) FROM t "
             "WHERE $docId < 1800 GROUP BY k ORDER BY k",
    "computed": "SELECT MAX(SQRT(i)), MIN(i / 0), MAX(LN(i)), MIN(SQRT(i)) "
                "FROM t",
}


@pytest.mark.parametrize("which", list(CLUSTER_SQL))
def test_cluster_merges_a_nan_partial(clusters, which):
    sql = CLUSTER_SQL[which]
    want = clusters["pinot_tpu"].execute(sql)
    hf.assert_host_answer(clusters["pinot_tpu_torch"].execute(sql), want,
                          [True] * 4)


# ---------------------------------------------------------------------------
# the kernels' plain versions and the torch reductions against numpy
# ---------------------------------------------------------------------------

SPECIALS32 = np.array([0x7FFFFFFF, 0xFFC00000, 0x7FC00000, 0xFFFFFFFF,
                       0x7F800000, 0xFF800000, 0x00000000, 0x80000000],
                      np.uint32).view(np.float32)
G = 12   # groups 10 and 11 get no row


def _special_rows(seed: int, n: int = 4000):
    """Group ids and float32 values with the specials in some groups:
    groups 0-2 +NaN only, 3-5 -NaN only, 6-9 none (±inf, ±0.0 there)."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, 10, n).astype(np.int32)
    v = rng.uniform(-5, 5, n).astype(np.float32)
    spots = rng.choice(n, 400, replace=False)
    for r in spots:
        g = gid[r]
        pick = SPECIALS32[[0, 2]] if g < 3 else SPECIALS32[[1, 3]] \
            if g < 6 else SPECIALS32[4:]
        v[r] = pick[rng.integers(0, len(pick))]
    gid[:5] = [-1, G, G + 3, -7, G]   # outside [0, G): no group
    return gid, v


def _np_extremes(gid, v, how, fill):
    out = np.full(G, fill, v.dtype)
    ok = (gid >= 0) & (gid < G)
    (np.minimum if how == "min" else np.maximum).at(out, gid[ok], v[ok])
    return out


def _assert_extremes(got, want):
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    np.testing.assert_array_equal(got, want)


def test_k2_plain_nan_rule():
    gid, v = _special_rows(1)
    src = kernels.MinMaxSource(torch.from_numpy(v), ("min", "max"),
                               (np.inf, -np.inf))
    (mn, mx), = ps.group_minmax_sources(torch.from_numpy(gid), [src], G)
    want_mn = _np_extremes(gid, v, "min", np.inf)
    want_mx = _np_extremes(gid, v, "max", -np.inf)
    _assert_extremes(mn, want_mn)
    _assert_extremes(mx, want_mx)
    assert np.isnan(want_mn[:6]).all() and not np.isnan(want_mn[6:]).any()
    assert (want_mn[10:] == np.inf).all()   # empty groups keep the fill
    # either NaN sign, either op: the same answer under numpy's negated
    # NaN (np.negative flips the sign bit)
    (mn2, mx2), = ps.group_minmax_sources(
        torch.from_numpy(gid), [kernels.MinMaxSource(
            torch.from_numpy(-v), ("min", "max"), (np.inf, -np.inf))], G)
    _assert_extremes(mn2, _np_extremes(gid, -v, "min", np.inf))
    _assert_extremes(mx2, _np_extremes(gid, -v, "max", -np.inf))


def test_k2_members_plain_nan_rule():
    M = 3
    rows = [_special_rows(10 + m) for m in range(M)]
    gid = torch.from_numpy(np.stack([g for g, _ in rows]))
    v = np.concatenate([x for _, x in rows])
    (mn, mx), = ps.group_minmax_members(
        gid, [kernels.MinMaxSource(torch.from_numpy(v), ("min", "max"),
                                   (np.inf, -np.inf))], G)
    for m, (g, x) in enumerate(rows):
        _assert_extremes(mn[m], _np_extremes(g, x, "min", np.inf))
        _assert_extremes(mx[m], _np_extremes(g, x, "max", -np.inf))


def _k4_inputs(seed: int):
    """Six 1024-row blocks of a float32 plane: block 0 +NaN, 1 -NaN,
    2 both, 3 none, 4 only NaN rows, 5 ±inf and ±0.0; candidates in
    a scrambled order with partial rows and one padding candidate."""
    rng = np.random.default_rng(seed)
    R, NBLK = 1024, 6
    plane = rng.uniform(-3, 3, (NBLK, R)).astype(np.float32)
    for b, pick in ((0, SPECIALS32[[0, 2]]), (1, SPECIALS32[[1, 3]]),
                    (2, SPECIALS32[:4])):
        at = rng.choice(R, 20, replace=False)
        plane[b, at] = pick[rng.integers(0, len(pick), 20)]
    plane[4] = SPECIALS32[rng.integers(0, 4, R)]
    plane[5, :4] = SPECIALS32[4:]
    cand = np.array([2, 0, 5, 1, 3, 4, 0], np.int32)
    rows_in = np.array([1024, 700, 1024, 1024, 512, 1024, 0], np.int32)
    return plane, cand, rows_in


def _k4_want(plane, cand, rows_in):
    mn, mx = [], []
    for b, n in zip(cand, rows_in):
        x = plane[b, :n]
        mn.append(np.minimum.reduce(x, initial=np.inf))
        mx.append(np.maximum.reduce(x, initial=-np.inf))
    return np.array(mn, np.float32), np.array(mx, np.float32)


_K4_PROG = [(kernels.OP_TRUE, 0, 0, 0, 0)]
_K4_AGGS = [(kernels.AGG_OPS["min"], 0, 1, 0, np.inf),
            (kernels.AGG_OPS["max"], 0, 1, 1, -np.inf)]


def test_k4_plain_nan_rule():
    plane, cand, rows_in = _k4_inputs(3)
    ints, flts = kernels.fused_filter_agg(
        torch.from_numpy(cand), torch.from_numpy(rows_in),
        [torch.from_numpy(plane)], torch.zeros(0, dtype=torch.int32),
        _K4_PROG, _K4_AGGS, 8, 8)
    want_mn, want_mx = _k4_want(plane, cand, rows_in)
    _assert_extremes(flts[:, 0], want_mn)
    _assert_extremes(flts[:, 1], want_mx)
    assert ints[:, 0].tolist() == rows_in.tolist()
    assert np.isnan(want_mn[[0, 1, 3, 5]]).all()


def test_k4_members_plain_nan_rule():
    plane, cand, rows_in = _k4_inputs(4)
    M = 3
    cands = np.stack([np.roll(cand, m) for m in range(M)])
    rows = np.stack([np.roll(rows_in, m) for m in range(M)])
    ints, flts = kernels.fused_filter_agg_members(
        torch.from_numpy(cands), torch.from_numpy(rows),
        [torch.from_numpy(plane)], torch.zeros((M, 0), dtype=torch.int32),
        _K4_PROG, _K4_AGGS, 8, 8)
    for m in range(M):
        want_mn, want_mx = _k4_want(plane, cands[m], rows[m])
        _assert_extremes(flts[m, :, 0], want_mn)
        _assert_extremes(flts[m, :, 1], want_mx)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_torch_reductions_nan_rule(dtype):
    """``ops/agg.py``: the scalar MIN / MAX under a mask and the group
    scatters past the kernels' regimes, float32 and float64."""
    gid, v = _special_rows(5)
    v = v.astype(dtype)
    ok = (gid >= 0) & (gid < G)
    t, g = torch.from_numpy(v), torch.from_numpy(np.where(ok, gid, G))
    _assert_extremes(agg_ops.group_min(g, t, G),
                     _np_extremes(gid, v, "min", np.inf))
    _assert_extremes(agg_ops.group_max(g, t, G),
                     _np_extremes(gid, v, "max", -np.inf))
    for grp in (0, 4, 7):   # +NaN only, -NaN only, none
        mask = torch.from_numpy(gid == grp)
        for how, fn in (("min", agg_ops.agg_min), ("max", agg_ops.agg_max)):
            want = (np.min if how == "min" else np.max)(v[gid == grp])
            got = float(fn(t, mask))
            assert (np.isnan(got) and np.isnan(want)) or got == want, \
                (grp, how, got, want)


def test_one_key_rule():
    """A NaN of either sign is the least key for MIN and the greatest
    for MAX, in both widths; the keys decode to a NaN."""
    for dt, it in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
        v = torch.tensor([float("nan"), -float("nan"), -np.inf, -0.0, 0.0,
                          np.inf], dtype=dt)
        info = torch.iinfo(it)
        kmin, kmax = agg_ops.float_keys(v, "min"), agg_ops.float_keys(v, "max")
        assert kmin[:2].tolist() == [info.min] * 2
        assert kmax[:2].tolist() == [info.max] * 2
        assert (kmin[2:] == agg_ops.float_keys(v[2:])).all()
        assert sorted(kmin[2:].tolist()) == kmin[2:].tolist()
        assert torch.isnan(agg_ops.from_float_keys(kmin[:2], dt)).all()
        assert torch.isnan(agg_ops.from_float_keys(kmax[:2], dt)).all()
        assert torch.equal(kernels._order_keys(v.float(), "min")[:2],
                           torch.full((2,), torch.iinfo(torch.int32).min,
                                      dtype=torch.int32))
