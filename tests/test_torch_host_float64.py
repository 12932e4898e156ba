"""DOUBLE operands and integer sums that could pass 2^63, in the shapes
the reference answers on its host, held against the reference's
``QueryEngine()``.

The reference's host path reads an aggregation's operand in float64 and
reduces it with ``np.add.at`` / ``np.minimum.at`` / ``np.maximum.at``
(its engine/aggspec.py). The port answers those shapes on the card
(engine/rows.py): a float64 operand (a DOUBLE column, bare or inside an
expression) is read from the stored values, not from the float32
aggregation planes, and an integer sum whose range times the rows could
pass 2^63 is taken in float64 (K1's byte planes recombined in float64).
Stage 2 of the multi-stage engine (query2/runner.py) and the distributed
exchange sum the same way.

Segments are made from a numpy seed: sealed, a consuming
``MutableSegment`` of 5,000 rows beside a sealed one, and warm
``LazySegmentView`` segments. The port runs on the CPU at the default
kernel gate and at gate 0 (K1 and K2's plain versions). MIN / MAX /
MINMAXRANGE and MAX(x) - MIN(x) must equal the reference's bit for bit,
with the same Python type; SUM / AVG within ``rows_close`` (so of the
same type); the dataSchema equal. Where the reference answers on its
device, the port still answers as it does: from the float32 planes, and
with int64 sums that wrap.
"""

import importlib
import math
import time

import numpy as np
import pytest

import pinot_tpu.common.datatypes as r_dt
import pinot_tpu.common.schema as r_schema
import pinot_tpu.common.table_config as r_tc
import pinot_tpu.server.tiering as r_tiering
import pinot_tpu.storage.creator as r_creator
import pinot_tpu.storage.mutable as r_mut
import pinot_tpu.storage.segment as r_segment
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.common import datatypes as t_dt
from pinot_tpu_torch.common import schema as t_schema
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter, groupby_mm
from pinot_tpu_torch.server import tiering as t_tiering
from pinot_tpu_torch.storage import creator as t_creator
from pinot_tpu_torch.storage import mutable as t_mut
from pinot_tpu_torch.storage import segment as t_segment
import test_tiering
from test_torch_join import rows_close

MODS = {"ref": (r_schema, r_dt, r_tc, r_creator, r_mut, r_tiering,
                r_segment),
        "port": (t_schema, t_dt, t_tc, t_creator, t_mut, t_tiering,
                 t_segment)}
GATES = (None, 0)   # the port's kernel gate: the default and 0

N = 2500             # rows of a sealed segment
N_CONSUMING = 5000
DAY = 86_400_000
RAW = ["rk", "f", "big", "fl"]

# one query per operand column and shape: each aggregation bare and
# inside an expression; MIN / MAX and what is made of them are exact
AGGS = ("SUM({c})", "SUM({c} * 1)", "AVG({c})", "AVG({c} + 0)",
        "MIN({c})", "MIN({c} * 1)", "MAX({c})", "MAX({c} + 0)",
        "MINMAXRANGE({c})", "MAX({c}) - MIN({c})")
EXACT = [a.startswith(("MIN", "MAX")) for a in AGGS]

OPERANDS = {
    "double_raw": "f",        # raw DOUBLE at 3 decimals: float32 cannot
    "double_dict": "fd",      # hold them
    "long_past_2e60": "big",  # [2^60, 2^61): sums pass 2^63
    "long_below_2e63": "lm",  # [2^43, 2^44): sums pass 2^53, not 2^63
    "float": "fl",
    "int": "i",
}
# the host path's shapes: (group key or None, filter)
SHAPES = {
    "docid": (None, "WHERE $docId < 1800"),
    "docid_dict_key": ("d", "WHERE $docId < 1800"),
    "not_null": (None, "WHERE nv IS NOT NULL"),
    "expr_key": ("k + 0", ""),
    "raw_long_key": ("rk", ""),
    "mv_key": ("tags", ""),
    "datetrunc_key": ("DATETRUNC('DAY', ts)", ""),
}


def _schema(side):
    sc, dt = MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(
        name="t",
        dimensions=[("d", D.STRING), ("k", D.INT), ("rk", D.LONG),
                    ("ts", D.LONG)],
        multi_value_dimensions=[("tags", D.INT)],
        metrics=[("nv", D.LONG), ("f", D.DOUBLE), ("fd", D.DOUBLE),
                 ("big", D.LONG), ("lm", D.LONG), ("fl", D.FLOAT),
                 ("i", D.INT)])


def _data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    nv = rng.integers(-100, 100, n).astype(object)
    nv[rng.random(n) < 0.2] = None
    return {
        "d": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "k": rng.integers(0, 10, n).astype(np.int32),
        "rk": 2 ** 40 + 7919 * rng.integers(0, 12, n),
        "ts": 1_577_836_800_000 + rng.integers(0, 10 * DAY, n),
        "tags": [rng.integers(0, 6, rng.integers(1, 4)).tolist()
                 for _ in range(n)],
        "nv": list(nv),
        "f": np.round(rng.uniform(0, 9, n), 3),
        "fd": np.round(rng.uniform(-50, 50, n), 2),
        "big": rng.integers(2 ** 60, 2 ** 61, n),
        "lm": rng.integers(2 ** 43, 2 ** 44, n),
        "fl": rng.uniform(0, 1, n).astype(np.float32),
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
    }


def _records(cols: dict) -> list:
    n = len(cols["k"])
    return [{c: (v[j].item() if isinstance(v, np.ndarray) else v[j])
             for c, v in cols.items()} for j in range(n)]


def _sealed(side, base, j: int) -> str:
    _sc, _dt, tc, creator = MODS[side][:4]
    d = str(base / f"{side}{j}")
    creator.build_segment(
        _schema(side), _data(N, 40 + j), d,
        tc.TableConfig(table_name="t", indexing=tc.IndexingConfig(
            no_dictionary_columns=RAW)), f"t{j}")
    return d


def _engine(side, gate=None):
    if side == "ref":
        return RefEngine()
    eng = QueryEngine(device="cpu")
    eng.device.partials_cache_enabled = False
    if gate is not None:
        eng.device.min_rows = gate
    return eng


def _load(side, eng, tier: str, dirs: list):
    _sc, _dt, _tc, _cr, mut, tiering, segment = MODS[side]
    if tier == "warm":
        for d in dirs:
            eng.add_segment("t", tiering.LazySegmentView(d))
        return eng
    eng.add_segment("t", segment.ImmutableSegment(dirs[0]))
    if tier == "sealed":
        eng.add_segment("t", segment.ImmutableSegment(dirs[1]))
    else:
        ms = mut.MutableSegment(_schema(side), "t__0__0__rt")
        ms.index_batch(_records(_data(N_CONSUMING, 77)))
        eng.add_segment("t", ms)
    return eng


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("host_f64")
    return {side: [_sealed(side, base, j) for j in range(2)]
            for side in MODS}


@pytest.fixture(scope="module", params=["sealed", "consuming", "warm"])
def tier(request, dirs):
    """(reference, [port at each of GATES]) over one tier's segments."""
    t = request.param
    return (_load("ref", _engine("ref"), t, dirs["ref"]),
            [_load("port", _engine("port", g), t, dirs["port"])
             for g in GATES])


def _sql(col: str, shape: str) -> str:
    key, where = SHAPES[shape]
    aggs = ", ".join(a.format(c=col) for a in AGGS)
    if key is None:
        return f"SELECT {aggs} FROM t {where}"
    return (f"SELECT {key}, {aggs} FROM t {where} GROUP BY {key} "
            f"ORDER BY {key} LIMIT 1000")


def _same_value(x, y) -> bool:
    """Bit for bit, of one Python type (NaN as NaN)."""
    if type(x) is not type(y):
        return False
    if isinstance(y, float) and math.isnan(y):
        return math.isnan(x)
    return x == y


def assert_host_answer(got: dict, want: dict, exact: list) -> None:
    """``want``'s rows and dataSchema: the columns flagged in ``exact``
    (the trailing aggregations) bit for bit, the others within
    ``rows_close``; key columns exactly."""
    assert not got.get("exceptions"), got.get("exceptions")
    assert not want.get("exceptions"), want.get("exceptions")
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    g_rows, w_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert len(g_rows) == len(w_rows) > 0
    lead = len(w_rows[0]) - len(exact)
    flags = [True] * lead + list(exact)
    for rg, rw in zip(g_rows, w_rows):
        for x, y, bit in zip(rg, rw, flags):
            if bit:
                assert _same_value(x, y), (rg, rw)
            else:
                assert rows_close([[x]], [[y]]), (rg, rw)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("operand", list(OPERANDS))
def test_host_path_shapes_answer_as_the_host(tier, operand, shape):
    ref, ports = tier
    sql = _sql(OPERANDS[operand], shape)
    want = ref.execute(sql)
    for port in ports:
        assert_host_answer(port.execute(sql), want, EXACT)


# the F4 / F5 table: each aggregation alone, as a query would ask for it
SCALAR = ["MIN(f)", "MAX(f)", "MINMAXRANGE(f)", "MAX(f) - MIN(f)",
          "SUM(f)", "SUM(f * 1)", "AVG(f)", "SUM(big)", "SUM(big + 0)",
          "AVG(big * 1)", "SUM(lm)", "SUM(i / 3)", "MAX(big / 3)",
          "SUM(fl * 1.5)"]


@pytest.mark.parametrize("agg", SCALAR)
def test_each_aggregation_alone(tier, agg):
    ref, ports = tier
    sql = f"SELECT {agg} FROM t WHERE $docId < 1000"
    want = ref.execute(sql)
    exact = agg.startswith(("MIN", "MAX"))
    for port in ports:
        assert_host_answer(port.execute(sql), want, [exact])


# ---------------------------------------------------------------------------
# the device shape does not move
# ---------------------------------------------------------------------------

DEVICE_SQL = {
    "scalar": "SELECT SUM(big), MIN(f), MAX(f), SUM(f), AVG(f) FROM t",
    "group": "SELECT d, SUM(big), MIN(f), MAX(fd), AVG(f) FROM t "
             "GROUP BY d ORDER BY d",
}


@pytest.mark.parametrize("which", list(DEVICE_SQL))
def test_device_shape_keeps_float32_and_the_int64_wrap(dirs, which):
    """Hot sealed segments in the device shape: the answer is the
    reference's device answer (float32 planes, an int64 sum that wraps),
    not its host's, on both packages alike."""
    ref = _load("ref", _engine("ref"), "sealed", dirs["ref"])
    sql = DEVICE_SQL[which]
    want = ref.execute(sql)
    host = ref.execute(sql.replace("FROM t", "FROM t WHERE $docId >= 0"))
    for gate in GATES:
        port = _load("port", _engine("port", gate), "sealed", dirs["port"])
        got = port.execute(sql)
        lead = 1 if which == "group" else 0
        exact = [False, True, True, False] if which == "group" \
            else [False, True, True, False, False]
        assert_host_answer(got, want, exact)
        for rg, rh in zip(got["resultTable"]["rows"],
                          host["resultTable"]["rows"]):
            # the wrapped sum stays within int64, the host's passes 2^63
            assert abs(rg[lead]) < 2.0 ** 63 < rh[lead]
            assert rg[lead + 1] != rh[lead + 1]   # MIN(f) off the f32 plane


@pytest.fixture(scope="module")
def tier_parity(tmp_path_factory):
    """tests/test_tiering.py's table: the reference's host-only and warm
    engines, the port's warm and hot ones over the same directories."""
    from pinot_tpu.server.tiering import LazySegmentView as RefLazy

    _s, _c, segs, _cols = test_tiering._build(
        tmp_path_factory.mktemp("tier_parity"))
    dirs = [s.dir for s in segs]

    def engine(eng, segments):
        for seg in segments:
            eng.add_segment("tiers", seg)
        return eng

    return (engine(RefEngine(device_executor=None), segs),
            engine(RefEngine(), [RefLazy(d) for d in dirs]),
            engine(_engine("port"), [t_tiering.LazySegmentView(d)
                                     for d in dirs]),
            engine(_engine("port"), [t_segment.ImmutableSegment(d)
                                     for d in dirs]))


@pytest.mark.parametrize("sql", test_tiering.PARITY_QUERIES)
def test_tier_parity_warm_equals_the_reference_host(tier_parity, sql):
    """test_tiering.py's tier parity held to the reference itself: the
    port's warm segments answer as the reference's host-only engine and
    its warm segments do, bit for bit; its hot segments, in the device
    shape, within the tolerance the reference holds its own hot ones to
    (tests/test_torch_tiering.py holds the SUM over a DOUBLE column out
    of the replay, where the port's one engine stands for the host)."""
    ref_host, ref_warm, warm, hot = (e.execute(sql) for e in tier_parity)
    for r in (ref_host, ref_warm, warm, hot):
        assert not r.get("exceptions"), r
    want = ref_host["resultTable"]["rows"]
    assert ref_warm["resultTable"]["rows"] == want
    assert warm["resultTable"]["rows"] == want
    assert test_tiering._rows_close(hot["resultTable"]["rows"], want)


# ---------------------------------------------------------------------------
# the kernels each operand reaches
# ---------------------------------------------------------------------------

def test_double_operands_skip_the_kernels_and_long_sums_keep_k1(
        dirs, monkeypatch):
    """At gate 0, in the host path's shape: a DOUBLE operand reaches
    neither K1 nor K2 (the reference's host runs no kernel there); a sum
    of LONG values past 2^60 still goes through K1, recombined in
    float64."""
    port = _load("port", _engine("port", 0), "sealed", dirs["port"])
    ref = _load("ref", _engine("ref"), "sealed", dirs["ref"])
    seen = {"k1": [], "k2": [], "f64": 0}
    for mod, name in ((group_scatter, "plane_group_sums"),
                      (groupby_mm, "group_sums")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda g, srcs, *a, _r=real, **k:
                            seen["k1"].append([s.kind for s in srcs])
                            or _r(g, srcs, *a, **k))
    real2 = group_scatter.group_minmax_sources
    monkeypatch.setattr(group_scatter, "group_minmax_sources",
                        lambda g, srcs, *a, **k: seen["k2"].append(
                            [s.dtype for s in srcs]) or real2(g, srcs, *a,
                                                              **k))
    real3 = groupby_mm.recombine_f64
    monkeypatch.setattr(groupby_mm, "recombine_f64", lambda *a: seen.update(
        f64=seen["f64"] + 1) or real3(*a))
    sql = ("SELECT k + 0, SUM(f), AVG(fd), MIN(f), MAX(fd), MINMAXRANGE(f) "
           "FROM t GROUP BY k + 0 ORDER BY k + 0")
    assert_host_answer(port.execute(sql), ref.execute(sql),
                       [False, False, True, True, True])
    assert seen["k1"] == [[]] and seen["k2"] == [], seen   # counts alone
    sql = "SELECT k + 0, SUM(big), AVG(i) FROM t GROUP BY k + 0"
    assert_host_answer(port.execute(sql), ref.execute(sql), [False, False])
    assert seen["k1"][-1] == ["int", "int"] and seen["f64"] == 1, seen


# ---------------------------------------------------------------------------
# stage 2 and the distributed exchange
# ---------------------------------------------------------------------------

N_FACT = 4000
N_KEYS = 25
JOIN_SQL = ("SELECT dm.name, SUM(fa.big), AVG(fa.big), SUM(fa.lm), "
            "AVG(fa.lm), SUM(fa.f), AVG(fa.f), SUM(fa.i), "
            "MIN(fa.f), MAX(fa.f), MIN(fa.big), MAX(fa.lm) "
            "FROM fact fa JOIN dim dm ON fa.key = dm.key "
            "GROUP BY dm.name ORDER BY dm.name")
JOIN_EXACT = [False] * 7 + [True] * 4


def _star(side):
    sc, dt = MODS[side][:2]
    D = dt.DataType
    fact = sc.Schema.build(name="fact", dimensions=[("key", D.INT)],
                           metrics=[("big", D.LONG), ("lm", D.LONG),
                                    ("f", D.DOUBLE), ("i", D.INT)])
    dim = sc.Schema.build(name="dim", dimensions=[("key", D.INT),
                                                  ("name", D.STRING)],
                          primary_key_columns=["key"])
    rng = np.random.default_rng(61)
    fcols = {"key": rng.integers(0, N_KEYS, N_FACT).astype(np.int32),
             "big": rng.integers(2 ** 60, 2 ** 61, N_FACT),
             "lm": rng.integers(2 ** 43, 2 ** 44, N_FACT),
             "f": np.round(rng.uniform(0, 9, N_FACT), 3),
             "i": rng.integers(-1000, 1000, N_FACT).astype(np.int32)}
    dcols = {"key": np.arange(N_KEYS, dtype=np.int32),
             "name": np.array([f"n{j % 5}" for j in range(N_KEYS)])}
    return (fact, fcols), (dim, dcols)


@pytest.fixture(scope="module")
def star_engines(tmp_path_factory):
    base = tmp_path_factory.mktemp("host_f64_star")
    out = {}
    for side, gate in (("ref", None), ("port", None), ("port", 0)):
        _sc, _dt, tc, creator = MODS[side][:4]
        eng = _engine(side, gate)
        (fs, fcols), (ds, dcols) = _star(side)
        half = N_FACT // 2
        for j, sl in enumerate((slice(0, half), slice(half, N_FACT))):
            eng.add_segment("fact", creator.build_segment(
                fs, {c: v[sl] for c, v in fcols.items()},
                str(base / f"{side}{gate}f{j}"),
                tc.TableConfig(table_name="fact", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["big", "f"])), f"f{j}"))
        eng.add_segment("dim", creator.build_segment(
            ds, dcols, str(base / f"{side}{gate}d"),
            tc.TableConfig(table_name="dim", is_dim_table=True), "d0"))
        eng.table("dim").is_dim_table = True
        out[(side, gate)] = eng
    return out


@pytest.mark.parametrize("gate", GATES, ids=["gate", "gate0"])
def test_stage2_sums_in_float64(star_engines, gate, monkeypatch):
    """Stage 2's group partials: K1 at gate 0 (``_k1_partials``, its
    planes recombined in float64 for the LONG values past 2^60), the
    torch scatters at the default gate (``_torch_partial``)."""
    calls = []
    real = group_scatter.plane_group_sums
    monkeypatch.setattr(group_scatter, "plane_group_sums",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sql = "SET useAdvisor=false; " + JOIN_SQL
    want = star_engines[("ref", None)].execute(sql)
    assert_host_answer(star_engines[("port", gate)].execute(sql), want,
                       JOIN_EXACT)
    assert bool(calls) == (gate == 0)


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
    for name, schema, cols in zip(("fact", "dim"), *zip(*_star(side))):
        cfg = tc.TableConfig(table_name=name, replication=2)
        controller.add_table(cfg, schema)
        n = len(cols["key"])
        for j, sl in enumerate((slice(0, n // 2), slice(n // 2, n))):
            d = str(tmp / f"up_{name}{j}")
            m["storage.creator"].build_segment(
                schema, {c: v[sl] for c, v in cols.items()}, d, cfg,
                f"{name}_{j}")
            controller.upload_segment(name, d)

    def ready():   # both segments of each table on both servers
        views = [registry.external_view(f"{t}_OFFLINE")
                 for t in ("fact", "dim")]
        return all(len(v) == 2 and all(len(r) == 2 for r in v.values())
                   for v in views)

    t0 = time.time()
    while not ready() and time.time() - t0 < 20:
        time.sleep(0.05)
    return broker, servers


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The star's tables on a two-server cluster of each package."""
    tmp = tmp_path_factory.mktemp("host_f64_cluster")
    out = {pkg: _cluster(pkg, tmp / pkg)
           for pkg in ("pinot_tpu", "pinot_tpu_torch")}
    yield {pkg: broker for pkg, (broker, _servers) in out.items()}
    for broker, servers in out.values():
        broker.close()
        for s in servers:
            s.stop(drain_timeout_s=0)


CLUSTER_SQL = {
    # the distributed exchange's owned partitions (``stage2_partial``)
    # and the wire codec that ships them
    "distributed_join": ("SET joinStrategy = 'distributed'; " + JOIN_SQL,
                         JOIN_EXACT),
    # the servers' DataTables and the broker's merge of their partials
    "broker_merge": ("SELECT key, SUM(big), AVG(big), SUM(f), MIN(f), "
                     "MAX(f), MINMAXRANGE(big) FROM fact WHERE $docId < 1500 "
                     "GROUP BY key ORDER BY key LIMIT 100",
                     [False] * 3 + [True] * 3),
}


@pytest.mark.parametrize("which", list(CLUSTER_SQL))
def test_cluster_keeps_the_float64_partials(clusters, which):
    """Through a cluster the port's answer is the reference cluster's:
    the float64 partials stay float64 on every hop."""
    sql, exact = CLUSTER_SQL[which]
    want = clusters["pinot_tpu"].execute(sql)
    got = clusters["pinot_tpu_torch"].execute(sql)
    assert want.get("joinStrategy") == got.get("joinStrategy")
    assert_host_answer(got, want, exact)
