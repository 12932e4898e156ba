"""A differential sweep of K4's surface (the fused block-skip filter and
scalar aggregation, ops/group_scatter.py ``fused_filter_agg``) against
the reference, through every merge that puts a second partial beside
K4's.

The table ``f`` holds one INT column for each width plan that
engine/params.py ``_int_for_plan`` makes, and a LONG: ``si`` (signed,
u16 plus an offset), ``dt`` (yyyymmdd, u16 plus the offset 19920101, as
SSB's ``lo_orderdate``), ``yr`` (a year, u8 plus an offset), ``q`` (1 to
50, u8 without one), ``wi`` (an int32 plane) and ``lg`` (epoch millis,
an int64 plane, which K4 declines); ``u`` is a dimension of 5,000
values for tests/test_torch_partial_shapes.py's sorted regime. Its rows
come in 4,096-row parts (one zone block each) sorted by ``dt``, and a
3,000-row tail of late rows over every date, which no range filter
prunes. Every setting holds the same rows:
- ``consuming``: the four parts sealed, the tail in a consuming
  ``MutableSegment``;
- ``chunklets``: the first part sealed, the rest in a consuming segment
  whose three promoted chunklets form a batch of their own beside its
  tail;
- ``mesh``: the consuming layout on a 4-device CPU mesh, a sealed part
  a shard;
- ``cluster``: the five parts sealed on two servers (replication 1)
  behind a broker, which merges their DataTables;
- ``cohort``: the consuming layout, every filter of a case released
  together through a forced coalescing window (the range filters share
  a template, and so do the two EQ filters).
Two sealed batches come only where the reference's device refuses a
query (engine/engine.py ``_scan_plan``), and K4 takes no such query:
tests/test_torch_partial_shapes.py holds that merge.

The oracle is the reference's ``QueryEngine()`` over the consuming
layout, in its dense form (``SET useBlockSkip = false``, which the
reference holds equal to its block-skip forms), once per query, since
every setting holds the same rows. The port runs at the default kernel
gate and at gate 0, with the plan advisor off (``PORT_OPTIONS``). As
tests/test_torch_sweep.py's ``check``: COUNT,
MIN, MAX and MINMAXRANGE bit for bit with the same Python type, SUM and
AVG within ``rows_close``, the dataSchema equal, and no RuntimeWarning
from the port. This file holds ``si`` and ``dt``;
tests/test_torch_sweep_fused_narrow.py and
tests/test_torch_sweep_fused_wide.py run the same cases over ``yr`` and
``q``, and over ``wi`` and ``lg``, so that the three can run on three
workers.
"""

import contextlib
import importlib
import threading
import warnings

import numpy as np
import pytest

import test_torch_host_float64 as hf
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.parallel.mesh import make_mesh
from test_torch_cluster import _pin_replica_order, _wait

PART, PARTS, TAIL = 4096, 4, 3000
CHUNKLET = 4096
DAYS = 2557               # 1992-01-01 ... 1998-12-31
EPOCH_1992_MS = 694_224_000_000
COLUMNS = {"signed": "si", "date": "dt", "year": "yr", "small": "q",
           "int32": "wi", "long": "lg"}
AGGS = {"count": "COUNT({c})", "sum": "SUM({c})", "avg": "AVG({c})",
        "min": "MIN({c})", "max": "MAX({c})",
        "minmaxrange": "MINMAXRANGE({c})",
        "sum_min_max": "SUM({c}), MIN({c}), MAX({c})",
        "count_avg_range": "COUNT({c}), AVG({c}), MINMAXRANGE({c})"}
INEXACT = ("SUM", "AVG")
# K4's filters: a range on the sorted column, EQ on a dict column, their
# AND / OR / NOT; "range_none" prunes every block, "range_all" keeps
# every block; 'e' lies only in March 1993's rows, 'zz' nowhere
FILTERS = {
    "range_month": "dt BETWEEN 19930301 AND 19930328",
    "range_none": "dt BETWEEN 19990101 AND 19991231",
    "range_all": "dt BETWEEN 19920101 AND 19981231",
    "eq_rare": "d = 'e'",
    "eq_absent": "d = 'zz'",
    "and": "dt BETWEEN 19930301 AND 19930331 AND d = 'b'",
    "or": "dt BETWEEN 19930301 AND 19930310 OR d = 'e'",
    "not": "dt BETWEEN 19930301 AND 19930331 AND NOT d = 'b'",
}
SETTINGS = ("consuming", "chunklets", "mesh", "cluster")
STAR_PAIRS = ["SUM__si", "COUNT__*", "MIN__si", "MAX__si"]
# the plan advisor keys its block-skip advice by the literal-free
# template, so "range_all" would turn "range_month" dense after it: off,
# each form follows its candidate bound
PORT_OPTIONS = "SET useAdvisor = false; "


def columns(seed: int = 2024) -> dict:
    """The table's rows from a numpy seed: the parts sorted by ``dt``,
    the tail over every date in arrival order."""
    n = PARTS * PART + TAIL
    rng = np.random.default_rng(seed)
    day = rng.integers(0, DAYS, n)
    day[:PARTS * PART].sort()
    day[0], day[PARTS * PART - 1] = 0, DAYS - 1
    dates = np.datetime64("1992-01-01") + day
    years = dates.astype("datetime64[Y]")
    months = dates.astype("datetime64[M]")
    ymd = ((years.astype(np.int64) + 1970) * 10000
           + (months.astype(np.int64) % 12 + 1) * 100
           + (dates - months).astype(np.int64) + 1).astype(np.int32)
    d = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    d[(ymd >= 19930305) & (ymd <= 19930312)] = "e"
    return {
        "d": d, "dt": ymd, "yr": (ymd // 10000).astype(np.int32),
        "u": rng.integers(0, 5000, n).astype(np.int32),
        "si": rng.integers(-1000, 1000, n).astype(np.int32),
        "q": rng.integers(1, 51, n).astype(np.int32),
        "wi": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32),
        "lg": EPOCH_1992_MS + day * hf.DAY + rng.integers(0, hf.DAY, n),
    }


def schema(side):
    sc, dt = hf.MODS[side][:2]
    D = dt.DataType
    return sc.Schema.build(
        name="f", dimensions=[("d", D.STRING), ("dt", D.INT), ("yr", D.INT),
                              ("u", D.INT)],
        metrics=[("si", D.INT), ("q", D.INT), ("wi", D.INT),
                 ("lg", D.LONG)])


def table_config(side, chunklets: bool = False, star: bool = False):
    """``f``'s config: with chunklets for a consuming segment, with a
    star-tree over (d, yr) for the sealed parts."""
    tc = hf.MODS[side][2]
    kw = {}
    if chunklets:
        kw["chunklets"] = tc.ChunkletConfig(
            enabled=True, rows_per_chunklet=CHUNKLET,
            device_min_rows=CHUNKLET)
    if star:
        kw["indexing"] = tc.IndexingConfig(star_tree_configs=[
            tc.StarTreeIndexConfig(dimensions_split_order=["d", "yr"],
                                   function_column_pairs=STAR_PAIRS)])
    return tc.TableConfig(table_name="f", **kw)


def part(cols: dict, j: int) -> dict:
    """Part ``j`` of the rows (``PARTS`` is the tail)."""
    return {c: v[j * PART:(j + 1) * PART] for c, v in cols.items()}


def rows_from(cols: dict, start: int) -> dict:
    return {c: v[start:] for c, v in cols.items()}


def records(cols: dict) -> list:
    n = len(cols["dt"])
    return [{c: v[j].item() for c, v in cols.items()} for j in range(n)]


def consuming(side, cols: dict, chunklets: bool = False):
    mut = hf.MODS[side][4]
    seg = mut.MutableSegment(schema(side), "f__0__0__0",
                             table_config(side, chunklets))
    seg.index_batch(records(cols))
    if chunklets:
        seg.chunklet_index.promote()
    return seg


def write_parts(base, star: bool = False) -> dict:
    """{side: the directories of the five parts, written by its creator;
    "cols": the rows}."""
    cols = columns()
    out = {}
    for side in hf.MODS:
        creator = hf.MODS[side][3]
        out[side] = []
        for j in range(PARTS + 1):
            d = str(base / f"{side}{j}")
            creator.build_segment(schema(side), part(cols, j), d,
                                  table_config(side, star=star), f"f{j}")
            out[side].append(d)
    return {"cols": cols, **out}


@pytest.fixture(scope="module")
def fused_dirs(tmp_path_factory):
    return write_parts(tmp_path_factory.mktemp("sweep_fused"))


def port_engine(gate, mesh=None) -> QueryEngine:
    ex = DeviceExecutor(device="cpu", mesh=mesh)
    ex.partials_cache_enabled = False
    if gate is not None:
        ex.min_rows = gate
    return QueryEngine(device_executor=ex)


def load(side, eng, layout: str, fdirs: dict):
    """``eng`` over one layout of the rows (see the module docstring;
    "two_batches" is the consuming layout with the consuming segment
    between the second and the third part)."""
    segment = hf.MODS[side][6]
    cols = fdirs["cols"]
    sealed = 1 if layout == "chunklets" else PARTS
    segs = [segment.ImmutableSegment(d) for d in fdirs[side][:sealed]]
    cons = consuming(side, rows_from(cols, sealed * PART),
                     chunklets=layout == "chunklets")
    at = 2 if layout == "two_batches" else len(segs)
    for s in segs[:at] + [cons] + segs[at:]:
        eng.add_segment("f", s)
    return eng


@contextlib.contextmanager
def cluster(side: str, tmp, n_servers: int = 2):
    """``n_servers`` servers of one package, on the CPU for the port and
    without the partials cache, and a broker over them: (controller,
    registry, servers, broker)."""
    pkg = "pinot_tpu" if side == "ref" else "pinot_tpu_torch"
    m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "broker.broker", "cluster.registry", "controller.controller",
        "server.server")}
    kw = {"device": "cpu"} if side == "port" else {}
    registry = m["cluster.registry"].ClusterRegistry()
    controller = m["controller.controller"].Controller(
        registry, str(tmp / "deepstore"))
    servers = [m["server.server"].ServerInstance(
        f"server_{i}", registry, str(tmp / f"srv{i}"), **kw)
        for i in range(n_servers)]
    for s in servers:
        s.engine.device.partials_cache_enabled = False
        s.start()
    broker = m["broker.broker"].Broker(registry, timeout_s=20.0, **kw)
    try:
        yield controller, registry, servers, broker
    finally:
        broker.close()
        for s in servers:
            s.stop(drain_timeout_s=0)


@contextlib.contextmanager
def f_cluster(side: str, tmp, dirs: list):
    """Two servers holding the five sealed parts (replication 1) and a
    broker over them: (broker, servers)."""
    with cluster(side, tmp) as (controller, registry, servers, broker):
        controller.add_table(table_config(side), schema(side))
        # the tail second: each server then holds a part of March 1993's
        # rows in a batch where it is one candidate of B = 1 (K4 on both)
        for d in [dirs[0], dirs[PARTS]] + dirs[1:PARTS]:
            controller.upload_segment("f", d)

        def hosted():
            return [len(t.segments) if t is not None else 0
                    for t in (s.engine.tables.get("f_OFFLINE")
                              for s in servers)]

        assert _wait(lambda: len(registry.external_view("f_OFFLINE"))
                     == PARTS + 1 and sum(hosted()) == PARTS + 1
                     and min(hosted()) > 0)
        _pin_replica_order(registry, servers)
        yield broker, servers


class ClusterGate:
    """The broker, with every server's kernel gate set per query."""

    def __init__(self, broker, servers, gate):
        self.broker, self.servers, self.gate = broker, servers, gate

    def execute(self, sql: str) -> dict:
        for s in self.servers:
            s.engine.device.min_rows = ps.PALLAS_MIN_ROWS \
                if self.gate is None else self.gate
        return self.broker.execute(sql)


@pytest.fixture(scope="module")
def setups(fused_dirs, tmp_path_factory):
    """(the oracle's answers by query, the oracle, {setting: [the port
    at each gate]})."""
    oracle = load("ref", RefEngine(), "consuming", fused_dirs)
    ports = {s: [load("port", port_engine(g), s, fused_dirs)
                 for g in hf.GATES] for s in ("consuming", "chunklets")}
    ports["mesh"] = [load("port", port_engine(g, make_mesh(4)), "consuming",
                          fused_dirs) for g in hf.GATES]
    ports["cohort"] = [load("port", port_engine(g), "consuming", fused_dirs)
                       for g in hf.GATES]
    with f_cluster("port", tmp_path_factory.mktemp("fused_cluster"),
                   fused_dirs["port"]) as (broker, servers):
        ports["cluster"] = [ClusterGate(broker, servers, g)
                            for g in hf.GATES]
        yield {}, oracle, ports


def select(col: str, aggs: str, filt: str) -> str:
    return (f"SELECT {AGGS[aggs].format(c=COLUMNS[col])} FROM f "
            f"WHERE {FILTERS[filt]}")


def want(setups, sql: str) -> dict:
    """The oracle's answer, once per query."""
    cache, oracle, _ports = setups
    if sql not in cache:
        cache[sql] = oracle.execute("SET useBlockSkip = false; " + sql)
        assert not cache[sql].get("exceptions"), cache[sql]
    return cache[sql]


def exact_flags(aggs: str) -> list:
    return [not a.strip().startswith(INEXACT)
            for a in AGGS[aggs].split(", ")]


def held(got: dict, expected: dict, aggs: str) -> None:
    hf.assert_host_answer(got, expected, exact_flags(aggs))


def no_warning(run):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always", RuntimeWarning)
        out = run()
    assert not [w for w in seen if issubclass(w.category, RuntimeWarning)], \
        [str(w.message) for w in seen]
    return out


def check(setups, setting: str, col: str, aggs: str, filt: str) -> None:
    sql = select(col, aggs, filt)
    expected = want(setups, sql)
    for port in setups[2][setting]:
        held(no_warning(lambda: port.execute(PORT_OPTIONS + sql)), expected,
             aggs)


def check_cohort(setups, col: str, aggs: str) -> None:
    """Every filter's query released at once through a forced window; each
    answer held to the oracle."""
    sqls = [select(col, aggs, f) for f in FILTERS]
    expected = [want(setups, s) for s in sqls]
    for eng in setups[2]["cohort"]:
        co = eng.device.coalescer
        co.force, co.window_s, co.max_cohort = True, 0.05, len(sqls)
        got = [None] * len(sqls)
        barrier = threading.Barrier(len(sqls))

        def worker(i):
            barrier.wait()
            got[i] = no_warning(lambda: eng.execute(PORT_OPTIONS + sqls[i]))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(sqls))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            co.force = False
        for g, w in zip(got, expected):
            held(g, w, aggs)


OWN_COLUMNS = ("signed", "date")


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("aggs", list(AGGS))
@pytest.mark.parametrize("col", OWN_COLUMNS)
@pytest.mark.parametrize("setting", SETTINGS)
def test_fused_surface(setups, setting, col, aggs, filt):
    check(setups, setting, col, aggs, filt)


@pytest.mark.parametrize("aggs", list(AGGS))
@pytest.mark.parametrize("col", OWN_COLUMNS)
def test_fused_surface_in_a_cohort(setups, col, aggs):
    check_cohort(setups, col, aggs)
