"""The partials that reach a merge, held to the reference's: for every
route the port has for a scalar or grouped aggregation, through every
merge that puts a second partial beside the first.

A spy on ``merge_intermediates`` in both packages' engine and broker
modules records every IntermediateResult that reaches it: its shape
kind, its group keys' dtypes, and for each aggregation the keys of its
partial with each array's dtype and shape (a grouped partial's leading
axis written as "G" once it equals the partial's group count, so that
partials of different group counts compare). The port's set of such
signatures, at the default kernel gate and at gate 0, must equal the
reference's ``QueryEngine()`` in the same setting. A partial of the
wrong shape (F12: a scalar K4 partial of (1, 1) where the reference's
is (1,)) passes alone, since a lone partial skips the merge; beside a
second one it fails the merge, or merges into a wrong answer.

The rows are tests/test_torch_sweep_fused.py's, its sealed parts
written with a star-tree over (d, yr). The routes:
- ``dense``: ``SET useBlockSkip = false``;
- ``gather``: the generic block-skip gather (K4 declines ``SUM(dt)``,
  whose per-block int32 partial could overflow);
- ``fused``: K4;
- ``host_shape``: the host path's shape (``$docId``, which the
  reference's device refuses);
- ``sorted``: the sorted regime (``dt`` by ``u``, past 2^22 keys);
- ``star_tree``: the star-tree's cube;
- ``metadata``: the metadata-only answer.
Each is asked scalar and grouped where it has both forms, and each
route's query is shown to take its route on the port (a spy on its
entry).

The merges: ``consuming`` (the sealed parts and a consuming segment),
``chunklets`` (promoted chunklets beside a sealed part and a tail),
``two_batches`` (the consuming segment between the second and the third
sealed part: where the reference's device refuses a query, its engine
scans every segment on its host and the port splits the sealed parts
into two batches, so only the host path's shape puts two sealed batches
side by side; the other routes run there as in ``consuming``),
``cluster`` (two servers, replication 1, through the broker and its
DataTables), ``mesh`` (a 4-device CPU mesh beside the consuming
segment) and ``cohort`` (two copies of the query released together
through a forced coalescing window). The reference has each of these
routes and merges, so every port signature is held to the reference's
own in the same setting. Rows are held too: integers exactly, floats
within ``rows_close``.
"""

import threading

import numpy as np
import pytest

import pinot_tpu.broker.broker as r_broker
import pinot_tpu.engine.engine as r_engine
import pinot_tpu_torch.broker.broker as t_broker
import pinot_tpu_torch.engine.engine as t_engine
import test_torch_host_float64 as hf
import test_torch_sweep_fused as sf
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pinot_tpu_torch.engine.device import DeviceExecutor
from pinot_tpu_torch.ops import blockskip as bs
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import radix_groupby
from pinot_tpu_torch.parallel.mesh import make_mesh
from test_torch_join import rows_close

MONTH = "dt BETWEEN 19930301 AND 19930328"
OPTIONS = "SET useAdvisor = false; "
ROUTES = {
    "dense": ("SET useBlockSkip = false; SELECT COUNT(*), SUM(si), "
              f"MIN(dt), MAX(yr), AVG(q) FROM f WHERE {MONTH}"),
    "dense_grouped": ("SET useBlockSkip = false; SELECT d, COUNT(*), "
                      f"SUM(si), MIN(dt) FROM f WHERE {MONTH} GROUP BY d "
                      "ORDER BY d"),
    "gather": ("SELECT SUM(dt), MIN(si), MAX(wi), AVG(yr) FROM f "
               f"WHERE {MONTH}"),
    "gather_grouped": (f"SELECT d, SUM(si), MAX(dt) FROM f WHERE {MONTH} "
                       "GROUP BY d ORDER BY d"),
    "fused": ("SELECT COUNT(*), SUM(si), MIN(dt), MAX(yr), AVG(si), "
              f"MINMAXRANGE(si) FROM f WHERE {MONTH}"),
    "host_shape": ("SELECT COUNT(*), SUM(si), MIN(dt), AVG(yr) FROM f "
                   "WHERE $docId < 1000"),
    "host_shape_grouped": ("SELECT d, SUM(si), MINMAXRANGE(dt) FROM f "
                           "WHERE $docId < 1000 GROUP BY d ORDER BY d"),
    "sorted": ("SELECT dt, u, COUNT(*), SUM(si), MIN(q) FROM f "
               "GROUP BY dt, u ORDER BY SUM(si) DESC, dt, u LIMIT 10"),
    "star_tree": "SELECT SUM(si), MIN(si), MAX(si), COUNT(*) FROM f "
                 "WHERE d = 'b'",
    "star_tree_grouped": "SELECT yr, SUM(si), COUNT(*) FROM f GROUP BY yr "
                         "ORDER BY yr",
    "metadata": "SELECT COUNT(*), MIN(dt), MAX(si) FROM f",
}
MERGES = ("consuming", "chunklets", "two_batches", "cluster", "mesh",
          "cohort")


def signature(r) -> tuple:
    """An IntermediateResult's shape kind, group key dtypes and partials
    (keys, dtypes, shapes)."""
    keys = getattr(r, "group_keys", None) or []
    g = len(keys[0]) if keys else None

    def arr(v):
        a = np.asarray(v)
        shape = a.shape
        if r.shape == "group_by" and shape and shape[0] == g:
            shape = ("G",) + shape[1:]
        return a.dtype.str, shape

    parts = tuple(tuple((k, arr(p[k])) for k in sorted(p))
                  for p in (r.agg_partials or []))
    return (r.shape, tuple(np.asarray(k).dtype.str for k in keys), parts)


class MergeSpy:
    """Every partial that reaches ``merge_intermediates`` in the given
    modules, as signatures."""

    def __init__(self, monkeypatch, modules):
        self.seen = set()
        self.calls = 0
        for mod in modules:
            real = mod.merge_intermediates

            def spy(q, results, _real=real):
                self.calls += 1
                self.seen |= {signature(r) for r in results
                              if r is not None}
                return _real(q, results)

            monkeypatch.setattr(mod, "merge_intermediates", spy)


@pytest.fixture(scope="module")
def star_dirs(tmp_path_factory):
    return sf.write_parts(tmp_path_factory.mktemp("partial_shapes"),
                          star=True)


def ref_engine(merge: str):
    if merge == "mesh":
        return RefEngine(device_executor=RefExecutor(mesh=ref_make_mesh(4)))
    return RefEngine()


def port_engine(merge: str, gate):
    return sf.port_engine(gate, make_mesh(4) if merge == "mesh" else None)


def layout(merge: str) -> str:
    return merge if merge in ("chunklets", "two_batches") else "consuming"


def cohort(eng, sql: str, copies: int = 2) -> list:
    """``copies`` of ``sql`` released together through a forced window."""
    co = eng.device.coalescer
    co.force, co.window_s, co.max_cohort = True, 0.05, copies
    got = [None] * copies
    barrier = threading.Barrier(copies)

    def worker(i):
        barrier.wait()
        got[i] = eng.execute(sql)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(copies)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        co.force = False
    return got


def answers(run, merge: str, sql: str) -> list:
    return cohort(run, sql) if merge == "cohort" else [run.execute(sql)]


def compile_first(run, merge: str, sql: str) -> None:
    """A route's first run through the reference's cluster compiles its
    pipeline on each server (JAX's lowering: ~6 s alone for the sorted
    regime, past the broker's 20 s budget on a loaded machine), and the
    compile goes on in the server's thread after the broker gives up,
    holding the GIL the next query's servers need. So the route runs once
    first under a budget that covers the compile; the compared run keeps
    the default budget."""
    if merge == "cluster":
        run.execute("SET timeoutMs = 600000; " + sql)


def same_rows(got: dict, want: dict, sql: str) -> None:
    assert not got.get("exceptions"), (sql, got.get("exceptions"))
    assert not want.get("exceptions"), (sql, want.get("exceptions"))
    g, w = got["resultTable"], want["resultTable"]
    assert g["dataSchema"] == w["dataSchema"], sql
    assert rows_close(g["rows"], w["rows"]), (sql, g["rows"], w["rows"])
    for rg, rw in zip(g["rows"], w["rows"]):
        assert [x for x in rg if not isinstance(x, float)] == \
            [y for y in rw if not isinstance(y, float)], (sql, rg, rw)


@pytest.fixture(scope="module")
def clusters(star_dirs, tmp_path_factory):
    """{side: (broker, servers)} over the star-tree parts."""
    with sf.f_cluster("ref", tmp_path_factory.mktemp("ps_ref"),
                      star_dirs["ref"]) as ref, \
            sf.f_cluster("port", tmp_path_factory.mktemp("ps_port"),
                         star_dirs["port"]) as port:
        yield {"ref": ref, "port": port}


def runners(merge: str, star_dirs, clusters) -> tuple:
    """(the reference's runner, [the port's at each gate])."""
    if merge == "cluster":
        rb, _rs = clusters["ref"]
        pb, pss = clusters["port"]
        return rb, [sf.ClusterGate(pb, pss, g) for g in hf.GATES]
    return (sf.load("ref", ref_engine(merge), layout(merge), star_dirs),
            [sf.load("port", port_engine(merge, g), layout(merge), star_dirs)
             for g in hf.GATES])


@pytest.fixture(scope="module", params=MERGES)
def merge_setup(request, star_dirs, clusters):
    return request.param, runners(request.param, star_dirs, clusters)


@pytest.mark.parametrize("route", list(ROUTES))
def test_partials_reaching_a_merge_match_the_reference(merge_setup, route,
                                                       monkeypatch):
    merge, (ref, ports) = merge_setup
    sql = OPTIONS + ROUTES[route]
    compile_first(ref, merge, sql)
    want_spy = MergeSpy(monkeypatch, (r_engine, r_broker))
    wants = answers(ref, merge, sql)
    for port in ports:
        monkeypatch.undo()
        got_spy = MergeSpy(monkeypatch, (t_engine, t_broker))
        gots = answers(port, merge, sql)
        for got, want in zip(gots, wants):
            same_rows(got, want, sql)
        assert got_spy.seen == want_spy.seen, (merge, route)
        assert got_spy.calls > 0


# every route's query takes its route on the port, in the consuming
# layout: the entry that shows it (host_shape answers a verdict,
# try_metadata_only None where the metadata cannot answer)
ENTRIES = {
    "gather": (bs, "gather_blocks"),
    "fused": (ps, "fused_filter_agg"),
    "host_shape": (DeviceExecutor, "host_shape"),
    "sorted": (radix_groupby, "chunked_group_aggregate"),
    "star_tree": (t_engine, "execute_star_tree_group"),
    "metadata": (t_engine, "try_metadata_only"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_each_route_is_taken(star_dirs, route, monkeypatch):
    taken = []
    for name, (mod, attr) in ENTRIES.items():
        real = getattr(mod, attr)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            if out is not None and out is not False:
                taken.append(_name)
            return out

        monkeypatch.setattr(mod, attr, spy)
    eng = sf.load("port", port_engine("consuming", 0), "consuming",
                  star_dirs)
    r = eng.execute(OPTIONS + ROUTES[route])
    assert not r.get("exceptions"), r["exceptions"]
    want = route.replace("_grouped", "")
    assert set(taken) == (set() if want == "dense" else {want}), taken
