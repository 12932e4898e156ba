"""The port's asynchronous serving surface against the JAX package.

After tests/test_concurrency.py and tests/test_observability.py: the
same two tables (a dense group-by table and one past MAX_DENSE_GROUPS,
the sorted regime) in the reference's engine and the port's
``QueryEngine(device="cpu")``. Concurrent submission equals serial and
the reference's answers; the batch LRU pins a batch while a launch reads
it and releases the pin on every path (fetch, failure, an expired
deadline); the fetch-time run in the host path's shape goes through the
caller's ``fallback_gate``; a traced ``execute_segments_async`` fetched
on another thread records the reference's phases, and cohort members
each their own ``device_fetch``.
"""

import sys
import threading

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common.deadline import Deadline, QueryTimeout
from pinot_tpu_torch.common.trace import Tracer
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.query.rewrite import expand_star
from pinot_tpu_torch.sql.compiler import compile_select
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment

STRIP = ("timeUsedMs", "partialsCacheHit", "deviceBytesMoved",
         "deviceKernelMs", "deviceLinkMs", "roofline", "advisorDecisions")


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def canonical(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in STRIP}


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
    return a == b


def _same_rows(got: dict, want: dict) -> None:
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert len(rows) == len(ref_rows)
    for a, b in zip(rows, ref_rows):
        assert all(_close(x, y) for x, y in zip(a, b)), (a, b)
    assert got["numDocsScanned"] == want["numDocsScanned"]


def run_threads(n, target):
    errors = []

    def wrapped(i):
        try:
            target(i)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            errors.append(e)

    threads = [threading.Thread(target=wrapped, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not [t for t in threads if t.is_alive()], "a worker hung"
    if errors:
        raise errors[0]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """'t' (dense group-by shapes) and 'hc' (2100 x 2100 keys, past
    MAX_DENSE_GROUPS: the sorted regime), three segments each."""
    rng = np.random.default_rng(23)
    base = tmp_path_factory.mktemp("torch_async")
    n, m = 4000, 4500
    cols_t = {
        "dim1": np.array([f"d{i:02d}" for i in range(40)])[
            rng.integers(0, 40, n)],
        "dim2": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "ivalue": rng.integers(0, 10_000, n).astype(np.int32),
        "fvalue": rng.uniform(0, 100, n).astype(np.float64),
    }
    schema_t = Schema.build(
        name="t", dimensions=[("dim1", DataType.STRING),
                              ("dim2", DataType.STRING)],
        metrics=[("ivalue", DataType.INT), ("fvalue", DataType.DOUBLE)])
    hc1 = rng.integers(0, 2100, m).astype(np.int32)
    hc2 = rng.integers(0, 2100, m).astype(np.int32)
    hc1[:2100] = np.arange(2100, dtype=np.int32)
    hc2[:2100] = np.arange(2100, dtype=np.int32)
    cols_hc = {"hc1": hc1, "hc2": hc2,
               "v": rng.integers(-100, 100, m).astype(np.int64)}
    schema_hc = Schema.build(
        name="hc", dimensions=[("hc1", DataType.INT), ("hc2", DataType.INT)],
        metrics=[("v", DataType.LONG)])
    out = {"t": [], "hc": []}
    for i in range(3):
        sl = slice(i * (n // 3), (i + 1) * (n // 3) if i < 2 else n)
        build_segment(schema_t, {k: v[sl] for k, v in cols_t.items()},
                      str(base / f"t{i}"), segment_name=f"t{i}")
        out["t"].append(str(base / f"t{i}"))
        sl = slice(i * (m // 3), (i + 1) * (m // 3) if i < 2 else m)
        build_segment(schema_hc, {k: v[sl] for k, v in cols_hc.items()},
                      str(base / f"hc{i}"), segment_name=f"hc{i}")
        out["hc"].append(str(base / f"hc{i}"))
    return out


def make_port(dirs, **kw) -> QueryEngine:
    eng = QueryEngine(device="cpu", **kw)
    eng.device.min_rows = 0
    for table, ds in dirs.items():
        for d in ds:
            eng.add_segment(table, ImmutableSegment(d))
    return eng


@pytest.fixture(scope="module")
def ref(dirs):
    eng = RefEngine()
    for table, ds in dirs.items():
        for d in ds:
            eng.add_segment(table, RefSegment(d))
    return eng


def compile_q(eng, sql):
    q = optimize_query(compile_select(parse_sql(sql)))
    return expand_star(q, table_segs(eng, q.table_name)[0].column_names())


MIXED_QUERIES = [
    "SELECT COUNT(*), SUM(ivalue), MIN(ivalue), MAX(ivalue) FROM t",
    "SELECT dim1, COUNT(*), SUM(ivalue), AVG(fvalue) FROM t "
    "GROUP BY dim1 ORDER BY dim1 LIMIT 50",
    "SELECT COUNT(*) FROM t WHERE ivalue > 2000 AND dim2 = 'a'",
    "SELECT COUNT(*) FROM t WHERE ivalue > 7000 AND dim2 = 'c'",
    "SELECT dim2, DISTINCTCOUNT(dim1) FROM t GROUP BY dim2 ORDER BY dim2",
    "SELECT DISTINCTCOUNTHLL(dim1) FROM t",
    "SELECT PERCENTILE(ivalue, 90) FROM t",
    "SELECT hc1, hc2, COUNT(*), SUM(v) FROM hc GROUP BY hc1, hc2 "
    "ORDER BY COUNT(*) DESC, hc1, hc2 LIMIT 20",
]


def test_mixed_queries_on_six_threads_equal_serial(dirs, ref):
    eng = make_port(dirs)
    serial = {sql: canonical(eng.execute(sql)) for sql in MIXED_QUERIES}
    for sql, r in serial.items():
        _same_rows(r, ref.execute(sql))

    def worker(i):
        order = MIXED_QUERIES[i:] + MIXED_QUERIES[:i]
        for _ in range(2):
            for sql in order:
                assert canonical(eng.execute(sql)) == serial[sql], sql

    # switch threads often, so a lost update of a counter or a pin shows
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        run_threads(6, worker)
    finally:
        sys.setswitchinterval(interval)
    assert eng.device.inflight == 0 and not eng.device._inflight_launches


def test_parity_under_one_cached_batch(dirs):
    """MAX_CACHED_BATCHES = 1: the two tables evict each other while
    launches in flight pin theirs; answers stay serial's and every pin
    drains."""
    eng = make_port(dirs)
    eng.device.MAX_CACHED_BATCHES = 1
    serial = {sql: canonical(eng.execute(sql)) for sql in MIXED_QUERIES}

    def worker(i):
        for sql in MIXED_QUERIES[i % 3:] + MIXED_QUERIES[:i % 3]:
            assert canonical(eng.execute(sql)) == serial[sql], sql

    run_threads(6, worker)
    dev = eng.device
    assert dev.inflight == 0 and not dev._inflight_launches
    assert len(dev._batches) <= 1 and dev.batch_evictions > 0


def test_inflight_launch_pins_its_batch(dirs):
    eng = make_port(dirs)
    dev = eng.device
    dev.MAX_CACHED_BATCHES = 1
    q = compile_q(eng, MIXED_QUERIES[1])
    segs = table_segs(eng, "t")
    handle = dev.launch(q, segs)
    key = dev._batch_key(segs)
    assert dev.inflight == 1 and dev._inflight_launches == {key: 1}
    # another batch cannot evict the pinned one
    other = dev.fetch(dev.launch(compile_q(eng, MIXED_QUERIES[7]),
                                 table_segs(eng, "hc")))
    assert other.stats.num_docs_scanned > 0
    assert key in dev._batches
    result = handle.fetch()
    assert result.stats.num_docs_scanned == 4000
    assert dev.inflight == 0 and not dev._inflight_launches
    with pytest.raises(RuntimeError):
        handle.fetch()  # one-shot
    handle.release()  # idempotent after the fetch
    assert dev.inflight == 0


def test_failure_between_launch_and_fetch_releases_the_pin(dirs,
                                                            monkeypatch):
    eng = make_port(dirs)
    dev = eng.device
    q = compile_q(eng, MIXED_QUERIES[1])
    handle = dev.launch(q, table_segs(eng, "t"))
    assert dev.inflight == 1
    handle.release()  # the caller failed before its fetch
    assert dev.inflight == 0 and not dev._inflight_launches

    class Boom(Exception):
        pass

    def boom(*a, **k):
        raise Boom()

    monkeypatch.setattr(dev, "_finish", boom)
    with pytest.raises(Boom):
        eng.execute_query(q)
    assert dev.inflight == 0 and not dev._inflight_launches
    monkeypatch.undo()
    r = eng.execute(MIXED_QUERIES[1])
    assert r["exceptions"] == []


def test_fetch_time_rerun_goes_through_the_gate(dirs):
    """A trimmed table holding more groups than numGroupsLimit keeps: the
    fetch asks for the host path's shape, which the engine runs through
    the caller's gate; numGroupsLimitReached is the reference's."""
    eng = make_port(dirs, num_groups_limit=5)
    ref = RefEngine(num_groups_limit=5)
    for d in dirs["t"]:
        ref.add_segment("t", RefSegment(d))
    sql = ("SELECT dim1, COUNT(*), SUM(ivalue) FROM t GROUP BY dim1 "
           "ORDER BY COUNT(*) DESC, dim1 LIMIT 3")
    q = compile_q(eng, sql)
    gated = []

    def gate(fn):
        gated.append(1)
        return fn()

    reruns = eng.device.host_shape_reruns
    merged = eng.execute_segments_async(q, table_segs(eng, "t"), terminal=True,
                                        fallback_gate=gate)()
    assert gated == [1]
    assert eng.device.host_shape_reruns == reruns + 1
    want = ref.execute(sql)
    assert merged.stats.num_groups_limit_reached \
        == want["numGroupsLimitReached"] is True
    _same_rows(eng.execute(sql), want)
    assert eng.device.inflight == 0


def test_expired_deadline_raises_before_the_fetch(dirs, monkeypatch):
    eng = make_port(dirs)
    dev = eng.device
    waits = []
    real = device_mod._Transfer.wait_link
    monkeypatch.setattr(device_mod._Transfer, "wait_link",
                        lambda self: waits.append(1) or real(self))
    q = compile_q(eng, MIXED_QUERIES[1])
    fetch = eng.execute_segments_async(q, table_segs(eng, "t"), terminal=True,
                                       deadline=Deadline(0.0))
    assert dev.inflight == 1
    with pytest.raises(QueryTimeout):
        fetch()
    assert waits == []
    assert dev.inflight == 0 and not dev._inflight_launches
    merged = eng.execute_segments_async(q, table_segs(eng, "t"), terminal=True,
                                        deadline=Deadline(60.0))()
    assert merged.stats.num_docs_scanned == 4000 and waits == [1]


PHASES = ("gather", "dispatch", "device_fetch", "merge")


def test_traced_async_query_fetched_on_another_thread(dirs):
    """After tests/test_observability.py: the launch phase's spans
    (gather, dispatch) and the fetch phase's (device_fetch with its
    kernel / link split, merge) land on the query's explicit tracer."""
    eng = make_port(dirs)
    eng.device.partials_cache_enabled = False
    q = compile_q(eng, "SELECT dim2, SUM(ivalue) FROM t GROUP BY dim2")
    tracer = Tracer("test-trace-1")
    fetch = eng.execute_segments_async(q, table_segs(eng, "t"), tracer=tracer)
    box = []
    th = threading.Thread(target=lambda: box.append(fetch()))
    th.start()
    th.join(60)
    assert box, "the fetch thread died"
    phases = {s["phase"] for s in tracer.to_json()}
    for p in PHASES:
        assert p in phases, phases
    assert any(p.endswith("kernel") for p in phases), phases
    assert any(p.endswith("link") for p in phases), phases


def test_cohort_members_each_get_fetch_spans(dirs):
    eng = make_port(dirs)
    dev = eng.device
    dev.partials_cache_enabled = False
    co = dev.coalescer
    sqls = [f"SELECT dim2, SUM(ivalue) FROM t WHERE ivalue > {lit} "
            f"GROUP BY dim2" for lit in (10, 500, 3000, 8000)]
    qs = [compile_q(eng, s) for s in sqls]
    tracers = [Tracer(f"m{i}") for i in range(len(qs))]
    barrier = threading.Barrier(len(qs))
    c0 = co.queries_coalesced

    def worker(i):
        barrier.wait()
        eng.execute_segments_async(qs[i], table_segs(eng, "t"),
                                   tracer=tracers[i])()

    co.force, co.window_s = True, 0.05
    try:
        run_threads(len(qs), worker)
    finally:
        co.force, co.window_s = False, 0.003
    assert co.queries_coalesced > c0
    for tr in tracers:
        phases = {s["phase"] for s in tr.to_json()}
        assert "device_fetch" in phases and "merge" in phases, phases
    # the shared kernel / link wait lands on one trace: the leader's
    assert sum(any(s["phase"].endswith("kernel") for s in tr.to_json())
               for tr in tracers) >= 1
    assert dev.inflight == 0


def test_cold_tier_segment_is_refused_in_band(dirs):
    """A cold-tier placeholder (``is_cold``: planes only in a deep store)
    answers nothing, as in the reference: the launch drops it, the
    partial counts it in numSegmentsCold and its docs in totalDocs (a
    broker marks such a response partial), and nothing is pinned. (The tiers came with
    ROADMAP item m3; before, the port refused the placeholder in-band.)"""
    eng = make_port(dirs)
    segs = table_segs(eng, "t")
    cold = ImmutableSegment(dirs["t"][0])
    cold.is_cold = True
    q = compile_q(eng, MIXED_QUERIES[1])
    merged = eng.execute_segments_async(q, segs[1:] + [cold])()
    assert merged.stats.num_segments_cold == 1
    assert merged.stats.num_segments_queried == len(segs)
    assert eng.device.inflight == 0
    eng.tables["t"].remove_segment(segs[0].name)
    eng.tables["t"].add_segment(cold)  # the table: segs[1:] + [cold]
    r = eng.execute(MIXED_QUERIES[1])
    ref_eng = RefEngine()
    for d in dirs["t"][1:]:
        ref_eng.add_segment("t", RefSegment(d))
    ref_cold = RefSegment(dirs["t"][0])
    ref_cold.is_cold = True
    ref_eng.add_segment("t", ref_cold)
    want = ref_eng.execute(MIXED_QUERIES[1])
    _same_rows(r, want)
    for key in ("numSegmentsCold", "numSegmentsQueried", "totalDocs",
                "numSegmentsProcessed"):
        assert r[key] == want[key], (key, r[key], want[key])
    assert r["numSegmentsCold"] == 1
