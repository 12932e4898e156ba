"""The port's query schedulers (pinot_tpu_torch/engine/scheduler.py)
against the JAX package's, on the CPU.

tests/test_scheduler_priority.py's first six cases run against the port's
``TokenBucketScheduler`` / ``QueryScheduler`` / ``make_scheduler`` as they
run against the reference's (the seventh needs the server, which comes
with the cluster tier). Then both packages' schedulers take one scripted,
single-threaded sequence and must give the same accounting, and two
tenants on threads run SQL through the port's engine under the port's
scheduler, every answer equal to the reference engine's.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.engine import scheduler as ref_sched
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import scheduler as port_sched
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.scheduler import (
    QueryScheduler,
    SchedulerSaturated,
    TokenBucketScheduler,
    make_scheduler,
)
from pinot_tpu_torch.storage.segment import ImmutableSegment


def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def _light_latencies(sched, n=30, work_s=0.004):
    """Light-tenant queries at a steady trickle, one at a time (closed
    loop): their end-to-end latencies."""
    lats = []
    for _ in range(n):
        t0 = time.perf_counter()
        sched.run(lambda: time.sleep(work_s), group="light")
        lats.append(time.perf_counter() - t0)
        time.sleep(0.002)
    return lats


def _swallow(fn):
    try:
        fn()
    except SchedulerSaturated:
        pass


# ---------------------------------------------------------------------------
# tests/test_scheduler_priority.py's cases, against the port
# ---------------------------------------------------------------------------


def test_heavy_tenant_cannot_starve_light():
    """A heavy tenant at saturation must not push the light tenant's p99
    past 2x its solo p99 (+ 5 ms of scheduling jitter)."""
    def solo_sched():
        return TokenBucketScheduler(max_concurrent=2, max_queued=64,
                                    rate_ms_per_s=50.0, burst_ms=100.0)

    solo_p99 = _percentile(_light_latencies(solo_sched()), 99)
    sched = solo_sched()
    stop = threading.Event()

    def heavy_loop():
        while not stop.is_set():
            try:
                sched.run(lambda: time.sleep(0.05), group="heavy",
                          queue_timeout_s=0.5)
            except SchedulerSaturated:
                pass

    threads = [threading.Thread(target=heavy_loop, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.15)  # let the heavy tenant overdraw its bucket
    try:
        contended = _light_latencies(sched)
    finally:
        stop.set()
        for t in threads:
            t.join(2)
    contended_p99 = _percentile(contended, 99)
    assert contended_p99 <= 2 * solo_p99 + 0.005, (
        f"light p99 {contended_p99 * 1e3:.1f}ms vs solo "
        f"{solo_p99 * 1e3:.1f}ms")
    gs = sched.group_stats()
    assert gs["heavy"]["executed"] > 0
    assert gs["heavy"]["tokens_ms"] < gs["light"]["tokens_ms"]


def test_fifo_within_group():
    sched = TokenBucketScheduler(max_concurrent=1, max_queued=16)
    order = []
    hold = threading.Event()
    t0 = threading.Thread(
        target=lambda: sched.run(lambda: hold.wait(2), group="g"))
    t0.start()
    time.sleep(0.05)
    threads = []
    for i in range(4):
        th = threading.Thread(
            target=lambda i=i: sched.run(lambda: order.append(i), group="g"))
        th.start()
        time.sleep(0.02)  # deterministic arrival order
        threads.append(th)
    hold.set()
    for th in threads:
        th.join(3)
    t0.join(3)
    assert order == [0, 1, 2, 3]


def test_stats_out_accounting():
    def busy():
        t = time.thread_time()
        while time.thread_time() - t < 0.01:
            pass
        return 42

    for sched in (QueryScheduler(), TokenBucketScheduler()):
        acct = {}
        assert sched.run(busy, stats_out=acct, group="t1") == 42
        assert acct["scheduler_wait_ms"] >= 0
    # the token bucket also reports the CPU time after fn
    assert acct["thread_cpu_time_ns"] >= 5_000_000


def test_group_stats_snapshot():
    sched = TokenBucketScheduler(rate_ms_per_s=100, burst_ms=200)
    sched.run(lambda: time.sleep(0.01), group="tableA")
    sched.run(lambda: None, group="tableB")
    gs = sched.group_stats()
    assert gs["tableA"]["executed"] == 1
    assert gs["tableB"]["executed"] == 1
    assert gs["tableA"]["wall_ms_total"] >= 10
    assert gs["tableA"]["tokens_ms"] < gs["tableB"]["tokens_ms"]


def test_queue_cap_rejects():
    sched = TokenBucketScheduler(max_concurrent=1, max_queued=1,
                                 queue_timeout_s=0.05)
    hold = threading.Event()
    t = threading.Thread(
        target=lambda: sched.run(lambda: hold.wait(2), group="g"))
    t.start()
    time.sleep(0.05)
    waiter = threading.Thread(target=lambda: _swallow(
        lambda: sched.run(lambda: None, group="g", queue_timeout_s=2)))
    waiter.start()
    time.sleep(0.05)
    with pytest.raises(SchedulerSaturated):
        sched.run(lambda: None, group="g")  # the queue is already full
    hold.set()
    t.join(2)
    waiter.join(3)
    assert sched.num_rejected >= 1


def test_make_scheduler_selection():
    assert isinstance(make_scheduler("fcfs", 4, 8), QueryScheduler)
    assert isinstance(make_scheduler("tokenbucket", 4, 8),
                      TokenBucketScheduler)
    with pytest.raises(ValueError):
        make_scheduler("nope", 4, 8)


# ---------------------------------------------------------------------------
# the same sequence through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fcfs", "tokenbucket"])
def test_sequence_matches_reference(kind):
    """One sequence (results, a slot wait that times out behind a held
    slot, executed and rejected counts, the groups) through both
    packages' schedulers gives the same observations."""
    def observe(mod):
        sched = mod.make_scheduler(kind, 1, 1)
        out = [sched.run(lambda i=i: i * i, group=f"g{i % 2}")
               for i in range(5)]
        hold, started = threading.Event(), threading.Event()

        def blocker():
            sched.run(lambda: (started.set(), hold.wait(2)), group="g0")

        t = threading.Thread(target=blocker)
        t.start()
        started.wait(2)
        try:
            sched.run(lambda: None, group="g1", queue_timeout_s=0.05)
            out.append("ran")
        except mod.SchedulerSaturated:
            out.append("saturated")
        hold.set()
        t.join(3)
        out.append((sched.num_executed, sched.num_rejected))
        if hasattr(sched, "group_stats"):
            gs = sched.group_stats()
            out.append(sorted((g, s["executed"]) for g, s in gs.items()))
        return out

    assert observe(port_sched) == observe(ref_sched)


# ---------------------------------------------------------------------------
# two tenants over the port's engine
# ---------------------------------------------------------------------------

TENANT_SQL = {
    "dashboard": [
        "SELECT COUNT(*), SUM(m) FROM t WHERE k = 'k03'",
        "SELECT k, SUM(m) FROM t GROUP BY k ORDER BY k LIMIT 5",
    ],
    "adhoc": [
        "SELECT MIN(m), MAX(m) FROM t WHERE ts BETWEEN 1000 AND 20000",
        "SELECT k, COUNT(*) FROM t WHERE m > 500 GROUP BY k "
        "ORDER BY COUNT(*) DESC, k LIMIT 3",
    ],
}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(7)
    schema = Schema.build(
        name="t", dimensions=[("ts", DataType.LONG), ("k", DataType.STRING)],
        metrics=[("m", DataType.INT)])
    base = tmp_path_factory.mktemp("sched")
    ref, port = RefEngine(), QueryEngine(device="cpu")
    port.device.min_rows = 0
    for i in range(2):
        n = 20_000
        cols = {"ts": np.int64(i * n) + np.arange(n, dtype=np.int64),
                "k": np.array([f"k{j:02d}" for j in range(12)])[
                    rng.integers(0, 12, n)],
                "m": rng.integers(0, 1000, n).astype(np.int32)}
        build_segment(schema, cols, str(base / f"s{i}"), None, f"s{i}")
        ref.add_segment("t", RefSegment(str(base / f"s{i}")))
        port.add_segment("t", ImmutableSegment(str(base / f"s{i}")))
    return ref, port


def test_two_tenants_over_the_engine(engines):
    ref, port = engines
    want = {sql: ref.execute("SET useAdvisor=false; " + sql)["resultTable"]
            for sqls in TENANT_SQL.values() for sql in sqls}
    sched = TokenBucketScheduler(max_concurrent=2, max_queued=64,
                                 rate_ms_per_s=200.0, burst_ms=400.0)
    got, errors = [], []
    barrier = threading.Barrier(len(TENANT_SQL) * 2)

    def tenant(name, sqls):
        try:
            barrier.wait(10)
            for _ in range(3):
                for sql in sqls:
                    r = sched.run(lambda sql=sql: port.execute(sql),
                                  group=name)
                    got.append((sql, r))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=tenant, args=(name, sqls))
               for name, sqls in TENANT_SQL.items() for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert len(got) == 2 * 3 * sum(len(v) for v in TENANT_SQL.values())
    for sql, r in got:
        assert r["exceptions"] == [], (sql, r)
        assert r["resultTable"] == want[sql], sql
    gs = sched.group_stats()
    assert {g: s["executed"] for g, s in gs.items()} == {
        name: 2 * 3 * len(sqls) for name, sqls in TENANT_SQL.items()}
