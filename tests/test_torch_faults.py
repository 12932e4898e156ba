"""The port's fault seams and device-error recovery against the JAX
package's, on the CPU.

The fault registry (pinot_tpu_torch/common/faults.py) runs
tests/test_faults.py's ``TestFaultRegistry`` cases. The recovery ladder
(engine/device.py) runs the reference's device-error scenarios with the
same faults armed in both packages' registries: a launch failure retried
once, the two-strike quarantine and its half-open probe under a patched
clock, a fetch failure, a cohort's one shared failure, a sticky CUDA error
and an out-of-memory. The reference answers a quarantined pair and a
failed fetch on its host; the port refuses them in-band, with the same
failure, eviction and quarantine counts. A chunklet-promotion fault leaves
ingestion going and the answers equal to the reference's.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from pinot_tpu.common import faults as ref_faults
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import TableConfig
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common import faults
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.storage.segment import ImmutableSegment


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def arm(**kw):
    """The same fault in both packages' registries: (port's, reference's)."""
    return (faults.install(faults.Fault(**kw)),
            ref_faults.install(ref_faults.Fault(**kw)))


# ---------------------------------------------------------------------------
# the registry: tests/test_faults.py TestFaultRegistry
# ---------------------------------------------------------------------------


class TestFaultRegistry:
    def test_inactive_by_default_and_zero_when_cleared(self):
        assert faults.ACTIVE is False
        f = faults.install(faults.Fault(point="p", mode="error"))
        assert faults.ACTIVE is True
        faults.clear()
        assert faults.ACTIVE is False
        faults.inject("p")  # cleared: a no-op even for the old point
        assert f.fired == 0

    def test_error_delay_and_times(self):
        f = faults.install(faults.Fault(point="p", mode="error", times=2))
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.inject("p")
        faults.inject("p")  # disarmed after 2 firings
        assert f.fired == 2
        faults.clear()
        faults.install(faults.Fault(point="d", mode="delay", delay_ms=30))
        t0 = time.perf_counter()
        faults.inject("d")
        assert time.perf_counter() - t0 >= 0.025

    def test_target_substring_match(self):
        faults.install(faults.Fault(point="p", target="server_1",
                                    mode="error"))
        faults.inject("p", target="server_2")  # no match
        with pytest.raises(faults.FaultInjected):
            faults.inject("p", target="server_1")

    def test_blackhole_bounded_by_caller_deadline(self):
        faults.install(faults.Fault(point="p", mode="blackhole",
                                    delay_ms=60_000))
        t0 = time.perf_counter()
        with pytest.raises(faults.FaultInjected):
            faults.inject("p", bound_ms=50)
        assert time.perf_counter() - t0 < 1.0

    def test_parse_spec(self):
        spec = ("transport.submit@server_1=blackhole:500;"
                "device.launch=error#2; chunklet.promote=delay:10")
        fs = faults.parse_spec(spec)
        assert [f.point for f in fs] == [
            "transport.submit", "device.launch", "chunklet.promote"]
        assert fs[0].target == "server_1" and fs[0].delay_ms == 500
        assert fs[1].times == 2 and fs[1].target is None
        assert fs[2].mode == "delay"
        # field for field the reference's parse
        assert [vars(f) for f in fs] == \
            [vars(f) for f in ref_faults.parse_spec(spec)]

    def test_device_points_raise_device_error(self):
        faults.install(faults.Fault(point="device.launch", mode="error"))
        with pytest.raises(faults.InjectedDeviceError):
            faults.inject("device.launch")
        assert device_mod._is_device_runtime_error(
            faults.InjectedDeviceError("x"))


def test_error_classification():
    """Injected faults and CUDA out-of-memory are retried; any other CUDA
    runtime error is sticky (counted, not retried); the rest is not a
    device error at all."""
    injected = faults.InjectedDeviceError("x")
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    sticky = torch.AcceleratorError("an illegal memory access")
    for e, device, retry in ((injected, True, True), (oom, True, True),
                             (sticky, True, False),
                             (ValueError("x"), False, False),
                             (faults.FaultInjected("x"), False, False)):
        assert device_mod._is_device_runtime_error(e) is device, e
        assert device_mod._is_retryable(e) is retry, e


# ---------------------------------------------------------------------------
# device-error recovery
# ---------------------------------------------------------------------------

ROWS = 4000
POISONED = "SELECT SUM(m) FROM t"
HEALTHY = "SELECT SUM(v) FROM t WHERE tag <> 'zz'"
GROUPED = "SELECT tag, COUNT(*), SUM(v) FROM t GROUP BY tag ORDER BY tag"
MINMAX = "SELECT tag, MIN(m), MAX(v) FROM t GROUP BY tag ORDER BY tag"


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """tests/test_faults.py's device table."""
    rng = np.random.default_rng(7)
    schema = Schema.build(
        name="t", dimensions=[("tag", DataType.STRING)],
        metrics=[("m", DataType.INT), ("v", DataType.INT)])
    cfg = TableConfig(table_name="t")
    base = tmp_path_factory.mktemp("faultseg")
    dirs = []
    for i in range(2):
        cols = {"tag": np.array(["a", "b", "c"])[rng.integers(0, 3, ROWS)],
                "m": rng.integers(0, 1000, ROWS).astype(np.int32),
                "v": rng.integers(0, 1000, ROWS).astype(np.int32)}
        build_segment(schema, cols, str(base / f"s{i}"), cfg, f"s{i}")
        dirs.append(str(base / f"s{i}"))
    return dirs


@pytest.fixture
def engines(table):
    """Fresh engines (the breaker's state is per executor): the
    reference's and the port's on the CPU at the kernel gate 0, partials
    cache off so each query launches."""
    ref, port = RefEngine(), QueryEngine(device="cpu")
    port.device.min_rows = 0
    port.device.partials_cache_enabled = False
    ref.device.partials_cache_enabled = False
    for d in table:
        ref.add_segment("t", RefSegment(d))
        port.add_segment("t", ImmutableSegment(d))
    return ref, port


def counts(eng):
    st = eng.device.hbm_stats()
    return (eng.device.launch_failures, st["quarantined_pipelines"],
            st["device_failures"])


def rows(resp):
    assert resp["exceptions"] == [], resp
    return resp["resultTable"]["rows"]


def test_launch_failure_retries_once_then_succeeds(engines):
    ref, port = engines
    want = rows(ref.execute(POISONED))
    ev0 = port.device.batch_evictions
    arm(point="device.launch", mode="error", times=1)
    assert rows(port.execute(POISONED)) == want
    assert rows(ref.execute(POISONED)) == want
    assert counts(port) == counts(ref) == (1, 0, 1)
    # the failed attempt's batch was evicted and the retry rebuilt it
    assert port.device.batch_evictions == ev0 + 1


@pytest.mark.parametrize("sql", [GROUPED, MINMAX])
def test_launch_failure_retry_answers_group_bys(engines, sql):
    ref, port = engines
    want = rows(ref.execute(sql))
    arm(point="device.launch", mode="error", times=1)
    assert rows(port.execute(sql)) == want
    assert counts(port) == (1, 0, 1)


def test_two_failures_quarantine_and_refuse_in_band(engines):
    ref, port = engines
    want_p, want_h = rows(ref.execute(POISONED)), rows(ref.execute(HEALTHY))
    fp, fr = arm(point="device.launch", target="sum(m)", mode="error")
    got = port.execute(POISONED)
    # the reference answers on its host; the port refuses in-band
    assert rows(ref.execute(POISONED)) == want_p
    assert len(got["exceptions"]) == 1
    assert "DeviceUnsupported" in got["exceptions"][0]["message"]
    assert "quarantined" in got["exceptions"][0]["message"]
    assert counts(port) == counts(ref) == (2, 1, 2)
    assert fp.fired == fr.fired == 2
    # quarantined: refused before the seam, no further device attempt
    again = port.execute(POISONED)
    assert "quarantined" in again["exceptions"][0]["message"]
    assert fp.fired == 2
    # another template over the same batch keeps running on the device
    leaves = port.device.fetch_leaves_total
    assert rows(port.execute(HEALTHY)) == want_h
    assert port.device.fetch_leaves_total > leaves
    assert counts(port)[1] == 1
    # the operational reset forgets the history
    faults.clear()
    port.device.reset_quarantine()
    assert counts(port)[1] == 0
    assert rows(port.execute(POISONED)) == want_p


def test_quarantine_ttl_half_open_probe(engines, monkeypatch):
    """After QUARANTINE_TTL_S the next launch probes the card with a fresh
    strike count: still failing, it quarantines again after two strikes;
    healed, it answers."""
    _ref, port = engines
    want = rows(_ref.execute(POISONED))
    now = [1000.0]
    monkeypatch.setattr(device_mod.time, "monotonic", lambda: now[0])
    f, _ = arm(point="device.launch", target="sum(m)", mode="error")
    assert port.execute(POISONED)["exceptions"]
    assert counts(port)[:2] == (2, 1)
    now[0] += port.device.QUARANTINE_TTL_S - 1
    assert "quarantined" in port.execute(POISONED)["exceptions"][0][
        "message"]
    assert f.fired == 2
    now[0] += 2  # past the TTL: half-open
    assert port.execute(POISONED)["exceptions"]
    assert f.fired == 4 and counts(port)[:2] == (4, 1)
    now[0] += port.device.QUARANTINE_TTL_S
    faults.clear()
    assert rows(port.execute(POISONED)) == want
    assert counts(port)[1] == 0


def test_fetch_failure_refused_in_band_and_batch_evicted(engines):
    ref, port = engines
    want = rows(ref.execute(GROUPED))
    ev_p, ev_r = port.device.batch_evictions, ref.device.batch_evictions
    arm(point="device.fetch", mode="error", times=1)
    got = port.execute(GROUPED)
    assert "device fetch failed" in got["exceptions"][0]["message"]
    assert rows(ref.execute(GROUPED)) == want  # the reference's host
    assert counts(port) == counts(ref) == (1, 0, 1)
    assert port.device.batch_evictions - ev_p \
        == ref.device.batch_evictions - ev_r == 1
    assert port.device.hbm_stats()["cached_batches"] == 0
    # the next query rebuilds the batch and answers
    misses = port.device.batch_misses
    assert rows(port.execute(GROUPED)) == want
    assert port.device.batch_misses == misses + 1


def test_cohort_shared_failure_counts_once(engines):
    """A cohort re-raises its one fetch failure in every member: one
    strike, no quarantine, every member refused in-band."""
    _ref, port = engines
    co = port.device.coalescer
    co.force, co.window_s = True, 0.2
    arm(point="device.fetch", mode="error", times=1)
    barrier = threading.Barrier(2)
    out = [None, None]

    def member(i):
        barrier.wait(10)
        out[i] = port.execute(f"SELECT SUM(m) FROM t WHERE v > {i}")

    threads = [threading.Thread(target=member, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    co.force = False
    assert co.queries_coalesced == 1
    for r in out:
        assert "device fetch failed" in r["exceptions"][0]["message"]
    assert counts(port) == (1, 0, 1)


@pytest.mark.parametrize("err,calls,refused", [
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"), 2, False),
    (lambda: torch.AcceleratorError("an illegal memory access"), 1, True),
])
def test_oom_retried_sticky_error_refused(engines, monkeypatch, err, calls,
                                          refused):
    """The first pipeline run raises: an out-of-memory is retried (and
    the retry answers), a sticky CUDA error counts its strike and is
    refused at once."""
    ref, port = engines
    want = rows(ref.execute(GROUPED))
    real, seen = device_mod.build_pipeline, []

    def flaky(*a, **k):
        inner = real(*a, **k)

        def run(*x, **y):
            seen.append(1)
            if len(seen) == 1:
                raise err()
            return inner(*x, **y)

        return run

    monkeypatch.setattr(device_mod, "build_pipeline", flaky)
    got = port.execute(GROUPED)
    assert len(seen) == calls
    if refused:
        assert "sticky" in got["exceptions"][0]["message"]
    else:
        assert rows(got) == want
    assert counts(port) == (1, 0, 1)


# ---------------------------------------------------------------------------
# chunklet promotion
# ---------------------------------------------------------------------------


def _rt_rows():
    rng = np.random.default_rng(3)
    return [{"zone": f"z{int(rng.integers(0, 20)):02d}",
             "fare": int(rng.integers(0, 1000)), "ts": i}
            for i in range(3000)]


def _rt_segment(pkg, rows_):
    tc = __import__(f"{pkg}.common.table_config", fromlist=["x"])
    sc = __import__(f"{pkg}.common.schema", fromlist=["x"])
    dt = __import__(f"{pkg}.common.datatypes", fromlist=["x"])
    mut = __import__(f"{pkg}.storage.mutable", fromlist=["x"])
    schema = sc.Schema.build(
        name="rt", dimensions=[("zone", dt.DataType.STRING)],
        metrics=[("fare", dt.DataType.INT)],
        datetimes=[("ts", dt.DataType.LONG)])
    cfg = tc.TableConfig(
        table_name="rt",
        chunklets=tc.ChunkletConfig(enabled=True, rows_per_chunklet=1024,
                                    device_min_rows=0))
    seg = mut.MutableSegment(schema, "rt__0", cfg)
    seg.index_batch(rows_)
    return seg


RT_SQL = ["SELECT COUNT(*), SUM(fare) FROM rt",
          "SELECT zone, COUNT(*), MAX(fare) FROM rt GROUP BY zone "
          "ORDER BY zone LIMIT 50"]


def test_promotion_failure_keeps_ingest_and_answers():
    rows_ = _rt_rows()
    arm(point="chunklet.promote", mode="error")
    pseg, rseg = _rt_segment("pinot_tpu_torch", rows_), \
        _rt_segment("pinot_tpu", rows_)
    with pytest.raises(faults.FaultInjected):
        pseg.chunklet_index.promote()
    with pytest.raises(ref_faults.FaultInjected):
        rseg.chunklet_index.promote()
    assert pseg.n_docs == 3000 and not pseg.chunklet_index.chunklets
    port, ref = QueryEngine(device="cpu"), RefEngine()
    port.device.min_rows = 0
    port.table("rt").add_segment(pseg)
    ref.table("rt").add_segment(rseg)
    for sql in RT_SQL:
        assert rows(port.execute(sql)) == rows(ref.execute(sql)), sql
    assert rows(port.execute(RT_SQL[0]))[0] == [
        3000, sum(r["fare"] for r in rows_)]
    # cleared: the next promotion catches the frozen prefix up
    faults.clear()
    ref_faults.clear()
    assert pseg.chunklet_index.promote() == rseg.chunklet_index.promote() > 0
    for sql in RT_SQL:
        assert rows(port.execute(sql)) == rows(ref.execute(sql)), sql


def test_consume_helper_swallows_promotion_failure():
    from pinot_tpu_torch.realtime.chunklet import consume_stream_batches

    seg = _rt_segment("pinot_tpu_torch", [])

    class OneBatchConsumer:
        def fetch_payload_batch(self, start, max_rows):
            if start > 0:
                return [], start
            return [json.dumps({"zone": "z1", "fare": i, "ts": i}).encode()
                    for i in range(1500)], 1500

    f, _ = arm(point="chunklet.promote", mode="error")
    n, nxt, fetched = consume_stream_batches(
        seg, OneBatchConsumer(), json.loads, 0)
    assert (n, nxt, fetched) == (1500, 1500, 1500)
    assert f.fired == 1 and seg.n_docs == 1500
    assert not seg.chunklet_index.chunklets
