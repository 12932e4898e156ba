"""Three repairs of the port against the reference, each held against
``pinot_tpu.engine.engine.QueryEngine`` over the same segments:

- F1: every single-stage response (and EXPLAIN ANALYZE's) carries the
  reference's stat keys, ``numSegmentsCold`` among them, with equal
  values (times aside);
- F2: ``BatchContext`` builds each plane once when several threads run
  the same first query, and counts its bytes once;
- F3: the batch LRU evicts by resident bytes too
  (``DeviceExecutor.MAX_CACHED_BYTES``, ``PINOT_TPU_BATCH_CACHE_BYTES``),
  never the last batch, never a pinned one.
"""

import threading
import time

import numpy as np
import pytest

from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu_torch.engine import params as t_params
from pinot_tpu_torch.engine.device import DeviceExecutor
from test_torch_join import MODS, new_engine, rows_close
from test_torch_lookup import STATS
from test_torch_lookup import load as load_lookup

# values that differ between two runs of one engine, let alone two
TIMES = ("timeUsedMs", "deviceKernelMs", "deviceLinkMs")


def same_response(got: dict, want: dict) -> None:
    """The reference's keys, each in the port's response with its value:
    rows within ``rows_close``, the roofline's records by label and bytes,
    EXPLAIN ANALYZE's inner response alike; times and traces aside, and
    the plan's rows (their times and backend labels differ) counted
    only."""
    plan = "analyzedResponse" in want
    assert want.get("exceptions") == [], want.get("exceptions")
    missing = sorted(set(want) - set(got))
    assert not missing, missing
    for key, w in want.items():
        g = got[key]
        if key in TIMES or key == "traceInfo":
            continue
        if key == "resultTable":
            assert g["dataSchema"] == w["dataSchema"]
            if plan:
                assert len(g["rows"]) == len(w["rows"])
            else:
                assert rows_close(g["rows"], w["rows"]), (g["rows"],
                                                          w["rows"])
        elif key == "roofline":
            assert [(r["kernel"], r["bytesMoved"]) for r in g] == \
                [(r["kernel"], r["bytesMoved"]) for r in w]
        elif key == "analyzedResponse":
            same_response(g, w)
        else:
            assert g == w, (key, g, w)


@pytest.fixture()
def lookup_engines(tmp_path):
    return (load_lookup("ref", new_engine("ref"), tmp_path / "r"),
            load_lookup("port", new_engine("port"), tmp_path / "p"))


class TestSegmentsColdStat:
    @pytest.mark.parametrize("sql", [
        "SELECT team, score FROM games ORDER BY score LIMIT 3",
        "SELECT team, SUM(score), COUNT(*) FROM games GROUP BY team "
        "ORDER BY team",
        "SELECT DISTINCT team FROM games ORDER BY team",
        "SELECT PERCENTILETDIGEST(score, 50), DISTINCTCOUNTHLL(team) "
        "FROM games",
        "SELECT LOOKUP('teams', 'teamName', 'teamID', team), score "
        "FROM games ORDER BY score",
        "SELECT COUNT(*), SUM(score) FROM games WHERE score > 100",
        "EXPLAIN ANALYZE SELECT team, SUM(score) FROM games GROUP BY team",
    ], ids=["selection", "groupby", "distinct", "sketch", "lookup",
            "empty_filter", "analyze"])
    def test_response_carries_every_stat(self, lookup_engines, sql):
        ref, port = lookup_engines
        got = port.execute(sql)
        assert got["numSegmentsCold"] == 0 if "numSegmentsCold" in got \
            else got["analyzedResponse"]["numSegmentsCold"] == 0
        same_response(got, ref.execute(sql))


# ---------------------------------------------------------------------------
# F2 and F3: two small tables of one schema
# ---------------------------------------------------------------------------

N = 2000


def _schema(side, name):
    sc, dt = MODS[side][:2]
    DT = dt.DataType
    return sc.Schema.build(name=name,
                           dimensions=[("k", DT.INT), ("s", DT.STRING)],
                           metrics=[("v", DT.INT), ("f", DT.DOUBLE)])


def _data():
    rng = np.random.default_rng(5)
    return {"k": rng.integers(0, 30, N).astype(np.int32),
            "s": np.array(["a", "b", "c"])[rng.integers(0, 3, N)],
            "v": rng.integers(0, 1000, N).astype(np.int32),
            "f": rng.random(N)}


def load_tables(side, eng, base, tables=("t1", "t2")):
    """``tables`` over the same rows; a port engine runs every query in
    full (its partials cache off), as the reference does here."""
    _sc, _dt, tc, creator, _m = MODS[side]
    if side == "port":
        eng.device.partials_cache_enabled = False
    data = _data()
    for t in tables:
        eng.add_segment(t, creator.build_segment(
            _schema(side, t), data, str(base / f"{side}_{t}"),
            tc.TableConfig(table_name=t), f"{t}_0"))
    return eng


def same_answer(got: dict, want: dict) -> None:
    """Rows, dataSchema and the single-stage scan stats (``STATS``)."""
    assert got.get("exceptions") == [], got.get("exceptions")
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    assert rows_close(got["resultTable"]["rows"],
                      want["resultTable"]["rows"])
    for key in (*STATS, "numSegmentsCold"):
        assert got[key] == want[key], (key, got[key], want[key])


FIRST = ("SELECT k, SUM(v), MAX(f) FROM t1 WHERE s = 'a' GROUP BY k "
         "ORDER BY k LIMIT 5")


def _threads(eng, n: int, sql: str) -> list:
    bar = threading.Barrier(n)
    out = [None] * n

    def run(i):
        bar.wait()
        out[i] = eng.execute(sql)

    ths = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    return out


@pytest.fixture()
def slow_builds(monkeypatch):
    """Count each plane's builds by (batch, column), and hold every build
    for a while, so that threads without a lock would all build it."""
    built: dict = {}
    host_column = t_params.BatchContext.host_column

    def slow(self, name):
        built[(id(self), name)] = built.get((id(self), name), 0) + 1
        time.sleep(0.05)
        return host_column(self, name)

    monkeypatch.setattr(t_params.BatchContext, "host_column", slow)
    return built


class TestConcurrentBuilds:
    def test_first_query_builds_each_plane_once(self, tmp_path, slow_builds):
        ref = load_tables("ref", new_engine("ref"), tmp_path / "r", ("t1",))
        want = ref.execute(FIRST)
        one = load_tables("port", new_engine("port"), tmp_path / "p1",
                          ("t1",))
        same_answer(one.execute(FIRST), want)
        single = one.device.hbm_stats()["resident_bytes"]
        assert single == ref.device.hbm_stats()["resident_bytes"]
        slow_builds.clear()
        four = load_tables("port", new_engine("port"), tmp_path / "p4",
                           ("t1",))
        for got in _threads(four, 4, FIRST):
            same_answer(got, want)
        assert slow_builds and set(slow_builds.values()) == {1}, slow_builds
        assert four.device.hbm_stats()["resident_bytes"] == single

    @pytest.mark.parametrize("sql", [
        "SELECT COUNT(*), SUM(v) FROM t1 WHERE k < 10",
        "SELECT s, DISTINCTCOUNTHLL(k), MIN(f) FROM t1 GROUP BY s "
        "ORDER BY s",
    ])
    def test_threads_count_bytes_once(self, tmp_path, sql):
        one = load_tables("port", new_engine("port"), tmp_path / "p1",
                          ("t1",))
        want = one.execute(sql)
        four = load_tables("port", new_engine("port"), tmp_path / "p4",
                           ("t1",))
        for got in _threads(four, 4, sql):
            same_answer(got, want)
        assert four.device.hbm_stats()["resident_bytes"] == \
            one.device.hbm_stats()["resident_bytes"]


ALTERNATE = ("SELECT k, SUM(v), COUNT(*) FROM {t} GROUP BY k ORDER BY k "
             "LIMIT 5")


class TestBatchByteCap:
    def test_default_cap_is_the_reference_s(self):
        assert DeviceExecutor.MAX_CACHED_BYTES == RefExecutor.MAX_CACHED_BYTES

    def test_evicts_by_bytes_as_the_reference(self, tmp_path, monkeypatch):
        monkeypatch.setattr(RefExecutor, "MAX_CACHED_BYTES", 1000)
        monkeypatch.setattr(DeviceExecutor, "MAX_CACHED_BYTES", 1000)
        ref = load_tables("ref", new_engine("ref"), tmp_path / "r")
        port = load_tables("port", new_engine("port"), tmp_path / "p")
        free = load_tables("port", new_engine("port"), tmp_path / "f")
        free.device.MAX_CACHED_BYTES = 6 << 30
        for i in range(4):
            sql = ALTERNATE.format(t=("t1", "t2")[i % 2])
            want = ref.execute(sql)
            same_answer(port.execute(sql), want)
            same_answer(free.execute(sql), want)
        got, ref_st = port.device.hbm_stats(), ref.device.hbm_stats()
        for key in ("batch_evictions", "cached_batches", "resident_bytes",
                    "max_cached_bytes"):
            assert got[key] == ref_st[key], (key, got[key], ref_st[key])
        assert got["batch_evictions"] == 3 and got["cached_batches"] == 1
        assert free.device.hbm_stats()["batch_evictions"] == 0

    def test_never_evicts_the_last_batch(self, tmp_path, monkeypatch):
        monkeypatch.setattr(DeviceExecutor, "MAX_CACHED_BYTES", 1)
        port = load_tables("port", new_engine("port"), tmp_path / "p",
                           ("t1",))
        for _ in range(2):
            port.execute(ALTERNATE.format(t="t1"))
        st = port.device.hbm_stats()
        assert st["batch_evictions"] == 0 and st["cached_batches"] == 1
        assert st["batch_hits"] >= 1 and st["resident_bytes"] > 1

    def test_pinned_batch_stays(self, tmp_path, monkeypatch):
        monkeypatch.setattr(DeviceExecutor, "MAX_CACHED_BYTES", 1000)
        port = load_tables("port", new_engine("port"), tmp_path / "p")
        port.execute(ALTERNATE.format(t="t1"))
        ex = port.device
        segs = list(port.table("t1").segments.values())
        pinned = ex.batch_for(segs, retain=True)
        port.execute(ALTERNATE.format(t="t2"))
        assert ex.hbm_stats()["cached_batches"] == 2
        assert ex.batch_for(segs) is pinned
        ex._release_launch(ex._batch_key(segs))
        port.execute(ALTERNATE.format(t="t2"))
        st = ex.hbm_stats()
        assert st["cached_batches"] == 1 and st["batch_evictions"] >= 1
