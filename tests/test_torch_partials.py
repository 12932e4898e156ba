"""The port's device partials cache against the JAX package.

After tests/test_subrtt.py (without the promotion, upsert and seal seams,
which come with consuming segments): a repeat execution (same template,
batch and forms, the same literal values and ps_alive verdicts) copies
the cached packed output buffer again, runs no kernel and answers as the
first run did, ``partialsCacheHit`` set; the counters in ``hbm_stats``;
the entry cap's evictions; entries dropping with their batch;
``invalidate_partials`` and the module-level
``invalidate_cached_partials``; ``SET usePartialsCache = false``; and the
``CACHED_PARTIALS`` EXPLAIN line equal to the reference's.
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.ops import groupby_mm as mm
from pinot_tpu_torch.storage.segment import ImmutableSegment

SQL = ("SELECT zone, COUNT(*), SUM(v), MIN(v) FROM t WHERE v > 100 "
       "GROUP BY zone ORDER BY SUM(v) DESC, zone LIMIT 5")
SQL2 = "SELECT COUNT(*), MAX(v) FROM u WHERE v < 500"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    rng = np.random.default_rng(11)
    base = tmp_path_factory.mktemp("torch_partials")
    out = {"t": [], "u": []}
    for table in out:
        schema = Schema.build(name=table,
                              dimensions=[("zone", DataType.STRING)],
                              metrics=[("v", DataType.INT)])
        for i in range(2):
            n = 3000
            d = str(base / f"{table}{i}")
            build_segment(schema, {
                "zone": np.array([f"z{j}" for j in range(12)])[
                    rng.integers(0, 12, n)],
                "v": rng.integers(0, 1000, n).astype(np.int32)},
                d, None, f"{table}{i}")
            out[table].append(d)
    return out


def make_port(dirs) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    eng.device.min_rows = 0
    for table, ds in dirs.items():
        for d in ds:
            eng.add_segment(table, ImmutableSegment(d))
    return eng


def rows(resp):
    assert resp["exceptions"] == [], resp
    return resp["resultTable"]["rows"]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the kernels' entries (the CPU runs their plain versions)."""
    seen = []
    for mod, names in ((ps, ("plane_group_sums", "group_minmax_sources",
                             "hll_register_max", "fused_filter_agg")),
                       (mm, ("group_sums", "hll_registers"))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(
                mod, name, lambda *a, _r=real, _n=name, **k:
                seen.append(_n) or _r(*a, **k))
    return seen


def test_repeat_hits_with_the_same_answer(dirs, kernel_calls):
    eng = make_port(dirs)
    d = eng.device
    h0, m0 = d.partials_hits, d.partials_misses
    r1 = eng.execute(SQL)
    assert kernel_calls, "the first run launched no kernel"
    kernel_calls.clear()
    r2 = eng.execute(SQL)
    assert kernel_calls == []  # a hit runs nothing on the card
    assert (r1["partialsCacheHit"], r2["partialsCacheHit"]) == (False, True)
    assert rows(r1) == rows(r2)
    assert {k: v for k, v in r1.items() if k not in (
        "timeUsedMs", "partialsCacheHit", "deviceBytesMoved",
        "deviceKernelMs", "deviceLinkMs", "roofline")} == {
        k: v for k, v in r2.items() if k not in (
            "timeUsedMs", "partialsCacheHit", "deviceBytesMoved",
            "deviceKernelMs", "deviceLinkMs", "roofline")}
    assert (d.partials_hits, d.partials_misses) == (h0 + 1, m0 + 1)
    # another literal is another entry
    r3 = eng.execute(SQL.replace("v > 100", "v > 101"))
    assert r3["partialsCacheHit"] is False and kernel_calls
    assert d.partials_misses == m0 + 2


def test_hbm_stats_counters(dirs):
    eng = make_port(dirs)
    eng.execute(SQL)
    eng.execute(SQL)
    stats = eng.device.hbm_stats()
    assert stats["partials_cache_entries"] == 1
    assert stats["partials_cache_bytes"] > 0
    assert (stats["partials_cache_hits"], stats["partials_cache_misses"]) \
        == (1, 1)
    assert stats["partials_cache_evictions"] == 0
    assert stats["partials_cache_invalidations"] == 0
    assert stats["device_reduce_queries"] == 2
    assert stats["inflight"] == 0 and stats["cached_batches"] == 1
    roof = stats["roofline"]
    assert set(roof) == {"peak_gbps", "kernels"}
    (label, agg), = roof["kernels"].items()
    assert label.startswith("groupby") and agg["queries"] == 2 \
        and agg["cache_hits"] == 1


def test_entry_cap_eviction_churn(dirs):
    eng = make_port(dirs)
    ref = RefEngine()
    for d in dirs["t"]:
        ref.add_segment("t", RefSegment(d))
    dev = eng.device
    dev.MAX_CACHED_PARTIALS = 1
    sqls = [SQL.replace("v > 100", f"v > {lit}") for lit in (100, 200, 300)]
    for _ in range(2):
        for s in sqls:
            assert rows(eng.execute(s)) == rows(ref.execute(s))
    assert dev.partials_evictions > 0
    assert len(dev._partials) <= 1 and dev.partials_bytes >= 0


def test_batch_eviction_drops_entries(dirs):
    eng = make_port(dirs)
    dev = eng.device
    dev.MAX_CACHED_BATCHES = 1
    w1, w2 = rows(eng.execute(SQL)), rows(eng.execute(SQL2))
    assert dev.batch_evictions > 0 and dev.partials_invalidations > 0
    # every entry's batch is still cached
    assert all(k[1] in dev._batches for k in dev._partials)
    for _ in range(2):
        assert rows(eng.execute(SQL)) == w1
        assert rows(eng.execute(SQL2)) == w2


def test_invalidate_partials(dirs):
    eng = make_port(dirs)
    eng.execute(SQL)
    eng.execute(SQL2)
    dev = eng.device
    assert len(dev._partials) == 2
    dev.invalidate_partials("u1")  # a segment dir of table u
    assert len(dev._partials) == 1
    assert eng.execute(SQL)["partialsCacheHit"] is True
    assert eng.execute(SQL2)["partialsCacheHit"] is False
    device_mod.invalidate_cached_partials(dirs["t"][0])
    assert all(dirs["t"][0] not in k[1] for k in dev._partials)
    device_mod.invalidate_cached_partials("")
    assert not dev._partials and dev.partials_bytes == 0
    assert dev.partials_invalidations >= 3


def test_set_use_partials_cache_false(dirs, kernel_calls):
    eng = make_port(dirs)
    off = "SET usePartialsCache = false; " + SQL
    r1 = eng.execute(off)
    kernel_calls.clear()
    r2 = eng.execute(off)
    assert kernel_calls and r2["partialsCacheHit"] is False
    assert rows(r1) == rows(r2)
    assert not eng.device._partials
    assert eng.execute(SQL)["partialsCacheHit"] is False  # never inserted


def test_cached_partials_explain_line(dirs):
    """Both engines' caches on, after the same queries: the EXPLAIN rows
    equal, CACHED_PARTIALS(entries=...) included (but the backend
    label)."""
    eng = make_port(dirs)
    ref = RefEngine()
    for table, ds in dirs.items():
        for d in ds:
            ref.add_segment(table, RefSegment(d))
    for e in (eng, ref):
        e.execute(SQL)
        e.execute(SQL2)
    lines = {}
    for sql in (SQL, SQL2, "SET usePartialsCache = false; " + SQL):
        explain = sql.replace("SELECT", "EXPLAIN PLAN FOR SELECT", 1)
        got = [r[0] for r in rows(eng.execute(explain))]
        want = [r[0].replace("[DEVICE(jax/xla)]", "[DEVICE(torch/cuda)]")
                for r in rows(ref.execute(explain))]
        assert got == want
        lines[sql] = got
    assert "    CACHED_PARTIALS(entries=2)" in lines[SQL]
    assert not any("CACHED_PARTIALS" in ln
                   for ln in lines["SET usePartialsCache = false; " + SQL])
