"""The port's roofline accounting and EXPLAIN ANALYZE against the JAX
package.

After tests/test_xray.py (without the join and cluster cases): the memory
peak probe (``ops/roofline.py``: the environment override, positive and
cached on the CPU, the percentage of peak); the per-flight roofline
records a response carries, with the reference's keys; cache-hit flights
marked and not rated; EXPLAIN ANALYZE's rows equal to the reference's
line for line but the timings and the labels (``+cuda`` where the
reference names ``+pallas``, the backend); ``analyzedResponse`` equal to
the plain execute; and plain EXPLAIN unchanged by ANALYZE.
"""

import re

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import roofline
from pinot_tpu_torch.storage.segment import ImmutableSegment

GROUPBY_SQL = ("SELECT city, COUNT(*), SUM(qty) FROM t GROUP BY city "
               "ORDER BY SUM(qty) DESC, city LIMIT 5")
QUERIES = [
    GROUPBY_SQL,
    "SELECT COUNT(*), SUM(qty), MAX(qty) FROM t WHERE ts BETWEEN 100 AND 200",
    "SELECT city, MIN(qty), MAX(qty) FROM t WHERE qty > 10 GROUP BY city "
    "ORDER BY city LIMIT 20",
    "SELECT DISTINCTCOUNTHLL(city) FROM t WHERE ts > 1500",
    "SELECT qty FROM t WHERE ts > 2500 ORDER BY qty DESC LIMIT 3",
]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    schema = Schema.build(
        name="t", dimensions=[("city", DataType.STRING),
                              ("ts", DataType.LONG)],
        metrics=[("qty", DataType.INT)])
    base = tmp_path_factory.mktemp("torch_xray")
    rng = np.random.default_rng(9)
    out = []
    for i in range(3):
        n = 6000
        d = str(base / f"s{i}")
        build_segment(schema, {
            "city": np.array([f"c{j}" for j in range(15)])[
                rng.integers(0, 15, n)],
            "ts": np.sort(rng.integers(0, 1000, n) + 1000 * i).astype(
                np.int64),
            "qty": rng.integers(0, 50, n).astype(np.int32)}, d, None, f"s{i}")
        out.append(d)
    return out


@pytest.fixture
def engines(dirs, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_HBM_PEAK_GBPS", "800")
    ref = RefEngine()
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0
    for d in dirs:
        ref.add_segment("t", RefSegment(d))
        port.add_segment("t", ImmutableSegment(d))
    return ref, port


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def test_probe_positive_and_cached_on_the_cpu(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_HBM_PEAK_GBPS", raising=False)
    monkeypatch.setattr(roofline, "CPU_PROBE_BYTES", 4 << 20)
    roofline.reset_probe()
    try:
        p1 = roofline.hbm_peak_gbps("cpu")
        assert p1 > 0
        assert roofline.hbm_peak_gbps("cpu") == p1  # cached
        assert roofline.peak_if_probed() == p1
    finally:
        roofline.reset_probe()
    assert roofline.peak_if_probed() is None


def test_env_override(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_HBM_PEAK_GBPS", "819.0")
    assert roofline.hbm_peak_gbps() == 819.0
    assert roofline.peak_if_probed() == 819.0


def test_pct_of_peak(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_HBM_PEAK_GBPS", "800")
    assert roofline.pct_of_peak(8.0) == 1.0
    assert roofline.pct_of_peak(None) is None
    assert roofline.pct_of_peak(8.0, peak=0.0) is None


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------


def test_response_carries_roofline_records(engines):
    ref, port = engines
    r = port.execute(GROUPBY_SQL)
    want = ref.execute(GROUPBY_SQL)
    (rec,), (ref_rec,) = r["roofline"], want["roofline"]
    assert set(rec) == set(ref_rec)
    assert rec["kernel"].startswith("groupby") and rec["kernel"].endswith(
        "+trim")
    assert rec["bytesMoved"] > rec["bytesFetched"] > 0
    assert rec["gbps"] > 0 and rec["peakGbps"] == 800.0
    assert rec["pctOfPeak"] == pytest.approx(100 * rec["gbps"] / 800,
                                             abs=1e-3)
    assert r["deviceBytesMoved"] == rec["bytesMoved"]
    assert r["deviceKernelMs"] == pytest.approx(rec["kernelMs"], abs=1e-3)
    assert r["deviceLinkMs"] == pytest.approx(rec["linkMs"], abs=1e-3)
    stats = port.device.roofline_stats()
    assert stats["peak_gbps"] == 800.0
    assert stats["kernels"][rec["kernel"]]["queries"] == 1


def test_block_skip_record_scales_the_data(engines):
    """A block-skip flight charges the gathered blocks only: the fused
    K4 form moves fewer modeled bytes than the dense form."""
    _ref, port = engines
    sql = QUERIES[1]
    fused = port.execute(sql)["roofline"][0]
    dense = port.execute("SET useBlockSkip = false; " + sql)["roofline"][0]
    assert "+bskip" in fused["kernel"] and "+fused" in fused["kernel"]
    assert "gatherBytes" not in fused
    assert fused["bytesMoved"] < dense["bytesMoved"]


def test_cache_hit_flights_are_marked_not_rated(engines):
    _ref, port = engines
    port.execute(GROUPBY_SQL)
    r = port.execute(GROUPBY_SQL)
    assert r["partialsCacheHit"] is True
    (rec,) = r["roofline"]
    assert rec["cacheHit"] is True and rec["bytesMoved"] == 0
    assert "gbps" not in rec and "pctOfPeak" not in rec
    agg = port.device.roofline_stats()["kernels"][rec["kernel"]]
    assert agg["cache_hits"] == 1 and agg["queries"] == 2


def test_host_path_shapes_carry_no_record(engines):
    """The reference answers selection on its host: no flight."""
    ref, port = engines
    r = port.execute(QUERIES[4])
    assert r["exceptions"] == [] and "roofline" not in r
    assert "roofline" not in ref.execute(QUERIES[4])


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

LABELS = {"[DEVICE(jax/xla)]": "[DEVICE(torch/cuda)]",
          "[HOST(numpy)]": "[DEVICE(torch/cuda, host-path shape)]"}


def _normalized(lines) -> list:
    """Rows with the timings and the kernel lines' measurements and labels
    blanked: everything else must be the reference's."""
    out = []
    for ln in lines:
        for ref_label, label in LABELS.items():
            ln = ln.replace(ref_label, label)
        ln = re.sub(r"timeMs=[0-9.]+", "timeMs=?", ln)
        s = ln.strip()
        if s.startswith("PHASE(") or s.startswith("KERNEL("):
            ln = ln[:ln.index("(")]
        out.append(ln)
    return out


def _lines(resp) -> list:
    assert resp["exceptions"] == [], resp
    return [r[0] for r in resp["resultTable"]["rows"]]


@pytest.mark.parametrize("sql", QUERIES)
def test_explain_analyze_matches_reference(engines, sql):
    ref, port = engines
    got = port.execute("EXPLAIN ANALYZE " + sql)
    want = ref.execute("EXPLAIN ANALYZE " + sql)
    assert _normalized(_lines(got)) == _normalized(_lines(want))
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    kernels = [ln for ln in _lines(got) if ln.strip().startswith("KERNEL(")]
    assert len(kernels) == len(got["analyzedResponse"].get("roofline") or [])
    for ln in kernels:
        assert "% of HBM peak 800.0 GB/s" in ln and "+cuda" in ln
    assert "traceInfo" in got["analyzedResponse"]


@pytest.mark.parametrize("sql", QUERIES)
def test_analyzed_response_equals_plain_execute(engines, sql):
    _ref, port = engines
    plain = port.execute(sql)
    got = port.execute("EXPLAIN ANALYZE " + sql)["analyzedResponse"]
    assert got["resultTable"] == plain["resultTable"]
    for key in ("numDocsScanned", "numEntriesScannedInFilter",
                "numBlocksPruned", "totalDocs", "numSegmentsPrunedByServer"):
        assert got[key] == plain[key], key
    assert got["partialsCacheHit"] is False  # ANALYZE bypasses the cache


def test_plain_explain_unchanged(engines):
    ref, port = engines
    before = _lines(port.execute("EXPLAIN PLAN FOR " + GROUPBY_SQL))
    port.execute("EXPLAIN ANALYZE " + GROUPBY_SQL)
    ref.execute("EXPLAIN ANALYZE " + GROUPBY_SQL)
    after = _lines(port.execute("EXPLAIN PLAN FOR " + GROUPBY_SQL))
    assert before == after
    assert not any("ANALYZE" in ln or "actual:" in ln for ln in after)
    want = _lines(ref.execute("EXPLAIN PLAN FOR " + GROUPBY_SQL))
    assert after == _normalized(want)
