"""EXPLAIN PLAN on the port against the JAX package.

Two segments written by the JAX package's creator (a sorted column, an
inverted index, raw metrics) go into both engines. Every EXPLAIN row
must equal the reference's but the backend label, which names what runs
the query in the port: the card, in the reference's device shape
(``DEVICE(torch/cuda)``) where the reference's device runs it, else in
its host path's shape. Both engines' device partials caches are off for
the comparison, so neither renders a CACHED_PARTIALS line. ``supports``
equals the reference's static check; EXPLAIN ANALYZE of a multi-stage
query is refused in-band.
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.query.optimizer import optimize_query as ref_optimize
from pinot_tpu.sql.compiler import compile_select as ref_compile
from pinot_tpu.sql.parser import parse_sql as ref_parse
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.explain import BACKEND_DEVICE, BACKEND_HOST_SHAPE
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.sql.compiler import compile_select
from pinot_tpu_torch.sql.parser import parse_sql
from pinot_tpu_torch.storage.segment import ImmutableSegment

LABELS = {"DEVICE(jax/xla)": BACKEND_DEVICE,
          "HOST(numpy)": BACKEND_HOST_SHAPE}

QUERIES = [
    "SELECT SUM(qty) FROM t WHERE city = 'c1'",
    "SELECT COUNT(*) FROM t",
    "SELECT city, SUM(qty) FROM t GROUP BY city ORDER BY SUM(qty) DESC "
    "LIMIT 3",
    "SELECT city, grp, COUNT(*) FROM t WHERE ts BETWEEN 10 AND 900 "
    "GROUP BY city, grp ORDER BY city, grp LIMIT 5",
    "SELECT city, COUNT(*) FROM t GROUP BY city HAVING COUNT(*) > 3",
    "SELECT qty % 5, SUM(big) FROM t GROUP BY qty % 5 ORDER BY 1 LIMIT 3",
    "SELECT city, qty FROM t WHERE qty > 3 AND NOT grp IN (1, 2) "
    "ORDER BY qty DESC LIMIT 4",
    "SELECT city FROM t WHERE city LIKE 'c1%' OR qty < 2 LIMIT 3",
    "SELECT DISTINCT city FROM t ORDER BY city",
    "SELECT DISTINCT qty FROM t WHERE grp = 3",
    "SELECT grp, DISTINCTCOUNT(qty) FROM t GROUP BY grp",
    "SELECT PERCENTILE(qty, 50) FROM t",
    "SELECT city, PERCENTILETDIGEST(qty, 90) FROM t WHERE grp > 2 "
    "GROUP BY city ORDER BY city",
    "SELECT city, FIRSTWITHTIME(qty, ts, 'INT') FROM t GROUP BY city",
    "SELECT qty FROM t WHERE city = 'nowhere'",
    "SELECT qty FROM t WHERE ts > 1500",
    "SELECT $docId, qty FROM t WHERE $segmentName = 's0' LIMIT 2",
]


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="t",
        dimensions=[("city", DataType.STRING), ("grp", DataType.INT),
                    ("ts", DataType.LONG)],
        metrics=[("qty", DataType.INT), ("big", DataType.LONG)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        inverted_index_columns=["city"], bloom_filter_columns=["city"]))
    base = tmp_path_factory.mktemp("torch_explain")
    rng = np.random.default_rng(3)
    dirs = []
    for i, n in enumerate((3000, 2000)):
        out = str(base / f"s{i}")
        build_segment(schema, {
            "city": np.array([f"c{j}" for j in range(15)])[
                rng.integers(0, 15, n)],
            "grp": rng.integers(0, 20, n).astype(np.int32),
            # sorted, and segment 1 entirely past 1000: some queries prune
            "ts": np.sort(rng.integers(0, 1000, n) + 1000 * i).astype(
                np.int64),
            "qty": rng.integers(0, 50, n).astype(np.int32),
            "big": rng.integers(0, 1 << 40, n).astype(np.int64),
        }, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def engines(segment_dirs):
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    ref.device.partials_cache_enabled = False
    port = QueryEngine(device="cpu")
    port.device.partials_cache_enabled = False
    for d in segment_dirs:
        ref.add_segment("t", RefSegment(d))
        port.add_segment("t", ImmutableSegment(d))
    return ref, port


def _lines(resp) -> list:
    return [r[0] for r in resp["resultTable"]["rows"]]


def _ported(lines) -> list:
    out = []
    for ln in lines:
        for ref_label, label in LABELS.items():
            ln = ln.replace(f"[{ref_label}]", f"[{label}]")
        out.append(ln)
    return out


@pytest.mark.parametrize("sql", QUERIES)
def test_explain_rows_match_reference(engines, sql):
    ref, port = engines
    want = ref.execute("EXPLAIN PLAN FOR " + sql)
    got = port.execute("EXPLAIN PLAN FOR " + sql)
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    assert _lines(got) == _ported(_lines(want))
    assert [r[1:] for r in got["resultTable"]["rows"]] == \
        [r[1:] for r in want["resultTable"]["rows"]]


@pytest.mark.parametrize("sql", QUERIES[:6])
def test_width_audit_lines_match_reference(engines, sql, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_WIDTH_AUDIT", "1")
    ref, port = engines
    got = _lines(port.execute("EXPLAIN PLAN FOR " + sql))
    want = _ported(_lines(ref.execute("EXPLAIN PLAN FOR " + sql)))
    assert any("WIDTH(" in ln for ln in got) == \
        any("WIDTH(" in ln for ln in want)
    assert got == want


@pytest.mark.parametrize("sql", QUERIES)
def test_supports_is_the_references_check(engines, sql):
    ref, port = engines
    q = optimize_query(compile_select(parse_sql(sql)))
    rq = ref_optimize(ref_compile(ref_parse(sql)))
    assert port.device.supports(q) == ref.device.supports(rq)


def test_explain_analyze_is_refused_in_band(engines):
    """EXPLAIN ANALYZE of a multi-stage query, refused in-band before the
    multi-stage engine came, now runs through it (single-stage ANALYZE is
    tests/test_torch_xray.py's): its analyzed answer is the reference's,
    and so are its annotated lines but for the backend label, the times
    and the KERNEL lines."""
    ref, port = engines
    sql = "EXPLAIN ANALYZE SELECT a.qty FROM t a JOIN t b ON a.grp = b.grp"
    got = port.execute(sql)
    want = ref.execute("SET useAdvisor=false; " + sql)
    assert got["exceptions"] == []
    assert got["analyzedResponse"]["resultTable"] == \
        want["analyzedResponse"]["resultTable"]

    def lines(resp):
        return [ln.replace("DEVICE(jax/xla)", "DEVICE(torch/cuda)")
                .split(" (actual: rows=")[0] for ln in _lines(resp)
                if not ln.strip().startswith(("PHASE(", "KERNEL("))]

    assert lines(got) == lines(want)
    assert any(ln.startswith("  SCAN(a=t [probe]) (actual: out=")
               for ln in _lines(got))


def test_explain_plan_mentions_the_filter_operator(engines):
    """tests/test_queries.py's EXPLAIN check, on this table: the reduce
    and the chosen filter operator are named."""
    _ref, port = engines
    ops = _lines(port.execute(
        "EXPLAIN PLAN FOR SELECT SUM(qty) FROM t WHERE city = 'c1'"))
    assert any("BROKER_REDUCE" in o for o in ops)
    assert any("FILTER_INVERTED_INDEX" in o for o in ops)
