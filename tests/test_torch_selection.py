"""Selection on the port's card path against the JAX package's host path.

The JAX package answers selection on its host (numpy over the stored
values); the port answers it on the card in that path's shape
(engine/rows.py, ops/selection.py). Three segments written by the JAX
package's creator (dict, raw INT / LONG / FLOAT / DOUBLE, a column sorted
in every segment, an inverted index, a bloom filter; DOUBLE values that
differ below float32 spacing and NaN) go into both engines; the reference
runs its Pallas tier in interpret mode, the port on the CPU. Rows, tie
order, the dataSchema and every response stat both report must be
equal: integers, strings, order and stats bit for bit, floats per
``_rows_close`` (rtol 1e-5).

The SQL of tests/test_queries.py replays through the port behind that
file's own fixture: all 40 of its tests pass (``test_percentile`` since
the digest and sketch slice, engine/sketches.py).
"""

import inspect

import numpy as np
import pytest
import torch

import test_queries
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.engine.host import _order_indices
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import selection as sel
from pinot_tpu_torch.storage.segment import ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numGroupsLimitReached", "totalDocs")
SIZES = (4000, 3500, 2500)
TS0 = 1_600_000_000

SELECTION_SQL = {
    "double_order": ("SELECT city, qty, price FROM t "
                     "ORDER BY price DESC, city LIMIT 12"),
    "ties_offset": ("SELECT qty, city FROM t WHERE grp IN (1, 2, 3) "
                    "ORDER BY qty, city LIMIT 15 OFFSET 7"),
    "star": "SELECT * FROM t LIMIT 5",
    "no_order_inverted": ("SELECT city, qty FROM t WHERE city = 'c3' "
                          "LIMIT 20"),
    "no_order_offset": "SELECT qty, big FROM t LIMIT 4 OFFSET 3",
    "empty_match": "SELECT qty, city FROM t WHERE qty > 1000 LIMIT 10",
    "limit_past_matches": ("SELECT city, qty FROM t WHERE grp = 5 "
                           "ORDER BY qty DESC LIMIT 100000"),
    "expressions_case": (
        "SELECT qty * 2 + 1, CASE WHEN qty > 20 THEN 'big' WHEN qty > 10 "
        "THEN 'mid' ELSE 'small' END, price / qty, big - qty FROM t "
        "WHERE qty > 0 ORDER BY qty * 2 + 1 DESC, $docId LIMIT 10"),
    "numeric_case": ("SELECT CASE WHEN price > 1000.5 THEN 1 ELSE 0 END, "
                     "price FROM t ORDER BY price LIMIT 5"),
    "virtual_columns": (
        "SELECT $docId, $segmentName, $hostName, qty FROM t "
        "WHERE $docId < 5 ORDER BY $segmentName DESC, $docId LIMIT 20"),
    "virtual_filter_sorted": (
        "SELECT $docId, qty, ts FROM t WHERE $segmentName IN ('s0', 's2') "
        f"AND ts BETWEEN {TS0 + 100} AND {TS0 + 900} "
        "ORDER BY ts, $docId LIMIT 9"),
    "long_float": "SELECT big, ratio FROM t ORDER BY ratio, big DESC LIMIT 8",
    "nan_order": "SELECT score, $docId FROM t ORDER BY score DESC LIMIT 6",
    "nan_order_asc": ("SELECT score FROM t WHERE qty < 5 "
                      "ORDER BY score, $docId LIMIT 400"),
    "double_filter": ("SELECT city, qty, price FROM t "
                      "WHERE price > 1000.0000000015 AND price < 1000.00001 "
                      "ORDER BY price, $docId LIMIT 5"),
    "order_not_selected": ("SELECT city FROM t ORDER BY qty DESC, $docId "
                           "LIMIT 5"),
    "all_pruned_bloom": "SELECT city, qty FROM t WHERE city = 'nowhere'",
    "all_pruned_range": f"SELECT qty FROM t WHERE ts > {TS0 + 10_000_000}",
    "some_pruned": (f"SELECT ts, qty FROM t WHERE ts < {TS0 + 50} "
                    "ORDER BY ts DESC, qty LIMIT 7"),
    "or_not_like": ("SELECT city, grp FROM t WHERE NOT city LIKE 'c1%' "
                    "OR grp BETWEEN 3 AND 4 ORDER BY grp DESC, city, $docId "
                    "LIMIT 11"),
    "limit_zero": "SELECT qty FROM t ORDER BY qty LIMIT 0",
    "string_compare_case": (
        "SELECT city, CASE WHEN city = 'c3' THEN 1 WHEN city > 'c7' THEN 2 "
        "ELSE 0 END, $segmentName <> 's1' FROM t WHERE qty = 9 "
        "ORDER BY city DESC, $docId LIMIT 12"),
}


def _rows_close(rows_a, rows_b):
    if len(rows_a) != len(rows_b):
        return False
    for ra, rb in zip(rows_a, rows_b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, str) or x is None or isinstance(y, str) \
                    or y is None:
                if x != y:
                    return False
            elif not np.isclose(float(x), float(y), rtol=1e-5, atol=1e-6,
                                equal_nan=True):
                return False
    return True


def _columns(n: int, seg: int, rng) -> dict:
    cities = np.array([f"c{i}" for i in range(12)])
    score = rng.normal(0, 1, n)
    score[rng.random(n) < 0.05] = np.nan
    return {
        "city": cities[rng.integers(0, 12, n)],
        "grp": rng.integers(0, 30, n).astype(np.int32),
        # sorted inside every segment: the host's SORTED_INDEX
        "ts": np.sort(TS0 + seg * 300 + rng.integers(0, 2000, n)
                      ).astype(np.int64),
        "qty": rng.integers(0, 40, n).astype(np.int32),
        "big": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "ratio": rng.random(n).astype(np.float32),
        # values 1e-10 apart: float32 cannot tell them apart
        "price": 1000.0 + rng.integers(0, 500, n) * 1e-10
        + rng.integers(0, 3, n),
        "score": score,
    }


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="t",
        dimensions=[("city", DataType.STRING), ("grp", DataType.INT),
                    ("ts", DataType.LONG)],
        metrics=[("qty", DataType.INT), ("big", DataType.LONG),
                 ("ratio", DataType.FLOAT), ("price", DataType.DOUBLE),
                 ("score", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        inverted_index_columns=["city"], bloom_filter_columns=["city"]))
    base = tmp_path_factory.mktemp("torch_selection")
    rng = np.random.default_rng(11)
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(schema, _columns(n, i, rng), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def ref_responses(segment_dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in segment_dirs:
        eng.add_segment("t", RefSegment(d))
    return {k: eng.execute(sql) for k, sql in SELECTION_SQL.items()}


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    eng = QueryEngine(device="cpu")
    if request.param is not None:
        eng.device.min_rows = request.param
    for d in segment_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    return eng


def assert_same_response(got, want, float_ok=True):
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    if float_ok:
        assert _rows_close(rows, ref_rows), (rows[:5], ref_rows[:5])
    else:
        assert rows == ref_rows
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


@pytest.mark.parametrize("name", sorted(SELECTION_SQL))
def test_selection_matches_reference(port_engine, ref_responses, name):
    want = ref_responses[name]
    got = port_engine.execute(SELECTION_SQL[name])
    types = want["resultTable"]["dataSchema"]["columnDataTypes"]
    assert_same_response(got, want, float_ok="DOUBLE" in types)
    if name not in ("empty_match", "all_pruned_bloom", "all_pruned_range",
                    "limit_zero"):
        assert got["resultTable"]["rows"]


def test_double_order_sees_below_float32_spacing(port_engine,
                                                 ref_responses):
    """The DOUBLE key's values differ below float32 spacing: ordered on
    float32 planes they would tie and fall back to the city order."""
    got = port_engine.execute(SELECTION_SQL["double_order"])
    prices = [r[2] for r in got["resultTable"]["rows"]]
    assert prices == sorted(prices, reverse=True)
    assert len({np.float32(p) for p in prices}) < len(set(prices))
    assert got["resultTable"]["rows"] == \
        ref_responses["double_order"]["resultTable"]["rows"]


def test_host_name_option(segment_dirs):
    """``host_name`` stamps the segments; ``$hostName`` reads it."""
    eng = QueryEngine(device="cpu", host_name="server_7")
    for d in segment_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    resp = eng.execute("SELECT $hostName, qty FROM t LIMIT 2")
    assert [r[0] for r in resp["resultTable"]["rows"]] == ["server_7"] * 2


def test_unknown_virtual_column_is_in_band(port_engine):
    resp = port_engine.execute("SELECT $bogus FROM t")
    (exc,) = resp["exceptions"]
    assert "$bogus" in exc["message"]


# ---------------------------------------------------------------------------
# the ops against numpy: per-segment rows and order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 7, 5000])
def test_first_rows_per_segment(k):
    rng = np.random.default_rng(k)
    mask = rng.random((4, 300)) < 0.3
    got = sel.first_rows(torch.from_numpy(mask), k).numpy()
    want = np.concatenate([s * 300 + np.nonzero(mask[s])[0][:k]
                           for s in range(4)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_rows_is_the_hosts_per_segment_lexsort(seed):
    rng = np.random.default_rng(seed)
    S, L, k = 3, 500, 9
    mask = rng.random((S, L)) < 0.5
    a = rng.integers(0, 4, (S, L))            # heavy ties
    b = rng.normal(0, 1, (S, L))
    b[rng.random((S, L)) < 0.1] = np.nan
    b[rng.random((S, L)) < 0.05] = -0.0
    idx = np.nonzero(mask.reshape(-1))[0]
    keys_np = [(a.reshape(-1)[idx], False), (b.reshape(-1)[idx], True)]
    from pinot_tpu_torch.engine.values import Val, ValueEvaluator

    ev = ValueEvaluator.__new__(ValueEvaluator)
    keys = [ev.sort_key(Val(torch.from_numpy(v), "num", v.dtype), asc)
            for v, asc in keys_np]
    got = sel.ordered_rows(torch.from_numpy(idx), keys, L, S, k).numpy()
    want = []
    for s in range(S):
        rows = idx[idx // L == s]
        sub = [(v[idx // L == s], asc) for v, asc in keys_np]
        want.append(rows[_order_indices(sub)][:k])
    np.testing.assert_array_equal(got, np.concatenate(want))


# ---------------------------------------------------------------------------
# tests/test_queries.py through the port, behind its own fixture
# ---------------------------------------------------------------------------

def _query_tests() -> list:
    out = []
    for cname, cls in inspect.getmembers(test_queries, inspect.isclass):
        if not cname.startswith("Test"):
            continue
        for mname, fn in inspect.getmembers(cls, inspect.isfunction):
            if mname.startswith("test_"):
                out.append(f"{cname}::{mname}")
    return sorted(out)


@pytest.fixture(scope="module")
def queries_setup(tmp_path_factory):
    fixture = test_queries.setup
    make = getattr(fixture, "_get_wrapped_function", None)
    make = make() if make is not None else fixture.__wrapped__
    ref, con = make(tmp_path_factory)
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0
    for seg in ref.tables["baseballStats"].segments.values():
        port.add_segment("baseballStats", ImmutableSegment(seg.dir))
    return port, con


def _run(setup, name):
    cname, mname = name.split("::")
    cls = getattr(test_queries, cname)
    fn = getattr(cls(), mname)
    if "setup" in inspect.signature(fn).parameters:
        fn(setup)
    else:
        fn()


@pytest.mark.parametrize("name", _query_tests())
def test_queries_sql_through_the_port(queries_setup, name):
    _run(queries_setup, name)


def test_queries_sql_passes_39_of_40(queries_setup):
    """Named when one test was left for the next slice: now all 40
    pass."""
    names = _query_tests()
    failed = set()
    for name in names:
        try:
            _run(queries_setup, name)
        except Exception:  # noqa: BLE001 — a failing test, by its name
            failed.add(name)
    assert len(names) == 40
    assert failed == set()
