"""The digest and sketch aggregations on the port against the JAX package.

The JAX package's device refuses the PERCENTILE family, the theta
sketches, SUMPRECISION, MODE, IDSET, DISTINCTCOUNTRAWHLL,
DISTINCTCOUNTSMARTHLL and FASTHLL; its host path answers them, one
partial a segment folded in segment order. The port runs them on the card
in that path's shape (engine/sketches.py). Three segments written by the
JAX package's creator (dict and raw INT / LONG / FLOAT / DOUBLE columns,
NaN, -0.0 and +0.0 in a DOUBLE, a LONG past 2^53 and one whose span
passes 2^63, integral DOUBLE values) go into both engines; the reference
runs its Pallas tier in interpret mode, the port on the CPU, once through
the kernels' plain versions (gate 0) and once at the default gate.

Every aggregation runs scalar and grouped (a dict key, an expression key,
numGroupsLimit), under a filter, an all-pruned filter and an empty match.
Rows must be equal bit for bit: PERCENTILE* results and PERCENTILERAW*
strings, theta estimates, SUMPRECISION strings, MODE, IDSET and the HLL
family; every response stat must be equal. SUMPRECISION over non-integer
floats is refused in-band, naming e2b.

The single-value SQL of tests/test_agg_extended.py,
tests/test_nulls_percentile.py and tests/test_theta.py replays through
the port behind those files' own data.
"""

import base64
import gzip
import json
import math

import numpy as np
import pytest
import torch

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.datatable import decode as ref_decode
from pinot_tpu.engine.datatable import encode as ref_encode
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.ops import quantile_digest as ref_qd
from pinot_tpu.ops import theta as ref_theta
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import aggspec, sketches
from pinot_tpu_torch.engine.datatable import decode, encode
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.reduce import finalize
from pinot_tpu_torch.ops import digest, kernels
from pinot_tpu_torch.ops import sketch_build as sb
from pinot_tpu_torch.query.optimizer import optimize_query
from pinot_tpu_torch.sql.compiler import compile_query
from pinot_tpu_torch.storage.segment import ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numGroupsLimitReached", "totalDocs")
SIZES = (3000, 2500, 1800)
TS0 = 1_600_000_000

AGGS = {
    "percentile": "PERCENTILE(qty, 50)",
    "percentile_est": "PERCENTILEEST(price, 90)",
    "tdigest_nan_zeros": "PERCENTILETDIGEST(score, 25)",
    "smart_tdigest": "PERCENTILESMARTTDIGEST(big, 75, 'threshold=100')",
    "raw_est_float": "PERCENTILERAWEST(ratio, 50)",
    "raw_tdigest_zeros": "PERCENTILERAWTDIGEST(score, 50)",
    "raw_tdigest_expr": "PERCENTILERAWTDIGEST(qty * 2 + 1, 90, 50)",
    "raw_tdigest_long": "PERCENTILERAWTDIGEST(huge, 10)",
    "theta_string": "DISTINCTCOUNTTHETASKETCH(city)",
    "theta_trimmed": "DISTINCTCOUNTTHETASKETCH(big, 256)",
    "theta_raw_int": "DISTINCTCOUNTRAWTHETASKETCH(qty)",
    "theta_double": "DISTINCTCOUNTTHETASKETCH(score, 'nominalEntries=128')",
    "theta_set": ("DISTINCTCOUNTTHETASKETCH(grp, 'nominalEntries=16', "
                  "'city = ''c1''', 'qty > 20', 'SET_UNION($1, $2)')"),
    "theta_set_intersect": (
        "DISTINCTCOUNTTHETASKETCH(big, 'nominalEntries=64', 'grp < 20', "
        "'ratio > 0.3', 'SET_INTERSECT($1, $2)')"),
    "sumprecision_int": "SUMPRECISION(qty)",
    "sumprecision_long": "SUMPRECISION(big)",
    "sumprecision_past_2p53": "SUMPRECISION(huge)",
    "sumprecision_span_2p63": "SUMPRECISION(wide)",
    "sumprecision_whole_double": "SUMPRECISION(whole)",
    "sumprecision_expr": "SUMPRECISION(qty - 20)",
    "mode_int": "MODE(qty)",
    "mode_double_nan_zeros": "MODE(score)",
    "mode_float": "MODE(ratio)",
    "mode_dict_double": "MODE(level)",
    "idset_string": "IDSET(city)",
    "idset_int": "IDSET(qty)",
    "idset_double_zeros": "IDSET(level)",
    "rawhll_string": "DISTINCTCOUNTRAWHLL(city)",
    "rawhll_long": "DISTINCTCOUNTRAWHLL(big)",
    "smarthll_exact": "DISTINCTCOUNTSMARTHLL(qty)",
    "smarthll_switch": "DISTINCTCOUNTSMARTHLL(big, 100)",
    "smarthll_double": "DISTINCTCOUNTSMARTHLL(score, 40)",
    "smarthll_string": "DISTINCTCOUNTSMARTHLL(city, 5)",
    # past the threshold the sets' values hash at numpy's dtype for them:
    # an INT column's as int64, a FLOAT column's as float64
    "smarthll_int_widened": "DISTINCTCOUNTSMARTHLL(qty, 10)",
    "smarthll_float_widened": "DISTINCTCOUNTSMARTHLL(ratio, 50)",
    "fasthll": "FASTHLL(grp)",
    "fasthll_raw": "FASTHLL(qty)",
}

SHAPES = {
    "scalar": "SELECT {agg} FROM t",
    "filtered": "SELECT {agg} FROM t WHERE qty > 5 AND city <> 'c3'",
    "by_city": "SELECT city, {agg} FROM t GROUP BY city ORDER BY city",
    "by_expr": ("SELECT qty % 3, {agg} FROM t WHERE grp < 25 "
                "GROUP BY qty % 3 ORDER BY qty % 3"),
    "groups_limit": ("SET numGroupsLimit = 7; SELECT grp, {agg} FROM t "
                     "GROUP BY grp ORDER BY grp"),
    "all_pruned": f"SELECT {{agg}} FROM t WHERE ts > {TS0 + 10_000_000}",
    "empty_match": "SELECT city, {agg} FROM t WHERE qty > 1000 GROUP BY city",
}

CASES = sorted(f"{a}-{s}" for a in AGGS for s in SHAPES)


def _columns(n: int, seg: int, rng) -> dict:
    cities = np.array([f"c{i}" for i in range(12)])
    score = rng.normal(0, 1, n)
    score[rng.random(n) < 0.05] = np.nan
    score[rng.random(n) < 0.04] = -0.0
    score[rng.random(n) < 0.04] = 0.0
    wide = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64) * 2
    wide[:3] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, -5]
    return {
        "city": cities[rng.integers(0, 12, n)],
        "grp": rng.integers(0, 30, n).astype(np.int32),
        "ts": np.sort(TS0 + seg * 300 + rng.integers(0, 2000, n)
                      ).astype(np.int64),
        "level": np.array([-0.0, 0.0, 1.5, -2.25])[rng.integers(0, 4, n)],
        "qty": rng.integers(0, 40, n).astype(np.int32),
        "big": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "huge": (1 << 53) + rng.integers(0, 1000, n).astype(np.int64),
        "wide": wide,
        "ratio": rng.random(n).astype(np.float32),
        "price": 1000.0 + rng.integers(0, 500, n) * 1e-3,
        "whole": rng.integers(-1 << 40, 1 << 40, n).astype(np.float64),
        "score": score,
    }


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="t",
        dimensions=[("city", DataType.STRING), ("grp", DataType.INT),
                    ("ts", DataType.LONG), ("level", DataType.DOUBLE)],
        metrics=[("qty", DataType.INT), ("big", DataType.LONG),
                 ("huge", DataType.LONG), ("wide", DataType.LONG),
                 ("ratio", DataType.FLOAT), ("price", DataType.DOUBLE),
                 ("whole", DataType.DOUBLE), ("score", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        inverted_index_columns=["city"], bloom_filter_columns=["city"]))
    base = tmp_path_factory.mktemp("torch_sketches")
    rng = np.random.default_rng(23)
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(schema, _columns(n, i, rng), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def ref_engine(segment_dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in segment_dirs:
        eng.add_segment("t", RefSegment(d))
    return eng


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    eng = QueryEngine(device="cpu")
    if request.param is not None:
        eng.device.min_rows = request.param
    for d in segment_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    return eng


def _ungzip(x):
    """IDSET's base64 gzip blob, as the json text it holds: gzip stamps
    the second it ran in its header."""
    if isinstance(x, str) and x.startswith("H4sI"):
        return gzip.decompress(base64.b64decode(x)).decode()
    return x


def _same_value(x, y) -> bool:
    """Equal bit for bit: floats by repr (NaN, -0.0), the rest by value
    and type."""
    x, y = _ungzip(x), _ungzip(y)
    if isinstance(x, float) or isinstance(y, float):
        return type(x) is type(y) and repr(x) == repr(y)
    if isinstance(x, list) or isinstance(y, list):
        return isinstance(x, list) and isinstance(y, list) \
            and len(x) == len(y) and all(map(_same_value, x, y))
    return type(x) is type(y) and x == y


def assert_same_response(got, want):
    assert want["exceptions"] == [], want["exceptions"]
    assert got["exceptions"] == [], got["exceptions"]
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert _same_value(rows, ref_rows), (rows[:4], ref_rows[:4])
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


def _sql(case: str) -> str:
    agg, shape = case.rsplit("-", 1)
    return SHAPES[shape].format(agg=AGGS[agg])


@pytest.mark.parametrize("case", CASES)
def test_sketch_matches_reference(port_engine, ref_engine, case):
    sql = _sql(case)
    want = ref_engine.execute(sql)
    got = port_engine.execute(sql)
    if case.startswith("sumprecision_whole") and want["exceptions"]:
        pytest.fail(f"reference refused {sql}: {want['exceptions']}")
    assert_same_response(got, want)


MIXED_SQL = [
    "SELECT city, COUNT(*), PERCENTILE(qty, 50), SUM(qty), MIN(qty) FROM t "
    "GROUP BY city ORDER BY COUNT(*) DESC LIMIT 3",
    "SELECT city, PERCENTILETDIGEST(score, 50) FROM t GROUP BY city "
    "HAVING PERCENTILETDIGEST(score, 50) > 0 ORDER BY city",
    "SELECT grp, MODE(qty), SUMPRECISION(big), DISTINCTCOUNTTHETASKETCH(city) "
    "FROM t WHERE qty BETWEEN 3 AND 30 GROUP BY grp "
    "ORDER BY SUMPRECISION(big) LIMIT 5",
    "SELECT PERCENTILE(qty, 50) + 1, SUMPRECISION(qty), COUNT(*) FROM t "
    "WHERE city IN ('c1', 'c2')",
    "SELECT city, PERCENTILEEST(qty, 99), DISTINCTCOUNTHLL(qty), "
    "DISTINCTCOUNT(big), FIRSTWITHTIME(qty, ts, 'INT') FROM t "
    "GROUP BY city ORDER BY city LIMIT 4",
    "SELECT $segmentName, PERCENTILERAWTDIGEST(ratio, 50), IDSET(grp) FROM t "
    "GROUP BY $segmentName ORDER BY $segmentName",
    "SELECT qty % 5, MODE(score), DISTINCTCOUNTSMARTHLL(score, 10) FROM t "
    "GROUP BY qty % 5 ORDER BY MODE(score) DESC",
]


@pytest.mark.parametrize("sql", MIXED_SQL)
def test_sketches_beside_other_aggregations(port_engine, ref_engine, sql):
    """Sketches in one query with the pipeline's aggregations, under
    ORDER BY, HAVING and LIMIT on either kind, and post-aggregation
    arithmetic: the group-by skips the on-device trim and the reduce
    orders the reference's partials."""
    assert_same_response(port_engine.execute(sql), ref_engine.execute(sql))


def test_cases_have_rows(ref_engine):
    """The table reaches what each case is for: matched rows where the
    shape keeps some, groups past numGroupsLimit, digests over NaN and
    both zeros, a trimmed theta sketch and a SMARTHLL past its
    threshold."""
    for agg in ("percentile", "mode_int"):
        for shape in ("scalar", "filtered", "by_city", "by_expr",
                      "groups_limit"):
            resp = ref_engine.execute(_sql(f"{agg}-{shape}"))
            assert resp["numDocsScanned"] > 0
            assert resp["resultTable"]["rows"]
    resp = ref_engine.execute(_sql("percentile-groups_limit"))
    assert resp["numGroupsLimitReached"]
    assert ref_engine.execute(_sql("percentile-all_pruned"))[
        "numSegmentsPrunedByServer"] == len(SIZES)
    raw = ref_engine.execute(_sql("raw_tdigest_zeros-scalar"))
    d = json.loads(base64.b64decode(raw["resultTable"]["rows"][0][0]))
    assert sum(d["weights"]) < sum(SIZES)     # NaN dropped
    exact = ref_engine.execute(
        "SELECT DISTINCTCOUNT(big) FROM t")["resultTable"]["rows"][0][0]
    est = ref_engine.execute(_sql("theta_trimmed-scalar"))[
        "resultTable"]["rows"][0][0]
    assert est != exact     # estimated: the sketch was trimmed
    assert ref_engine.execute(_sql("smarthll_switch-scalar"))[
        "resultTable"]["rows"][0][0] != exact


@pytest.mark.parametrize("shape", ["scalar", "by_city"])
def test_sumprecision_non_integer_floats_in_band(port_engine, ref_engine,
                                                 shape):
    """Non-integer floats, once refused in-band (item e2b), now answer
    the reference's exact decimal strings, character for character."""
    sql = SHAPES[shape].format(agg="SUMPRECISION(price)")
    assert_same_response(port_engine.execute(sql), ref_engine.execute(sql))


def test_mode_over_strings_is_refused_like_the_reference(port_engine,
                                                         ref_engine):
    sql = "SELECT MODE(city) FROM t"
    assert ref_engine.execute(sql)["exceptions"]
    (exc,) = port_engine.execute(sql)["exceptions"]
    assert "MODE requires a numeric column" in exc["message"]


HIGH_CARD_SQL = [
    # every row its own group in most segments: ~7,300 groups, ~7,300
    # (segment, group) runs each
    "SET numGroupsLimit = 1000000; SELECT big, SUMPRECISION(qty), "
    "PERCENTILETDIGEST(score, 50), DISTINCTCOUNTSMARTHLL(qty, 0) FROM t "
    "GROUP BY big ORDER BY big LIMIT 40",
    "SELECT ts, SUMPRECISION(wide), MODE(qty) FROM t GROUP BY ts "
    "ORDER BY ts DESC LIMIT 25",
]


@pytest.mark.parametrize("sql", HIGH_CARD_SQL)
def test_high_cardinality_group_bys(port_engine, ref_engine, sql):
    assert_same_response(port_engine.execute(sql), ref_engine.execute(sql))


ROUTE_SQL = {
    "SELECT SUMPRECISION(big) FROM t": "group_plane_sums",
    "SELECT city, SUMPRECISION(wide) FROM t GROUP BY city":
        "group_plane_sums",
    "SELECT DISTINCTCOUNTRAWHLL(qty) FROM t": "hll_register_max",
    "SELECT grp, DISTINCTCOUNTRAWHLL(city) FROM t GROUP BY grp":
        "hll_register_max",
    "SELECT city, DISTINCTCOUNTSMARTHLL(big, 10) FROM t GROUP BY city":
        "hll_register_max",
    "SELECT PERCENTILE(qty, 50) FROM t": "cluster_sums",
}


@pytest.mark.parametrize("sql", sorted(ROUTE_SQL))
def test_sketches_call_their_kernel_below_the_row_gate(
        monkeypatch, segment_dirs, ref_engine, sql):
    """The reference's device has no form for these aggregations, so its
    row gate (PALLAS_MIN_ROWS) and accumulator regimes do not apply: at
    the engine's default gate, with 7,300 rows, each reaches its
    kernel's wrapper (which runs the plain version on CPU tensors)."""
    eng = QueryEngine(device="cpu")
    assert eng.device.min_rows > sum(SIZES)
    for d in segment_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    calls = []
    name = ROUTE_SQL[sql]
    real = getattr(kernels, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, name, spy)
    assert_same_response(eng.execute(sql), ref_engine.execute(sql))
    assert calls


def test_fold_refuses_a_run_without_a_result_row():
    """A per-segment partial whose group has no row in the result fails
    instead of merging into another group's row."""
    spec = aggspec.make_spec(compile_query(
        "SELECT SUMPRECISION(qty) FROM t").aggregations()[0])
    part = {"psum": np.array([5, 7], dtype=object)}
    acc = sketches._fold(spec, 4, np.array([1, 3]),
                         [(np.array([1, 3]), part)])
    assert acc["psum"].tolist() == [5, 7]
    with pytest.raises(AssertionError, match="no row in the result"):
        sketches._fold(spec, 4, np.array([1, 3]), [(np.array([0, 3]), part)])


# ---------------------------------------------------------------------------
# the wire: the new partials through the port's engine/datatable.py
# ---------------------------------------------------------------------------

WIRE_SQL = [
    "SELECT city, PERCENTILE(score, 50), PERCENTILERAWTDIGEST(qty, 90) "
    "FROM t GROUP BY city ORDER BY city",
    "SELECT city, DISTINCTCOUNTTHETASKETCH(big, 64), MODE(score), "
    "IDSET(level), SUMPRECISION(huge) FROM t GROUP BY city ORDER BY city",
    "SELECT DISTINCTCOUNTSMARTHLL(big, 100), DISTINCTCOUNTRAWHLL(qty), "
    "DISTINCTCOUNTTHETASKETCH(grp, 'nominalEntries=16', 'city = ''c1''', "
    "'qty > 20', 'SET_DIFF($1, $2)') FROM t",
]


@pytest.mark.parametrize("sql", WIRE_SQL)
def test_wire_roundtrip_of_the_new_partials(segment_dirs, ref_engine, sql):
    """Per-segment partials of the port cross the wire (encode / decode)
    and merge to the reference's answer: the merge runs the reference's
    fold over them."""
    from pinot_tpu_torch.engine.reduce import merge_intermediates

    port = QueryEngine(device="cpu")
    segs = [ImmutableSegment(d) for d in segment_dirs]
    q = optimize_query(compile_query(sql))
    parts = [decode(encode(port.execute_segments(q, [s]))) for s in segs]
    rows = finalize(q, merge_intermediates(q, parts)).rows
    want = ref_engine.execute(sql)["resultTable"]["rows"]
    assert _same_value([list(r) for r in rows], want)


def test_port_partials_decode_in_the_reference(segment_dirs):
    """The port's wire bytes are the reference's format."""
    port = QueryEngine(device="cpu")
    q = optimize_query(compile_query(WIRE_SQL[1]))
    blob = encode(port.execute_segments(q, [ImmutableSegment(
        segment_dirs[0])]))
    ref = ref_decode(blob)
    assert ref_encode(ref) == blob


# ---------------------------------------------------------------------------
# the digest build: schedule and K5's plain version against compress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", [100.0, 200.0, 400.0])
def test_schedule_is_compress_weights(delta):
    for n in range(1, 5001):
        w = ref_qd.compress(np.zeros(n), np.ones(n), delta)[1]
        assert digest.schedule(n, delta) == tuple(w.tolist()), n


@pytest.mark.parametrize("n", [54_321, 200_000, 1_000_000])
def test_schedule_is_compress_weights_large(n):
    for delta in (100.0, 200.0, 400.0):
        w = ref_qd.compress(np.zeros(n), np.ones(n), delta)[1]
        assert digest.schedule(n, delta) == tuple(w.tolist())


@pytest.mark.parametrize("seed", range(6))
def test_plain_cluster_sums_are_add_values_means(seed):
    """K5's plain version and the schedule give ``add_values``' means bit
    for bit: normal, heavy-tailed and zero-heavy values (runs of -0.0)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 30_000))
    v = [rng.normal(0, 1e6, n), rng.lognormal(3, 4, n) * rng.choice(
        [-1, 1], n), rng.choice([-0.0, 0.0, 3.5, -1e-300, 2e16], n)][seed % 3]
    for delta in (100.0, 200.0):
        m, w = ref_qd.add_values([], [], v, delta)
        sizes = digest.schedule(n, delta)
        off = np.concatenate([[0], np.cumsum(sizes)])
        sums = kernels.cluster_sums(torch.from_numpy(np.sort(v, kind="stable")),
                                    torch.from_numpy(off))
        means = sums / torch.tensor(sizes, dtype=torch.float64)
        assert list(sizes) == w.tolist()
        assert means.numpy().tobytes() == m.tobytes()


def test_plain_cluster_sums_keep_minus_zero():
    v = torch.tensor([-0.0, -0.0, -0.0, 0.0, 1.0, -1.0], dtype=torch.float64)
    off = torch.tensor([0, 2, 4, 6])
    got = kernels.cluster_sums(v, off)
    assert [math.copysign(1, x) for x in got.tolist()] == [-1, 1, 1]
    assert got.tolist() == [0.0, 0.0, 0.0]


def test_schedule_is_scalar_compress_loop():
    """The schedule's per-cluster jump equals compress's value-by-value
    loop, which it replaces (a few N past the ones above)."""
    for n in (2_000_003, 12_500_000 // 7):
        sizes = digest.schedule(n, 200.0)
        assert sum(sizes) == n
        assert max(sizes) <= math.ceil(n * math.pi / 200.0) + 1


# ---------------------------------------------------------------------------
# the hashes and the KMV build against the reference's numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "float32", "float64", "uint8", "bool"])
def test_hash63_at_each_dtype(dtype):
    rng = np.random.default_rng(3)
    if np.dtype(dtype).kind == "f":
        v = rng.normal(0, 1e5, 2000)
        v[:4] = [0.0, -0.0, np.nan, np.inf]   # both zeros, NaN: their bits
    else:   # the type's whole range: signed values sign-extend
        lo, hi = (0, 1) if dtype == "bool" else (np.iinfo(dtype).min,
                                                 np.iinfo(dtype).max)
        v = rng.integers(lo, hi, 2000, dtype=np.int64, endpoint=True)
    v = v.astype(dtype)
    got = sb.hash63(sb.hash32_values(torch.from_numpy(v), v.dtype))
    np.testing.assert_array_equal(got.numpy(), ref_theta.hash63(v))


def test_kmv_is_theta_build_per_run():
    rng = np.random.default_rng(5)
    rk = np.sort(rng.integers(0, 6, 5000))
    h = ref_theta.hash63(rng.integers(0, 900, 5000))
    rk_k, h_k, rk_t, th = (t.numpy() for t in sb.kmv(
        torch.from_numpy(rk), torch.from_numpy(h), 100))
    for r in range(6):
        want_th, want_h = ref_theta.build(
            rng.integers(0, 1, 0), 100) if not (rk == r).any() else \
            ref_theta.trim(int(ref_theta.MAX_HASH),
                           np.unique(h[rk == r]), 100)
        np.testing.assert_array_equal(h_k[rk_k == r], want_h)
        got_th = th[rk_t == r]
        assert (int(got_th[0]) if len(got_th) else
                int(ref_theta.MAX_HASH)) == want_th


# ---------------------------------------------------------------------------
# the single-value SQL of test_agg_extended.py, test_nulls_percentile.py and
# test_theta.py through the port, behind those files' own data
# ---------------------------------------------------------------------------


class _PortEngine(QueryEngine):
    """The port's engine behind the reference's constructor: the
    segments the reference's creator wrote are reopened by the port."""

    def __init__(self, device_executor=None, **_kw):
        super().__init__(device="cpu")
        self.device.min_rows = 0

    def add_segment(self, table, seg):
        super().add_segment(table, ImmutableSegment(seg.dir))

    def execute_segments(self, q, segments, **kw):
        return super().execute_segments(
            q, [ImmutableSegment(s.dir) for s in segments], **kw)


def _port_modules(monkeypatch, *modules):
    """Route the names a replayed test reads from the reference's
    modules at call time to the port's: its engine, and the compile,
    wire and reduce steps of its server-style tests."""
    from pinot_tpu.engine import datatable as ref_datatable
    from pinot_tpu.engine import reduce as ref_reduce
    from pinot_tpu.query import optimizer as ref_optimizer
    from pinot_tpu.sql import compiler as ref_compiler
    from pinot_tpu_torch.engine.reduce import merge_intermediates

    for m in modules:
        monkeypatch.setattr(m, "QueryEngine", _PortEngine)
    monkeypatch.setattr(ref_datatable, "encode", encode)
    monkeypatch.setattr(ref_datatable, "decode", decode)
    monkeypatch.setattr(ref_reduce, "finalize", finalize)
    monkeypatch.setattr(ref_reduce, "merge_intermediates",
                        merge_intermediates)
    monkeypatch.setattr(ref_optimizer, "optimize_query", optimize_query)
    monkeypatch.setattr(ref_compiler, "compile_query", compile_query)


AGG_EXTENDED_SV = ("test_sumprecision_exact", "test_idset_roundtrip",
                   "test_smart_hll_exact_below_threshold",
                   "test_smart_hll_switches_above_threshold",
                   "test_raw_hll_blob", "test_raw_tdigest_blob",
                   "test_smart_tdigest_parameters_string",
                   "test_fasthll_alias")


@pytest.fixture(scope="module")
def agg_extended_port(tmp_path_factory):
    import test_agg_extended

    mp = pytest.MonkeyPatch()
    mp.setattr(test_agg_extended, "QueryEngine", _PortEngine)
    try:
        fixture = test_agg_extended.engine
        make = getattr(fixture, "_get_wrapped_function", None)
        make = make() if make is not None else fixture.__wrapped__
        yield make(tmp_path_factory)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", AGG_EXTENDED_SV)
def test_agg_extended_sql_through_the_port(agg_extended_port, name):
    import test_agg_extended

    eng, _cols = agg_extended_port
    assert isinstance(eng, _PortEngine)
    getattr(test_agg_extended.TestExtendedAggs(), name)(agg_extended_port)


def test_sumprecision_past_float53_through_the_port(monkeypatch, tmp_path):
    import test_agg_extended

    _port_modules(monkeypatch, test_agg_extended)
    test_agg_extended.TestExtendedAggs().test_sumprecision_past_float53(
        tmp_path)


@pytest.mark.parametrize("name", ["test_group_by_percentile_through_engine",
                                  "test_wire_roundtrip_of_digest_partials"])
def test_nulls_percentile_sql_through_the_port(monkeypatch, tmp_path, name):
    import test_nulls_percentile

    _port_modules(monkeypatch, test_nulls_percentile)
    getattr(test_nulls_percentile.TestQuantileDigest(), name)(tmp_path)


@pytest.mark.parametrize("name", ["test_group_by_and_wire_roundtrip",
                                  "test_scalar_through_sql"])
def test_theta_sql_through_the_port(monkeypatch, tmp_path, name):
    import test_theta

    _port_modules(monkeypatch, test_theta)
    getattr(test_theta.TestThetaThroughEngine(), name)(tmp_path)


@pytest.mark.parametrize("name", ["test_sql_set_ops_exact_mode_match_oracle",
                                  "test_sql_set_ops_groupby_and_approx",
                                  "test_bad_ref_rejected"])
def test_theta_set_form_through_the_port(monkeypatch, tmp_path, name):
    """test_theta.py's set-form SQL over its rows, written as a sealed
    segment: consuming segments come with a later slice of the port."""
    import test_theta

    def engine(_self, rows):
        schema = Schema.build(
            name="ev",
            dimensions=[("dim", DataType.STRING), ("uid", DataType.INT)],
            metrics=[("m", DataType.INT)])
        cols = {"dim": np.array([r["dim"] for r in rows]),
                "uid": np.array([r["uid"] for r in rows], dtype=np.int32),
                "m": np.array([r["m"] for r in rows], dtype=np.int32)}
        out = str(tmp_path / f"ev{len(rows)}")
        eng = _PortEngine()
        eng.add_segment("ev", build_segment(
            schema, cols, out, TableConfig(table_name="ev"), "s"))
        return eng

    monkeypatch.setattr(test_theta.TestThetaSetOps, "_engine", engine)
    getattr(test_theta.TestThetaSetOps(), name)()
