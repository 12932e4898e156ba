"""DISTINCT, group keys over expressions, raw and virtual columns,
DISTINCTCOUNT over raw columns and FIRST/LASTWITHTIME: the port against
the JAX package.

DISTINCT over dict columns and FIRST/LASTWITHTIME over dict keys run on
the reference's device; the other shapes here run on its host path. The
port runs all of them on the card (engine/device.py, engine/rows.py).
Three segments written by the JAX package's creator go into both engines
(the reference's Pallas tier in interpret mode, the port on the CPU with
its kernel gate at 0 rows and at its default). Rows, the dataSchema and
every response stat must be equal: integers, strings, order and stats
bit for bit, floats per ``_rows_close`` (rtol 1e-5). The ops
(ops/selection.py, the with-time scatters of ops/agg.py) are held against
the host's numpy forms on seeded inputs, and the mergeable (non-terminal)
partials against the reference's.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.engine.host import factorize_multi
from pinot_tpu.sql.compiler import compile_query as ref_compile
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import agg as agg_ops
from pinot_tpu_torch.ops import selection as sel
from pinot_tpu_torch.sql.compiler import compile_query
from pinot_tpu_torch.storage.segment import ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numGroupsLimitReached", "totalDocs")
SIZES = (4000, 3000, 2000)

SQL = {
    # DISTINCT over dict columns: the reference's device shape
    "distinct_dict": "SELECT DISTINCT city FROM t ORDER BY city",
    "distinct_dict_two": ("SELECT DISTINCT city, grp FROM t WHERE qty < 10 "
                          "ORDER BY city, grp LIMIT 50"),
    "distinct_dict_unordered": "SELECT DISTINCT grp FROM t LIMIT 100",
    # DISTINCT in the host path's shape
    "distinct_raw": ("SELECT DISTINCT qty FROM t WHERE grp = 3 "
                     "ORDER BY qty LIMIT 100"),
    "distinct_expression": ("SELECT DISTINCT qty % 5, city FROM t "
                            "ORDER BY city DESC, qty % 5 LIMIT 30"),
    "distinct_double": ("SELECT DISTINCT price FROM t WHERE qty = 3 "
                        "ORDER BY price DESC LIMIT 20"),
    "distinct_nan": "SELECT DISTINCT score FROM t WHERE qty = 7 LIMIT 1000",
    "distinct_segment": "SELECT DISTINCT $segmentName FROM t",
    "distinct_host_city": ("SELECT DISTINCT $hostName, city FROM t "
                           "ORDER BY city LIMIT 4"),
    "distinct_empty": "SELECT DISTINCT qty FROM t WHERE qty > 999",
    "distinct_all_pruned": ("SELECT DISTINCT qty FROM t "
                            "WHERE city = 'nowhere'"),
    # group keys over expressions, raw and virtual columns
    "gb_expression_trim": (
        "SELECT qty % 7, COUNT(*), SUM(big), MIN(price), MAX(qty), "
        "AVG(ratio) FROM t GROUP BY qty % 7 ORDER BY SUM(big) DESC LIMIT 5"),
    "gb_raw_key": ("SELECT qty, COUNT(*), SUM(qty) FROM t GROUP BY qty "
                   "ORDER BY qty LIMIT 100"),
    "gb_double_key": ("SELECT price, COUNT(*) FROM t WHERE qty < 3 "
                      "GROUP BY price ORDER BY price LIMIT 30"),
    "gb_segment": ("SELECT $segmentName, COUNT(*), MAX(qty), "
                   "MINMAXRANGE(big) FROM t GROUP BY $segmentName "
                   "ORDER BY $segmentName"),
    "gb_segment_city": (
        "SELECT $segmentName, city, COUNT(*) FROM t WHERE grp < 3 "
        "GROUP BY $segmentName, city ORDER BY COUNT(*) DESC, city LIMIT 10"),
    "gb_case": (
        "SELECT CASE WHEN qty > 20 THEN 'hi' ELSE 'lo' END, COUNT(*), "
        "SUM(qty) FROM t GROUP BY CASE WHEN qty > 20 THEN 'hi' ELSE 'lo' END"),
    "gb_limit_raw": ("SET numGroupsLimit = 7; SELECT qty, COUNT(*), "
                     "SUM(big) FROM t GROUP BY qty LIMIT 1000"),
    "gb_limit_two_keys": (
        "SET numGroupsLimit = 5; SELECT qty % 10, grp, COUNT(*) FROM t "
        "GROUP BY qty % 10, grp ORDER BY COUNT(*) DESC, grp LIMIT 20"),
    "gb_virtual_sum": ("SELECT $docId % 3, COUNT(*), SUM($docId) FROM t "
                       "GROUP BY $docId % 3 ORDER BY 1"),
    "gb_having": ("SELECT qty % 9, COUNT(*) FROM t GROUP BY qty % 9 "
                  "HAVING COUNT(*) > 1000 ORDER BY 1"),
    "gb_empty": ("SELECT qty % 3, COUNT(*) FROM t WHERE qty > 999 "
                 "GROUP BY qty % 3"),
    "gb_all_pruned": ("SELECT qty, COUNT(*) FROM t WHERE city = 'nowhere' "
                      "GROUP BY qty"),
    # DISTINCTCOUNT over raw columns
    "dc_raw_grouped": (
        "SELECT grp, DISTINCTCOUNT(qty), DISTINCTCOUNT(price), COUNT(*) "
        "FROM t WHERE city <> 'c1' GROUP BY grp ORDER BY grp LIMIT 40"),
    "dc_raw_scalar": ("SELECT DISTINCTCOUNT(qty), DISTINCTCOUNTBITMAP(price), "
                      "COUNT(*) FROM t WHERE grp > 20"),
    "dc_raw_nan": ("SELECT grp, DISTINCTCOUNT(score), COUNT(*) FROM t "
                   "WHERE qty < 20 GROUP BY grp ORDER BY grp LIMIT 40"),
    "dc_nan_scalar": "SELECT DISTINCTCOUNT(score), COUNT(*) FROM t",
    "dc_expression_key": (
        "SELECT qty % 4, SEGMENTPARTITIONEDDISTINCTCOUNT(big) FROM t "
        "GROUP BY qty % 4 ORDER BY 1"),
    # FIRST/LASTWITHTIME: time ties (ts repeats), NaN values
    "with_time_dict_key": (
        "SELECT city, FIRSTWITHTIME(qty, ts, 'INT'), "
        "LASTWITHTIME(price, ts, 'DOUBLE'), LASTWITHTIME(score, ts) "
        "FROM t GROUP BY city ORDER BY city"),
    "with_time_expression_key": (
        "SELECT qty % 4, FIRSTWITHTIME(score, ts), "
        "LASTWITHTIME(city, ts, 'STRING'), FIRSTWITHTIME(price, ts) "
        "FROM t GROUP BY qty % 4 ORDER BY 1"),
    "with_time_scalar": ("SELECT FIRSTWITHTIME(big, ts, 'LONG'), "
                         "LASTWITHTIME(qty, grp, 'INT') FROM t "
                         "WHERE city = 'c2'"),
    "with_time_empty": ("SELECT LASTWITHTIME(qty, ts, 'INT') FROM t "
                        "WHERE qty > 999"),
    # a virtual column in the filter sends a dict-key query to the host
    # path's shape, numGroupsLimit included
    "virtual_filter_dict_key": (
        "SELECT city, COUNT(*) FROM t WHERE $segmentName = 's1' "
        "GROUP BY city ORDER BY city"),
    "virtual_filter_limit": (
        "SET numGroupsLimit = 3; SELECT city, COUNT(*) FROM t "
        "WHERE $docId >= 0 GROUP BY city ORDER BY city"),
    "virtual_filter_distinct_dict": (
        "SELECT DISTINCT grp, $segmentName FROM t WHERE grp < 2 "
        "ORDER BY grp, $segmentName"),
    "scalar_virtual": ("SELECT MAX($docId), MIN($docId), COUNT(*) FROM t "
                       "WHERE city = 'c2'"),
    # keys past the offset coding's span, float keys, two raw keys
    "gb_wide_key": (
        "SELECT big % 1000000007, COUNT(*) FROM t "
        "GROUP BY big % 1000000007 ORDER BY COUNT(*) DESC, 1 LIMIT 5"),
    "gb_double_desc_nan": ("SELECT score, COUNT(*) FROM t GROUP BY score "
                           "ORDER BY score DESC LIMIT 5"),
    "gb_double_asc_nan": ("SELECT score, COUNT(*) FROM t GROUP BY score "
                          "ORDER BY score LIMIT 5"),
    "gb_float_key": ("SELECT qty / 3, COUNT(*) FROM t GROUP BY qty / 3 "
                     "ORDER BY 1 LIMIT 5"),
    "gb_cast_key": ("SELECT CAST(price AS INT), COUNT(*) FROM t "
                    "GROUP BY CAST(price AS INT) ORDER BY 1"),
    "gb_two_keys": ("SELECT grp, qty, COUNT(*) FROM t GROUP BY grp, qty "
                    "ORDER BY COUNT(*) DESC, grp, qty LIMIT 7"),
}
# queries whose group ids reach K1 at the gate of 0: dict DISTINCT in
# the reference's device shape, factorized keys in its host path's shape
K1_QUERIES = ("distinct_dict", "distinct_dict_two", "gb_segment",
              "gb_expression_trim")


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


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


def _columns(n: int, rng) -> dict:
    score = rng.normal(0, 1, n)
    score[rng.random(n) < 0.1] = np.nan
    return {
        "city": np.array([f"c{i}" for i in range(12)])[
            rng.integers(0, 12, n)],
        "grp": rng.integers(0, 30, n).astype(np.int32),
        "ts": rng.integers(0, 60, n).astype(np.int64),   # heavy time ties
        "qty": rng.integers(0, 40, n).astype(np.int32),
        "big": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "ratio": rng.random(n).astype(np.float32),
        "price": 1000.0 + rng.integers(0, 50, n) * 1e-10
        + rng.integers(0, 3, n),
        "score": score,
    }


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    schema = Schema.build(
        name="t",
        dimensions=[("city", DataType.STRING), ("grp", DataType.INT)],
        metrics=[("ts", DataType.LONG), ("qty", DataType.INT),
                 ("big", DataType.LONG), ("ratio", DataType.FLOAT),
                 ("price", DataType.DOUBLE), ("score", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        inverted_index_columns=["grp"], bloom_filter_columns=["city"]))
    base = tmp_path_factory.mktemp("torch_group_keys")
    rng = np.random.default_rng(23)
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(schema, _columns(n, rng), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def ref_engine(segment_dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in segment_dirs:
        eng.add_segment("t", RefSegment(d))
    return eng


@pytest.fixture(scope="module")
def ref_responses(ref_engine):
    return {k: ref_engine.execute(sql) for k, sql in SQL.items()}


def _port(segment_dirs, min_rows=None):
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in segment_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    return eng


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    return _port(segment_dirs, request.param)


@pytest.mark.parametrize("name", sorted(SQL))
def test_matches_reference(port_engine, ref_responses, name):
    want = ref_responses[name]
    got = port_engine.execute(SQL[name])
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert _rows_close(rows, ref_rows), (rows[:6], ref_rows[:6])
    if "DOUBLE" not in want["resultTable"]["dataSchema"]["columnDataTypes"]:
        assert rows == ref_rows
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


def test_double_key_sees_below_float32_spacing(port_engine, ref_responses):
    rows = port_engine.execute(SQL["gb_double_key"])["resultTable"]["rows"]
    prices = [r[0] for r in rows]
    assert len({np.float32(p) for p in prices}) < len(prices)
    assert rows == ref_responses["gb_double_key"]["resultTable"]["rows"]


@pytest.mark.parametrize("name", ["gb_double_desc_nan", "gb_double_asc_nan",
                                  "gb_expression_trim"])
def test_trim_matches_untrimmed(port_engine, ref_responses, name):
    """The on-device ORDER BY trim of a factorized table keeps the groups
    the untrimmed table gives (``SET useDeviceReduce = false``): a NaN
    float key sorts last in both directions, as the host orders it."""
    trimmed = port_engine.execute(SQL[name])
    plain = port_engine.execute("SET useDeviceReduce = false; " + SQL[name])
    rows = trimmed["resultTable"]["rows"]
    assert str(rows) == str(plain["resultTable"]["rows"])
    assert str(rows) == str(ref_responses[name]["resultTable"]["rows"])
    assert len(rows) == 5 and all(not np.isnan(r[0]) for r in rows)
    assert port_engine.device.device_reduce_queries > 0


def test_group_ids_reach_the_kernels(segment_dirs, monkeypatch):
    """At the gate of 0 the factorized group id feeds K1 (counts, sums)
    and K2 (MIN / MAX) as the dict group keys do; DISTINCT over dict
    columns takes its presence from K1's count channel."""
    from pinot_tpu_torch.ops import group_scatter, groupby_mm

    calls = []
    for mod, entry in ((group_scatter, "plane_group_sums"),
                       (groupby_mm, "group_sums"),
                       (group_scatter, "group_minmax_sources")):
        real = getattr(mod, entry)

        def spy(*a, _real=real, _entry=entry, **k):
            calls.append(_entry)
            return _real(*a, **k)
        monkeypatch.setattr(mod, entry, spy)
    eng = _port(segment_dirs, 0)
    for name in K1_QUERIES:
        calls.clear()
        assert eng.execute(SQL[name])["exceptions"] == []
        assert {"plane_group_sums", "group_sums"} & set(calls), name
        if name in ("gb_segment", "gb_expression_trim"):
            assert "group_minmax_sources" in calls, name


@pytest.mark.parametrize("sql", [
    "SELECT grp, DISTINCTCOUNT(qty), COUNT(*) FROM t WHERE qty < 30 "
    "GROUP BY grp",
    "SELECT qty % 5, DISTINCTCOUNT(price) FROM t GROUP BY qty % 5",
    "SELECT DISTINCTCOUNT(big) FROM t WHERE grp = 4",
    "SELECT grp, DISTINCTCOUNT(score) FROM t WHERE qty < 9 GROUP BY grp",
])
def test_non_terminal_distinct_sets_match_reference(segment_dirs,
                                                    ref_engine, sql):
    """Without ``terminal`` the partial is the mergeable value sets, equal
    to the reference host path's merged sets: the same numbers, and as
    many NaN members, each NaN row one (NaN equals no NaN)."""

    def members(values):
        nums = {x for x in values if not (isinstance(x, float) and x != x)}
        return nums, len(values) - len(nums)

    port = _port(segment_dirs)
    got = port.execute_segments(compile_query(sql), table_segs(port, "t"))
    want = ref_engine.execute_segments(
        ref_compile(sql), table_segs(ref_engine, "t"))
    for g, w in zip(got.group_keys or (), want.group_keys or ()):
        np.testing.assert_array_equal(g, w)
    sets = [(pg, pw) for pg, pw in zip(got.agg_partials, want.agg_partials)
            if "sets" in pw]
    assert sets
    for pg, pw in sets:
        assert len(pg["sets"]) == len(pw["sets"])
        for a, b in zip(pg["sets"], pw["sets"]):
            assert members(a) == members(b)
    assert got.stats.num_docs_scanned == want.stats.num_docs_scanned


# ---------------------------------------------------------------------------
# tests/test_firstlast.py's shapes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def firstlast_dirs(tmp_path_factory):
    """test_firstlast.py's table: LONG values over a small time range, so
    most (key, time) pairs tie; and its NaN and string-valued tables."""
    tmp = tmp_path_factory.mktemp("torch_firstlast")
    schema = Schema.build(
        name="t", dimensions=[("k", DataType.STRING)],
        metrics=[("v", DataType.LONG), ("ts", DataType.LONG)])
    rng = np.random.default_rng(7)
    df = pd.DataFrame({
        "k": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, 5000)],
        "v": rng.integers(-50, 50, 5000).astype(np.int64),
        "ts": rng.integers(0, 40, 5000).astype(np.int64),
    })
    out = {"t": [], "n": [], "s": [], "big": []}
    for i in range(3):
        part = df.iloc[i * 1700: (i + 1) * 1700]
        d = os.path.join(str(tmp), f"s{i}")
        build_segment(schema, {c: part[c].to_numpy() for c in part}, d,
                      segment_name=f"s{i}")
        out["t"].append(d)
    schema_n = Schema.build(
        name="n", dimensions=[("k", DataType.STRING)],
        metrics=[("v", DataType.DOUBLE), ("ts", DataType.LONG)])
    d = os.path.join(str(tmp), "n0")
    build_segment(schema_n, {"k": np.array(["a", "a", "a", "b"]),
                             "v": np.array([np.nan, 5.0, 1.0, np.nan]),
                             "ts": np.array([7, 7, 3, 9], dtype=np.int64)},
                  d, segment_name="n0")
    out["n"].append(d)
    schema_s = Schema.build(
        name="s", dimensions=[("k", DataType.STRING),
                              ("who", DataType.STRING)],
        metrics=[("ts", DataType.LONG)])
    d = os.path.join(str(tmp), "w0")
    build_segment(schema_s, {
        "k": np.array(["x", "x", "y", "y", "y"]),
        "who": np.array(["ann", "bob", "cat", "dan", "eve"]),
        "ts": np.array([5, 9, 2, 7, 7], dtype=np.int64)}, d,
        segment_name="w0")
    out["s"].append(d)
    # LONG values past 2^53, which float64 cannot hold
    schema_b = Schema.build(
        name="big", dimensions=[("k", DataType.STRING)],
        metrics=[("v", DataType.LONG), ("ts", DataType.LONG)])
    base = (1 << 53) + 1
    big = pd.DataFrame({
        "k": ["a", "a", "a", "b", "b"],
        "v": np.array([base, base + 2, 7, -base - 4, 11], dtype=np.int64),
        "ts": np.array([5, 9, 1, 3, 2], dtype=np.int64)})
    for i in range(2):
        d = os.path.join(str(tmp), f"b{i}")
        build_segment(schema_b, {c: big.iloc[i::2][c].to_numpy()
                                 for c in big}, d, segment_name=f"b{i}")
        out["big"].append(d)
    return out


FIRSTLAST_SQL = [
    ("t", "SELECT k, FIRSTWITHTIME(v, ts, 'LONG') FROM t GROUP BY k "
          "ORDER BY k"),
    ("t", "SELECT k, LASTWITHTIME(v, ts, 'LONG'), FIRSTWITHTIME(v, ts, "
          "'LONG') FROM t GROUP BY k ORDER BY k"),
    ("t", "SELECT LASTWITHTIME(v, ts, 'LONG'), FIRSTWITHTIME(v, ts, 'LONG') "
          "FROM t WHERE k = 'b'"),
    ("t", "SELECT LASTWITHTIME(v, ts, 'LONG') FROM t "
          "WHERE k = 'zzz_not_there'"),
    ("n", "SELECT k, LASTWITHTIME(v, ts, 'DOUBLE') FROM n GROUP BY k "
          "ORDER BY k"),
    ("s", "SELECT k, LASTWITHTIME(who, ts, 'STRING') FROM s GROUP BY k "
          "ORDER BY k"),
    ("s", "SELECT FIRSTWITHTIME(who, ts, 'STRING') FROM s"),
    # the host path's shape carries LONG values exactly
    ("big", "SELECT $segmentName, LASTWITHTIME(v, ts, 'LONG'), "
            "FIRSTWITHTIME(v, ts, 'LONG') FROM big GROUP BY $segmentName "
            "ORDER BY 1"),
    ("big", "SELECT LASTWITHTIME(v, ts, 'LONG'), FIRSTWITHTIME(v, ts, "
            "'LONG') FROM big WHERE $docId < 2"),
    ("big", "SELECT k, LASTWITHTIME(v, ts, 'LONG') FROM big "
            "GROUP BY k ORDER BY k"),
]


@pytest.mark.parametrize("table,sql", FIRSTLAST_SQL)
def test_firstlast_shapes_match_reference(firstlast_dirs, table, sql):
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    port = QueryEngine(device="cpu")
    for d in firstlast_dirs[table]:
        ref.add_segment(table, RefSegment(d))
        port.add_segment(table, ImmutableSegment(d))
    want, got = ref.execute(sql), port.execute(sql)
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    assert str(got["resultTable"]["rows"]) == str(want["resultTable"]["rows"])
    for key in STATS:
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the ops against the host's numpy forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dense_limit", [0, 1 << 22])
@pytest.mark.parametrize("seed", [0, 1])
def test_factorize_is_factorize_multi(seed, dense_limit):
    """Both codings (ranks among the distinct keys, and offsets within a
    small span) number the masked rows' tuples in factorize_multi's
    order, and each id decodes to its tuple's keys."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-5, 5, 2000)
    b = rng.integers(0, 1 << 40, 2000) % 37
    mask = rng.random(2000) < 0.7
    keys, ginv = factorize_multi([a[mask], b[mask]])
    gid, G, gkeys = sel.factorize(
        [torch.from_numpy(a), torch.from_numpy(b)], torch.from_numpy(mask),
        dense_limit=dense_limit)
    ids, rank = np.unique(gid.numpy()[mask], return_inverse=True)
    np.testing.assert_array_equal(rank, ginv)
    assert ids.max() < G
    np.testing.assert_array_equal(gkeys[0].numpy()[ids], keys[0])
    np.testing.assert_array_equal(gkeys[1].numpy()[ids], keys[1])
    if dense_limit == 0:   # the sorted coding numbers the tuples present
        assert G == len(keys[0])


def test_factorize_compacts_past_int64():
    """Three columns of 2^21 distinct keys each overflow a mixed-radix
    int64 code: the prefix is numbered on the way and still decodes."""
    rng = np.random.default_rng(9)
    cols = [rng.integers(0, 1 << 40, 3000) for _ in range(3)]
    cols = [np.concatenate([c, np.arange(1 << 21) << 19]) for c in cols]
    mask = np.ones(len(cols[0]), dtype=bool)
    keys, ginv = factorize_multi(cols)
    gid, G, gkeys = sel.factorize([torch.from_numpy(c) for c in cols],
                                  torch.from_numpy(mask), dense_limit=16)
    np.testing.assert_array_equal(gid.numpy(), ginv)
    for g, k in zip(gkeys, keys):
        np.testing.assert_array_equal(g.numpy(), k)


@pytest.mark.parametrize("limit", [1, 4, 9, 1000])
def test_limit_groups_is_the_hosts_per_segment_cap(limit):
    """Per segment: the first ``limit`` groups met in doc order keep
    their rows (the host's numGroupsLimit)."""
    rng = np.random.default_rng(limit)
    S, L = 3, 400
    seg = np.repeat(np.arange(S), L)
    gid = rng.integers(0, 12, S * L)
    keep = sel.limit_groups(torch.from_numpy(seg), torch.from_numpy(gid),
                            12, S, limit)
    want = np.zeros(S * L, dtype=bool)
    for s in range(S):
        g = gid[seg == s]
        _u, first_idx = np.unique(g, return_index=True)
        kept = np.unique(g)[np.argsort(first_idx)[:limit]]
        want[seg == s] = np.isin(g, kept)
    if keep is None:
        assert want.all()
    else:
        np.testing.assert_array_equal(keep.numpy(), want)


def test_distinct_pair_counts():
    rng = np.random.default_rng(3)
    gid = rng.integers(0, 6, 3000)      # id 5: masked rows
    v = rng.integers(0, 40, 3000)
    got = sel.distinct_pair_counts(torch.from_numpy(gid),
                                   torch.from_numpy(v), 5).numpy()
    want = [len(set(v[gid == g].tolist())) for g in range(5)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("is_first", [True, False])
def test_group_arg_time_matches_reference(is_first):
    """The with-time scatters against the reference's XLA form, ties on
    the time and NaN values included."""
    import jax.numpy as jnp
    from pinot_tpu.ops import agg as ref_agg

    rng = np.random.default_rng(5)
    n, G = 4000, 9
    gid = rng.integers(0, G + 1, n).astype(np.int32)   # G: masked
    t = rng.integers(0, 12, n).astype(np.int64)
    v = rng.normal(0, 1, n)
    v[rng.random(n) < 0.3] = np.nan
    v[gid == 3] = np.nan                                # all-NaN winners
    tb, vb = agg_ops.group_arg_time(torch.from_numpy(gid),
                                    torch.from_numpy(v), torch.from_numpy(t),
                                    G, is_first)
    rtb, rvb = ref_agg.group_arg_time(jnp.asarray(gid), jnp.asarray(v),
                                      jnp.asarray(t), G, is_first)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rtb))
    np.testing.assert_array_equal(vb.numpy(), np.asarray(rvb))
    mask = gid < G
    stb, svb = agg_ops.agg_arg_time(torch.from_numpy(v), torch.from_numpy(t),
                                    torch.from_numpy(mask), is_first)
    rstb, rsvb = ref_agg.agg_arg_time(jnp.asarray(v), jnp.asarray(t),
                                      jnp.asarray(mask), is_first)
    assert int(stb) == int(rstb) and float(svb) == float(rsvb)
