"""The port's zone-map pruning, block skip and fused kernel (K4) against
the JAX package's, on the CPU.

Engine level: the reference's own block-skip tables (the time-ordered
3 x 20k-row layout of tests/test_blockskip.py and the uint16
frame-of-reference ``ts`` table of tests/test_pallas_scatter.py) are
written by the JAX package's creator and loaded into both engines. The
reference runs its Pallas tier in interpret mode, so its fused kernel
runs; the port runs on the CPU with its kernel gate at 0 rows, so the
fused form goes through K4's plain version. Integer cells must match bit
for bit, float cells per ``_rows_close`` (the reference's tolerance), and
the seven pruning and scan stats exactly; the port's block-skip answer
must equal its own ``SET useBlockSkip = false`` answer exactly.

Unit level, numpy inputs from a seed fed to both packages: zone verdicts
and candidate compaction, the fused plan's accept/decline decisions,
K4's plain version against the reference kernel in interpret mode, and
the batch's zone maps (with and without the segments' ``.zmap.npy``).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.engine.params import BatchContext as RefBatch
from pinot_tpu.ops import blockskip as ref_bs
from pinot_tpu.ops import pallas_scatter as ref_ps
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.params import BatchContext
from pinot_tpu_torch.ops import blockskip as bs
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS, ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned", "totalDocs")

# tests/test_blockskip.py's PARITY_QUERIES: EQ / IN / RANGE / AND / OR /
# NOT over dict (k, tag) and raw (ts, m) columns, selective, empty and
# unselective (overflow), scalar and group-by
PARITY_QUERIES = [
    "SELECT COUNT(*), SUM(m) FROM t WHERE ts BETWEEN 5000 AND 5999",
    "SELECT COUNT(*), SUM(m), MIN(m), MAX(m) FROM t WHERE ts < 3000",
    "SELECT COUNT(*) FROM t WHERE k = 'k0002'",
    "SELECT COUNT(*), SUM(f) FROM t WHERE k IN ('k0001', 'k0009')",
    "SELECT tag, COUNT(*), SUM(m) FROM t WHERE ts BETWEEN 10000 AND 30000 "
    "GROUP BY tag ORDER BY tag",
    "SELECT COUNT(*) FROM t WHERE ts > 15000 AND k = 'k0004'",
    "SELECT COUNT(*) FROM t WHERE ts < 2000 OR ts > 55000",
    "SELECT COUNT(*) FROM t WHERE NOT ts < 30000",
    "SELECT COUNT(*) FROM t WHERE tag = 'b' AND ts BETWEEN 4096 AND 8191",
    "SELECT k, COUNT(*) FROM t WHERE ts BETWEEN 4000 AND 21000 "
    "GROUP BY k ORDER BY k",
    "SELECT COUNT(*), MIN(m), MAX(m) FROM t WHERE ts = 5000 AND ts = 9000",
    "SELECT COUNT(*), MIN(m), MAX(m) FROM t WHERE k = 'zzz'",
    "SELECT COUNT(*), SUM(m) FROM t WHERE ts >= 0",
    # beyond the reference's list: fully pruned group-by and sketches,
    # and sketches through the gathered form
    "SELECT tag, COUNT(*), SUM(m), MIN(f) FROM t WHERE k = 'zzz' "
    "GROUP BY tag",
    "SELECT COUNT(*), DISTINCTCOUNTHLL(tag), DISTINCTCOUNT(k), "
    "MINMAXRANGE(m), AVG(f) FROM t WHERE ts > 100000",
    "SELECT tag, DISTINCTCOUNTHLL(k), DISTINCTCOUNT(k) FROM t "
    "WHERE ts BETWEEN 100 AND 200 GROUP BY tag ORDER BY tag",
    "SELECT COUNT(*), DISTINCTCOUNTHLL(tag), DISTINCTCOUNT(k) FROM t "
    "WHERE ts BETWEEN 100 AND 5000",
]

# tests/test_pallas_scatter.py's fused DIFF_QUERIES shapes and the two
# fractional-literal queries, with the form each takes in the port:
# "fused" (K4), "gather" (the generic gathered form) or "dense" (the
# candidates overflow the bound)
FUSED_QUERIES = {
    "SELECT COUNT(*) FROM t WHERE ts < 40": "fused",
    "SELECT COUNT(*), SUM(iv), MIN(iv), MAX(iv) FROM t WHERE ts BETWEEN "
    "100 AND 700": "fused",
    # SUM(big): rows_per_block_for(2^38) is None, the plan declines
    "SELECT COUNT(*), MAX(fv), SUM(big) FROM t WHERE ts >= 29000": "gather",
    "SELECT COUNT(*), MIN(fv) FROM t WHERE ts < 3000 AND d = 'k0003'":
        "fused",
    "SELECT COUNT(*) FROM t WHERE d IN ('k0001','k0007') AND e = 'y'":
        "dense",
    "SELECT COUNT(*), SUM(iv) FROM t WHERE NOT e = 'x' AND ts < 300":
        "fused",
    # float SUM: order-sensitive, the plan declines
    "SELECT COUNT(*), SUM(fv) FROM t WHERE ts < 300": "gather",
    # fractional literals over an integer plane: fused_params_ok declines
    "SELECT COUNT(*) FROM t WHERE ts < 10.5": "gather",
    "SELECT COUNT(*), SUM(iv) FROM t WHERE ts BETWEEN 99.5 AND 700.5":
        "gather",
}
FLOAT_SQL = ("SUM(f)", "AVG(f)", "fv")


def _rows_close(rows_a, rows_b):
    if len(rows_a) != len(rows_b):
        return False
    for ra, rb in zip(rows_a, rows_b):
        for x, y in zip(ra, rb):
            if isinstance(x, str) or x is None:
                if x != y:
                    return False
            elif not np.isclose(float(x), float(y), rtol=1e-5, atol=1e-6):
                return False
    return True


# ---------------------------------------------------------------------------
# tables and engines
# ---------------------------------------------------------------------------


def _write(schema, cfg, parts, base):
    dirs = []
    for i, cols in enumerate(parts):
        out = str(base / f"s{i}")
        build_segment(schema, cols, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def bs_table(tmp_path_factory):
    """tests/test_blockskip.py's table: ``ts`` ascends across segments,
    ``k`` changes every 5000 rows, ``tag``/``m``/``f`` unclustered."""
    rng = np.random.default_rng(29)
    n = 20_000
    parts = []
    for i in range(3):
        base = i * n
        parts.append({
            "ts": (base + np.arange(n)).astype(np.int64),
            "k": np.array([f"k{(base + j) // 5000:04d}" for j in range(n)]),
            "tag": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
            "m": rng.integers(0, 10_000, n).astype(np.int32),
            "f": np.round(rng.uniform(0, 100, n), 3),
        })
    schema = Schema.build(
        name="t",
        dimensions=[("ts", DataType.LONG), ("k", DataType.STRING),
                    ("tag", DataType.STRING)],
        metrics=[("m", DataType.INT), ("f", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t",
                      indexing=IndexingConfig(no_dictionary_columns=["ts"]))
    dirs = _write(schema, cfg, parts, tmp_path_factory.mktemp("bs_table"))
    return dirs, {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def fused_table(tmp_path_factory):
    """tests/test_pallas_scatter.py's table: ``ts`` ascends (a uint16
    frame-of-reference plane, inside the fused predicate surface),
    everything else unclustered."""
    rng = np.random.default_rng(5)
    n, card = 30000, 220
    cols = {
        "ts": np.arange(n, dtype=np.int64),
        "d": np.array([f"k{i:04d}" for i in range(card)])[
            rng.integers(0, card, n)],
        "e": np.array(["x", "y", "z"])[rng.integers(0, 3, n)],
        "iv": rng.integers(0, 9000, n).astype(np.int32),
        "big": (rng.integers(0, 1 << 38, n)).astype(np.int64),
        "fv": rng.uniform(-100, 100, n).astype(np.float64),
    }
    schema = Schema.build(
        name="t",
        dimensions=[("ts", DataType.LONG), ("d", DataType.STRING),
                    ("e", DataType.STRING)],
        metrics=[("iv", DataType.INT), ("big", DataType.LONG),
                 ("fv", DataType.DOUBLE)])
    cfg = TableConfig(table_name="t",
                      indexing=IndexingConfig(no_dictionary_columns=["ts"]))
    third = n // 3
    parts = [{k: v[sl] for k, v in cols.items()}
             for sl in (slice(0, third), slice(third, 2 * third),
                        slice(2 * third, n))]
    return _write(schema, cfg, parts, tmp_path_factory.mktemp("fused_table"))


def _engines(dirs):
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0
    # the route spies watch a repeat's launch: it must not be served from
    # the device partials cache
    port.device.partials_cache_enabled = False
    for d in dirs:
        ref.add_segment("t", RefSegment(d))
        port.add_segment("t", ImmutableSegment(d))
    return ref, port


@pytest.fixture(scope="module")
def bs_engines(bs_table):
    return _engines(bs_table[0])


@pytest.fixture(scope="module")
def fused_engines(fused_table):
    return _engines(fused_table)


@pytest.fixture
def route(monkeypatch):
    """Records which form each launch took: K4's entry, the generic
    gather (once per gathered column), or neither (the dense form)."""
    seen = []
    fused, gather = ps.fused_filter_agg, bs.gather_blocks

    def spy_fused(*a, **k):
        seen.append("fused")
        return fused(*a, **k)

    def spy_gather(*a, **k):
        seen.append("gather")
        return gather(*a, **k)

    monkeypatch.setattr(ps, "fused_filter_agg", spy_fused)
    monkeypatch.setattr(bs, "gather_blocks", spy_gather)
    return seen


def _check_parity(ref, port, sql, exact: bool):
    r = ref.execute(sql)
    p = port.execute(sql)
    pd = port.execute("SET useBlockSkip = false; " + sql)
    for resp in (r, p, pd):
        assert not resp.get("exceptions"), (sql, resp)
    rows, want = p["resultTable"]["rows"], r["resultTable"]["rows"]
    assert (rows == want) if exact else _rows_close(rows, want), \
        (sql, rows, want)
    for key in STATS:
        assert p[key] == r[key], (sql, key, p[key], r[key])
    # skip == force-dense, exactly (the dense form prunes no block)
    assert pd["resultTable"] == p["resultTable"], sql
    for key in STATS:
        if key not in ("numEntriesScannedInFilter", "numBlocksPruned"):
            assert pd[key] == p[key], (sql, key)
    assert pd["numBlocksPruned"] == 0
    return p


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql", PARITY_QUERIES)
def test_blockskip_parity(bs_engines, sql):
    ref, port = bs_engines
    _check_parity(ref, port, sql, exact=not any(f in sql for f in FLOAT_SQL))


# DISTINCTCOUNTHLL over the raw column ts: the reference's device reads
# dict columns only, so its host path answers, with that path's stats
# (no block skip; a sorted column's predicate scans no entry)
RAW_HLL_QUERIES = [
    "SELECT DISTINCTCOUNTHLL(ts) FROM t WHERE ts BETWEEN 5000 AND 5999",
    "SELECT COUNT(*), DISTINCTCOUNTHLL(ts), FASTHLL(ts) FROM t "
    "WHERE ts < 3000",
    "SELECT k, DISTINCTCOUNTHLL(ts) FROM t WHERE k IN ('k0001', 'k0009') "
    "GROUP BY k ORDER BY k",
    "SELECT tag, DISTINCTCOUNTHLL(ts), SUM(m) FROM t WHERE k = 'k0002' "
    "GROUP BY tag ORDER BY tag",
    "SELECT DISTINCTCOUNTHLL(ts, 8), DISTINCTCOUNTHLL(tag) FROM t "
    "WHERE ts BETWEEN 100 AND 200 OR ts > 59000",
]


@pytest.mark.parametrize("sql", RAW_HLL_QUERIES)
def test_raw_hll_takes_the_host_path_shape(bs_engines, route, sql):
    """Rows bit for bit and every response stat the reference's host path
    reports, its block-skip forms and index choices included; the port
    answers in that path's shape, so no block-skip form runs."""
    ref, port = bs_engines
    got, want = port.execute(sql), ref.execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    for key in STATS + ("numEntriesScannedPostFilter",):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["numBlocksPruned"] == 0
    assert route == []


@pytest.mark.parametrize("sql", list(FUSED_QUERIES))
def test_fused_parity(fused_engines, route, sql):
    ref, port = fused_engines
    _check_parity(ref, port, sql, exact=not any(f in sql for f in FLOAT_SQL))
    route.clear()
    port.execute(sql)
    want = FUSED_QUERIES[sql]
    assert sorted(set(route)) == ([] if want == "dense" else [want]), \
        (sql, route)


def test_selective_range_stats(bs_engines):
    """Level 1 and Level 2 both fire: the window lives in segment 0's
    first two blocks."""
    _ref, port = bs_engines
    sql = "SELECT COUNT(*), SUM(m) FROM t WHERE ts BETWEEN 5000 AND 5999"
    r = port.execute(sql)
    rd = port.execute("SET useBlockSkip = false; " + sql)
    assert r["numBlocksPruned"] > 0 and rd["numBlocksPruned"] == 0
    assert 0 < r["numEntriesScannedInFilter"] \
        < rd["numEntriesScannedInFilter"]
    assert r["numSegmentsPrunedByServer"] == 2
    assert r["numSegmentsProcessed"] == 1


@pytest.mark.parametrize("width", [ZONE_BLOCK_ROWS // 2, ZONE_BLOCK_ROWS,
                                   2 * ZONE_BLOCK_ROWS, 8 * ZONE_BLOCK_ROWS])
def test_candidate_bound_sweep(bs_engines, bs_table, width):
    """15 blocks, bound ceil(15 / 16) = 1: windows of 1, 2 and 8 blocks
    cross the bound both ways; every width answers exactly."""
    ref, port = bs_engines
    cols = bs_table[1]
    lo, hi = 1000, 1000 + width - 1
    sql = f"SELECT COUNT(*), SUM(m) FROM t WHERE ts BETWEEN {lo} AND {hi}"
    p = _check_parity(ref, port, sql, exact=True)
    want = (cols["ts"] >= lo) & (cols["ts"] <= hi)
    assert p["resultTable"]["rows"] == [[int(want.sum()),
                                         float(cols["m"][want].sum())]]


def test_fully_pruned_runs_nothing_on_the_batch(bs_engines, monkeypatch):
    """Every segment pruned: the outputs are the all-masked fills, made
    on the host from one dead row; no pipeline runs over the batch."""
    ref, port = bs_engines
    shapes = []
    build = device_mod.build_pipeline

    def spy_build(*a, **k):
        fn = build(*a, **k)

        def run(cols, n_docs, params):
            shapes.append(tuple(n_docs.shape))
            return fn(cols, n_docs, params)
        return run

    monkeypatch.setattr(device_mod, "build_pipeline", spy_build)
    sql = "SELECT COUNT(*), MIN(m), MAX(m), SUM(m) FROM t WHERE k = 'zzz'"
    p = port.execute(sql)
    r = ref.execute(sql)
    assert p["resultTable"]["rows"] == r["resultTable"]["rows"]
    assert p["numSegmentsPrunedByServer"] == 3
    assert p["numDocsScanned"] == 0 and p["numEntriesScannedInFilter"] == 0
    assert p["totalDocs"] == 60_000
    assert shapes == [(1,)]  # the host's one dead row, never the 3 segments


# ---------------------------------------------------------------------------
# unit level: zone verdicts and candidate compaction
# ---------------------------------------------------------------------------

S_Z, NB_Z = 3, 7
ZWIDTHS = {
    "a": ("|u1", 0, False, ""),              # uint8 dict ids
    "b": ("<u2", 0, False, ""),              # uint16 dict ids
    "r": ("<u2", 0, True, "<i8"),            # FOR raw plane, offset 1000
    "dv::v": ("|u1", 0, False, "<i4"),       # decoded, narrowed, no offset
    "f": ("<f4", 0, False, ""),              # float raw plane
}
ZNODES = {
    "eq_dict": ("eq_dict", "a", "pa"),
    "eq_dict_absent": ("eq_dict", "a", "pneg"),
    "in_dict": ("in_dict", "b", "pin", 4),
    "range_dict": ("range_dict", "b", "plo", "phi"),
    "eq_raw": ("eq_raw", ("raw", "r"), "preq"),
    "in_raw": ("in_raw", ("raw", "r"), "prin", 3),
    "range_raw_closed": ("range_raw", ("raw", "r"), "prl", "prh", True, True,
                         True, True),
    "range_raw_open_lo": ("range_raw", ("raw", "r"), "prl", "prh", True,
                          False, False, False),
    "range_raw_open_hi": ("range_raw", ("raw", "r"), "prl", "prh", False,
                          True, False, False),
    "range_dictval": ("range_raw", ("dictval", "v"), "pvl", "pvh", True, True,
                      True, False),
    "range_float": ("range_raw", ("raw", "f"), "pfl", "pfh", True, True, True,
                    True),
    "computed_expr": ("eq_raw", ("plus", ("raw", "r"), ("lit", "preq")),
                      "preq"),
    "and": ("and", ("range_dict", "b", "plo", "phi"), ("eq_raw", ("raw", "r"),
                                                       "preq")),
    "or": ("or", ("eq_dict", "a", "pa"), ("in_raw", ("raw", "r"), "prin", 3)),
    "not": ("not", ("eq_dict", "a", "pa")),
    "lut_dict": ("lut_dict", "a", "plut"),
    "true": ("true",),
    "false": ("false",),
}


def _zone_inputs(seed=3):
    rng = np.random.default_rng(seed)

    def zones(lo, hi, dtype):
        a = rng.integers(lo, hi, (S_Z, NB_Z))
        b = rng.integers(lo, hi, (S_Z, NB_Z))
        return np.minimum(a, b).astype(dtype), np.maximum(a, b).astype(dtype)

    cols = {}
    for key, (lo, hi, dt) in {"a": (0, 200, np.uint8),
                              "b": (0, 3000, np.uint16),
                              "r": (0, 60000, np.uint16),
                              "dv::v": (0, 250, np.uint8)}.items():
        zl, zh = zones(lo, hi, dt)
        cols[bs.ZLO + key], cols[bs.ZHI + key] = zl, zh
    fl = rng.uniform(-50, 50, (2, S_Z, NB_Z)).astype(np.float32)
    cols[bs.ZLO + "f"], cols[bs.ZHI + "f"] = fl.min(0), fl.max(0)
    params = {
        "pa": np.int32(77), "pneg": np.int32(-2),
        "pin": np.array([5, 900, 2500, -2], np.int32),
        "plo": np.int32(1000), "phi": np.int32(1400),
        "preq": np.int64(31000), "prin": np.array([1500, 40000, 61500]),
        "prl": np.int64(20000), "prh": np.int64(26000),
        "pvl": np.int64(40), "pvh": np.int64(90),
        "pfl": np.float32(-3.5), "pfh": np.float32(4.25),
        "plut": np.ones(200, bool),
        "fo::r": np.int64(1000),
    }
    return cols, params


@pytest.mark.parametrize("node", list(ZNODES))
def test_zone_verdict_and_compaction_equal_reference(node):
    tpl = ZNODES[node]
    cols, params = _zone_inputs()
    want = np.asarray(ref_bs.zone_verdict(
        tpl, {k: jnp.asarray(v) for k, v in cols.items()},
        {k: jnp.asarray(v) for k, v in params.items()}, (S_Z, NB_Z),
        {k: (np.dtype(w[0]).name, w[1], w[2],
             np.dtype(w[3]).name if w[3] else None)
         for k, w in ZWIDTHS.items()}))
    got = bs.zone_verdict(
        tpl, {k: torch.from_numpy(v) for k, v in cols.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        (S_Z, NB_Z), ZWIDTHS).numpy()
    np.testing.assert_array_equal(got, want)
    assert bs.prunable_columns(tpl) == ref_bs.prunable_columns(tpl)
    flat = want.reshape(-1).copy()
    for bound in (1, 5, flat.size):
        rc, rv = ref_bs.compact_candidates(jnp.asarray(flat), bound)
        pc, pv = bs.compact_candidates(torch.from_numpy(flat), bound)
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# unit level: the fused plan and K4's plain version
# ---------------------------------------------------------------------------

PWIDTHS = {
    "d": ("uint8", 0, False, None),
    "iv": ("uint16", 0, True, "int64"),
    "fv": ("float32", 0, False, None),
    "sb": ("uint8", 4, False, None),  # sub-byte packed
    "w32": ("int32", 0, False, None),
}
RANGE_IV = ("range_raw", ("raw", "iv"), "p1", "p2", True, True, True, False)
COUNT = (("count", None, None),)
PLANS = {
    "eligible": (("and", ("eq_dict", "d", "p0"), RANGE_IV),
                 (("count", None, None), ("sum", ("raw", "iv"), (2, 1 << 20)),
                  ("minmaxrange", ("raw", "fv"), None))),
    "in_or_not": (("or", ("in_dict", "d", "p0", 4),
                   ("not", ("eq_raw", ("raw", "iv"), "p1"))),
                  (("max", ("raw", "w32"), None), ("min", ("raw", "iv"), None))),
    "sub_byte": (("eq_dict", "sb", "p0"), COUNT),
    "lut": (("lut_dict", "d", "p0"), COUNT),
    "float_raw_pred": (("range_raw", ("raw", "fv"), "p1", "p2", True, True,
                        True, False), COUNT),
    "int32_raw_pred": (("eq_raw", ("raw", "w32"), "p1"), COUNT),
    "float_sum": (("eq_dict", "d", "p0"), (("sum", ("raw", "fv"),
                                            (None, None)),)),
    "overflowing_sum": (("eq_dict", "d", "p0"), (("sum", ("raw", "iv"),
                                                  (2, 2048)),)),
    "computed_agg": (("eq_dict", "d", "p0"),
                     (("max", ("plus", ("raw", "iv"), ("lit", "p3")), None),)),
    "sketch_agg": (("eq_dict", "d", "p0"), (("distinctcount", "d", 200),)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_fused_equals_reference(name):
    ftpl, aggs = PLANS[name]
    want = ref_ps.plan_fused(ftpl, aggs, PWIDTHS)
    got = ps.plan_fused(ftpl, aggs, PWIDTHS)
    assert (got is None) == (want is None), name
    if want is None:
        return
    assert got.cols == want.cols
    assert got.pred_params == want.pred_params
    assert got.aggs == want.aggs
    assert (got.n_int, got.n_flt) == (want.n_int, want.n_flt)


@pytest.mark.parametrize("p0_shape,p1_dtype,ok", [
    ((4,), np.int64, True), ((ps.FUSED_MAX_IN + 1,), np.int64, False),
    ((1,), np.float32, False), ((), np.int32, True)])
def test_fused_params_ok_equals_reference(p0_shape, p1_dtype, ok):
    ftpl, aggs = PLANS["in_or_not"]
    rp = ref_ps.plan_fused(ftpl, aggs, PWIDTHS)
    pp = ps.plan_fused(ftpl, aggs, PWIDTHS)
    vals = {"p0": np.zeros(p0_shape, np.int32),
            "p1": np.zeros((), p1_dtype)}
    assert ref_ps.fused_params_ok(
        rp, {k: jnp.asarray(v) for k, v in vals.items()}) == ok
    assert ps.fused_params_ok(
        pp, {k: torch.from_numpy(np.asarray(v)) for k, v in vals.items()}) \
        == ok
    assert not ps.fused_params_ok(pp, {})


KWIDTHS = {
    "a": ("uint8", 0, False, None), "b": ("uint16", 0, False, None),
    "c": ("int8", 0, False, None), "d": ("int16", 0, False, None),
    "e": ("int32", 0, False, None), "f": ("float32", 0, False, None),
}
KFILTERS = {
    "and_or_not_in8": (
        "and",
        ("or", ("eq_dict", "a", "p0"), ("in_dict", "b", "p1", 8)),
        ("not", ("range_raw", ("raw", "c"), "p2", "p3", True, True, True,
                 False)),
        ("range_dict", "e", "p4", "p5")),
    "in_raw_or_range": (
        "or", ("in_raw", ("raw", "d"), "p6", 3),
        ("range_raw", ("raw", "c"), "p2", "p3", False, True, False, True)),
    "not_and": ("not", ("and", ("range_dict", "b", "p4", "p5"),
                        ("eq_raw", ("raw", "d"), "p7"))),
}
KAGGS = (("count", None, None), ("sum", ("raw", "b"), (2, 1 << 20)),
         ("min", ("raw", "d"), None), ("minmaxrange", ("raw", "f"), None),
         ("max", ("raw", "c"), None), ("sum", ("raw", "e"), (2, 1 << 20)),
         ("max", ("raw", "a"), None))


@pytest.mark.parametrize("filt", list(KFILTERS))
def test_fused_plain_equals_reference_kernel(filt):
    """K4's plain version against the reference kernel in interpret mode:
    planes of all six dtypes, and/or/not trees, IN lists up to 8,
    padding candidates and a partial last block."""
    rng = np.random.default_rng(41)
    R, NBLK = ZONE_BLOCK_ROWS, 6
    planes = {
        "a": rng.integers(0, 40, (NBLK, R)).astype(np.uint8),
        "b": rng.integers(0, 3000, (NBLK, R)).astype(np.uint16),
        "c": rng.integers(-128, 128, (NBLK, R)).astype(np.int8),
        "d": rng.integers(-300, 300, (NBLK, R)).astype(np.int16),
        "e": rng.integers(0, 5000, (NBLK, R)).astype(np.int32),
        "f": rng.uniform(-1e3, 1e3, (NBLK, R)).astype(np.float32),
    }
    params = {
        "p0": np.array([7], np.int32),
        "p1": rng.integers(0, 3000, 8).astype(np.int32),
        "p2": np.array([-20], np.int32), "p3": np.array([64], np.int32),
        "p4": np.array([1000], np.int32), "p5": np.array([4200], np.int32),
        "p6": np.array([-5, 17, 250], np.int32),
        "p7": np.array([3], np.int32),
    }
    cand = np.array([4, 1, 5, 0, 0, 0], np.int32)   # 3 padding candidates
    rows_in = np.array([R, R, 1000, 0, 0, 0], np.int32)  # 5 is partial
    ftpl = KFILTERS[filt]
    rplan = ref_ps.plan_fused(ftpl, KAGGS, KWIDTHS)
    pplan = ps.plan_fused(ftpl, KAGGS, KWIDTHS)
    assert rplan is not None and pplan is not None
    used = {k: v for k, v in params.items() if k in pplan.pred_params}
    want_i, want_f = ref_ps.fused_filter_agg(
        jnp.asarray(cand), jnp.asarray(rows_in),
        {k: jnp.asarray(planes[k].reshape(NBLK, R // 128, 128))
         for k in rplan.cols},
        {k: jnp.asarray(v) for k, v in used.items()}, rplan, interpret=True)
    got_i, got_f = ps.fused_filter_agg(
        torch.from_numpy(cand), torch.from_numpy(rows_in),
        {k: torch.from_numpy(planes[k]) for k in pplan.cols},
        {k: torch.from_numpy(v) for k, v in used.items()}, pplan)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_i[3:, 0].eq(0).all()  # padding candidates match nothing
    assert 0 < int(got_i[2, 0]) <= 1000


def test_fused_plan_bounds_decline():
    """Past K4's descriptor bounds the port's plan declines (the generic
    gather branch then answers); the reference has no such bound."""
    leaf = ("eq_dict", "a", "p0")
    deep = leaf
    for _ in range(20):  # 41 instructions
        deep = ("and", deep, leaf)
    assert ref_ps.plan_fused(deep, COUNT, KWIDTHS) is not None
    assert ps.plan_fused(deep, COUNT, KWIDTHS) is None
    assert ps.plan_fused(("and", leaf, leaf), COUNT, KWIDTHS) is not None


# ---------------------------------------------------------------------------
# unit level: the batch's zone maps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zone_dirs(tmp_path_factory):
    """Two segments with a FOR raw plane (``ts`` past 2^16 at an offset),
    a dict plane (``k``), a numeric dict plane decoded (``v``) and a float
    raw plane (``f``); a copy without the ``.zmap.npy`` files."""
    rng = np.random.default_rng(17)
    schema = Schema.build(
        name="z", dimensions=[("ts", DataType.LONG), ("k", DataType.STRING),
                              ("v", DataType.INT)],
        metrics=[("f", DataType.DOUBLE)])
    cfg = TableConfig(table_name="z", indexing=IndexingConfig(
        no_dictionary_columns=["ts", "f"]))
    parts = []
    for i, n in enumerate((10_000, 9_000)):
        parts.append({
            "ts": (1_000_000 + i * 10_000 + np.arange(n)).astype(np.int64),
            "k": np.array([f"k{j // 3000 + 3 * i:03d}" for j in range(n)]),
            "v": rng.integers(-500, 500, n).astype(np.int32),
            "f": rng.uniform(-1, 1, n),
        })
    base = tmp_path_factory.mktemp("zones")
    dirs = _write(schema, cfg, parts, base / "with")
    bare = []
    for d in dirs:
        out = str(base / "bare" / os.path.basename(d))
        shutil.copytree(d, out)
        for f in os.listdir(out):
            if f.endswith(".zmap.npy"):
                os.unlink(os.path.join(out, f))
        bare.append(out)
    return dirs, bare


@pytest.mark.parametrize("files", ["with_zmap", "recomputed"])
@pytest.mark.parametrize("key", ["ts", "k", "dv::v", "f"])
def test_zone_map_equals_reference(zone_dirs, files, key):
    dirs = zone_dirs[0] if files == "with_zmap" else zone_dirs[1]
    if files == "recomputed":
        assert ImmutableSegment(dirs[0]).zone_map("ts") is None
    ref = RefBatch([RefSegment(d) for d in dirs])
    port = BatchContext([ImmutableSegment(d) for d in dirs], "cpu")
    want_lo, want_hi = (np.asarray(z) for z in ref.zone_map(key))
    got_lo, got_hi = (z.numpy() for z in port.zone_map(key))
    assert got_lo.dtype == want_lo.dtype
    np.testing.assert_array_equal(got_lo, want_lo)
    np.testing.assert_array_equal(got_hi, want_hi)
    if key == "ts":
        assert port.width_plan("ts").offset == 1_000_000
