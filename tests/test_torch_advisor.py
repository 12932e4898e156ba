"""The port's plan advisor (pinot_tpu_torch/engine/advisor.py) and its
wiring into the executor against the JAX package's, on the CPU.

Unit level: tests/test_advisor.py's memo cases against the port's
``PlanAdvisor``, and one observation script through both packages'
advisors with equal advice and snapshots.

Engine level, over one table written by the JAX package's creator (two
segments of 819,200 rows, ``ts`` ascending, so 200 zone blocks a segment;
a range inside one segment prunes the other): the same
query sequences (unselective, selective in one block and in two, a join
over a small fact table, and a server partial's top-K group-by whose
present groups sit under the default trim) through the reference's engine
and the port's, with
equal rows, stats and ``advisorDecisions`` at every step; each sequence's
``SET useAdvisor=false`` twin is bit-exact and leaves the memos as they
were. The advised dense form reads no candidate count and compacts no
candidates; the tightened bounds equal the reference's and K4 takes its
candidates at that bound; an overflow of a tight bound answers exactly
and is observed as ratio 1.0.
"""

import threading

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

import pinot_tpu.ops.blockskip as ref_bs
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.advisor import PlanAdvisor as RefAdvisor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine.advisor import PlanAdvisor, advisor_enabled
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import blockskip as bs
from pinot_tpu_torch.ops import group_scatter as ps
from pinot_tpu_torch.storage.segment import ImmutableSegment

# ---------------------------------------------------------------------------
# unit: the memo store (tests/test_advisor.py's cases)
# ---------------------------------------------------------------------------


def test_lru_eviction_under_template_churn():
    adv = PlanAdvisor(max_memos=4, min_samples=2)
    for i in range(10):
        adv.observe(f"tpl{i}", skip_ratio=0.5)
    assert len(adv) == 4
    assert adv.evictions == 6
    assert adv.peek("tpl9") is not None
    assert adv.peek("tpl0") is None
    adv.observe("tpl6", skip_ratio=0.5)
    adv.observe("tplA", skip_ratio=0.5)
    assert adv.peek("tpl6") is not None
    assert adv.peek("tpl7") is None


def test_advice_needs_min_samples():
    adv = PlanAdvisor(min_samples=3)
    adv.observe("t", skip_ratio=0.9)
    adv.observe("t", skip_ratio=0.9)
    assert adv.advise_blockskip("t", 16) == (16, None)
    assert adv.convergence("t") == "cold"
    adv.observe("t", skip_ratio=0.9)
    frac, note = adv.advise_blockskip("t", 16)
    assert frac == 0 and "ADVISOR(blockSkip=dense" in note
    assert adv.convergence("t") == "converged"


def test_confirming_decision_does_not_stamp():
    adv = PlanAdvisor(min_samples=2)
    for _ in range(3):
        adv.observe("t", build_rows={"d": 100})
    assert adv.advise_join_strategy("t", "BROADCAST", "d", 1000) \
        == ("BROADCAST", None)
    assert adv.peek("t").decisions == 1
    assert adv.peek("t").overrides == 0
    for _ in range(4):
        adv.observe("t", build_rows={"d": 50_000})
    strat, note = adv.advise_join_strategy("t", "BROADCAST", "d", 1000)
    assert strat == "SHUFFLE" and "ADVISOR(joinStrategy=SHUFFLE" in note


def test_drift_decays_advice_toward_default():
    adv = PlanAdvisor(min_samples=3)
    for _ in range(4):
        adv.observe("t", skip_ratio=0.01)
    frac, note = adv.advise_blockskip("t", 16)
    assert frac == 32 and "ADVISOR(candBound=1/32" in note
    adv.observe("t", skip_ratio=1.0)
    assert adv.convergence("t") == "drifting"
    assert adv.advise_blockskip("t", 16) == (16, None)
    for _ in range(8):
        adv.observe("t", skip_ratio=1.0)
    assert adv.convergence("t") == "converged"
    frac, note = adv.advise_blockskip("t", 16)
    assert frac == 0 and "blockSkip=dense" in note


def test_trim_advice_no_drop_rule():
    adv = PlanAdvisor(min_samples=2)
    for _ in range(3):
        adv.observe("t", groups=900)
    trim, note = adv.advise_trim("t", 5000)
    assert trim == 2048 and "ADVISOR(groupTrim=2048" in note
    adv.observe("t", groups=4000, trim_keep=2048)
    assert adv.peek("t").trim_overflows == 1
    assert adv.advise_trim("t", 5000) == (5000, None)


def test_dense_blockskip_advice_reprobes():
    adv = PlanAdvisor(min_samples=2, reprobe_every=4)
    for _ in range(3):
        adv.observe("t", skip_ratio=1.0)
    picks = [adv.advise_blockskip("t", 16)[0] for _ in range(8)]
    assert 16 in picks and picks.count(0) >= 5


def test_observe_thread_safety():
    adv = PlanAdvisor(max_memos=8, min_samples=2)
    n_threads, n_iter = 8, 300
    errors = []

    def work(t):
        try:
            for i in range(n_iter):
                key = f"tpl{(t + i) % 12}"
                adv.observe(key, skip_ratio=0.3, groups=50 + i % 7,
                            cohort=1 + i % 3, build_rows={"d": 1000 + i})
                adv.advise_blockskip(key, 16)
                adv.advise_trim(key, 5000)
                adv.snapshot()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert adv.observations == n_threads * n_iter
    assert len(adv) <= 8


def test_advisor_enabled_option_parsing():
    assert advisor_enabled({}) is True
    assert advisor_enabled({"useadvisor": "false"}) is False
    assert advisor_enabled({"useadvisor": "'false'"}) is False
    assert advisor_enabled({"useadvisor": "true"}) is True
    assert PlanAdvisor.from_config() is not None


def test_memo_script_matches_reference():
    """One script of observations and advice through both advisors: the
    same advice, notes and snapshots at every step."""
    rng = np.random.default_rng(3)
    port, ref = PlanAdvisor(min_samples=2, reprobe_every=4), \
        RefAdvisor(min_samples=2, reprobe_every=4)
    for step in range(200):
        key = f"t{rng.integers(0, 3)}"
        obs = {"skip_ratio": float(rng.choice([0.004, 0.01, 0.2, 1.0])),
               "groups": int(rng.integers(10, 4000)),
               "cohort": int(rng.integers(1, 6)),
               "build_rows": {"d": int(rng.integers(10, 3 << 20))}}
        if step % 7 == 0:
            obs["trim_keep"] = 512
        port.observe(key, **obs)
        ref.observe(key, **obs)
        for adv_call, args in (("advise_blockskip", (16,)),
                               ("advise_trim", (5000,)),
                               ("advise_cohort_window", (0.003,)),
                               ("advise_join_strategy",
                                ("SHUFFLE", "d", 1 << 20))):
            got = getattr(port, adv_call)(key, *args)
            assert got == getattr(ref, adv_call)(key, *args), \
                (step, adv_call)
    assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

SEG_ROWS = 819_200           # 200 zone blocks a segment
CARD_C = 20_000
STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsProcessed",
         "numSegmentsMatched", "numSegmentsPrunedByServer",
         "numBlocksPruned", "totalDocs")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    rng = np.random.default_rng(61)
    schema = Schema.build(
        name="t",
        dimensions=[("ts", DataType.LONG), ("d", DataType.LONG),
                    ("c", DataType.STRING), ("k", DataType.STRING)],
        metrics=[("m", DataType.INT)])
    cfg = TableConfig(table_name="t", indexing=IndexingConfig(
        no_dictionary_columns=["ts", "d"]))
    base = tmp_path_factory.mktemp("advisor")
    cvals = np.array([f"c{j:05d}" for j in range(CARD_C)])
    kvals = np.array([f"k{j:02d}" for j in range(12)])
    out = {"t": []}
    for i in range(2):
        ts = np.int64(i * SEG_ROWS) + np.arange(SEG_ROWS, dtype=np.int64)
        cols = {"ts": ts,
                # 128 values a zone block, 51,200 the table: a 16-bit
                # frame-of-reference plane, inside K4's predicate surface
                "d": ts // 32,
                "c": cvals[rng.integers(0, CARD_C, SEG_ROWS)],
                "k": kvals[rng.integers(0, 12, SEG_ROWS)],
                "m": rng.integers(0, 1000, SEG_ROWS).astype(np.int32)}
        build_segment(schema, cols, str(base / f"t{i}"), cfg, f"t{i}")
        out["t"].append(str(base / f"t{i}"))
    uschema = Schema.build(name="u", dimensions=[("k", DataType.STRING)],
                           metrics=[("w", DataType.INT)])
    build_segment(uschema, {"k": kvals, "w": np.arange(12, dtype=np.int32)},
                  str(base / "u0"), TableConfig(table_name="u"), "u0")
    out["u"] = [str(base / "u0")]
    return out


@pytest.fixture
def engines(dirs):
    """Fresh engines a test (the memos live in the executor): the
    reference's and the port's on the CPU at the kernel gate 0."""
    ref, port = RefEngine(), QueryEngine(device="cpu")
    port.device.min_rows = 0
    for table, ds in dirs.items():
        for d in ds:
            ref.add_segment(table, RefSegment(d))
            port.add_segment(table, ImmutableSegment(d))
    return ref, port


B = 4096  # zone block rows
NO_CACHE = "SET usePartialsCache = false; "


D = B // 32  # d values a zone block


def _one_block(i):
    lo = D * (7 * i + 3) + 10
    return lo, lo + 30


SEQUENCES = {
    # most of the table: measured ratio ~1, then the dense form, with the
    # 16th decision a re-probe of the skip form
    "unselective": ([NO_CACHE + "SELECT COUNT(*), SUM(m) FROM t "
                     f"WHERE ts BETWEEN {i} AND {700_000 + i}"
                     for i in range(22)], "ADVISOR(blockSkip=dense"),
    # one block of the live segment's 200: ratio 0.005, x 2.5 <= 1/64
    "one_block": ([NO_CACHE + "SELECT COUNT(*), MAX(m) FROM t WHERE d "
                   "BETWEEN %d AND %d" % _one_block(i) for i in range(6)],
                  "ADVISOR(candBound=1/64"),
    # two blocks: ratio 0.01 fits 1/32, not 1/64
    "two_blocks": ([NO_CACHE + "SELECT COUNT(*), MIN(m) FROM t WHERE d "
                    f"BETWEEN {D * (5 * i + 2)} AND {D * (5 * i + 4) - 1}"
                    for i in range(6)], "ADVISOR(candBound=1/32"),
    # a 12-row build side off a fact table: SHUFFLE by default, measured
    # small, so BROADCAST
    "join": ([NO_CACHE + "SELECT t.k, COUNT(*), SUM(u.w) FROM t JOIN u "
              f"ON t.k = u.k WHERE t.ts BETWEEN {1000 * i} AND "
              f"{1000 * i + 30_000} GROUP BY t.k ORDER BY t.k"
              for i in range(5)], "ADVISOR(joinStrategy=BROADCAST"),
}


def _same(got, want, sql):
    assert got["exceptions"] == [] and want["exceptions"] == [], (sql, got)
    assert got["resultTable"] == want["resultTable"], sql
    for key in STATS:
        if key in want:
            assert got[key] == want[key], (sql, key, got[key], want[key])
    assert got.get("advisorDecisions") == want.get("advisorDecisions"), sql


def _run(ref, port, sqls):
    notes = []
    for sql in sqls:
        got, want = port.execute(sql), ref.execute(sql)
        _same(got, want, sql)
        notes.append(tuple(got.get("advisorDecisions") or ()))
    return notes


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_sequence_matches_reference(engines, seq):
    ref, port = engines
    sqls, stamp = SEQUENCES[seq]
    notes = _run(ref, port, sqls)
    first = next(i for i, n in enumerate(notes)
                 if any(stamp in x for x in n))
    # min_samples = 3 observations, so the fourth execution is advised
    assert first == 3, notes
    if seq == "unselective":
        # every 16th dense decision re-probes the skip form, unstamped
        assert notes[3:].count(()) == 1, notes


@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_advisor_off_twin_bit_exact_and_no_memo_effect(engines, seq):
    _ref, port = engines
    sqls, _stamp = SEQUENCES[seq]
    adv = port.device.advisor
    for sql in sqls:
        on = port.execute(sql)
        before = (len(adv), adv.observations, adv.decisions)
        off = port.execute("SET useAdvisor=false; " + sql)
        assert (len(adv), adv.observations, adv.decisions) == before
        assert "advisorDecisions" not in off
        assert off["resultTable"] == on["resultTable"], sql
        for key in STATS:
            if key not in ("numEntriesScannedInFilter", "numBlocksPruned"):
                assert off[key] == on[key], (sql, key)


# device -> host reads: a scalar read (int() / .item()) and the ops whose
# output shape depends on the data
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2")


class _Syncs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in SYNC_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_advised_dense_reads_no_candidate_count(engines, monkeypatch):
    _ref, port = engines
    sqls, _ = SEQUENCES["unselective"]
    for sql in sqls[:3]:
        port.execute(sql)
    calls = []
    for name in ("zone_verdict", "compact_candidates"):
        real = getattr(bs, name)
        monkeypatch.setattr(bs, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    with _Syncs() as advised:
        got = port.execute(sqls[3])
    assert "ADVISOR(blockSkip=dense" in got["advisorDecisions"][0]
    assert calls == []
    with _Syncs() as default:
        twin = port.execute("SET useAdvisor=false; " + sqls[3])
    # the default form computes the verdict, reads the count once and
    # overflows into the dense form
    assert calls == ["zone_verdict"]
    assert twin["resultTable"] == got["resultTable"]
    assert default.n - advised.n == 1, (default.n, advised.n)


@pytest.mark.parametrize("seq,frac", [("one_block", 64), ("two_blocks", 32)])
def test_tightened_bound_equals_reference(engines, monkeypatch, seq, frac):
    """The advised bound B = ceil(400 / frac) (the batch's blocks, dead
    segment included) in both packages, and K4 takes its candidates at
    that bound."""
    ref, port = engines
    seen = {"port": [], "ref": [], "k4": []}
    real_p, real_r = bs.compact_candidates, ref_bs.compact_candidates
    real_k4 = ps.fused_filter_agg

    def spy_p(flat, bound):
        seen["port"].append(bound)
        return real_p(flat, bound)

    def spy_r(flat, bound):
        seen["ref"].append(int(bound))
        return real_r(flat, bound)

    def spy_k4(cand, *a, **k):
        seen["k4"].append(int(cand.shape[0]))
        return real_k4(cand, *a, **k)

    monkeypatch.setattr(bs, "compact_candidates", spy_p)
    monkeypatch.setattr(ref_bs, "compact_candidates", spy_r)
    monkeypatch.setattr(ps, "fused_filter_agg", spy_k4)
    _run(ref, port, SEQUENCES[seq][0])
    total = 2 * SEG_ROWS // B
    want = -(-total // frac)
    default = -(-total // bs.CAND_FRACTION)
    assert bs.cand_bound(total, frac) == want
    assert seen["port"] == [default] * 3 + [want] * 3
    assert seen["k4"] == seen["port"]
    # the reference traces each compiled form once
    assert seen["ref"] and seen["ref"][-1] == want


def test_overflow_of_tight_bound_answers_and_reads_as_dense(engines):
    ref, port = engines
    sqls = SEQUENCES["one_block"][0]
    _run(ref, port, sqls[:4])
    # the same template over ~40 blocks overflows the tightened B = 7:
    # the dense form answers, the memo sees ratio 1.0 (drift)
    wide = NO_CACHE + ("SELECT COUNT(*), MAX(m) FROM t WHERE d BETWEEN "
                       f"{D * 10} AND {D * 50}")
    _run(ref, port, [wide])
    for eng in (port, ref):
        (key,) = [k for k in eng.device.advisor.snapshot()["templates"]
                  if "max" in k]
        assert eng.device.advisor.convergence(key) == "drifting"
    # advice stands down: the next execution takes the default bound
    notes = _run(ref, port, sqls[4:5])
    assert notes == [()]


# ~1,900 present groups of 20,000 in a server partial (the sole batch,
# not terminal): the keep max(5 x 5, 5000) rounds to a table of 8192
# rows; the advised 4096 halves it
TRIM_SQLS = [NO_CACHE + "SELECT c, SUM(m) FROM t WHERE ts BETWEEN "
             f"{50_000 * i} AND {50_000 * i + 1999} GROUP BY c "
             "ORDER BY SUM(m) DESC, c LIMIT 5" for i in range(6)]


def _partial(eng, sql, port: bool):
    """A server's partial over the engine's table (``execute_segments``,
    not terminal): (finalized rows after the server trim, the advisor's
    stamps, the groups the partial carries)."""
    if port:
        from pinot_tpu_torch.engine.reduce import finalize, trim_group_by
        from pinot_tpu_torch.query.optimizer import optimize_query
        from pinot_tpu_torch.sql.compiler import compile_query
    else:
        from pinot_tpu.engine.reduce import finalize, trim_group_by
        from pinot_tpu.query.optimizer import optimize_query
        from pinot_tpu.sql.compiler import compile_query
    q = optimize_query(compile_query(sql))
    tdm = eng.tables["t"]
    segs = tdm.acquire()
    try:
        merged = eng.execute_segments(q, segs, terminal=False)
    finally:
        tdm.release(segs)
    rows_ = finalize(q, trim_group_by(q, merged)).rows
    return rows_, list(merged.stats.advisor_decisions), \
        len(merged.group_keys[0])


def test_trim_sequence_matches_reference(engines):
    ref, port = engines
    got = [_partial(port, sql, True) for sql in TRIM_SQLS]
    want = [_partial(ref, sql, False) for sql in TRIM_SQLS]
    assert got == want
    stamped = [any("ADVISOR(groupTrim=4096" in x for x in g[1])
               for g in got]
    assert stamped == [False] * 3 + [True] * 3, got


def test_trim_advice_shrinks_the_fetch(engines):
    _ref, port = engines
    for sql in TRIM_SQLS[:3]:
        _partial(port, sql, True)
    b0 = port.device.fetch_bytes_total
    off = _partial(port, "SET useAdvisor=false; " + TRIM_SQLS[3], True)
    b1 = port.device.fetch_bytes_total
    on = _partial(port, TRIM_SQLS[3], True)
    b2 = port.device.fetch_bytes_total
    assert any("ADVISOR(groupTrim=4096" in x for x in on[1])
    assert off[0] == on[0] and off[2] == on[2]
    assert 0 < b2 - b1 < b1 - b0, (b1 - b0, b2 - b1)


def test_explain_analyze_shows_the_advisor_lines(engines):
    _ref, port = engines
    sqls = SEQUENCES["one_block"][0]
    for sql in sqls[:3]:
        port.execute(sql)
    sql = sqls[3].replace(NO_CACHE, NO_CACHE + "EXPLAIN ANALYZE ")
    lines = [r[0] for r in port.execute(sql)["resultTable"]["rows"]]
    assert any(x.strip().startswith("ADVISOR(candBound=1/64")
               for x in lines), lines


def test_cohort_window_follows_solo_cohorts(engines):
    """Forced windows that stay solo (cohorts of 1) halve the template's
    window after three observations."""
    _ref, port = engines
    co = port.device.coalescer
    co.force = True
    try:
        notes = [tuple(port.execute(
            NO_CACHE + f"SELECT COUNT(*), SUM(m) FROM t WHERE k = 'k{i:02d}'"
        ).get("advisorDecisions") or ()) for i in range(5)]
    finally:
        co.force = False
    assert notes[:3] == [(), (), ()]
    assert all(any("ADVISOR(cohortWindow=1.5ms" in x for x in n)
               for n in notes[3:]), notes
