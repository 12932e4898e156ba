"""The port's multi-stage joins against the reference's, after
tests/test_join.py: TestJoinParity's queries under both join strategies,
sealed plus consuming segments, LEFT JOIN against LOOKUP, the typed
diagnostics, EXPLAIN, selection order without ORDER BY, the stage-1 and
pair caps, and stage 2's group sums reaching K1 (its wrapper's plain
version on the CPU).

The same segments load into the reference's ``QueryEngine()`` (its device
on JAX's CPU, ``SET useAdvisor=false``) and into the port's
``QueryEngine(device="cpu")`` at the default kernel gate and at gate 0.
Rows are compared with integers bit for bit and floats within
``_rows_close``; every stat the response carries must match, but
``timeUsedMs`` and the roofline's times; each query is also held to the
sqlite oracle as test_join.py holds it."""

import math
import sqlite3

import numpy as np
import pytest

import pinot_tpu.common.datatypes as r_dt
import pinot_tpu.common.schema as r_schema
import pinot_tpu.common.table_config as r_tc
import pinot_tpu.storage.creator as r_creator
import pinot_tpu.storage.mutable as r_mut
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu_torch.common import datatypes as t_dt
from pinot_tpu_torch.common import schema as t_schema
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import group_scatter
from pinot_tpu_torch.query2 import runner as t_runner
from pinot_tpu_torch.storage import creator as t_creator
from pinot_tpu_torch.storage import mutable as t_mut

MODS = {"ref": (r_schema, r_dt, r_tc, r_creator, r_mut),
        "port": (t_schema, t_dt, t_tc, t_creator, t_mut)}
GATES = {"gate": None, "gate0": 0}

N_FACT = 4000
N_PARTS = 60
N_CUSTS = 25

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned", "numSegmentsCold",
         "partialResult", "numGroupsLimitReached", "totalDocs", "numStages",
         "numJoinedRows", "leafRows", "joinStrategy")
NO_ADVISOR = "SET useAdvisor=false; "


def schemas(side):
    sc, dt = MODS[side][:2]
    DT = dt.DataType
    fact = sc.Schema.build(
        name="orders",
        dimensions=[("partkey", DT.INT), ("custkey", DT.INT),
                    ("status", DT.STRING)],
        metrics=[("qty", DT.INT), ("price", DT.DOUBLE)])
    parts = sc.Schema.build(
        name="parts",
        dimensions=[("pkey", DT.INT), ("category", DT.STRING),
                    ("brand", DT.STRING)],
        primary_key_columns=["pkey"])
    custs = sc.Schema.build(
        name="custs",
        dimensions=[("ckey", DT.INT), ("region", DT.STRING)],
        primary_key_columns=["ckey"])
    return fact, parts, custs


def make_data(rng):
    """test_join.py's tables: partkey past the dim table (LEFT misses),
    every key on many fact rows."""
    fact = {
        "partkey": rng.integers(0, N_PARTS + 8, N_FACT).astype(np.int32),
        "custkey": rng.integers(0, N_CUSTS, N_FACT).astype(np.int32),
        "status": np.array(["open", "paid", "void"])[
            rng.integers(0, 3, N_FACT)],
        "qty": rng.integers(1, 50, N_FACT).astype(np.int32),
        "price": np.round(rng.uniform(1.0, 500.0, N_FACT), 2),
    }
    parts = {
        "pkey": np.arange(N_PARTS, dtype=np.int32),
        "category": np.array([f"cat_{i % 7}" for i in range(N_PARTS)]),
        "brand": np.array([f"brand_{i % 11}" for i in range(N_PARTS)]),
    }
    custs = {
        "ckey": np.arange(N_CUSTS, dtype=np.int32),
        "region": np.array([f"region_{i % 5}" for i in range(N_CUSTS)]),
    }
    return fact, parts, custs


def new_engine(side, gate=None):
    if side == "ref":
        return RefEngine()
    eng = QueryEngine(device="cpu")
    if gate is not None:
        eng.device.min_rows = gate
    return eng


def load(side, eng, base, fact, parts, custs, consuming=False):
    """Two fact segments (the second consuming when ``consuming``), parts
    and custs as dimension tables."""
    _sc, _dt, tc, creator, mut = MODS[side]
    fs, ps_, cs = schemas(side)
    half = N_FACT // 2
    eng.add_segment("orders", creator.build_segment(
        fs, {k: v[:half] for k, v in fact.items()}, str(base / "f0"),
        tc.TableConfig(table_name="orders"), "f0"))
    if consuming:
        ms = mut.MutableSegment(fs, "orders__0__0__rt")
        ms.index_batch([{k: fact[k][i].item() for k in fact}
                        for i in range(half, N_FACT)])
        eng.add_segment("orders", ms)
    else:
        eng.add_segment("orders", creator.build_segment(
            fs, {k: v[half:] for k, v in fact.items()}, str(base / "f1"),
            tc.TableConfig(table_name="orders"), "f1"))
    for name, schema, data in (("parts", ps_, parts), ("custs", cs, custs)):
        eng.add_segment(name, creator.build_segment(
            schema, data, str(base / name),
            tc.TableConfig(table_name=name, is_dim_table=True), f"{name}0"))
        eng.table(name).is_dim_table = True
    return eng


def oracle_db(fact, parts, custs):
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE orders (partkey INT, custkey INT, "
                "status TEXT, qty INT, price REAL)")
    con.executemany(
        "INSERT INTO orders VALUES (?,?,?,?,?)",
        list(zip(*(fact[c].tolist() for c in
                   ("partkey", "custkey", "status", "qty", "price")))))
    con.execute("CREATE TABLE parts (pkey INT, category TEXT, brand TEXT)")
    con.executemany("INSERT INTO parts VALUES (?,?,?)",
                    list(zip(*(parts[c].tolist() for c in
                               ("pkey", "category", "brand")))))
    con.execute("CREATE TABLE custs (ckey INT, region TEXT)")
    con.executemany("INSERT INTO custs VALUES (?,?)",
                    list(zip(*(custs[c].tolist() for c in
                               ("ckey", "region")))))
    return con


def engines(tmp_path_factory, tag, seed=11, consuming=False):
    rng = np.random.default_rng(seed)
    fact, parts, custs = make_data(rng)
    out = {"ref": load("ref", new_engine("ref"),
                       tmp_path_factory.mktemp(f"{tag}r"), fact, parts,
                       custs, consuming)}
    for gname, gate in GATES.items():
        out[gname] = load("port", new_engine("port", gate),
                          tmp_path_factory.mktemp(f"{tag}{gname}"), fact,
                          parts, custs, consuming)
    return out, oracle_db(fact, parts, custs)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return engines(tmp_path_factory, "join")


def norm(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        f = float(v)
        return None if math.isnan(f) else round(f, 6)
    return v


def rows_close(got, want) -> bool:
    """Integers bit for bit, floats as tests/test_pallas_scatter.py's
    ``_rows_close`` (rtol 1e-5, atol 1e-6), strings exactly."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, str) or y is None or isinstance(y, bool):
                if x != y or type(x) is not type(y):
                    return False
            elif isinstance(y, int):
                if not isinstance(x, int) or x != y:
                    return False
            elif not (isinstance(x, float) and (
                    (math.isnan(x) and math.isnan(y))
                    or np.isclose(x, y, rtol=1e-5, atol=1e-6))):
                return False
    return True


def same(got: dict, want: dict, stats=STATS) -> None:
    """Rows, dataSchema and every stat of a response; the roofline's
    records by label."""
    assert want.get("exceptions") == [], want.get("exceptions")
    assert got.get("exceptions") == [], got.get("exceptions")
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    g, w = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert rows_close(g, w), (g[:5], w[:5])
    for key in stats:
        assert got.get(key) == want.get(key), (key, got.get(key),
                                               want.get(key))
    assert [r["kernel"] for r in got.get("roofline", ())] == \
        [r["kernel"] for r in want.get("roofline", ())]


def check(setup, sql, oracle_sql=None, strategies=("broadcast", "shuffle")):
    eng, con = setup
    expected = None if oracle_sql is None else \
        [[norm(v) for v in r] for r in con.execute(oracle_sql).fetchall()]
    for strat in strategies:
        full = f"{NO_ADVISOR}SET joinStrategy='{strat}'; {sql}"
        want = eng["ref"].execute(full)
        for gname in GATES:
            got = eng[gname].execute(full)
            same(got, want)
            if expected is not None:
                rows = [[norm(v) for v in r]
                        for r in got["resultTable"]["rows"]]
                assert rows == expected, (gname, strat, rows[:5],
                                          expected[:5])


# test_join.py's TestJoinParity: (port SQL, sqlite SQL)
PARITY = {
    "inner_group_by": (
        "SELECT p.category, SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "GROUP BY p.category ORDER BY p.category LIMIT 20", None),
    "left_join_group_by": (
        "SELECT p.category, COUNT(*) FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey "
        "GROUP BY p.category ORDER BY p.category LIMIT 20",
        "SELECT COALESCE(p.category, ''), COUNT(*) FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey "
        "GROUP BY COALESCE(p.category, '') "
        "ORDER BY COALESCE(p.category, '') LIMIT 20"),
    "inner_selection_order_by": (
        "SELECT o.partkey, p.brand, o.qty FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "WHERE o.qty > 47 AND p.category = 'cat_3' "
        "ORDER BY o.partkey, o.qty LIMIT 15", None),
    "where_pushdown_both_sides": (
        "SELECT p.category, COUNT(*), AVG(o.price) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "WHERE o.status = 'paid' AND p.brand = 'brand_2' "
        "GROUP BY p.category ORDER BY p.category", None),
    "residual_on_conjunct": (
        "SELECT p.category, COUNT(*) FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey AND o.qty < 10 "
        "GROUP BY p.category ORDER BY p.category",
        "SELECT COALESCE(p.category, ''), COUNT(*) FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey AND o.qty < 10 "
        "GROUP BY COALESCE(p.category, '') "
        "ORDER BY COALESCE(p.category, '')"),
    "star_two_dim_chain": (
        "SELECT p.category, c.region, SUM(o.price) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "JOIN custs c ON o.custkey = c.ckey "
        "WHERE o.status <> 'void' "
        "GROUP BY p.category, c.region "
        "ORDER BY p.category, c.region LIMIT 50", None),
    "multi_column_key": (
        "SELECT COUNT(*) FROM orders o JOIN parts p "
        "ON o.partkey = p.pkey AND o.partkey = p.pkey",
        "SELECT COUNT(*) FROM orders o JOIN parts p "
        "ON o.partkey = p.pkey"),
    "having_on_join": (
        "SELECT p.category, SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "GROUP BY p.category HAVING SUM(o.qty) > 6000 "
        "ORDER BY p.category", None),
    "inner_join_no_matches": (
        "SELECT COUNT(*), SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey WHERE p.category = 'nope'",
        None),
    "join_strategy_default": (
        "SELECT COUNT(*) FROM orders o JOIN parts p "
        "ON o.partkey = p.pkey", None),
}


class TestJoinParity:
    @pytest.mark.parametrize("strategy", ["broadcast", "shuffle"])
    @pytest.mark.parametrize("name", list(PARITY))
    def test_parity(self, setup, name, strategy):
        sql, oracle_sql = PARITY[name]
        check(setup, sql, oracle_sql or sql, strategies=(strategy,))

    def test_join_strategy_reported(self, setup):
        eng, _ = setup
        for gname in GATES:
            r = eng[gname].execute(
                "SET joinStrategy='shuffle'; SELECT COUNT(*) FROM orders o "
                "JOIN parts p ON o.partkey = p.pkey")
            assert r["joinStrategy"] == "SHUFFLE" and r["numStages"] == 2
            r = eng[gname].execute(
                "SELECT COUNT(*) FROM orders o JOIN parts p "
                "ON o.partkey = p.pkey")
            # both dims are flagged is_dim_table: BROADCAST by default
            assert r["joinStrategy"] == "BROADCAST"

    @pytest.mark.parametrize("sql", [
        "SELECT o.partkey, p.category, o.qty, o.price FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey LIMIT 40",
        "SELECT o.custkey, c.region, p.brand FROM orders o "
        "JOIN custs c ON o.custkey = c.ckey "
        "LEFT JOIN parts p ON o.partkey = p.pkey "
        "WHERE o.qty < 4 LIMIT 60",
        "SELECT o.status, p.pkey FROM orders o "
        "JOIN parts p ON o.custkey = p.pkey "
        "JOIN parts q ON o.custkey = q.pkey LIMIT 25 OFFSET 5",
        "SET joinStrategy='distributed'; SELECT p.brand, o.qty "
        "FROM orders o JOIN parts p ON o.partkey = p.pkey "
        "WHERE p.category IN ('cat_1', 'cat_4') LIMIT 33",
    ])
    def test_selection_without_order_by_keeps_row_order(self, setup, sql):
        """A selection without ORDER BY returns the reference's joined
        order: probe-major, each probe row's matches in build-row order,
        LEFT misses after the matches."""
        eng, _ = setup
        want = eng["ref"].execute(NO_ADVISOR + sql)
        for gname in GATES:
            same(eng[gname].execute(NO_ADVISOR + sql), want)

    @pytest.mark.parametrize("sql", [
        # expressions over joined rows: torch forms, numpy per distinct
        # tuple, a post-join filter on a LEFT join's build side
        "SELECT p.category, SUM(o.qty * 2 + 1), MAX(o.price / o.qty), "
        "MIN(o.price) FROM orders o JOIN parts p ON o.partkey = p.pkey "
        "GROUP BY p.category ORDER BY p.category",
        "SELECT UPPER(p.brand), COUNT(*) FROM orders o "
        "LEFT JOIN parts p ON o.partkey = p.pkey "
        "WHERE p.brand <> 'brand_3' OR o.qty > 40 "
        "GROUP BY UPPER(p.brand) ORDER BY COUNT(*) DESC, UPPER(p.brand)",
        "SELECT DISTINCT c.region, o.status FROM orders o "
        "JOIN custs c ON o.custkey = c.ckey ORDER BY c.region, o.status "
        "LIMIT 20",
        "SELECT DISTINCTCOUNT(o.custkey), DISTINCTCOUNTHLL(p.brand), "
        "MINMAXRANGE(o.qty), AVG(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey WHERE o.price > 100",
        "SELECT c.region, DISTINCTCOUNT(p.category), "
        "DISTINCTCOUNTHLL(o.partkey), SUM(o.price) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "JOIN custs c ON o.custkey = c.ckey "
        "GROUP BY c.region ORDER BY c.region",
        "SELECT o.qty, p.category FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey "
        "ORDER BY p.category DESC, o.price DESC, o.qty LIMIT 12 OFFSET 3",
        "SELECT p.category, COUNT(*) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey AND o.price > 250.5 "
        "GROUP BY p.category ORDER BY p.category",
        "SELECT COUNT(*), SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey WHERE o.qty > 1000",
        "SELECT p.category, AVG(o.qty), SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey WHERE o.qty > 1000 "
        "GROUP BY p.category",
    ])
    def test_shapes_over_joined_rows(self, setup, sql):
        eng, _ = setup
        want = eng["ref"].execute(NO_ADVISOR + sql)
        for gname in GATES:
            same(eng[gname].execute(NO_ADVISOR + sql), want)


class TestConsumingJoin:
    @pytest.fixture(scope="class")
    def consuming(self, tmp_path_factory):
        return engines(tmp_path_factory, "rt", seed=13, consuming=True)

    @pytest.mark.parametrize("strategy", ["broadcast", "shuffle"])
    def test_sealed_plus_consuming_parity(self, consuming, strategy):
        sql = ("SELECT p.category, COUNT(*), SUM(o.qty) FROM orders o "
               "JOIN parts p ON o.partkey = p.pkey "
               "GROUP BY p.category ORDER BY p.category")
        check(consuming, sql, sql, strategies=(strategy,))

    def test_left_join_on_consuming(self, consuming):
        check(consuming,
              "SELECT o.partkey, p.category FROM orders o "
              "LEFT JOIN parts p ON o.partkey = p.pkey "
              "WHERE o.qty = 7 ORDER BY o.partkey, p.category LIMIT 25",
              "SELECT o.partkey, COALESCE(p.category,'') FROM orders o "
              "LEFT JOIN parts p ON o.partkey = p.pkey "
              "WHERE o.qty = 7 ORDER BY o.partkey, COALESCE(p.category,'') "
              "LIMIT 25", strategies=("broadcast",))

    def test_selection_order_over_consuming(self, consuming):
        eng, _ = consuming
        sql = (NO_ADVISOR + "SELECT o.partkey, o.status, p.brand "
               "FROM orders o JOIN parts p ON o.partkey = p.pkey "
               "WHERE o.qty > 45 LIMIT 50")
        want = eng["ref"].execute(sql)
        for gname in GATES:
            same(eng[gname].execute(sql), want)


class TestLookupSuperset:
    """LEFT JOIN equals LOOKUP against the same dim table, in the port
    and against the reference."""

    def test_left_join_matches_lookup_bit_identical(self, setup):
        eng, _ = setup
        lookup_sql = (
            "SELECT partkey, LOOKUP('parts', 'category', 'pkey', "
            "partkey), qty FROM orders ORDER BY partkey, qty, "
            "LOOKUP('parts', 'category', 'pkey', partkey) LIMIT 200")
        join_sql = (
            "SELECT o.partkey, p.category, o.qty FROM orders o "
            "LEFT JOIN parts p ON o.partkey = p.pkey "
            "ORDER BY o.partkey, o.qty, p.category LIMIT 200")
        want = eng["ref"].execute(lookup_sql)
        for gname in GATES:
            via_lookup = eng[gname].execute(lookup_sql)
            via_join = eng[gname].execute(join_sql)
            assert not via_lookup["exceptions"], via_lookup["exceptions"]
            assert not via_join["exceptions"], via_join["exceptions"]
            assert via_join["resultTable"]["rows"] == \
                via_lookup["resultTable"]["rows"] == \
                want["resultTable"]["rows"]

    def test_lookup_numeric_default_matches_left_join(self, setup):
        eng, _ = setup
        for gname in GATES:
            via_lookup = eng[gname].execute(
                "SELECT SUM(LOOKUP('parts', 'pkey', 'pkey', partkey)) "
                "FROM orders")
            via_join = eng[gname].execute(
                "SELECT SUM(p.pkey) FROM orders o LEFT JOIN parts p "
                "ON o.partkey = p.pkey")
            assert via_join["resultTable"]["rows"] == \
                via_lookup["resultTable"]["rows"]
            same(via_join, eng["ref"].execute(
                NO_ADVISOR + "SELECT SUM(p.pkey) FROM orders o "
                "LEFT JOIN parts p ON o.partkey = p.pkey"))


def _message(resp) -> str:
    assert resp["exceptions"], resp
    return resp["exceptions"][0]["message"]


class TestDiagnostics:
    @pytest.mark.parametrize("sql", [
        "SELECT p.nosuch FROM orders o JOIN parts p ON o.partkey = p.pkey",
        "SELECT nosuch FROM orders o JOIN parts p ON o.partkey = p.pkey",
        "SELECT COUNT(*) FROM orders o JOIN parts p ON o.partkey > p.pkey",
        "SELECT COUNT(*) FROM orders o JOIN parts o ON o.partkey = o.pkey",
        "SELECT COUNT(*) FROM orders o JOIN nope n ON o.partkey = n.k",
        "SELECT o.$docId FROM orders o JOIN parts p ON o.partkey = p.pkey",
        "SET joinStrategy='sideways'; SELECT COUNT(*) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey",
    ])
    def test_same_typed_errors(self, setup, sql):
        eng, _ = setup
        want = _message(eng["ref"].execute(sql))
        for gname in GATES:
            assert _message(eng[gname].execute(sql)) == want

    def test_unknown_column_names_alias_and_candidates(self, setup):
        msg = _message(setup[0]["gate"].execute(
            "SELECT p.nosuch FROM orders o JOIN parts p "
            "ON o.partkey = p.pkey"))
        assert "nosuch" in msg and "'p'" in msg and "category" in msg

    def test_ambiguous_column_names_candidate_aliases(self, tmp_path):
        got = {}
        for side in MODS:
            sc, dt, tc, creator, _m = MODS[side]
            DT = dt.DataType
            eng = new_engine(side)
            data = {"k": np.arange(4, dtype=np.int32),
                    "v": np.arange(4, dtype=np.int32)}
            for t in ("t1", "t2"):
                eng.add_segment(t, creator.build_segment(
                    sc.Schema.build(name=t, dimensions=[("k", DT.INT)],
                                    metrics=[("v", DT.INT)]),
                    data, str(tmp_path / f"{side}{t}"),
                    tc.TableConfig(table_name=t), f"{t}0"))
            got[side] = _message(eng.execute(
                "SELECT v FROM t1 a JOIN t2 b ON a.k = b.k"))
        assert got["port"] == got["ref"]
        assert "ambiguous" in got["port"] and "a.v" in got["port"]

    def test_analysis_error_is_typed(self):
        from pinot_tpu_torch.query2.logical import compile_plan
        from pinot_tpu_torch.sql.parser import SqlAnalysisError, parse_sql

        stmt = parse_sql("SELECT x.nope FROM f x JOIN d y ON x.a = y.b")
        with pytest.raises(SqlAnalysisError) as ei:
            compile_plan(stmt, lambda table: (("a", "b"), False))
        assert ei.value.column == "x.nope"
        assert "a" in ei.value.candidates

    def test_mixed_type_join_keys_never_match(self, setup):
        eng, _ = setup
        for kind, want in (("JOIN", 0), ("LEFT JOIN", N_FACT)):
            sql = (NO_ADVISOR + f"SELECT COUNT(*) FROM orders o {kind} "
                   f"parts p ON o.partkey = p.category")
            ref = eng["ref"].execute(sql)
            for gname in GATES:
                r = eng[gname].execute(sql)
                same(r, ref)
                assert r["resultTable"]["rows"][0][0] == want

    def test_heuristic_broadcast_demotes_on_huge_build(self, setup,
                                                       monkeypatch):
        eng, _ = setup
        monkeypatch.setattr(t_runner, "BROADCAST_MAX_BUILD_ROWS", 10)
        r = eng["gate"].execute("SELECT COUNT(*) FROM orders o JOIN parts p "
                                "ON o.partkey = p.pkey")
        assert r["joinStrategy"] == "SHUFFLE"
        r = eng["gate"].execute(
            "SET joinStrategy='broadcast'; SELECT COUNT(*) FROM orders o "
            "JOIN parts p ON o.partkey = p.pkey")
        assert r["joinStrategy"] == "BROADCAST"

    def test_stage1_cap_refused_as_reference(self, setup, monkeypatch):
        import pinot_tpu.query2.runner as r_runner

        eng, _ = setup
        monkeypatch.setattr(r_runner, "MAX_STAGE1_ROWS", 1500)
        monkeypatch.setattr(t_runner, "MAX_STAGE1_ROWS", 1500)
        sql = ("SELECT COUNT(*) FROM orders o JOIN parts p "
               "ON o.partkey = p.pkey")
        want = _message(eng["ref"].execute(sql))
        assert "exceeds 1500 rows" in want
        for gname in GATES:
            assert _message(eng[gname].execute(sql)) == want
        # a pushed-down filter under the cap answers
        ok = sql + " WHERE o.qty < 10"
        same(eng["gate"].execute(NO_ADVISOR + ok),
             eng["ref"].execute(NO_ADVISOR + ok))

    def test_join_pair_cap_refused_as_reference(self, setup, monkeypatch):
        import pinot_tpu.query2.runner as r_runner

        eng, _ = setup
        monkeypatch.setattr(r_runner, "MAX_JOIN_PAIRS", 5000)
        monkeypatch.setattr(t_runner, "MAX_JOIN_PAIRS", 5000)
        # a non-unique build: orders against itself by status
        sql = ("SELECT COUNT(*) FROM orders a JOIN orders b "
               "ON a.status = b.status WHERE a.qty < 3")
        want = _message(eng["ref"].execute(sql))
        assert "matched pairs" in want
        for gname in GATES:
            assert _message(eng[gname].execute(sql)) == want

    def test_unported_stage2_aggregation_refused(self, setup):
        """Stage 2 refuses no aggregation the reference answers: the
        digests and sketches run over the joined rows as a batch
        (tests/test_torch_stage2_aggs.py holds each); only an MV
        aggregation is refused, with the reference's own error."""
        eng, _ = setup
        sql = (NO_ADVISOR + "SELECT p.category, PERCENTILE(o.qty, 50) "
               "FROM orders o JOIN parts p ON o.partkey = p.pkey "
               "GROUP BY p.category ORDER BY p.category")
        want = eng["ref"].execute(sql)
        for gname in GATES:
            same(eng[gname].execute(sql), want)
        sql = (NO_ADVISOR + "SELECT SUMMV(o.qty) FROM orders o "
               "JOIN parts p ON o.partkey = p.pkey")
        want = _message(eng["ref"].execute(sql))
        assert _message(eng["gate"].execute(sql)) == want

    def test_cold_segment_refused(self, setup, monkeypatch):
        """A cold segment in a leaf answers nothing, as in the reference:
        it counts in numSegmentsCold, its docs in totalDocs, and the
        response is partial. (The tiers came with ROADMAP item m3; before,
        the port refused the leaf in-band.)"""
        eng, _ = setup
        sql = ("SELECT COUNT(*) FROM orders o JOIN parts p "
               "ON o.partkey = p.pkey")
        for side in ("ref", "gate"):
            seg = next(iter(eng[side].table("parts").segments.values()))
            monkeypatch.setattr(seg, "is_cold", True, raising=False)
        want = eng["ref"].execute(NO_ADVISOR + sql)
        got = eng["gate"].execute(NO_ADVISOR + sql)
        same(got, want)
        assert got["numSegmentsCold"] == want["numSegmentsCold"] >= 1
        assert got["partialResult"] is want["partialResult"] is True


class TestExplainJoin:
    @pytest.mark.parametrize("sql", [
        "SET joinStrategy='broadcast'; EXPLAIN PLAN FOR "
        "SELECT p.category, SUM(o.qty) FROM orders o "
        "JOIN parts p ON o.partkey = p.pkey GROUP BY p.category",
        "SET joinStrategy='shuffle'; EXPLAIN PLAN FOR "
        "SELECT o.partkey FROM orders o LEFT JOIN parts p "
        "ON o.partkey = p.pkey WHERE o.qty > 5",
        "EXPLAIN PLAN FOR SELECT p.category, c.region, COUNT(*) "
        "FROM orders o JOIN parts p ON o.partkey = p.pkey AND o.qty < 9 "
        "LEFT JOIN custs c ON o.custkey = c.ckey "
        "WHERE c.region <> 'region_1' AND o.status = 'paid' "
        "GROUP BY p.category, c.region HAVING COUNT(*) > 2",
    ])
    def test_explain_lines_are_the_reference(self, setup, sql):
        eng, _ = setup
        want = [r[0].replace("DEVICE(jax/xla)", "DEVICE(torch/cuda)")
                for r in eng["ref"].execute(sql)["resultTable"]["rows"]]
        for gname in GATES:
            got = eng[gname].execute(sql)
            assert [r[0] for r in got["resultTable"]["rows"]] == want
            assert any(ln.strip().startswith("STAGE_BOUNDARY")
                       and "[local]" in ln for ln in want)

    def test_explain_analyze_actuals(self, setup):
        eng, _ = setup
        sql = ("EXPLAIN ANALYZE SELECT p.category, SUM(o.qty) FROM orders o "
               "JOIN parts p ON o.partkey = p.pkey WHERE o.qty > 10 "
               "GROUP BY p.category ORDER BY p.category")
        want = eng["ref"].execute(NO_ADVISOR + sql)
        got = eng["gate"].execute(NO_ADVISOR + sql)
        same(got["analyzedResponse"], want["analyzedResponse"])

        def lines(resp):
            return [r[0].replace("DEVICE(jax/xla)", "DEVICE(torch/cuda)")
                    for r in resp["resultTable"]["rows"]
                    if not r[0].strip().startswith(("PHASE(", "KERNEL("))]

        drop_time = [ln.split(" (actual: rows=")[0] for ln in lines(got)]
        want_lines = [ln.split(" (actual: rows=")[0] for ln in lines(want)]
        assert drop_time == want_lines
        phases = [r[0] for r in got["resultTable"]["rows"]
                  if r[0].strip().startswith("PHASE(")]
        assert len(phases) == 1 and "host_scan=" in phases[0] \
            and "stage2=" in phases[0]


def test_stage2_sums_reach_k1(tmp_path, monkeypatch):
    """A join of >= 2^17 joined rows: its COUNT and integer SUM reach
    ``group_scatter.plane_group_sums`` (one call, count and the integer
    planes), a float SUM does not; the answers equal the reference's."""
    rng = np.random.default_rng(5)
    n = (1 << 17) + 3000
    fact = {"partkey": rng.integers(0, N_PARTS, n).astype(np.int32),
            "custkey": rng.integers(0, N_CUSTS, n).astype(np.int32),
            "status": np.array(["open", "paid", "void"])[
                rng.integers(0, 3, n)],
            "qty": rng.integers(1, 50, n).astype(np.int32),
            "price": np.round(rng.uniform(1.0, 500.0, n), 2)}
    _f, parts, custs = make_data(rng)
    ref = RefEngine()
    port = QueryEngine(device="cpu")
    for side, eng in (("ref", ref), ("port", port)):
        _sc, _dt, tc, creator, _m = MODS[side]
        fs, ps_, _cs = schemas(side)
        eng.add_segment("orders", creator.build_segment(
            fs, fact, str(tmp_path / f"{side}f"),
            tc.TableConfig(table_name="orders"), "f0"))
        eng.add_segment("parts", creator.build_segment(
            ps_, parts, str(tmp_path / f"{side}p"),
            tc.TableConfig(table_name="parts", is_dim_table=True), "p0"))
    calls = []
    real = group_scatter.plane_group_sums

    def spy(gid, sources, num_groups, **kw):
        calls.append((gid.numel(), [s.kind for s in sources], num_groups,
                      kw))
        return real(gid, sources, num_groups, **kw)

    monkeypatch.setattr(group_scatter, "plane_group_sums", spy)
    sql = (NO_ADVISOR + "SELECT p.category, COUNT(*), SUM(o.qty), "
           "AVG(o.custkey), SUM(o.price) FROM orders o "
           "JOIN parts p ON o.partkey = p.pkey "
           "GROUP BY p.category ORDER BY p.category")
    got = port.execute(sql)
    same(got, ref.execute(sql))
    assert got["numJoinedRows"] == n >= 1 << 17
    assert calls == [(n, ["int", "int"], 7, {"count": True})]
    # a float SUM alone never reaches K1
    calls.clear()
    sql2 = (NO_ADVISOR + "SELECT p.category, SUM(o.price) FROM orders o "
            "JOIN parts p ON o.partkey = p.pkey GROUP BY p.category")
    same(port.execute(sql2), ref.execute(sql2))
    assert calls == []
    # below the gate, the torch scatter answers the same
    small = sql + " LIMIT 3"
    port.execute("SELECT COUNT(*) FROM orders")
    port.device.min_rows = n + 1
    calls.clear()
    same(port.execute(small), ref.execute(small))
    assert calls == []
