"""The port's window functions against the reference's, after
tests/test_window.py: TestWindowParity's thirteen queries (ties, DESC,
multi-key, a window over a join), sealed plus consuming segments, the
refusals and EXPLAIN. The reference runs with its device on JAX's CPU,
the port on the CPU at the default kernel gate and at gate 0; rows,
dataSchema and every stat are compared (test_torch_join.py ``same``),
and each query is held to the sqlite oracle too."""

import sqlite3

import numpy as np
import pytest

from test_torch_join import GATES, MODS, NO_ADVISOR, new_engine, norm, same

N = 3000


def schema(side):
    sc, dt = MODS[side][:2]
    DT = dt.DataType
    return sc.Schema.build(
        name="trades",
        dimensions=[("sym", DT.STRING), ("venue", DT.STRING),
                    ("ts", DT.LONG)],
        metrics=[("px", DT.DOUBLE), ("size", DT.INT)])


def dim_schema(side):
    sc, dt = MODS[side][:2]
    DT = dt.DataType
    return sc.Schema.build(
        name="symbols",
        dimensions=[("symbol", DT.STRING), ("sector", DT.STRING)],
        primary_key_columns=["symbol"])


def make_data(rng):
    return {
        "sym": np.array([f"sym_{i}" for i in range(12)])[
            rng.integers(0, 12, N)],
        "venue": np.array(["A", "B", "C"])[rng.integers(0, 3, N)],
        # unique per row: the deterministic ORDER BY tie-break
        "ts": np.arange(N, dtype=np.int64) * 10 + 5,
        "px": np.round(rng.uniform(5.0, 250.0, N), 2),
        "size": rng.integers(1, 500, N).astype(np.int32),
    }


DIM = {"symbol": np.array([f"sym_{i}" for i in range(12)]),
       "sector": np.array([f"sec_{i % 4}" for i in range(12)])}


def load(side, eng, base, data, consuming=False):
    _sc, _dt, tc, creator, mut = MODS[side]
    half = N // 2
    eng.add_segment("trades", creator.build_segment(
        schema(side), {k: v[:half] for k, v in data.items()},
        str(base / "t0"), tc.TableConfig(table_name="trades"), "t0"))
    if consuming:
        ms = mut.MutableSegment(schema(side), "trades__0__0__rt")
        ms.index_batch([{k: data[k][i].item() for k in data}
                        for i in range(half, N)])
        eng.add_segment("trades", ms)
    else:
        eng.add_segment("trades", creator.build_segment(
            schema(side), {k: v[half:] for k, v in data.items()},
            str(base / "t1"), tc.TableConfig(table_name="trades"), "t1"))
    eng.add_segment("symbols", creator.build_segment(
        dim_schema(side), DIM, str(base / "d0"),
        tc.TableConfig(table_name="symbols", is_dim_table=True), "d0"))
    return eng


def oracle_db(data):
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE trades (sym TEXT, venue TEXT, ts INT, "
                "px REAL, size INT)")
    con.executemany(
        "INSERT INTO trades VALUES (?,?,?,?,?)",
        list(zip(*(data[c].tolist() for c in
                   ("sym", "venue", "ts", "px", "size")))))
    con.execute("CREATE TABLE symbols (symbol TEXT, sector TEXT)")
    con.executemany("INSERT INTO symbols VALUES (?,?)",
                    list(zip(DIM["symbol"].tolist(),
                             DIM["sector"].tolist())))
    return con


def engines(tmp_path_factory, tag, seed, consuming=False):
    data = make_data(np.random.default_rng(seed))
    out = {"ref": load("ref", new_engine("ref"),
                       tmp_path_factory.mktemp(f"{tag}r"), data, consuming)}
    for gname, gate in GATES.items():
        out[gname] = load("port", new_engine("port", gate),
                          tmp_path_factory.mktemp(f"{tag}{gname}"), data,
                          consuming)
    return out, oracle_db(data)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return engines(tmp_path_factory, "win", 23)


def check(setup, sql, oracle_sql=None):
    eng, con = setup
    expected = [[norm(v) for v in r]
                for r in con.execute(oracle_sql or sql).fetchall()]
    want = eng["ref"].execute(NO_ADVISOR + sql)
    for gname in GATES:
        got = eng[gname].execute(NO_ADVISOR + sql)
        same(got, want)
        assert [[norm(v) for v in r]
                for r in got["resultTable"]["rows"]] == expected, gname


# test_window.py's TestWindowParity
PARITY = {
    "row_number": (
        "SELECT sym, ts, ROW_NUMBER() OVER (PARTITION BY sym "
        "ORDER BY ts) FROM trades WHERE size > 480 "
        "ORDER BY sym, ts LIMIT 40"),
    "rank_dense_rank_with_ties": (
        "SELECT sym, venue, RANK() OVER (PARTITION BY sym "
        "ORDER BY venue), DENSE_RANK() OVER (PARTITION BY sym "
        "ORDER BY venue) FROM trades WHERE size > 470 "
        "ORDER BY sym, venue, ts LIMIT 50"),
    "running_sum": (
        "SELECT sym, ts, SUM(size) OVER (PARTITION BY sym "
        "ORDER BY ts) FROM trades WHERE size > 450 "
        "ORDER BY sym, ts LIMIT 60"),
    "running_sum_peers_share_frame": (
        "SELECT sym, venue, SUM(size) OVER (PARTITION BY sym "
        "ORDER BY venue) FROM trades WHERE size > 480 "
        "ORDER BY sym, venue, ts LIMIT 50"),
    "avg_count_min_max": (
        "SELECT sym, ts, AVG(px) OVER (PARTITION BY sym "
        "ORDER BY ts), COUNT(px) OVER (PARTITION BY sym "
        "ORDER BY ts), MIN(px) OVER (PARTITION BY sym "
        "ORDER BY ts), MAX(px) OVER (PARTITION BY sym ORDER BY ts) "
        "FROM trades WHERE size > 460 ORDER BY sym, ts LIMIT 60"),
    "partition_total_no_order": (
        "SELECT sym, ts, SUM(size) OVER (PARTITION BY sym) "
        "FROM trades WHERE size > 470 ORDER BY sym, ts LIMIT 50"),
    "no_partition_global_window": (
        "SELECT ts, ROW_NUMBER() OVER (ORDER BY ts) "
        "FROM trades WHERE size > 490 ORDER BY ts LIMIT 40"),
    "descending_order": (
        "SELECT sym, ts, ROW_NUMBER() OVER (PARTITION BY sym "
        "ORDER BY ts DESC) FROM trades WHERE size > 480 "
        "ORDER BY sym, ts LIMIT 40"),
    "multi_key_partition_and_order": (
        "SELECT sym, venue, ts, ROW_NUMBER() OVER (PARTITION BY "
        "sym, venue ORDER BY px DESC, ts) FROM trades "
        "WHERE size > 475 ORDER BY sym, venue, ts LIMIT 50"),
    "count_star_window": (
        "SELECT sym, ts, COUNT(*) OVER (PARTITION BY sym "
        "ORDER BY ts) FROM trades WHERE size > 480 "
        "ORDER BY sym, ts LIMIT 40"),
    "window_in_expression": (
        "SELECT sym, ts, ROW_NUMBER() OVER (PARTITION BY sym "
        "ORDER BY ts) + 100 FROM trades WHERE size > 485 "
        "ORDER BY sym, ts LIMIT 30"),
    "order_by_window_result": (
        "SELECT sym, ts, SUM(size) OVER (PARTITION BY sym "
        "ORDER BY ts) FROM trades WHERE size > 480 "
        "ORDER BY SUM(size) OVER (PARTITION BY sym ORDER BY ts), "
        "sym, ts LIMIT 30"),
    "window_over_join": (
        "SELECT s.sector, t.ts, ROW_NUMBER() OVER (PARTITION BY "
        "s.sector ORDER BY t.ts) FROM trades t "
        "JOIN symbols s ON t.sym = s.symbol WHERE t.size > 485 "
        "ORDER BY s.sector, t.ts LIMIT 40"),
}


class TestWindowParity:
    @pytest.mark.parametrize("name", list(PARITY))
    def test_parity(self, setup, name):
        check(setup, PARITY[name])

    @pytest.mark.parametrize("sql", [
        # ties in every function over a tied key, no LIMIT trim between
        "SELECT sym, venue, RANK() OVER (PARTITION BY venue ORDER BY sym "
        "DESC), DENSE_RANK() OVER (ORDER BY venue DESC, sym), COUNT(*) "
        "OVER (PARTITION BY venue ORDER BY sym), MIN(size) OVER "
        "(PARTITION BY sym ORDER BY venue), MAX(px) OVER (PARTITION BY "
        "sym ORDER BY venue DESC), AVG(size) OVER (PARTITION BY venue) "
        "FROM trades WHERE px < 20 ORDER BY ts",
        # a window over a LEFT join's build column and an expression key
        "SELECT t.ts, s.sector, SUM(t.px) OVER (PARTITION BY s.sector "
        "ORDER BY t.size * 2, t.ts DESC) FROM trades t "
        "LEFT JOIN symbols s ON t.sym = s.symbol WHERE t.size < 15 "
        "ORDER BY t.ts",
        # window rows in joined order, no ORDER BY
        "SELECT sym, ROW_NUMBER() OVER (PARTITION BY venue ORDER BY px) "
        "FROM trades WHERE size > 495",
    ])
    def test_window_shapes(self, setup, sql):
        eng, _ = setup
        want = eng["ref"].execute(NO_ADVISOR + sql)
        for gname in GATES:
            same(eng[gname].execute(NO_ADVISOR + sql), want)


class TestWindowConsuming:
    def test_consuming_segment_parity(self, tmp_path_factory):
        setup = engines(tmp_path_factory, "winrt", 29, consuming=True)
        check(setup,
              "SELECT sym, ts, ROW_NUMBER() OVER (PARTITION BY sym "
              "ORDER BY ts), SUM(size) OVER (PARTITION BY sym "
              "ORDER BY ts) FROM trades WHERE size > 460 "
              "ORDER BY sym, ts LIMIT 60")


class TestWindowErrors:
    @pytest.mark.parametrize("sql, words", [
        ("SELECT sym, SUM(size), ROW_NUMBER() OVER (ORDER BY sym) "
         "FROM trades GROUP BY sym", "GROUP BY"),
        ("SELECT sym FROM trades "
         "WHERE ROW_NUMBER() OVER (ORDER BY ts) < 5", ""),
        ("SELECT SUM(size) OVER (ORDER BY ts ROWS BETWEEN 1 "
         "PRECEDING AND CURRENT ROW) FROM trades", "frame"),
        ("SELECT NTILE(4) OVER (ORDER BY ts) FROM trades",
         "not a window function"),
        ("SELECT SUM(size) OVER (PARTITION BY SUM(px)) FROM trades",
         ""),
    ])
    def test_refused_as_reference(self, setup, sql, words):
        eng, _ = setup
        want = eng["ref"].execute(sql)["exceptions"]
        assert want and words in want[0]["message"]
        for gname in GATES:
            assert eng[gname].execute(sql)["exceptions"] == want


class TestExplainWindow:
    @pytest.mark.parametrize("sql", [
        "EXPLAIN PLAN FOR SELECT sym, ROW_NUMBER() OVER "
        "(PARTITION BY sym ORDER BY ts DESC) FROM trades",
        "EXPLAIN PLAN FOR SELECT s.sector, SUM(t.size) OVER (PARTITION BY "
        "s.sector) FROM trades t JOIN symbols s ON t.sym = s.symbol "
        "WHERE t.px > 5",
    ])
    def test_explain_window_lines(self, setup, sql):
        eng, _ = setup
        want = [r[0].replace("DEVICE(jax/xla)", "DEVICE(torch/cuda)")
                for r in eng["ref"].execute(sql)["resultTable"]["rows"]]
        for gname in GATES:
            got = [r[0] for r in
                   eng[gname].execute(sql)["resultTable"]["rows"]]
            assert got == want
        assert any("STAGE_2_SELECT_WINDOW" in ln for ln in want)
