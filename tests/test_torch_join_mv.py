"""Multi-value columns through the port's joins, and numbers compared with
string literals on joined rows, against the reference.

Tables: ``m`` (two fact segments: ``i``, ``k``, ``v`` and the MV columns
``tags`` STRING and ``ports`` INT) and ``d`` (a dimension table: ``pk``,
``nm``, ``bs``), made from a seed. ``k`` takes 1,278 rows into ``d``, 217
of them onto the key whose ``bs`` is 'a', the counts of the re-anchor's
probes: ``x.i = 'abc' OR y.bs = 'a'`` counts 217 and ``x.i <> '5' OR
y.bs = 'a'`` counts 1,278. An MV column is selected, filtered in its
leaf, carried through a LEFT join's build side and beside a window as
the reference answers it; where the reference's numpy fails on the
per-doc arrays (a key, an ORDER BY, a PARTITION BY, a comparison after
the join) the port fails with the same exception class, and an MV
aggregation over joined rows with the reference's SqlAnalysisError."""

import numpy as np
import pytest

from test_torch_join import MODS, NO_ADVISOR, same

N_FACT = 1_278
N_A = 217
N_DIM = 40

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched", "totalDocs",
         "numStages", "numJoinedRows", "leafRows", "joinStrategy")


def make_data(seed=5):
    rng = np.random.default_rng(seed)
    # key 0 is the one whose bs is 'a'; keys past 30 have no fact row
    k = np.concatenate([np.zeros(N_A, dtype=np.int32),
                        rng.integers(1, 30, N_FACT - N_A).astype(np.int32)])
    rng.shuffle(k)
    tags = np.array(["a", "b", "c", "d", "e"])
    fact = {
        "i": rng.integers(0, 60, N_FACT).astype(np.int32),
        "k": k,
        "v": rng.integers(0, 1000, N_FACT).astype(np.int32),
        "tags": [list(tags[rng.integers(0, 5, int(rng.integers(0, 4)))])
                 for _ in range(N_FACT)],
        "ports": [rng.integers(0, 50, int(rng.integers(1, 3)))
                  .astype(np.int32).tolist() for _ in range(N_FACT)],
    }
    dim = {
        "pk": np.arange(N_DIM, dtype=np.int32),
        "nm": np.array([f"n{j % 4}" for j in range(N_DIM)]),
        "bs": np.array(["a"] + [["b", "c", "zz"][j % 3]
                                for j in range(1, N_DIM)]),
    }
    return fact, dim


def load(side, eng, base, fact, dim):
    sc, dt, tc, creator, _mut = MODS[side]
    DT = dt.DataType
    fs = sc.Schema.build(
        name="m", dimensions=[("i", DT.INT), ("k", DT.INT)],
        metrics=[("v", DT.INT)],
        multi_value_dimensions=[("tags", DT.STRING), ("ports", DT.INT)])
    ds = sc.Schema.build(
        name="d", dimensions=[("pk", DT.INT), ("nm", DT.STRING),
                              ("bs", DT.STRING)],
        primary_key_columns=["pk"])
    half = N_FACT // 2
    for j, sl in enumerate((slice(0, half), slice(half, N_FACT))):
        part = {c: (v[sl] if isinstance(v, np.ndarray) else v[sl])
                for c, v in fact.items()}
        eng.add_segment("m", creator.build_segment(
            fs, part, str(base / f"m{j}"), tc.TableConfig(table_name="m"),
            f"m{j}"))
    eng.add_segment("d", creator.build_segment(
        ds, dim, str(base / "d"),
        tc.TableConfig(table_name="d", is_dim_table=True), "d0"))
    eng.table("d").is_dim_table = True
    return eng


@pytest.fixture(scope="module")
def engs(tmp_path_factory):
    from pinot_tpu.engine.engine import QueryEngine as RefEngine
    from pinot_tpu_torch.engine.engine import QueryEngine

    fact, dim = make_data()
    out = {"ref": load("ref", RefEngine(), tmp_path_factory.mktemp("mvr"),
                       fact, dim)}
    for name, gate in (("gate", None), ("gate0", 0)):
        eng = QueryEngine(device="cpu")
        if gate is not None:
            eng.device.min_rows = gate
        out[name] = load("port", eng, tmp_path_factory.mktemp(f"mv{name}"),
                         fact, dim)
    return out


def lists_as_text(resp: dict) -> dict:
    """Per-doc lists compared exactly, as their repr: the values and
    their Python types."""
    rows = resp.get("resultTable", {}).get("rows")
    if rows:
        resp["resultTable"]["rows"] = [
            [repr(v) if isinstance(v, list) else v for v in r] for r in rows]
    return resp


def check(engs, sql, strategies=("broadcast", "shuffle")):
    for strat in strategies:
        full = f"{NO_ADVISOR}SET joinStrategy='{strat}'; {sql}"
        want = lists_as_text(engs["ref"].execute(full))
        for name in ("gate", "gate0"):
            same(lists_as_text(engs[name].execute(full)), want, STATS)
    return want


JOIN = "FROM m x JOIN d y ON x.k = y.pk"

MV_SHAPES = {
    "selected": f"SELECT x.tags, y.nm {JOIN} LIMIT 30",
    "selected_int_ordered": (
        f"SELECT x.i, x.ports, x.tags, y.nm {JOIN} WHERE x.i < 20 "
        "ORDER BY x.i, x.v LIMIT 40"),
    "leaf_filter": (
        f"SELECT y.nm, COUNT(*) {JOIN} WHERE x.tags = 'a' "
        "GROUP BY y.nm ORDER BY y.nm"),
    "leaf_filter_selected": (
        f"SELECT x.ports, y.nm {JOIN} WHERE x.ports > 20 AND y.bs = 'b' "
        "LIMIT 25"),
    "leaf_filter_in": (
        f"SELECT COUNT(*), SUM(x.v) {JOIN} WHERE x.tags IN ('b', 'e')"),
    "left_join_build_side": (
        "SELECT y.pk, x.tags, x.ports FROM d y LEFT JOIN m x "
        "ON y.pk = x.k WHERE y.pk > 26 ORDER BY y.pk, x.v LIMIT 40"),
    "window_carries": (
        f"SELECT x.i, x.tags, ROW_NUMBER() OVER (PARTITION BY y.nm "
        f"ORDER BY x.v) {JOIN} WHERE x.i < 5 ORDER BY x.i, x.v LIMIT 30"),
    "count_only": f"SELECT COUNT(*) {JOIN} WHERE x.ports < 10",
}


@pytest.mark.parametrize("name", list(MV_SHAPES))
def test_mv_shapes(engs, name):
    check(engs, MV_SHAPES[name])


MV_REFUSED = {
    "mv_aggregation": f"SELECT SUMMV(x.ports) {JOIN}",
    "mv_aggregation_grouped": (
        f"SELECT y.nm, COUNTMV(x.tags) {JOIN} GROUP BY y.nm"),
    "group_by_mv": f"SELECT x.tags, COUNT(*) {JOIN} GROUP BY x.tags",
    "order_by_mv": f"SELECT y.nm, x.ports {JOIN} ORDER BY x.ports LIMIT 3",
    "compare_after_join": (
        f"SELECT COUNT(*) {JOIN} WHERE x.tags = 'a' OR y.nm = 'n1'"),
    # the reference's stage 2 has no dimension-table resolver: LOOKUP
    # beside an MV column fails there
    "lookup_beside": (
        f"SELECT x.tags, LOOKUP('d', 'nm', 'pk', x.k) {JOIN} "
        "WHERE x.i = 7 LIMIT 20"),
    "partition_by_mv": (
        f"SELECT x.k, ROW_NUMBER() OVER (PARTITION BY x.ports "
        f"ORDER BY x.v) {JOIN} LIMIT 3"),
}


def _error(resp) -> str:
    assert resp["exceptions"], resp
    return resp["exceptions"][0]["message"]


@pytest.mark.parametrize("name", list(MV_REFUSED))
def test_mv_refused_as_reference(engs, name):
    sql = NO_ADVISOR + MV_REFUSED[name]
    want = _error(engs["ref"].execute(sql))
    for port in ("gate", "gate0"):
        got = _error(engs[port].execute(sql))
        assert got.split(":")[0] == want.split(":")[0], (got, want)
        if not want.startswith("ValueError: The truth value"):
            assert got == want


def test_mv_aggregation_message(engs):
    msg = _error(engs["gate"].execute(NO_ADVISOR + MV_REFUSED[
        "mv_aggregation"]))
    assert msg == ("SqlAnalysisError: multi-value aggregation summv() is "
                   "not supported over joined rows")


STRING_LITERALS = {
    "eq_or": (f"SELECT COUNT(*) {JOIN} WHERE x.i = 'abc' OR y.bs = 'a'",
              N_A),
    "not_eq_or": (
        f"SELECT COUNT(*) {JOIN} WHERE x.i <> '5' OR y.bs = 'a'", N_FACT),
    "in_or": (
        f"SELECT COUNT(*) {JOIN} WHERE x.i IN ('5', 'abc') OR y.bs = 'a'",
        None),
    "not_in_or": (
        f"SELECT COUNT(*) {JOIN} WHERE x.i NOT IN ('5', '7') "
        "OR y.bs = 'zz'", None),
    "numeric_in_mixed": (
        f"SELECT COUNT(*) {JOIN} WHERE x.i IN (5, 'x') OR y.bs = 'a'", None),
    "left_build_side": (
        "SELECT COUNT(*) FROM m x LEFT JOIN d y ON x.k = y.pk "
        "WHERE y.pk <> '3'", None),
    "grouped": (
        f"SELECT y.nm, COUNT(*) {JOIN} WHERE x.v = '12' OR y.bs <> 'zz' "
        "GROUP BY y.nm ORDER BY y.nm", None),
}


@pytest.mark.parametrize("name", list(STRING_LITERALS))
def test_number_against_string_literal(engs, name):
    sql, count = STRING_LITERALS[name]
    want = check(engs, sql)
    if count is not None:
        assert want["resultTable"]["rows"] == [[count]]


def test_range_against_string_refused(engs):
    sql = NO_ADVISOR + f"SELECT COUNT(*) {JOIN} WHERE x.i > 'abc' " \
        "OR y.bs = 'a'"
    want = _error(engs["ref"].execute(sql))
    for port in ("gate", "gate0"):
        assert _error(engs[port].execute(sql)).split(":")[0] == \
            want.split(":")[0]
