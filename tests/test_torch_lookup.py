"""The port's LOOKUP over dimension tables against the reference's, after
tests/test_lookup.py's TestEmbeddedLookup: select, group-by, a numeric
value under a filter, a literal key, a missing table, an empty table's
numeric default, the map cached until a new segment lands
(``TableDataManager.generation``) and the ``is_dim_table=false`` refusal.
The port resolves each distinct key once on the host and gathers the
values on the card (engine/values.py ``_lookup``); a group-by over a
LOOKUP key runs in the host path's shape, its sums and MIN / MAX reaching
K1's and K2's wrappers at gate 0."""

import numpy as np
import pytest

from pinot_tpu_torch.ops import group_scatter
from test_torch_join import GATES, MODS, new_engine, same

DIM = {
    "teamID": np.asarray(["t1", "t2", "t3"], dtype=np.str_),
    "teamName": np.asarray(["Tigers", "Bears", "Hawks"], dtype=np.str_),
    "founded": np.asarray([1901, 1950, 1988], dtype=np.int32),
}
FACT = {
    "team": np.asarray(["t1", "t2", "t1", "t9"], dtype=np.str_),
    "score": np.asarray([3, 5, 7, 2], dtype=np.int32),
}


def schemas(side):
    sc, dt = MODS[side][:2]
    DT = dt.DataType
    dim = sc.Schema.build(
        name="teams",
        dimensions=[("teamID", DT.STRING), ("teamName", DT.STRING),
                    ("founded", DT.INT)],
        primary_key_columns=["teamID"])
    fact = sc.Schema.build(name="games", dimensions=[("team", DT.STRING)],
                           metrics=[("score", DT.INT)])
    return dim, fact


def load(side, eng, base, dim=DIM, fact=FACT):
    _sc, _dt, tc, creator, _m = MODS[side]
    ds, fs = schemas(side)
    eng.add_segment("teams", creator.build_segment(
        ds, dim, str(base / f"{side}dim"),
        tc.TableConfig(table_name="teams", is_dim_table=True), "d0"))
    eng.add_segment("games", creator.build_segment(
        fs, fact, str(base / f"{side}fact"),
        tc.TableConfig(table_name="games"), "f0"))
    return eng


@pytest.fixture()
def engines(tmp_path):
    out = {"ref": load("ref", new_engine("ref"), tmp_path / "r")}
    for gname, gate in GATES.items():
        out[gname] = load("port", new_engine("port", gate),
                          tmp_path / gname)
    return out


# the single-stage response's stats
STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numGroupsLimitReached", "totalDocs")


def check(engines, sql, rows=None):
    want = engines["ref"].execute(sql)
    if rows is not None:
        assert want["resultTable"]["rows"] == rows
    for gname in GATES:
        same(engines[gname].execute(sql), want, stats=STATS)


class TestEmbeddedLookup:
    def test_lookup_select(self, engines):
        check(engines,
              "SELECT team, LOOKUP('teams', 'teamName', 'teamID', team), "
              "score FROM games ORDER BY score",
              [["t9", "", 2], ["t1", "Tigers", 3], ["t2", "Bears", 5],
               ["t1", "Tigers", 7]])

    def test_lookup_group_by(self, engines):
        check(engines,
              "SELECT LOOKUP('teams', 'teamName', 'teamID', team), "
              "SUM(score) FROM games WHERE team <> 't9' "
              "GROUP BY LOOKUP('teams', 'teamName', 'teamID', team) "
              "ORDER BY LOOKUP('teams', 'teamName', 'teamID', team)",
              [["Bears", 5], ["Tigers", 10]])

    def test_lookup_numeric_value_and_filter(self, engines):
        # a miss takes the value column's type default (0 < 1950)
        check(engines, "SELECT COUNT(*) FROM games "
              "WHERE LOOKUP('teams', 'founded', 'teamID', team) < 1950",
              [[3]])
        check(engines, "SELECT COUNT(*) FROM games WHERE "
              "LOOKUP('teams', 'founded', 'teamID', team) < 1950 "
              "AND team <> 't9'", [[2]])

    @pytest.mark.parametrize("sql", [
        "SELECT LOOKUP('teams', 'founded', 'teamID', team) + score, "
        "UPPER(LOOKUP('teams', 'teamName', 'teamID', team)) FROM games "
        "ORDER BY score DESC",
        "SELECT LOOKUP('teams', 'founded', 'teamID', team), COUNT(*), "
        "SUM(score), MAX(score), MIN(score) FROM games "
        "GROUP BY LOOKUP('teams', 'founded', 'teamID', team) "
        "ORDER BY LOOKUP('teams', 'founded', 'teamID', team)",
        "SELECT SUM(LOOKUP('teams', 'founded', 'teamID', team)), "
        "MAX(LOOKUP('teams', 'founded', 'teamID', team)) FROM games",
        "SELECT DISTINCT LOOKUP('teams', 'teamName', 'teamID', team) "
        "FROM games ORDER BY LOOKUP('teams', 'teamName', 'teamID', team)",
        "SELECT team FROM games WHERE LOOKUP('teams', 'teamName', "
        "'teamID', team) IN ('Bears', 'Hawks', '')",
    ])
    def test_lookup_shapes(self, engines, sql):
        check(engines, sql)

    def test_cache_invalidated_on_new_segment(self, engines, tmp_path):
        sql = ("SELECT LOOKUP('teams', 'teamName', 'teamID', team) "
               "FROM games WHERE team = 't9'")
        check(engines, sql, [[""]])
        for side, eng in engines.items():
            _sc, _dt, tc, creator, _m = MODS["ref" if side == "ref"
                                             else "port"]
            ds, _fs = schemas("ref" if side == "ref" else "port")
            gen = eng.table("teams").generation
            eng.add_segment("teams", creator.build_segment(
                ds, {"teamID": np.asarray(["t9"], dtype=np.str_),
                     "teamName": np.asarray(["Lions"], dtype=np.str_),
                     "founded": np.asarray([2020], dtype=np.int32)},
                str(tmp_path / f"{side}dim2"),
                tc.TableConfig(table_name="teams", is_dim_table=True),
                "d1"))
            assert eng.table("teams").generation == gen + 1
        check(engines, sql, [["Lions"]])

    def test_missing_dim_table_errors(self, engines):
        sql = "SELECT LOOKUP('nope', 'a', 'b', team) FROM games"
        want = engines["ref"].execute(sql)["exceptions"]
        assert want
        for gname in GATES:
            assert engines[gname].execute(sql)["exceptions"] == want

    def test_literal_key(self, engines):
        check(engines,
              "SELECT LOOKUP('teams', 'teamName', 'teamID', 't1'), score "
              "FROM games ORDER BY score LIMIT 2",
              [["Tigers", 2], ["Tigers", 3]])

    def test_empty_dim_table_numeric_default(self, tmp_path):
        empty = {"teamID": np.asarray([], dtype=np.str_),
                 "teamName": np.asarray([], dtype=np.str_),
                 "founded": np.asarray([], dtype=np.int32)}
        engines = {"ref": load("ref", new_engine("ref"), tmp_path, empty)}
        for gname, gate in GATES.items():
            engines[gname] = load("port", new_engine("port", gate),
                                  tmp_path / gname, empty)
        check(engines, "SELECT SUM(LOOKUP('teams', 'founded', 'teamID', "
              "team)) FROM games", [[0.0]])

    def test_non_dim_table_rejected_when_flagged(self, engines):
        sql = "SELECT LOOKUP('teams', 'teamName', 'teamID', team) FROM games"
        for eng in engines.values():
            eng.tables["teams"].is_dim_table = False
        want = engines["ref"].execute(sql)["exceptions"]
        assert "not a dimension table" in want[0]["message"]
        for gname in GATES:
            assert engines[gname].execute(sql)["exceptions"] == want
            engines[gname].tables["teams"].is_dim_table = None
            assert not engines[gname].execute(sql)["exceptions"]


def test_lookup_group_by_reaches_k1_and_k2(engines, monkeypatch):
    """At gate 0 the host path's shape sums the LOOKUP group-by's COUNT
    and SUM through K1's entry and its MAX through K2's."""
    seen = []
    for entry in ("plane_group_sums", "group_minmax_sources"):
        real = getattr(group_scatter, entry)

        def spy(*a, _real=real, _entry=entry, **kw):
            seen.append(_entry)
            return _real(*a, **kw)

        monkeypatch.setattr(group_scatter, entry, spy)
    sql = ("SELECT LOOKUP('teams', 'teamName', 'teamID', team), COUNT(*), "
           "SUM(score), MAX(score) FROM games GROUP BY "
           "LOOKUP('teams', 'teamName', 'teamID', team) ORDER BY "
           "SUM(score) DESC")
    engines["gate0"].device.partials_cache_enabled = False
    same(engines["gate0"].execute(sql), engines["ref"].execute(sql),
         stats=STATS)
    assert sorted(seen) == ["group_minmax_sources", "plane_group_sums"]
