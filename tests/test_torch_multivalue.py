"""Multi-value columns on the port against the JAX package.

Three segments written by the JAX package's creator hold MV columns of
every kind the port reads: a dict STRING column of at most 3 entries a
doc (``tags``) and a dict INT one (``ports``), both in the reference
device's ``mv_any`` form; a dict INT column of up to 24 entries a doc
(``wide``, past ``MAX_MV_K``) and a raw INT one (``codes``), both in its
host path's shape; and a column the segments predate (``extra``,
schema-evolved: no entries). The reference runs with its device in
interpret mode, as its own tests do; the port on the CPU, at the kernel
gate 0 (the kernels' plain versions) and at the default gate (the torch
scatters). Rows, order, the dataSchema and every response stat must be
equal, floats per ``_rows_close`` (rtol 1e-5).

The SQL of tests/test_multivalue.py replays through the port behind
that file's own fixture (its mutable-segment test waits for consuming
segments, ROADMAP item j).
"""

import inspect

import numpy as np
import pytest
import torch

import test_multivalue
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common.datatypes import DataType as PortDataType
from pinot_tpu_torch.common.schema import Schema as PortSchema
from pinot_tpu_torch.engine import datatable
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import selection as sel
from pinot_tpu_torch.sql.compiler import compile_query
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_selection import STATS

SIZES = (3000, 2500, 1800)

MV_AGGS = ("countmv", "summv", "minmv", "maxmv", "avgmv", "minmaxrangemv",
           "distinctcountmv", "distinctcountbitmapmv", "distinctcounthllmv",
           "distinctcountrawhllmv", "percentilemv", "percentileestmv",
           "percentiletdigestmv", "percentilerawestmv",
           "percentilerawtdigestmv")


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def _agg_sql(name: str, col: str) -> str:
    arg = f"{col}, 90" if name.startswith("percentile") else col
    return f"{name.upper()}({arg})"


SQL = {
    # the reference device's mv_any form
    "eq_device": "SELECT COUNT(*), SUM(amount) FROM ev WHERE tags = 't3'",
    "in_not_eq": ("SELECT user, COUNT(*), MAX(amount) FROM ev WHERE "
                  "tags IN ('t1', 't7') AND ports != 42 GROUP BY user "
                  "ORDER BY user LIMIT 10"),
    "not_and_range": ("SELECT COUNT(*) FROM ev WHERE NOT tags = 't3' "
                      "AND ports BETWEEN 90 AND 99"),
    "like_mv": "SELECT COUNT(*) FROM ev WHERE tags LIKE 't1%'",
    "and_sv_zones": ("SELECT COUNT(*), SUM(amount) FROM ev WHERE "
                     "tags = 't3' AND amount BETWEEN 10 AND 20"),
    # the host path's shape: K past the cap, raw, schema-evolved
    "wide_k": ("SELECT user, COUNT(*), SUM(amount) FROM ev WHERE wide > 990 "
               "GROUP BY user ORDER BY COUNT(*) DESC, user LIMIT 5"),
    "raw_mv": "SELECT COUNT(*) FROM ev WHERE codes IN (7, 8, 9)",
    "raw_not_in": "SELECT COUNT(*) FROM ev WHERE codes NOT IN (7, 8, 9)",
    "evolved_eq": "SELECT COUNT(*) FROM ev WHERE extra = 'x'",
    "evolved_countmv": "SELECT COUNTMV(extra), COUNT(*) FROM ev",
    "empty_match": ("SELECT tags, COUNT(*) FROM ev WHERE tags = 'none' "
                    "GROUP BY tags"),
    "empty_entries": ("SELECT COUNTMV(tags), SUMMV(ports) FROM ev "
                      "WHERE amount > 5000"),
    # group keys: expansion, Cartesian, with SV keys
    "group_tags": ("SELECT tags, COUNT(*), SUM(amount) FROM ev GROUP BY tags "
                   "ORDER BY COUNT(*) DESC, tags LIMIT 20"),
    "group_cartesian": ("SELECT tags, ports, COUNT(*) FROM ev WHERE "
                        "amount < 200 GROUP BY tags, ports "
                        "ORDER BY COUNT(*) DESC, tags, ports LIMIT 15"),
    "group_sv_mv": ("SELECT user, tags, COUNT(*), AVG(amount) FROM ev "
                    "WHERE user IN ('u3', 'u4') GROUP BY user, tags "
                    "ORDER BY user, tags"),
    "group_raw_key": ("SELECT codes, COUNT(*) FROM ev GROUP BY codes "
                      "ORDER BY codes LIMIT 12"),
    "group_evolved_key": "SELECT extra, COUNT(*) FROM ev GROUP BY extra",
    "group_limit": ("SET numGroupsLimit = 4; SELECT tags, COUNT(*), "
                    "SUM(amount) FROM ev GROUP BY tags ORDER BY tags"),
    "group_mv_aggs": ("SELECT tags, COUNTMV(ports), SUMMV(codes), "
                      "MAXMV(wide), DISTINCTCOUNTMV(ports) FROM ev "
                      "GROUP BY tags ORDER BY tags"),
    "group_mv_aggs_limit": ("SET numGroupsLimit = 3; SELECT user, "
                            "COUNTMV(ports), MINMV(codes) FROM ev "
                            "GROUP BY user ORDER BY user"),
    # selection
    "select_mv": ("SELECT user, tags, codes, amount FROM ev WHERE "
                  "ports = 42 LIMIT 8"),
    "select_mv_order": ("SELECT tags, wide, amount FROM ev WHERE "
                        "codes = 3 ORDER BY amount DESC, user LIMIT 6"),
    "select_evolved": "SELECT extra, user FROM ev LIMIT 3",
}
for _n in MV_AGGS:
    SQL[f"scalar_{_n}"] = (f"SELECT {_agg_sql(_n, 'ports')}, "
                           f"{_agg_sql(_n, 'codes')} FROM ev "
                           f"WHERE tags IN ('t2', 't5')")
    _other = "tags" if _n.startswith(("distinct", "count")) else "codes"
    SQL[f"grouped_{_n}"] = (f"SELECT user, {_agg_sql(_n, 'wide')}, "
                            f"{_agg_sql(_n, _other)} FROM ev "
                            f"WHERE amount < 500 GROUP BY user "
                            f"ORDER BY user LIMIT 8")


def _close(x, y) -> bool:
    """``_rows_close`` of tests/test_torch_selection.py, into the lists an
    MV column's selection rows hold."""
    if isinstance(x, list) or isinstance(y, list):
        return isinstance(x, list) and isinstance(y, list) \
            and len(x) == len(y) and all(map(_close, x, y))
    if isinstance(x, str) or x is None or isinstance(y, str) or y is None:
        return x == y
    return bool(np.isclose(float(x), float(y), rtol=1e-5, atol=1e-6,
                           equal_nan=True))


def assert_same_response(got, want):
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert _close(rows, ref_rows), (rows[:5], ref_rows[:5])
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


def _schema(with_extra: bool):
    mv = [("tags", DataType.STRING), ("ports", DataType.INT),
          ("wide", DataType.INT), ("codes", DataType.INT)]
    if with_extra:
        mv.append(("extra", DataType.STRING))
    return Schema.build(name="ev", dimensions=[("user", DataType.STRING)],
                        multi_value_dimensions=mv,
                        metrics=[("amount", DataType.INT)])


def _columns(n: int, rng) -> dict:
    pool = np.array([f"t{i}" for i in range(12)])
    return {
        "user": [f"u{i}" for i in rng.integers(0, 40, n)],
        "tags": [list(pool[rng.choice(12, size=rng.integers(0, 4),
                                      replace=False)]) for _ in range(n)],
        "ports": [list(rng.integers(0, 100, rng.integers(1, 5)))
                  for _ in range(n)],
        "wide": [list(rng.integers(0, 1000, rng.integers(0, 25)))
                 for _ in range(n)],
        "codes": [list(rng.integers(-5, 40, rng.integers(0, 6)))
                  for _ in range(n)],
        "amount": rng.integers(0, 1000, n).astype(np.int32),
    }


@pytest.fixture(scope="module")
def segment_dirs(tmp_path_factory):
    cfg = TableConfig(table_name="ev", indexing=IndexingConfig(
        no_dictionary_columns=["codes"]))
    base = tmp_path_factory.mktemp("torch_mv")
    rng = np.random.default_rng(5)
    dirs = []
    for i, n in enumerate(SIZES):
        out = str(base / f"s{i}")
        build_segment(_schema(False), _columns(n, rng), out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


def _evolved(seg, schema_cls, RD):
    """The segment behind a table schema that adds the MV column
    ``extra``."""
    seg.table_schema = schema_cls.build(
        name="ev", dimensions=[("user", RD.STRING)],
        multi_value_dimensions=[("tags", RD.STRING), ("ports", RD.INT),
                                ("wide", RD.INT), ("codes", RD.INT),
                                ("extra", RD.STRING)],
        metrics=[("amount", RD.INT)])
    return seg


@pytest.fixture(scope="module")
def ref_responses(segment_dirs):
    eng = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    for d in segment_dirs:
        eng.add_segment("ev", _evolved(RefSegment(d), Schema, DataType))
    return {k: eng.execute(sql) for k, sql in SQL.items()}


def _port(dirs, min_rows=None) -> QueryEngine:
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in dirs:
        eng.add_segment("ev", _evolved(ImmutableSegment(d), PortSchema,
                                         PortDataType))
    return eng


@pytest.fixture(scope="module", params=[0, None], ids=["kernels", "scatter"])
def port_engine(request, segment_dirs):
    return _port(segment_dirs, request.param)


@pytest.mark.parametrize("name", sorted(SQL))
def test_mv_sql_matches_reference(port_engine, ref_responses, name):
    want = ref_responses[name]
    got = port_engine.execute(SQL[name])
    assert_same_response(got, want)
    if name not in ("evolved_eq", "empty_match", "group_evolved_key"):
        assert got["resultTable"]["rows"], name


def test_numeric_reduction_of_strings_is_in_band(port_engine,
                                                ref_responses):
    """MINMV over a STRING column fails in the host path (a numeric
    reduction of strings); the port refuses it in-band too."""
    got = port_engine.execute("SELECT MINMV(tags) FROM ev")
    assert got["exceptions"] and "resultTable" not in got


def test_every_mv_aggregation_is_covered():
    from pinot_tpu_torch.engine import aggspec

    mv = sorted(n for n, c in aggspec._SPECS.items() if c.mv)
    assert mv == sorted(MV_AGGS)


def test_shapes_follow_the_reference_device(segment_dirs, monkeypatch):
    """A K <= 16 dict MV filter under single-value aggregations takes the
    device shape (``mv_any``, the dense pipeline); K past the cap, a raw
    MV column, an MV key or an ``*MV`` aggregation the host path's."""
    from pinot_tpu_torch.engine import device as dev_mod

    eng = _port(segment_dirs)
    seen = []
    real = dev_mod.DeviceExecutor.host_shape

    def spy(self, q, ctx):
        out = real(self, q, ctx)
        seen.append(out)
        return out

    monkeypatch.setattr(dev_mod.DeviceExecutor, "host_shape", spy)
    for key, host in (("eq_device", False), ("in_not_eq", False),
                      ("wide_k", True), ("raw_mv", True),
                      ("group_tags", True), ("scalar_countmv", True),
                      ("evolved_eq", True)):
        seen.clear()
        resp = eng.execute(SQL[key])
        assert resp["exceptions"] == [], resp
        assert seen == [host], key


def test_block_skip_and_k4_decline_mv_any():
    """An ``mv_any`` leaf may match in any block, and K4's fused plan has
    no form for it, as in the reference (ops/blockskip.py,
    ops/group_scatter.py)."""
    from pinot_tpu_torch.ops import blockskip as bs_ops
    from pinot_tpu_torch.ops import group_scatter as ps

    leaf = ("mv_any", "mv::tags", ("eq_dict", "mv::tags", "pr0"))
    assert bs_ops.prunable_columns(leaf) == (False, set())
    assert bs_ops.prunable_columns(("and", leaf, ("eq_dict", "user",
                                                  "pr1")))[1] == {"user"}
    assert ps.plan_fused(leaf, (), {}) is None


def test_mv_column_block_is_the_references(segment_dirs):
    """``mv_column``: the (S, L, K) global-id block, -1 padded, as the
    reference's BatchContext builds it."""
    from pinot_tpu.engine.params import BatchContext as RefBatch
    from pinot_tpu_torch.engine.params import BatchContext

    ref = RefBatch([RefSegment(d) for d in segment_dirs])
    port = BatchContext([ImmutableSegment(d) for d in segment_dirs], "cpu")
    for col in ("tags", "ports"):
        np.testing.assert_array_equal(port.mv_column(col).numpy(),
                                      np.asarray(ref.mv_column(col)))
    assert port.mv_on_device("tags") and not port.mv_on_device("wide") \
        and not port.mv_on_device("codes")


def test_mv_selection_round_trips_the_datatable(segment_dirs):
    """An MV column's selection rows are per-row arrays, as the host
    path's, and survive the wire (engine/datatable.py)."""
    eng = _port(segment_dirs)
    q = compile_query("SELECT tags, codes, amount FROM ev LIMIT 7")
    res = eng.device.execute(q, table_segs(eng, "ev"))
    back = datatable.decode(datatable.encode(res))
    assert len(res.rows[0]) == 3 * 7
    for j in (0, 1):
        for a, b in zip(res.rows[j], back.rows[j]):
            assert list(a) == list(b)


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_is_repeat_per_segment(seed):
    rng = np.random.default_rng(seed)
    S, L = 3, 40
    counts = rng.integers(0, 4, (S, L))
    counts[1] = 0
    src, rank, per, Lx = sel.expand(torch.from_numpy(counts))
    src, rank = src.numpy().reshape(S, Lx), rank.numpy().reshape(S, Lx)
    for s in range(S):
        want = np.repeat(np.arange(L), counts[s])
        n = int(per[s])
        assert n == len(want)
        np.testing.assert_array_equal(src[s, :n], s * L + want)
        np.testing.assert_array_equal(
            rank[s, :n], np.concatenate([np.arange(c) for c in counts[s]]))


# ---------------------------------------------------------------------------
# tests/test_multivalue.py through the port, behind its own fixture
# ---------------------------------------------------------------------------

REPLAYED = ("TestHostPredicates", "TestDevicePredicates", "TestGroupBy",
            "TestMVAggregations", "TestSelectionAndWire::test_select_mv_column")


def _mv_tests() -> list:
    out = []
    for cname, cls in inspect.getmembers(test_multivalue, inspect.isclass):
        for mname, _fn in inspect.getmembers(cls, inspect.isfunction):
            name = f"{cname}::{mname}"
            if mname.startswith("test_") and (cname in REPLAYED
                                              or name in REPLAYED):
                out.append(name)
    return sorted(out)


@pytest.fixture(scope="module")
def mv_setup(tmp_path_factory):
    def unwrap(fixture):
        make = getattr(fixture, "_get_wrapped_function", None)
        return make() if make is not None else fixture.__wrapped__

    data = unwrap(test_multivalue.data)()
    seg = unwrap(test_multivalue.seg)(tmp_path_factory, data)
    return seg, data


@pytest.mark.parametrize("name", _mv_tests())
def test_multivalue_sql_through_the_port(mv_setup, name, monkeypatch):
    seg, data = mv_setup

    def port_engine(s, device=None):
        eng = QueryEngine(device="cpu")
        eng.device.min_rows = 0
        eng.add_segment("ev", ImmutableSegment(s.dir))
        return eng

    monkeypatch.setattr(test_multivalue, "_engine", port_engine)
    cname, mname = name.split("::")
    fn = getattr(getattr(test_multivalue, cname)(), mname)
    kwargs = {k: v for k, v in (("seg", seg), ("data", data))
              if k in inspect.signature(fn).parameters}
    fn(**kwargs)


def test_replay_covers_all_but_the_mutable_test():
    names = _mv_tests()
    assert len(names) == 10
    assert not any("Mutable" in n or "roundtrip" in n for n in names)


def test_mv_any_in_the_block_skip_forms(tmp_path, monkeypatch):
    """``tags = ...`` beside a selective range on a sorted column: the
    zone maps keep a few blocks, the (S, L, K) id block is gathered with
    them, and the answer equals the reference's and the dense form's."""
    from pinot_tpu_torch.ops import blockskip as bs_ops

    rng = np.random.default_rng(9)
    schema = Schema.build(name="ev", dimensions=[("ts", DataType.LONG)],
                          multi_value_dimensions=[("tags", DataType.STRING)],
                          metrics=[("amount", DataType.INT)])
    pool = np.array([f"t{i}" for i in range(12)])
    dirs = []
    for i in range(2):
        n = 20_000
        out = str(tmp_path / f"s{i}")
        build_segment(schema, {
            "ts": np.arange(n, dtype=np.int64) + i * n,
            "tags": [list(pool[rng.choice(12, size=rng.integers(0, 4),
                                          replace=False)])
                     for _ in range(n)],
            "amount": rng.integers(0, 1000, n).astype(np.int32)},
            out, TableConfig(table_name="ev"), f"s{i}")
        dirs.append(out)
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    port = QueryEngine(device="cpu")
    for d in dirs:
        ref.add_segment("ev", RefSegment(d))
        port.add_segment("ev", ImmutableSegment(d))
    gathered = []
    real = bs_ops.gather_blocks

    def spy(x, *a):
        gathered.append(tuple(x.shape))
        return real(x, *a)

    monkeypatch.setattr(bs_ops, "gather_blocks", spy)
    sql = ("SELECT COUNT(*), SUM(amount) FROM ev WHERE tags = 't3' "
           "AND ts BETWEEN 5000 AND 6000")
    got = port.execute(sql)
    assert_same_response(got, ref.execute(sql))
    assert any(len(s) == 3 for s in gathered), gathered  # the id block
    dense = port.execute("SET useBlockSkip = false; " + sql)
    assert dense["resultTable"] == got["resultTable"]
