"""The port's TableDataManager against the reference's
(pinot_tpu/engine/engine.py TableDataManager): acquire / release
refcounts, an unload deferred while a query holds the segment,
``replace_if_idle`` refused under a held reference, ``generation``, and
the engine acquiring a table's segments for exactly one query."""

import numpy as np
import pytest

from pinot_tpu.engine.engine import TableDataManager as RefTDM
from pinot_tpu_torch.common.datatypes import DataType
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import TableConfig
from pinot_tpu_torch.engine.engine import QueryEngine, TableDataManager
from pinot_tpu_torch.storage.creator import build_segment


class _Seg:
    def __init__(self, name):
        self.name = name
        self.n_docs = 1


def _trace(cls):
    """The observable history of one scripted run of a manager class."""
    out = []
    tdm = cls("t", host_name="h1")
    tdm.on_unload = lambda s: out.append(("unload", s.name))
    a, b, c = _Seg("a"), _Seg("b"), _Seg("c")
    tdm.add_segment(a)
    tdm.add_segment(b)
    out.append(("gen", tdm.generation, a.host_name))
    held = tdm.acquire()
    out.append(("held", [s.name for s in held], dict(tdm._refs)))
    tdm.remove_segment("a")             # held: deferred
    out.append(("after remove", sorted(tdm.segments), sorted(tdm._doomed)))
    out.append(("swap held", tdm.replace_if_idle("b", c)))
    again = tdm.acquire()               # a second query: b only
    tdm.release(held)                   # a's last ref drops: unload fires
    out.append(("swap still held", tdm.replace_if_idle("b", c)))
    tdm.release(again)
    out.append(("swap idle", tdm.replace_if_idle("b", c),
                tdm.segments["b"] is c, c.host_name))
    tdm.remove_segment("b")             # idle: unload at once
    tdm.add_segment(a)
    tdm.remove_segment("missing")       # a no-op
    out.append(("end", tdm.generation, sorted(tdm.segments), dict(tdm._refs)))
    return out


def test_scripted_history_matches_reference():
    assert _trace(TableDataManager) == _trace(RefTDM)


def test_readd_wins_over_a_deferred_unload():
    for cls in (TableDataManager, RefTDM):
        fired = []
        tdm = cls("t")
        tdm.on_unload = lambda s: fired.append(s.name)
        a = _Seg("a")
        tdm.add_segment(a)
        held = tdm.acquire()
        tdm.remove_segment("a")
        tdm.add_segment(a)              # re-added before the query ends
        tdm.release(held)
        assert fired == [] and list(tdm.segments) == ["a"]


def test_unload_callback_failure_is_contained(caplog):
    tdm = TableDataManager("t")

    def boom(_seg):
        raise RuntimeError("cleanup failed")

    tdm.on_unload = boom
    tdm.add_segment(_Seg("a"))
    tdm.remove_segment("a")             # logged, not raised
    assert "unload callback failed" in caplog.text


@pytest.fixture(scope="module")
def seg_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tdm")
    schema = Schema.build(name="t", dimensions=[("d", DataType.STRING)],
                          metrics=[("m", DataType.INT)])
    rng = np.random.default_rng(3)
    dirs = []
    for i in range(3):
        out = str(base / f"s{i}")
        build_segment(schema, {"d": [f"d{j % 7}" for j in range(500)],
                               "m": rng.integers(0, 100, 500)},
                      out, TableConfig(table_name="t"), f"s{i}")
        dirs.append(out)
    return dirs


def test_engine_holds_segments_for_one_query(seg_dirs):
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    eng = QueryEngine(device="cpu")
    for d in seg_dirs:
        eng.add_segment("t", ImmutableSegment(d))
    tdm = eng.table("t")
    assert eng.tables["t"] is tdm and len(tdm.segments) == 3
    unloaded, seen = [], []
    tdm.on_unload = lambda s: unloaded.append(s.name)
    inner = eng.execute_segments_async

    def launch_then_unload(q, segments, **kw):
        # a rebalance unloads a segment while this query holds it
        seen.append(dict(tdm._refs))
        tdm.remove_segment("s1")
        assert unloaded == []           # deferred: the query holds s1
        return inner(q, segments, **kw)

    eng.execute_segments_async = launch_then_unload
    r = eng.execute("SELECT COUNT(*) FROM t")
    assert r["exceptions"] == [] and r["resultTable"]["rows"] == [[1500]]
    assert seen == [{"s0": 1, "s1": 1, "s2": 1}]
    assert unloaded == ["s1"] and tdm._refs == {}
    del eng.execute_segments_async
    r = eng.execute("SELECT COUNT(*) FROM t")
    assert r["resultTable"]["rows"] == [[1000]]
    assert r["numSegmentsQueried"] == 2


def test_empty_and_unknown_tables_answer_in_band():
    eng = QueryEngine(device="cpu")
    eng.table("t")
    r = eng.execute("SELECT COUNT(*) FROM t")
    assert "has no segments" in r["exceptions"][0]["message"]
    r = eng.execute("SELECT COUNT(*) FROM nope")
    assert "not found" in r["exceptions"][0]["message"]
