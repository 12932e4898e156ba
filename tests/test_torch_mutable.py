"""The port's consuming segment (storage/mutable.py) against the
reference's: the row path (``index``) and the atomic columnar path
(``index_batch``) answer the same, through the port's QueryEngine on the
CPU (the kernels' plain versions) and the reference's engine, rows and
every stat; a bad row fails its whole batch; MV rows, missing columns
and null defaults with IS NULL; a segment sealed by either package loads
in the other and answers the same (after tests/test_chunklet.py
TestIndexBatchEquivalence and tests/test_realtime.py TestMutableSegment).

The helpers here (``pair``, ``same``, ``engines``) serve the other
consuming-segment test files too."""

import numpy as np
import pytest

import pinot_tpu.common.datatypes as r_dt
import pinot_tpu.common.schema as r_schema
import pinot_tpu.common.table_config as r_tc
import pinot_tpu.storage.mutable as r_mut
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common import datatypes as t_dt
from pinot_tpu_torch.common import schema as t_schema
from pinot_tpu_torch.common import table_config as t_tc
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.storage import mutable as t_mut
from pinot_tpu_torch.storage.segment import ImmutableSegment

STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numBlocksPruned", "totalDocs",
         "numGroupsLimitReached")

# tests/test_chunklet.py's QUERIES, and the shapes beside them the host
# path's shape answers: selection, DISTINCT, the sketches
QUERIES = [
    "SELECT COUNT(*), SUM(fare) FROM rt",
    "SELECT zone, COUNT(*), SUM(fare), MIN(fare), MAX(fare) FROM rt "
    "GROUP BY zone ORDER BY zone LIMIT 100",
    "SELECT hour, AVG(fare) FROM rt WHERE zone <> 'z001' "
    "GROUP BY hour ORDER BY hour LIMIT 30",
    "SELECT COUNT(*) FROM rt WHERE fare IS NULL",
    "SELECT COUNT(*) FROM rt WHERE fare > 5000 AND hour BETWEEN 3 AND 20",
]
MORE_QUERIES = [
    "SELECT zone, hour, fare, ts FROM rt WHERE hour = 3 "
    "ORDER BY fare DESC, ts LIMIT 7",
    "SELECT zone, fare FROM rt WHERE ts > 10 LIMIT 5",
    "SELECT DISTINCT zone FROM rt ORDER BY zone LIMIT 6",
    "SELECT DISTINCTCOUNTHLL(zone), DISTINCTCOUNT(hour), MINMAXRANGE(fare) "
    "FROM rt WHERE ts >= 100",
    "SELECT hour, MAX(ts), COUNT(*) FROM rt WHERE zone IN ('z002', 'z007') "
    "GROUP BY hour ORDER BY MAX(ts) DESC LIMIT 4",
    "SELECT COUNT(*) FROM rt WHERE fare IS NOT NULL AND zone LIKE 'z01%'",
]


def schema(mod_schema, mod_dt, pk=False, mv=False):
    DT = mod_dt.DataType
    return mod_schema.Schema.build(
        name="rt",
        dimensions=[("zone", DT.STRING), ("hour", DT.INT)],
        multi_value_dimensions=[("tags", DT.STRING), ("ports", DT.INT)]
        if mv else [],
        metrics=[("fare", DT.INT)],
        datetimes=[("ts", DT.LONG)],
        primary_key_columns=["zone"] if pk else [],
    )


def make_rows(n, zones=40, seed=0, with_nulls=True):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        r = {"zone": f"z{int(rng.integers(0, zones)):03d}",
             "hour": int(rng.integers(0, 24)),
             "fare": int(rng.integers(0, 10_000)),
             "ts": i}
        if with_nulls and i % 37 == 0:
            del r["fare"]  # -> null default + null vector entry
        rows.append(r)
    return rows


def table_config(mod_tc, rows_per=None, min_rows=0, upsert=None):
    kw = {}
    if rows_per is not None:
        kw["chunklets"] = mod_tc.ChunkletConfig(
            enabled=True, rows_per_chunklet=rows_per,
            device_min_rows=min_rows)
    if upsert is not None:
        kw["upsert"] = mod_tc.UpsertConfig(mode="FULL",
                                           comparison_column=upsert)
    return mod_tc.TableConfig(table_name="rt", **kw)


def pair(build, **kw):
    """``build(side)`` run for the reference's modules ("ref") and the
    port's ("port"): (reference result, port result)."""
    return build("ref", **kw), build("port", **kw)


MODS = {"ref": (r_schema, r_dt, r_tc, r_mut),
        "port": (t_schema, t_dt, t_tc, t_mut)}


def mutable(side, rows, rows_per=None, min_rows=0, batch=True, mv=False,
            name="a", promote=True):
    sc, dt, tc, mut = MODS[side]
    seg = mut.MutableSegment(schema(sc, dt, mv=mv), name,
                             table_config(tc, rows_per, min_rows))
    if batch:
        seg.index_batch(rows)
    else:
        for r in rows:
            seg.index(r)
    if promote and seg.chunklet_index is not None:
        seg.chunklet_index.promote()
    return seg


def engines(ref_segs, port_segs, table="rt"):
    ref, port = RefEngine(), QueryEngine(device="cpu")
    port.device.min_rows = 0  # small batches reach the kernels' wrappers
    for s in ref_segs:
        ref.table(table).add_segment(s)
    for s in port_segs:
        port.add_segment(table, s)
    return ref, port


def _close(a, b) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, (str, list)) or x is None \
                    or isinstance(y, (str, list)) or y is None:
                if x != y:
                    return False
            elif not np.isclose(float(x), float(y), rtol=1e-9, atol=0,
                                equal_nan=True):
                return False
    return True


def same(got: dict, want: dict, stats=STATS) -> None:
    """Rows (floats within 1e-9 relative), dataSchema and every stat."""
    assert want["exceptions"] == [], want["exceptions"]
    assert got["exceptions"] == [], got["exceptions"]
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert _close(rows, ref_rows), (rows[:5], ref_rows[:5])
    for key in stats:
        assert got[key] == want[key], (key, got[key], want[key])


def check(ref, port, sqls) -> None:
    for sql in sqls:
        same(port.execute(sql), ref.execute(sql))


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "rows"])
@pytest.mark.parametrize("sql", QUERIES + MORE_QUERIES)
def test_consuming_segment_answers_as_reference(batch, sql):
    rows = make_rows(3000)
    ref_seg, port_seg = pair(mutable, rows=rows, batch=batch)
    ref, port = engines([ref_seg], [port_seg])
    same(port.execute(sql), ref.execute(sql))


def test_batch_and_row_paths_store_the_same():
    rows = make_rows(3000)
    a = mutable("port", rows, rows_per=1024)
    b = mutable("port", rows, batch=False)
    assert a.n_docs == b.n_docs == 3000
    for col in ("zone", "hour", "fare", "ts"):
        np.testing.assert_array_equal(a.values(col), b.values(col))
        np.testing.assert_array_equal(a.null_vector(col) is None,
                                      b.null_vector(col) is None)
    np.testing.assert_array_equal(a.null_vector("fare"),
                                  b.null_vector("fare"))
    _, port = engines([], [a])
    _, port_b = engines([], [b])
    for sql in QUERIES:
        assert port.execute(sql)["resultTable"]["rows"] == \
            port_b.execute(sql)["resultTable"]["rows"], sql


def test_seal_answers_as_the_rows(tmp_path):
    rows = make_rows(3000)
    a = mutable("port", rows, rows_per=1024)
    b = mutable("port", rows, batch=False)
    assert len(a.chunklet_index.chunklets) == 2
    sa = a.seal(str(tmp_path / "sa"))   # chunklet seal-reuse path
    sb = b.seal(str(tmp_path / "sb"))
    assert isinstance(sa, ImmutableSegment)
    _, before = engines([], [b])
    _, ea = engines([], [sa])
    _, eb = engines([], [sb])
    for sql in QUERIES + MORE_QUERIES:
        want = before.execute(sql)["resultTable"]["rows"]
        assert ea.execute(sql)["resultTable"]["rows"] == want, sql
        assert eb.execute(sql)["resultTable"]["rows"] == want, sql


def test_bad_row_fails_batch_atomically():
    seg = mutable("port", [], rows_per=1024)
    with pytest.raises(Exception):
        seg.index_batch([
            {"zone": "a", "hour": 1, "fare": 1, "ts": 0},
            {"zone": "b", "hour": "not-an-int", "fare": 2, "ts": 1},
        ])
    assert seg.n_docs == 0  # nothing published
    seg.index_batch([{"zone": "c", "hour": 3, "fare": 3, "ts": 2}])
    assert seg.n_docs == 1
    assert seg.row_value("zone", 0) == "c"
    assert seg.row_value("fare", 0) == 3


MV_ROWS = [
    {"zone": "a", "hour": 1, "fare": 10, "ts": 0, "tags": ["x", "y"],
     "ports": [80, 443]},
    {"zone": "b", "hour": 2, "ts": 1, "tags": [], "ports": [22]},  # fare null
    {"zone": "a", "hour": 3, "fare": 30, "ts": 2, "tags": ["y"]},  # no ports
    {"zone": "c", "ts": 3, "tags": ["z", "x", "y"], "ports": [80]},
]
MV_QUERIES = [
    "SELECT COUNT(*) FROM rt WHERE tags = 'y'",
    "SELECT COUNT(*) FROM rt WHERE fare IS NULL",
    "SELECT COUNT(*) FROM rt WHERE hour IS NULL OR ports IS NULL",
    "SELECT tags, COUNT(*) FROM rt GROUP BY tags ORDER BY tags LIMIT 10",
    "SELECT zone, SUMMV(ports), COUNTMV(tags) FROM rt GROUP BY zone "
    "ORDER BY zone",
    "SELECT zone, tags, ports FROM rt WHERE ports = 80 ORDER BY ts",
    "SELECT zone, hour, fare FROM rt ORDER BY ts LIMIT 10",
]


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "rows"])
@pytest.mark.parametrize("sql", MV_QUERIES)
def test_mv_rows_missing_columns_and_nulls(batch, sql):
    ref_seg, port_seg = pair(mutable, rows=MV_ROWS, batch=batch, mv=True,
                             rows_per=1024)
    # an MV schema has no chunklet index: the whole segment runs in the
    # host path's shape
    assert port_seg.chunklet_index is None
    ref, port = engines([ref_seg], [port_seg])
    same(port.execute(sql), ref.execute(sql))


def test_missing_column_gets_null_default():
    seg = mutable("port", [{"zone": "u1", "ts": 1}])
    assert seg.n_docs == 1
    sc, dt = MODS["port"][:2]
    assert seg.values("fare")[0] == \
        schema(sc, dt).field("fare").null_value()
    assert seg.row_value("fare", 0) is None
    assert seg.null_vector("hour").tolist() == [True]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_sealed_segments_load_in_the_other_package(tmp_path, writer):
    rows = make_rows(3000, seed=4)
    seg = mutable(writer, rows, rows_per=1024)
    sealed = seg.seal(str(tmp_path / "s"))
    ref, port = engines([RefSegment(sealed.dir)],
                        [ImmutableSegment(sealed.dir)])
    check(ref, port, QUERIES + MORE_QUERIES)
    # and they equal the segment sealed by the other package
    other = mutable("ref" if writer == "port" else "port", rows,
                    rows_per=1024).seal(str(tmp_path / "o"))
    for col in ("zone", "hour", "fare", "ts"):
        np.testing.assert_array_equal(
            ImmutableSegment(sealed.dir).values(col),
            ImmutableSegment(other.dir).values(col))
