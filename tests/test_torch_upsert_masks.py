"""Upsert valid-docs masks through the port's QueryEngine on the CPU,
against the reference's engine: tests/test_differential_large.py's table
with its masked last segment (every odd doc superseded), at a small
size; tests/test_multivalue.py::TestMutableMV's consuming MV segment,
queried and sealed; and a mask that changes between two runs of one
query, whose second answer must follow it (no stale plane, no stale
partials)."""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.storage.creator import build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.engine import rows as t_rows
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_mutable import MODS, engines, same

N_ROWS = 60_000
N_SEGMENTS = 4
HIGH_CARD = 90_000

# tests/test_differential_large.py's QUERIES (their Pinot SQL)
QUERIES = [
    "SELECT COUNT(*), SUM(amount), MIN(amount), MAX(amount) FROM events",
    "SELECT SUM(amount) FROM events WHERE amount BETWEEN 250000 AND 750000",
    "SELECT COUNT(*), SUM(ratio) FROM events "
    "WHERE site IN ('s03','s11','s17')",
    "SELECT site, COUNT(*), SUM(amount), AVG(ratio) FROM events "
    "GROUP BY site ORDER BY site LIMIT 30",
    "SELECT site, code, SUM(amount) FROM events WHERE code < 10 "
    "GROUP BY site, code ORDER BY site, code LIMIT 300",
    "SELECT devid, COUNT(*), SUM(amount) FROM events GROUP BY devid "
    "ORDER BY COUNT(*) DESC, devid LIMIT 20",
    "SELECT devid, code, COUNT(*), SUM(amount), MIN(amount), MAX(amount) "
    "FROM events WHERE devid < 20000 AND code = 7 "
    "GROUP BY devid, code ORDER BY COUNT(*) DESC, devid, code LIMIT 25",
    "SELECT COUNT(*) FROM events WHERE opt IS NULL",
    "SELECT site, COUNT(*) FROM events WHERE opt IS NOT NULL "
    "GROUP BY site ORDER BY site LIMIT 30",
    "SELECT COUNT(*) FROM events WHERE tags = 'gold'",
    "SELECT SUM(ARRAYLENGTH(tags)) FROM events",
    "SELECT DISTINCTCOUNT(code) FROM events WHERE site = 's05'",
    "SELECT TIMECONVERT(amount, 'MILLISECONDS', 'SECONDS'), COUNT(*) "
    "FROM events WHERE amount < 5000 GROUP BY "
    "TIMECONVERT(amount, 'MILLISECONDS', 'SECONDS') "
    "ORDER BY TIMECONVERT(amount, 'MILLISECONDS', 'SECONDS') LIMIT 10",
    "SELECT site, devid, amount FROM events WHERE code = 3 "
    "ORDER BY amount DESC, devid LIMIT 8",
    "SELECT DISTINCTCOUNTHLL(devid), MINMAXRANGE(ratio) FROM events",
]


@pytest.fixture(scope="module")
def seg_dirs(tmp_path_factory):
    """tests/test_differential_large.py's _build at N_ROWS rows."""
    rng = np.random.default_rng(2024)
    n = N_ROWS
    cols = {
        "site": np.array([f"s{i:02d}" for i in range(24)])[
            rng.integers(0, 24, n)],
        "devid": rng.integers(0, HIGH_CARD, n).astype(np.int32),
        "code": rng.integers(0, 50, n).astype(np.int32),
        "amount": rng.integers(0, 1_000_000, n).astype(np.int64),
        "ratio": np.round(rng.uniform(0, 10, n), 4),
        "opt": rng.integers(1, 100, n).astype(np.int32),
    }
    null_mask = rng.random(n) < 0.1
    opt_vals = cols["opt"].astype(object)
    opt_vals[null_mask] = None
    cols["opt"] = opt_vals
    tagpool = np.array(["red", "green", "blue", "gold"])
    lens = rng.integers(0, 4, n)
    cols["tags"] = [list(tagpool[rng.choice(4, k, replace=False)])
                    for k in lens]
    schema = Schema.build(
        name="events",
        dimensions=[("site", DataType.STRING), ("devid", DataType.INT),
                    ("code", DataType.INT)],
        multi_value_dimensions=[("tags", DataType.STRING)],
        metrics=[("amount", DataType.LONG), ("ratio", DataType.DOUBLE),
                 ("opt", DataType.INT)],
    )
    cfg = TableConfig(table_name="events", indexing=IndexingConfig(
        inverted_index_columns=["site"]))
    base = tmp_path_factory.mktemp("masks")
    per = n // N_SEGMENTS
    dirs = []
    for i in range(N_SEGMENTS):
        sl = slice(i * per, n if i == N_SEGMENTS - 1 else (i + 1) * per)
        part = {k: v[sl] for k, v in cols.items()}
        d = str(base / f"seg{i}")
        build_segment(schema, part, d, cfg, f"events_{i}")
        dirs.append(d)
    return dirs


def _masked_engines(dirs, masks):
    """Reference and port engines over ``dirs``, segment i carrying
    ``masks[i]`` (None: no mask) as its valid-docs mask."""
    ref_segs = [RefSegment(d) for d in dirs]
    port_segs = [ImmutableSegment(d) for d in dirs]
    for i, m in enumerate(masks):
        if m is not None:
            ref_segs[i].valid_docs_mask = m.copy()
            port_segs[i].valid_docs_mask = m.copy()
    ref, port = engines(ref_segs, port_segs, table="events")
    return ref, port, ref_segs, port_segs


def _odd_docs_superseded(n):
    m = np.ones(n, dtype=bool)
    m[1::2] = False
    return m


@pytest.fixture(scope="module")
def masked(seg_dirs):
    n_last = RefSegment(seg_dirs[-1]).n_docs
    return _masked_engines(seg_dirs, [None] * (N_SEGMENTS - 1)
                           + [_odd_docs_superseded(n_last)])


@pytest.mark.parametrize("sql", QUERIES)
def test_masked_last_segment(masked, sql):
    ref, port, _r, _p = masked
    same(port.execute(sql), ref.execute(sql))


def test_masked_segment_runs_alone_in_the_host_shape(masked, monkeypatch):
    _ref, port, _r, port_segs = masked
    seen = []
    real = t_rows.launch

    def spy(ex, q, ctx, *a, **kw):
        seen.append(([s.name for s in ctx.segments],
                     kw.get("valid") is not None))
        return real(ex, q, ctx, *a, **kw)

    monkeypatch.setattr(t_rows, "launch", spy)
    r = port.execute("SELECT COUNT(*), SUM(amount) FROM events")
    assert r["exceptions"] == []
    # the three unmasked segments ride one device batch (the device
    # shape: rows.launch not called for it); the masked one alone
    assert seen == [([port_segs[-1].name], True)]


def test_mask_change_between_runs_is_followed(seg_dirs):
    n = [RefSegment(d).n_docs for d in seg_dirs]
    first = np.ones(n[1], dtype=bool)
    first[:100] = False
    ref, port, ref_segs, port_segs = _masked_engines(
        seg_dirs, [None, first, None, None])
    port.device.partials_cache_enabled = True
    sqls = QUERIES[:4] + [QUERIES[13]]
    for sql in sqls:
        same(port.execute(sql), ref.execute(sql))
        same(port.execute(sql), ref.execute(sql))   # a repeat
    # the writer flips more docs in place, and a second segment gains a
    # mask (an upsert's first invalidation there)
    for segs in (ref_segs, port_segs):
        segs[1].valid_docs_mask[5000:9000] = False
        m = np.ones(n[2], dtype=bool)
        m[::3] = False
        segs[2].valid_docs_mask = m
    for sql in sqls:
        same(port.execute(sql), ref.execute(sql))
    # and back: the masks lifted
    for segs in (ref_segs, port_segs):
        segs[1].valid_docs_mask[:] = True
    for sql in sqls:
        same(port.execute(sql), ref.execute(sql))


MV_ROWS = [
    {"user": "a", "tags": ["x", "y"], "ports": [1, 2], "amount": 10},
    {"user": "b", "tags": ["y"], "ports": [3], "amount": 20},
    {"user": "a", "tags": [], "ports": [5, 6, 7], "amount": 30},
]
MV_SQL = [
    "SELECT COUNT(*) FROM ev WHERE tags = 'y'",
    "SELECT COUNTMV(ports), SUMMV(ports) FROM ev",
    "SELECT tags, COUNT(*) FROM ev GROUP BY tags ORDER BY tags",
    "SELECT user, MAXMV(ports), DISTINCTCOUNTMV(tags) FROM ev "
    "GROUP BY user ORDER BY user",
]


def _mv_segment(side):
    sc, dt, _tc, mut = MODS[side]
    DT = dt.DataType
    schema = sc.Schema.build(
        name="ev", dimensions=[("user", DT.STRING)],
        multi_value_dimensions=[("tags", DT.STRING), ("ports", DT.INT)],
        metrics=[("amount", DT.INT)])
    seg = mut.MutableSegment(schema, "m0")
    for row in MV_ROWS:
        seg.index(row)
    return seg


def test_mutable_mv_index_query_seal(tmp_path):
    """tests/test_multivalue.py::TestMutableMV, through both engines."""
    ref_seg, port_seg = _mv_segment("ref"), _mv_segment("port")
    ref, port = engines([ref_seg], [port_seg], table="ev")
    for sql in MV_SQL:
        same(port.execute(sql), ref.execute(sql))
    assert port.execute(MV_SQL[1])["resultTable"]["rows"] == [[6, 24]]
    assert port.execute(MV_SQL[2])["resultTable"]["rows"] == \
        [["x", 1], ["y", 2]]
    sealed = port_seg.seal(str(tmp_path / "sealed"))
    ref2, port2 = engines([RefSegment(sealed.dir)],
                          [ImmutableSegment(sealed.dir)], table="ev")
    for sql in MV_SQL:
        same(port2.execute(sql), ref2.execute(sql))
        assert port2.execute(sql)["resultTable"]["rows"] == \
            port.execute(sql)["resultTable"]["rows"]
