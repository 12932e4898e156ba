"""The port's star-tree cubes and metadata-only path against the JAX
package's.

The fixture is tests/test_startree.py's: 20k SSB-shaped rows in two
segments, one tree over (d_year, d_region, d_category) with its ten
function-column pairs. The same segments (written by the JAX package's
creator) load into the reference's ``QueryEngine`` and the port's
``QueryEngine(device="cpu")``; rows and response stats must be equal
(integers, counts and HLL estimates bit for bit; every sum here is an
integer below 2^24, so the f32 DOUBLE planes hold it exactly). Cubes
written by either creator must load in the other's ``load_star_trees``
with the same columns, dtypes, encodings and values.
"""

import numpy as np
import pytest

from pinot_tpu.common.datatypes import DataType as RefDataType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.table_config import IndexingConfig as RefIndexing
from pinot_tpu.common.table_config import StarTreeIndexConfig as RefStarTree
from pinot_tpu.common.table_config import TableConfig as RefTableConfig
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.storage.creator import build_segment as ref_build_segment
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu.storage.startree import load_star_trees as ref_load_star_trees
from pinot_tpu_torch.common.datatypes import DataType
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.table_config import (
    IndexingConfig,
    StarTreeIndexConfig,
    TableConfig,
)
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.ops import kernels
from pinot_tpu_torch.storage.creator import build_segment
from pinot_tpu_torch.storage.segment import ImmutableSegment
from pinot_tpu_torch.storage.startree import load_star_trees

DIMS = [("d_year", "INT"), ("d_region", "STRING"), ("d_category", "STRING")]
METRICS = [("revenue", "LONG"), ("quantity", "INT")]
PAIRS = [
    "SUM__revenue", "COUNT__*", "MIN__revenue", "MAX__revenue",
    "SUM__quantity", "DISTINCTCOUNTHLL__quantity",
    "PERCENTILETDIGEST__revenue",
    "DISTINCTCOUNTBITMAP__quantity", "PERCENTILEEST__revenue",
    "SUMPRECISION__revenue",
]
SPLIT = ["d_year", "d_region", "d_category"]

# tests/test_startree.py's ST_QUERIES
ST_QUERIES = [
    "SELECT SUM(revenue) FROM ssb",
    "SELECT SUM(revenue), COUNT(*) FROM ssb WHERE d_region = 'ASIA'",
    "SELECT d_year, SUM(revenue) FROM ssb GROUP BY d_year ORDER BY d_year",
    "SELECT d_region, d_year, SUM(revenue), COUNT(*) FROM ssb "
    "WHERE d_category IN ('cat1','cat5') GROUP BY d_region, d_year "
    "ORDER BY d_region, d_year LIMIT 50",
    "SELECT MIN(revenue), MAX(revenue) FROM ssb WHERE d_year BETWEEN 1994 AND 1996",
    "SELECT d_region, AVG(revenue) FROM ssb GROUP BY d_region ORDER BY d_region",
    "SELECT d_year, MINMAXRANGE(revenue) FROM ssb GROUP BY d_year ORDER BY d_year",
    "SELECT SUM(quantity) FROM ssb WHERE d_region != 'AFRICA'",
    "SELECT DISTINCTCOUNTHLL(quantity) FROM ssb",
    "SELECT DISTINCTCOUNTHLL(quantity) FROM ssb WHERE d_region = 'ASIA'",
    "SELECT d_year, COUNT(*), AVG(revenue), DISTINCTCOUNTHLL(quantity) "
    "FROM ssb GROUP BY d_year ORDER BY COUNT(*) DESC, d_year LIMIT 5",
]
STATS = ("numDocsScanned", "numEntriesScannedInFilter",
         "numEntriesScannedPostFilter", "numSegmentsQueried",
         "numSegmentsProcessed", "numSegmentsMatched",
         "numSegmentsPrunedByServer", "numGroupsLimitReached", "totalDocs")

# tests/test_startree.py's pairs whose cube-side merge the reference runs
# on its host (TDIGESTMERGE, BITMAPMERGE, SUMPRECISIONMERGE): the port
# runs them in the host path's shape on the card (engine/sketches.py)
MERGES = [
    "SELECT d_year, PERCENTILETDIGEST(revenue, 90) FROM ssb "
    "GROUP BY d_year ORDER BY d_year",
    # compression 400 fits no pair: the scan, on both
    "SELECT PERCENTILETDIGEST(revenue, 50, 400) FROM ssb",
    "SELECT d_year, PERCENTILEEST(revenue, 75) FROM ssb "
    "GROUP BY d_year ORDER BY d_year",
    "SELECT d_year, PERCENTILE(revenue, 75) FROM ssb "
    "GROUP BY d_year ORDER BY d_year",
    "SELECT d_region, SUMPRECISION(revenue) FROM ssb "
    "GROUP BY d_region ORDER BY d_region",
    "SELECT d_year, DISTINCTCOUNTBITMAP(quantity) FROM ssb "
    "WHERE d_region != 'AFRICA' GROUP BY d_year ORDER BY d_year",
    "SELECT d_year, DISTINCTCOUNT(quantity) FROM ssb "
    "WHERE d_region != 'AFRICA' GROUP BY d_year ORDER BY d_year",
]


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def _columns(n=20_000, seed=31):
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "d_region": np.array(["AMERICA", "ASIA", "EUROPE", "AFRICA"])[
            rng.integers(0, 4, n)],
        "d_category": np.array([f"cat{i}" for i in range(12)])[
            rng.integers(0, 12, n)],
        "revenue": rng.integers(100, 100_000, n).astype(np.int64),
        "quantity": rng.integers(1, 50, n).astype(np.int32),
    }


def _write(base, cols, port: bool, star: bool) -> list:
    """Two segments of ``cols`` written by the port's creator or the
    reference's, with the tree or without; their directories."""
    dt = DataType if port else RefDataType
    schema = (Schema if port else RefSchema).build(
        name="ssb", dimensions=[(c, dt[t]) for c, t in DIMS],
        metrics=[(c, dt[t]) for c, t in METRICS])
    if star:
        tree = (StarTreeIndexConfig if port else RefStarTree)(
            dimensions_split_order=SPLIT, function_column_pairs=PAIRS)
        cfg = (TableConfig if port else RefTableConfig)(
            table_name="ssb",
            indexing=(IndexingConfig if port else RefIndexing)(
                star_tree_configs=[tree]))
    else:
        cfg = (TableConfig if port else RefTableConfig)(table_name="ssb")
    build = build_segment if port else ref_build_segment
    n = len(cols["revenue"])
    dirs = []
    for i, sl in enumerate([slice(0, n // 2), slice(n // 2, n)]):
        out = str(base / f"s{i}")
        build(schema, {k: v[sl] for k, v in cols.items()}, out, cfg, f"s{i}")
        dirs.append(out)
    return dirs


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    cols = _columns()
    return {"cols": cols,
            "ref_star": _write(tmp_path_factory.mktemp("ref_star"), cols,
                               port=False, star=True),
            "ref_plain": _write(tmp_path_factory.mktemp("ref_plain"), cols,
                                port=False, star=False),
            "port_star": _write(tmp_path_factory.mktemp("port_star"), cols,
                                port=True, star=True)}


def _port(paths, min_rows=None):
    eng = QueryEngine(device="cpu")
    if min_rows is not None:
        eng.device.min_rows = min_rows
    for d in paths:
        eng.add_segment("ssb", ImmutableSegment(d))
    return eng


def _ref(paths):
    eng = RefEngine()
    for d in paths:
        eng.add_segment("ssb", RefSegment(d))
    return eng


@pytest.fixture(scope="module")
def engines(dirs):
    return {"port": _port(dirs["ref_star"]), "ref": _ref(dirs["ref_star"]),
            "port_plain": _port(dirs["ref_plain"])}


def test_port_creator_builds_the_cube(dirs):
    seg = ImmutableSegment(dirs["port_star"][0])
    (meta, st_seg), = load_star_trees(seg)
    assert meta["dimensions_split_order"] == SPLIT
    assert meta["function_column_pairs"] == PAIRS
    assert st_seg.n_docs < seg.n_docs
    assert "sum__revenue" in st_seg.column_names()


@pytest.mark.parametrize("sql", ST_QUERIES)
def test_star_tree_queries_match_reference(engines, sql):
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    for key in STATS:
        assert got[key] == want[key], key
    # and the scan over the plain segments answers the same rows
    plain = engines["port_plain"].execute(sql)
    assert plain["resultTable"]["rows"] == got["resultTable"]["rows"]


@pytest.mark.parametrize("sql", [
    "SELECT SUM(revenue), COUNT(*) FROM ssb WHERE d_year = 2005",
    "SELECT d_year, SUM(revenue) FROM ssb WHERE d_year > 2000 GROUP BY d_year",
])
def test_fully_pruned_cube_queries_match_reference(engines, sql):
    """Every segment fits the cube and is pruned: as in the reference, the
    answer is the empty partial of the first segment, every segment
    counts as pruned and all their docs in totalDocs."""
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    for key in STATS:
        assert got[key] == want[key], key
    assert got["numSegmentsPrunedByServer"] == 2


def test_cube_is_actually_used(engines):
    sql = "SELECT d_year, SUM(revenue) FROM ssb GROUP BY d_year"
    a = engines["port"].execute(sql)
    b = engines["port"].execute("SET useStarTree = false; " + sql)
    assert a["resultTable"]["rows"] == b["resultTable"]["rows"]
    assert a["numDocsScanned"] < b["numDocsScanned"] / 3
    assert b["numDocsScanned"] == 20_000
    hll = "SELECT d_year, DISTINCTCOUNTHLL(quantity) FROM ssb GROUP BY d_year"
    a = engines["port"].execute(hll)
    assert a["resultTable"] == engines["ref"].execute(hll)["resultTable"]
    assert a["numDocsScanned"] < 20_000 / 3


def test_unfit_and_opted_out_queries_scan(engines):
    port, ref = engines["port"], engines["ref"]
    # a filter on a metric column is not covered by the split dimensions
    sql = "SELECT SUM(revenue) FROM ssb WHERE quantity > 25"
    a, b = port.execute(sql), ref.execute(sql)
    assert a["resultTable"] == b["resultTable"]
    assert a["numDocsScanned"] == b["numDocsScanned"]
    assert a["numDocsScanned"] == engines["port_plain"].execute(
        sql)["numDocsScanned"]
    opt = "SET useStarTree = false; SELECT SUM(revenue) FROM ssb " \
          "WHERE d_region = 'ASIA'"
    a, b = port.execute(opt), ref.execute(opt)
    assert a["resultTable"] == b["resultTable"]
    assert a["numDocsScanned"] == b["numDocsScanned"]
    assert a["numDocsScanned"] == engines["port_plain"].execute(
        "SELECT SUM(revenue) FROM ssb WHERE d_region = 'ASIA'")[
        "numDocsScanned"]


def test_hll_log2m_mismatch_scans(engines, dict_pair_dirs):
    """A query at another register resolution than the cube's scans, as
    in the reference (merging planes of another m would skew the
    estimate): over the raw metric (hashed per doc at upload) and over a
    dict column, bit-identical to the reference; at the cube's
    resolution the dict column's pair answers from the cube."""
    sql = "SELECT DISTINCTCOUNTHLL(quantity, 8) FROM ssb"
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    assert got["numDocsScanned"] == want["numDocsScanned"] == 20_000
    port, ref = _port(dict_pair_dirs), _ref(dict_pair_dirs)
    for sql, cube in (
            ("SELECT d_year, DISTINCTCOUNTHLL(k, 8) FROM ssb GROUP BY d_year "
             "ORDER BY d_year", False),
            ("SELECT d_year, DISTINCTCOUNTHLL(k) FROM ssb GROUP BY d_year "
             "ORDER BY d_year", True)):
        got, want = port.execute(sql), ref.execute(sql)
        assert got["exceptions"] == [], got
        assert got["resultTable"] == want["resultTable"]
        assert got["numDocsScanned"] == want["numDocsScanned"]
        assert (got["numDocsScanned"] < 8000 / 3) == cube


def test_metadata_only_path(engines, dirs):
    cols = dirs["cols"]
    sql = "SELECT COUNT(*), MIN(revenue), MAX(revenue) FROM ssb"
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["resultTable"]["rows"][0] == [
        len(cols["revenue"]), float(cols["revenue"].min()),
        float(cols["revenue"].max())]
    assert got["numEntriesScannedPostFilter"] == 0
    assert got["resultTable"] == want["resultTable"]
    for key in STATS:
        assert got[key] == want[key], key
    # with a filter the metadata cannot answer: the cube does
    sql = "SELECT COUNT(*), MAX(revenue) FROM ssb WHERE d_year = 1995"
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["resultTable"] == want["resultTable"]
    assert got["numDocsScanned"] == want["numDocsScanned"] < 20_000


def _cube_view(load, seg_cls, d):
    (meta, st), = load(seg_cls(d))
    cols = {}
    for c in sorted(st.column_names()):
        m = st.column_metadata(c)
        v = np.asarray(st.values(c))
        cols[c] = (str(m.data_type.name), str(m.encoding), v.dtype.str,
                   v.tobytes())
    return meta, st.n_docs, cols


@pytest.mark.parametrize("i", [0, 1])
def test_cubes_load_in_both_packages(dirs, i):
    """A cube written by the port's creator loads in the reference's
    ``load_star_trees`` as the reference's own cube does, and the
    reverse: same tree metadata, rows, and per column the type, the
    encoding, the value dtype and the value bytes."""
    views = {(w, r): _cube_view(load, cls, dirs[f"{w}_star"][i])
             for w in ("port", "ref")
             for r, load, cls in (("port", load_star_trees, ImmutableSegment),
                                  ("ref", ref_load_star_trees, RefSegment))}
    first = views[("ref", "ref")]
    for key, view in views.items():
        assert view[0] == first[0], key
        assert view[1] == first[1], key
        assert sorted(view[2]) == sorted(first[2]), key
        for c in first[2]:
            assert view[2][c] == first[2][c], (key, c)


# (percentile, compression) of MERGES' digest queries
DIGESTS = {MERGES[0]: (90, 100), MERGES[1]: (50, 400),
           MERGES[2]: (75, 200), MERGES[3]: (75, 200)}


@pytest.mark.parametrize("sql", MERGES)
def test_merge_pairs_match_reference(engines, dirs, sql):
    """The digest, exact distinct and exact sum pairs answer from the
    cube as the reference's do: rows bit for bit (the cube's digests
    folded in the reference's order) and every response stat,
    numDocsScanned counting cube rows; the compression mismatch scans on
    both. Each digest answer also lies within rank 1.5 / compression of
    the exact order statistic (ops/quantile_digest.py)."""
    got, want = engines["port"].execute(sql), engines["ref"].execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    for key in STATS:
        assert got[key] == want[key], key
    scan = engines["port_plain"].execute(sql)["numDocsScanned"]
    cube = sql != MERGES[1]
    assert (got["numDocsScanned"] < scan / 3) == cube
    if sql not in DIGESTS:
        assert got["resultTable"] == engines["port_plain"].execute(
            sql)["resultTable"]
        return
    p, delta = DIGESTS[sql]
    cols = dirs["cols"]
    for row in got["resultTable"]["rows"]:
        vals = np.sort(cols["revenue"] if len(row) == 1
                       else cols["revenue"][cols["d_year"] == row[0]])
        rank = np.searchsorted(vals, row[-1]) / len(vals)
        assert abs(rank - p / 100) <= 1.5 / delta, (row, rank)


@pytest.fixture(scope="module")
def dict_pair_dirs(tmp_path_factory):
    """A small table whose HLL and DISTINCTCOUNTBITMAP pairs are over a
    dict column the scan can answer on the card."""
    rng = np.random.default_rng(5)
    n = 8000
    cols = {"d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "d_region": np.array(["AMERICA", "ASIA", "EUROPE"])[
                rng.integers(0, 3, n)],
            "k": rng.integers(0, 300, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int64)}
    schema = RefSchema.build(
        name="ssb", dimensions=[("d_year", RefDataType.INT),
                                ("d_region", RefDataType.STRING),
                                ("k", RefDataType.INT)],
        metrics=[("v", RefDataType.LONG)])
    cfg = RefTableConfig(table_name="ssb", indexing=RefIndexing(
        star_tree_configs=[RefStarTree(
            dimensions_split_order=["d_year", "d_region"],
            function_column_pairs=["COUNT__*", "DISTINCTCOUNTBITMAP__k",
                                   "DISTINCTCOUNTHLL__k",
                                   "SUMPRECISION__v"])]))
    base = tmp_path_factory.mktemp("bitmap")
    out = []
    for i, sl in enumerate([slice(0, n // 2), slice(n // 2, n)]):
        ref_build_segment(schema, {c: a[sl] for c, a in cols.items()},
                          str(base / f"s{i}"), cfg, f"s{i}")
        out.append(str(base / f"s{i}"))
    return out


@pytest.mark.parametrize("agg", ["DISTINCTCOUNTBITMAP(k)", "DISTINCTCOUNT(k)",
                                 "SUMPRECISION(v)"])
def test_dict_pair_merges_match_reference(dict_pair_dirs, agg):
    """Over a dict column's pairs, filtered: the reference merges the
    cube's value sets and decimal sums on its host, the port in that
    path's shape on the card. Rows, stats and cube-row numDocsScanned
    equal, and the scan answers the same rows."""
    sql = (f"SELECT d_year, {agg}, COUNT(*) FROM ssb "
           "WHERE d_region != 'ASIA' GROUP BY d_year ORDER BY d_year")
    got, want = _port(dict_pair_dirs).execute(sql), _ref(dict_pair_dirs).execute(sql)
    assert got["exceptions"] == [] and want["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    for key in STATS:
        assert got[key] == want[key], key
    assert got["numDocsScanned"] < 8000 / 3
    scan = _port(dict_pair_dirs).execute("SET useStarTree = false; " + sql)
    assert scan["resultTable"] == got["resultTable"]


def test_sumprecision_pair_over_fractions_refused_in_band(tmp_path):
    """A cube whose SUMPRECISION states hold fractions (a DOUBLE column):
    its merge, once refused in-band (ROADMAP item e2b), answers the
    reference's exact decimal strings, and so does the scan (SET
    useStarTree = false) over the same non-integer values."""
    rng = np.random.default_rng(9)
    n = 4000
    cols = {"d_year": rng.integers(1992, 1995, n).astype(np.int32),
            "f": np.round(rng.uniform(0, 10, n), 2)}
    schema = RefSchema.build(name="ssb",
                             dimensions=[("d_year", RefDataType.INT)],
                             metrics=[("f", RefDataType.DOUBLE)])
    cfg = RefTableConfig(table_name="ssb", indexing=RefIndexing(
        star_tree_configs=[RefStarTree(
            dimensions_split_order=["d_year"],
            function_column_pairs=["COUNT__*", "SUMPRECISION__f"])]))
    ref_build_segment(schema, cols, str(tmp_path / "s0"), cfg, "s0")
    sql = "SELECT d_year, SUMPRECISION(f) FROM ssb GROUP BY d_year"
    got = _port([str(tmp_path / "s0")]).execute(sql)
    want = _ref([str(tmp_path / "s0")]).execute(sql)
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"] == want["resultTable"]
    assert got["numDocsScanned"] == want["numDocsScanned"] < n
    scan = _port([str(tmp_path / "s0")]).execute(
        "SET useStarTree = false; " + sql)
    assert scan["resultTable"] == want["resultTable"]
    assert scan["numDocsScanned"] == n


def test_cube_launches_reach_the_kernel_wrappers(dirs, engines, monkeypatch):
    """At the kernel gate of 0 rows the cube launches run through K1's
    and K2's wrappers (their plain versions on the CPU), as the
    reference's interpret mode ignores its gate; at the default gate the
    cubes' few hundred rows take the torch scatters."""
    calls = {"group_plane_sums": 0, "group_minmax": 0}

    def spy(name):
        real = getattr(kernels, name + "_plain")

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(kernels, name + "_plain", wrapped)

    spy("group_plane_sums")
    spy("group_minmax")
    sqls = (ST_QUERIES[2], ST_QUERIES[6])
    for sql in sqls:
        engines["port"].execute(sql)
    assert calls == {"group_plane_sums": 0, "group_minmax": 0}
    eng = _port(dirs["ref_star"], min_rows=0)
    for sql in sqls:
        got = eng.execute(sql)
        assert got["resultTable"] == engines["ref"].execute(sql)["resultTable"]
        assert got["numDocsScanned"] < 20_000 / 3
    # the MINMAXRANGE group-by takes its counts from K1 as well
    assert calls == {"group_plane_sums": 2, "group_minmax": 1}


@pytest.mark.parametrize("sql", [
    "SELECT d_year, COUNT(*), AVG(revenue), DISTINCTCOUNTHLL(quantity) "
    "FROM ssb GROUP BY d_year ORDER BY d_year",
    "SELECT DISTINCTCOUNTHLL(quantity), SUM(quantity) FROM ssb "
    "WHERE d_region = 'ASIA'",
])
def test_non_terminal_cube_partials_match_reference(dirs, sql):
    """Without ``terminal`` the cube launch returns the mergeable
    partials: HLLMERGE's int32 register planes (every group), sums and
    counts, equal to the reference engine's server partial."""
    from pinot_tpu.query.optimizer import optimize_query as ref_optimize
    from pinot_tpu.sql.compiler import compile_query as ref_compile
    from pinot_tpu_torch.query.optimizer import optimize_query
    from pinot_tpu_torch.sql.compiler import compile_query

    port, ref = _port(dirs["ref_star"]), _ref(dirs["ref_star"])
    got = port.execute_segments(optimize_query(compile_query(sql)),
                                table_segs(port, "ssb"), terminal=False)
    tdm = ref.tables["ssb"]
    acq = tdm.acquire()
    try:
        want = ref.execute_segments(ref_optimize(ref_compile(sql)), acq,
                                    terminal=False)
    finally:
        tdm.release(acq)
    assert got.shape == want.shape
    for g, w in zip(got.group_keys or (), want.group_keys or ()):
        np.testing.assert_array_equal(g, w)
    assert "regs" in got.agg_partials[-1 if "GROUP" in sql else 0]
    for pg, pw in zip(got.agg_partials, want.agg_partials):
        assert sorted(pg) == sorted(pw)
        for key in pw:
            assert pg[key].dtype == np.asarray(pw[key]).dtype, key
            np.testing.assert_array_equal(pg[key], np.asarray(pw[key]))
    assert got.stats.num_docs_scanned == want.stats.num_docs_scanned
    assert got.stats.total_docs == want.stats.total_docs
