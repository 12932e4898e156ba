"""The JSON, text, FST and geo indexes on the port against the JAX package.

Both creators write the same columns with the four indexes: the index
files must be byte-identical and each engine must answer over the
other's segments. The SQL of tests/test_json.py, tests/test_text.py,
tests/test_fst_index.py and tests/test_geo_index.py then runs through the
port and through the reference (its device in interpret mode), once with
the index and once over an unindexed twin, and once over a table whose
segments disagree (one indexed, one not): rows, order, the dataSchema and
every response stat must be equal. EXPLAIN names the index operators as
the reference does (its backend label aside, tests/test_torch_explain.py).
Each file's own tests replay through the port behind its fixture.
"""

import inspect
import json
import os

import numpy as np
import pytest

import test_fst_index
import test_geo_index
import test_json
import test_text
from pinot_tpu.common.datatypes import DataType
from pinot_tpu.common.schema import Schema
from pinot_tpu.common.table_config import IndexingConfig, TableConfig
from pinot_tpu.engine.device import DeviceExecutor as RefExecutor
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from pinot_tpu.ops import geo
from pinot_tpu.storage.creator import build_segment as ref_build
from pinot_tpu.storage.segment import ImmutableSegment as RefSegment
from pinot_tpu_torch.common.datatypes import DataType as PDataType
from pinot_tpu_torch.common.schema import Schema as PSchema
from pinot_tpu_torch.common.table_config import IndexingConfig as PIndexing
from pinot_tpu_torch.common.table_config import TableConfig as PTableConfig
from pinot_tpu_torch.engine.engine import QueryEngine
from pinot_tpu_torch.engine.explain import BACKEND_DEVICE, BACKEND_HOST_SHAPE
from pinot_tpu_torch.storage import fstindex, geoindex
from pinot_tpu_torch.storage.creator import build_segment as port_build
from pinot_tpu_torch.storage.segment import ImmutableSegment
from test_torch_selection import STATS, _rows_close

LABELS = {"DEVICE(jax/xla)": BACKEND_DEVICE,
          "HOST(numpy)": BACKEND_HOST_SHAPE}


def _q(s: str) -> str:
    """A JSON_MATCH inner expression quoted into the SQL string literal."""
    return s.replace("'", "''")


JSON_MATCHES = [
    "\"$.name\" = 'ann'", "\"$.addresses[*].country\" = 'us'",
    "\"$.addresses[0].country\" = 'us'",
    "\"$.addresses[*].country\" = 'us' AND \"$.addresses[*].city\" = 'nyc'",
    '"$.age" = 30', '"$.age" IN (25, 41)', '"$.age" <> 30',
    '"$.age" IS NULL', '"$.vip" IS NOT NULL',
    '"$.age" > 26 AND "$.age" <= 41', '"$.scores[*]" >= 8',
    "\"$.name\" > 'cat'", "\"$.name\" = 'dan' OR \"$.age\" = 25",
    "NOT \"$.addresses[*].country\" = 'us'",
]
JSON_SQL = [f"SELECT id FROM people WHERE JSON_MATCH(person, '{_q(m)}') "
            f"ORDER BY id" for m in JSON_MATCHES] + [
    "SELECT COUNT(*) FROM people WHERE id < 4 AND "
    "JSON_MATCH(person, '\"$.addresses[*].country\" = ''us''')",
    "SELECT JSON_EXTRACT_SCALAR(person, '$.name', 'STRING'), "
    "JSON_EXTRACT_SCALAR(person, '$.age', 'INT', -1) FROM people ORDER BY id",
    "SELECT JSON_EXTRACT_SCALAR(person, '$.age', 'INT', 0), COUNT(*) "
    "FROM people GROUP BY JSON_EXTRACT_SCALAR(person, '$.age', 'INT', 0) "
    "ORDER BY JSON_EXTRACT_SCALAR(person, '$.age', 'INT', 0)",
    "SELECT id, SUM(id) FROM people WHERE JSON_MATCH(person, "
    "'\"$.age\" >= 25') GROUP BY id ORDER BY id",
]
TEXT_QUERIES = ["query", "QUERY", "query AND processing", "fox OR olap",
                "fox olap", '"query processing"', '"processing query"',
                "optim*", "pro*", "(fox OR olap) AND query", "zebra",
                "planning and"]
TEXT_SQL = [f"SELECT id FROM docs WHERE TEXT_MATCH(body, '{t}') ORDER BY id"
            for t in TEXT_QUERIES] + [
    "SELECT COUNT(*), SUM(id) FROM docs WHERE TEXT_MATCH(body, 'query') "
    "AND id > 0"]
GEO_SQL = list(test_geo_index.GEO_QUERIES) + [
    "SELECT COUNT(*), SUM(v) FROM pois WHERE "
    "ST_DISTANCE(loc, ST_POINT(1.5, 50.0)) < 20000 AND v > 50",
    "SELECT v, COUNT(*) FROM pois WHERE "
    "ST_DISTANCE(loc, ST_POINT(-1.0, 47.0)) <= 30000 GROUP BY v "
    "ORDER BY COUNT(*) DESC, v LIMIT 5"]
EXPLAIN_SQL = {
    "people": "EXPLAIN PLAN FOR SELECT COUNT(*) FROM people WHERE "
              "JSON_MATCH(person, '\"$.name\" = ''ann''')",
    "docs": "EXPLAIN PLAN FOR SELECT COUNT(*) FROM docs "
            "WHERE TEXT_MATCH(body, 'query')",
}


def _tables() -> dict:
    """table -> (schema args, columns, the indexing that covers it)."""
    rng = np.random.default_rng(44)
    n = 6000
    hosts = np.asarray([f"h{i % 7}.dc{i % 3}.example" for i in range(40)])
    urls = np.asarray([
        f"/api/v{rng.integers(1, 4)}/resource_{rng.integers(0, 3000):04d}"
        f"/{'edit' if rng.random() < 0.1 else 'view'}" for _ in range(n)])
    grng = np.random.default_rng(12)
    m = 4000
    return {
        "people": (
            [("person", "JSON"), ("id", "INT")], [],
            {"person": np.asarray([json.dumps(d) for d in test_json.DOCS],
                                  dtype=np.str_),
             "id": np.arange(len(test_json.DOCS), dtype=np.int32)},
            {"json_index_columns": ["person"]}),
        "docs": (
            [("body", "STRING"), ("id", "INT")], [],
            {"body": np.asarray(test_text.REVIEWS, dtype=np.str_),
             "id": np.arange(len(test_text.REVIEWS), dtype=np.int32)},
            {"text_index_columns": ["body"]}),
        "logs": (
            [("url", "STRING"), ("host", "STRING")], [("v", "INT")],
            {"url": urls, "host": hosts[rng.integers(0, 40, n)],
             "v": rng.integers(0, 100, n).astype(np.int32)},
            {"fst_index_columns": ["url", "host"]}),
        "pois": (
            [("loc", "STRING")], [("v", "INT")],
            {"loc": geo.st_point(grng.uniform(-5, 5, m),
                                 grng.uniform(45, 55, m)),
             "v": grng.integers(0, 100, m).astype(np.int32)},
            {"h3_index_columns": ["loc"]}),
    }


def _build(writer: str, table: str, out: str, indexed: bool, cols=None):
    dims, mets, data, idx = _tables()[table]
    if cols is not None:
        data = {k: v[cols] for k, v in data.items()}
    if writer == "ref":
        S, D, T, I, build = Schema, DataType, TableConfig, IndexingConfig, \
            ref_build
    else:
        S, D, T, I, build = PSchema, PDataType, PTableConfig, PIndexing, \
            port_build
    schema = S.build(name=table, dimensions=[(c, D[t]) for c, t in dims],
                     metrics=[(c, D[t]) for c, t in mets])
    build(schema, data, out, T(table_name=table,
                               indexing=I(**(idx if indexed else {}))),
          os.path.basename(out))
    return out


SQL = {"people": JSON_SQL, "docs": TEXT_SQL,
       "logs": list(test_fst_index.FST_QUERIES), "pois": GEO_SQL}
LAYOUTS = ("indexed", "scan", "mixed")


@pytest.fixture(scope="module")
def table_dirs(tmp_path_factory):
    """(table, layout) -> segment dirs written by the reference's creator:
    one indexed segment, its unindexed twin, or two halves of which only
    the first is indexed."""
    base = tmp_path_factory.mktemp("torch_indexes")
    out = {}
    for table, (_d, _m, data, _i) in _tables().items():
        n = len(next(iter(data.values())))
        out[(table, "indexed")] = [_build("ref", table,
                                          str(base / f"{table}_i"), True)]
        out[(table, "scan")] = [_build("ref", table,
                                       str(base / f"{table}_p"), False)]
        half = np.arange(n) < n // 2
        out[(table, "mixed")] = [
            _build("ref", table, str(base / f"{table}_m0"), True, half),
            _build("ref", table, str(base / f"{table}_m1"), False, ~half)]
    return out


def _engines(dirs, table):
    ref = RefEngine(device_executor=RefExecutor(mm_mode="interpret"))
    # both engines' partials caches off: EXPLAIN renders no CACHED_PARTIALS
    # line, whose entry count would depend on the queries run before
    ref.device.partials_cache_enabled = False
    port = QueryEngine(device="cpu")
    port.device.partials_cache_enabled = False
    port.device.min_rows = 0
    for d in dirs:
        ref.add_segment(table, RefSegment(d))
        port.add_segment(table, ImmutableSegment(d))
    return ref, port


def _same(got, want):
    assert want["exceptions"] == [] and got["exceptions"] == [], got
    assert got["resultTable"]["dataSchema"] == \
        want["resultTable"]["dataSchema"]
    rows, ref_rows = got["resultTable"]["rows"], want["resultTable"]["rows"]
    assert _rows_close(rows, ref_rows), (rows[:5], ref_rows[:5])
    for key in STATS:
        assert got[key] == want[key], (key, got[key], want[key])


CASES = [(t, lay, i) for t in SQL for lay in LAYOUTS
         for i in range(len(SQL[t]))]


@pytest.fixture(scope="module")
def engines(table_dirs):
    return {k: _engines(v, k[0]) for k, v in table_dirs.items()}


@pytest.mark.parametrize("table,layout,i", CASES)
def test_index_sql_matches_reference(engines, table, layout, i):
    ref, port = engines[(table, layout)]
    sql = SQL[table][i]
    _same(port.execute(sql), ref.execute(sql))


@pytest.mark.parametrize("table", sorted(EXPLAIN_SQL))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_explain_names_the_index(engines, table, layout):
    ref, port = engines[(table, layout)]
    want = ref.execute(EXPLAIN_SQL[table])["resultTable"]["rows"]
    got = port.execute(EXPLAIN_SQL[table])["resultTable"]["rows"]
    for label, ours in LABELS.items():
        want = [[r[0].replace(label, ours)] + r[1:] for r in want]
    assert got == want
    ops = " ".join(r[0] for r in got)
    kind = "JSON" if table == "people" else "TEXT"
    assert (f"FILTER_{kind}_INDEX" in ops) == (layout != "scan")


def test_fst_index_narrows(engines, monkeypatch):
    """The trigram index's candidates narrow the dictionary before the
    pattern runs (engine/params.py ``regex_lut``)."""
    _ref, port = engines[("logs", "indexed")]
    calls = []
    real = fstindex.TrigramIndex.candidates

    def spy(self, pattern, n):
        out = real(self, pattern, n)
        calls.append(0 if out is None else len(out))
        return out

    monkeypatch.setattr(fstindex.TrigramIndex, "candidates", spy)
    r = port.execute("SELECT COUNT(*) FROM logs WHERE "
                     "REGEXP_LIKE(url, 'resource_0042')")
    assert r["exceptions"] == [], r
    assert calls and calls[0] < 50


def test_geo_index_bounds_the_candidates(engines, monkeypatch):
    _ref, port = engines[("pois", "indexed")]
    calls = []
    real = geoindex.GeoGridIndex.candidate_docs

    def spy(self, lon, lat, r):
        out = real(self, lon, lat, r)
        calls.append(len(out))
        return out

    monkeypatch.setattr(geoindex.GeoGridIndex, "candidate_docs", spy)
    r = port.execute(GEO_SQL[0])
    assert r["exceptions"] == [], r
    assert calls and calls[0] < 4000
    assert 0 < r["numEntriesScannedInFilter"] < 4000


# ---------------------------------------------------------------------------
# the creators and readers, both directions
# ---------------------------------------------------------------------------

INDEX_FILES = {"people": ("jsonidx",), "docs": ("textidx",),
               "logs": ("fst", "trigram"), "pois": ("geo", "grid")}


@pytest.mark.parametrize("table", sorted(INDEX_FILES))
def test_creators_write_identical_index_files(tmp_path, table):
    a = _build("ref", table, str(tmp_path / "ref"), True)
    b = _build("port", table, str(tmp_path / "port"), True)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    idx = [f for f in files if any(k in f for k in INDEX_FILES[table])]
    assert idx, files
    for f in files:
        if f in ("metadata.json", "creation.meta.json"):
            continue
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("table", sorted(INDEX_FILES))
def test_each_engine_reads_the_others_segments(tmp_path, table):
    """The reference over the port creator's segment and the port over
    the reference creator's answer alike."""
    ref_dir = _build("ref", table, str(tmp_path / "ref"), True)
    port_dir = _build("port", table, str(tmp_path / "port"), True)
    ref, _ = _engines([port_dir], table)
    _, port = _engines([ref_dir], table)
    for sql in SQL[table]:
        _same(port.execute(sql), ref.execute(sql))
    readers = {"people": "json_index", "docs": "text_index",
               "logs": "fst_index", "pois": "geo_index"}[table]
    col = {"people": "person", "docs": "body", "logs": "url",
           "pois": "loc"}[table]
    assert getattr(ImmutableSegment(ref_dir), readers)(col) is not None
    assert getattr(RefSegment(port_dir), readers)(col) is not None


# ---------------------------------------------------------------------------
# the index test files through the port, behind their own fixtures
# ---------------------------------------------------------------------------

def _unwrap(fixture):
    make = getattr(fixture, "_get_wrapped_function", None)
    return make() if make is not None else fixture.__wrapped__


def _methods(module, classes) -> list:
    out = []
    for cname in classes:
        cls = getattr(module, cname)
        for mname, _fn in inspect.getmembers(cls, inspect.isfunction):
            if mname.startswith("test_") and "consulted" not in mname:
                out.append((module.__name__, cname, mname))
    return out


REPLAYS = (_methods(test_json, ("TestJsonMatch", "TestJsonExtractScalar"))
           + _methods(test_text, ("TestTextMatch",))
           + _methods(test_fst_index, ("TestFstQueries",))
           + _methods(test_geo_index, ("TestGeoIndexQueries",)))
MODULES = {m.__name__: m for m in (test_json, test_text, test_fst_index,
                                   test_geo_index)}


def _port_of(ref_engine) -> QueryEngine:
    """A port engine over the same segment directories."""
    port = QueryEngine(device="cpu")
    port.device.min_rows = 0
    for name, tdm in ref_engine.tables.items():
        for seg in tdm.segments.values():
            port.add_segment(name, ImmutableSegment(seg.dir))
    return port


@pytest.fixture(scope="module")
def replay_engines(tmp_path_factory):
    """Per module, per index setting, the port over the segments the
    module's own fixture writes."""
    out = {}
    for flag in (True, False):
        class _Req:
            param = flag
        out[("test_json", flag)] = _port_of(_unwrap(test_json.engine)(
            _Req, tmp_path_factory))
        out[("test_text", flag)] = _port_of(_unwrap(test_text.engine)(
            _Req, tmp_path_factory))
    for mod in (test_fst_index, test_geo_index):
        with_idx, without = _unwrap(mod.engines)(tmp_path_factory)
        out[(mod.__name__, "pair")] = (_port_of(with_idx), _port_of(without))
    return out


CASES_REPLAY = [(m, c, f, flag) for m, c, f in REPLAYS
                for flag in ((True, False) if m in ("test_json", "test_text")
                             else ("pair",))]


@pytest.mark.parametrize("mod,cname,mname,flag", CASES_REPLAY)
def test_index_test_files_through_the_port(replay_engines, mod, cname, mname,
                                           flag):
    module = MODULES[mod]
    fn = getattr(getattr(module, cname)(), mname)
    if flag != "pair":
        fn(engine=replay_engines[(mod, flag)])
        return
    kwargs = {"engines": replay_engines[(mod, "pair")]}
    if "sql" in inspect.signature(fn).parameters:
        for sql in getattr(module, "FST_QUERIES", None) \
                or module.GEO_QUERIES:
            fn(sql=sql, **kwargs)
    else:
        fn(**kwargs)


# ---------------------------------------------------------------------------
# the builders over distinct strings against their doc-by-doc loops
# ---------------------------------------------------------------------------

def _json_docs(rng, n: int) -> np.ndarray:
    def doc():
        d = {}
        for k in rng.choice(["a", "b", "arr", "n"], rng.integers(0, 4),
                            replace=False):
            r = rng.random()
            if r < 0.3:
                d[str(k)] = int(rng.integers(0, 4))
            elif r < 0.5:
                d[str(k)] = [True, None, 2.0, 2.5][int(rng.integers(0, 4))]
            elif r < 0.8:
                d[str(k)] = [{"p": int(rng.integers(0, 2))}, "x", 1][
                    : int(rng.integers(0, 4))]
            else:
                d[str(k)] = {"m": [1, 2][: int(rng.integers(0, 3))]}
        return json.dumps(d)
    pool = [doc() for _ in range(60)] + ["not json", "[1, 2]", "null"]
    return np.asarray([pool[i] for i in rng.integers(0, len(pool), n)])


@pytest.mark.parametrize("n", [0, 1, 2000])
def test_json_index_over_distinct_strings_is_the_loops(tmp_path, n):
    from pinot_tpu_torch.storage import jsonindex

    vals = _json_docs(np.random.default_rng(n), n)
    jsonindex.build_json_index(vals, str(tmp_path / "a"))
    jsonindex.build_json_index(list(vals), str(tmp_path / "b"))
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    for k in b.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n", [1, 7, 3000])
def test_text_postings_over_distinct_strings_are_the_loops(n):
    from pinot_tpu_torch.storage import textindex

    rng = np.random.default_rng(n)
    words = ["fix", "Bug", "merge-pull", "a1", "x", "", "über", "Q!"]
    pool = [" ".join(rng.choice(words, rng.integers(0, 6)))
            for _ in range(50)]
    vals = np.asarray([pool[i] for i in rng.integers(0, 50, n)])
    got = textindex._build_postings(vals)
    want = textindex._build_postings(list(vals))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phrase_docs_are_the_references(seed):
    """The port's phrase match intersects (doc, start) keys at once; the
    reference's walks doc by doc: the same docs."""
    from pinot_tpu.storage import textindex as ref_text
    from pinot_tpu_torch.storage import textindex

    rng = np.random.default_rng(seed)
    words = np.array(["merge", "pull", "fix", "a", "b"])
    docs = np.asarray([" ".join(words[rng.integers(0, 5, rng.integers(
        0, 12))]) for _ in range(3000)])
    ours = textindex.ScanTextIndex(docs)
    theirs = ref_text.ScanTextIndex(docs)
    for phrase in ("merge pull", "pull merge fix", "a a", "fix", "b a b"):
        np.testing.assert_array_equal(
            textindex._phrase_docs(phrase, ours),
            ref_text._phrase_docs(phrase, theirs))
