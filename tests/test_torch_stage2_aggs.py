"""Every aggregation the reference's stage 2 answers, over joined rows,
against the reference: the digests and sketches (engine/sketches.py laid
over the joined rows as a batch of one segment), FIRST/LASTWITHTIME, the
cube merges over a dimension table of serialized states, STUNION, grouped
and scalar, over sealed and over sealed + consuming fact segments.

The tables are tests/test_torch_join.py's (orders, parts, custs) plus
``states``, a dimension table whose BYTES and STRING columns hold HLL
register planes, t-digests, value sets and decimal sums, keyed by part
(six of them).
Rows are compared with integers bit for bit and floats within
``_rows_close``; every stat the response carries must match."""

import numpy as np
import pytest

import pinot_tpu.ops.quantile_digest as r_qd
from pinot_tpu.engine import aggspec as r_aggspec
from test_torch_join import (
    GATES,
    MODS,
    NO_ADVISOR,
    load,
    make_data,
    new_engine,
    same,
)

LOG2M = 4
# the states table keys 6 parts (~350 joined rows): the reference merges
# TDIGESTMERGE's digests row by row on its host
N_STATES = 6


def states_data(rng):
    """One row per part key below N_STATES: an HLL register plane (16
    bytes), a t-digest, a value set and a decimal sum, each serialized as
    a cube stores it."""
    hll, dig, bm, sp = [], [], [], []
    for k in range(N_STATES):
        regs = rng.integers(0, 12, 1 << LOG2M).astype(np.uint8)
        hll.append(regs.tobytes())
        vals = np.sort(rng.normal(100.0, 25.0, int(rng.integers(3, 40))))
        m, w = r_qd.compress(vals, np.ones(len(vals)))
        dig.append(r_qd.digest_to_bytes(m, w))
        bm.append(r_aggspec.set_to_bytes(
            rng.integers(0, 30, int(rng.integers(1, 6))).tolist()))
        sp.append(str(int(rng.integers(-10**12, 10**12))) if k % 3
                  else f"{rng.integers(-10**6, 10**6)}.{k:03d}")
    return {"skey": np.arange(N_STATES, dtype=np.int32),
            "hll": np.asarray(hll, dtype=object),
            "dig": np.asarray(dig, dtype=object),
            "bm": np.asarray(bm, dtype=object),
            "sp": np.asarray(sp)}


def load_states(side, eng, base, states):
    sc, dt, tc, creator, _mut = MODS[side]
    DT = dt.DataType
    schema = sc.Schema.build(
        name="states",
        dimensions=[("skey", DT.INT), ("hll", DT.BYTES), ("dig", DT.BYTES),
                    ("bm", DT.BYTES), ("sp", DT.STRING)],
        primary_key_columns=["skey"])
    eng.add_segment("states", creator.build_segment(
        schema, states, str(base / "states"),
        tc.TableConfig(table_name="states", is_dim_table=True), "states0"))
    eng.table("states").is_dim_table = True
    return eng


def build(tmp_path_factory, tag, consuming):
    rng = np.random.default_rng(29)
    fact, parts, custs = make_data(rng)
    states = states_data(rng)
    out = {}
    for name, side, gate in (("ref", "ref", None),
                             *(("port_" + g, "port", v)
                               for g, v in GATES.items())):
        base = tmp_path_factory.mktemp(f"{tag}{name}")
        eng = load(side, new_engine(side, gate), base, fact, parts, custs,
                   consuming)
        out[name] = load_states(side, eng, base, states)
    return out


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    return build(tmp_path_factory, "s2s", False)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return build(tmp_path_factory, "s2m", True)


JOIN = "FROM orders o JOIN parts p ON o.partkey = p.pkey"
STATES = ("FROM orders o JOIN states s ON o.partkey = s.skey "
          "JOIN parts p ON o.partkey = p.pkey")

# (aggregation, FROM clause): every name of the reference's _SPECS its
# stage 2 answers over single-value arguments
AGGS = {
    # the forms PR 15 ran, beside the rest
    "torch_forms": ("COUNT(*), SUM(o.qty), AVG(o.price), MIN(o.qty), "
                    "MAX(o.price), MINMAXRANGE(o.qty), DISTINCTCOUNT(p.brand)",
                    JOIN),
    "percentile": ("PERCENTILE(o.qty, 50)", JOIN),
    "percentileest": ("PERCENTILEEST(o.price, 90)", JOIN),
    "percentiletdigest": ("PERCENTILETDIGEST(o.price, 50)", JOIN),
    "percentilesmarttdigest": ("PERCENTILESMARTTDIGEST(o.qty * 2, 75)",
                               JOIN),
    "percentilerawest": ("PERCENTILERAWEST(o.qty, 50)", JOIN),
    "percentilerawtdigest": ("PERCENTILERAWTDIGEST(o.price, 25)", JOIN),
    "theta": ("DISTINCTCOUNTTHETASKETCH(o.custkey)", JOIN),
    "theta_build_side": ("DISTINCTCOUNTTHETASKETCH(p.brand)", JOIN),
    "rawtheta": ("DISTINCTCOUNTRAWTHETASKETCH(o.custkey)", JOIN),
    "theta_set_form": (
        # the reference's stage 1 reads only the columns the query names
        # outside its literals: the filters read the argument column
        "DISTINCTCOUNTTHETASKETCH(o.custkey, 'nominalEntries=4096', "
        "'o.custkey > 5', 'o.custkey <> 17', 'SET_INTERSECT($1,$2)')",
        JOIN),
    "mode": ("MODE(o.qty)", JOIN),
    "mode_expression": ("MODE(o.qty + p.pkey)", JOIN),
    "firstwithtime": ("FIRSTWITHTIME(o.price, o.qty, 'DOUBLE')", JOIN),
    "lastwithtime_string": ("LASTWITHTIME(p.brand, o.custkey, 'STRING')",
                            JOIN),
    "lastwithtime_int": ("LASTWITHTIME(o.custkey, o.qty, 'INT')", JOIN),
    "sumprecision": ("SUMPRECISION(o.qty)", JOIN),
    "sumprecision_fractions": ("SUMPRECISION(o.price)", JOIN),
    "idset": ("IDSET(o.custkey)", JOIN),
    "idset_string": ("IDSET(p.brand)", JOIN),
    "rawhll": ("DISTINCTCOUNTRAWHLL(o.custkey)", JOIN),
    "smarthll": ("DISTINCTCOUNTSMARTHLL(p.brand)", JOIN),
    "fasthll": ("FASTHLL(o.custkey)", JOIN),
    "distinctcountbitmap": ("DISTINCTCOUNTBITMAP(o.status)", JOIN),
    "segmentpartitioneddistinctcount": (
        "SEGMENTPARTITIONEDDISTINCTCOUNT(o.custkey)", JOIN),
    "distinctcounthll": ("DISTINCTCOUNTHLL(p.brand)", JOIN),
    "hllmerge": (f"HLLMERGE(s.hll, {LOG2M})", STATES),
    "tdigestmerge": ("TDIGESTMERGE(s.dig, 50)", STATES),
    "bitmapmerge": ("BITMAPMERGE(s.bm)", STATES),
    "sumprecisionmerge": ("SUMPRECISIONMERGE(s.sp)", STATES),
    "stunion": ("STUNION(ST_POINT(o.qty, p.pkey))", JOIN),
    "st_union": ("ST_UNION(ST_POINT(o.price, o.qty))", JOIN),
}


def gunzip_idsets(resp: dict) -> dict:
    """IDSET's blobs after gunzip: gzip stamps the second it ran."""
    import base64
    import gzip

    rows = resp.get("resultTable", {}).get("rows")
    if rows:
        resp["resultTable"]["rows"] = [
            [gzip.decompress(base64.b64decode(v)).decode()
             if isinstance(v, str) and v.startswith("H4sI") else v
             for v in r] for r in rows]
    return resp


def run(engs, sql, strategies=("broadcast", "shuffle")):
    for strat in strategies:
        full = f"{NO_ADVISOR}SET joinStrategy='{strat}'; {sql}"
        want = gunzip_idsets(engs["ref"].execute(full))
        for gname in GATES:
            same(gunzip_idsets(engs["port_" + gname].execute(full)), want)


@pytest.mark.parametrize("name", list(AGGS))
def test_grouped(sealed, name):
    agg, frm = AGGS[name]
    run(sealed, f"SELECT p.category, {agg} {frm} WHERE o.qty > 3 "
                f"GROUP BY p.category ORDER BY p.category")


@pytest.mark.parametrize("name", list(AGGS))
def test_scalar(sealed, name):
    agg, frm = AGGS[name]
    run(sealed, f"SELECT {agg} {frm} WHERE o.status <> 'void'",
        strategies=("broadcast",))


@pytest.mark.parametrize("name", list(AGGS))
def test_sealed_plus_consuming(mixed, name):
    agg, frm = AGGS[name]
    run(mixed, f"SELECT p.brand, {agg} {frm} GROUP BY p.brand "
               f"ORDER BY p.brand LIMIT 6", strategies=("shuffle",))


def test_several_sketches_one_query(sealed):
    """Digests, sketches and the torch forms in one stage 2, by a key
    over both tables."""
    run(sealed, "SELECT p.category, o.status, COUNT(*), "
                "PERCENTILETDIGEST(o.price, 90), MODE(o.custkey), "
                "DISTINCTCOUNTTHETASKETCH(p.brand), SUMPRECISION(o.qty), "
                "AVG(o.price) " + JOIN + " GROUP BY p.category, o.status "
                "ORDER BY p.category, o.status LIMIT 40")


def test_no_joined_rows(sealed):
    run(sealed, "SELECT PERCENTILE(o.qty, 50), MODE(o.qty), "
                "DISTINCTCOUNTRAWHLL(o.custkey), SUMPRECISION(o.qty) "
                + JOIN + " WHERE p.category = 'nope'")


def test_digest_reaches_k5(sealed, monkeypatch):
    """The joined rows' digests are K5's first joined-row inputs: its
    wrapper sees the rows' sorted values and the cluster offsets."""
    from pinot_tpu_torch.ops import kernels

    calls = []
    real = kernels.cluster_sums

    def spy(values, offsets):
        calls.append((int(values.numel()), int(offsets.numel())))
        return real(values, offsets)

    monkeypatch.setattr(kernels, "cluster_sums", spy)
    sealed["port_gate"].execute(
        NO_ADVISOR + "SELECT p.category, PERCENTILETDIGEST(o.price, 50) "
        + JOIN + " GROUP BY p.category")
    assert len(calls) == 1 and calls[0][0] > 1000


def test_host_failure_refused_in_band(sealed):
    """Where the reference's host fails on the values (MODE over strings),
    the port fails with the same message."""
    sql = NO_ADVISOR + "SELECT MODE(p.brand) " + JOIN
    want = sealed["ref"].execute(sql)["exceptions"]
    got = sealed["port_gate"].execute(sql)["exceptions"]
    assert want and got and got[0]["message"] == want[0]["message"]
