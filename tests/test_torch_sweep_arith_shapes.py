"""tests/test_torch_sweep_arith.py's functions at their edge values,
outside the aggregations' operands: as a WHERE predicate (in the device
shape and under the host path's ``$docId < 1800``), as a group key, as a
selected column and as a CASE branch under MIN, MAX and SUM; and a
smaller cross of the same functions in stage 2 of a join over
tests/test_torch_host_float64.py's star (``fact JOIN dim``), whose keys
hold a zero and whose DOUBLE ``f`` in [0, 9) makes NaN under
``SQRT(fa.f - 5)``. Its data, tiers, gates and oracle are that file's;
stage 2's are the star's own engines: the reference, its host-only engine
and the port at both gates.
"""

import pytest

import test_torch_host_float64 as hf
import test_torch_sweep as sw
import test_torch_sweep_arith as sa
from pinot_tpu.engine.engine import QueryEngine as RefEngine
from test_torch_host_float64 import dirs  # noqa: F401 — the segments
from test_torch_sweep import engines  # noqa: F401 — the tiers' engines
from test_torch_sweep_strings import one_thread  # noqa: F401 — one thread

EXPRESSIONS = sa.EXPRESSIONS
WHERE = {"device": "{x} <= 0", "docid": "$docId < 1800 AND {x} <= 0"}


@pytest.mark.parametrize("shape", list(WHERE))
@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_where(engines, expr, shape):  # noqa: F811
    p = WHERE[shape].format(x=EXPRESSIONS[expr])
    sw.check(engines, f"SELECT COUNT(*), MAX(i) FROM t WHERE {p}",
             [True, True])


@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_group_key(engines, expr):  # noqa: F811
    x = EXPRESSIONS[expr]
    sw.check(engines, f"SELECT {x}, COUNT(*), MIN(i) FROM t GROUP BY {x} "
             f"ORDER BY {x} LIMIT 30", [True, True])


@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_selected_column(engines, expr):  # noqa: F811
    x = EXPRESSIONS[expr]
    sw.check(engines, f"SELECT {x}, fl, i FROM t WHERE k = 3 ORDER BY i, fl "
             f"LIMIT 30", [True, True])


@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_case_branch(engines, expr):  # noqa: F811
    case = f"CASE WHEN k > 4 THEN {EXPRESSIONS[expr]} ELSE 0 END"
    sw.check(engines, f"SELECT MIN({case}), MAX({case}), SUM({case}) "
             f"FROM t", [True, True, False])


# ---------------------------------------------------------------------------
# stage 2: the functions over the joined rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def star_engines(tmp_path_factory):
    """(reference, reference host-only, [port at each gate], "star")."""
    base = tmp_path_factory.mktemp("sweep_arith_star")
    out = []
    for side, eng in (("ref", hf._engine("ref")),
                      ("ref", RefEngine(device_executor=None)),
                      ("port", hf._engine("port", None)),
                      ("port", hf._engine("port", 0))):
        _sc, _dt, tc, creator = hf.MODS[side][:4]
        (fs, fcols), (ds, dcols) = hf._star(side)
        tag = f"{side}{len(out)}"
        half = hf.N_FACT // 2
        for j, sl in enumerate((slice(0, half), slice(half, hf.N_FACT))):
            eng.add_segment("fact", creator.build_segment(
                fs, {c: v[sl] for c, v in fcols.items()},
                str(base / f"{tag}f{j}"),
                tc.TableConfig(table_name="fact", indexing=tc.IndexingConfig(
                    no_dictionary_columns=["big", "f"])), f"f{j}"))
        eng.add_segment("dim", creator.build_segment(
            ds, dcols, str(base / f"{tag}d"),
            tc.TableConfig(table_name="dim", is_dim_table=True), "d0"))
        eng.table("dim").is_dim_table = True
        out.append(eng)
    return out[0], out[1], out[2:], "star"


STAGE2 = {
    "mod_key": "MOD(fa.i, fa.key)",
    "mod_long_key": "MOD(fa.big, fa.key)",
    "cast_int_past": "CAST(fa.f * 1e9 AS INT)",
    "cast_int_nan": "CAST(SQRT(fa.f - 5) AS INT)",
    "cast_long_past": "CAST(fa.f * 1e30 AS LONG)",
    "sign_nan": "SIGN(SQRT(fa.f - 5))",
    "sign_neg_zero": "1 / SIGN(-0.0 * fa.f)",
    "abs_neg_zero": "1 / ABS(-0.0 * fa.f)",
    "floor_neg_zero": "1 / FLOOR(-0.0 * fa.f)",
    "least_zeros": "1 / LEAST(-0.0 * fa.f, 0.0 * fa.f)",
    "greatest_nan": "GREATEST(SQRT(fa.f - 5), fa.f)",
    "divide_key": "fa.i / fa.key",
    "power_key": "POWER(fa.key, 2)",
}
STAGE2_SQL = ("SET useAdvisor=false; SELECT dm.name, MIN({x}), MAX({x}), "
              "SUM({x}) FROM fact fa JOIN dim dm ON fa.key = dm.key "
              "GROUP BY dm.name ORDER BY dm.name")


@pytest.mark.parametrize("expr", list(STAGE2))
def test_stage2(star_engines, expr):
    sw.check(star_engines, STAGE2_SQL.format(x=STAGE2[expr]),
             [True, True, False])


def test_stage2_quoted_example(star_engines):
    """F16 in stage 2 as first found: NaN for every name on the
    reference, 1.0 on the port."""
    want = sw.check(star_engines, "SET useAdvisor=false; SELECT dm.name, "
                    "MAX(SIGN(SQRT(fa.f - 5))) FROM fact fa JOIN dim dm ON "
                    "fa.key = dm.key GROUP BY dm.name ORDER BY dm.name",
                    [True])
    assert all(r[1] != r[1] for r in want["resultTable"]["rows"])


def test_stage2_negative_integer_power_is_refused(star_engines):
    """D1 in stage 2: the reference's stage 2 and the port's refuse it
    with numpy's message."""
    sql = ("SET useAdvisor=false; SELECT dm.name, MAX(POWER(fa.key, -1)) "
           "FROM fact fa JOIN dim dm ON fa.key = dm.key GROUP BY dm.name")
    ref, _host, ports, _ = star_engines
    assert sa.NEGATIVE_POWER in sw._message(ref.execute(sql))
    for port in ports:
        assert sa.NEGATIVE_POWER in sw._message(port.execute(sql))
