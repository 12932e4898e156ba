"""tests/test_torch_sweep_strings.py's comparisons of a STRING operand
with a string literal, outside the aggregations: the comparison itself as
a group key, a CASE with string results as a group key, a WHERE over a
CASE, HAVING on a CASE sum, and a selection's column with ORDER BY. Its
data, tiers, gates and oracle are that file's.
"""

import pytest

import test_torch_sweep as sw
import test_torch_sweep_strings as ss
from test_torch_sweep_strings import (  # noqa: F401 — fixtures
    engines, one_thread, string_dirs)

ROLES = ["first", "middle", "last", "absent"]
# each operator once, the literal's side alternating
SOME_COMPARISONS = ("r=", "l<>", "r<", "l<=", "r>", "l>=")


def check(engines, sql: str, exact: list) -> None:  # noqa: F811
    """``sw.check``, where the oracle may answer no row."""
    ref = engines[0]
    want = ref.execute(sql)
    if not want.get("exceptions") and not want["resultTable"]["rows"]:
        for port in engines[2]:
            got = port.execute(sql)
            assert not got.get("exceptions"), got["exceptions"]
            assert got["resultTable"] == want["resultTable"]
        return
    sw.check(engines, sql, exact)


@pytest.mark.parametrize("cmp", SOME_COMPARISONS)
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_comparison_as_a_group_key(engines, operand, role,
                                   cmp):  # noqa: F811
    c = ss.comparison(operand, cmp, role)
    check(engines, f"SELECT {c}, COUNT(*), SUM(i), MAX(k) FROM t GROUP BY "
          f"{c} ORDER BY {c}", [True, False, True])


@pytest.mark.parametrize("shape", ["docid", "k_eq_3"])
@pytest.mark.parametrize("role", ["last", "absent"])
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_group_key_in_a_filtered_shape(engines, operand, role,
                                       shape):  # noqa: F811
    """Two comparison keys beside ``k``, under a filter."""
    a = ss.comparison(operand, "r<", role)
    b = ss.comparison(operand, "l=", role)
    where = ss.SHAPES[shape][1]
    check(engines, f"SELECT {a}, {b}, k, COUNT(*), SUM(fl) FROM t {where} "
          f"GROUP BY {a}, {b}, k ORDER BY {a}, {b}, k", [True, False])


@pytest.mark.parametrize("shape", ["scalar", "docid", "k_eq_3"])
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_case_strings_as_a_group_key(engines, operand, role,
                                     shape):  # noqa: F811
    key = (f"CASE WHEN {ss.comparison(operand, 'r=', role)} THEN 'x' "
           f"WHEN {ss.comparison(operand, 'l>', role)} THEN 'z' "
           f"ELSE 'y' END")
    where = ss.SHAPES[shape][1]
    check(engines, f"SELECT {key}, COUNT(*), MIN(i) FROM t {where} "
          f"GROUP BY {key} ORDER BY {key}", [True, True])


@pytest.mark.parametrize("cmp", SOME_COMPARISONS)
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_where_over_a_case(engines, operand, role, cmp):  # noqa: F811
    c = ss.comparison(operand, cmp, role)
    check(engines, f"SELECT COUNT(*), SUM(i) FROM t WHERE CASE WHEN {c} "
          f"THEN i ELSE 0 END > 10", [True, False])


@pytest.mark.parametrize("cmp", ["r=", "l<"])
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_having_on_a_case_sum(engines, operand, role, cmp):  # noqa: F811
    c = ss.comparison(operand, cmp, role)
    s = f"SUM(CASE WHEN {c} THEN 1 ELSE 0 END)"
    check(engines, f"SELECT k, {s}, COUNT(*) FROM t GROUP BY k HAVING "
          f"{s} > 150 ORDER BY k", [False, True])


@pytest.mark.parametrize("cmp", ["r=", "l>="])
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_selection_ordered_by_a_comparison(engines, operand, role,
                                           cmp):  # noqa: F811
    c = ss.comparison(operand, cmp, role)
    check(engines, f"SELECT {c}, i, k FROM t ORDER BY {c} DESC, fl, i "
          f"LIMIT 25", [True, True])

