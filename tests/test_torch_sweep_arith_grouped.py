"""tests/test_torch_sweep_arith.py's functions at their edge values under
SUM, MIN, MAX, AVG and MINMAXRANGE grouped by ``k``: in the device shape
(K1 and K2 at gate 0, where the reference's kernel tier is the oracle if
its default answer parts from it) and under ``$docId < 1800`` (the host
path's shape, numpy's values). Its data, tiers, gates and oracle are
that file's.
"""

import pytest

import test_torch_sweep as sw
import test_torch_sweep_arith as sa
from test_torch_host_float64 import dirs  # noqa: F401 — the segments
from test_torch_sweep import engines  # noqa: F401 — the tiers' engines
from test_torch_sweep_arith import kernel_tier  # noqa: F401
from test_torch_sweep_strings import one_thread  # noqa: F401 — one thread

SHAPES = {"by_k": ("k", ""), "docid_by_k": ("k", "WHERE $docId < 1800")}
# the reference's device starts a grouped MAX at -inf, which a BOOLEAN
# value takes as True (pinot_tpu/ops/agg.py ``group_max``), so every
# group of False values has MAX 1 there; the port answers the values'
# MAX, as the reference's host does (ROADMAP queue 3, named divergences)
HOST_ORACLE = {("cast_bool_neg_zero", "by_k")}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("expr", list(sa.EXPRESSIONS))
def test_aggregation_operand(engines, kernel_tier, expr,
                             shape):  # noqa: F811
    sql = sw._select(sa.AGGS.format(x=sa.EXPRESSIONS[expr]), SHAPES[shape])
    if (expr, shape) in HOST_ORACLE:
        engines = (engines[1],) + engines[1:]
    sa.check(engines, sql, sa.AGG_EXACT, kernel_tier)
