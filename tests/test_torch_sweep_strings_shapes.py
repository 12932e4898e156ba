"""tests/test_torch_sweep_strings.py's comparisons of a STRING operand
with a string literal, every aggregation position of one comparison in
one query, in the shapes past the scalar one: grouped by ``k``, under the
host path's ``$docId < 1800`` and under a dict column's ``k = 3``. Each
of the six operators appears once, three with the literal on the right
and three on the left; the literal is the operand's last value or one
absent from its values. Its data, tiers, gates and oracle are that
file's.
"""

import pytest

import test_torch_sweep as sw
import test_torch_sweep_strings as ss
from test_torch_sweep_strings import (  # noqa: F401 — fixtures
    engines, one_thread, string_dirs)

# each operator once, the literal's side alternating
SHAPE_COMPARISONS = ("r=", "l<>", "r<", "l<=", "r>", "l>=")


@pytest.mark.parametrize("shape", [s for s in ss.SHAPES if s != "scalar"])
@pytest.mark.parametrize("cmp", SHAPE_COMPARISONS)
@pytest.mark.parametrize("role", ["last", "absent"])
@pytest.mark.parametrize("operand", list(ss.OPERANDS))
def test_every_position_in_each_shape(engines, operand, role, cmp,
                                      shape):  # noqa: F811
    c = ss.comparison(operand, cmp, role)
    aggs = [agg.format(c=c) for agg, _exact in ss.POSITIONS.values()]
    sw.check(engines, ss.select(aggs, shape),
             [exact for _agg, exact in ss.POSITIONS.values()])
