"""The port's tiered segment lifecycle (server/tiering.py: TierManager,
LazySegmentView, ColdSegmentRef, segment_plan_bytes; the executor's
``evict_segment_dir``; cold segments as in-flight partials in the engine
and the multi-stage runner) against the reference's, on the CPU:
tests/test_tiering.py replayed through the harness of
test_torch_cluster.py, and differential tests of its own.
"""

import pytest

from test_torch_cluster import (  # noqa: F401
    _as_port,
    fails_as_listed,
    load_replay,
    port_swap,
    replay,
)


@pytest.fixture(scope="module", autouse=True)
def _as_port_module():
    """The swap around the whole module: the reference file's
    module-scoped fixtures set up before the function-scoped ``_as_port``
    and must build the port's objects."""
    with port_swap():
        yield


# replayed cases that a named divergence keeps from passing:
# "file::Class::case" → (why, the text of its failure on the port)
NOT_REPLAYED: dict = {
    "test_tiering::TestColdLifecycle::"
    "test_tick_policy_hot_admission_and_cold_idle": (
        "one engine (ROADMAP queue 3): the reference's fixture server has "
        "no device executor, so its hot budget is 0 and the hottest "
        "segment serves warm; the port's server has the card's budget "
        "(MAX_CACHED_BYTES) and admits it hot. "
        "test_tick_policy_with_no_hot_budget runs the case at budget 0",
        "snap[names[0]] == Tier.WARM"),
}

replay(globals(), "test_tiering", NOT_REPLAYED)

# a replayed case's parameter that a named divergence keeps from passing,
# held out of its parametrization (the other parameters replay under
# their own ids): (class, case, parameter) → (why, the text of its
# failure on the port)
HELD_PARAMS = {
    ("TestTierParity", "test_hot_equals_warm_equals_host",
     "SELECT mid, COUNT(*), SUM(f) FROM tiers WHERE tag = 'c' GROUP BY mid "
     "ORDER BY mid LIMIT 10"): (
        "one engine (ROADMAP queue 3): the reference's host-only engine "
        "(device_executor=None) is the port's one engine, which answers "
        "the hot segments in the device shape, where a SUM over a DOUBLE "
        "column reads the float32 planes as the reference's device does; "
        "the warm segments answer in the host path's shape in float64, as "
        "the reference's host does (ROADMAP F4). tests/test_torch_host_"
        "float64.py test_tier_parity_warm_equals_the_reference_host holds "
        "the port's warm answers to the reference's host-only engine's "
        "bit for bit",
        'assert rw["resultTable"]["rows"] == ro["resultTable"]["rows"]'),
}
_parity = TestTierParity.test_hot_equals_warm_equals_host  # noqa: F821
_PARITY_HELD = next(iter(HELD_PARAMS))[2]


class TestTierParity(TestTierParity):  # noqa: F821 — the replayed class
    @pytest.mark.parametrize("sql", [
        q for q in load_replay("test_tiering").PARITY_QUERIES
        if q != _PARITY_HELD])
    def test_hot_equals_warm_equals_host(self, table, sql):
        _parity(self, table, sql)


def test_held_parameter_fails_as_listed(table):
    """The held parameter fails on the port as its listing says: the warm
    answer (float64) is not the one engine's hot answer (float32)."""
    import inspect

    with pytest.raises(AssertionError) as err:
        _parity(TestTierParity(), table, _PARITY_HELD)
    (_why, expect), = HELD_PARAMS.values()
    frame = err.tb
    while frame.tb_next is not None:
        frame = frame.tb_next
    line = inspect.getsource(frame.tb_frame.f_code).splitlines()[
        frame.tb_lineno - frame.tb_frame.f_code.co_firstlineno]
    assert expect in line, (line, err.value)


def _tick_case(tmp_path, hot_budget=None):
    """test_tiering.py's tick-policy case on the port, through its class
    fixture, with the server's hot budget set where given."""
    from test_torch_cluster import load_replay, port_swap

    mod = load_replay("test_tiering")
    case = mod.TestColdLifecycle()
    with port_swap():
        gen = case.cluster.__wrapped__(case, tmp_path)
        cluster = next(gen)
        try:
            if hot_budget is not None:
                cluster[2].tiers.hot_budget_bytes = hot_budget
            case.test_tick_policy_hot_admission_and_cold_idle(
                cluster, tmp_path)
        finally:
            next(gen, None)
    return cluster[2]


def test_not_replayed_case_fails_as_listed(tmp_path):
    """The listed case fails on the port as its listing says: at the
    card's default budget the hottest segment is admitted hot."""
    import inspect

    with pytest.raises(AssertionError) as err:
        _tick_case(tmp_path)
    (_why, expect), = NOT_REPLAYED.values()
    frame = err.tb
    while frame.tb_next is not None:
        frame = frame.tb_next
    line = inspect.getsource(frame.tb_frame.f_code).splitlines()[
        frame.tb_lineno - frame.tb_frame.f_code.co_firstlineno]
    assert expect in line, (line, err.value)


def test_tick_policy_with_no_hot_budget(tmp_path):
    """The listed case with the hot budget at 0, the reference's
    device-less server's: the hottest segment serves warm, the
    hour-stale one goes cold, the recent one stays warm."""
    server = _tick_case(tmp_path, hot_budget=0)
    assert server.tiers.demotions_cold == 1
