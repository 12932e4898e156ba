"""The port's tools (tools/compat.py, querylog.py, benchdiff.py,
clusterstat.py) against the reference's, on the CPU: tests/test_compat.py,
test_xray.py and test_subrtt.py replayed through the harness of
test_torch_cluster.py.
"""

import pytest

from test_torch_cluster import (  # noqa: F401
    _as_port,
    fails_as_listed,
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
    f"test_compat::TestCompatRunner::{case}": (
        "the reference's compat runner builds host-only servers; the "
        "port's runs its cluster on the card unless given a device "
        "(``run_suite_file(device=)``, ``--device``), and the CPU test "
        "machines have none. test_compat_on_cpu runs both cases with "
        "device 'cpu'",
        "no CUDA device available")
    for case in ("test_sample_suite_passes", "test_cli_exit_codes")
}
NOT_REPLAYED.update({
    "test_subrtt::TestDeviceReduceParity::test_sorted_regime_topk": (
        "reads the reference executor's compiled-pipeline map "
        "(``DeviceExecutor._pipelines``), which the port's eager executor "
        "does not keep; the sorted regime's top-k is held by "
        "tests/test_torch_sorted_regime.py",
        "'DeviceExecutor' object has no attribute '_pipelines'"),
    "test_subrtt::TestPartialsCache::test_hbm_stats_and_bytes": (
        "``hbm_stats()`` of the port has no ``device_reduce_ms`` (the "
        "reference times its on-device reduce on the host's clock; the "
        "port counts ``device_reduce_queries`` only); the partials cache's "
        "stats are held by tests/test_torch_partials.py",
        "device_reduce_ms"),
    "test_subrtt::TestStreamWindows::"
    "test_successor_buffers_until_predecessor_fetch": (
        "drives the reference coalescer's internals (its dispatch hook "
        "and member slots); the port's cohort windows are held by "
        "tests/test_torch_coalesce.py",
        "0"),
})

replay(globals(), "test_compat", NOT_REPLAYED)
replay(globals(), "test_xray", NOT_REPLAYED)
replay(globals(), "test_subrtt", NOT_REPLAYED)


@pytest.mark.parametrize("case", sorted(NOT_REPLAYED))
def test_not_replayed_case_fails_as_listed(case, request):
    fails_as_listed(case, NOT_REPLAYED[case][1], request)


def test_compat_on_cpu(tmp_path, capsys, monkeypatch):
    """The two listed compat cases, their cluster on the CPU."""
    import functools

    from test_torch_cluster import load_replay, port_swap

    from pinot_tpu_torch.tools import compat

    mod = load_replay("test_compat")
    on_cpu = functools.partial(compat.run_suite_file, device="cpu")
    monkeypatch.setattr(compat, "run_suite_file", on_cpu)
    monkeypatch.setattr(mod, "run_suite_file", on_cpu)
    monkeypatch.setattr(mod, "main",
                        lambda argv: compat.main(argv + ["--device", "cpu"]))
    case = mod.TestCompatRunner()
    with port_swap():
        case.test_sample_suite_passes()
        case.test_cli_exit_codes(tmp_path, capsys)
