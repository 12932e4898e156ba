"""The port's server (pinot_tpu_torch/server) replayed against the
reference's tests on the CPU: test_faults.py and test_concurrency.py,
through the harness of test_torch_cluster.py.
"""

import pytest

from test_torch_cluster import _as_port, fails_as_listed, replay  # noqa: F401

# replayed cases that a later item or a named divergence keeps from
# passing: "file::Class::case" → (why, the text of its failure on the port)
NOT_REPLAYED: dict = {
    "test_faults::TestDeviceErrorRecovery::"
    "test_fetch_failure_falls_back_to_host": (
        "queue 3, device-error recovery without its host steps: a failed "
        "fetch is refused in-band, where the reference answers on its host",
        "DeviceUnsupported: device fetch failed"),
    "test_faults::TestDeviceErrorRecovery::"
    "test_quarantine_routes_poisoned_template_to_host": (
        "queue 3, device-error recovery without its host steps: a "
        "quarantined pipeline is refused in-band, where the reference "
        "answers on its host",
        "pipeline quarantined"),
    "test_concurrency::TestAbandonedLaunchRelease::"
    "test_host_partial_failure_releases_pin": (
        "queue 3, one engine: the port has no host-only engine "
        "(``QueryEngine.host``) for the case to break",
        "has no attribute 'host'"),
}

replay(globals(), "test_faults", NOT_REPLAYED)
replay(globals(), "test_concurrency", NOT_REPLAYED)


@pytest.mark.parametrize("case", sorted(NOT_REPLAYED))
def test_not_replayed_case_fails_as_listed(case, request):
    fails_as_listed(case, NOT_REPLAYED[case][1], request)
