"""The port's controller and registry (pinot_tpu_torch/controller,
cluster) replayed against the reference's tests on the CPU:
test_controller_ha.py, test_controller_longtail.py, test_streaming.py and
test_peer_download.py, through the harness of test_torch_cluster.py.
"""

import pytest

from test_torch_cluster import _as_port, fails_as_listed, replay  # noqa: F401

# replayed cases that a later item or a named divergence keeps from
# passing: "file::Class::case" → (why, the text of its failure on the port)
NOT_REPLAYED: dict = {
    "test_controller_longtail::TestRecommender::"
    "test_workload_driven_recommendation": (
        "ROADMAP m3: controller/advisor.py recommend_config",
        "the controller's config advisor is ROADMAP item m3"),
    "test_controller_longtail::TestRecommender::"
    "test_unparsable_queries_skipped": (
        "ROADMAP m3: controller/advisor.py recommend_config",
        "the controller's config advisor is ROADMAP item m3"),
    "test_controller_longtail::TestTuner::"
    "test_tuner_grows_config_from_segment_stats": (
        "ROADMAP m3: controller/advisor.py tune_table",
        "the controller's table tuner is ROADMAP item m3"),
}

replay(globals(), "test_controller_ha", NOT_REPLAYED)
replay(globals(), "test_controller_longtail", NOT_REPLAYED)
replay(globals(), "test_streaming", NOT_REPLAYED)
replay(globals(), "test_peer_download", NOT_REPLAYED)


@pytest.mark.parametrize("case", sorted(NOT_REPLAYED))
def test_not_replayed_case_fails_as_listed(case, request):
    fails_as_listed(case, NOT_REPLAYED[case][1], request)
