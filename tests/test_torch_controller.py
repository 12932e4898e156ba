"""The port's controller and registry (pinot_tpu_torch/controller,
cluster) replayed against the reference's tests on the CPU:
test_controller_ha.py, test_controller_longtail.py, test_streaming.py and
test_peer_download.py, through the harness of test_torch_cluster.py.
"""

from test_torch_cluster import _as_port, replay  # noqa: F401

# replayed cases that a named divergence keeps from passing:
# "file::Class::case" → (why, the text of its failure on the port); none
NOT_REPLAYED: dict = {}

replay(globals(), "test_controller_ha", NOT_REPLAYED)
replay(globals(), "test_controller_longtail", NOT_REPLAYED)
replay(globals(), "test_streaming", NOT_REPLAYED)
replay(globals(), "test_peer_download", NOT_REPLAYED)

