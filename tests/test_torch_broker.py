"""The port's broker (pinot_tpu_torch/broker) replayed against the
reference's tests on the CPU: test_broker_pruning.py, test_quota.py,
test_overload.py, test_scheduler_priority.py, test_scheduler_trim.py and
test_tls.py, through the harness of test_torch_cluster.py.
"""

from test_torch_cluster import _as_port, replay  # noqa: F401

# replayed cases that a named divergence keeps from passing:
# "file::Class::case" → (why, the text of its failure on the port); none
NOT_REPLAYED: dict = {}

replay(globals(), "test_broker_pruning", NOT_REPLAYED)
replay(globals(), "test_quota", NOT_REPLAYED)
replay(globals(), "test_overload", NOT_REPLAYED)
replay(globals(), "test_scheduler_priority", NOT_REPLAYED)
replay(globals(), "test_scheduler_trim", NOT_REPLAYED)
replay(globals(), "test_tls", NOT_REPLAYED)
