"""The port's broker (pinot_tpu_torch/broker) replayed against the
reference's tests on the CPU: test_broker_pruning.py, test_quota.py,
test_overload.py, test_scheduler_priority.py, test_scheduler_trim.py and
test_tls.py, through the harness of test_torch_cluster.py.
"""

import time

import pytest

from test_torch_cluster import _as_port, fails_as_listed, replay  # noqa: F401

# replayed cases that a later item or a named divergence keeps from
# passing: "file::Class::case" → (why, the text of its failure on the port)
NOT_REPLAYED: dict = {
    f"test_overload::TestAutoscaler::{case}": (
        "ROADMAP m3: controller/autoscaler.py; Controller.attach_autoscaler "
        "refuses, naming m3",
        "the controller's autoscaler is ROADMAP item m3")
    for case in ("test_scale_out_and_drain_cycle",
                 "test_never_exceeds_bounds_and_sustain_required",
                 "test_stale_heartbeats_do_not_count_as_capacity")
}

replay(globals(), "test_broker_pruning", NOT_REPLAYED)
replay(globals(), "test_quota", NOT_REPLAYED)
replay(globals(), "test_overload", NOT_REPLAYED)
replay(globals(), "test_scheduler_priority", NOT_REPLAYED)
replay(globals(), "test_scheduler_trim", NOT_REPLAYED)
replay(globals(), "test_tls", NOT_REPLAYED)


@pytest.mark.parametrize("case", sorted(NOT_REPLAYED))
def test_not_replayed_case_fails_as_listed(case, request):
    fails_as_listed(case, NOT_REPLAYED[case][1], request)


# ---------------------------------------------------------------------------
# the refusals that name ROADMAP item m3
# ---------------------------------------------------------------------------


@pytest.fixture()
def port_cluster(tmp_path):
    """A registry, a controller, two servers and a broker of the port on
    the CPU, with a fact table ``f`` and a table ``d`` to join to it."""
    import numpy as np

    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.storage.creator import build_segment

    registry = ClusterRegistry()
    controller = Controller(registry, str(tmp_path / "deep"))
    servers = [ServerInstance(f"s{i}", registry, str(tmp_path / f"srv{i}"),
                              device="cpu") for i in range(2)]
    for s in servers:
        s.start()
    broker = Broker(registry, device="cpu")
    rng = np.random.default_rng(5)
    for name, dims, mets, cols in (
            ("f", [("k", DataType.INT)], [("v", DataType.INT)],
             {"k": rng.integers(0, 20, 400).astype(np.int32),
              "v": rng.integers(0, 9, 400).astype(np.int32)}),
            ("d", [("k", DataType.INT), ("name", DataType.STRING)], [],
             {"k": np.arange(20, dtype=np.int32),
              "name": np.array([f"n{i % 4}" for i in range(20)])})):
        schema = Schema.build(name=name, dimensions=dims, metrics=mets)
        cfg = TableConfig(table_name=name)
        controller.add_table(cfg, schema)
        build_segment(schema, cols, str(tmp_path / name), cfg, f"{name}0")
        controller.upload_segment(name, str(tmp_path / name))
    deadline = time.time() + 20
    while time.time() < deadline and not all(
            registry.external_view(f"{t}_OFFLINE") for t in ("f", "d")):
        time.sleep(0.05)
    yield registry, controller, servers, broker
    broker.close()
    for s in servers:
        s.stop(drain_timeout_s=0)


JOIN = ("SELECT d.name, SUM(f.v) FROM f JOIN d ON f.k = d.k "
        "GROUP BY d.name ORDER BY d.name")


def test_distributed_exchange_is_refused_naming_m3(port_cluster):
    _registry, _controller, _servers, broker = port_cluster
    local = broker.execute(JOIN)
    assert not local["exceptions"], local
    assert len(local["resultTable"]["rows"]) == 4
    r = broker.execute("SET joinStrategy = 'distributed'; " + JOIN)
    assert "resultTable" not in r
    assert [e["errorCode"] for e in r["exceptions"]] == [200]
    assert "ROADMAP item m3" in r["exceptions"][0]["message"]


def test_server_exchange_handlers_refuse_naming_m3(port_cluster):
    import json

    from pinot_tpu_torch.engine.datatable import ServerQueryError, decode

    _registry, _controller, servers, _broker = port_cluster
    ack = json.loads(servers[0]._handle_exchange_transfer(b"{}"))
    assert ack["ok"] is False and "ROADMAP item m3" in ack["error"]
    with pytest.raises(ServerQueryError, match="ROADMAP item m3"):
        decode(servers[0]._handle_execute_stage(b"{}"))


def test_tiered_lifecycle_is_refused_naming_m3(tmp_path):
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.server.server import ServerInstance

    with pytest.raises(ValueError, match="ROADMAP item m3"):
        ServerInstance("s", ClusterRegistry(), str(tmp_path), device="cpu",
                       tier_overrides={"pinot.server.tier.enabled": True})


def test_minion_task_generation_is_refused_naming_m3(tmp_path):
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.controller.controller import Controller

    ctl = Controller(ClusterRegistry(), str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP item m3"):
        ctl.run_task_generation()
