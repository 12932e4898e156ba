"""The port's cluster observability (metrics, traces, the query log
through tools/querylog.py) against the reference's, on the CPU:
tests/test_observability.py replayed through the harness of
test_torch_cluster.py.
"""

import sys

import pytest

from test_torch_cluster import (  # noqa: F401
    _as_port,
    fails_as_listed,
    port_swap,
    replay,
)


@pytest.fixture(autouse=True)
def _fresh_plugin_module(monkeypatch):
    """TestPluginRegistry's case writes and imports a plugin module named
    ``my_plugin``; one that tests/test_observability.py imported earlier
    in this process is cached against the reference's registry, so each
    case imports its own."""
    monkeypatch.delitem(sys.modules, "my_plugin", raising=False)


@pytest.fixture(scope="module", autouse=True)
def _as_port_module():
    """The swap around the whole module: the reference file's
    module-scoped fixtures set up before the function-scoped ``_as_port``
    and must build the port's objects."""
    with port_swap():
        yield


# replayed cases that a named divergence keeps from passing:
# "file::Class::case" → (why, the text of its failure on the port)
NOT_REPLAYED: dict = {}
# replayed cases that run as a twin below instead: "file::Class::case" →
# why (their outcome through the harness depends on import order)
TWINNED = {
    "test_observability::TestPluginRegistry::"
    "test_unknown_plugin_raises_with_inventory": (
        "the replay harness imports every module of the port, the Kafka "
        "consumer among them, which registers the 'kafka' stream whether "
        "or not the registry has bootstrapped yet; "
        "test_unknown_plugin_raises_without_kafka runs the case with it "
        "taken out"),
}

replay(globals(), "test_observability", {**NOT_REPLAYED, **TWINNED})




def test_unknown_plugin_raises_without_kafka(monkeypatch):
    """The listed plugin case with the 'kafka' stream the harness's
    imports registered taken out of the registry."""
    from test_torch_cluster import load_replay, port_swap

    from pinot_tpu_torch.common.plugins import plugin_registry

    plugin_registry.available("stream")  # bootstrapped
    monkeypatch.delitem(plugin_registry._plugins, ("stream", "kafka"),
                        raising=False)
    case = load_replay("test_observability").TestPluginRegistry()
    with port_swap():
        case.test_unknown_plugin_raises_with_inventory()
