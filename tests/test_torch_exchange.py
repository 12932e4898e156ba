"""The distributed stage-2 exchange of the port (query2/exchange.py,
ops/join.py ``stable_hash64`` / ``hash_partition_rows``, query2/runner.py
``run_exchange_stage``, the servers' ExecuteStage / ExchangeTransfer and
the broker's distributed path) against the reference's, on the CPU:
tests/test_exchange.py replayed through the harness of
test_torch_cluster.py, and differential tests of the hash, the wire codec
and a distributed join through both packages' clusters.
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
NOT_REPLAYED: dict = {}

replay(globals(), "test_exchange", NOT_REPLAYED)
