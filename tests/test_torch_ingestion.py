"""The port's ingestion jobs (ingestion/job.py, readers.py, uploader.py),
the quickstart, the record transforms and the plugin tail against the
reference's, on the CPU: tests/test_ingestion.py,
test_record_transform.py and test_plugin_tail.py replayed through the
harness of test_torch_cluster.py.
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
# replayed cases that run as a twin instead: "file::Class::case" → why
TWINNED = {
    "test_plugin_tail::test_sqlalchemy_dialect_with_fake_sa": (
        "the dialect registers its own module path, which names the "
        "port's package (pinot_tpu_torch.client.sqlalchemy_dialect); "
        "tests/test_torch_client.py test_sqlalchemy_dialect_names_the_port "
        "runs the case's fake SQLAlchemy against it"),
}

replay(globals(), "test_ingestion", NOT_REPLAYED)
replay(globals(), "test_record_transform", NOT_REPLAYED)
replay(globals(), "test_plugin_tail", {**NOT_REPLAYED, **TWINNED})


