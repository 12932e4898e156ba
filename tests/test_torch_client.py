"""The port's DB-API client (client/) and its SQLAlchemy dialect against
the reference's, on the CPU: tests/test_client.py replayed through the
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

replay(globals(), "test_client", NOT_REPLAYED)




def test_sqlalchemy_dialect_names_the_port(tmp_path, monkeypatch):
    """test_plugin_tail.py's dialect case over its fake SQLAlchemy, the
    registered module path being the port's: the dialect registers its
    own module, pinot_tpu_torch.client.sqlalchemy_dialect."""
    import inspect

    from test_torch_cluster import load_replay

    mod = load_replay("test_plugin_tail")
    src = inspect.getsource(mod.test_sqlalchemy_dialect_with_fake_sa)
    ref_path = '"pinot_tpu.client.sqlalchemy_dialect", "dialect"'
    assert src.count(ref_path) == 1
    src = src.replace(ref_path,
                      '"pinot_tpu_torch.client.sqlalchemy_dialect", "dialect"')
    ns = dict(vars(mod))
    exec(compile(src, mod.__file__, "exec"), ns)
    ns["test_sqlalchemy_dialect_with_fake_sa"](tmp_path, monkeypatch)
