"""The port's broker fleet (broker/fleet.py) and the OS-process cluster
against the reference's, on the CPU: tests/test_fleet.py and
test_multiprocess.py replayed through the harness of
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
NOT_REPLAYED: dict = {}
# replayed cases that run as a twin instead: "file::Class::case" → why
TWINNED = {
    "test_multiprocess::test_multiprocess_cluster_end_to_end": (
        "spawns ``python -m pinot_tpu.tools.admin``: a child process does "
        "not see the harness's swap, so it would run the reference's CLI; "
        "test_port_multiprocess_cluster runs the case against the port's "
        "CLI, its server and broker processes with ``--device cpu``"),
}

replay(globals(), "test_fleet", NOT_REPLAYED)
replay(globals(), "test_multiprocess", {**NOT_REPLAYED, **TWINNED})




def test_port_multiprocess_cluster(tmp_path):
    """test_multiprocess.py's OS-process cluster through the port's CLI:
    a ``start-server`` and a ``start-broker`` process (``--device cpu``)
    and the ``add-table`` / ``ingest`` commands, over one FileRegistry,
    queried over HTTP."""
    import pathlib

    src = (pathlib.Path(__file__).parent / "test_multiprocess.py").read_text()
    spawn = '[sys.executable, "-m", "pinot_tpu.tools.admin", *args]'
    assert src.count(spawn) == 1
    src = src.replace(spawn, '[sys.executable, "-m", '
                             '"pinot_tpu_torch.tools.admin", *args, '
                             '"--device", "cpu"]')
    assert src.count('"pinot_tpu.tools.admin"') == 2
    src = src.replace('"pinot_tpu.tools.admin"',
                      '"pinot_tpu_torch.tools.admin"')
    ns = {"__name__": "_port_multiprocess"}
    exec(compile(src, "test_multiprocess.py", "exec"), ns)
    ns["test_multiprocess_cluster_end_to_end"](tmp_path)
