"""The port stands alone: it imports torch, never jax, and nothing of the
JAX package; its entry points never drop to the CPU on their own.

Note the name trap: ``"pinot_tpu_torch".startswith("pinot_tpu")`` is true,
so every check here tests ``name == "pinot_tpu" or
name.startswith("pinot_tpu.")``.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import pinot_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pinot_tpu_torch")


def _forbidden(name: str) -> bool:
    return name in ("jax", "jaxlib", "pinot_tpu") or name.startswith(
        ("jax.", "jaxlib.", "pinot_tpu."))


# the cluster tier's modules that need no cluster, with the broker
# package's query-log key
CLUSTER_TIER_MODULES = [
    "pinot_tpu_torch.broker.querylog",
    "pinot_tpu_torch.common.auth",
    "pinot_tpu_torch.common.config",
    "pinot_tpu_torch.common.environment",
    "pinot_tpu_torch.common.faults",
    "pinot_tpu_torch.common.plugins",
    "pinot_tpu_torch.common.tls",
    "pinot_tpu_torch.engine.advisor",
    "pinot_tpu_torch.engine.scheduler",
    "pinot_tpu_torch.ingestion.avro_io",
    "pinot_tpu_torch.ingestion.confluent_avro",
    "pinot_tpu_torch.ingestion.protobuf_io",
    "pinot_tpu_torch.ingestion.thrift_io",
    "pinot_tpu_torch.storage.adlsfs",
    "pinot_tpu_torch.storage.fs",
    "pinot_tpu_torch.storage.gcsfs",
    "pinot_tpu_torch.storage.hdfsfs",
    "pinot_tpu_torch.storage.s3fs",
    "pinot_tpu_torch.stream.kafka_stream",
    "pinot_tpu_torch.stream.kinesis_stream",
    "pinot_tpu_torch.stream.pulsar_stream",
]
# client libraries a deployment may lack (the card's machine has none)
CLIENTS = ("grpc", "cryptography", "kafka", "boto3", "botocore", "pulsar",
           "azure")


def _port_modules() -> list:
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="pinot_tpu_torch."))


def test_importing_every_port_module_loads_no_jax():
    modules = ["pinot_tpu_torch"] + _port_modules()
    assert "pinot_tpu_torch.engine.engine" in modules
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pinot_tpu_torch.ops.kernels" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    # the third-party clients load inside the functions that need them
    assert [m for m in loaded if m.split(".")[0] in CLIENTS
            or m.startswith("google.protobuf")] == []


@pytest.mark.parametrize("root", ["pinot_tpu_torch", "chip_smoke.py",
                                  "f13_card.py"])
def test_no_source_imports_jax_or_the_jax_package(root):
    path = os.path.join(ROOT, root)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(f, n) for n in names if _forbidden(n)]
    assert bad == []


def test_engine_without_cuda_raises(monkeypatch):
    from pinot_tpu_torch.engine.engine import QueryEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine()
    with pytest.raises(RuntimeError):
        pinot_tpu_torch.resolve_device(None)
    assert QueryEngine(device="cpu").device.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (this CPU box) and from a directory holding only the
    script, chip_smoke.py exits non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", CLUSTER_TIER_MODULES)
def test_cluster_tier_module_is_ported_with_lazy_clients(module):
    """Each module of the cluster tier that needs no cluster is the port's
    own copy of the reference's, and its module-level imports name no
    third-party client (those stay inside the functions that need them,
    as the reference keeps them)."""
    assert module in _port_modules()
    rel = module.split(".", 1)[1].replace(".", os.sep) + ".py"
    assert os.path.exists(os.path.join(ROOT, "pinot_tpu", rel))
    with open(os.path.join(PKG, rel)) as fh:
        tree = ast.parse(fh.read())
    top = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.append(node.module or "")
    assert [n for n in top if n.split(".")[0] in CLIENTS
            or n.startswith("google.") or _forbidden(n)] == []
