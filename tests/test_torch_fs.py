"""The port's deep-store filesystems (pinot_tpu_torch/storage/fs.py and
its S3, GCS, ADLS and HDFS back ends) against the JAX package's, on the
CPU.

Each client is injected as the reference's tests inject it (their fake
boto3, google-cloud-storage, azure-storage-blob and WebHDFS endpoints).
Replays: the reference's own S3 / GCS / ADLS / HDFS test cases run with
the JAX package's storage and plugin modules swapped for the port's, so
every class they import is the port's. Differential: one scripted
lifecycle (push, list, exists, pull, remote copy, re-push, delete, a
missing pull) through both packages' filesystems over the same fake store
gives the same observations and the same stored objects.
"""

import importlib
import inspect
import sys

import pytest

import test_adlsfs as tad
import test_gcsfs as tgc
import test_plugin_tail as tpt
import test_s3fs as ts3
from test_adlsfs import fake_azure  # noqa: F401 — fixtures
from test_gcsfs import fake_gcs  # noqa: F401
from test_s3fs import fake_boto3  # noqa: F401

PORTED = ("storage.fs", "storage.s3fs", "storage.gcsfs", "storage.adlsfs",
          "storage.hdfsfs", "common.plugins")


@pytest.fixture
def as_port(monkeypatch):
    """The JAX package's storage and plugin modules swapped for the
    port's, so a reference test body imports the port's classes: in
    ``sys.modules`` and as attributes of their packages. Whether an
    earlier import in this process set that attribute depends on which
    files ran before, so it is set whether or not it exists
    (``raising=False``): teardown then restores the earlier module or
    removes the attribute the fixture added."""
    for rel in PORTED:
        mod = importlib.import_module(f"pinot_tpu_torch.{rel}")
        monkeypatch.setitem(sys.modules, f"pinot_tpu.{rel}", mod)
        parent, _, name = f"pinot_tpu.{rel}".rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), name, mod,
                            raising=False)
    from pinot_tpu.storage import fs as swapped

    assert swapped.__name__ == "pinot_tpu_torch.storage.fs"


def _replay(fn, request):
    """Call a reference test with the fixtures its signature names."""
    names = [p for p in inspect.signature(fn).parameters if p != "self"]
    return fn(*[request.getfixturevalue(n) for n in names])


def _cases(cls):
    return sorted(n for n in vars(cls) if n.startswith("test_"))


@pytest.mark.parametrize("case", _cases(ts3.TestS3FS))
def test_s3_reference_case_on_the_port(fake_boto3, as_port, request, case):
    _replay(getattr(ts3.TestS3FS(), case), request)


@pytest.mark.parametrize("case", _cases(tgc.TestGcsFS))
def test_gcs_reference_case_on_the_port(fake_gcs, as_port, request, case):
    _replay(getattr(tgc.TestGcsFS(), case), request)


@pytest.mark.parametrize("case", _cases(tad.TestAdlsFS))
def test_adls_reference_case_on_the_port(fake_azure, as_port, request, case):
    _replay(getattr(tad.TestAdlsFS(), case), request)


@pytest.mark.parametrize("case", ["test_hdfs_fs", "test_hdfs_registered"])
def test_hdfs_reference_case_on_the_port(as_port, request, case):
    _replay(getattr(tpt, case), request)


# ---------------------------------------------------------------------------
# one lifecycle through both packages
# ---------------------------------------------------------------------------

BACKENDS = {
    "s3": ("fake_boto3", "s3fs", "S3FS", "s3://b", ts3._STORE),
    "gs": ("fake_gcs", "gcsfs", "GcsFS", "gs://b", tgc._STORE),
    "abfss": ("fake_azure", "adlsfs", "AdlsFS", "abfss://cont", tad._STORE),
}


def _lifecycle(pkg, mod, cls, root, tmp):
    """Push, list, pull, remote copy, re-push, delete and a missing pull:
    → the observations, and the fake store's contents after."""
    fs = getattr(importlib.import_module(f"{pkg}.storage.{mod}"), cls)()
    base = tmp / pkg
    v1, v2 = base / "v1", base / "v2"
    (v1 / "sub").mkdir(parents=True)
    v2.mkdir()
    (v1 / "metadata.json").write_text('{"v": 1}')
    (v1 / "old.bin").write_bytes(b"\x00\x01")
    (v1 / "sub" / "x.bin").write_bytes(b"X")
    (v2 / "metadata.json").write_text('{"v": 2}')
    sib = base / "seg_10"
    sib.mkdir()
    (sib / "b.bin").write_bytes(b"B")
    out = []
    fs.copy(str(v1), f"{root}/t/seg_1")
    fs.copy(str(sib), f"{root}/t/seg_10")
    out.append(fs.list_files(f"{root}/t"))
    out.append([fs.exists(f"{root}/t/seg_1"), fs.exists(f"{root}/t/nope")])
    fs.copy(f"{root}/t/seg_1", f"{root}/t2/seg_1")
    fs.copy(str(v2), f"{root}/t/seg_1")   # a re-push replaces
    dl = base / "dl"
    fs.copy(f"{root}/t/seg_1", str(dl))
    out.append(sorted(str(p.relative_to(dl)) for p in dl.rglob("*")
                      if p.is_file()))
    out.append((dl / "metadata.json").read_text())
    dl2 = base / "dl2"
    fs.copy(f"{root}/t2/seg_1", str(dl2))
    out.append((dl2 / "sub" / "x.bin").read_bytes())
    fs.delete(f"{root}/t/seg_1")
    out.append([fs.exists(f"{root}/t/seg_1"), fs.exists(f"{root}/t/seg_10")])
    try:
        fs.copy(f"{root}/t/seg_1", str(base / "dl3"))
        out.append("pulled")
    except Exception as e:  # noqa: BLE001 — compared below
        out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("scheme", list(BACKENDS))
def test_lifecycle_matches_reference(request, tmp_path, scheme):
    fixture, mod, cls, root, store = BACKENDS[scheme]
    request.getfixturevalue(fixture)
    got = _lifecycle("pinot_tpu_torch", mod, cls, root, tmp_path)
    got_store = dict(store)
    store.clear()
    want = _lifecycle("pinot_tpu", mod, cls, root, tmp_path)
    assert got == want
    assert got_store == dict(store)
    assert got[0] == ["seg_1", "seg_10"]


@pytest.mark.parametrize("uri,cls", [
    ("s3://bucket/x", "S3FS"), ("gs://bucket/x", "GcsFS"),
    ("abfss://cont/x", "AdlsFS"), ("hdfs://nn:9870/x", "HdfsFS"),
    ("/tmp/x", "LocalFS"), ("file:///tmp/x", "LocalFS")])
def test_create_fs_picks_the_same_backend(fake_boto3, fake_gcs, fake_azure,
                                          uri, cls):
    from pinot_tpu.storage.fs import create_fs as ref_create
    from pinot_tpu_torch.storage.fs import create_fs

    got = create_fs(uri)
    assert type(got).__name__ == type(ref_create(uri)).__name__ == cls
    assert type(got).__module__.startswith("pinot_tpu_torch.")


def test_local_fs_matches_reference(tmp_path):
    from pinot_tpu.storage.fs import LocalFS as RefLocal
    from pinot_tpu_torch.storage.fs import LocalFS

    out = []
    for cls, side in ((LocalFS, "p"), (RefLocal, "r")):
        src = tmp_path / side / "seg"
        (src / "sub").mkdir(parents=True)
        (src / "a.bin").write_bytes(b"A")
        (src / "sub" / "b.bin").write_bytes(b"B")
        fs = cls()
        dst = tmp_path / side / "deep" / "seg"
        fs.copy(str(src), str(dst))
        obs = [fs.exists(str(dst)), fs.list_files(str(dst)),
               (dst / "sub" / "b.bin").read_bytes()]
        fs.delete(str(dst))
        obs.append(fs.exists(str(dst)))
        out.append(obs)
    assert out[0] == out[1] and out[0][0] is True
