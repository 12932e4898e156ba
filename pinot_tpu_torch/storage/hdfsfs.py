"""HDFS deep-store filesystem
(pinot-plugins/pinot-file-system/pinot-hdfs analog) over the WebHDFS REST
gateway — stdlib urllib only, no hadoop client dependency.

Unlike the object stores (PrefixObjectFS), HDFS is a real hierarchical
filesystem, so this implements the PinotFS surface directly with WebHDFS
operations: MKDIRS, GETFILESTATUS, LISTSTATUS, DELETE (recursive),
CREATE (two-step redirect PUT), OPEN. URIs:

    hdfs://namenode:9870/path/to/segment

where the authority is the WebHDFS (HTTP) endpoint of the namenode. An
optional ``HDFS_USER`` environment variable rides as ``user.name`` on
every call (simple auth — the common dev/test posture; kerberized
clusters front WebHDFS with a gateway).

Registers under the ``hdfs`` scheme via the plugin registry, like the
s3/gs/abfss plugins.

A copy of pinot_tpu/storage/hdfsfs.py for the port.
"""

from __future__ import annotations

import json
import os
import shutil
from urllib.parse import quote, urlparse

from pinot_tpu_torch.storage.fs import PinotFS

_TIMEOUT_S = 30.0


class HdfsFS(PinotFS):
    scheme = "hdfs"

    def __init__(self):
        self.user = os.environ.get("HDFS_USER", "")

    # ---- REST plumbing ---------------------------------------------------
    def _split(self, uri: str):
        u = urlparse(uri)
        if u.scheme != self.scheme or not u.netloc:
            raise ValueError(f"not an {self.scheme} URI: {uri!r}")
        return u.netloc, u.path or "/"

    def _url(self, authority: str, path: str, op: str, **params) -> str:
        qs = f"op={op}"
        if self.user:
            qs += f"&user.name={quote(self.user)}"
        for k, v in params.items():
            qs += f"&{k}={quote(str(v))}"
        return f"http://{authority}/webhdfs/v1{quote(path)}?{qs}"

    def _call(self, method: str, url: str, data=None,
              follow_redirect_put: bool = False, sink=None):
        """``data`` may be bytes or a FILE OBJECT (urllib streams file-like
        PUT bodies); ``sink``: stream the response into this open file
        instead of returning bytes — multi-GB segment files must not
        buffer whole on the heap."""
        import shutil as _shutil
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url, method=method)
        try:
            with urllib.request.urlopen(req, timeout=_TIMEOUT_S) as resp:
                if sink is not None:
                    _shutil.copyfileobj(resp, sink)
                    return b""
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 307 and follow_redirect_put:
                # CREATE/APPEND two-step: the namenode redirects to a
                # datanode; PUT the payload there (streamed when file-like)
                loc = e.headers.get("Location")
                req2 = urllib.request.Request(
                    loc, data=(data if data is not None else b""),
                    method="PUT")
                with urllib.request.urlopen(req2, timeout=_TIMEOUT_S) as r2:
                    return r2.read()
            if e.code == 404:
                raise FileNotFoundError(url) from e
            raise

    def _status(self, authority: str, path: str):
        try:
            raw = self._call("GET", self._url(authority, path,
                                              "GETFILESTATUS"))
        except FileNotFoundError:
            return None
        return json.loads(raw.decode("utf-8"))["FileStatus"]

    # ---- PinotFS surface -------------------------------------------------
    def mkdir(self, path: str) -> None:
        auth, p = self._split(path)
        self._call("PUT", self._url(auth, p, "MKDIRS"))

    def delete(self, path: str) -> None:
        auth, p = self._split(path)
        try:
            self._call("DELETE", self._url(auth, p, "DELETE",
                                           recursive="true"))
        except FileNotFoundError:
            pass  # idempotent like the object stores

    def exists(self, path: str) -> bool:
        auth, p = self._split(path)
        return self._status(auth, p) is not None

    def _list_status(self, authority: str, path: str) -> list:
        """[(name, 'FILE'|'DIRECTORY')] — one LISTSTATUS, types included,
        so directory walks don't need a GETFILESTATUS per child."""
        raw = self._call("GET", self._url(authority, path, "LISTSTATUS"))
        statuses = json.loads(raw.decode("utf-8"))
        return sorted(
            (s["pathSuffix"], s["type"])
            for s in statuses["FileStatuses"]["FileStatus"]
            if s["pathSuffix"])

    def list_files(self, path: str) -> list:
        auth, p = self._split(path)
        return [n for n, _t in self._list_status(auth, p)]

    def _upload_file(self, local: str, auth: str, remote: str) -> None:
        with open(local, "rb") as f:
            self._call("PUT", self._url(auth, remote, "CREATE",
                                        overwrite="true"),
                       data=f, follow_redirect_put=True)

    def _download_file(self, auth: str, remote: str, local: str) -> None:
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        with open(local, "wb") as f:
            self._call("GET", self._url(auth, remote, "OPEN"), sink=f)

    def copy(self, src: str, dst: str) -> None:
        pfx = f"{self.scheme}://"
        src_h, dst_h = src.startswith(pfx), dst.startswith(pfx)
        if not src_h and dst_h:  # upload (segment push)
            self.delete(dst)
            auth, p = self._split(dst)
            if os.path.isdir(src):
                self._call("PUT", self._url(auth, p, "MKDIRS"))
                for root, _, files in os.walk(src):
                    for f in sorted(files):
                        full = os.path.join(root, f)
                        rel = os.path.relpath(full, src).replace(os.sep, "/")
                        self._upload_file(full, auth, f"{p.rstrip('/')}/{rel}")
            else:
                self._upload_file(src, auth, p)
        elif src_h and not dst_h:  # download (server sync)
            auth, p = self._split(src)
            st = self._status(auth, p)
            if st is None:
                raise FileNotFoundError(src)
            if st["type"] == "FILE":
                self._download_file(auth, p, dst)
                return
            os.makedirs(dst, exist_ok=True)
            for name, ftype in self._list_status(auth, p):
                child = f"{src.rstrip('/')}/{name}"
                local = os.path.join(dst, name)
                if ftype == "DIRECTORY":
                    self.copy(child, local)
                else:
                    self._download_file(auth, f"{p.rstrip('/')}/{name}",
                                        local)
        elif src_h and dst_h:
            # no server-side copy op in WebHDFS: bounce through a temp dir
            import tempfile

            tmp = tempfile.mkdtemp(prefix="hdfs_cp_")
            try:
                self.copy(src, os.path.join(tmp, "x"))
                self.copy(os.path.join(tmp, "x"), dst)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise ValueError(
                f"HdfsFS.copy needs at least one {self.scheme}:// side")
