"""Deep-store filesystem SPI.

Equivalent of the reference's ``PinotFS``
(pinot-spi/.../filesystem/PinotFS.java + LocalPinotFS, with S3/GCS/HDFS
as plugins): scheme-keyed factories resolve a URI to a filesystem
offering the segment-lifecycle operations the controller needs (copy
dir/file, delete, exists, listFiles, mkdir). Only ``file://`` ships
in-tree — object-store impls register through the plugin registry
(common/plugins.py) exactly like the reference's pinot-file-system
plugins.

A copy of pinot_tpu/storage/fs.py for the port.
"""

from __future__ import annotations

import os
import shutil
from urllib.parse import urlparse


class PinotFS:
    """SPI surface (PinotFS.java subset the controller exercises)."""

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def copy(self, src: str, dst: str) -> None:
        """File or directory; dst is replaced."""
        raise NotImplementedError

    def list_files(self, path: str) -> list:
        raise NotImplementedError


class LocalFS(PinotFS):
    """LocalPinotFS analog over the host filesystem."""

    @staticmethod
    def _p(path: str) -> str:
        u = urlparse(path)
        return u.path if u.scheme == "file" else path

    def mkdir(self, path: str) -> None:
        os.makedirs(self._p(path), exist_ok=True)

    def delete(self, path: str) -> None:
        p = self._p(path)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.unlink(p)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._p(path))

    def copy(self, src: str, dst: str) -> None:
        s, d = self._p(src), self._p(dst)
        os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
        if os.path.isdir(s):
            if os.path.exists(d):
                shutil.rmtree(d)
            shutil.copytree(s, d)
        else:
            shutil.copy2(s, d)

    def list_files(self, path: str) -> list:
        p = self._p(path)
        return sorted(os.listdir(p)) if os.path.isdir(p) else []


class PrefixObjectFS(PinotFS):
    """Shared base for object stores that model segment directories as key
    prefixes (S3/GCS/ABFS-shaped). Subclasses set ``scheme`` and implement
    five primitive hooks; the PinotFS surface (delimiter-safe dir
    matching, replace-on-copy, download/upload/remote-copy branching) is
    written once here.

    Hooks:
      _list(bucket, prefix, limit=None) -> [key]
      _put(local_path, bucket, key)
      _get(bucket, key, local_path)
      _delete_objs(bucket, [key])            # batched where the SDK allows
      _copy_obj(src_bucket, src_key, dst_bucket, dst_key)
    """

    scheme = ""

    def _split(self, uri: str):
        u = urlparse(uri)
        if u.scheme != self.scheme or not u.netloc:
            raise ValueError(f"not a {self.scheme} URI: {uri!r}")
        return u.netloc, u.path.lstrip("/")

    def _dir_keys(self, bucket: str, prefix: str, limit=None) -> list:
        """Keys of the 'directory' at prefix: everything under
        prefix + '/' plus an exact-key object — a bare prefix match would
        also hit same-prefix siblings (seg_1 vs seg_10)."""
        p = prefix.rstrip("/")
        keys = self._list(bucket, p + "/", limit=limit)
        if limit is None or len(keys) < limit:
            exact = self._list(bucket, p, limit=1)
            if exact and exact[0] == p and p not in keys:
                keys.append(p)
        return keys

    def mkdir(self, path: str) -> None:
        pass  # prefixes need no creation

    def delete(self, path: str) -> None:
        bucket, prefix = self._split(path)
        keys = self._dir_keys(bucket, prefix)
        if keys:
            self._delete_objs(bucket, keys)

    def exists(self, path: str) -> bool:
        bucket, prefix = self._split(path)
        return bool(self._dir_keys(bucket, prefix, limit=1))

    def copy(self, src: str, dst: str) -> None:
        pfx = f"{self.scheme}://"
        src_obj = src.startswith(pfx)
        dst_obj = dst.startswith(pfx)
        if not src_obj and dst_obj:  # upload (segment push)
            self.delete(dst)  # PinotFS contract: dst is REPLACED
            bucket, prefix = self._split(dst)
            if os.path.isdir(src):
                for root, _, files in os.walk(src):
                    for f in sorted(files):
                        full = os.path.join(root, f)
                        rel = os.path.relpath(full, src).replace(os.sep, "/")
                        self._put(full, bucket, f"{prefix.rstrip('/')}/{rel}")
            else:
                self._put(src, bucket, prefix)
        elif src_obj and not dst_obj:  # download (server sync)
            bucket, prefix = self._split(src)
            p = prefix.rstrip("/")
            keys = self._dir_keys(bucket, p)
            if not keys:
                raise FileNotFoundError(src)
            for key in keys:
                rel = key[len(p):].lstrip("/")
                local = os.path.join(dst, rel) if rel else dst
                os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
                self._get(bucket, key, local)
        elif src_obj and dst_obj:
            self.delete(dst)  # PinotFS contract: dst is REPLACED
            sb, sp = self._split(src)
            sp = sp.rstrip("/")
            db, dp = self._split(dst)
            for key in self._dir_keys(sb, sp):
                rel = key[len(sp):].lstrip("/")
                self._copy_obj(sb, key, db, f"{dp}/{rel}".rstrip("/"))
        else:
            raise ValueError(
                f"{type(self).__name__}.copy needs at least one "
                f"{self.scheme}:// side")

    def list_files(self, path: str) -> list:
        bucket, prefix = self._split(path)
        pfx = prefix.rstrip("/") + "/" if prefix else ""
        names = set()
        for key in self._list(bucket, pfx):
            rest = key[len(pfx):]
            names.add(rest.split("/", 1)[0])
        return sorted(n for n in names if n)

    # ---- hooks -----------------------------------------------------------
    def _list(self, bucket: str, prefix: str, limit=None) -> list:
        raise NotImplementedError

    def _put(self, local_path: str, bucket: str, key: str) -> None:
        raise NotImplementedError

    def _get(self, bucket: str, key: str, local_path: str) -> None:
        raise NotImplementedError

    def _delete_objs(self, bucket: str, keys: list) -> None:
        raise NotImplementedError

    def _copy_obj(self, src_bucket: str, src_key: str,
                  dst_bucket: str, dst_key: str) -> None:
        raise NotImplementedError


def create_fs(uri: str) -> PinotFS:
    """Scheme → filesystem via the plugin registry (PinotFSFactory.create)."""
    from pinot_tpu_torch.common.plugins import plugin_registry

    scheme = urlparse(uri).scheme or "file"
    factory = plugin_registry.load("fs", scheme)
    return factory()
