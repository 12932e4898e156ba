"""ADLS (Azure Blob / abfss) deep-store filesystem
(pinot-plugins/pinot-file-system/pinot-adls analog), gated on
azure-storage-blob.

Segment-directory-over-prefix semantics come from the shared
``PrefixObjectFS`` base (storage/fs.py) — this module supplies only the
azure-storage-blob-backed primitive hooks (container == bucket). Registers
lazily under the ``abfss`` scheme and raises a clear error at construction
when the client library is absent. The account connection string rides the
standard ``AZURE_STORAGE_CONNECTION_STRING`` environment variable.

A copy of pinot_tpu/storage/adlsfs.py for the port.
"""

from __future__ import annotations

import os

from pinot_tpu_torch.storage.fs import PrefixObjectFS


def _azure_blob():
    try:
        from azure.storage import blob  # type: ignore

        return blob
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "abfss:// deep store needs the azure-storage-blob package; "
            "install it or use a file:// deep store") from e


class AdlsFS(PrefixObjectFS):
    scheme = "abfss"

    def __init__(self):
        blob = _azure_blob()
        conn = os.environ.get("AZURE_STORAGE_CONNECTION_STRING", "")
        self._client = blob.BlobServiceClient.from_connection_string(conn)

    def _container(self, bucket: str):
        # abfss URIs carry container@account.dfs.core.windows.net as the
        # netloc; the SDK wants the bare container name (the account is
        # fixed by the connection string)
        return self._client.get_container_client(bucket.split("@", 1)[0])

    def _list(self, bucket: str, prefix: str, limit=None) -> list:
        names = []
        for b in self._container(bucket).list_blobs(name_starts_with=prefix):
            names.append(b.name if hasattr(b, "name") else b["name"])
            if limit and len(names) >= limit:
                break
        return names

    def _put(self, local_path: str, bucket: str, key: str) -> None:
        with open(local_path, "rb") as f:
            self._container(bucket).upload_blob(key, f, overwrite=True)

    def _get(self, bucket: str, key: str, local_path: str) -> None:
        with open(local_path, "wb") as f:
            f.write(self._container(bucket).download_blob(key).readall())

    def _delete_objs(self, bucket: str, keys: list) -> None:
        c = self._container(bucket)
        for k in keys:
            try:
                c.delete_blob(k)
            except Exception as e:  # noqa: BLE001 — idempotent like S3/GCS
                if "NotFound" not in type(e).__name__ and "404" not in str(e):
                    raise

    def _copy_obj(self, src_bucket: str, src_key: str,
                  dst_bucket: str, dst_key: str) -> None:
        import time

        src_url = self._container(src_bucket).get_blob_client(src_key).url
        dst = self._container(dst_bucket).get_blob_client(dst_key)
        dst.start_copy_from_url(src_url)
        # start_copy_from_url only INITIATES the copy (pending for large /
        # cross-account blobs); the PrefixObjectFS contract is synchronous
        # (callers delete the source right after a move) — poll to success
        deadline = time.time() + 300
        while time.time() < deadline:
            props = dst.get_blob_properties() if hasattr(
                dst, "get_blob_properties") else None
            status = getattr(getattr(props, "copy", None), "status", None) \
                if props is not None else None
            if status in (None, "success"):
                return
            if status in ("failed", "aborted"):
                raise RuntimeError(
                    f"abfss copy {src_key} -> {dst_key} {status}")
            time.sleep(0.5)
        raise TimeoutError(f"abfss copy {src_key} -> {dst_key} still pending")
