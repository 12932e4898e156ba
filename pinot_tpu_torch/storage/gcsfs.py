"""GCS deep-store filesystem (pinot-plugins/pinot-file-system/pinot-gcs
analog), gated on google-cloud-storage.

Segment-directory-over-prefix semantics come from the shared
``PrefixObjectFS`` base (storage/fs.py) — this module supplies only the
google-cloud-storage-backed primitive hooks. Registers lazily under the
``gs`` scheme and raises a clear error at construction when the client
library is absent.

A copy of pinot_tpu/storage/gcsfs.py for the port.
"""

from __future__ import annotations

from pinot_tpu_torch.storage.fs import PrefixObjectFS


def _gcs():
    try:
        from google.cloud import storage  # type: ignore

        return storage
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "gs:// deep store needs the google-cloud-storage package; "
            "install it or use a file:// deep store") from e


class GcsFS(PrefixObjectFS):
    scheme = "gs"

    def __init__(self):
        self._client = _gcs().Client()

    def _list(self, bucket: str, prefix: str, limit=None) -> list:
        kw = {"prefix": prefix}
        if limit:
            kw["max_results"] = limit
        return [b.name for b in self._client.list_blobs(bucket, **kw)]

    def _put(self, local_path: str, bucket: str, key: str) -> None:
        self._client.bucket(bucket).blob(key).upload_from_filename(local_path)

    def _get(self, bucket: str, key: str, local_path: str) -> None:
        self._client.bucket(bucket).blob(key).download_to_filename(local_path)

    @staticmethod
    def _is_not_found(exc: Exception) -> bool:
        return "NotFound" in type(exc).__name__ or "404" in str(exc)

    def _delete_objs(self, bucket: str, keys: list) -> None:
        b = self._client.bucket(bucket)
        # one round trip per batch instead of one per blob; deletes must be
        # IDEMPOTENT like S3's delete_objects — a concurrent retire racing
        # this listing raises NotFound mid-batch, which is success here
        for i in range(0, len(keys), 100):  # GCS batch cap
            try:
                with self._client.batch():
                    for k in keys[i: i + 100]:
                        b.blob(k).delete()
            except Exception as e:  # noqa: BLE001 — tolerate gone objects
                if not self._is_not_found(e):
                    raise

    def _copy_obj(self, src_bucket: str, src_key: str,
                  dst_bucket: str, dst_key: str) -> None:
        sb = self._client.bucket(src_bucket)
        sb.copy_blob(sb.blob(src_key), self._client.bucket(dst_bucket),
                     dst_key)
