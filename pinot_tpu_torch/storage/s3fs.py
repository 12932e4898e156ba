"""S3 deep-store filesystem (pinot-plugins/pinot-file-system/pinot-s3
analog), gated on boto3.

Segment-directory-over-prefix semantics come from the shared
``PrefixObjectFS`` base (storage/fs.py) — this module supplies only the
five boto3-backed primitive hooks. Registers lazily under the ``s3``
scheme and raises a clear error at construction when boto3 is absent.

Config via environment: the standard AWS env/credentials chain applies,
plus ``PINOT_TPU_S3_ENDPOINT`` for S3-compatible stores.

A copy of pinot_tpu/storage/s3fs.py for the port.
"""

from __future__ import annotations

import os

from pinot_tpu_torch.storage.fs import PrefixObjectFS


def _boto3():
    try:
        import boto3  # type: ignore

        return boto3
    except ImportError as e:  # pragma: no cover - exercised via fake module
        raise RuntimeError(
            "s3:// deep store needs the boto3 package; install it or use a "
            "file:// deep store") from e


class S3FS(PrefixObjectFS):
    scheme = "s3"

    def __init__(self):
        b3 = _boto3()
        kwargs = {}
        endpoint = os.environ.get("PINOT_TPU_S3_ENDPOINT")
        if endpoint:
            kwargs["endpoint_url"] = endpoint
        self._s3 = b3.client("s3", **kwargs)

    def _list(self, bucket: str, prefix: str, limit=None) -> list:
        keys = []
        token = None
        while True:
            kw = {"Bucket": bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            if limit:
                kw["MaxKeys"] = limit
            resp = self._s3.list_objects_v2(**kw)
            keys.extend(o["Key"] for o in resp.get("Contents", ()))
            if limit or not resp.get("IsTruncated"):
                return keys
            token = resp.get("NextContinuationToken")

    def _put(self, local_path: str, bucket: str, key: str) -> None:
        self._s3.upload_file(local_path, bucket, key)

    def _get(self, bucket: str, key: str, local_path: str) -> None:
        self._s3.download_file(bucket, key, local_path)

    def _delete_objs(self, bucket: str, keys: list) -> None:
        for i in range(0, len(keys), 1000):  # API batch cap
            self._s3.delete_objects(
                Bucket=bucket,
                Delete={"Objects": [{"Key": k} for k in keys[i: i + 1000]]})

    def _copy_obj(self, src_bucket: str, src_key: str,
                  dst_bucket: str, dst_key: str) -> None:
        self._s3.copy_object(Bucket=dst_bucket, Key=dst_key,
                             CopySource={"Bucket": src_bucket,
                                         "Key": src_key})
