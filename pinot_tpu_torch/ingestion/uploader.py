"""Segment uploader SPI
(pinot-plugins/pinot-segment-uploader/pinot-segment-uploader-default
analog): the pluggable push step between a built segment and the cluster,
with bounded retry — transient deep-store/controller hiccups during a
batch job must not fail the whole job on the first blip
(SegmentUploaderDefault wraps the same retry-and-report loop around the
controller push).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger("pinot_tpu_torch.ingestion.uploader")


class SegmentUploader:
    """SPI surface (SegmentUploader.java role)."""

    def upload(self, table: str, segment_dir: str) -> str:
        """Push one built segment dir; returns the segment name."""
        raise NotImplementedError


class ControllerSegmentUploader(SegmentUploader):
    """Default uploader: the controller push path with exponential-backoff
    retries."""

    def __init__(self, controller, max_attempts: int = 3,
                 backoff_s: float = 0.5):
        self.controller = controller
        self.max_attempts = max(1, max_attempts)
        self.backoff_s = backoff_s

    def upload(self, table: str, segment_dir: str) -> str:
        import random

        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            try:
                return self.controller.upload_segment(table, segment_dir)
            except Exception as e:  # noqa: BLE001 — retried, then surfaced
                last = e
                if attempt + 1 < self.max_attempts:
                    # jittered exponential backoff (0.5x-1.0x of the
                    # step): a batch job's N workers failing on the same
                    # controller blip must not retry in lockstep and
                    # re-stampede it at exactly backoff*2^k
                    sleep = self.backoff_s * (2 ** attempt) \
                        * (0.5 + random.random() * 0.5)
                    log.warning(
                        "segment upload %s/%s attempt %d failed (%s); "
                        "retrying in %.1fs", table, segment_dir,
                        attempt + 1, e, sleep)
                    time.sleep(sleep)
        raise RuntimeError(
            f"segment upload {table}/{segment_dir} failed after "
            f"{self.max_attempts} attempts") from last


_UPLOADERS: dict[str, Callable] = {"default": ControllerSegmentUploader}


def register_uploader(name: str, factory: Callable) -> None:
    _UPLOADERS[name] = factory


def create_uploader(name: str, controller, **kwargs) -> SegmentUploader:
    try:
        return _UPLOADERS[name](controller, **kwargs)
    except KeyError:
        raise KeyError(f"unknown segment uploader {name!r}") from None
