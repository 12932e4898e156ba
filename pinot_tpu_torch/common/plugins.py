"""Plugin registry: one discovery surface for every pluggable kind (a copy
of pinot_tpu/common/plugins.py for the port).

Equivalent of the reference's plugin framework
(pinot-spi/.../plugin/PluginManager.java + the pinot-plugins/* tree):
kind-keyed factories (stream types, message decoders, record readers,
filesystems, minion task executors) behind one ``register``/``load``
surface. The reference isolates plugins with per-plugin classloaders and
discovers them from a plugins dir; here the python import system is the
plugin boundary — ``PINOT_TPU_PLUGINS`` names modules to import at
bootstrap, and importing a plugin module registers its factories (the
side-effect contract the reference's ServiceLoader files play).
"""

from __future__ import annotations

import importlib
import logging
import os
import threading

log = logging.getLogger("pinot_tpu_torch.plugins")

PLUGINS_ENV = "PINOT_TPU_PLUGINS"


class PluginRegistry:
    def __init__(self):
        # RLock: _bootstrap holds it across _register_builtins, whose
        # modules call back into register() on this same thread
        self._lock = threading.RLock()
        self._plugins: dict[tuple, object] = {}
        self._bootstrapped = False

    def register(self, kind: str, name: str, factory) -> None:
        with self._lock:
            self._plugins[(kind, name.lower())] = factory

    def load(self, kind: str, name: str):
        self._bootstrap()
        with self._lock:
            try:
                return self._plugins[(kind, name.lower())]
            except KeyError:
                have = sorted(n for k, n in self._plugins if k == kind)
                raise KeyError(
                    f"no {kind!r} plugin named {name!r}; registered: {have}"
                ) from None

    def available(self, kind: str) -> list:
        self._bootstrap()
        with self._lock:
            return sorted(n for k, n in self._plugins if k == kind)

    def _bootstrap(self) -> None:
        """Register built-ins + import PINOT_TPU_PLUGINS modules, once.
        Runs entirely under the lock so a concurrent load() never observes
        a half-registered state; the done-flag is only set on success, so
        a transient import failure retries instead of poisoning the
        registry for the process lifetime."""
        with self._lock:
            if self._bootstrapped:
                return
            self._register_builtins()
            self.load_env_plugins()
            self._bootstrapped = True

    def load_env_plugins(self) -> list:
        """Import every module named in PINOT_TPU_PLUGINS (idempotent —
        python caches the import; a module's registrations land on the
        GLOBAL registry it imports). Returns the modules loaded."""
        loaded = []
        for mod in filter(None, os.environ.get(PLUGINS_ENV, "").split(",")):
            try:
                loaded.append(importlib.import_module(mod.strip()))
            except Exception:  # noqa: BLE001 — one bad plugin ≠ dead process
                log.exception("failed to load plugin module %s", mod)
        return loaded

    def _register_builtins(self) -> None:
        from pinot_tpu_torch.ingestion import readers as _readers
        from pinot_tpu_torch.storage import fs as _fs
        from pinot_tpu_torch.stream import memory_stream  # noqa: F401 (registers)
        from pinot_tpu_torch.stream import spi as _stream

        self.register("fs", "file", _fs.LocalFS)
        self.register("fs", "", _fs.LocalFS)  # bare paths
        from pinot_tpu_torch.storage import gcsfs as _gcsfs
        from pinot_tpu_torch.storage import s3fs as _s3fs

        self.register("fs", "s3", _s3fs.S3FS)  # gated on boto3 at init
        self.register("fs", "gs", _gcsfs.GcsFS)  # gated on google-cloud
        from pinot_tpu_torch.storage import adlsfs as _adlsfs

        self.register("fs", "abfss", _adlsfs.AdlsFS)  # gated on azure sdk
        from pinot_tpu_torch.storage import hdfsfs as _hdfsfs

        self.register("fs", "hdfs", _hdfsfs.HdfsFS)  # WebHDFS REST (stdlib)
        for name, cls in _stream._FACTORIES.items():
            self.register("stream", name, cls)
        for name, fn in _stream._DECODERS.items():
            self.register("decoder", name, fn)
        for name, cls in _readers._READERS.items():
            self.register("record_reader", name, cls)
        from pinot_tpu_torch.minion import tasks as _tasks

        for name, fn in _tasks.TASK_EXECUTORS.items():
            self.register("minion_task", name, fn)


plugin_registry = PluginRegistry()
