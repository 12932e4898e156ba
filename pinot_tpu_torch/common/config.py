"""Layered configuration.

Equivalent to the reference's ``PinotConfiguration``
(pinot-spi/.../env/PinotConfiguration.java): resolution order is explicit
overrides > environment variables (``PINOT_TPU_`` prefix, dots as
underscores) > properties/JSON file > defaults.

A copy of pinot_tpu/common/config.py for the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping


class Configuration:
    ENV_PREFIX = "PINOT_TPU_"

    def __init__(
        self,
        overrides: Mapping[str, Any] | None = None,
        config_file: str | None = None,
        defaults: Mapping[str, Any] | None = None,
        env: Mapping[str, str] | None = None,
    ):
        self._defaults = dict(defaults or {})
        self._file: dict[str, Any] = {}
        if config_file:
            self._file = self._load_file(config_file)
        self._env = dict(env if env is not None else os.environ)
        self._overrides = dict(overrides or {})

    @staticmethod
    def _load_file(path: str) -> dict:
        with open(path) as f:
            text = f.read()
        text_stripped = text.lstrip()
        if text_stripped.startswith("{"):
            return dict(json.loads(text))
        # .properties style: key=value lines
        out = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    def _env_key(self, key: str) -> str:
        return self.ENV_PREFIX + key.upper().replace(".", "_").replace("-", "_")

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._overrides:
            return self._overrides[key]
        ek = self._env_key(key)
        if ek in self._env:
            return self._env[ek]
        if key in self._file:
            return self._file[key]
        return self._defaults.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("true", "1", "yes", "on")

    def set(self, key: str, value: Any) -> None:
        self._overrides[key] = value

    def subset(self, prefix: str) -> dict[str, Any]:
        """All resolved keys under ``prefix.`` (file+defaults+overrides keys)."""
        keys = set(self._defaults) | set(self._file) | set(self._overrides)
        p = prefix.rstrip(".") + "."
        return {k[len(p):]: self.get(k) for k in keys if k.startswith(p)}
