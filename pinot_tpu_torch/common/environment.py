"""Environment provider SPI: failure-domain metadata for instances.

Reference: pinot-plugins/pinot-environment/pinot-azure
(AzureEnvironmentProvider) — resolves the instance's FAILURE DOMAIN from
the cloud metadata service so segment assignment can spread replicas
across fault boundaries. Here the SPI is a registry of providers; the
default provider reads ``PINOT_TPU_FAILURE_DOMAIN`` (or the
``pinot.environment.failure.domain`` config key), and cloud-specific
providers can register the same way the stream/fs plugins do. The
resolved domain rides on InstanceInfo as a ``fd:<domain>`` tag, and the
segment assigner spreads replicas across distinct domains
(controller/controller.py SegmentAssigner).

A copy of pinot_tpu/common/environment.py for the port.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

FD_TAG_PREFIX = "fd:"

_PROVIDERS: dict[str, Callable[[], Optional[str]]] = {}


def register_environment_provider(name: str,
                                  fn: Callable[[], Optional[str]]) -> None:
    _PROVIDERS[name] = fn


def _default_provider() -> Optional[str]:
    fd = os.environ.get("PINOT_TPU_FAILURE_DOMAIN")
    if fd:
        return fd
    from pinot_tpu_torch.common.config import Configuration

    return Configuration().get("pinot.environment.failure.domain", None)


register_environment_provider("default", _default_provider)


def resolve_failure_domain(provider: str = "default") -> Optional[str]:
    fn = _PROVIDERS.get(provider)
    return fn() if fn is not None else None


def failure_domain_tag(provider: str = "default") -> Optional[str]:
    """``fd:<domain>`` instance tag, or None when no domain is configured."""
    fd = resolve_failure_domain(provider)
    return f"{FD_TAG_PREFIX}{fd}" if fd else None


def domain_of(instance) -> Optional[str]:
    """Failure domain from an InstanceInfo's tags."""
    for t in getattr(instance, "tags", ()) or ():
        if str(t).startswith(FD_TAG_PREFIX):
            return str(t)[len(FD_TAG_PREFIX):]
    return None
