"""End-to-end query deadlines.

A copy of pinot_tpu/common/deadline.py (the port imports nothing of the
JAX package).

The reference honors ``timeoutMs`` at every tier: the broker stamps a
deadline when the request arrives and ships the *remaining* budget to each
server in the InstanceRequest; servers check it at admission and during
execution, answering with a QUERY_TIMEOUT-coded exception (errorCode 250
family) instead of running to completion after the client gave up. This
module is that budget object: created once per query, decremented by
wall-clock, consulted at every blocking seam (compile semaphore, scheduler
admission, device fetch, host fallback gate, peer fetch, broker gather).

Monotonic-clock based: wall-clock steps (NTP) must not spuriously expire
or extend a query's budget.
"""

from __future__ import annotations

import time

# reference errorCode for a query that ran out of budget
# (QueryException.BROKER_TIMEOUT_ERROR_CODE shape)
QUERY_TIMEOUT_ERROR_CODE = 250


class QueryTimeout(Exception):
    """The query's deadline expired. Carries where the budget ran out so
    the in-band error names the seam (admission vs fetch vs gather)."""

    error_code = QUERY_TIMEOUT_ERROR_CODE


class Deadline:
    """Absolute per-query deadline; cheap to consult."""

    __slots__ = ("at", "budget_s")

    def __init__(self, timeout_s: float):
        self.budget_s = max(0.0, float(timeout_s))
        self.at = time.monotonic() + self.budget_s

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) / 1000.0)

    def remaining_s(self) -> float:
        return self.at - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1000.0

    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def check(self, where: str) -> None:
        """Raise QueryTimeout when the budget is gone."""
        if self.expired():
            raise QueryTimeout(
                f"QUERY_TIMEOUT at {where}: budget "
                f"{self.budget_s * 1000:.0f}ms exhausted")

    def clamp(self, timeout_s: float) -> float:
        """A wait bounded by BOTH its own cap and the remaining budget
        (never negative — an expired deadline yields an immediate-timeout
        wait, and the caller's post-wait check raises)."""
        return max(0.0, min(float(timeout_s), self.remaining_s()))
