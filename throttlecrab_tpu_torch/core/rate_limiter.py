"""The result type and clock-skew rule of the scalar GCRA contract.

`RateLimitResult` mirrors the reference's result struct
(`throttlecrab/src/core/rate_limiter.rs:13-22`) and `normalize_now_ns`
its pre-epoch clock fallback (`rate_limiter.rs:126-144`).  The scalar
engine and its stores are not part of this package yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .errors import InternalError
from .i64 import NS_PER_SEC, sat_mul_u64, wrap_i64


@dataclass(frozen=True)
class RateLimitResult:
    """Outcome of a rate-limit check (mirrors `rate_limiter.rs:13-22`)."""

    limit: int
    remaining: int
    reset_after_ns: int
    retry_after_ns: int

    @property
    def reset_after_secs(self) -> int:
        """Whole seconds until full reset (Duration::as_secs truncation)."""
        return self.reset_after_ns // NS_PER_SEC

    @property
    def retry_after_secs(self) -> int:
        """Whole seconds until the next request can succeed."""
        return self.retry_after_ns // NS_PER_SEC

    @property
    def reset_after(self) -> float:
        return self.reset_after_ns / NS_PER_SEC

    @property
    def retry_after(self) -> float:
        return self.retry_after_ns / NS_PER_SEC


def normalize_now_ns(now_ns: int, period: int) -> int:
    """Clock-skew fallback of `rate_limiter.rs:126-144`.

    A pre-epoch timestamp (negative ns) falls back to wall-clock time minus
    one period, letting the system continue with a fresh window.
    """
    if now_ns >= 0:
        return now_ns
    current = time.time_ns()
    if current < 0:  # pragma: no cover - wall clock before epoch
        raise InternalError("system time error: clock before Unix epoch")
    period_ns = sat_mul_u64(max(period, 0), NS_PER_SEC)
    return wrap_i64(max(current - period_ns, 0))
