"""Scalar GCRA rate limiter: the semantic contract of the framework.

A faithful re-implementation of the reference's GCRA engine
(`throttlecrab/src/core/rate_limiter.rs:102-250`):

- theoretical-arrival-time (TAT) stored per key, in i64 ns since epoch;
- first touch initialises TAT to `now - emission_interval`
  (`rate_limiter.rs:163-166`); stored TATs are clamped to
  `now - tolerance` (`:158-161`);
- `new_tat = tat + emission_interval * quantity` (saturating, `:170-171`);
- allowed iff `now >= new_tat - tolerance` (`:174-175`);
- TTL on write = `new_tat - now + tolerance` (`:179-183`);
- `remaining = (now + tolerance - current_tat) / emission_interval`,
  truncated toward zero, clamped at 0 (`:217-225`);
- `reset_after = current_tat - now + tolerance` (`:227-232`);
- `retry_after = allow_at - now` when denied, else 0 (`:234-238`);
- CAS retry loop capped at 10 attempts (`:146-204`);
- quantity < 0 and non-positive params are errors; quantity == 0 is a free
  probe.

The port's copy of `throttlecrab_tpu/core/rate_limiter.py`: the scalar
path is the library surface (`RateLimiter(AdaptiveStore())`) and the
host oracle for the batched device decide.  Time is an explicit `now_ns`
input.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .errors import InternalError, InvalidRateLimit, NegativeQuantity
from .i64 import (
    NS_PER_SEC,
    rust_div,
    sat_add,
    sat_mul,
    sat_mul_u64,
    sat_sub,
    wrap_i64,
    wrap_u64,
)
from .rate import Rate
from .store.base import Store

MAX_RETRIES = 10
_U32_MASK = (1 << 32) - 1


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


def derive_intervals(max_burst: int, count_per_period: int, period: int) -> tuple[int, int]:
    """(emission_interval_ns, tolerance_ns) as wrapped i64 values.

    Emission interval comes from the f64 pipeline of `rate/mod.rs:164-176`;
    tolerance is `emission_interval * ((max_burst - 1) as u32)`
    (`rate_limiter.rs:122`), both then narrowed with `as_nanos() as i64`
    wrapping casts (`rate_limiter.rs:154-155`).
    """
    emission_exact = Rate.from_count_and_period(count_per_period, period).period_ns
    tolerance_exact = emission_exact * ((max_burst - 1) & _U32_MASK)
    return wrap_i64(emission_exact), wrap_i64(tolerance_exact)


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


class RateLimiter:
    """GCRA rate limiter over a pluggable :class:`Store`."""

    def __init__(self, store: Store) -> None:
        self.store = store

    def rate_limit(
        self,
        key: str,
        max_burst: int,
        count_per_period: int,
        period: int,
        quantity: int,
        now_ns: int,
    ) -> tuple[bool, RateLimitResult]:
        """Check (and consume) `quantity` tokens for `key` at time `now_ns`."""
        if quantity < 0:
            raise NegativeQuantity(quantity)
        if max_burst <= 0 or count_per_period <= 0 or period <= 0:
            raise InvalidRateLimit()

        emission_interval_ns, tolerance_ns = derive_intervals(
            max_burst, count_per_period, period
        )
        now_ns = normalize_now_ns(now_ns, period)

        retries = 0
        while True:
            tat_val = self.store.get(key, now_ns)

            if tat_val is not None:
                tat = max(tat_val, sat_sub(now_ns, tolerance_ns))
            else:
                tat = sat_sub(now_ns, emission_interval_ns)

            increment = sat_mul(emission_interval_ns, quantity)
            new_tat = sat_add(tat, increment)

            allow_at = sat_sub(new_tat, tolerance_ns)
            allowed = now_ns >= allow_at

            if allowed:
                ttl_ns = wrap_u64(sat_add(sat_sub(new_tat, now_ns), tolerance_ns))
                if tat_val is not None:
                    success = self.store.compare_and_swap_with_ttl(
                        key, tat_val, new_tat, ttl_ns, now_ns
                    )
                else:
                    success = self.store.set_if_not_exists_with_ttl(
                        key, new_tat, ttl_ns, now_ns
                    )
                if not success:
                    retries += 1
                    if retries >= MAX_RETRIES:
                        raise InternalError("max retries exceeded")
                    continue

            current_tat = new_tat if allowed else tat

            burst_limit = wrap_i64(now_ns + tolerance_ns)
            room_until_limit = sat_sub(burst_limit, current_tat)
            if emission_interval_ns > 0:
                remaining = max(rust_div(room_until_limit, emission_interval_ns), 0)
            else:
                remaining = 0

            reset_after_ns = wrap_u64(
                max(sat_add(sat_sub(current_tat, now_ns), tolerance_ns), 0)
            )
            retry_after_ns = (
                0 if allowed else wrap_u64(max(sat_sub(allow_at, now_ns), 0))
            )

            return allowed, RateLimitResult(
                limit=max_burst,
                remaining=remaining,
                reset_after_ns=reset_after_ns,
                retry_after_ns=retry_after_ns,
            )
