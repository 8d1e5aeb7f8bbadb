"""Rate: converts "(count, period)" into an emission interval.

Semantics mirror the reference's `Rate` (`throttlecrab/src/core/rate/mod.rs`):

- convenience constructors `per_second/minute/hour/day` divide the base
  duration by the count with exact integer nanosecond math;
- `from_count_and_period` uses f64 math (`period * 1e9 / count`) truncated to
  u64 — the exact float pipeline of `rate/mod.rs:164-176` — so emission
  intervals match the reference bit for bit;
- invalid input (count <= 0 or period <= 0) yields an effectively-infinite
  interval ("block all"), modelled as u64::MAX *seconds* like
  `rate/mod.rs:166-170`.

The emission interval is stored as an exact (unbounded) integer nanosecond
count; users convert to i64 at the point of use, reproducing the reference's
`Duration::as_nanos() as i64` cast.
"""

from __future__ import annotations

from dataclasses import dataclass

from .i64 import NS_PER_SEC, U64_MAX, f64_to_u64_sat


@dataclass(frozen=True)
class Rate:
    """An emission interval, in exact integer nanoseconds."""

    period_ns: int

    @staticmethod
    def new(period_ns: int) -> "Rate":
        """A rate with a custom period between token emissions."""
        return Rate(period_ns)

    @staticmethod
    def _per(base_ns: int, n: int) -> "Rate":
        # The reference takes u64 here — non-positive counts are
        # unrepresentable; reject them instead of producing a negative
        # interval.
        if n <= 0:
            raise ValueError(f"rate count must be positive, got {n}")
        return Rate(base_ns // n)

    @staticmethod
    def per_second(n: int) -> "Rate":
        return Rate._per(NS_PER_SEC, n)

    @staticmethod
    def per_minute(n: int) -> "Rate":
        return Rate._per(60 * NS_PER_SEC, n)

    @staticmethod
    def per_hour(n: int) -> "Rate":
        return Rate._per(3600 * NS_PER_SEC, n)

    @staticmethod
    def per_day(n: int) -> "Rate":
        return Rate._per(86400 * NS_PER_SEC, n)

    @staticmethod
    def from_count_and_period(count: int, period_seconds: int) -> "Rate":
        """Emission interval for "count requests per period_seconds".

        Invalid parameters yield a block-all rate of u64::MAX seconds.
        """
        if count <= 0 or period_seconds <= 0:
            return Rate(U64_MAX * NS_PER_SEC)
        period_ns = f64_to_u64_sat(float(period_seconds) * 1e9 / float(count))
        return Rate(period_ns)

    def period(self) -> int:
        """The emission interval in nanoseconds."""
        return self.period_ns
