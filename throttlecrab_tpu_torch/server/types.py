"""Shared request/response types (reference: throttlecrab-server/src/types.rs).

`ThrottleResponse` carries whole *seconds* for reset_after/retry_after — the
reference truncates its internal Durations to seconds at the type boundary
(`types.rs:87-97`), and both its HTTP JSON and gRPC proto expose integer
seconds.  The engine keeps nanoseconds internally and truncates here.
"""

from __future__ import annotations

from dataclasses import dataclass

NS_PER_SEC = 1_000_000_000


@dataclass
class ThrottleRequest:
    """One rate-limit check (types.rs:32-45); timestamp is server-side.

    `deadline_ns` is the optional client deadline, absolute in the
    engine's now_fn clock (None = no deadline — byte-identical legacy
    behavior).  Requests still queued past it are shed at flush time,
    before any device dispatch, with STATUS_DEADLINE semantics."""

    key: str
    max_burst: int
    count_per_period: int
    period: int
    quantity: int = 1
    deadline_ns: int | None = None


@dataclass
class ThrottleResponse:
    """Decision returned to every transport (types.rs:74-85)."""

    allowed: bool
    limit: int
    remaining: int
    reset_after: int  # whole seconds (truncated)
    retry_after: int  # whole seconds (truncated)

    @classmethod
    def from_ns(
        cls,
        allowed: bool,
        limit: int,
        remaining: int,
        reset_after_ns: int,
        retry_after_ns: int,
    ) -> "ThrottleResponse":
        return cls(
            allowed=allowed,
            limit=limit,
            remaining=remaining,
            reset_after=reset_after_ns // NS_PER_SEC,
            retry_after=retry_after_ns // NS_PER_SEC,
        )
