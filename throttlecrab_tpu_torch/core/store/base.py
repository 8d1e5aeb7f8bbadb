"""Store protocol: the storage contract for rate-limiter state.

Mirrors the reference `Store` trait (`throttlecrab/src/core/store/mod.rs:85-133`):
one i64 value (the TAT, in ns since epoch) plus a TTL per string key, with
atomic compare-and-swap and set-if-absent, and a `get` that treats expired
entries as absent.

Time (`now_ns`) is an explicit integer-nanosecond input on every call — never
ambient state — so tests can run on virtual time.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable


@runtime_checkable
class Store(Protocol):
    """Storage backend for rate limiter state."""

    def compare_and_swap_with_ttl(
        self, key: str, old: int, new: int, ttl_ns: int, now_ns: int
    ) -> bool:
        """Atomically swap `old` → `new` for `key`, refreshing its TTL.

        Returns True iff the current value matched `old` (and was not
        expired).
        """
        ...

    def get(self, key: str, now_ns: int) -> Optional[int]:
        """Current value for `key`, or None if absent or expired at now_ns."""
        ...

    def set_if_not_exists_with_ttl(
        self, key: str, value: int, ttl_ns: int, now_ns: int
    ) -> bool:
        """Create `key` with `value` and TTL; False if it already exists."""
        ...
