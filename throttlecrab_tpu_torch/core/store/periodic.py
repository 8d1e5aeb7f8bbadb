"""PeriodicStore: fixed-interval full-sweep cleanup.

Semantics per `throttlecrab/src/core/store/periodic.rs`: a cleanup sweep runs
lazily inside mutating operations whenever `now >= next_cleanup`, then
schedules the next sweep `cleanup_interval` later.  Default interval: 60 s.
"""

from __future__ import annotations

from typing import Optional

from ..i64 import NS_PER_SEC
from .mapstore import MapStore

DEFAULT_CAPACITY = 1000
DEFAULT_CLEANUP_INTERVAL_SECS = 60


class PeriodicStore(MapStore):
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        cleanup_interval_ns: int = DEFAULT_CLEANUP_INTERVAL_SECS * NS_PER_SEC,
    ) -> None:
        super().__init__()
        # API parity only: the reference preallocates its HashMap with this
        # hint; Python dicts have no preallocation and this store has no
        # capacity-based trigger (unlike AdaptiveStore).
        self.capacity = capacity
        self.cleanup_interval_ns = cleanup_interval_ns
        # Seeded lazily from the first operation's now_ns so virtual-time
        # callers get time-based cleanup too (time is an input, not ambient
        # state — unlike the reference, which seeds from SystemTime::now()).
        self._next_cleanup_ns: Optional[int] = None
        self._expired_count = 0

    @classmethod
    def with_capacity(cls, capacity: int) -> "PeriodicStore":
        return cls(capacity=capacity)

    @classmethod
    def builder(cls) -> "PeriodicStoreBuilder":
        return PeriodicStoreBuilder()

    def expired_count(self) -> int:
        return self._expired_count

    def _maybe_cleanup(self, now_ns: int) -> None:
        if self._next_cleanup_ns is None:
            self._next_cleanup_ns = now_ns + self.cleanup_interval_ns
            return
        if now_ns >= self._next_cleanup_ns:
            self._expired_count = self._sweep(now_ns)
            self._next_cleanup_ns = now_ns + self.cleanup_interval_ns


class PeriodicStoreBuilder:
    def __init__(self) -> None:
        self._capacity = DEFAULT_CAPACITY
        self._cleanup_interval_ns = DEFAULT_CLEANUP_INTERVAL_SECS * NS_PER_SEC

    def capacity(self, capacity: int) -> "PeriodicStoreBuilder":
        self._capacity = capacity
        return self

    def cleanup_interval(self, seconds: float) -> "PeriodicStoreBuilder":
        self._cleanup_interval_ns = int(seconds * NS_PER_SEC)
        return self

    def build(self) -> PeriodicStore:
        return PeriodicStore(self._capacity, self._cleanup_interval_ns)
