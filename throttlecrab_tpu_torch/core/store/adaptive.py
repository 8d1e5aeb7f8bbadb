"""AdaptiveStore: self-tuning cleanup intervals.

Semantics per `throttlecrab/src/core/store/adaptive_cleanup.rs`:

Triggers (`should_clean`, `adaptive_cleanup.rs:138-171`):
  1. time      — now >= next_cleanup
  2. ops count — operations_since_cleanup >= max_operations (default 100 000)
  3. expired % — expired_count > 50 AND expired_ratio > dynamic threshold
                 (10% if the last sweep was productive, else 25%)
  4. pressure  — map len > 3/4 of its capacity

After a sweep (`cleanup`, `adaptive_cleanup.rs:173-203`) the interval doubles
(capped at max_interval, default 300 s) when nothing was removed, and halves
(floored at min_interval, default 1 s) when more than half the entries were
removed.
"""

from __future__ import annotations

from typing import Optional

from ..i64 import NS_PER_SEC
from .mapstore import MapStore

DEFAULT_CAPACITY = 1000
CAPACITY_OVERHEAD_FACTOR = 1.3
MIN_CLEANUP_INTERVAL_SECS = 1
MAX_CLEANUP_INTERVAL_SECS = 300
DEFAULT_CLEANUP_INTERVAL_SECS = 5
MAX_OPERATIONS_BEFORE_CLEANUP = 100_000
EXPIRED_RATIO_THRESHOLD = 0.2


class AdaptiveStore(MapStore):
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        min_interval_ns: int = MIN_CLEANUP_INTERVAL_SECS * NS_PER_SEC,
        max_interval_ns: int = MAX_CLEANUP_INTERVAL_SECS * NS_PER_SEC,
        max_operations: int = MAX_OPERATIONS_BEFORE_CLEANUP,
    ) -> None:
        super().__init__()
        # The Rust HashMap is allocated with a 1.3x overhead factor; the
        # pressure trigger compares against that allocated capacity.
        self.capacity = int(capacity * CAPACITY_OVERHEAD_FACTOR)
        self.min_interval_ns = min_interval_ns
        self.max_interval_ns = max_interval_ns
        self.max_operations = max_operations
        self.current_interval_ns = DEFAULT_CLEANUP_INTERVAL_SECS * NS_PER_SEC
        # Lazily seeded from the first operation's now_ns (see periodic.py).
        self._next_cleanup_ns: Optional[int] = None
        self._expired_count = 0
        self._operations_since_cleanup = 0
        self._last_cleanup_removed = 0
        self._last_cleanup_total = 0

    @classmethod
    def with_capacity(cls, capacity: int) -> "AdaptiveStore":
        return cls(capacity=capacity)

    @classmethod
    def builder(cls) -> "AdaptiveStoreBuilder":
        return AdaptiveStoreBuilder()

    def expired_count(self) -> int:
        return self._expired_count

    def _should_clean(self, now_ns: int) -> bool:
        if now_ns >= self._next_cleanup_ns:  # type: ignore[operator]
            return True
        if self._operations_since_cleanup >= self.max_operations:
            return True
        if self._expired_count > 50:
            expired_ratio = self._expired_count / max(len(self._data), 1)
            if self._last_cleanup_removed > self._last_cleanup_total // 4:
                threshold = EXPIRED_RATIO_THRESHOLD / 2.0
            else:
                threshold = EXPIRED_RATIO_THRESHOLD * 1.25
            if expired_ratio > threshold:
                return True
        if len(self._data) > self.capacity * 3 // 4:
            return True
        return False

    def _cleanup(self, now_ns: int) -> None:
        initial_len = len(self._data)
        removed = self._sweep(now_ns)
        if removed == 0 and self._expired_count == 0:
            self.current_interval_ns = min(
                self.current_interval_ns * 2, self.max_interval_ns
            )
        elif removed > initial_len * 0.5:
            self.current_interval_ns = max(
                self.current_interval_ns // 2, self.min_interval_ns
            )
        self._last_cleanup_removed = removed
        self._last_cleanup_total = initial_len
        self._next_cleanup_ns = now_ns + self.current_interval_ns
        self._expired_count = 0
        self._operations_since_cleanup = 0
        # The reference's pressure trigger compares against the Rust
        # HashMap's *allocated* capacity, which grows as the map grows —
        # making pressure sweeps transient.  Python dicts don't expose
        # capacity, so emulate reallocation: if the map is still above the
        # pressure threshold after sweeping, the "allocation" doubles.
        if len(self._data) > self.capacity * 3 // 4:
            self.capacity *= 2

    def _maybe_cleanup(self, now_ns: int) -> None:
        if self._next_cleanup_ns is None:
            self._next_cleanup_ns = now_ns + self.current_interval_ns
        self._operations_since_cleanup += 1
        if self._should_clean(now_ns):
            self._cleanup(now_ns)

    def _on_expired_hit(self) -> None:
        self._expired_count += 1

    def _on_expired_hit_set(self) -> None:
        self._expired_count += 1


class AdaptiveStoreBuilder:
    def __init__(self) -> None:
        self._capacity = DEFAULT_CAPACITY
        self._min_interval_ns = MIN_CLEANUP_INTERVAL_SECS * NS_PER_SEC
        self._max_interval_ns = MAX_CLEANUP_INTERVAL_SECS * NS_PER_SEC
        self._max_operations = MAX_OPERATIONS_BEFORE_CLEANUP

    def capacity(self, capacity: int) -> "AdaptiveStoreBuilder":
        self._capacity = capacity
        return self

    def min_interval(self, seconds: float) -> "AdaptiveStoreBuilder":
        self._min_interval_ns = int(seconds * NS_PER_SEC)
        return self

    def max_interval(self, seconds: float) -> "AdaptiveStoreBuilder":
        self._max_interval_ns = int(seconds * NS_PER_SEC)
        return self

    def max_operations(self, n: int) -> "AdaptiveStoreBuilder":
        self._max_operations = n
        return self

    def build(self) -> AdaptiveStore:
        return AdaptiveStore(
            self._capacity,
            self._min_interval_ns,
            self._max_interval_ns,
            self._max_operations,
        )
