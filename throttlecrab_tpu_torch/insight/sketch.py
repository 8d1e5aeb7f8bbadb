"""Bounded heavy-hitter counting: a space-saving sketch.

The port's copy of `throttlecrab_tpu/insight/sketch.py`.  Its consumers
are the metrics leaderboard (`server/metrics.py`
`throttlecrab_top_denied_keys`) and the insight tier's hot-key tracking
(`insight/`).  The reference's metrics.rs
tracker is an unbounded dict with amortized grow-then-prune; that shape
is kept (grow to 3x capacity, then compact to capacity) but the
compaction now records the largest dropped count as a *floor*, turning
the ad-hoc prune into a proper space-saving summary (Metwally et al.,
"Efficient computation of frequent and top-k elements in data
streams"): a key that (re-)enters after a compaction starts at
``floor + count`` with ``error = floor``, so every estimate carries the
guarantee

    estimate - error  <=  true count  <=  estimate

While the distinct-key population stays within ``capacity`` the floor
never rises and every count is exact — byte-identical to the old dict
tracker, which is the regime the 10k-key metrics leaderboard runs in.

Memory is bounded at 3x capacity entries; ``record`` is amortized O(1)
(one dict probe, with an O(n log n) compaction every >= 2x capacity
insertions).  Not thread-safe — callers hold their own lock (the
metrics object and the insight tier both already do).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class SpaceSavingSketch:
    """Bounded top-k counter with per-key overestimation error."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("sketch capacity must be positive")
        self.capacity = capacity
        self._counts: Dict[object, int] = {}
        self._errors: Dict[object, int] = {}
        # Largest count ever dropped by a compaction: the overestimation
        # floor every later insertion inherits.
        self._floor = 0
        self.compactions = 0

    def __len__(self) -> int:
        return len(self._counts)

    @property
    def error_bound(self) -> int:
        """Max overestimation any entry can carry (0 = all exact)."""
        return self._floor

    @property
    def counts(self) -> Dict[object, int]:
        """The live estimate map (read-only by convention)."""
        return self._counts

    def record(self, key, count: int = 1) -> None:
        """Fold `count` observations of `key` into the summary."""
        if count <= 0:
            return
        cur = self._counts.get(key)
        if cur is not None:
            self._counts[key] = cur + count
            return
        # New key: space-saving overestimate — it may have been dropped
        # with up to `floor` observations by an earlier compaction.
        self._counts[key] = self._floor + count
        if self._floor:
            self._errors[key] = self._floor
        if len(self._counts) > self.capacity * 3:
            self._compact()

    def _compact(self) -> None:
        items = sorted(self._counts.items(), key=lambda kv: -kv[1])
        kept = items[: self.capacity]
        # The largest dropped estimate bounds every dropped key's true
        # count (estimates never under-count), so it is the new floor.
        self._floor = max(self._floor, items[self.capacity][1])
        self._counts = dict(kept)
        self._errors = {
            k: e for k, e in self._errors.items() if k in self._counts
        }
        self.compactions += 1

    def top(self, n: int) -> List[Tuple[object, int]]:
        """Top-n (key, estimate), highest first — ties keep insertion
        order (stable sort over dict order), matching the old metrics
        tracker's export order exactly."""
        return sorted(self._counts.items(), key=lambda kv: -kv[1])[:n]

    def top_with_error(self, n: int) -> List[Tuple[object, int, int]]:
        """Top-n (key, estimate, error): true count is certified inside
        [estimate - error, estimate]."""
        return [
            (k, c, self._errors.get(k, 0)) for k, c in self.top(n)
        ]

    def clear(self) -> None:
        self._counts.clear()
        self._errors.clear()
        self._floor = 0
