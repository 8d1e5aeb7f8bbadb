"""Host-side helpers for merging device insight partials.

The port's copy of `throttlecrab_tpu/insight/collector.py`.  The device
hands the insight tier slot-indexed partials (the denied-hit top-K and
the running [allowed, denied] totals); this module supplies the two host
structures that turn them into key-indexed, time-windowed facts: a
slot->key resolver over the limiter's keymap and a windowed rate tracker.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

NS_PER_SEC = 1_000_000_000


class SlotKeyResolver:
    """slot id -> key, against the limiter's live keymap.

    The python keymap exposes its reverse column directly (O(1) per
    slot); the native keymap only exports (key, slot) pairs wholesale, so
    its reverse map is cached and pinned by the keymap's ``mutations``
    counter — the same staleness stamp the by-id launch rows use — and
    rebuilt only after a sweep/growth actually remapped slots.  Callers
    must hold the limiter lock so the map cannot mutate mid-resolution.
    """

    def __init__(self, keymap) -> None:
        self.keymap = keymap
        self._cache: Optional[dict] = None
        self._stamp = -1

    def keys_for(self, slots) -> List[Optional[object]]:
        km = self.keymap
        rev = getattr(km, "_rev", None)
        if rev is not None:
            n = len(rev)
            return [rev[s] if 0 <= s < n else None for s in slots]
        stamp = getattr(km, "mutations", 0)
        if self._cache is None or stamp != self._stamp:
            self._cache = {slot: key for key, slot in km.items()}
            self._stamp = stamp
        get = self._cache.get
        return [get(s) for s in slots]


class RateWindow:
    """Windowed request rates from cumulative-total samples.

    ``sample(now_ns, allowed, denied)`` feeds one poll's cumulative
    totals; ``rates()`` answers (allowed/s, denied/s) over the retained
    window.  Totals are monotone by construction (device accumulators +
    host counters only ever grow), so rates are never negative.
    """

    def __init__(self, window_s: float) -> None:
        self.window_ns = max(int(window_s * NS_PER_SEC), 1)
        self._samples: deque = deque()  # (t_ns, allowed, denied)

    def sample(self, now_ns: int, allowed: int, denied: int) -> None:
        samples = self._samples
        if samples and now_ns < samples[-1][0]:
            # Clock regression (virtual-time tests, NTP steps): restart
            # the window rather than emit garbage spans.
            samples.clear()
        samples.append((now_ns, allowed, denied))
        # Keep one sample at or beyond the window edge as the baseline.
        while len(samples) >= 2 and samples[1][0] <= now_ns - self.window_ns:
            samples.popleft()

    def rates(self) -> tuple:
        samples = self._samples
        if len(samples) < 2:
            return 0.0, 0.0
        t0, a0, d0 = samples[0]
        t1, a1, d1 = samples[-1]
        span_s = (t1 - t0) / NS_PER_SEC
        if span_s <= 0:
            return 0.0, 0.0
        return (a1 - a0) / span_s, (d1 - d0) / span_s


class ShardedSlotKeyResolver:
    """GLOBAL slot id -> key over a sharded limiter's per-shard keymaps.

    The mesh top-K (parallel/sharded.py ShardedBucketTable.insight_topk)
    reports global ids ``shard * capacity_per_shard + local_slot``; this
    decodes them against the LIVE per-shard capacity and resolves each
    shard's slots through a plain SlotKeyResolver, so the native
    keymap's mutation-pinned reverse-map cache is reused per shard.
    Table growth re-bases the id encoding — ``id_base()`` exposes the
    live base so the insight tier can reset its per-slot delta map
    instead of diffing new ids against stale ones.  Callers must hold
    the limiter lock, like the single-device form.
    """

    def __init__(self, limiter) -> None:
        self._table = limiter.table
        self._per_shard = [SlotKeyResolver(km) for km in limiter.keymaps]

    def id_base(self):
        """The encoding base of the global slot ids; changes exactly
        when growth re-bases them (InsightTier resets its delta map)."""
        return self._table.capacity

    def keys_for(self, slots) -> List[Optional[object]]:
        cap = self._table.capacity
        n_shards = len(self._per_shard)
        out: List[Optional[object]] = [None] * len(slots)
        for i, gid in enumerate(slots):
            d, slot = divmod(int(gid), cap)
            if 0 <= d < n_shards:
                out[i] = self._per_shard[d].keys_for([slot])[0]
        return out
