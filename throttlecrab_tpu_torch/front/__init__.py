"""Front tier (L3.5): exact deny cache + admission control.

The port of `throttlecrab_tpu/front/` (plain Python integers under one
lock; no device code).  Its deny cache certifies entries from the
decision-window kernel's `cur` output tier (`result.cur_ns`).

Sits between the transports (L4) and the batching engine (L3).  Under
abuse/hot-key traffic — the exact scenario rate limiters exist for —
most requests are denials, and GCRA's exact `retry_after` makes those
denials *provably* answerable without a device round trip (deny_cache).
Under overload, bounded shedding with two priority classes replaces the
engine's unbounded future queue (admission).  The worst-case traffic
becomes the cheapest traffic.

One FrontTier instance is shared by every transport driving the same
limiter (the asyncio engine and the native C++ wire drivers), so an
allowed decision on any transport invalidates cached denials for all of
them.  All methods are thread-safe.

Key identity matches the limiter's keymap (`bytes_keys`): the cache
normalizes str/bytes exactly like the transports do, so one client key
is one cache row no matter which wire it arrived on.
"""

from __future__ import annotations

from .admission import (  # noqa: F401  (re-exported API)
    OVERLOAD_MESSAGE,
    STATUS_OVERLOADED,
    AdmissionController,
    OverloadError,
)
from .deny_cache import DenyCache, DenyHit  # noqa: F401


class FrontTier:
    """Facade combining the deny cache and the admission controller."""

    def __init__(self, deny_cache=None, admission=None, metrics=None,
                 bytes_keys: bool = False) -> None:
        self.deny_cache = deny_cache
        self.admission = admission
        self.metrics = metrics
        self.bytes_keys = bytes_keys
        # Insight tier (L3.75), when attached: cache-served denials are
        # reported there so /stats totals cover every served denial,
        # not just device-decided ones.
        self.insight = None

    # ------------------------------------------------------------------ #

    def _norm_key(self, key):
        """Match the limiter keymap's key identity (one client key, one
        bucket, one cache row across str- and bytes-keyed transports).
        Returns None for keys the limiter itself cannot encode."""
        if self.bytes_keys:
            if isinstance(key, str):
                try:
                    return key.encode()
                except UnicodeEncodeError:
                    return None
            return key
        if isinstance(key, (bytes, bytearray)):
            return bytes(key).decode("utf-8", "surrogateescape")
        return key

    # ------------------------------------------------------------------ #

    def lookup(self, key, max_burst, count_per_period, period, quantity,
               now_ns):
        """Exact cached denial for this request, or None."""
        if self.deny_cache is None:
            return None
        k = self._norm_key(key)
        if k is None:
            return None
        stale_before = self.deny_cache.stale_evictions
        hit = self.deny_cache.lookup(
            k, max_burst, count_per_period, period, quantity, now_ns
        )
        self._flush_stale(stale_before)
        if hit is not None:
            if self.metrics is not None:
                self.metrics.record_front_hit()
            if self.insight is not None:
                self.insight.record_front_denied((k,))
        return hit

    def admit(self, depth: int, peek: bool) -> bool:
        if self.admission is None:
            return True
        ok = self.admission.admit(depth, peek)
        if not ok and self.metrics is not None:
            self.metrics.record_front_shed(peek)
        return ok

    def record_launch(self, n_requests: int, elapsed_s: float) -> None:
        if self.admission is not None:
            self.admission.record_launch(n_requests, elapsed_s)

    # ------------------------------------------------------------------ #

    def next_seq(self) -> int:
        # NB: `is not None`, not truthiness — DenyCache.__len__ makes an
        # *empty* cache falsy, and seq must advance from the first launch.
        if self.deny_cache is None:
            return 0
        return self.deny_cache.next_seq()

    def begin_inflight(self, key) -> None:
        if self.deny_cache is not None:
            k = self._norm_key(key)
            if k is not None:
                self.deny_cache.begin_inflight(k)

    def end_inflight(self, key) -> None:
        if self.deny_cache is not None:
            k = self._norm_key(key)
            if k is not None:
                self.deny_cache.end_inflight(k)

    def lookup_window(self, keys, max_burst, count_per_period, period,
                      quantity, now_ns, mark_inflight: bool = True):
        """Bulk exact-denial lookup for one shared-timestamp window
        (DenyCache.lookup_window); keys must already be normalized to
        the limiter's key identity (the native driver's are).  Returns
        (rows, n_hits); missing keys are marked in-flight when
        `mark_inflight` — release them via observe_window."""
        if self.deny_cache is None:
            return [None] * len(keys), 0
        stale_before = self.deny_cache.stale_evictions
        rows, n_hits = self.deny_cache.lookup_window(
            keys, max_burst, count_per_period, period, quantity, now_ns,
            mark_inflight=mark_inflight,
        )
        self._flush_stale(stale_before)
        if n_hits:
            if self.metrics is not None:
                self.metrics.record_front_hits(n_hits)
            if self.insight is not None:
                self.insight.record_front_denied(
                    k for k, r in zip(keys, rows) if r is not None
                )
        return rows, n_hits

    def observe_window(self, rows, now_ns, seq) -> None:
        """Bulk observe + in-flight release for one decided window
        (DenyCache.observe_window); rows are (key, mb, cpp, period, q,
        allowed, cur_ns) in arrival order, keys pre-normalized."""
        if self.deny_cache is None:
            return
        stale_before = self.deny_cache.stale_evictions
        self.deny_cache.observe_window(rows, now_ns, seq)
        self._flush_stale(stale_before)

    def release_window(self, keys) -> None:
        """Release in-flight holds for rows that never reached a launch
        (shed rows)."""
        if self.deny_cache is not None:
            self.deny_cache.release_window(keys)

    def fail_window(self, keys) -> None:
        """A launch failed after its writes may have committed: release
        the rows' holds and conservatively drop their keys' cached
        denials and write records (keys may be unnormalized)."""
        if self.deny_cache is None:
            return
        norm = []
        for key in keys:
            k = self._norm_key(key)
            if k is not None:
                norm.append(k)
        self.deny_cache.fail_window(norm)

    def observe(self, key, max_burst, count_per_period, period, quantity,
                now_ns, allowed, seq, cur_ns=None, reset_after_ns=None,
                retry_after_ns=None) -> None:
        if self.deny_cache is None:
            return
        k = self._norm_key(key)
        if k is None:
            return
        stale_before = self.deny_cache.stale_evictions
        self.deny_cache.observe(
            k, max_burst, count_per_period, period, quantity, now_ns,
            allowed, seq, cur_ns=cur_ns, reset_after_ns=reset_after_ns,
            retry_after_ns=retry_after_ns,
        )
        self._flush_stale(stale_before)

    def prewarm(self, keys) -> int:
        """Insight-tier feedback: refresh confirmed hot-denied keys to
        the back of the deny cache's eviction queues (nothing is
        created — exactness is untouched).  Keys may be unnormalized;
        returns the number of keys actually refreshed."""
        if self.deny_cache is None:
            return 0
        norm = []
        for key in keys:
            k = self._norm_key(key)
            if k is not None:
                norm.append(k)
        if not norm:
            return 0
        return self.deny_cache.prewarm(norm)

    def on_sweep(self, now_ns: int) -> None:
        if self.deny_cache is None:
            return
        n = self.deny_cache.on_sweep(now_ns)
        if n and self.metrics is not None:
            self.metrics.record_front_stale(n)

    def on_restore(self) -> None:
        """A snapshot restore rewrote bucket state: drop everything."""
        if self.deny_cache is not None:
            self.deny_cache.clear()

    def _flush_stale(self, before: int) -> None:
        if self.metrics is not None:
            delta = self.deny_cache.stale_evictions - before
            if delta:
                self.metrics.record_front_stale(delta)

    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Gauge snapshot for the metrics exporter."""
        out = {"deny_cache_size": 0}
        if self.deny_cache is not None:
            out["deny_cache_size"] = len(self.deny_cache)
        return out
