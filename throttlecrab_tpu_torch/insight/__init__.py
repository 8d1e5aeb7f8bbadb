"""Insight tier (L3.75): device-resident traffic analytics + feedback.

The port of `throttlecrab_tpu/insight/`.  Every decision window of an
insight table already updates device-resident accumulators (the per-slot
denied-hit column of the W=6 rows and the running [allowed, denied]
totals, `BucketTable.ins_counts`), so per-request accounting costs the
host nothing.  This tier is the host half:

  * **poll** (throttled, ~1/s, under the limiter lock): fetch the scalar
    totals, take the top-K of the denied column on the device
    (`kernel.insight_topk`, ties by lower slot as in the JAX package),
    map the hot slot ids back to key bytes through the keymap, and fold
    the per-slot deltas into a bounded space-saving sketch (sketch.py,
    shared with the metrics leaderboard);
  * **windowed rates**: cumulative totals sampled per poll turn into
    allowed/s / denied/s over a sliding window (collector.py);
  * **feedback loop**: confirmed hot-denied keys are prewarmed into the
    front tier's deny cache (refreshed to the back of its FIFO eviction
    queue), and the hot-set *concentration* — the share of recent
    denials landing on the device top-K — scales admission control's
    peek shedding (front/admission.py ``hot_shed_weight``);
  * **degraded-mode truth**: while the supervisor serves from the host
    oracle, the oracle feeds decisions here (``record_host_rows``), so
    ``GET /stats`` totals stay truthful across degrade and recovery.

Exposed through ``GET /stats`` (asyncio and native HTTP), the
``throttlecrab_tpu_insight_*`` gauges and the ``THROTTLECRAB_INSIGHT_*``
knobs.  A sharded mesh limiter is served the same way: its table
answers the poll with mesh-global totals and top-K, whose global slot
ids resolve through the per-shard keymaps (ShardedSlotKeyResolver), and
/stats gains its per-tenant counters.  The cluster's poll lock is not
part of the port yet.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from .collector import (
    NS_PER_SEC,
    RateWindow,
    ShardedSlotKeyResolver,
    SlotKeyResolver,
)
from .sketch import SpaceSavingSketch

__all__ = ["InsightTier", "SpaceSavingSketch"]

log = logging.getLogger("throttlecrab.insight")

#: /stats shows at most this many top denied keys.
STATS_TOP_N = 32

#: Smoothing for the hot-set concentration estimate (per poll).
_CONC_ALPHA = 0.5

#: Bound on the per-slot last-seen-count map (delta extraction between
#: polls): entries persist after a slot leaves the top-K so re-entry
#: diffs correctly; past the cap the coldest entries drop.
_SLOT_LAST_CAP = 65536


def _display_key(key) -> str:
    """Key bytes -> JSON-safe display string (256-character cap, like
    the metrics leaderboard's)."""
    if isinstance(key, (bytes, bytearray)):
        key = bytes(key).decode("utf-8", "replace")
    else:
        key = str(key)
    return key[:256]


class InsightTier:
    """Merges device insight partials; feeds /stats, metrics, and the
    front-tier feedback loop.  Thread-safe: its own lock guards host
    state; device fetches happen inside ``poll``, which callers run
    under the limiter lock (the engine's executor and the native driver
    thread both do)."""

    def __init__(
        self,
        limiter=None,
        sketch_capacity: int = 4096,
        topk: int = 64,
        window_s: float = 10.0,
        poll_ms: int = 1000,
        decay_s: float = 60.0,
        prewarm: int = 64,
        hot_denies: int = 100,
        shed_weight: float = 0.0,
        front=None,
    ) -> None:
        """`prewarm` caps the hot-denied keys refreshed into the deny
        cache per poll (0 disables the prewarm half); `hot_denies` is
        the sketch count at which a key counts as confirmed-hot;
        `shed_weight` scales admission peek-shedding by hot-set
        concentration (0 disables; wired onto front.admission).
        `decay_s` is the denied-column halving cadence (0 = never)."""
        self.topk = max(int(topk), 1)
        self.poll_ns = max(int(poll_ms), 1) * 1_000_000
        self.decay_ns = int(decay_s * NS_PER_SEC) if decay_s > 0 else 0
        self.prewarm = max(int(prewarm), 0)
        self.hot_denies = max(int(hot_denies), 1)
        self.shed_weight = float(shed_weight)
        self.front = front
        self._lock = threading.Lock()
        self.sketch = SpaceSavingSketch(sketch_capacity)
        self._window = RateWindow(window_s)
        self.limiter = None
        self._resolver = None
        # Per-slot last-seen denied counts (delta extraction between
        # polls; halved alongside the device column on decay).  Keyed by
        # the resolver's slot-id encoding: when that re-bases (sharded
        # table growth), the map resets rather than diffing new ids
        # against stale entries.
        self._slot_last: dict = {}
        self._slot_id_base = None
        # Device totals (last fetched) + host-oracle counters: the sum
        # is the truthful all-paths total across degrade/recover.
        self._dev_allowed = 0
        self._dev_denied = 0
        self._host_allowed = 0
        self._host_denied = 0
        # Denials served straight from the deny cache (no launch): the
        # hottest traffic by design — /stats totals must include it.
        self._front_denied = 0
        self._last_poll_ns: Optional[int] = None
        self._last_decay_ns: Optional[int] = None
        self.hot_concentration = 0.0
        self.polls = 0
        self.poll_failures = 0
        self.prewarmed_total = 0
        if front is not None:
            # Cache-served denials report back here (FrontTier.lookup /
            # lookup_window), so /stats totals stay truthful when the
            # deny cache absorbs the abuse traffic.
            front.insight = self
            if front.admission is not None:
                front.admission.hot_shed_weight = self.shed_weight
        if limiter is not None:
            self.attach(limiter)

    # ------------------------------------------------------------------ #

    def attach(self, limiter) -> None:
        """Bind the DEVICE limiter (a supervision wrapper is unwrapped:
        polls read the device table and keymap directly).  The sharded
        mesh limiter qualifies too: its table answers the same poll
        surface with mesh-global results, and its GLOBAL slot ids
        resolve through the per-shard keymaps."""
        dev = getattr(limiter, "inner", limiter)
        table = getattr(dev, "table", None)
        if table is None or not getattr(table, "insight", False):
            raise ValueError(
                "insight tier needs a device limiter whose table was "
                "built with insight enabled"
            )
        self.limiter = dev
        if hasattr(dev, "keymaps"):
            self._resolver = ShardedSlotKeyResolver(dev)
        else:
            self._resolver = SlotKeyResolver(dev.keymap)
        self._slot_last = {}
        # Pin the slot-id encoding base now, so only a LATER re-base
        # (sharded growth) triggers the baseline-only poll.
        id_base_fn = getattr(self._resolver, "id_base", None)
        self._slot_id_base = (
            id_base_fn() if id_base_fn is not None else None
        )

    # ------------------------------------------------------------------ #

    def prime(self) -> None:
        """Run the poll's device ops once at boot (totals fetch, top-K,
        decay), so their first-call costs are not paid inside a serving
        flush under the limiter lock.  Decay on all-zero counters is a
        numeric no-op, so priming never perturbs state."""
        if self.limiter is None:
            return
        table = self.limiter.table
        table.insight_counts()
        tk = table.insight_topk(self.topk)
        if tk is not None:
            tk[0].cpu()
            tk[1].cpu()
        if self.decay_ns:
            table.insight_decay()

    def poll_due(self, now_ns: int) -> bool:
        last = self._last_poll_ns
        return last is None or now_ns - last >= self.poll_ns

    def maybe_poll(self, now_ns: int, limiter_lock=None) -> bool:
        """Throttled poll; pass the caller's limiter lock to serialize
        the device fetch against launches (callers already holding it
        pass nothing)."""
        if self.limiter is None or not self.poll_due(now_ns):
            return False
        if limiter_lock is not None:
            with limiter_lock:
                return self.poll(now_ns)
        return self.poll(now_ns)

    def poll(self, now_ns: int) -> bool:
        """Fetch the device partials and merge (call under the limiter
        lock).  A dead device (mid-outage poll) only marks a failure —
        host counters keep /stats truthful until recovery."""
        with self._lock:
            if not self.poll_due(now_ns):
                return False
            self._last_poll_ns = now_ns
            self.polls += 1
        table = self.limiter.table
        try:
            allowed, denied = table.insight_counts()
            decay_due = (
                self.decay_ns
                and (
                    self._last_decay_ns is None
                    or now_ns - self._last_decay_ns >= self.decay_ns
                )
            )
            tk = table.insight_topk(self.topk)
            vals = tk[0].tolist()
            ids = tk[1].tolist()
            if decay_due:
                table.insight_decay()
                self._last_decay_ns = now_ns
            # The keymap read rides the same limiter-lock hold as the
            # fetch, so slot->key attribution cannot race a sweep.
            keys = self._resolver.keys_for(ids)
        except Exception:
            log.debug("insight device poll failed", exc_info=True)
            with self._lock:
                self.poll_failures += 1
                self._window.sample(now_ns, *self._totals_locked())
            return True
        hot_keys = []
        with self._lock:
            # Growth re-based the global slot ids (sharded mesh): a stale
            # delta map would re-record hot slots' whole cumulative counts
            # under their new ids.  Re-baseline this poll WITHOUT
            # recording: its inter-poll deltas are unknowable per slot,
            # so the sketch under-counts once instead of counting whole
            # histories twice (totals, rates and /stats counters come
            # from the device totals, not the sketch).
            id_base_fn = getattr(self._resolver, "id_base", None)
            id_base = id_base_fn() if id_base_fn is not None else None
            rebased = id_base != self._slot_id_base
            if rebased:
                self._slot_id_base = id_base
                self._slot_last = {}
            # The concentration denominator is the ENGINE-decided denial
            # delta (device + host oracle), excluding cache-served
            # denials: it measures how concentrated the traffic that
            # still reaches the engine is.
            prev_denied_total = self._dev_denied + self._host_denied
            self._dev_allowed = allowed
            self._dev_denied = denied
            # Carry last-seen counts forward for slots OUTSIDE this
            # poll's top-K too: a slot that drops out and later re-enters
            # must diff against its old value, or its whole cumulative
            # count would be recorded into the sketch twice.
            slot_last = self._slot_last
            new_last = dict(slot_last)
            top_delta = 0
            for slot, val, key in zip(ids, vals, keys):
                if val <= 0:
                    continue
                if rebased:
                    # Baseline-only pass after an id re-base.
                    new_last[slot] = val
                    continue
                prev = slot_last.get(slot, 0)
                # A count below last-seen means the slot was swept (or
                # the column decayed): the delta restarts from zero.
                delta = val - prev if val >= prev else val
                new_last[slot] = val
                if delta > 0:
                    top_delta += delta
                    if key is not None:
                        self.sketch.record(key, delta)
            if decay_due:
                new_last = {s: v // 2 for s, v in new_last.items()}
            if len(new_last) > _SLOT_LAST_CAP:
                # Keep the hottest entries — they are the ones likely to
                # re-enter the top-K (an evicted slot that returns
                # re-records its full count once; bounded damage).
                new_last = dict(
                    sorted(new_last.items(), key=lambda kv: -kv[1])[
                        :_SLOT_LAST_CAP
                    ]
                )
            self._slot_last = new_last
            denied_total = self._dev_denied + self._host_denied
            denied_delta = denied_total - prev_denied_total
            if denied_delta > 0:
                conc = min(top_delta / denied_delta, 1.0)
                self.hot_concentration += _CONC_ALPHA * (
                    conc - self.hot_concentration
                )
            self._window.sample(now_ns, *self._totals_locked())
            if self.prewarm and self.front is not None:
                hot_keys = [
                    k
                    for k, c in self.sketch.top(self.prewarm)
                    if c >= self.hot_denies
                ]
        front = self.front
        if front is not None:
            if hot_keys:
                # Feedback half 1: refresh confirmed hot-denied keys to
                # the back of the deny cache's eviction queue.
                n = front.prewarm(hot_keys)
                with self._lock:
                    self.prewarmed_total += n
            if front.admission is not None:
                # Feedback half 2: concentrated abuse sheds peek probes
                # earlier (weight 0 = the unweighted behavior).
                front.admission.set_hot_concentration(self.hot_concentration)
        return True

    # ------------------------------------------------------------------ #

    def record_host_rows(self, keys, allowed_flags) -> None:
        """Degraded-mode accounting: one decided host-oracle batch's OK
        rows, in arrival order (keys already limiter-normalized)."""
        with self._lock:
            for key, allowed in zip(keys, allowed_flags):
                if allowed:
                    self._host_allowed += 1
                else:
                    self._host_denied += 1
                    self.sketch.record(key, 1)

    def record_front_denied(self, keys) -> None:
        """Deny-cache-served denials (no device launch), keys normalized:
        counted into totals and the hot-key sketch so the cache
        absorbing an attack doesn't hide it from /stats."""
        with self._lock:
            for key in keys:
                self._front_denied += 1
                self.sketch.record(key, 1)

    def _totals_locked(self) -> tuple:
        """(allowed, denied) across every serving path: device
        accumulators + degraded-mode host oracle + deny-cache hits."""
        return (
            self._dev_allowed + self._host_allowed,
            self._dev_denied + self._host_denied + self._front_denied,
        )

    # ------------------------------------------------------------------ #

    def stats(self, state: Optional[str] = None) -> dict:
        """The GET /stats document."""
        with self._lock:
            allowed, denied = self._totals_locked()
            total = allowed + denied
            allowed_rate, denied_rate = self._window.rates()
            top = [
                {"key": _display_key(k), "count": c, "error": e}
                for k, c, e in self.sketch.top_with_error(STATS_TOP_N)
            ]
            out = {
                "insight": {
                    "enabled": True,
                    "polls": self.polls,
                    "poll_failures": self.poll_failures,
                },
                "totals": {
                    "allowed": allowed,
                    "denied": denied,
                    "deny_rate": round(denied / total, 6) if total else 0.0,
                },
                "host_path": {
                    "allowed": self._host_allowed,
                    "denied": self._host_denied,
                },
                "front_path": {
                    "denied": self._front_denied,
                },
                "window": {
                    "seconds": self._window.window_ns / NS_PER_SEC,
                    "allowed_per_s": round(allowed_rate, 3),
                    "denied_per_s": round(denied_rate, 3),
                },
                "top_denied": top,
                "hot": {
                    "concentration": round(self.hot_concentration, 6),
                    "tracked_keys": len(self.sketch),
                    "sketch_error_bound": self.sketch.error_bound,
                    "prewarmed_total": self.prewarmed_total,
                },
            }
        # Per-tenant dimensions (the sharded limiter's namespace layer,
        # parallel/tenants.py): mesh-global counters summed from every
        # window, so /stats answers per tenant with no host-side
        # per-request accounting.
        tenant_stats = getattr(self.limiter, "tenant_stats", None)
        if tenant_stats is not None:
            tenants = tenant_stats()
            if tenants:
                out["tenants"] = tenants
        if state is not None:
            out["engine_state"] = state
        return out

    def stats_json(self, state: Optional[str] = None) -> str:
        return json.dumps(self.stats(state=state))

    def metric_stats(self) -> dict:
        """Gauge snapshot for the Prometheus exporter
        (Metrics.set_insight_stats_provider)."""
        with self._lock:
            allowed_rate, denied_rate = self._window.rates()
            return {
                "allowed_rate": round(allowed_rate, 3),
                "denied_rate": round(denied_rate, 3),
                "hot_concentration": round(self.hot_concentration, 6),
                "tracked_keys": len(self.sketch),
                "prewarmed_total": self.prewarmed_total,
                "polls": self.polls,
            }
