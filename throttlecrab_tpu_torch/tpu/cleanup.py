"""Cleanup policies: when to run the expiry-compaction sweep.

The reference couples cleanup policy to its three store types
(`periodic.rs:128-142`, `adaptive_cleanup.rs:138-203`,
`probabilistic.rs:110-125`); here the sweep itself is one tensor mask over
the expiry column (kernel.sweep_expired) and the policy is a host object the
engine consults between batches.  The trigger/adaptation rules are preserved
verbatim, including the adaptive expired-ratio trigger: the per-op expired
hits the Rust store counted inline (`adaptive_cleanup.rs:233,267`) are
counted by the kernel itself (a device-resident accumulator riding every
launch, kernel.gcra_*_acc) and drained to the policy via
`record_expired` — fetched at most once per second, the policy's own
minimum interval, since its triggers have no sub-second semantics.

Policies are consulted with *batches* of operations (the engine processes
thousands of requests per step), so the probabilistic fire-check covers the
whole operation-count range at once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.i64 import NS_PER_SEC

DEFAULT_CLEANUP_INTERVAL_SECS = 60
MIN_CLEANUP_INTERVAL_SECS = 1
MAX_CLEANUP_INTERVAL_SECS = 300
ADAPTIVE_DEFAULT_INTERVAL_SECS = 5
MAX_OPERATIONS_BEFORE_CLEANUP = 100_000
EXPIRED_RATIO_THRESHOLD = 0.2  # adaptive_cleanup.rs:16
# Ratio trigger floor — EXCLUSIVE bound, `expired_count > 50` verbatim
# (adaptive_cleanup.rs:150): exactly 50 hits never triggers.
MIN_EXPIRED_FOR_RATIO = 50
PROBABILISTIC_CLEANUP_MODULO = 1000
_PRIME = 2654435761


class CleanupPolicy:
    """Decides when the engine should sweep; see subclasses."""

    #: True when the policy consumes the expired-hit signal — the engine
    #: only pays the (throttled) device read for policies that want it.
    uses_expired_signal = False

    def record_ops(self, n: int) -> None:
        """Account `n` processed requests."""

    def record_expired(self, n: int) -> None:
        """Account `n` requests that landed on expired entries."""

    def should_clean(self, now_ns: int, live_keys: int, capacity: int) -> bool:
        raise NotImplementedError

    def after_sweep(self, now_ns: int, removed: int, total_before: int) -> None:
        """Observe a sweep's yield (for self-tuning policies)."""


class PeriodicPolicy(CleanupPolicy):
    """Fixed-interval sweeps (periodic.rs:128-142); default 60 s."""

    def __init__(
        self, interval_ns: int = DEFAULT_CLEANUP_INTERVAL_SECS * NS_PER_SEC
    ) -> None:
        self.interval_ns = interval_ns
        self._next_ns: Optional[int] = None

    def should_clean(self, now_ns, live_keys, capacity):
        if self._next_ns is None:
            self._next_ns = now_ns + self.interval_ns
            return False
        return now_ns >= self._next_ns

    def after_sweep(self, now_ns, removed, total_before):
        self._next_ns = now_ns + self.interval_ns


class ProbabilisticPolicy(CleanupPolicy):
    """Deterministic sampled sweeps (probabilistic.rs:110-125).

    The per-op rule fires when `(ops * 2654435761 mod 2^64) % p == 0`; over a
    batch of n ops the policy fires iff any op count in (prev, prev + n]
    satisfies it — checked exactly with a vectorized wrapping multiply (the
    u64 wrap makes the rule aperiodic past ops ≈ 6.9e9, so no divisor
    shortcut is valid).
    """

    def __init__(self, probability: int = PROBABILISTIC_CLEANUP_MODULO) -> None:
        self.probability = probability
        self._ops = 0
        self._fire = False

    def record_ops(self, n):
        prev = self._ops
        self._ops += n
        # probability 0 never fires (Rust is_multiple_of(0) ⇔ hash == 0,
        # unreachable for the odd-prime product with ops < 2^64).
        if self.probability <= 0 or self._fire or n <= 0:
            return
        ops = np.arange(prev + 1, prev + n + 1, dtype=np.uint64)
        hashed = ops * np.uint64(_PRIME)  # wraps mod 2^64
        if (hashed % np.uint64(self.probability) == 0).any():
            self._fire = True

    def should_clean(self, now_ns, live_keys, capacity):
        return self._fire

    def after_sweep(self, now_ns, removed, total_before):
        self._fire = False


class AdaptivePolicy(CleanupPolicy):
    """Self-tuning sweeps (adaptive_cleanup.rs:138-203).

    Triggers, in the reference's order: time >= next_cleanup; ops since
    last sweep >= max_operations; expired-hit ratio above a dynamic
    threshold (STRICTLY more than 50 hits — `expired_count > 50`,
    adaptive_cleanup.rs:150 — and hits/keys over 10 % after a
    productive sweep, i.e. the last sweep removed over a quarter of the
    table, else 25 %); or keys above 3/4 of table capacity.
    After each sweep the interval doubles (nothing removed and no
    expired hits seen) or halves (over half removed), clamped to
    [min_interval, max_interval].
    """

    uses_expired_signal = True

    def __init__(
        self,
        min_interval_ns: int = MIN_CLEANUP_INTERVAL_SECS * NS_PER_SEC,
        max_interval_ns: int = MAX_CLEANUP_INTERVAL_SECS * NS_PER_SEC,
        max_operations: int = MAX_OPERATIONS_BEFORE_CLEANUP,
    ) -> None:
        self.min_interval_ns = min_interval_ns
        self.max_interval_ns = max_interval_ns
        self.max_operations = max_operations
        self.current_interval_ns = ADAPTIVE_DEFAULT_INTERVAL_SECS * NS_PER_SEC
        self._next_ns: Optional[int] = None
        self._ops = 0
        self._expired = 0
        self._last_removed = 0
        self._last_total = 0

    def record_ops(self, n):
        self._ops += n

    def record_expired(self, n):
        self._expired += n

    def should_clean(self, now_ns, live_keys, capacity):
        if self._next_ns is None:
            self._next_ns = now_ns + self.current_interval_ns
        if now_ns >= self._next_ns:
            return True
        if self._ops >= self.max_operations:
            return True
        # Expired-ratio trigger with the dynamic threshold: clean at
        # half threshold when the last sweep was productive, else wait
        # until 125 % of it (adaptive_cleanup.rs:150-163).
        if self._expired > MIN_EXPIRED_FOR_RATIO:
            ratio = self._expired / max(live_keys, 1)
            if self._last_removed > self._last_total // 4:
                threshold = EXPIRED_RATIO_THRESHOLD / 2.0
            else:
                threshold = EXPIRED_RATIO_THRESHOLD * 1.25
            if ratio > threshold:
                return True
        if live_keys > capacity * 3 // 4:
            return True
        return False

    def after_sweep(self, now_ns, removed, total_before):
        # adaptive_cleanup.rs:187-195: the interval only relaxes when the
        # sweep found nothing AND no traffic hit an expired entry.
        if removed == 0 and self._expired == 0:
            self.current_interval_ns = min(
                self.current_interval_ns * 2, self.max_interval_ns
            )
        elif removed > total_before * 0.5:
            self.current_interval_ns = max(
                self.current_interval_ns // 2, self.min_interval_ns
            )
        self._last_removed = removed
        self._last_total = total_before
        self._next_ns = now_ns + self.current_interval_ns
        self._ops = 0
        self._expired = 0


def feed_expired_hits(policy, limiter, now_ns: int, force: bool = False) -> int:
    """Drain the limiter's expired-hit counter into a policy that wants
    it; returns the drained count (0 when throttled or inapplicable) so
    callers can mirror it into metrics.  Shared by every transport's
    sweep hook (engine._maybe_sweep); call
    under limiter_lock.

    `force=True` bypasses the fetch throttle — used just before a sweep
    so hits counted on-device are attributed to the pre-sweep window
    (after_sweep resets the policy's count; draining late would leak
    them into the fresh window and could fire a redundant ratio sweep).
    """
    if not getattr(policy, "uses_expired_signal", False):
        return 0
    take = getattr(limiter, "take_expired_hits", None)
    if take is None:
        return 0
    n = take(now_ns, 0) if force else take(now_ns)
    if n:
        policy.record_expired(n)
    return n


def make_policy(name: str, **kwargs) -> CleanupPolicy:
    """Factory mirroring the server's store selection (store.rs:57-87)."""
    name = name.lower()
    if name == "periodic":
        interval = kwargs.get("cleanup_interval_secs", DEFAULT_CLEANUP_INTERVAL_SECS)
        return PeriodicPolicy(int(interval * NS_PER_SEC))
    if name == "probabilistic":
        return ProbabilisticPolicy(
            int(kwargs.get("cleanup_probability", PROBABILISTIC_CLEANUP_MODULO))
        )
    if name == "adaptive":
        return AdaptivePolicy(
            min_interval_ns=int(
                kwargs.get("min_interval_secs", MIN_CLEANUP_INTERVAL_SECS) * NS_PER_SEC
            ),
            max_interval_ns=int(
                kwargs.get("max_interval_secs", MAX_CLEANUP_INTERVAL_SECS) * NS_PER_SEC
            ),
            max_operations=int(
                kwargs.get("max_operations", MAX_OPERATIONS_BEFORE_CLEANUP)
            ),
        )
    raise ValueError(f"unknown cleanup policy: {name!r}")
