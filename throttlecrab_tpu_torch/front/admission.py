"""Admission control: bounded shedding instead of unbounded queueing.

The reference funnels every transport into a *bounded* mpsc channel
(`--buffer-size`); a full channel is backpressure.  The asyncio engine
has no such bound — every accepted request appends a future to the
pending deque — so a burst beyond device throughput stacks memory and
latency without limit.  The admission controller restores the bound and
makes it latency-aware:

  * **queue depth**: past `max_pending` requests already waiting, new
    arrivals shed immediately with an overload status (the reference's
    full-channel condition, surfaced instead of silently awaited);
  * **estimated wait**: the engine feeds per-launch (size, seconds)
    samples; an EWMA of per-request decide cost turns queue depth into
    an expected linger, and arrivals that would wait longer than
    `max_wait_us` shed even below the depth bound;
  * **two priority classes**: peek/read-only probes (quantity == 0 —
    they consume nothing and are advisory by contract) shed first, at
    `peek_frac` of either bound, keeping headroom for the consuming
    decisions that actually enforce limits.

Shedding is the *correct* overload behavior for a rate limiter: a
rate-limit check that waits out an unbounded queue protects nothing.
"""

from __future__ import annotations

import threading

OVERLOAD_MESSAGE = "server overloaded"

# Per-request status code for shed requests on the native wire path —
# continues tpu.limiter's STATUS_* space (0=ok .. 3=internal); the C++
# wire layer (native/wire_server.cpp ws_respond) maps it to HTTP 503 /
# RESP "-ERR server overloaded".
STATUS_OVERLOADED = 4

# Peek probes (quantity 0) shed at this fraction of each bound unless
# configured otherwise.
DEFAULT_PEEK_FRAC = 0.9

# EWMA smoothing for per-request decide cost (per launch sample).
_ALPHA = 0.2


class OverloadError(Exception):
    """Request shed by admission control; each transport maps it to its
    protocol's overload status (HTTP 503 / gRPC RESOURCE_EXHAUSTED /
    RESP -ERR)."""

    def __init__(self, message: str = OVERLOAD_MESSAGE) -> None:
        super().__init__(message)


class AdmissionController:
    """Queue-depth + estimated-wait shedding with peek/consume classes."""

    def __init__(
        self,
        max_pending: int = 0,
        max_wait_us: int = 0,
        peek_frac: float = DEFAULT_PEEK_FRAC,
    ) -> None:
        """`max_pending` bounds queued requests (0 disables);
        `max_wait_us` bounds the EWMA-estimated queue wait (0 disables);
        `peek_frac` scales both bounds for quantity-0 probes."""
        if max_pending < 0 or max_wait_us < 0:
            raise ValueError("admission bounds must be non-negative")
        if not 0.0 < peek_frac <= 1.0:
            raise ValueError("peek_frac must be in (0, 1]")
        self.max_pending = max_pending
        self.max_wait_us = max_wait_us
        self.peek_frac = peek_frac
        self._lock = threading.Lock()
        self._cost_us: float = 0.0  # EWMA per-request decide cost
        self.shed_peek = 0
        self.shed_consume = 0
        # Insight-tier feedback (L3.75): `hot_concentration` is the
        # share of recent denials landing on the hot set (set per poll
        # via set_hot_concentration); `hot_shed_weight` scales how hard
        # it tightens the PEEK bounds — consuming checks keep their
        # configured bounds, only advisory probes shed earlier when the
        # traffic is concentrated abuse.  Weight 0 (the default and the
        # THROTTLECRAB_INSIGHT=0 state) reproduces today's behavior
        # exactly.
        self.hot_concentration = 0.0
        self.hot_shed_weight = 0.0

    # ------------------------------------------------------------------ #

    def record_launch(self, n_requests: int, elapsed_s: float) -> None:
        """One decide launch finished: fold its per-request cost into
        the EWMA the wait estimate uses.  Called from executor/driver
        threads; the lock keeps the float update coherent."""
        if n_requests <= 0 or elapsed_s < 0:
            return
        sample_us = elapsed_s * 1e6 / n_requests
        with self._lock:
            if self._cost_us == 0.0:
                self._cost_us = sample_us
            else:
                self._cost_us += _ALPHA * (sample_us - self._cost_us)

    def estimated_wait_us(self, depth: int) -> float:
        return depth * self._cost_us

    # ------------------------------------------------------------------ #

    def set_hot_concentration(self, frac: float) -> None:
        """Feed the insight tier's hot-set concentration (clamped to
        [0, 1]); no lock needed — a float store is atomic and admit()
        tolerates any interleaving."""
        self.hot_concentration = min(max(float(frac), 0.0), 1.0)

    def admit(self, depth: int, peek: bool) -> bool:
        """Admit a new arrival given `depth` requests already pending?
        Counts the shed when refusing."""
        frac = self.peek_frac if peek else 1.0
        if peek and self.hot_shed_weight:
            # Concentrated abuse: tighten the peek bounds so advisory
            # probes yield headroom to the consuming checks absorbing
            # the attack.  Floor at 10% so peeks are throttled, never
            # starved outright.
            frac *= max(
                1.0 - self.hot_shed_weight * self.hot_concentration, 0.1
            )
        over = False
        if self.max_pending and depth >= self.max_pending * frac:
            over = True
        elif self.max_wait_us and self._cost_us:
            over = depth * self._cost_us > self.max_wait_us * frac
        if over:
            with self._lock:
                if peek:
                    self.shed_peek += 1
                else:
                    self.shed_consume += 1
        return not over
