"""Feedback controllers: AIMD on admission shedding + hill climbing.

The port of `throttlecrab_tpu/control/controllers.py`.

Two pluggable controllers close the loop over the actuator registry
(arXiv:2511.03279's telemetry-driven adaptive rate limiting, scoped to
this repo's knob surface):

* :class:`AIMDController` — the fast loop.  Regulates the engine's
  queueing delay toward a target by moving the admission bound:
  additive increase (serve more) while the EWMA-estimated wait is
  under target, multiplicative decrease (shed sooner) the moment it
  overshoots — TCP's stability argument, applied to queue admission.
  Under sustained overload the bound converges to target_wait/cost and
  the measured shed fraction settles at the forced equilibrium (the
  "shed setpoint" the convergence test pins).  A secondary term leans
  on the insight tier: concentrated abuse traffic additionally raises
  ``hot_shed_weight`` so advisory peeks yield headroom first.

* :class:`HillClimber` — the slow loop.  Gradient-free coordinate
  descent over the remaining actuators, maximizing the declared
  multi-objective score with hysteresis: a move must beat the current
  baseline by a margin to be accepted, otherwise it is reverted — so
  measurement noise cannot make the climber oscillate.

Both are pure functions of (telemetry, clock): no ambient time, no
randomness — convergence tests run deterministically under virtual
time, and the offline policy search replays them bit-identically.

The multi-objective score: served throughput, queue wait
(the p99-wait proxy admission's EWMA cost model provides), and
per-tenant fairness (Jain's index), combined with declared weights.
"""

from __future__ import annotations

import math
from typing import List, Optional

from .telemetry import Telemetry, jain_fairness, shed_fraction

NS_PER_SEC = 1_000_000_000


class Objective:
    """score = w_t·log1p(served/s) − w_w·log1p(wait_us) + w_f·fairness.

    Log-compressed throughput and wait so one decade of either cannot
    silently buy ten decades of the other; fairness enters linearly
    (it is already in [0, 1])."""

    def __init__(self, w_throughput: float = 1.0, w_wait: float = 1.0,
                 w_fairness: float = 0.5) -> None:
        self.w_throughput = float(w_throughput)
        self.w_wait = float(w_wait)
        self.w_fairness = float(w_fairness)

    def weights(self) -> dict:
        return {
            "throughput": self.w_throughput,
            "wait": self.w_wait,
            "fairness": self.w_fairness,
        }

    def score(self, prev: Optional[Telemetry], cur: Telemetry) -> float:
        if prev is None or cur.now_ns <= prev.now_ns:
            dt_s = 1.0
            served = cur.served_total
        else:
            dt_s = (cur.now_ns - prev.now_ns) / NS_PER_SEC
            served = cur.served_total - prev.served_total
        rate = max(served / dt_s, 0.0)
        return (
            self.w_throughput * math.log1p(rate)
            - self.w_wait * math.log1p(max(cur.est_wait_us, 0.0))
            + self.w_fairness * jain_fairness(cur.tenant_served)
        )


class AIMDController:
    """Additive-increase / multiplicative-decrease on the admission
    bound, with a hot-set term on ``hot_shed_weight``."""

    PENDING = "admission.max_pending"
    SHED_WEIGHT = "admission.hot_shed_weight"

    def __init__(self, target_wait_us: float = 5000.0,
                 increase_step: int = 256,
                 decrease_factor: float = 0.7,
                 hot_threshold: float = 0.5) -> None:
        if not 0.0 < decrease_factor < 1.0:
            raise ValueError("decrease_factor must be in (0, 1)")
        self.target_wait_us = float(target_wait_us)
        self.increase_step = int(increase_step)
        self.decrease_factor = float(decrease_factor)
        self.hot_threshold = float(hot_threshold)

    def tick(self, prev: Optional[Telemetry], cur: Telemetry,
             registry, now_ns: int) -> None:
        congested = cur.est_wait_us > self.target_wait_us
        if self.PENDING in registry:
            bound = registry.get(self.PENDING)
            if congested:
                registry.apply(
                    self.PENDING, bound * self.decrease_factor, now_ns
                )
            elif shed_fraction(prev, cur) > 0.0:
                # The bound is binding and latency has headroom: relax
                # additively so fewer arrivals shed.
                registry.apply(
                    self.PENDING, bound + self.increase_step, now_ns
                )
        if self.SHED_WEIGHT in registry:
            weight = registry.get(self.SHED_WEIGHT)
            if congested and cur.hot_concentration > self.hot_threshold:
                # Concentrated abuse under pressure: shed advisory
                # peeks earlier (additive, bounded by the registry).
                registry.apply(self.SHED_WEIGHT, weight + 0.05, now_ns)
            elif not congested and weight > 0.0:
                registry.apply(
                    self.SHED_WEIGHT, weight * self.decrease_factor,
                    now_ns,
                )


class HillClimber:
    """Coordinate descent with hysteresis over a declared coordinate
    list, maximizing the objective.

    Phases: measure a baseline for ``eval_ticks`` ticks, then per
    coordinate try +step and (if rejected) −step, each measured for
    ``eval_ticks`` ticks; a move is accepted only when its mean score
    beats the baseline by ``hysteresis`` (absolute score units) —
    otherwise it is reverted exactly.  Accepted moves become the new
    baseline and the same coordinate is pushed again (greedy descent
    along the winning axis)."""

    def __init__(self, coords: List[str], step_frac: float = 0.125,
                 eval_ticks: int = 4, hysteresis: float = 0.01) -> None:
        if eval_ticks < 1:
            raise ValueError("eval_ticks must be >= 1")
        self.coords = list(coords)
        self.step_frac = float(step_frac)
        self.eval_ticks = int(eval_ticks)
        self.hysteresis = float(hysteresis)
        self._scores: List[float] = []
        self._baseline: Optional[float] = None
        self._coord_i = 0
        self._direction = 1
        self._pending_revert: Optional[tuple] = None  # (name, old value)
        self.moves_accepted = 0
        self.moves_reverted = 0

    def _step_of(self, registry, name: str) -> float:
        lo, hi = registry.bounds(name)
        return max((hi - lo) * self.step_frac, 1e-9)

    def _advance(self) -> None:
        """Next probe direction: +, then −, then the next coordinate."""
        if self._direction > 0:
            self._direction = -1
        else:
            self._direction = 1
            self._coord_i += 1

    def tick(self, score: float, registry, now_ns: int) -> None:
        coords = [c for c in self.coords if c in registry]
        if not coords:
            return
        self._scores.append(score)
        if len(self._scores) < self.eval_ticks:
            return
        mean = sum(self._scores) / len(self._scores)
        self._scores = []
        if self._baseline is None:
            self._baseline = mean
        elif self._pending_revert is not None:
            name, old = self._pending_revert
            self._pending_revert = None
            if mean > self._baseline + self.hysteresis:
                # Keep the move, raise the bar, push the same axis.
                self._baseline = mean
                self.moves_accepted += 1
            else:
                registry.apply(name, old, now_ns)
                self.moves_reverted += 1
                self._advance()
        # Propose the next move.
        name = coords[self._coord_i % len(coords)]
        old = registry.get(name)
        target = old + self._direction * self._step_of(registry, name)
        applied = registry.apply(name, target, now_ns)
        if applied == old:
            # Pinned at a bound: skip this direction without burning a
            # measurement window on a no-op.
            self._advance()
        else:
            self._pending_revert = (name, old)

    def stats(self) -> dict:
        return {
            "accepted": self.moves_accepted,
            "reverted": self.moves_reverted,
            "baseline": self._baseline,
        }
