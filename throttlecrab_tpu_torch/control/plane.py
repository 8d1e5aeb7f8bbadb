"""Control plane (L3.9): sensor bus → controllers → actuator registry.

The port of `throttlecrab_tpu/control/plane.py`.  One `ControlPlane` per
deployment, driven from exactly the two places the insight poll is
driven: the asyncio engine's flush loop (engine._maybe_sweep, on the
executor) and the native driver's batch loop — both via
:meth:`maybe_tick`, throttled to the configured tick cadence, under the
same limiter-lock discipline.  Each tick:

  1. snapshot a `Telemetry` from the sensor bus (control/telemetry.py),
  2. score it against the previous record (multi-objective:
     throughput / wait / fairness),
  3. let the armed controllers (AIMD fast loop, hill-climb slow loop)
     move actuators through the bounded, rate-limited registry.

Kill switch: ``THROTTLECRAB_CONTROL=0`` (the default) builds none of
this — no bus, no registry, no tick in the flush loop — so decisions,
stored state, and every knob value are byte-identical to the subsystem
never having existed (pinned by the differential test).

Lock discipline: ``ControlPlane._lock`` is taken strictly BEFORE every
leaf lock a tick reads through (InsightTier._lock, DenyCache,
AdmissionController, Metrics), and none of them is held while taking
it, so the snapshot can never invert the order.  On a card the insight
sensors fetch device totals, so a tick syncs the table's stream: the
callers run it under the limiter lock.

Clock discipline: the plane never reads a wall clock.  ``now_ns``
always arrives from the caller (the engine's ``now_fn``, the native
driver's clock, or a virtual clock in tests and the offline replayer),
which is what makes convergence tests and `control rank` rankings
deterministic.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from .actuators import ActuatorRegistry, build_registry
from .controllers import AIMDController, HillClimber, Objective
from .telemetry import SensorBus, Telemetry, shed_fraction

__all__ = ["ControlPlane", "MODES"]

MODES = ("aimd", "hill", "both")

#: Hill climber runs over the slow knobs AIMD does not own.
_HILL_COORDS = (
    "admission.hot_shed_weight",
    "deny_cache.capacity",
    "insight.prewarm",
    "insight.poll_ns",
)


class ControlPlane:
    """Owns the sensor bus, the actuator registry, and the armed
    controllers; ticks at a fixed cadence under injected time."""

    def __init__(
        self,
        bus: SensorBus,
        registry: ActuatorRegistry,
        mode: str = "both",
        tick_ms: int = 1000,
        target_wait_us: float = 5000.0,
        objective: Optional[Objective] = None,
    ) -> None:
        if mode not in MODES:
            raise ValueError(f"control mode must be one of {MODES}")
        self.bus = bus
        self.registry = registry
        self.mode = mode
        self.tick_ns = max(int(tick_ms), 1) * 1_000_000
        self.objective = objective if objective is not None else Objective()
        self.aimd = (
            AIMDController(target_wait_us=target_wait_us)
            if mode in ("aimd", "both")
            else None
        )
        self.hill = (
            HillClimber(list(_HILL_COORDS))
            if mode in ("hill", "both")
            else None
        )
        self._lock = threading.Lock()
        # The lock that serializes device access for this deployment:
        # None means the caller's limiter lock is the right one (a
        # deployment whose device is serialized by another lock sets
        # it).
        self.tick_lock = None
        self._last_tick_ns: Optional[int] = None
        self._prev: Optional[Telemetry] = None
        self.ticks = 0
        self.last_score = 0.0
        self.last_shed_rate = 0.0

    # -- tick cadence (mirrors InsightTier.poll_due / maybe_poll) ------

    def tick_due(self, now_ns: int) -> bool:
        last = self._last_tick_ns
        return last is None or now_ns - last >= self.tick_ns

    def maybe_tick(self, now_ns: int, limiter_lock=None,
                   queue_depth: int = 0) -> bool:
        """Throttled tick; pass the caller's limiter lock to serialize
        sensor reads against launches (callers already holding the
        right lock pass nothing).  `tick_lock`, when set, overrides
        the caller's lock."""
        if not self.tick_due(now_ns):
            return False
        lock = self.tick_lock if self.tick_lock is not None else limiter_lock
        if lock is not None:
            with lock:
                return self.tick(now_ns, queue_depth=queue_depth)
        return self.tick(now_ns, queue_depth=queue_depth)

    def tick(self, now_ns: int, queue_depth: int = 0) -> bool:
        """One control step (call under the limiter lock): snapshot,
        score, actuate.  Never raises into the serving path."""
        with self._lock:
            if not self.tick_due(now_ns):
                return False
            self._last_tick_ns = now_ns
            self.ticks += 1
            prev = self._prev
            try:
                cur = self.bus.snapshot(now_ns, queue_depth=queue_depth)
                score = self.objective.score(prev, cur)
                self.last_score = score
                self.last_shed_rate = shed_fraction(prev, cur)
                if self.aimd is not None:
                    self.aimd.tick(prev, cur, self.registry, now_ns)
                if self.hill is not None:
                    self.hill.tick(score, self.registry, now_ns)
                self._prev = cur
            except Exception:
                import logging

                logging.getLogger("throttlecrab.control").debug(
                    "control tick failed", exc_info=True
                )
            return True

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        """The GET /control document."""
        with self._lock:
            out = {
                "control": {
                    "enabled": True,
                    "mode": self.mode,
                    "tick_ms": self.tick_ns // 1_000_000,
                    "ticks": self.ticks,
                },
                "objective": {
                    "weights": self.objective.weights(),
                    "last_score": round(self.last_score, 6),
                    "last_shed_rate": round(self.last_shed_rate, 6),
                },
                "actuators": self.registry.snapshot(),
                "actuations": {
                    "total": self.registry.actuations,
                    "clamped": self.registry.clamps,
                    "log": list(self.registry.log),
                },
            }
            if self.hill is not None:
                out["hill"] = self.hill.stats()
            return out

    def stats_json(self) -> str:
        return json.dumps(self.stats())

    def actuation_log_json(self) -> str:
        """Canonical byte-diffable actuation log (determinism diffs)."""
        with self._lock:
            return json.dumps(list(self.registry.log), sort_keys=True)

    def metric_stats(self) -> dict:
        """Gauge snapshot for the Prometheus exporter
        (Metrics.set_control_stats_provider)."""
        with self._lock:
            return {
                "ticks": self.ticks,
                "actuations": self.registry.actuations,
                "clamped": self.registry.clamps,
                "objective": round(self.last_score, 6),
                "shed_rate": round(self.last_shed_rate, 6),
            }


def create_control_plane(config, front=None, insight=None,
                         cleanup_policy=None, limiter=None, metrics=None):
    """Config → ControlPlane, or None when THROTTLECRAB_CONTROL is off
    (the kill switch: nothing is built, nothing ticks, no knob moves).
    Mirrors store.create_insight's shape; lives here rather than in
    server/store.py so the control package is importable standalone."""
    if not getattr(config, "control", False):
        return None
    bus = SensorBus(
        front=front, insight=insight, metrics=metrics, limiter=limiter
    )
    registry = build_registry(
        front=front,
        insight=insight,
        cleanup_policy=cleanup_policy,
        limiter=limiter,
    )
    plane = ControlPlane(
        bus,
        registry,
        mode=config.control_mode,
        tick_ms=config.control_tick_ms,
        target_wait_us=config.control_target_wait_us,
        objective=Objective(
            w_throughput=config.control_w_throughput,
            w_wait=config.control_w_wait,
            w_fairness=config.control_w_fairness,
        ),
    )
    if metrics is not None:
        metrics.set_control_stats_provider(plane.metric_stats)
    return plane
