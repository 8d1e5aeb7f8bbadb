"""Actuator registry: the vetted, bounded, rate-limited knob surface.

The port of `throttlecrab_tpu/control/actuators.py`.  A controller must
never be able to push a knob outside the range the config layer would
have accepted, and must never slew one faster than the serving stack can
absorb — so every knob the control plane may touch is wrapped in an
:class:`Actuator` declaring its unit, hard bounds, and per-tick
change-rate limit, and every write goes through
:meth:`ActuatorRegistry.apply`, which clamps, rate-limits, and records
the actuation in a bounded log (the byte-diff target of the determinism
checks).

The vetted subset: admission ``hot_shed_weight`` and queue thresholds,
deny-cache capacity and prewarm cadence, insight poll rate, sweep
cadence, and the cluster replica pump cadence (registered only for a
ring-mode ClusterLimiter, the one limiter with a replica pump).  Absent
subsystems simply never register their actuators, so one registry
shape serves every deployment and the offline simulator.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

#: Bounded actuation history (GET /control tail + determinism diffs).
LOG_CAP = 256


@dataclass
class Actuator:
    """One controllable knob: getter/setter closures onto the live
    object, declared unit, hard bounds, and the largest step one tick
    may apply."""

    name: str
    unit: str
    lo: float
    hi: float
    max_step: float  # largest |delta| one apply() may make
    get: Callable[[], float]
    set: Callable[[float], None]
    integer: bool = False

    def describe(self) -> dict:
        return {
            "unit": self.unit,
            "lo": self.lo,
            "hi": self.hi,
            "max_step": self.max_step,
            "value": self.get(),
        }


class ActuatorRegistry:
    """Name → Actuator map with clamped, rate-limited, logged writes."""

    def __init__(self) -> None:
        self._actuators: Dict[str, Actuator] = {}
        self.log: deque = deque(maxlen=LOG_CAP)
        self.actuations = 0
        self.clamps = 0

    def register(self, actuator: Actuator) -> None:
        if actuator.lo > actuator.hi:
            raise ValueError(
                f"actuator {actuator.name}: lo > hi "
                f"({actuator.lo} > {actuator.hi})"
            )
        if actuator.max_step <= 0:
            raise ValueError(
                f"actuator {actuator.name}: max_step must be positive"
            )
        self._actuators[actuator.name] = actuator

    def __contains__(self, name: str) -> bool:
        return name in self._actuators

    def names(self) -> List[str]:
        return sorted(self._actuators)

    def get(self, name: str) -> float:
        return self._actuators[name].get()

    def bounds(self, name: str):
        a = self._actuators[name]
        return a.lo, a.hi

    def apply(self, name: str, target: float, now_ns: int) -> float:
        """Move `name` toward `target`, clamped to its bounds and to
        one tick's max_step from the current value; returns the value
        actually applied (== current when the move is a no-op)."""
        a = self._actuators[name]
        cur = float(a.get())
        want = float(target)
        value = min(max(want, a.lo), a.hi)
        step = value - cur
        if abs(step) > a.max_step:
            value = cur + (a.max_step if step > 0 else -a.max_step)
        if a.integer:
            value = float(int(round(value)))
        clamped = value != want
        if value == cur:
            return cur
        a.set(int(value) if a.integer else value)
        self.actuations += 1
        if clamped:
            self.clamps += 1
        self.log.append({
            "now_ns": now_ns,
            "actuator": name,
            "old": cur,
            "new": value,
            "clamped": clamped,
        })
        return value

    def snapshot(self) -> dict:
        """Current value + declaration of every actuator (GET /control)."""
        return {
            name: a.describe()
            for name, a in sorted(self._actuators.items())
        }


def build_registry(
    front=None,
    insight=None,
    cleanup_policy=None,
    limiter=None,
    admission=None,
) -> ActuatorRegistry:
    """Wrap the vetted knob subset of whatever subsystems exist.

    Bounds are anchored to each knob's configured value (the validated
    operating point): the controller may scale a threshold up or down
    around it, never into a regime the operator's config would have
    rejected.  `admission` overrides `front.admission` (the simulator
    passes a bare controller with no front tier).
    """
    reg = ActuatorRegistry()
    if admission is None:
        admission = getattr(front, "admission", None)
    if admission is not None:
        reg.register(Actuator(
            name="admission.hot_shed_weight", unit="frac",
            lo=0.0, hi=1.0, max_step=0.1,
            get=lambda: admission.hot_shed_weight,
            set=lambda v: setattr(admission, "hot_shed_weight", v),
        ))
        if admission.max_pending > 0:
            base = admission.max_pending
            reg.register(Actuator(
                name="admission.max_pending", unit="requests",
                lo=max(base // 64, 64), hi=base,
                max_step=max(base // 4, 64),
                get=lambda: admission.max_pending,
                set=lambda v: setattr(admission, "max_pending", v),
                integer=True,
            ))
        if admission.max_wait_us > 0:
            base = admission.max_wait_us
            reg.register(Actuator(
                name="admission.max_wait_us", unit="us",
                lo=max(base // 64, 100), hi=base,
                max_step=max(base // 4, 100),
                get=lambda: admission.max_wait_us,
                set=lambda v: setattr(admission, "max_wait_us", v),
                integer=True,
            ))
    deny = getattr(front, "deny_cache", None)
    if deny is not None:
        base = deny.capacity
        reg.register(Actuator(
            name="deny_cache.capacity", unit="entries",
            lo=max(base // 8, 1024), hi=base * 4,
            max_step=max(base // 4, 1024),
            get=lambda: deny.capacity,
            set=lambda v: setattr(deny, "capacity", v),
            integer=True,
        ))
    if insight is not None:
        reg.register(Actuator(
            name="insight.poll_ns", unit="ns",
            lo=100_000_000, hi=60_000_000_000,
            max_step=1_000_000_000,
            get=lambda: insight.poll_ns,
            set=lambda v: setattr(insight, "poll_ns", v),
            integer=True,
        ))
        reg.register(Actuator(
            name="insight.prewarm", unit="keys",
            lo=0, hi=4096, max_step=64,
            get=lambda: insight.prewarm,
            set=lambda v: setattr(insight, "prewarm", v),
            integer=True,
        ))
    if cleanup_policy is not None and hasattr(
        cleanup_policy, "interval_ns"
    ):
        # Sweep cadence: only the periodic policy exposes a fixed
        # interval (the adaptive policy already closes its own loop).
        reg.register(Actuator(
            name="cleanup.interval_ns", unit="ns",
            lo=5_000_000_000, hi=3_600_000_000_000,
            max_step=60_000_000_000,
            get=lambda: cleanup_policy.interval_ns,
            set=lambda v: setattr(cleanup_policy, "interval_ns", v),
            integer=True,
        ))
    pump = getattr(limiter, "_pump", None)
    if pump is not None:
        # Replica pump cadence: an instance attribute shadows the class
        # default POLL_S, so only this deployment's pump retunes.
        reg.register(Actuator(
            name="cluster.pump_poll_s", unit="s",
            lo=0.05, hi=5.0, max_step=0.2,
            get=lambda: pump.POLL_S,
            set=lambda v: setattr(pump, "POLL_S", v),
        ))
    return reg
