"""Adaptive control plane (L3.9): close the loop the insight tier opened.

The port of `throttlecrab_tpu/control/`.

The serving stack grew rich sensors (insight hot-set concentration,
engine EWMA wait, per-tenant counters, cluster view) and a surface of
hand-tuned knobs (admission thresholds, deny-cache size/prewarm, poll
and sweep cadences) — this package connects them, the way
arXiv:2511.03279's multi-objective adaptive rate limiting connects
telemetry to policy:

* ``telemetry``  — typed `Telemetry` snapshots via the `SensorBus`;
* ``actuators``  — the vetted, bounded, rate-limited knob registry;
* ``controllers``— AIMD (fast loop) + hill climbing (slow loop) over a
  declared throughput/wait/fairness objective;
* ``plane``      — `ControlPlane`, ticked from the engine flush loop
  and the native driver under the insight tier's lock discipline;
* ``replayer``   — offline policy search over recorded traces under
  virtual time (`python -m throttlecrab_tpu_torch.control rank`).

``THROTTLECRAB_CONTROL=0`` (default) builds none of it: decisions,
state, and every knob value are byte-identical to the package never
having existed.
"""

from .actuators import LOG_CAP, Actuator, ActuatorRegistry, build_registry
from .controllers import AIMDController, HillClimber, Objective
from .plane import MODES, ControlPlane, create_control_plane
from .replayer import (
    ControlReplayer,
    Policy,
    SimResult,
    default_candidates,
    rank,
    rank_json,
)
from .telemetry import SensorBus, Telemetry, jain_fairness, shed_fraction

__all__ = [
    "Actuator",
    "ActuatorRegistry",
    "AIMDController",
    "ControlPlane",
    "ControlReplayer",
    "HillClimber",
    "LOG_CAP",
    "MODES",
    "Objective",
    "Policy",
    "SensorBus",
    "SimResult",
    "Telemetry",
    "build_registry",
    "create_control_plane",
    "default_candidates",
    "jain_fairness",
    "rank",
    "rank_json",
    "shed_fraction",
]
