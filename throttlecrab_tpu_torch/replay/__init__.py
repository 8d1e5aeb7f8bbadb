"""Deterministic record/replay: trace capture, flight recorder, replay.

The port of `throttlecrab_tpu/replay/`.  The fault injector (faults/)
can *produce* failures on demand; this package makes any observed run
*reproducible*:

* ``trace.py`` — a versioned columnar trace format recording per-window
  decision inputs ``(key, burst, count, period, now_ns)`` plus
  outcomes, tenant ids, membership/degrade events, and exactly which
  fault injections fired.  Same malformed-frame hardening contract as
  the JAX package's cluster codecs (count-vs-size before allocation,
  typed ``TraceError``, trailing-bytes rejection).
* ``recorder.py`` — an always-on bounded flight recorder (ring buffer
  of the last N windows) armed via ``THROTTLECRAB_TRACE_*`` knobs,
  with capture hooks on the engine flush path and the native-driver
  dispatch (per-batch, never per-request: disarmed cost is one global
  ``None`` check, the fault hooks' discipline), dumped automatically on
  persistent degrade and on demand via ``GET /trace/dump``.
* ``player.py`` — re-runs a trace under virtual time against the
  scalar oracle, a `TorchRateLimiter` (the card, or ``device="cpu"``),
  the sharded mesh, or an in-process multi-node cluster reconstructed
  from the recorded membership timeline, differentially against the
  scalar oracle and against the recorded outcomes.
* ``generators.py`` — synthetic diurnal / flash-crowd / slow-drift
  traces.
"""

from .trace import (  # noqa: F401
    REC_EVENT,
    REC_INJECTION,
    REC_WINDOW,
    SOURCE_CLUSTER_BASE,
    SOURCE_ENGINE,
    SOURCE_HARNESS,
    SOURCE_NATIVE,
    SOURCE_SYNTH,
    Trace,
    TraceError,
    TraceWriter,
)
from .recorder import (  # noqa: F401
    FlightRecorder,
    active_recorder,
    arm,
    disarm,
    maybe_record_event,
)

__all__ = [
    "Trace",
    "TraceError",
    "TraceWriter",
    "FlightRecorder",
    "arm",
    "disarm",
    "active_recorder",
    "maybe_record_event",
    "REC_WINDOW",
    "REC_EVENT",
    "REC_INJECTION",
    "SOURCE_ENGINE",
    "SOURCE_NATIVE",
    "SOURCE_CLUSTER_BASE",
    "SOURCE_HARNESS",
    "SOURCE_SYNTH",
]
