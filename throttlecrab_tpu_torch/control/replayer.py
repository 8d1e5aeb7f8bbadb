"""Offline policy search: replay one trace against K candidate
policies under virtual time; rank by the declared objective.

The port of `throttlecrab_tpu/control/replayer.py`; for the same trace
its `rank_json` is byte-identical to the JAX package's.  It rides the
replay player: the trace supplies keys, GCRA params, and the
server-stamped ``now_ns`` per window — time is an input, so the whole
search is deterministic (same trace + same candidates ⇒ the same
ranking, byte for byte).  It runs on the host only: every decision
comes from the scalar oracle.

The simulation closes the loop the live engine closes, in miniature:

  * a **virtual queue** with a declared service rate stands in for the
    device — each window, the backlog drains ``service_rate·Δt`` rows,
    then the window's arrivals pass through a real
    :class:`AdmissionController` at the current backlog depth;
  * **admitted** rows are decided by the scalar-oracle limiter at the
    window's recorded ``now_ns`` (the same oracle differential tests
    trust), **shed** rows get STATUS_OVERLOADED exactly like the live
    front tier;
  * a real :class:`ControlPlane` ticks at the recorded timestamps,
    reading a `Telemetry` built from the simulated queue and moving
    the real admission knobs through the real bounded registry.

With the controller off and default knobs, the virtual queue stays
under the default admission bound for every shipped trace shape, so
the outcome planes are byte-identical to a plain oracle replay — the
kill-switch bit-identity anchor the tests verify.

Every degrade dump the flight recorder writes is a valid input here:
`python -m throttlecrab_tpu_torch.control rank dump.tctr` turns an
incident artifact into auto-tuning fuel.
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..front.admission import STATUS_OVERLOADED, AdmissionController
from ..replay.player import make_target, outcome_vector
from .actuators import build_registry
from .controllers import NS_PER_SEC, Objective
from .plane import ControlPlane
from .telemetry import Telemetry

__all__ = ["Policy", "ControlReplayer", "SimResult", "rank",
           "default_candidates"]

#: Per-admitted-row simulated decide cost fed to the EWMA: 1 µs, so the
#: estimated wait in µs numerically equals the backlog depth in rows.
SIM_COST_US = 1.0

#: Hot-set size for the simulated concentration sensor (top keys per
#: window, mirroring the insight tier's device top-K in spirit).
_SIM_TOPK = 8


@dataclass(frozen=True)
class Policy:
    """One candidate control policy for the offline search.  ``mode``
    'off' is the static-defaults baseline (no plane is built)."""

    name: str
    mode: str = "both"  # off | aimd | hill | both
    target_wait_us: float = 5000.0
    tick_ms: int = 250
    w_throughput: float = 1.0
    w_wait: float = 1.0
    w_fairness: float = 0.5

    def describe(self) -> dict:
        return {
            "name": self.name,
            "mode": self.mode,
            "target_wait_us": self.target_wait_us,
            "tick_ms": self.tick_ms,
            "weights": {
                "throughput": self.w_throughput,
                "wait": self.w_wait,
                "fairness": self.w_fairness,
            },
        }


@dataclass
class SimResult:
    policy: Policy
    score: float = 0.0
    served: int = 0
    shed: int = 0
    actuations: int = 0
    final_max_pending: int = 0
    max_wait_us_seen: float = 0.0
    outcomes: list = field(default_factory=list)
    actuation_log: list = field(default_factory=list)

    def vector(self) -> bytes:
        return outcome_vector(self.outcomes)

    def to_dict(self) -> dict:
        return {
            "policy": self.policy.describe(),
            "score": round(self.score, 6),
            "served": self.served,
            "shed": self.shed,
            "actuations": self.actuations,
            "final_max_pending": self.final_max_pending,
            "max_wait_us_seen": round(self.max_wait_us_seen, 3),
        }


class _SimBus:
    """Sensor bus over the simulated queue: same `Telemetry` shape a
    live tick snapshots, built from the virtual-queue state."""

    def __init__(self, sim: "ControlReplayer") -> None:
        self.sim = sim

    def snapshot(self, now_ns: int, queue_depth: int = 0) -> Telemetry:
        adm = self.sim.admission
        return Telemetry(
            now_ns=now_ns,
            queue_depth=queue_depth,
            est_wait_us=adm.estimated_wait_us(queue_depth),
            cost_us=adm._cost_us,
            shed_peek=adm.shed_peek,
            shed_consume=adm.shed_consume,
            allowed_total=self.sim.allowed_total,
            denied_total=self.sim.denied_total,
            hot_concentration=self.sim.hot_concentration,
        )


class ControlReplayer:
    """Replays one trace under a candidate policy, virtual time only.

    ``service_rate`` (rows/s the virtual device drains) defaults to
    half the trace's offered rate — a 2× overload, the regime where a
    controller has something to do.  One instance simulates one
    policy; build a fresh one per candidate (`rank` does)."""

    def __init__(
        self,
        trace,
        policy: Policy,
        service_rate: Optional[float] = None,
        max_pending: int = 100_000,
        max_wait_us: int = 0,
    ) -> None:
        self.trace = trace
        self.policy = policy
        if service_rate is None:
            dur_s = self._duration_s(trace)
            service_rate = 0.5 * trace.n_rows() / dur_s if dur_s > 0 else 0.0
        self.service_rate = float(service_rate)
        self.admission = AdmissionController(
            max_pending=max_pending, max_wait_us=max_wait_us
        )
        self.oracle = make_target("oracle", trace)
        self.backlog = 0.0
        self.allowed_total = 0
        self.denied_total = 0
        self.hot_concentration = 0.0
        self.plane: Optional[ControlPlane] = None
        if policy.mode != "off":
            registry = build_registry(admission=self.admission)
            self.plane = ControlPlane(
                _SimBus(self),
                registry,
                mode=policy.mode,
                tick_ms=policy.tick_ms,
                target_wait_us=policy.target_wait_us,
                objective=Objective(
                    w_throughput=policy.w_throughput,
                    w_wait=policy.w_wait,
                    w_fairness=policy.w_fairness,
                ),
            )

    @staticmethod
    def _duration_s(trace) -> float:
        ws = trace.windows
        if len(ws) < 2:
            return 0.0
        span = ws[-1].now_ns - ws[0].now_ns
        # Include one trailing step so rate = rows / wall time covered.
        step = span / (len(ws) - 1)
        return (span + step) / NS_PER_SEC

    def run(self) -> SimResult:
        """Simulate every window in capture order; returns the result
        (outcome planes included, for bit-identity diffs)."""
        # Judged by ONE yardstick — the default objective weights — no
        # matter what weights the policy's own controllers steer with;
        # otherwise every candidate would grade its own homework.
        objective = Objective()
        res = SimResult(policy=self.policy)
        prev_tel: Optional[Telemetry] = None
        prev_ns: Optional[int] = None
        scores: List[float] = []
        for w in self.trace.windows:
            if prev_ns is not None and w.now_ns > prev_ns:
                dt_s = (w.now_ns - prev_ns) / NS_PER_SEC
                self.backlog = max(
                    self.backlog - self.service_rate * dt_s, 0.0
                )
            prev_ns = w.now_ns
            quantity = np.asarray(w.params[:, 3])
            admitted_idx: List[int] = []
            n = len(w.keys)
            for i in range(n):
                depth = int(self.backlog) + len(admitted_idx)
                if self.admission.admit(depth, peek=quantity[i] == 0):
                    admitted_idx.append(i)
            allowed = np.zeros(n, np.uint8)
            status = np.full(n, STATUS_OVERLOADED, np.uint8)
            if admitted_idx:
                idx = np.asarray(admitted_idx)
                keys = [w.keys[i] for i in admitted_idx]
                r = self.oracle.rate_limit_batch(
                    keys,
                    w.params[idx, 0], w.params[idx, 1],
                    w.params[idx, 2], w.params[idx, 3], w.now_ns,
                )
                ra = np.asarray(r.allowed, np.uint8)
                rs = np.asarray(r.status, np.uint8)
                allowed[idx] = ra
                status[idx] = rs
                self.allowed_total += int(ra.sum())
                self.denied_total += int(len(idx) - ra.sum())
                self.admission.record_launch(
                    len(idx), len(idx) * SIM_COST_US * 1e-6
                )
            res.outcomes.append((allowed, status))
            self.backlog += len(admitted_idx)
            # Simulated hot-set concentration: share of this window's
            # traffic on its top keys (the insight tier's signal, from
            # the trace instead of the device).
            counts = Counter(w.keys)
            self.hot_concentration = (
                sum(c for _, c in counts.most_common(_SIM_TOPK)) / n
                if n else 0.0
            )
            if self.plane is not None:
                self.plane.maybe_tick(
                    w.now_ns, None, queue_depth=int(self.backlog)
                )
            bus = _SimBus(self)
            cur = bus.snapshot(w.now_ns, queue_depth=int(self.backlog))
            scores.append(objective.score(prev_tel, cur))
            res.max_wait_us_seen = max(
                res.max_wait_us_seen, cur.est_wait_us
            )
            prev_tel = cur
        res.score = sum(scores) / len(scores) if scores else 0.0
        res.served = self.allowed_total + self.denied_total
        res.shed = self.admission.shed_peek + self.admission.shed_consume
        res.final_max_pending = self.admission.max_pending
        if self.plane is not None:
            res.actuations = self.plane.registry.actuations
            res.actuation_log = list(self.plane.registry.log)
        return res


def default_candidates(k: int = 8) -> List[Policy]:
    """A deterministic candidate grid: the static baseline plus AIMD /
    hill / combined variants across wait targets.  Extends past the
    fixed head by sweeping the wait target, so any K is serviceable."""
    head = [
        Policy(name="static", mode="off"),
        Policy(name="aimd-5ms", mode="aimd", target_wait_us=5000.0),
        Policy(name="aimd-2ms", mode="aimd", target_wait_us=2000.0),
        Policy(name="aimd-10ms", mode="aimd", target_wait_us=10000.0),
        Policy(name="aimd-20ms", mode="aimd", target_wait_us=20000.0),
        Policy(name="hill", mode="hill"),
        Policy(name="both-5ms", mode="both", target_wait_us=5000.0),
        Policy(name="both-10ms", mode="both", target_wait_us=10000.0),
    ]
    out = head[:k]
    i = 0
    while len(out) < k:
        i += 1
        out.append(Policy(
            name=f"aimd-{25 + 10 * i}ms", mode="aimd",
            target_wait_us=(25 + 10 * i) * 1000.0,
        ))
    return out


def rank(trace, policies: List[Policy], service_rate=None,
         max_pending: int = 100_000) -> List[dict]:
    """Simulate every candidate against the trace and rank by a SHARED
    objective (the default weights — candidates may steer with their
    own weights, but they are judged by one yardstick).  Deterministic:
    ties break on policy name."""
    results = []
    for p in policies:
        sim = ControlReplayer(
            trace, p, service_rate=service_rate, max_pending=max_pending
        )
        results.append(sim.run())
    results.sort(key=lambda r: (-r.score, r.policy.name))
    return [
        {"rank": i + 1, **r.to_dict()} for i, r in enumerate(results)
    ]


def rank_json(ranking: List[dict]) -> str:
    """Canonical byte-diffable ranking (determinism diffs)."""
    return json.dumps(ranking, sort_keys=True)
