"""Replay player: re-run a trace under virtual time, differentially.

The port of `throttlecrab_tpu/replay/player.py` for the single-device
targets.  A trace (trace.py) carries everything a decision depends on —
key, params, quantity, and the server-side timestamp each window was
stamped with — so replaying is exact by construction: time is an input
(rate_limiter.rs:109), never ambient.  The player re-drives those
windows against a limiter:

* ``oracle``  — the ``core/`` scalar GCRA engine (the repo's
  differential-test oracle, via server/supervisor.HostOracle);
* ``device``  — a `TorchRateLimiter`, on ``cuda`` unless the caller
  passes ``device="cpu"`` (the plain version); every window is one
  ``rate_limit_batch`` call, so on a card one launch of the
  decision-window kernel per conflict round of the window (one for a
  window whose keys keep their params).

The JAX package's mesh target (``sharded:D``) and its in-process
cluster replayer are not part of the port: ``make_target`` refuses
``sharded`` with a ValueError that names the missing piece.

Two modes:

* **differential** (:func:`differential_replay`): the target's
  replayed outcomes are compared row-by-row against the scalar oracle
  AND against the recorded outcomes, so silent drift between the
  capture config and the replay config is a test failure, not a shrug.
* **deterministic fault replay**: :func:`injector_from_trace` rebuilds
  the exact fired-injection schedule a chaos run recorded
  (faults/injector.py ``from_schedule``), so the replayed run fails at
  the same sites, on the same draws, in the same order.

Rows whose *recorded* status is load-dependent (admission shed, or an
internal error from a mid-run fault) are excluded from outcome
comparison by default — they are properties of the original run's
environment, not of the decision function.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .trace import Trace

#: Recorded statuses excluded from comparison by default: 3 = internal
#: (a fault fired mid-run; deterministic fault replay pins those runs
#: instead), 4 = overloaded (admission shed is queue-depth-dependent),
#: 6 = deadline exceeded (queue-dwell-dependent: a replay's dwell times
#: differ, so which rows expired in queue is an environment fact).
DEFAULT_IGNORE_STATUSES = (3, 4, 6)


def _next_pow2(n: int) -> int:
    p = 1024
    while p < n:
        p <<= 1
    return p


def make_target(name: str, trace: Optional[Trace] = None, **kw):
    """Build a replay target limiter: ``oracle`` or ``device`` (extra
    keywords go to `TorchRateLimiter`, e.g. ``device="cpu"``; the
    default is the card).  Capacity is sized from the trace's
    distinct-key count so a replay can never fail on table growth."""
    cap = kw.pop("capacity", None)
    if cap is None:
        cap = _next_pow2(
            2 * (trace.distinct_keys() if trace is not None else 4096)
        )
    if name == "oracle":
        from ..server.supervisor import HostOracle

        return HostOracle(bytes_keys=True)
    if name == "device":
        from ..tpu.limiter import TorchRateLimiter

        return TorchRateLimiter(capacity=cap, **kw)
    if name.startswith("sharded"):
        raise ValueError(
            f"replay target {name!r}: the sharded mesh limiter is not "
            "part of the port yet (ROADMAP A7)"
        )
    raise ValueError(f"unknown replay target {name!r}")


def _decode_keys(keys: List[bytes], limiter) -> list:
    from ..tpu.limiter import limiter_uses_bytes_keys

    if getattr(limiter, "bytes_keys", False) or limiter_uses_bytes_keys(
        limiter
    ):
        return keys
    return [k.decode("utf-8", "surrogateescape") for k in keys]


def replay(trace: Trace, limiter) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Re-run every window in capture order; returns per-window
    (allowed u8, status u8) planes."""
    out = []
    for w in trace.windows:
        keys = _decode_keys(w.keys, limiter)
        res = limiter.rate_limit_batch(
            keys,
            w.params[:, 0], w.params[:, 1], w.params[:, 2],
            w.params[:, 3], w.now_ns,
        )
        out.append((
            np.asarray(res.allowed, np.uint8).copy(),
            np.asarray(res.status, np.uint8).copy(),
        ))
    return out


def outcome_vector(outcomes) -> bytes:
    """Byte-for-byte determinism diff target for replayed outcomes."""
    return b"".join(a.tobytes() + s.tobytes() for a, s in outcomes)


@dataclass
class Mismatch:
    window: int
    row: int
    field: str
    got: int
    want: int
    key: bytes = b""

    def __str__(self) -> str:
        return (
            f"window {self.window} row {self.row} key {self.key!r}: "
            f"{self.field} got {self.got} want {self.want}"
        )


@dataclass
class ReplayReport:
    n_windows: int = 0
    n_rows: int = 0
    n_compared: int = 0
    vs_oracle: List[Mismatch] = field(default_factory=list)
    vs_recorded: List[Mismatch] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.vs_oracle and not self.vs_recorded

    def summary(self) -> dict:
        return {
            "windows": self.n_windows,
            "rows": self.n_rows,
            "compared": self.n_compared,
            "oracle_mismatches": len(self.vs_oracle),
            "recorded_mismatches": len(self.vs_recorded),
            "ok": self.ok,
        }


def compare_outcomes(
    trace: Trace,
    got,
    want,
    label: str,
    sink: List[Mismatch],
    ignore_statuses=DEFAULT_IGNORE_STATUSES,
    max_mismatches: int = 64,
) -> int:
    """Row-by-row outcome comparison, gated on the recorded status;
    returns the number of rows compared."""
    compared = 0
    for wi, (w, (ga, gs), (wa, ws)) in enumerate(
        zip(trace.windows, got, want)
    ):
        rec_status = np.asarray(w.status)
        comparable = ~np.isin(rec_status, ignore_statuses)
        compared += int(comparable.sum())
        bad_status = comparable & (gs != ws)
        ok_rows = comparable & (gs == 0) & (ws == 0)
        bad_allowed = ok_rows & (ga != wa)
        for i in np.flatnonzero(bad_status | bad_allowed):
            if len(sink) >= max_mismatches:
                return compared
            i = int(i)
            fieldname = "status" if bad_status[i] else "allowed"
            g, e = (gs[i], ws[i]) if bad_status[i] else (ga[i], wa[i])
            sink.append(
                Mismatch(
                    window=wi, row=i, field=f"{label}:{fieldname}",
                    got=int(g), want=int(e), key=w.keys[i],
                )
            )
    return compared


def recorded_outcomes(trace: Trace):
    return [
        (np.asarray(w.allowed, np.uint8), np.asarray(w.status, np.uint8))
        for w in trace.windows
    ]


def differential_replay(
    trace: Trace,
    target="device",
    ignore_statuses=DEFAULT_IGNORE_STATUSES,
) -> ReplayReport:
    """Replay against ``target`` and the scalar oracle; compare the
    target's outcomes against BOTH the oracle and the recorded planes.
    Any drift — replay config vs capture config, or engine vs oracle —
    surfaces as a mismatch list, never silently.  A target named by a
    string is built by `make_target` (``"device"``: on the card); pass
    ``make_target("device", trace, device="cpu")`` for the CPU."""
    limiter = (
        make_target(target, trace) if isinstance(target, str) else target
    )
    report = ReplayReport(
        n_windows=len(trace.windows), n_rows=trace.n_rows()
    )
    got = replay(trace, limiter)
    oracle = replay(trace, make_target("oracle", trace))
    report.n_compared = compare_outcomes(
        trace, got, oracle, "oracle", report.vs_oracle, ignore_statuses
    )
    compare_outcomes(
        trace, got, recorded_outcomes(trace), "recorded",
        report.vs_recorded, ignore_statuses,
    )
    return report


def injector_from_trace(trace: Trace, sleep_fn=None):
    """Rebuild the chaos run's exact fired-injection schedule."""
    from ..faults import FaultInjector

    return FaultInjector.from_schedule(
        trace.injection_schedule(), sleep_fn=sleep_fn
    )
