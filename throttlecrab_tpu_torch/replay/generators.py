"""Synthetic trace generators: diurnal, flash-crowd, slow-drift-churn.

The port of `throttlecrab_tpu/replay/generators.py`: for each pattern
and seed the trace is byte-identical to the JAX package's.  Instead of a
live load generator approximating a diurnal cycle in wall time, the
cycle is synthesized once into a trace — window sizes and timestamps
modulated over a simulated day — and replayed deterministically against
any limiter configuration.

Outcomes are pre-filled by a scalar-oracle pass (the repo's
differential ground truth), so a generated trace is complete: replay
targets can be diffed against its recorded planes exactly like a
captured production trace.
"""

from __future__ import annotations

import math

import numpy as np

from .trace import SOURCE_SYNTH, Trace, TraceError, TraceWriter

NS = 1_000_000_000
T0 = 1_753_700_000 * NS

PATTERNS = ("diurnal", "flash-crowd", "slow-drift")


def _params_of(kid: np.ndarray):
    """Per-key heterogeneous params derived from the key id (the bench
    convention — BASELINE config 3)."""
    burst = 5 + (kid % 60)
    count = 50 + (kid % 1000)
    period = 30 + (kid % 120)
    return burst, count, period


def synthesize(
    pattern: str,
    windows: int = 64,
    batch: int = 256,
    key_space: int = 2048,
    seed: int = 0,
    t0_ns: int = T0,
    step_ns: int = NS // 4,
    fill_outcomes: bool = True,
) -> Trace:
    """Build a synthetic decision trace.

    * ``diurnal`` — the offered load follows a sinusoidal day: window
      sizes swing between ~10% and 100% of ``batch`` over the trace
      (the whole day is compressed into ``windows`` steps), keys drawn
      Zipf-skewed from a fixed population.
    * ``flash-crowd`` — halfway through, the hot set shifts to a
      disjoint population with the same ~90% concentration (the
      insight tier's detection scenario, harness ``flash-crowd``).
    * ``slow-drift`` — the key population churns gradually: each
      window draws from a sliding range, so old keys expire out and
      fresh keys trickle in for the whole trace (keymap-growth and
      sweep pressure, the long-soak failure shape).
    """
    if pattern not in PATTERNS:
        raise TraceError(f"unknown synthetic pattern {pattern!r}")
    rng = np.random.default_rng(seed)
    n_hot = max(key_space // 100, 1)
    ranks = np.arange(1, key_space + 1, dtype=np.float64) ** -1.1
    zipf_p = ranks / ranks.sum()

    writer = TraceWriter()
    now = int(t0_ns)
    for wi in range(windows):
        if pattern == "diurnal":
            phase = math.sin(2 * math.pi * wi / max(windows, 1))
            n = max(int(batch * (0.55 + 0.45 * phase)), max(batch // 10, 1))
            kid = rng.choice(key_space, size=n, p=zipf_p)
        elif pattern == "flash-crowd":
            n = batch
            lo = 0 if wi < windows // 2 else n_hot
            hot = rng.integers(lo, lo + n_hot, n)
            cold = rng.integers(2 * n_hot, max(key_space, 2 * n_hot + 1), n)
            kid = np.where(rng.random(n) < 0.9, hot, cold)
        else:  # slow-drift
            n = batch
            drift = max(key_space // max(windows, 1), 1)
            lo = wi * drift
            kid = rng.integers(lo, lo + key_space, n)
        kid = kid.astype(np.int64)
        burst, count, period = _params_of(kid)
        params = np.stack(
            [burst, count, period, np.ones(len(kid), np.int64)], axis=1
        )
        keys = [b"key:%d" % k for k in kid]
        writer.add_window(
            now, SOURCE_SYNTH, keys, params,
            np.zeros(len(kid), np.uint8), np.zeros(len(kid), np.uint8),
        )
        now += int(step_ns)

    trace = Trace.loads(writer.to_bytes())
    if fill_outcomes:
        _fill_outcomes(trace)
    return trace


def _fill_outcomes(trace: Trace) -> None:
    """Run the trace's inputs through the scalar oracle and write the
    resulting (allowed, status) planes back — ground truth filled in."""
    from .player import make_target, replay

    outcomes = replay(trace, make_target("oracle", trace))
    for w, (allowed, status) in zip(trace.windows, outcomes):
        w.allowed[:] = allowed
        w.status[:] = status


def save(trace: Trace, path: str) -> str:
    """Serialize a (possibly outcome-refilled) trace back to a file."""
    from .trace import (
        REC_EVENT,
        REC_WINDOW,
        encode_event,
        encode_injection,
        encode_window,
    )

    writer = TraceWriter()
    for kind, rec in trace.records:
        if kind == REC_WINDOW:
            writer._frames.append(
                encode_window(
                    rec.now_ns, rec.source, rec.keys, rec.params,
                    rec.allowed, rec.status, rec.tenants,
                )
            )
            writer.n_windows += 1
        elif kind == REC_EVENT:
            writer._frames.append(
                encode_event(rec.now_ns, rec.kind, rec.detail)
            )
        else:
            writer._frames.append(
                encode_injection(rec.site, rec.mode, rec.index, rec.arg)
            )
    return writer.save(path)
