"""Workload shapes and key distributions for the load generator.

Re-designs the reference's workload vocabulary
(`tests/integration/workload.rs:8-52`): request-arrival patterns
Steady / Burst / Ramp / Wave and key patterns Sequential / Random /
Zipfian / UserResource, plus HotkeyAbuse (a deny-dominated attack mix
the front tier's deny cache is built for).  Patterns are expressed as
*per-request delay schedules* (host side), so they compose with any
transport client.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass
class Workload:
    """A schedule of inter-request delays (seconds) for one worker."""

    pattern: str  # steady | burst | ramp | wave
    target_rps: float  # per-worker request rate
    n_requests: int

    def delays(self) -> Iterator[float]:
        base = 1.0 / self.target_rps if self.target_rps > 0 else 0.0
        if self.pattern == "steady":
            for _ in range(self.n_requests):
                yield base
        elif self.pattern == "burst":
            # bursts of 50 back-to-back, then a pause that restores the
            # average rate (workload.rs Burst).
            burst = 50
            for i in range(self.n_requests):
                yield 0.0 if i % burst else base * burst
        elif self.pattern == "ramp":
            # linear 0 → 2x target over the run (workload.rs Ramp).
            for i in range(self.n_requests):
                frac = (i + 1) / self.n_requests
                rate = self.target_rps * 2 * frac
                yield 1.0 / rate if rate > 0 else 0.0
        elif self.pattern == "wave":
            # sinusoidal around the target (workload.rs Wave).
            for i in range(self.n_requests):
                phase = math.sin(2 * math.pi * i / 1000)
                rate = self.target_rps * (1 + 0.8 * phase)
                yield 1.0 / rate if rate > 0 else 0.0
        else:
            raise ValueError(f"unknown workload pattern: {self.pattern!r}")


def make_keys(
    pattern: str, n_requests: int, key_space: int, seed: int = 0
) -> List[str]:
    """Key sequence per `workload.rs:43-52`'s KeyPattern."""
    rng = np.random.default_rng(seed)
    if pattern == "sequential":
        ids = np.arange(n_requests) % key_space
    elif pattern == "random":
        ids = rng.integers(0, key_space, n_requests)
    elif pattern == "zipfian":
        ranks = np.arange(1, key_space + 1, dtype=np.float64)
        p = ranks**-1.1
        p /= p.sum()
        ids = rng.choice(key_space, size=n_requests, p=p)
    elif pattern == "user-resource":
        users = rng.integers(0, max(key_space // 10, 1), n_requests)
        resources = rng.integers(0, 10, n_requests)
        return [f"user:{u}:res:{r}" for u, r in zip(users, resources)]
    elif pattern == "hotkey-abuse":
        # Abuse/attack traffic — the scenario rate limiters exist for:
        # a handful of hot keys (~1/1000th of the key space, at least
        # one) hammered far past their limit soak ~90% of the stream,
        # so almost every hot-key request after the first burst is a
        # deny; the rest is a benign random tail.  This is the shape
        # the front tier's deny cache turns from the most expensive
        # traffic into the cheapest (see front/).
        n_hot = max(key_space // 1000, 1)
        hot = rng.integers(0, n_hot, n_requests)
        cold = rng.integers(n_hot, max(key_space, n_hot + 1), n_requests)
        is_hot = rng.random(n_requests) < 0.9
        ids = np.where(is_hot, hot, cold)
    elif pattern == "flash-crowd":
        # Sudden hot-set shift (the insight tier's detection target):
        # the first half of the run hammers hot set A, then the crowd
        # moves — the second half hammers a DISJOINT hot set B with the
        # same ~90% concentration over a benign random tail.  A
        # telemetry loop that only knows cumulative counters keeps
        # reporting set A long after the attack moved; the harness's
        # --stats flag measures how fast GET /stats surfaces set B
        # (see flash_crowd_hot_sets for the set definitions).
        n_hot = max(key_space // 1000, 1)
        shift = n_requests // 2
        hot_a = rng.integers(0, n_hot, n_requests)
        hot_b = rng.integers(n_hot, 2 * n_hot, n_requests)
        cold = rng.integers(
            2 * n_hot, max(key_space, 2 * n_hot + 1), n_requests
        )
        pos = np.arange(n_requests)
        hot = np.where(pos < shift, hot_a, hot_b)
        is_hot = rng.random(n_requests) < 0.9
        ids = np.where(is_hot, hot, cold)
    elif pattern == "noisy-neighbor":
        # Multi-tenant isolation scenario (the sharded mesh's namespace
        # layer is built for it): 64 tenants share the server, tenant
        # t0 is abusive — ~50% of the whole stream hammers a handful of
        # its keys far past their limit AND sprays ever-fresh keys
        # (slot-capacity pressure, the tenant-quota surface) — while 63
        # compliant tenants spread modest traffic over their own key
        # ranges.  Keys carry the tenant prefix (`t<N>:key:<i>`), so
        # per-tenant /stats, psum'd tenant counters, quotas, and
        # tenant-affine routing all see it; the load generator reports
        # per-tenant allow/deny splits for it (PerfResult.tenant_counts).
        tenants = 64
        per_tenant = max(key_space // tenants, 1)
        n_hot = max(per_tenant // 100, 1)
        hot = rng.integers(0, n_hot, n_requests)  # tenant 0's hot keys
        # Fresh-key spray from the abusive tenant: monotone ids past its
        # range (seed-offset so every worker/run brings new ones).
        spray = per_tenant + (seed + 1) * n_requests + np.arange(n_requests)
        t_other = rng.integers(1, tenants, n_requests)
        k_other = rng.integers(0, per_tenant, n_requests)
        u = rng.random(n_requests)
        tid = np.where(u < 0.5, 0, t_other)
        kid = np.where(
            u < 0.4, hot, np.where(u < 0.5, spray, k_other)
        )
        return [f"t{t}:key:{k}" for t, k in zip(tid, kid)]
    elif pattern == "diurnal":
        # Live twin of the synthetic diurnal trace generator
        # (replay/generators.py): the whole "day" is compressed into
        # the request stream — keys draw Zipf-skewed from a fixed
        # population, but the DRAW INTENSITY follows a sinusoidal
        # cycle: at the day's peak the stream concentrates on the hot
        # head (the skew the control plane's AIMD loop must absorb), in
        # the trough it spreads into the cold tail.  Pairs with the
        # `wave` arrival pattern for the full load cycle.
        ranks = np.arange(1, key_space + 1, dtype=np.float64)
        p_hot = ranks**-1.1
        p_hot /= p_hot.sum()
        pos = np.arange(n_requests)
        phase = np.sin(2 * np.pi * pos / max(n_requests, 1))
        hot_draw = rng.choice(key_space, size=n_requests, p=p_hot)
        cold_draw = rng.integers(0, key_space, n_requests)
        # Peak hours: ~95% of draws from the skewed head; trough: ~50%.
        is_peak = rng.random(n_requests) < (0.725 + 0.225 * phase)
        ids = np.where(is_peak, hot_draw, cold_draw)
    elif pattern == "slow-drift":
        # Live twin of the synthetic slow-drift generator: the key
        # population slides over the run — each request draws from a
        # window of `key_space` ids whose base advances with stream
        # position, so old keys expire out and fresh keys trickle in
        # for the whole run (keymap-growth and sweep pressure, the
        # long-soak shape; seed-offset so every worker/run drifts over
        # its own band).
        drift_span = key_space  # total drift over the run: one full population
        pos = np.arange(n_requests)
        lo = (pos * drift_span) // max(n_requests, 1)
        lo = lo + (seed + 1) * drift_span
        ids = lo + rng.integers(0, key_space, n_requests)
    elif pattern == "chaos":
        # The chaos-run companion (harness --chaos) for a server armed
        # with THROTTLECRAB_FAULTS: half hot-key abuse (exercises the
        # deny cache across degrade/re-promote invalidations), 40%
        # random cold keys (exercises the supervised launch path), and
        # a 10% ever-fresh churn band (monotone new keys, pressuring
        # keymap growth — the capacity-exhaustion fault surface).
        n_hot = max(key_space // 1000, 1)
        hot = rng.integers(0, n_hot, n_requests)
        cold = rng.integers(n_hot, max(key_space, n_hot + 1), n_requests)
        # Per-worker/run disjoint band (seed-offset): every worker of
        # every run must bring genuinely fresh keys, or the growth
        # pressure this band exists for fades after the first run.
        churn = key_space + (seed + 1) * n_requests + np.arange(n_requests)
        u = rng.random(n_requests)
        ids = np.where(u < 0.5, hot, np.where(u < 0.9, cold, churn))
    elif pattern == "rolling-restart":
        # Companion for the rolling-restart soak: a FIXED key
        # population (no churn band) whose buckets stay live for the
        # whole run, so every node restart must carry their state
        # across the handoff — a hot band driven past its limit (any
        # post-handoff staleness shows up immediately as an extra
        # allow vs the oracle) over a uniform warm tail that keeps
        # every ring range populated with migrate-worthy state.
        n_hot = max(key_space // 100, 1)
        hot = rng.integers(0, n_hot, n_requests)
        warm = rng.integers(n_hot, max(key_space, n_hot + 1), n_requests)
        is_hot = rng.random(n_requests) < 0.3
        ids = np.where(is_hot, hot, warm)
    elif pattern == "crash-restart":
        # Companion for the crash-recovery soak (SIGKILL -> restart on
        # the same checkpoint dir): a FIXED population with a small
        # ledger band (crash_restart_ledger) driven far past its limit
        # — the load generator audits cumulative allows per ledger key,
        # so a restart that comes back cold (forgot checkpointed state)
        # surfaces as per-key allows beyond one burst, while the
        # over-allow-only restore means a wrong deny can never hide in
        # the noise.  A uniform warm tail keeps the table — and every
        # checkpoint delta — realistically populated.
        n_hot = max(key_space // 200, 1)
        hot = rng.integers(0, n_hot, n_requests)
        warm = rng.integers(n_hot, max(key_space, n_hot + 1), n_requests)
        is_hot = rng.random(n_requests) < 0.5
        ids = np.where(is_hot, hot, warm)
    else:
        raise ValueError(f"unknown key pattern: {pattern!r}")
    return [f"key:{i}" for i in ids]


def crash_restart_ledger(key_space: int):
    """The crash-restart pattern's ledger band: the fixed hot keys
    whose cumulative allows the load generator audits for warm-restart
    evidence (allows past one burst per key = state the restart
    forgot)."""
    n_hot = max(key_space // 200, 1)
    return {f"key:{i}" for i in range(n_hot)}


def flash_crowd_hot_sets(key_space: int):
    """(set_a, set_b) key strings of the flash-crowd pattern's two hot
    sets — the shift happens at n_requests // 2 of every worker's
    stream.  The load generator's --stats poller uses set_b to measure
    hot-key detection latency."""
    n_hot = max(key_space // 1000, 1)
    return (
        {f"key:{i}" for i in range(n_hot)},
        {f"key:{i}" for i in range(n_hot, 2 * n_hot)},
    )
