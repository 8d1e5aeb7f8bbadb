"""Cleanup-policy comparison on one workload — examples/store_comparison.rs.

The port's counterpart of the JAX package's `examples/store_comparison.py`.
The reference compares PeriodicStore / ProbabilisticStore / AdaptiveStore
throughput; here the three are *cleanup policies* over the same device
table (tpu/cleanup.py preserves each one's trigger rules verbatim), so
the comparison shows policy overhead and sweep cadence rather than
separate store implementations.  On the card unless `--cpu` asks for the
plain version.

    python -m throttlecrab_tpu_torch.examples.store_comparison [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..tpu.cleanup import AdaptivePolicy, PeriodicPolicy, ProbabilisticPolicy
from ..tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_000_000 * NS
BATCH = 1024
BATCHES = 48
N_KEYS = 20_000


def run(name: str, policy, device=None) -> None:
    rng = np.random.default_rng(7)
    limiter = TorchRateLimiter(capacity=1 << 15, device=device)
    ids = rng.integers(0, N_KEYS, BATCH * BATCHES)
    keys = [f"key_{int(i)}" for i in ids]
    limiter.rate_limit_batch(keys[:BATCH], 100, 1000, 60, 1, T0)  # warm

    sweeps = 0
    freed_total = 0
    start = time.perf_counter()
    for b in range(BATCHES):
        now = T0 + b * 30 * NS  # 30 s per batch: TTLs lapse mid-run
        limiter.rate_limit_batch(
            keys[b * BATCH : (b + 1) * BATCH], 100, 1000, 60, 1, now,
            wire=True,
        )
        policy.record_ops(BATCH)
        if policy.should_clean(now, len(limiter), limiter.total_capacity):
            freed = limiter.sweep(now)
            policy.after_sweep(now, freed, len(limiter))
            sweeps += 1
            freed_total += freed
    dt = time.perf_counter() - start
    print(
        f"{name:>14}: {BATCH * BATCHES / dt:>12,.0f} decisions/s, "
        f"{sweeps} sweeps, {freed_total} slots reclaimed, "
        f"{len(limiter)} live"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    run("periodic", PeriodicPolicy(interval_ns=60 * NS), device)
    run("probabilistic", ProbabilisticPolicy(probability=10), device)
    run("adaptive", AdaptivePolicy(), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
