"""Access-pattern demo: how key locality shapes batched throughput.

The port's counterpart of the JAX package's `examples/access_patterns.py`
(the reference's examples/access_patterns.rs): Sequential / Random /
Hot-Key (90/10) / Zipfian key streams through the batched engine on the
card (`--cpu`: the plain version).  The comparison is decisions/s per
pattern: the decision-window kernel serialises duplicate keys inside a
batch without any sort or scan.

    python -m throttlecrab_tpu_torch.examples.access_patterns [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
N_KEYS = 10_000
BATCH = 1024
BATCHES = 64


def pattern_keys(name: str, rng) -> list:
    n = BATCH * BATCHES
    if name == "sequential":
        ids = np.arange(n) % N_KEYS
    elif name == "random":
        ids = rng.integers(0, N_KEYS, n)
    elif name == "hot_key":
        # 90% of traffic on 10% of keys.
        hot = rng.integers(0, N_KEYS // 10, n)
        cold = rng.integers(0, N_KEYS, n)
        ids = np.where(rng.random(n) < 0.9, hot, cold)
    elif name == "zipfian":
        ranks = np.arange(1, N_KEYS + 1, dtype=np.float64)
        p = ranks ** -1.1
        p /= p.sum()
        ids = rng.choice(N_KEYS, n, p=p)
    else:
        raise ValueError(name)
    return [f"key_{int(i)}" for i in ids]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    t0 = 1_753_000_000 * NS
    for name in ("sequential", "random", "hot_key", "zipfian"):
        rng = np.random.default_rng(42)
        limiter = TorchRateLimiter(capacity=1 << 15, device=device)
        keys = pattern_keys(name, rng)
        # Warm (the first launch builds and loads the kernel).
        limiter.rate_limit_batch(keys[:BATCH], 100, 1000, 3600, 1, t0)
        start = time.perf_counter()
        allowed = 0
        for b in range(BATCHES):
            res = limiter.rate_limit_batch(
                keys[b * BATCH : (b + 1) * BATCH],
                100, 1000, 3600, 1, t0 + b * 1_000_000,
                wire=True,
            )
            allowed += int(res.allowed.sum())
        dt = time.perf_counter() - start
        print(
            f"{name:>10}: {BATCH * BATCHES / dt:>12,.0f} decisions/s  "
            f"({allowed} allowed, {len(limiter)} live keys)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
