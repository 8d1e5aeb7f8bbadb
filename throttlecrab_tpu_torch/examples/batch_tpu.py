"""Batched device-engine use: thousands of decisions per launch.

The port's counterpart of the JAX package's `examples/batch_tpu.py`, over
`TorchRateLimiter`: on the card unless `--cpu` asks for the plain
version.

    python -m throttlecrab_tpu_torch.examples.batch_tpu [--cpu]
"""

import argparse
import sys
import time

import numpy as np

from ..tpu.limiter import TorchRateLimiter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    limiter = TorchRateLimiter(
        capacity=1 << 16, keymap="auto", device="cpu" if args.cpu else None
    )
    now = time.time_ns()

    keys = [f"tenant:{i % 64}/user:{i}" for i in range(4096)]
    result = limiter.rate_limit_batch(
        keys, max_burst=10, count_per_period=100, period=60,
        quantity=1, now_ns=now,
    )
    print(f"batch 1: {int(result.allowed.sum())}/{len(keys)} allowed")

    # Hammer one key within a single batch: exact sequential semantics.
    hot = ["hot-key"] * 64
    result = limiter.rate_limit_batch(
        hot, max_burst=10, count_per_period=100, period=3600,
        quantity=1, now_ns=now,
    )
    print(
        f"hot key: {int(result.allowed.sum())}/64 allowed "
        f"(burst 10 → first 10: {bool(result.allowed[:10].all())})"
    )

    # Expiry sweep frees slots whose TTL lapsed.
    freed = limiter.sweep(now + 7200 * 10**9)
    print(f"sweep freed {freed} slots, {len(limiter)} live")

    # Per-key heterogeneous parameters in one batch.
    n = 1024
    rng = np.random.default_rng(0)
    result = limiter.rate_limit_batch(
        [f"k{i}" for i in range(n)],
        max_burst=rng.integers(1, 20, n),
        count_per_period=rng.integers(1, 1000, n),
        period=rng.integers(1, 3600, n),
        quantity=1,
        now_ns=now,
    )
    print(f"heterogeneous batch: {int(result.allowed.sum())}/{n} allowed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
