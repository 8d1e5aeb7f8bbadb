"""Embedded library use — the reference's examples/basic.rs equivalent.

The port's counterpart of the JAX package's `examples/basic.py`: the
scalar GCRA engine of `core/`, no device.

    python -m throttlecrab_tpu_torch.examples.basic
"""

import argparse
import sys
import time

import throttlecrab_tpu_torch as tc


def main(argv=None) -> int:
    argparse.ArgumentParser().parse_args(argv)
    limiter = tc.RateLimiter(tc.AdaptiveStore())
    now = time.time_ns()
    for i in range(7):
        allowed, result = limiter.rate_limit(
            "api:user:42",
            max_burst=5,
            count_per_period=100,
            period=60,
            quantity=1,
            now_ns=now + i * 1_000,
        )
        print(
            f"request {i}: allowed={allowed} remaining={result.remaining} "
            f"retry_after={result.retry_after_ns / 1e9:.3f}s"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
