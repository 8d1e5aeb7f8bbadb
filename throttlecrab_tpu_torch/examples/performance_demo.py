"""In-process performance demo — the reference's
examples/performance_demo.rs equivalent, adapted to the batched engine.

The port's counterpart of the JAX package's `examples/performance_demo.py`:
the scalar-compat API decides one request per call (paying a window
launch each), the batch API amortizes one launch over thousands.  On the
card unless `--cpu` asks for the plain version.

    python -m throttlecrab_tpu_torch.examples.performance_demo [--cpu]
        [--batch 4096]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..tpu.limiter import TorchRateLimiter


def demo_scalar(limiter, now_ns: int, iterations: int = 2_000) -> None:
    print("\nScalar API (one device launch per decision)")
    print("-" * 44)
    for i in range(100):  # warm: the first launch builds the kernel
        limiter.rate_limit(f"warm_{i}", 100, 1000, 60, 1, now_ns)
    t0 = time.perf_counter()
    for i in range(iterations):
        limiter.rate_limit(
            f"bench_key_{i % 1000}", 100, 1000, 60, 1, now_ns + i * 1000
        )
    dt = time.perf_counter() - t0
    print(f"{iterations} decisions in {dt:.2f}s -> "
          f"{iterations / dt:,.0f} req/s "
          f"({dt / iterations * 1e6:.1f} us/req)")


def demo_batched(limiter, now_ns: int, batch: int, iters: int = 64) -> None:
    print(f"\nBatch API ({batch} decisions per launch)")
    print("-" * 44)
    keys = [f"bench_key_{i}" for i in range(10_000)]
    rng = np.random.default_rng(1)
    sel = rng.integers(0, len(keys), (iters + 1, batch))
    limiter.rate_limit_batch(  # warm
        [keys[i] for i in sel[0]], 100, 1000, 60, 1, now_ns
    )
    t0 = time.perf_counter()
    for it in range(1, iters + 1):
        limiter.rate_limit_batch(
            [keys[i] for i in sel[it]], 100, 1000, 60, 1,
            now_ns + it * 1_000_000,
        )
    dt = time.perf_counter() - t0
    total = iters * batch
    print(f"{total} decisions in {dt:.2f}s -> {total / dt:,.0f} req/s "
          f"({dt / total * 1e9:.0f} ns/req)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)

    print("throttlecrab-tpu-torch Performance Demo")
    print("=" * 44)

    now_ns = time.time_ns()
    limiter = TorchRateLimiter(
        capacity=1 << 15, keymap="auto", device="cpu" if args.cpu else None
    )
    demo_scalar(limiter, now_ns)
    demo_batched(limiter, now_ns, args.batch)

    print("\nThe gap is the whole design: the reference amortizes a "
          "HashMap lookup per call,\nthis framework amortizes a device "
          "launch per *batch* (see chip_smoke.py phase 3 for the\nfull "
          "serving-path number).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
