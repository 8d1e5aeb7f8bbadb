"""Capacity-pressure demo: table growth, sweep reclamation, memory/key.

The port's counterpart of the JAX package's `examples/capacity_test.py`
(the reference's examples/capacity_test.rs pushes unique keys through
each store to show capacity behaviour).  The port's table is one packed
int32 row per slot on the card (`--cpu`: host memory), so the
interesting behaviour is growth doubling (HashMap-style) and the expiry
sweep vacating slots for the host keymap to reuse.  The bytes per slot
are read from the table's real row width and dtype.

    python -m throttlecrab_tpu_torch.examples.capacity_test [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ..tpu.limiter import TorchRateLimiter

NS = 1_000_000_000
T0 = 1_753_000_000 * NS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    limiter = TorchRateLimiter(
        capacity=1024, auto_grow=True, device="cpu" if args.cpu else None
    )
    state = limiter.table.state
    slot_bytes = state.shape[1] * state.element_size()
    print(f"initial capacity: {limiter.total_capacity} slots "
          f"({limiter.total_capacity * slot_bytes / 1024:.0f} KiB HBM)")

    # 1. Push 10x the initial capacity of unique short-TTL keys.
    n = 10_240
    for start in range(0, n, 1024):
        keys = [f"burst_key_{i}" for i in range(start, start + 1024)]
        limiter.rate_limit_batch(keys, 10, 100, 60, 1, T0)  # 60 s period
    print(f"after {n} unique keys: capacity={limiter.total_capacity}, "
          f"live={len(limiter)}")

    # 2. Everything expires after its TTL; one sweep vacates the slots.
    freed = limiter.sweep(T0 + 3600 * NS)
    print(f"sweep at +1h freed {freed} slots; live={len(limiter)}")

    # 3. The vacated capacity is reused without further growth.
    before = limiter.total_capacity
    for start in range(0, n, 1024):
        keys = [f"second_wave_{i}" for i in range(start, start + 1024)]
        limiter.rate_limit_batch(keys, 10, 100, 60, 1, T0 + 3601 * NS)
    print(f"second wave of {n} keys reused slots: capacity "
          f"{before} -> {limiter.total_capacity} (no growth)")

    hbm = limiter.total_capacity * slot_bytes
    print(
        f"\nmemory model: {hbm / 1024:.0f} KiB HBM for "
        f"{limiter.total_capacity} slots ({slot_bytes} B/slot) + host keymap "
        "(~60 B + key bytes per live key)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
