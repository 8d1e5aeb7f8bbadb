"""Exact 64-bit integer semantics on top of Python's unbounded ints.

The reference implements GCRA with Rust `i64` saturating arithmetic and a few
deliberate wrapping casts (`rate_limiter.rs:154-238`).  Python ints never
overflow, so the scalar oracle reproduces those semantics explicitly with the
helpers below.  The device decide implements the same operations on int64
tensors (tpu/sat.py) and in CUDA (csrc/gcra_lane.cuh).
"""

from __future__ import annotations

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
U64_MAX = (1 << 64) - 1

# The one shared time unit: all timestamps/durations are integer nanoseconds.
NS_PER_SEC = 1_000_000_000


def wrap_i64(x: int) -> int:
    """Two's-complement wrap of an unbounded int into i64 (Rust `as i64`)."""
    return ((x - I64_MIN) & U64_MAX) + I64_MIN


def sat_mul_u64(a: int, b: int) -> int:
    """u64 saturating multiplication."""
    return min(a * b, U64_MAX)
