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


def wrap_u64(x: int) -> int:
    """Two's-complement wrap into u64 (Rust `as u64` on integer sources)."""
    return x & U64_MAX


def sat_i64(x: int) -> int:
    """Clamp an unbounded int into the i64 range."""
    if x > I64_MAX:
        return I64_MAX
    if x < I64_MIN:
        return I64_MIN
    return x


def sat_add(a: int, b: int) -> int:
    """i64 saturating addition (Rust `saturating_add`)."""
    return sat_i64(a + b)


def sat_sub(a: int, b: int) -> int:
    """i64 saturating subtraction (Rust `saturating_sub`)."""
    return sat_i64(a - b)


def sat_mul(a: int, b: int) -> int:
    """i64 saturating multiplication (Rust `saturating_mul`)."""
    return sat_i64(a * b)


def sat_add_u64(a: int, b: int) -> int:
    """u64 saturating addition."""
    return min(a + b, U64_MAX)


def sat_mul_u64(a: int, b: int) -> int:
    """u64 saturating multiplication."""
    return min(a * b, U64_MAX)


def rust_div(a: int, b: int) -> int:
    """Integer division truncating toward zero (Rust `/` on i64)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def f64_to_u64_sat(x: float) -> int:
    """Rust `as u64` float→int cast: truncates toward zero, saturates."""
    if x != x:  # NaN
        return 0
    if x <= 0.0:
        return 0
    if x >= float(U64_MAX):
        return U64_MAX
    return int(x)
