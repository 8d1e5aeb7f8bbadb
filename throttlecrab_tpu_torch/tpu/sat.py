"""Saturating i64 arithmetic on int64 tensors.

Torch's int64 ops wrap on overflow (two's complement); the GCRA contract
needs Rust-style saturating semantics (`rate_limiter.rs:160-238`).  These
helpers detect the wrap and clamp with elementwise ops only, bit for bit
the lattice of `throttlecrab_tpu/tpu/sat.py`; `csrc/gcra_lane.cuh` carries
the same lattice in C++ for the CUDA kernel.
"""

from __future__ import annotations

import torch

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


def sat_add(a, b):
    """i64 saturating a + b."""
    s = a + b
    pos_of = (a > 0) & (b > 0) & (s < 0)
    neg_of = (a < 0) & (b < 0) & (s >= 0)
    return torch.where(
        pos_of, I64_MAX, torch.where(neg_of, I64_MIN, s)
    )


def sat_sub(a, b):
    """i64 saturating a - b."""
    d = a - b
    pos_of = (a >= 0) & (b < 0) & (d < 0)
    neg_of = (a < 0) & (b > 0) & (d >= 0)
    return torch.where(
        pos_of, I64_MAX, torch.where(neg_of, I64_MIN, d)
    )


def sat_add_nn(a, b):
    """i64 saturating a + b for b >= 0: only positive overflow is
    possible, and it shows exactly as s < a."""
    s = a + b
    return torch.where(s < a, I64_MAX, s)


def sat_sub_nn(a, b):
    """i64 saturating a - b for b >= 0: only negative overflow is
    possible, showing exactly as d > a."""
    d = a - b
    return torch.where(d > a, I64_MIN, d)


def sat_mul_nonneg(a, b):
    """i64 saturating a * b for a, b >= 0 (the only case GCRA needs).

    The overflow probe `a > I64_MAX // max(b, 1)` is the reference
    lattice's; for operands outside the contract the result is the
    wrapped product, as there."""
    safe_b = torch.clamp(b, min=1)
    limit = torch.div(
        torch.full_like(safe_b, I64_MAX), safe_b, rounding_mode="trunc"
    )
    overflow = (b > 0) & (a > limit)
    return torch.where(overflow, I64_MAX, a * b)


def div_trunc(a, b):
    """i64 division truncating toward zero (Rust `/`); b is clamped to
    >= 1.  Torch's `//` floors, so the rounding mode is explicit."""
    return torch.div(a, torch.clamp(b, min=1), rounding_mode="trunc")
