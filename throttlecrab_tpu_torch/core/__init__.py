"""Scalar GCRA contract pieces the batch engine needs: errors, i64 math,
the result type and the clock-skew rule."""

from .errors import CellError, InternalError, InvalidRateLimit, NegativeQuantity
from .rate_limiter import RateLimitResult, normalize_now_ns

__all__ = [
    "CellError",
    "InternalError",
    "InvalidRateLimit",
    "NegativeQuantity",
    "RateLimitResult",
    "normalize_now_ns",
]
