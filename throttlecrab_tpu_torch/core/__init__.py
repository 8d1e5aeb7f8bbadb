"""Scalar GCRA core: rate math, error taxonomy, stores, rate limiter."""

from .errors import CellError, InternalError, InvalidRateLimit, NegativeQuantity
from .rate import Rate
from .rate_limiter import RateLimiter, RateLimitResult, normalize_now_ns
from .store import (
    AdaptiveStore,
    PeriodicStore,
    ProbabilisticStore,
    Store,
)

__all__ = [
    "AdaptiveStore",
    "CellError",
    "InternalError",
    "InvalidRateLimit",
    "NegativeQuantity",
    "PeriodicStore",
    "ProbabilisticStore",
    "Rate",
    "RateLimiter",
    "RateLimitResult",
    "Store",
    "normalize_now_ns",
]
