"""Error taxonomy for rate-limit checks.

Mirrors the reference's `CellError` enum (`throttlecrab/src/core/mod.rs:48-68`):
``NegativeQuantity``, ``InvalidRateLimit`` and ``Internal(String)``.
"""

from __future__ import annotations


class CellError(Exception):
    """Base class for all rate-limiter errors."""


class NegativeQuantity(CellError):
    """Raised when the requested quantity is negative."""

    def __init__(self, quantity: int):
        self.quantity = quantity
        super().__init__(f"quantity cannot be negative: {quantity}")


class InvalidRateLimit(CellError):
    """Raised when max_burst, count_per_period or period is not positive."""

    def __init__(self) -> None:
        super().__init__(
            "invalid rate limit parameters: max_burst, count_per_period "
            "and period must all be positive"
        )


class InternalError(CellError):
    """An internal storage or engine error, carrying a message."""
