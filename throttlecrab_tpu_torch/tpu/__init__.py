"""Device backend: bucket table on the card, the plain decide and the
hand-written decision-window kernel."""

from .keymap import PyKeyMap
from .kernel import EMPTY_EXPIRY, gcra_batch, sweep_expired
from .limiter import (
    STATUS_INVALID_PARAMS,
    STATUS_NEGATIVE_QUANTITY,
    STATUS_OK,
    BatchResult,
    TorchRateLimiter,
    derive_params,
)
from .table import BucketTable

__all__ = [
    "BatchResult",
    "BucketTable",
    "EMPTY_EXPIRY",
    "PyKeyMap",
    "STATUS_INVALID_PARAMS",
    "STATUS_NEGATIVE_QUANTITY",
    "STATUS_OK",
    "TorchRateLimiter",
    "derive_params",
    "gcra_batch",
    "sweep_expired",
]
