"""throttlecrab-tpu-torch: GCRA rate limiting on PyTorch and CUDA.

The PyTorch/H100 port of `throttlecrab_tpu`, laid out module for module
like it (`tpu/table.py` here is the counterpart of `tpu/table.py` there):

- **core**: the scalar GCRA engine and its in-memory stores, the
  reference library's API (`RateLimiter(AdaptiveStore())`): pure Python,
  the host oracle of the device decide.
- **tpu**: the device backend — a bucket table of packed int32 rows on
  the card, the composed torch decide (`tpu/kernel.py`, the plain
  version) and the hand-written CUDA decision-window kernel
  (`tpu/fused.py` over `csrc/fused_window.cu`).
- **server**: the micro-batching engine and the HTTP/JSON, Redis/RESP and
  gRPC transports.

Every entry point runs on `cuda` unless the caller asks for the CPU.
Time is always an explicit input in integer nanoseconds since the epoch.
"""

from .core.errors import (
    CellError,
    InternalError,
    InvalidRateLimit,
    NegativeQuantity,
)
from .core.rate import Rate
from .core.rate_limiter import RateLimiter, RateLimitResult
from .core.store import (
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
]
