"""throttlecrab-tpu-torch server: micro-batching engine + HTTP and RESP
transports.

Requests are coalesced into windows and decided thousands per device
launch (engine.py, or the native transports' driver thread over the C++
wire server, native_redis.py); the HTTP/JSON and Redis/RESP surfaces are
the reference server's.
"""

from .config import Config
from .engine import BatchingEngine
from .metrics import Metrics
from .types import ThrottleRequest, ThrottleResponse

__all__ = [
    "BatchingEngine",
    "Config",
    "Metrics",
    "ThrottleRequest",
    "ThrottleResponse",
]
