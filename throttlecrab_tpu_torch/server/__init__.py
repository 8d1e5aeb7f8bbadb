"""throttlecrab-tpu-torch server: micro-batching engine + HTTP transport.

Requests are coalesced into windows and decided thousands per device
launch (engine.py); the HTTP/JSON surface is the reference server's.
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
