"""In-memory stores for rate-limiter state (CPU path / oracle).

Three cleanup strategies, mirroring the reference
(`throttlecrab/src/core/store/`):

- :class:`PeriodicStore` — fixed-interval sweeps
- :class:`AdaptiveStore` — self-tuning sweep intervals
- :class:`ProbabilisticStore` — deterministic sampled sweeps

All implement the :class:`Store` protocol and are interchangeable.
"""

from .adaptive import AdaptiveStore, AdaptiveStoreBuilder
from .base import Store
from .periodic import PeriodicStore, PeriodicStoreBuilder
from .probabilistic import ProbabilisticStore, ProbabilisticStoreBuilder

__all__ = [
    "AdaptiveStore",
    "AdaptiveStoreBuilder",
    "PeriodicStore",
    "PeriodicStoreBuilder",
    "ProbabilisticStore",
    "ProbabilisticStoreBuilder",
    "Store",
]
