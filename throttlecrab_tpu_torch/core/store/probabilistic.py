"""ProbabilisticStore: deterministic sampled cleanup.

Per `throttlecrab/src/core/store/probabilistic.rs:110-125`: every mutating op
increments an operation counter; when `count.wrapping_mul(2654435761)` is a
multiple of `cleanup_probability` the store sweeps.  Deterministic, uniform
over time, no periodic latency spikes.  Default probability: 1/1000.
"""

from __future__ import annotations

from .mapstore import MapStore

DEFAULT_CAPACITY = 1000
PROBABILISTIC_CLEANUP_MODULO = 1000
_PRIME = 2654435761
_U64_MASK = (1 << 64) - 1


class ProbabilisticStore(MapStore):
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        cleanup_probability: int = PROBABILISTIC_CLEANUP_MODULO,
    ) -> None:
        super().__init__()
        # API parity only (preallocation hint in the reference; see
        # periodic.py).
        self.capacity = capacity
        self.cleanup_probability = cleanup_probability
        self._operations_count = 0

    @classmethod
    def with_capacity(cls, capacity: int) -> "ProbabilisticStore":
        return cls(capacity=capacity)

    @classmethod
    def builder(cls) -> "ProbabilisticStoreBuilder":
        return ProbabilisticStoreBuilder()

    def _maybe_cleanup(self, now_ns: int) -> None:
        self._operations_count += 1
        hashed = (self._operations_count * _PRIME) & _U64_MASK
        # Rust's `is_multiple_of(0)` is `self == 0`: with probability 0 the
        # store never cleans (the odd-prime product is never 0 mod 2^64).
        if self.cleanup_probability == 0:
            fire = hashed == 0
        else:
            fire = hashed % self.cleanup_probability == 0
        if fire:
            self._sweep(now_ns)


class ProbabilisticStoreBuilder:
    def __init__(self) -> None:
        self._capacity = DEFAULT_CAPACITY
        self._cleanup_probability = PROBABILISTIC_CLEANUP_MODULO

    def capacity(self, capacity: int) -> "ProbabilisticStoreBuilder":
        self._capacity = capacity
        return self

    def cleanup_probability(self, probability: int) -> "ProbabilisticStoreBuilder":
        self._cleanup_probability = probability
        return self

    def build(self) -> ProbabilisticStore:
        return ProbabilisticStore(self._capacity, self._cleanup_probability)
