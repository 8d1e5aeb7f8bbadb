"""Limiter/policy factory: config -> engine parts (reference: store.rs:57-87).

The "store" choice selects the cleanup policy; the bucket table itself is
always the device table of `TorchRateLimiter`.
"""

from __future__ import annotations

from ..tpu.cleanup import CleanupPolicy, make_policy
from ..tpu.limiter import TorchRateLimiter


def create_limiter(config) -> TorchRateLimiter:
    """The single-device limiter the engine will drive, on
    `config.device` (raises when that device is absent)."""
    return TorchRateLimiter(
        capacity=config.store_capacity,
        keymap=config.keymap,
        device=config.device,
    )


def create_cleanup_policy(config) -> CleanupPolicy:
    """store.rs:57-87: the store type decides when cleanup runs."""
    if config.store == "periodic":
        return make_policy(
            "periodic", cleanup_interval_secs=config.store_cleanup_interval
        )
    if config.store == "probabilistic":
        return make_policy(
            "probabilistic",
            cleanup_probability=config.store_cleanup_probability,
        )
    return make_policy(
        "adaptive",
        min_interval_secs=config.store_min_interval,
        max_interval_secs=config.store_max_interval,
        max_operations=config.store_max_operations,
    )
