"""Shared dict-backed store machinery for the three CPU stores.

Each store is `dict[str, (tat_i64, expiry_ns | None)]` plus a cleanup policy
deciding *when* to sweep expired entries; the sweep itself is a retain over
`expiry > now` (`periodic.rs:128-142`, `adaptive_cleanup.rs:173-203`,
`probabilistic.rs:110-125`).  The CAS / get / set-if-absent semantics are
identical across stores (modulo expired-entry bookkeeping hooks), so they
live here once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


class MapStore:
    """Base class: TAT map + lazy cleanup inside mutating ops."""

    def __init__(self) -> None:
        self._data: Dict[str, Tuple[int, Optional[int]]] = {}

    # -- policy hooks -----------------------------------------------------

    def _maybe_cleanup(self, now_ns: int) -> None:
        """Called at the top of every mutating op; subclasses decide."""
        raise NotImplementedError

    def _on_expired_hit(self) -> None:
        """Called when a mutating op lands on an expired entry."""

    def _sweep(self, now_ns: int) -> int:
        """Remove expired entries; returns how many were removed."""
        before = len(self._data)
        self._data = {
            k: v
            for k, v in self._data.items()
            if v[1] is None or v[1] > now_ns
        }
        return before - len(self._data)

    # -- Store protocol ---------------------------------------------------

    def compare_and_swap_with_ttl(
        self, key: str, old: int, new: int, ttl_ns: int, now_ns: int
    ) -> bool:
        self._maybe_cleanup(now_ns)
        entry = self._data.get(key)
        if entry is None:
            return False
        value, expiry = entry
        if expiry is not None and expiry <= now_ns:
            self._on_expired_hit()
            return False
        if value != old:
            return False
        self._data[key] = (new, now_ns + ttl_ns)
        return True

    def get(self, key: str, now_ns: int) -> Optional[int]:
        entry = self._data.get(key)
        if entry is None:
            return None
        value, expiry = entry
        if expiry is None or expiry > now_ns:
            return value
        return None

    def set_if_not_exists_with_ttl(
        self, key: str, value: int, ttl_ns: int, now_ns: int
    ) -> bool:
        self._maybe_cleanup(now_ns)
        entry = self._data.get(key)
        if entry is not None:
            _, expiry = entry
            if expiry is None or expiry > now_ns:
                return False
            # Expired entry: replace it.
            self._on_expired_hit_set()
        self._data[key] = (value, now_ns + ttl_ns)
        return True

    def _on_expired_hit_set(self) -> None:
        """Hook for set-if-absent landing on an expired entry."""

    # -- introspection (test accessors, like periodic.rs:113-126) ---------

    def __len__(self) -> int:
        return len(self._data)

    def is_empty(self) -> bool:
        return not self._data
