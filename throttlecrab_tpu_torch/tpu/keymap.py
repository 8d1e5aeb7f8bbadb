"""Host-side key→slot mapping.

The reference hashes string keys straight into its HashMap on every request
(`periodic.rs:151-209`); here the hot path is on the card, so the host's only
job is resolving string keys to dense slot indices.  This module is the
pure-Python keymap of `throttlecrab_tpu/tpu/keymap.py`; the native C++
keymap is `throttlecrab_tpu_torch/native.py`.

Slot lifecycle: allocated on first sight of a key, recycled through a free
list when a cleanup sweep reports the slot expired (limiter.sweep).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np


class PyKeyMap:
    """Dict-backed key→slot table with a free list."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._map: dict = {}
        # Stack of free slots; pop from the end (low indices first).
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._rev: List[Optional[object]] = [None] * capacity
        # Bumped by every slot-remapping operation (sweep frees, growth).
        self.mutations = 0

    def __len__(self) -> int:
        return len(self._map)

    def resolve(self, keys: Sequence, valid: np.ndarray):
        """Resolve each key to a slot, allocating on miss, and emit the
        kernel's duplicate-segment structure in the same pass.

        Returns (slots, rank, is_last, n_full): slots are -1 where `valid`
        is False or the table is full (n_full counts the latter; the caller
        grows and retries those).
        """
        n = len(keys)
        slots = np.full(n, -1, np.int32)
        rank = np.zeros(n, np.int32)
        is_last = np.ones(n, bool)
        n_full = 0
        get = self._map.get
        free = self._free
        batch_seen: dict = {}
        for i, key in enumerate(keys):
            if not valid[i]:
                continue
            slot = get(key)
            if slot is None:
                if not free:
                    n_full += 1
                    continue
                slot = free.pop()
                self._map[key] = slot
                self._rev[slot] = key
            slots[i] = slot
            st = batch_seen.get(slot)
            if st is None:
                batch_seen[slot] = [1, i]
            else:
                rank[i] = st[0]
                st[0] += 1
                is_last[st[1]] = False
                st[1] = i
        return slots, rank, is_last, n_full

    def free_slots(self, slot_indices: Iterable[int]) -> int:
        """Recycle slots reported expired by a sweep; returns count freed."""
        n = 0
        for slot in slot_indices:
            key = self._rev[slot]
            if key is None:
                continue
            del self._map[key]
            self._rev[slot] = None
            self._free.append(slot)
            n += 1
        if n:
            self.mutations += 1
        return n

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        self._free.extend(range(new_capacity - 1, self.capacity - 1, -1))
        self._rev.extend([None] * (new_capacity - self.capacity))
        self.capacity = new_capacity
        self.mutations += 1

    @classmethod
    def from_items(cls, capacity: int, items) -> "PyKeyMap":
        """A keymap holding the given (key, slot) pairs; the free stack
        holds every other slot, lowest popped first."""
        km = cls(capacity)
        for key, slot in items:
            slot = int(slot)
            if not 0 <= slot < capacity or km._rev[slot] is not None:
                raise ValueError(f"slot {slot} out of range or taken")
            km._map[key] = slot
            km._rev[slot] = key
        km._free = [s for s in km._free if km._rev[s] is None]
        return km

    def items(self):
        """(key, slot) pairs for every live entry (snapshot export)."""
        return list(self._map.items())
