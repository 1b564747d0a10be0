"""Slot KV pool for the serving engine, ported from the ``CachePool`` of
src/repro/serving/cache_pool.py (the paged pool is not ported yet)."""
from __future__ import annotations

from typing import Dict, List, Optional


class CachePool:
    """Fixed pool of KV cache slots, acquired/released as requests come and go.

    The cache tensors are laid out (n_layers, num_slots, max_seq_len, ...):
    slot i owns batch row i.  A warm tick rewrites the whole pool's K/V in
    place (models/transformer.py), so :meth:`update` only rebinds.
    """

    def __init__(self, model, num_slots: int, max_seq_len: int,
                 with_cache: bool = True):
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.cache: Optional[Dict] = (
            model.init_cache(num_slots, max_seq_len) if with_cache else None)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self.acquires = 0
        self.releases = 0
        self.peak_in_use = 0

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_slots - len(self._free)

    def acquire(self) -> int:
        """Claim a free slot index; raises RuntimeError when the pool is full
        (the engine checks ``free_slots`` before admitting)."""
        if not self._free:
            raise RuntimeError("cache pool exhausted")
        slot = self._free.pop()
        self.acquires += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return slot

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-released")
        self._free.append(slot)
        self.releases += 1

    def update(self, new_cache) -> None:
        """Store the cache returned by a warm tick."""
        self.cache = new_cache
