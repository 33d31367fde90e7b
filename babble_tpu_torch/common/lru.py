"""Bounded LRU cache (reference: src/common/lru.go:11-156).

Python's OrderedDict gives us the recency list for free; the optional
eviction callback mirrors the reference API.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional


class LRU:
    def __init__(
        self,
        size: int,
        on_evict: Optional[Callable[[Any, Any], None]] = None,
        pin: Optional[Callable[[Any, Any], bool]] = None,
    ):
        if size <= 0:
            raise ValueError("LRU size must be positive")
        self.size = size
        self.on_evict = on_evict
        # `pin(key, value) -> True` exempts an entry from eviction (round
        # 5): evicting an event body that gossip still needs — an
        # undetermined event, or a parent peers' diffs will reference —
        # silently corrupts the DAG store and livelocks the node (its
        # known-events high-water still claims the body, so peers never
        # resend it). A store that would have to drop pinned state grows
        # past `size` instead: memory degradation over corruption.
        self.pin = pin
        self._items: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key) -> bool:
        return key in self._items

    def get(self, key):
        """Returns (value, True) and refreshes recency, or (None, False)."""
        try:
            self._items.move_to_end(key)
        except KeyError:
            return None, False
        return self._items[key], True

    def peek(self, key):
        """Returns (value, True) without refreshing recency."""
        if key in self._items:
            return self._items[key], True
        return None, False

    def add(self, key, value) -> bool:
        """Adds a value; returns True if an eviction occurred."""
        if key in self._items:
            self._items.move_to_end(key)
            self._items[key] = value
            return False
        self._items[key] = value
        if len(self._items) > self.size:
            if self.pin is None:
                old_key, old_val = self._items.popitem(last=False)
                if self.on_evict is not None:
                    self.on_evict(old_key, old_val)
                return True
            # bounded victim scan from the oldest end: evict unpinned
            # entries until back under the bound; pinned entries
            # encountered are recycled to the back (they ARE hot —
            # amortizes the scan and keeps the pinned prefix from being
            # rescanned every add). The budget bounds per-add cost; any
            # overage it leaves (all probes pinned) is reclaimed by later
            # adds, whose loop keeps draining while len > size.
            evicted = False
            for _ in range(8):
                if len(self._items) <= self.size:
                    break
                old_key = next(iter(self._items))
                old_val = self._items[old_key]
                if self.pin(old_key, old_val):
                    self._items.move_to_end(old_key)
                    continue
                del self._items[old_key]
                if self.on_evict is not None:
                    self.on_evict(old_key, old_val)
                evicted = True
            return evicted
        return False

    def remove(self, key) -> bool:
        if key in self._items:
            del self._items[key]
            return True
        return False

    def keys(self):
        """Keys oldest-to-newest."""
        return list(self._items.keys())

    def purge(self) -> None:
        if self.on_evict is not None:
            for k, v in self._items.items():
                self.on_evict(k, v)
        self._items.clear()
