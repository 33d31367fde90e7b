"""Bounded sequential window (reference: src/common/rolling_index.go:5-98).

Holds up to 2*size gap-free items; when full, rolls by dropping the oldest
`size` items. Indexes are absolute (the producer's sequence numbers).
"""

from __future__ import annotations

from typing import Any, List, Tuple

from .errors import StoreErr, StoreErrType


class RollingIndex:
    def __init__(self, name: str, size: int):
        self.name = name
        self.size = size
        self.last_index = -1
        self.items: List[Any] = []

    def get_last_window(self) -> Tuple[List[Any], int]:
        return self.items, self.last_index

    def get(self, skip_index: int) -> List[Any]:
        """Items with absolute index > skip_index."""
        if skip_index > self.last_index:
            return []
        oldest_cached = self.last_index - len(self.items) + 1
        if skip_index + 1 < oldest_cached:
            raise StoreErr(self.name, StoreErrType.TOO_LATE, str(skip_index))
        start = skip_index - oldest_cached + 1
        return self.items[start:]

    def get_item(self, index: int) -> Any:
        oldest_cached = self.last_index - len(self.items) + 1
        if index < oldest_cached:
            raise StoreErr(self.name, StoreErrType.TOO_LATE, str(index))
        pos = index - oldest_cached
        if pos >= len(self.items):
            raise StoreErr(self.name, StoreErrType.KEY_NOT_FOUND, str(index))
        return self.items[pos]

    def set(self, item: Any, index: int) -> None:
        if 0 <= self.last_index and index > self.last_index + 1:
            raise StoreErr(self.name, StoreErrType.SKIPPED_INDEX, str(index))

        if self.last_index < 0 or index == self.last_index + 1:
            if len(self.items) >= 2 * self.size:
                self.roll()
            self.items.append(item)
            self.last_index = index
            return

        oldest_cached = self.last_index - len(self.items) + 1
        if index < oldest_cached:
            raise StoreErr(self.name, StoreErrType.TOO_LATE, str(index))
        self.items[index - oldest_cached] = item

    def roll(self) -> None:
        self.items = self.items[self.size:]
