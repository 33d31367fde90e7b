"""Per-key RollingIndex map (reference: src/common/rolling_index_map.go:8-87)."""

from __future__ import annotations

from typing import Any, Dict, List

from .errors import StoreErr, StoreErrType
from .rolling_index import RollingIndex


class RollingIndexMap:
    def __init__(self, name: str, size: int, keys: List[int]):
        self.name = name
        self.size = size
        self.keys = list(keys)
        self.mapping: Dict[int, RollingIndex] = {
            k: RollingIndex(f"{name}[{k}]", size) for k in keys
        }

    def get(self, key: int, skip_index: int) -> List[Any]:
        if key not in self.mapping:
            raise StoreErr(self.name, StoreErrType.KEY_NOT_FOUND, str(key))
        return self.mapping[key].get(skip_index)

    def get_item(self, key: int, index: int) -> Any:
        return self.mapping[key].get_item(index)

    def get_last(self, key: int) -> Any:
        if key not in self.mapping:
            raise StoreErr(self.name, StoreErrType.KEY_NOT_FOUND, str(key))
        cached, _ = self.mapping[key].get_last_window()
        if not cached:
            raise StoreErr(self.name, StoreErrType.EMPTY, "")
        return cached[-1]

    def set(self, key: int, item: Any, index: int) -> None:
        if key not in self.mapping:
            self.mapping[key] = RollingIndex(f"{self.name}[{key}]", self.size)
        self.mapping[key].set(item, index)

    def known(self) -> Dict[int, int]:
        """[key] => last known absolute index."""
        return {k: ri.get_last_window()[1] for k, ri in self.mapping.items()}

    def reset(self) -> None:
        self.mapping = {k: RollingIndex(f"{self.name}[{k}]", self.size) for k in self.keys}
