from .clock import Clock, SystemClock, SYSTEM_CLOCK
from .errors import StoreErr, StoreErrType, is_store_err
from .lru import LRU
from .rolling_index import RollingIndex
from .rolling_index_map import RollingIndexMap
from .hash32 import hash32

__all__ = [
    "Clock",
    "SystemClock",
    "SYSTEM_CLOCK",
    "StoreErr",
    "StoreErrType",
    "is_store_err",
    "LRU",
    "RollingIndex",
    "RollingIndexMap",
    "hash32",
]
