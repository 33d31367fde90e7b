"""FNV-1a 32-bit hash used for peer IDs (reference: src/common/hash32.go:5-11)."""

from __future__ import annotations

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF


def hash32(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h
