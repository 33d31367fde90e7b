"""SHA-256 and the simple Merkle fold (reference: src/crypto/hash.go:7-33)."""

from __future__ import annotations

import hashlib
from typing import List, Optional


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def simple_hash_from_two_hashes(left: bytes, right: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(left)
    h.update(right)
    return h.digest()


def simple_hash_from_hashes(hashes: List[bytes]) -> Optional[bytes]:
    if len(hashes) == 0:
        return None
    if len(hashes) == 1:
        return hashes[0]
    mid = (len(hashes) + 1) // 2
    left = simple_hash_from_hashes(hashes[:mid])
    right = simple_hash_from_hashes(hashes[mid:])
    return simple_hash_from_two_hashes(left, right)
