"""Validator identity (reference: src/peers/peer.go:13-70).

A peer's ID is the FNV-1a 32-bit hash of its raw public-key bytes; IDs also
index the dense on-device grids via the peer's position in the sorted set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..common import hash32


@dataclass
class Peer:
    net_addr: str = ""
    pub_key_hex: str = ""
    id: int = field(default=0)

    def __post_init__(self):
        if self.id == 0 and self.pub_key_hex:
            self.compute_id()

    def pub_key_bytes(self) -> bytes:
        return bytes.fromhex(self.pub_key_hex[2:])

    def compute_id(self) -> None:
        self.id = hash32(self.pub_key_bytes())

    def to_json(self) -> dict:
        return {"NetAddr": self.net_addr, "PubKeyHex": self.pub_key_hex}

    @classmethod
    def from_json(cls, d: dict) -> "Peer":
        return cls(net_addr=d.get("NetAddr", ""), pub_key_hex=d.get("PubKeyHex", ""))


def exclude_peer(peers: List[Peer], addr: str) -> Tuple[int, List[Peer]]:
    """Remove the peer with the given net address; returns (index, remaining)."""
    index = -1
    others: List[Peer] = []
    for i, p in enumerate(peers):
        if p.net_addr != addr:
            others.append(p)
        else:
            index = i
    return index, others
