"""Validator set (reference: src/peers/peers.go:11-16,120-150).

Sorted by ID; the sorted position is the peer's dense coordinate (the column
index of every (events x validators) grid on device).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .peer import Peer


class Peers:
    def __init__(self):
        self._lock = threading.RLock()
        self.sorted: List[Peer] = []  # guarded-by: _lock
        self.by_pub_key: Dict[str, Peer] = {}  # guarded-by: _lock
        self.by_id: Dict[int, Peer] = {}  # guarded-by: _lock

    @classmethod
    def from_slice(cls, source: List[Peer]) -> "Peers":
        # fresh object, not yet shared — lock-free mutation is safe here
        peers = cls()
        for p in source:
            peers._add_raw(p)
        peers._sort()
        return peers

    def _add_raw(self, peer: Peer) -> None:  # requires-lock: _lock
        if peer.id == 0:
            peer.compute_id()
        self.by_pub_key[peer.pub_key_hex] = peer
        self.by_id[peer.id] = peer

    def _sort(self) -> None:  # requires-lock: _lock
        self.sorted = sorted(self.by_pub_key.values(), key=lambda p: p.id)

    def add_peer(self, peer: Peer) -> None:
        with self._lock:
            self._add_raw(peer)
            self._sort()

    def remove_peer(self, peer: Optional[Peer]) -> None:
        with self._lock:
            if peer is None or peer.pub_key_hex not in self.by_pub_key:
                return
            del self.by_pub_key[peer.pub_key_hex]
            del self.by_id[peer.id]
            self._sort()

    def remove_peer_by_pub_key(self, pub_key: str) -> None:
        # unguarded-ok: lookup is re-validated by remove_peer under _lock
        self.remove_peer(self.by_pub_key.get(pub_key))

    def remove_peer_by_id(self, pid: int) -> None:
        # unguarded-ok: lookup is re-validated by remove_peer under _lock
        self.remove_peer(self.by_id.get(pid))

    def to_peer_slice(self) -> List[Peer]:
        # unguarded-ok: _sort rebinds a fresh list; readers see old or new
        return self.sorted

    def to_pub_key_slice(self) -> List[str]:
        # unguarded-ok: _sort rebinds a fresh list; readers see old or new
        return [p.pub_key_hex for p in self.sorted]

    def to_id_slice(self) -> List[int]:
        # unguarded-ok: _sort rebinds a fresh list; readers see old or new
        return [p.id for p in self.sorted]

    def __len__(self) -> int:
        # unguarded-ok: len() on a dict is a single atomic read
        return len(self.by_pub_key)

    def __iter__(self):
        # unguarded-ok: _sort rebinds a fresh list; readers see old or new
        return iter(self.sorted)
