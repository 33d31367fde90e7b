"""peers.json store (reference: src/peers/json_peers.go:13-72)."""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

from .peer import Peer
from .peers import Peers

JSON_PEER_FILE = "peers.json"


class JSONPeers:
    def __init__(self, base: str):
        self.path = os.path.join(base, JSON_PEER_FILE)
        self._lock = threading.Lock()

    def peers(self) -> Optional[Peers]:
        with self._lock:
            with open(self.path, "rb") as f:
                buf = f.read()
            if not buf:
                return None
            peer_set = [Peer.from_json(d) for d in json.loads(buf)]
            return Peers.from_slice(peer_set)

    def set_peers(self, peers: List[Peer]) -> None:
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                json.dump([p.to_json() for p in peers], f)
