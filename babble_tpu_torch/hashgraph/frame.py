"""Frame: a self-contained DAG section used for fast-sync
(reference: src/hashgraph/frame.go, docs/fastsync.rst:52-75).

Hash is the SHA-256 of the canonical encoding; it is pinned into block
headers, so it must be byte-stable across validators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from .. import crypto
from ..utils.codec import canonical_dumps
from .event import Event
from .root import Root


@dataclass
class Frame:
    round: int = -1  # the round received
    roots: List[Root] = field(default_factory=list)  # [peer position] => Root
    events: List[Event] = field(default_factory=list)
    # frozen on first computation: a frame is immutable once built (it is
    # stored and pinned into block headers), and the canonical marshal of
    # every contained event is expensive enough to dominate block
    # construction if recomputed (new_block_from_frame + the store both
    # ask for the hash)
    _hash: bytes = field(default=b"", repr=False, compare=False)

    def to_canonical(self) -> dict:
        return {
            "Round": self.round,
            "Roots": [r.to_canonical() for r in self.roots],
            "Events": [e.to_canonical() for e in self.events],
        }

    def marshal(self) -> bytes:
        return canonical_dumps(self.to_canonical())

    def hash(self) -> bytes:
        if not self._hash:
            self._hash = crypto.sha256(self.marshal())
        return self._hash

    def to_json(self) -> dict:
        return {
            "Round": self.round,
            "Roots": [r.to_canonical() for r in self.roots],
            "Events": [e.to_json() for e in self.events],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Frame":
        return cls(
            round=d["Round"],
            roots=[Root.from_canonical(r) for r in d["Roots"]],
            events=[Event.from_json(e) for e in d["Events"]],
        )
