"""Roots: the base layer of a (possibly mid-history) hashgraph
(reference: src/hashgraph/root.go).

Each participant gets a Root; the first event a participant inserts must
attach to it. Roots enable Frame-based reset — initializing a hashgraph from
the middle of another one (fast-sync). Canonical encoding is
consensus-critical because root bytes feed the frame hash
(reference: src/hashgraph/root.go:108-126).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from .event import root_self_parent


@dataclass
class RootEvent:
    hash: str = ""
    creator_id: int = -1
    index: int = -1
    lamport_timestamp: int = -1
    round: int = -1

    def to_canonical(self) -> dict:
        return {
            "Hash": self.hash,
            "CreatorID": self.creator_id,
            "Index": self.index,
            "LamportTimestamp": self.lamport_timestamp,
            "Round": self.round,
        }

    @classmethod
    def from_canonical(cls, d: dict) -> "RootEvent":
        return cls(
            hash=d["Hash"],
            creator_id=d["CreatorID"],
            index=d["Index"],
            lamport_timestamp=d["LamportTimestamp"],
            round=d["Round"],
        )


def new_base_root_event(creator_id: int) -> RootEvent:
    return RootEvent(
        hash=root_self_parent(creator_id),
        creator_id=creator_id,
        index=-1,
        lamport_timestamp=-1,
        round=-1,
    )


@dataclass
class Root:
    next_round: int = 0
    self_parent: RootEvent = field(default_factory=RootEvent)
    others: Dict[str, RootEvent] = field(default_factory=dict)

    def to_canonical(self) -> dict:
        return {
            "NextRound": self.next_round,
            "SelfParent": self.self_parent.to_canonical(),
            "Others": {k: v.to_canonical() for k, v in sorted(self.others.items())},
        }

    @classmethod
    def from_canonical(cls, d: dict) -> "Root":
        return cls(
            next_round=d["NextRound"],
            self_parent=RootEvent.from_canonical(d["SelfParent"]),
            others={k: RootEvent.from_canonical(v) for k, v in d["Others"].items()},
        )


def new_base_root(creator_id: int) -> Root:
    return Root(next_round=0, self_parent=new_base_root_event(creator_id), others={})
