"""Per-round event registry with witness/famous/consensus flags
(reference: src/hashgraph/roundInfo.go).

Unlike the reference's Go maps (whose iteration order is random — safe only
because the algorithm is order-independent), we keep insertion-ordered dicts,
giving deterministic iteration everywhere for free.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List


class Trilean(enum.IntEnum):
    UNDEFINED = 0
    TRUE = 1
    FALSE = 2

    def __str__(self) -> str:
        return {0: "Undefined", 1: "True", 2: "False"}[int(self)]


@dataclass
class PendingRound:
    index: int
    decided: bool = False


@dataclass
class RoundEvent:
    consensus: bool = False
    witness: bool = False
    famous: Trilean = Trilean.UNDEFINED


@dataclass
class RoundInfo:
    events: Dict[str, RoundEvent] = field(default_factory=dict)
    queued: bool = False

    def add_event(self, x: str, witness: bool) -> None:
        if x not in self.events:
            self.events[x] = RoundEvent(witness=witness)

    def set_consensus_event(self, x: str) -> None:
        e = self.events.setdefault(x, RoundEvent())
        e.consensus = True

    def set_fame(self, x: str, famous: bool) -> None:
        e = self.events.setdefault(x, RoundEvent(witness=True))
        e.famous = Trilean.TRUE if famous else Trilean.FALSE

    def witnesses_decided(self) -> bool:
        """True if no witness's fame is left undefined."""
        return all(
            not e.witness or e.famous != Trilean.UNDEFINED for e in self.events.values()
        )

    def witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness]

    def round_events(self) -> List[str]:
        return [x for x, e in self.events.items() if not e.consensus]

    def consensus_events(self) -> List[str]:
        return [x for x, e in self.events.items() if e.consensus]

    def famous_witnesses(self) -> List[str]:
        return [x for x, e in self.events.items() if e.witness and e.famous == Trilean.TRUE]

    def is_decided(self, witness: str) -> bool:
        e = self.events.get(witness)
        return e is not None and e.witness and e.famous != Trilean.UNDEFINED

    def to_json(self) -> dict:
        # `queued` is deliberately NOT serialized: it is node-local pipeline
        # state; a bootstrap replay must re-queue persisted rounds (the
        # reference keeps it unexported for the same effect,
        # reference: src/hashgraph/roundInfo.go:35)
        return {
            "Events": {
                x: {"Consensus": e.consensus, "Witness": e.witness, "Famous": int(e.famous)}
                for x, e in self.events.items()
            },
        }

    @classmethod
    def from_json(cls, d: dict) -> "RoundInfo":
        ri = cls(queued=False)
        for x, e in d.get("Events", {}).items():
            ri.events[x] = RoundEvent(
                consensus=e["Consensus"], witness=e["Witness"], famous=Trilean(e["Famous"])
            )
        return ri
