"""Fast-sync live-DAG section — the part of fast-forward that goes beyond
the reference.

The reference's FastForward ships only the anchor block + one Frame
(the consensus events of the anchor round, reference:
src/net/commands.go:31-40, src/hashgraph/hashgraph.go:1125-1231). A joiner
must then *re-decide* every round above the anchor from a DAG whose
pre-frame region it cannot see. Its witness sets and strongly-see
relations around the anchor are incomplete, so its round numbers — and
therefore fame votes, round-received assignments, and block contents —
can diverge from the rest of the network (observed: byte-different
blocks right after a fast-forward; the reference has the same structural
gap and merely logs 'Invalid block signature').

The Section closes the gap by shipping the donor's *decided state* for
everything above the anchor cut:

- every event whose round-received is above the anchor round or still
  undetermined, with authoritative metadata (round, lamport, coordinate
  rows) via Event.to_store_json;
- RoundInfo snapshots for rounds above the anchor (witness flags, fame
  trileans, consensus membership);
- the already-built Frames for rounds (anchor, last-consensus] so the
  joiner replays byte-identical blocks instead of rebuilding them;
- FrozenRefs: (round, lamport, creator, index) for other-parents that sit
  below the cut — enough for root construction without the event bodies.

The joiner replays this state verbatim and only *continues* consensus
from the donor's frontier, which restores determinism: its subsequent
decisions use exactly the data every other node uses.

Trust model: like the reference's Frame minus the anchor-hash check —
the section is donor-trusted (event signatures are still verified;
metadata is not independently verifiable without the frozen region).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .block import Block
from .event import Event
from .frame import Frame
from .round_info import RoundInfo


@dataclass
class FrozenRef:
    """Identity of an event below the section cut, referenced as an
    other-parent by a section event (serves GetFrame root construction)."""

    hash: str
    creator_id: int
    index: int
    round: int
    lamport: int

    def to_json(self) -> dict:
        return {
            "Hash": self.hash,
            "CreatorID": self.creator_id,
            "Index": self.index,
            "Round": self.round,
            "Lamport": self.lamport,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FrozenRef":
        return cls(
            hash=d["Hash"],
            creator_id=d["CreatorID"],
            index=d["Index"],
            round=d["Round"],
            lamport=d["Lamport"],
        )


@dataclass
class Section:
    """Donor state above the anchor cut."""

    anchor_round: int
    last_consensus_round: int
    events: List[Event] = field(default_factory=list)  # topo order, full meta
    rounds: Dict[int, RoundInfo] = field(default_factory=dict)
    frames: List[Frame] = field(default_factory=list)
    frozen_refs: List[FrozenRef] = field(default_factory=list)
    # authoritative (round, lamport) for the anchor frame's own events: the
    # joiner must not recompute them from its amnesiac base, or future
    # frame roots that reference them diverge (the Frame wire format itself
    # cannot carry this — its hash is pinned in the anchor block)
    base_meta: List[FrozenRef] = field(default_factory=list)
    # the donor's stored blocks (with their accumulated validator
    # signatures) per replayed block index: proof material that lets the
    # joiner verify the replayed chain against >1/3 of the validator set
    # before committing anything (Hashgraph.verify_section) — the
    # signatures cover the full block body (index, round, state hash,
    # frame hash, txs), so they must travel with the body they signed
    proof_blocks: Dict[int, Block] = field(default_factory=dict)
    # participant pubkey -> last consensus event hash as of the anchor
    # round: seeds the joiner's last-consensus-event bookkeeping so frame
    # roots for participants quiet since the anchor are built from the
    # same event on every node (divergent roots change the frame hash and
    # break block byte-equality)
    consensus_baseline: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "AnchorRound": self.anchor_round,
            "LastConsensusRound": self.last_consensus_round,
            "Events": [e.to_store_json() for e in self.events],
            "Rounds": {str(r): ri.to_json() for r, ri in self.rounds.items()},
            "Frames": [f.to_json() for f in self.frames],
            "FrozenRefs": [fr.to_json() for fr in self.frozen_refs],
            "BaseMeta": [fr.to_json() for fr in self.base_meta],
            "ProofBlocks": {
                str(i): b.to_json() for i, b in self.proof_blocks.items()
            },
            "ConsensusBaseline": dict(sorted(self.consensus_baseline.items())),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Section":
        return cls(
            anchor_round=d["AnchorRound"],
            last_consensus_round=d["LastConsensusRound"],
            events=[Event.from_store_json(e) for e in d.get("Events", [])],
            rounds={
                int(r): RoundInfo.from_json(ri)
                for r, ri in d.get("Rounds", {}).items()
            },
            frames=[Frame.from_json(f) for f in d.get("Frames", [])],
            frozen_refs=[
                FrozenRef.from_json(fr) for fr in d.get("FrozenRefs", [])
            ],
            base_meta=[FrozenRef.from_json(fr) for fr in d.get("BaseMeta", [])],
            proof_blocks={
                int(i): Block.from_json(b)
                for i, b in d.get("ProofBlocks", {}).items()
            },
            consensus_baseline=dict(d.get("ConsensusBaseline", {})),
        )
