"""Per-participant rolling caches (reference: src/hashgraph/caches.go).

ParticipantEventsCache holds each validator's recent event hashes by
creator-sequence index — powering EventDiff and wire-ID resolution.
"""

from __future__ import annotations

from typing import Dict, List

from ..common import RollingIndexMap, StoreErr, StoreErrType
from ..peers import Peers
from .block import BlockSignature


class ParticipantEventsCache:
    def __init__(self, size: int, participants: Peers):
        self.participants = participants
        self.rim = RollingIndexMap("ParticipantEvents", size, participants.to_id_slice())

    def _participant_id(self, participant: str) -> int:
        peer = self.participants.by_pub_key.get(participant)
        if peer is None:
            raise StoreErr("ParticipantEvents", StoreErrType.UNKNOWN_PARTICIPANT, participant)
        return peer.id

    def get(self, participant: str, skip_index: int) -> List[str]:
        return list(self.rim.get(self._participant_id(participant), skip_index))

    def get_item(self, participant: str, index: int) -> str:
        return self.rim.get_item(self._participant_id(participant), index)

    def get_last(self, participant: str) -> str:
        return self.rim.get_last(self._participant_id(participant))

    def set(self, participant: str, hash_: str, index: int) -> None:
        self.rim.set(self._participant_id(participant), hash_, index)

    def known(self) -> Dict[int, int]:
        return self.rim.known()

    def reset(self) -> None:
        self.rim.reset()


class ParticipantBlockSignaturesCache:
    def __init__(self, size: int, participants: Peers):
        self.participants = participants
        self.rim = RollingIndexMap(
            "ParticipantBlockSignatures", size, participants.to_id_slice()
        )

    def _participant_id(self, participant: str) -> int:
        peer = self.participants.by_pub_key.get(participant)
        if peer is None:
            raise StoreErr(
                "ParticipantBlockSignatures", StoreErrType.UNKNOWN_PARTICIPANT, participant
            )
        return peer.id

    def get(self, participant: str, skip_index: int) -> List[BlockSignature]:
        return list(self.rim.get(self._participant_id(participant), skip_index))

    def get_item(self, participant: str, index: int) -> BlockSignature:
        return self.rim.get_item(self._participant_id(participant), index)

    def get_last(self, participant: str) -> BlockSignature:
        return self.rim.get_last(self._participant_id(participant))

    def set(self, participant: str, sig: BlockSignature) -> None:
        self.rim.set(self._participant_id(participant), sig, sig.index)

    def known(self) -> Dict[int, int]:
        return self.rim.known()

    def reset(self) -> None:
        self.rim.reset()
