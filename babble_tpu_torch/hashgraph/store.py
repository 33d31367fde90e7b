"""Storage abstraction for events, rounds, roots, blocks, and frames
(reference: src/hashgraph/store.go:5-34)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Tuple

from .block import Block
from .event import Event
from .frame import Frame
from .root import Root
from .round_info import RoundInfo


class Store(ABC):
    @abstractmethod
    def cache_size(self) -> int: ...

    @abstractmethod
    def participants(self): ...

    @abstractmethod
    def roots_by_self_parent(self) -> Dict[str, Root]: ...

    @abstractmethod
    def get_event(self, key: str) -> Event: ...

    @abstractmethod
    def set_event(self, event: Event) -> None: ...

    @abstractmethod
    def participant_events(self, participant: str, skip: int) -> List[str]: ...

    @abstractmethod
    def participant_event(self, participant: str, index: int) -> str: ...

    @abstractmethod
    def last_event_from(self, participant: str) -> Tuple[str, bool]: ...

    @abstractmethod
    def last_consensus_event_from(self, participant: str) -> Tuple[str, bool]: ...

    @abstractmethod
    def known_events(self) -> Dict[int, int]: ...

    @abstractmethod
    def consensus_events(self) -> List[str]: ...

    @abstractmethod
    def consensus_events_count(self) -> int: ...

    @abstractmethod
    def add_consensus_event(self, event: Event) -> None: ...

    @abstractmethod
    def seed_last_consensus_event(self, participant: str, event_hex: str) -> None:
        """Install a fast-sync baseline for last_consensus_event_from
        without counting a locally processed event (Hashgraph.apply_section)."""

    @abstractmethod
    def get_round(self, r: int) -> RoundInfo: ...

    @abstractmethod
    def set_round(self, r: int, round_info: RoundInfo) -> None: ...

    @abstractmethod
    def last_round(self) -> int: ...

    @abstractmethod
    def round_witnesses(self, r: int) -> List[str]: ...

    @abstractmethod
    def round_events(self, r: int) -> int: ...

    @abstractmethod
    def get_root(self, participant: str) -> Root: ...

    @abstractmethod
    def get_block(self, index: int) -> Block: ...

    @abstractmethod
    def set_block(self, block: Block) -> None: ...

    @abstractmethod
    def last_block_index(self) -> int: ...

    @abstractmethod
    def get_frame(self, index: int) -> Frame: ...

    @abstractmethod
    def set_frame(self, frame: Frame) -> None: ...

    @abstractmethod
    def reset(self, roots: Dict[str, Root]) -> None: ...

    @abstractmethod
    def close(self) -> None: ...

    @abstractmethod
    def need_bootstrap(self) -> bool: ...

    @abstractmethod
    def store_path(self) -> str: ...
