from .event import Event, EventBody, WireEvent, WireBody, root_self_parent, by_lamport_key
from .root import Root, RootEvent, new_base_root, new_base_root_event
from .round_info import RoundInfo, RoundEvent, Trilean, PendingRound
from .frame import Frame
from .section import FrozenRef, Section
from .block import Block, BlockBody, BlockSignature, WireBlockSignature, new_block_from_frame
from .store import Store
from .inmem_store import InmemStore
from .caches import ParticipantEventsCache, ParticipantBlockSignaturesCache
from .hashgraph import Hashgraph
from .carry import hashgraph_from_events

__all__ = [
    "Event",
    "EventBody",
    "WireEvent",
    "WireBody",
    "root_self_parent",
    "by_lamport_key",
    "Root",
    "RootEvent",
    "new_base_root",
    "new_base_root_event",
    "RoundInfo",
    "RoundEvent",
    "Trilean",
    "PendingRound",
    "Frame",
    "FrozenRef",
    "Section",
    "Block",
    "BlockBody",
    "BlockSignature",
    "WireBlockSignature",
    "new_block_from_frame",
    "Store",
    "InmemStore",
    "ParticipantEventsCache",
    "ParticipantBlockSignaturesCache",
    "Hashgraph",
    "hashgraph_from_events",
]
