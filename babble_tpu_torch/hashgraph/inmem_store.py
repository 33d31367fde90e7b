"""In-memory store backed by LRU caches (reference: src/hashgraph/inmem_store.go)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..common import LRU, RollingIndex, StoreErr, StoreErrType, is_store_err
from ..peers import Peers
from .block import Block
from .caches import ParticipantEventsCache
from .event import Event
from .frame import Frame
from .root import Root, new_base_root
from .round_info import RoundInfo
from .store import Store


# per-chain tail kept safe from eviction: incoming diff events reference
# parents this deep during ordinary gossip races (see _pin_event)
TAIL_PIN = 64


class InmemStore(Store):
    def __init__(self, participants: Peers, cache_size: int, pin_live: bool = True):
        # pin_live=False for write-through use under a persistent store
        # (SQLiteStore): evicted bodies are recoverable from disk there,
        # so the hard cache bound matters more than the pin
        self._cache_size = cache_size
        self._participants = participants
        self._pin = self._pin_event if pin_live else None
        self.event_cache = LRU(cache_size, pin=self._pin)
        self.round_cache = LRU(cache_size)
        self.block_cache = LRU(cache_size)
        self.frame_cache = LRU(cache_size)
        self.consensus_cache = RollingIndex("ConsensusCache", cache_size)
        self.tot_consensus_events = 0
        self.participant_events_cache = ParticipantEventsCache(cache_size, participants)
        self.roots_by_participant: Dict[str, Root] = {
            pk: new_base_root(peer.id) for pk, peer in participants.by_pub_key.items()
        }
        self._roots_by_self_parent: Optional[Dict[str, Root]] = None
        self._last_round = -1
        self.last_consensus_events: Dict[str, str] = {}  # [participant] => last consensus event hex
        self._last_block = -1

    def cache_size(self) -> int:
        return self._cache_size

    def _pin_event(self, key: str, ev: Event) -> bool:
        """LIVE event bodies are exempt from LRU eviction (round 5): a
        body the store's own known-events high-water still claims, but
        whose bytes are gone, livelocks the node — peers' diffs reference
        it as a parent, inserts fail forever, and over_sync_limit never
        trips because the high-water looks current (observed: a survivor
        wedged 960s on three evicted bodies). Live =
        (a) undetermined (no round-received yet: consensus still reads
            it, and a stall makes the undetermined window outgrow any
            fixed cache), or
        (b) within the newest TAIL_PIN of its creator's chain (diff
            inserts resolve parents this deep during gossip races).
        When everything in the scan budget is live the cache grows past
        its bound instead — memory degradation over DAG corruption."""
        if ev.round_received is None:
            return True
        peer = self._participants.by_pub_key.get(ev.creator())
        if peer is None:
            return False
        # single-chain high-water, not known() — the predicate runs per
        # eviction probe and known() materializes a dict over all N
        ri = self.participant_events_cache.rim.mapping.get(peer.id)
        high = ri.get_last_window()[1] if ri is not None else -1
        return ev.index() > high - TAIL_PIN

    def participants(self) -> Peers:
        return self._participants

    def roots_by_self_parent(self) -> Dict[str, Root]:
        if self._roots_by_self_parent is None:
            self._roots_by_self_parent = {
                root.self_parent.hash: root for root in self.roots_by_participant.values()
            }
        return self._roots_by_self_parent

    def get_event(self, key: str) -> Event:
        res, ok = self.event_cache.get(key)
        if not ok:
            raise StoreErr("EventCache", StoreErrType.KEY_NOT_FOUND, key)
        return res

    def set_event(self, event: Event) -> None:
        key = event.hex()
        _, ok = self.event_cache.get(key)
        if not ok:
            self._add_participant_event(event.creator(), key, event.index())
        self.event_cache.add(key, event)

    def _add_participant_event(self, participant: str, hash_: str, index: int) -> None:
        self.participant_events_cache.set(participant, hash_, index)

    def participant_events(self, participant: str, skip: int) -> List[str]:
        return self.participant_events_cache.get(participant, skip)

    def participant_event(self, participant: str, index: int) -> str:
        try:
            return self.participant_events_cache.get_item(participant, index)
        except StoreErr:
            root = self.roots_by_participant.get(participant)
            if root is None:
                raise StoreErr("InmemStore.Roots", StoreErrType.NO_ROOT, participant)
            if root.self_parent.index == index:
                return root.self_parent.hash
            raise

    def last_event_from(self, participant: str) -> Tuple[str, bool]:
        """Returns (hash, is_root)."""
        try:
            return self.participant_events_cache.get_last(participant), False
        except StoreErr as e:
            if is_store_err(e, StoreErrType.EMPTY):
                root = self.roots_by_participant.get(participant)
                if root is not None:
                    return root.self_parent.hash, True
                raise StoreErr("InmemStore.Roots", StoreErrType.NO_ROOT, participant)
            raise

    def last_consensus_event_from(self, participant: str) -> Tuple[str, bool]:
        if participant in self.last_consensus_events:
            return self.last_consensus_events[participant], False
        root = self.roots_by_participant.get(participant)
        if root is not None:
            return root.self_parent.hash, True
        raise StoreErr("InmemStore.Roots", StoreErrType.NO_ROOT, participant)

    def known_events(self) -> Dict[int, int]:
        known = self.participant_events_cache.known()
        for pk, peer in self._participants.by_pub_key.items():
            if known.get(peer.id, -1) == -1:
                root = self.roots_by_participant.get(pk)
                if root is not None:
                    known[peer.id] = root.self_parent.index
        return known

    def consensus_events(self) -> List[str]:
        window, _ = self.consensus_cache.get_last_window()
        return list(window)

    def consensus_events_count(self) -> int:
        return self.tot_consensus_events

    def add_consensus_event(self, event: Event) -> None:
        self.consensus_cache.set(event.hex(), self.tot_consensus_events)
        self.tot_consensus_events += 1
        self.last_consensus_events[event.creator()] = event.hex()

    def seed_last_consensus_event(self, participant: str, event_hex: str) -> None:
        """Fast-sync: install the donor's last-consensus-event baseline for a
        participant without counting it as a locally processed event. Frame
        roots for participants quiet since the anchor are built from this
        (get_frame), so it must match the rest of the network exactly."""
        self.last_consensus_events[participant] = event_hex

    def get_round(self, r: int) -> RoundInfo:
        res, ok = self.round_cache.get(r)
        if not ok:
            raise StoreErr("RoundCache", StoreErrType.KEY_NOT_FOUND, str(r))
        return res

    def set_round(self, r: int, round_info: RoundInfo) -> None:
        self.round_cache.add(r, round_info)
        if r > self._last_round:
            self._last_round = r

    def last_round(self) -> int:
        return self._last_round

    def round_witnesses(self, r: int) -> List[str]:
        try:
            return self.get_round(r).witnesses()
        except StoreErr:
            return []

    def round_events(self, r: int) -> int:
        try:
            return len(self.get_round(r).events)
        except StoreErr:
            return 0

    def get_root(self, participant: str) -> Root:
        root = self.roots_by_participant.get(participant)
        if root is None:
            raise StoreErr("RootCache", StoreErrType.KEY_NOT_FOUND, participant)
        return root

    def get_block(self, index: int) -> Block:
        res, ok = self.block_cache.get(index)
        if not ok:
            raise StoreErr("BlockCache", StoreErrType.KEY_NOT_FOUND, str(index))
        return res

    def set_block(self, block: Block) -> None:
        self.block_cache.add(block.index(), block)
        if block.index() > self._last_block:
            self._last_block = block.index()

    def last_block_index(self) -> int:
        return self._last_block

    def get_frame(self, index: int) -> Frame:
        res, ok = self.frame_cache.get(index)
        if not ok:
            raise StoreErr("FrameCache", StoreErrType.KEY_NOT_FOUND, str(index))
        return res

    def set_frame(self, frame: Frame) -> None:
        self.frame_cache.add(frame.round, frame)

    def reset(self, roots: Dict[str, Root]) -> None:
        self.roots_by_participant = roots
        self._roots_by_self_parent = None
        self.event_cache = LRU(self._cache_size, pin=self._pin)
        self.round_cache = LRU(self._cache_size)
        self.consensus_cache = RollingIndex("ConsensusCache", self._cache_size)
        self.participant_events_cache.reset()
        self._last_round = -1
        self._last_block = -1
        # Beyond the reference (which keeps these, inmem_store.go:272-282):
        # frames and last-consensus-event entries built on the pre-reset
        # timeline would leak into future frame roots and diverge them;
        # after a reset the fast-sync section re-seeds both. Blocks are
        # chain history and survive.
        self.frame_cache = LRU(self._cache_size)
        self.last_consensus_events = {}

    def close(self) -> None:
        pass

    def need_bootstrap(self) -> bool:
        return False

    def store_path(self) -> str:
        return ""
