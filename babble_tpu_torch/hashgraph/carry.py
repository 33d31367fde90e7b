"""Carry a DAG across into this package's Hashgraph.

The port keeps its own host layer, and its engines catch its own StoreErr
and GridUnsupported; a hashgraph of another package would raise classes
past those handlers. A DAG crosses as JSON instead: peers as
`Peer.to_json()` dicts, events as `Event.to_json()` dicts, the same
encodings the store and the wire use.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from ..peers import Peer, Peers
from .block import Block
from .event import Event
from .hashgraph import Hashgraph
from .inmem_store import InmemStore


def hashgraph_from_events(
    peers_json: Iterable[dict],
    events_json: Iterable[dict],
    cache_size: int = 1000,
    commit_callback: Optional[Callable[[Block], None]] = None,
) -> Hashgraph:
    """A fresh Hashgraph over an InmemStore holding the given peers and the
    given events, inserted in the order given (which must be topological).
    Each insert checks the event's signature and computes its coordinates,
    as a gossip insert does; no consensus pass runs."""
    participants = Peers.from_slice([Peer.from_json(p) for p in peers_json])
    hg = Hashgraph(
        participants, InmemStore(participants, cache_size),
        commit_callback=commit_callback,
    )
    for d in events_json:
        hg.insert_event(Event.from_json(d), True)
    return hg
