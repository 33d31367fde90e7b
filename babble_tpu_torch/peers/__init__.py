from .peer import Peer, exclude_peer
from .peers import Peers
from .json_peers import JSONPeers

__all__ = ["Peer", "Peers", "JSONPeers", "exclude_peer"]
