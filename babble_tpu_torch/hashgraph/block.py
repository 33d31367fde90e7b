"""Blockchain projection of consensus rounds (reference: src/hashgraph/block.go).

A Block carries the ordered transactions of one consensus round, the frame
hash anchoring it to the DAG, the app's state hash, and a map of validator
signatures collected via the gossiped signature pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .. import crypto
from ..utils.codec import canonical_dumps, b64e, b64d


@dataclass
class WireBlockSignature:
    index: int = -1
    signature: str = ""


@dataclass
class BlockSignature:
    validator: bytes = b""
    index: int = -1
    signature: str = ""

    def validator_hex(self) -> str:
        return "0x" + self.validator.hex().upper()

    def to_wire(self) -> WireBlockSignature:
        return WireBlockSignature(index=self.index, signature=self.signature)

    def to_canonical(self) -> dict:
        return {"Validator": b64e(self.validator), "Index": self.index, "Signature": self.signature}

    @classmethod
    def from_canonical(cls, d: dict) -> "BlockSignature":
        return cls(validator=b64d(d["Validator"]), index=d["Index"], signature=d["Signature"])


@dataclass
class BlockBody:
    index: int = -1
    round_received: int = -1
    state_hash: bytes = b""
    frame_hash: bytes = b""
    transactions: List[bytes] = field(default_factory=list)

    def to_canonical(self) -> dict:
        return {
            "Index": self.index,
            "RoundReceived": self.round_received,
            "StateHash": b64e(self.state_hash),
            "FrameHash": b64e(self.frame_hash),
            "Transactions": [b64e(t) for t in self.transactions],
        }

    def marshal(self) -> bytes:
        return canonical_dumps(self.to_canonical())

    def hash(self) -> bytes:
        return crypto.sha256(self.marshal())


class Block:
    def __init__(
        self,
        index: int = -1,
        round_received: int = -1,
        frame_hash: bytes = b"",
        transactions: List[bytes] | None = None,
    ):
        self.body = BlockBody(
            index=index,
            round_received=round_received,
            frame_hash=frame_hash,
            transactions=list(transactions or []),
        )
        self.signatures: Dict[str, str] = {}  # [validator hex] => signature
        self._hash: bytes = b""

    def index(self) -> int:
        return self.body.index

    def transactions(self) -> List[bytes]:
        return self.body.transactions

    def round_received(self) -> int:
        return self.body.round_received

    def state_hash(self) -> bytes:
        return self.body.state_hash

    def frame_hash(self) -> bytes:
        return self.body.frame_hash

    def get_signatures(self) -> List[BlockSignature]:
        return [
            BlockSignature(
                validator=bytes.fromhex(val[2:]), index=self.index(), signature=sig
            )
            for val, sig in self.signatures.items()
        ]

    def get_signature(self, validator: str) -> BlockSignature:
        if validator not in self.signatures:
            raise KeyError("signature not found")
        return BlockSignature(
            validator=bytes.fromhex(validator[2:]),
            index=self.index(),
            signature=self.signatures[validator],
        )

    def append_transactions(self, txs: List[bytes]) -> None:
        self.body.transactions.extend(txs)

    def marshal(self) -> bytes:
        return canonical_dumps(self.to_json())

    def hash(self) -> bytes:
        # frozen on first call so a block's identity does not drift as
        # signatures are attached (reference: src/hashgraph/block.go:196-205)
        if not self._hash:
            self._hash = crypto.sha256(self.marshal())
        return self._hash

    def hex(self) -> str:
        return "0x" + self.hash().hex().upper()

    def sign(self, key) -> BlockSignature:
        r, s = crypto.sign(key, self.body.hash())
        return BlockSignature(
            validator=crypto.pub_key_bytes(key),
            index=self.index(),
            signature=crypto.encode_signature(r, s),
        )

    def set_signature(self, bs: BlockSignature) -> None:
        self.signatures[bs.validator_hex()] = bs.signature

    def verify(self, sig: BlockSignature) -> bool:
        pub = crypto.pub_key_from_bytes(sig.validator)
        try:
            r, s = crypto.decode_signature(sig.signature)
        except ValueError:
            return False
        return crypto.verify(pub, self.body.hash(), r, s)

    def to_json(self) -> dict:
        return {
            "Body": self.body.to_canonical(),
            "Signatures": dict(sorted(self.signatures.items())),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Block":
        b = d["Body"]
        block = cls(
            index=b["Index"],
            round_received=b["RoundReceived"],
            frame_hash=b64d(b["FrameHash"]),
            transactions=[b64d(t) for t in b["Transactions"]],
        )
        block.body.state_hash = b64d(b["StateHash"])
        block.signatures = dict(d.get("Signatures", {}))
        return block

    def __repr__(self) -> str:
        return f"Block(#{self.index()}, rr={self.round_received()}, txs={len(self.transactions())})"


def new_block_from_frame(block_index: int, frame) -> Block:
    transactions: List[bytes] = []
    for e in frame.events:
        transactions.extend(e.transactions())
    return Block(
        index=block_index,
        round_received=frame.round,
        frame_hash=frame.hash(),
        transactions=transactions,
    )
