"""Canonical deterministic encoding.

Consensus-critical hashes (event bodies, block bodies, frames, roots) must be
computed over a byte representation that every validator derives identically.
The reference leans on Go's encoding/json + ugorji canonical mode for this
(reference: src/hashgraph/root.go:108-126); we define a single canonical JSON
form used everywhere: sorted keys, compact separators, bytes as base64 text.
"""

from __future__ import annotations

import base64
import json
from typing import Any


def b64e(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def b64d(text: str) -> bytes:
    return base64.b64decode(text.encode("ascii"))


def _default(obj: Any):
    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": b64e(bytes(obj))}
    if hasattr(obj, "to_canonical"):
        return obj.to_canonical()
    raise TypeError(f"not canonically encodable: {type(obj)!r}")


def canonical_dumps(obj: Any) -> bytes:
    """Deterministic byte encoding of a JSON-able structure."""
    return json.dumps(
        obj,
        sort_keys=True,
        separators=(",", ":"),
        ensure_ascii=True,
        default=_default,
    ).encode("utf-8")


def _revive(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__b64__"}:
            return b64d(obj["__b64__"])
        return {k: _revive(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_revive(v) for v in obj]
    return obj


def canonical_loads(data: bytes) -> Any:
    return _revive(json.loads(data.decode("utf-8")))
