"""The voting-table layout knob of the port (counterpart of
babble_tpu/tpu/packed.py:61-108 and its table-footprint gauge).

The reference packs the validator axis of its voting tables into uint32
lanes from 128 validators up ("auto"), or as the process-wide mode says
("0" | "1" | "auto"; env BABBLE_PACKED_VOTING wins). The port resolves
the same mode with the same rules but has the wide layout only: every
engine raises NotImplementedError where the packed one resolves, before
it touches any state. The lane helpers (pack_bits, popcount tallies) are
still to be ported.
"""

from __future__ import annotations

import os
from typing import Optional

LANE = 32

# "auto" threshold: the reference's
PACKED_AUTO_MIN_N = 128

# process-wide default; the env var (read per call) overrides it
_MODE = "auto"
_VALID_MODES = ("0", "1", "auto")


def set_packed_mode(mode: str) -> None:
    """Install the process-wide packed-voting mode ("0" | "1" | "auto")."""
    global _MODE
    mode = str(mode).strip().lower()
    if mode not in _VALID_MODES:
        raise ValueError(
            f"packed_voting must be one of {_VALID_MODES}, got {mode!r}"
        )
    _MODE = mode


def packed_mode() -> str:
    """Effective mode: BABBLE_PACKED_VOTING when set, else the installed
    process default."""
    env = os.environ.get("BABBLE_PACKED_VOTING", "").strip().lower()
    if env in _VALID_MODES:
        return env
    return _MODE


def packed_enabled(n_participants: int) -> bool:
    """Resolve the mode for a grid of `n_participants` validators."""
    mode = packed_mode()
    if mode == "1":
        return True
    if mode == "0":
        return False
    return n_participants >= PACKED_AUTO_MIN_N


def resolve_packed(packed: Optional[bool], n_participants: int) -> bool:
    """Per-call override (`packed=` kwarg) falling back to the knob."""
    return packed_enabled(n_participants) if packed is None else bool(packed)


def packed_words(n: int) -> int:
    """uint32 words per packed row of n validator columns."""
    return (n + LANE - 1) // LANE


def voting_table_bytes(n: int, r_rounds: int, packed: bool) -> dict:
    """Device-resident bytes of the (R, N, N-lane) voting tables in the
    given layout: bool lanes wide, uint32 words packed."""
    per_row = 4 * packed_words(n) if packed else n
    return {
        "strongly_seen": r_rounds * n * per_row,
        "votes": r_rounds * n * per_row,
    }


def observe_table_bytes(obs, n: int, r_rounds: int, packed: bool) -> dict:
    """Publish the voting-table footprint of the layout that just ran
    (gauge `babble_device_table_bytes`, labels table/layout)."""
    layout = "packed" if packed else "wide"
    gauge = obs.gauge(
        "babble_device_table_bytes",
        "Device-resident bytes per voting table in the active layout",
        labels=("table", "layout"),
    )
    sizes = voting_table_bytes(n, r_rounds, packed)
    for table, nbytes in sizes.items():
        gauge.labels(table=table, layout=layout).set(nbytes)
    return sizes
