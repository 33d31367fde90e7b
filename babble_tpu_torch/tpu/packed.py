"""The packed voting layout of the port (counterpart of
babble_tpu/tpu/packed.py: the layout knob, the uint32 lane helpers and the
table-footprint gauge).

The packed layout holds the validator axis of the boolean voting tables
(the strongly-seen tensor and the carried votes) in uint32 lanes,

    word w, bit k  <->  validator column w * 32 + k      (little-endian)

and takes every supermajority tally as a popcount over the words. It is
a layout, never an observable: every decision is integer-equal to the
wide layout's. The reference turns it on from 128 validators up ("auto"),
or as the process-wide mode says ("0" | "1" | "auto"; env
BABBLE_PACKED_VOTING wins); the port resolves the same mode with the same
rules, and its kernels take the layout that resolves (decide_fame,
divide_rounds, step_levels, decide_window).

Words are torch.int32 tensors that hold the uint32 bit pattern (torch has
no usable uint32 shifts or popcount on the CPU): tests compare them with
the reference through `.numpy().view(np.uint32)`. The trailing lanes of a
partial word are zero, so they add nothing to any popcount.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

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


# ---------------------------------------------------------------------------
# lane packing and popcount tallies (babble_tpu/tpu/packed.py:120-171)
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def _as_uint(words: torch.Tensor) -> torch.Tensor:
    """int32 words as their uint32 values, held in int64."""
    return words.to(torch.int64) & (_U32 - 1)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack the trailing boolean axis into uint32 lanes (bit k of word w is
    element w * 32 + k), int32 words; the trailing partial word is
    zero-filled. Assembled one lane at a time, so nothing larger than the
    words is materialised beside x."""
    n = x.shape[-1]
    w = packed_words(n)
    pad = w * LANE - n
    x = x.to(torch.bool)
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    xr = x.reshape(x.shape[:-1] + (w, LANE))
    words = torch.zeros(x.shape[:-1] + (w,), dtype=torch.int32, device=x.device)
    for k in range(LANE - 1):
        words |= xr[..., k].to(torch.int32) << k
    # bit 31 is the int32 sign bit
    top = torch.full_like(words, -(1 << 31))
    return words | torch.where(xr[..., LANE - 1], top, torch.zeros_like(words))


def unpack_bits(xp: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_bits: expand packed words back to n boolean lanes."""
    shifts = torch.arange(LANE, dtype=torch.int64, device=xp.device)
    bits = (_as_uint(xp)[..., None] >> shifts) & 1
    flat = bits.reshape(xp.shape[:-1] + (xp.shape[-1] * LANE,))
    return flat[..., :n].to(torch.bool)


def popcount_sum(xp: torch.Tensor) -> torch.Tensor:
    """Total set-bit count over the trailing word axis (int32), the packed
    form of a boolean row's sum; a SWAR popcount of each word in int64."""
    v = _as_uint(xp)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & (_U32 - 1)) >> 24
    return v.sum(dim=-1, dtype=torch.int64).to(torch.int32)


def packed_count(x: torch.Tensor) -> torch.Tensor:
    """Count True lanes along the trailing axis via pack + popcount;
    integer-identical to the wide sum."""
    return popcount_sum(pack_bits(x))


def packed_tally(ss_p: torch.Tensor, votes_t_p: torch.Tensor) -> torch.Tensor:
    """Binary product over packed words: for ss_p (..., Y, W) and
    votes_t_p (..., X, W), both packing the same voted-witness axis, the
    (..., Y, X) int32 tally sum_w popcount(ss_p[y] & votes_t_p[x]), the
    packed form of the fame product ss @ votes."""
    joint = ss_p[..., :, None, :] & votes_t_p[..., None, :, :]
    return popcount_sum(joint)


def pack_votes_t(votes: torch.Tensor) -> torch.Tensor:
    """Pack a (..., W_voters, X) vote matrix into its transposed packed
    form (..., X, words(W_voters)), the operand layout packed_tally
    expects (the voter axis is the packed one)."""
    return pack_bits(votes.transpose(-1, -2))


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
