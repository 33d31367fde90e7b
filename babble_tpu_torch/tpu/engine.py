"""Device consensus engine of the PyTorch port: passes 1-3 (DivideRounds,
DecideFame, DecideRoundReceived) over a DagGrid, through the
round-frontier pipeline (base grids) or the level scan (any grid).

Counterpart of babble_tpu/tpu/engine.py's one-shot engines. The host
stages the grid with numpy, pads it to the reference's bucketed shapes (so
the port's tensors equal the reference's, shape for shape), runs the
pipeline on the card (or, when asked, on the CPU through the plain
versions) and stages the results back to numpy. The log-diameter cold
path is in doubling.py.

Not ported yet: the node seam (grid_from_hashgraph /
integrate_pass_results / run_consensus_device), the packed voting layout
and the device-time ledger.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .device import resolve_device, to_device
from .frontier import (
    build_inv, chain_table, frontier_pipeline, level_lamport, sp_index_of,
)
from .grid import MAX_INT32, MIN_INT32, DagGrid, GridUnsupported
from .kernels import consensus_pipeline

# validator count from which the reference picks the packed voting layout
# by default (babble_tpu/tpu/packed.py); the port has the wide layout only
PACKED_AUTO_MIN_N = 128


@dataclass
class PassResults:
    """Device results staged back to host numpy (absolute round numbers;
    base grids have round_offset 0)."""

    rounds: np.ndarray  # (E,)
    witness: np.ndarray  # (E,)
    lamport: np.ndarray  # (E,)
    witness_table: np.ndarray  # (R, N)
    fame_decided: np.ndarray  # (R, N)
    famous: np.ndarray  # (R, N)
    rounds_decided: np.ndarray  # (R,)
    received: np.ndarray  # (E,)
    last_round: int
    round_offset: int = 0


def _bucket(x: int, floor: int, factor: int = 4) -> int:
    """Next floor*factor^k >= x — the reference's static-shape schedule."""
    b = floor
    while b < x:
        b *= factor
    return b


def pad_grid(grid: DagGrid) -> DagGrid:
    """Pad the event axis and the level table to bucketed static shapes.
    Padding rows are inert: la=-1 / fd=MAX make them invisible to any
    ancestry comparison."""
    e_b = _bucket(grid.e, 256)
    l_b = _bucket(grid.num_levels, 128)
    if e_b == grid.e and l_b == grid.levels.shape[0]:
        return grid
    pad_e = e_b - grid.e
    n = grid.n

    def pad1(a, fill):
        return np.concatenate([a, np.full(pad_e, fill, dtype=a.dtype)])

    levels = np.full((l_b, n), -1, dtype=np.int32)
    levels[: grid.levels.shape[0]] = grid.levels

    return DagGrid(
        n=n,
        e=grid.e,
        super_majority=grid.super_majority,
        creator=pad1(grid.creator, 0),
        index=pad1(grid.index, MAX_INT32),
        self_parent=pad1(grid.self_parent, -1),
        other_parent=pad1(grid.other_parent, -1),
        last_ancestors=np.concatenate(
            [grid.last_ancestors, np.full((pad_e, n), -1, dtype=np.int32)]
        ),
        first_descendants=np.concatenate(
            [grid.first_descendants, np.full((pad_e, n), MAX_INT32, dtype=np.int32)]
        ),
        coin_bit=pad1(grid.coin_bit, False),
        fixed_round=pad1(grid.fixed_round, -1),
        ext_sp_round=pad1(grid.ext_sp_round, -1),
        ext_op_round=pad1(grid.ext_op_round, -1),
        ext_sp_lamport=pad1(grid.ext_sp_lamport, -1),
        ext_op_lamport=pad1(grid.ext_op_lamport, MIN_INT32),
        fixed_lamport=pad1(grid.fixed_lamport, MIN_INT32),
        levels=levels,
        num_levels=l_b,
        hashes=grid.hashes,
    )


def refuse_packed(grid: DagGrid, packed: Optional[bool]) -> None:
    """NotImplementedError for the packed voting layout: packed=True, or
    packed=None where the reference would pick it (>= 128 validators)."""
    if packed or (packed is None and grid.n >= PACKED_AUTO_MIN_N):
        raise NotImplementedError(
            "the packed voting layout is not ported yet; pass packed=False"
        )


def rebase_rounds(grid: DagGrid):
    """Shift all externally-supplied round numbers down by their minimum so
    the device round axis spans activity since the last reset, not the
    node's lifetime. Returns (grid, offset)."""
    lows = [
        a[a >= 0]
        for a in (grid.fixed_round, grid.ext_sp_round, grid.ext_op_round)
    ]
    lows = [a for a in lows if a.size]
    if not lows:
        return grid, 0
    r_lo = int(min(a.min() for a in lows))
    if r_lo <= 0:
        return grid, 0

    def shift(a):
        return np.where(a >= 0, a - r_lo, a).astype(np.int32)

    return (
        dataclasses.replace(
            grid,
            fixed_round=shift(grid.fixed_round),
            ext_sp_round=shift(grid.ext_sp_round),
            ext_op_round=shift(grid.ext_op_round),
        ),
        r_lo,
    )


def _frontier_safe(grid: DagGrid) -> bool:
    """The round-frontier walk covers base-state grids: every chain
    anchored at a genesis root (no external parent metadata from resets)."""
    return (
        grid.e > 0
        and bool((grid.ext_sp_round == -1).all())
        and bool((grid.ext_op_round == -1).all())
    )


# grow-only hint for the adaptive fame/received round axis, shared by every
# call in the process (a wrong hint costs one discarded run, then sticks);
# the port's own, independent of the reference's
_r_fame_hint = 8


def _adaptive_r_loop(run_fn, n: int, cap_bound: int):
    """Start from the grow-only hint, re-run one bucket up when the round
    axis overflowed (last_round + 2 > r_cap), and remember the final
    bucket for the next call."""
    global _r_fame_hint

    floor = min(n, 64)
    r_cap = min(max(_r_fame_hint, floor), cap_bound)
    while True:
        res = run_fn(r_cap)
        last_round = int(res.last_round)
        if last_round + 2 <= r_cap or r_cap >= cap_bound:
            break
        r_cap = min(max(_bucket(last_round + 4, 8, factor=2), floor), cap_bound)
    _r_fame_hint = max(_r_fame_hint, r_cap)
    return res, last_round


class FrontierInputs(NamedTuple):
    """A base grid staged for the frontier pipeline, as device tensors."""

    rows_by: torch.Tensor  # (N, L_b) int32, -1 padded
    la: torch.Tensor  # (E_b, N) int32
    fd: torch.Tensor  # (E_b, N) int32
    creator: torch.Tensor  # (E_b,) int32
    index: torch.Tensor  # (E_b,) int32, -1 padded
    sp_index: torch.Tensor  # (E_b,) int32, -1 padded
    lamport: torch.Tensor  # (E_b,) int32, -1 padded
    coin_bit: torch.Tensor  # (E_b,) bool


def stage_frontier(grid: DagGrid, device: torch.device) -> FrontierInputs:
    """Host staging of the frontier path: chain table, self-parent
    indexes, level lamports, the event axis padded by pad_grid and the
    chain axis bucketed, exactly as the reference stages them."""
    e_real = grid.e
    rows_by = chain_table(grid)
    sp_index = sp_index_of(grid)
    lamport = level_lamport(grid)
    grid_p = pad_grid(grid)
    pad_e = grid_p.creator.shape[0] - e_real
    # E-padding for the frontier path: index -1 keeps padded rows below
    # every frontier value, so their rounds stay -1 and cannot pollute
    # last_round (pad_grid's MAX fill would do the opposite here)
    minus = np.full(pad_e, -1, dtype=np.int32)
    index = np.concatenate([grid.index, minus])
    sp_index = np.concatenate([sp_index, minus])
    lamport = np.concatenate([lamport, minus])
    # bucket the chain axis as the reference does
    l_b = _bucket(rows_by.shape[1], 64, factor=2)
    if l_b != rows_by.shape[1]:
        ext = np.full((grid.n, l_b), -1, dtype=np.int32)
        ext[:, : rows_by.shape[1]] = rows_by
        rows_by = ext

    def t(a):
        return to_device(a, device)

    return FrontierInputs(
        rows_by=t(rows_by),
        la=t(grid_p.last_ancestors),
        fd=t(grid_p.first_descendants),
        creator=t(grid_p.creator),
        index=t(index),
        sp_index=t(sp_index),
        lamport=t(lamport),
        coin_bit=t(grid_p.coin_bit.astype(bool)),
    )


def run_frontier_passes(
    grid: DagGrid,
    d_max: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    packed: Optional[bool] = None,
) -> PassResults:
    """Passes 1-3 of a base grid through the round-frontier pipeline, on
    the CUDA card by default (device="cpu" runs the plain versions).
    Bucketed shapes and the adaptive round axis as in the reference.

    Raises GridUnsupported on a grid that is not frontier-safe (post-reset
    grids take run_passes or run_doubling_passes) and NotImplementedError
    for the packed layout (packed=True, or packed=None at >= 128
    validators)."""
    dev = resolve_device(device)
    refuse_packed(grid, packed)
    if not _frontier_safe(grid):
        raise GridUnsupported(
            "post-reset grid: the round-frontier walk covers base grids only; "
            "run it through run_passes (the level scan) or "
            "run_doubling_passes (the cold path)"
        )

    e_real = grid.e
    st = stage_frontier(grid, dev)
    inv = build_inv(st.rows_by, st.la)

    def run_fn(r_cap):
        return frontier_pipeline(
            inv, st.rows_by, st.creator, st.index, st.sp_index, st.la, st.fd,
            st.lamport, st.coin_bit, grid.super_majority, grid.n, r_cap,
            d_cap=d_max,
        )

    res, last_round = _adaptive_r_loop(run_fn, grid.n, st.rows_by.shape[1] + 2)

    def host(x):
        return x.cpu().numpy()

    return PassResults(
        rounds=host(res.rounds)[:e_real],
        witness=host(res.witness)[:e_real],
        lamport=host(res.lamport)[:e_real],
        witness_table=host(res.witness_table),
        fame_decided=host(res.fame_decided),
        famous=host(res.famous),
        rounds_decided=host(res.rounds_decided),
        received=host(res.received)[:e_real],
        last_round=last_round,
        round_offset=0,
    )


# the DagGrid fields the level scan reads, in consensus_pipeline's order
SCAN_FIELDS = (
    "levels", "creator", "index", "self_parent", "other_parent",
    "last_ancestors", "first_descendants", "ext_sp_round", "ext_op_round",
    "fixed_round", "ext_sp_lamport", "ext_op_lamport", "fixed_lamport",
    "coin_bit",
)


def stage_scan(grid: DagGrid, device: torch.device):
    """The level scan's inputs as device tensors, in SCAN_FIELDS order."""
    return tuple(to_device(getattr(grid, f), device) for f in SCAN_FIELDS)


def scan_layout(grid: DagGrid, bucketed: bool):
    """(grid, round_offset, r_max) as run_passes stages them: bucketed
    rebases the round axis and pads to the static-shape schedule."""
    if not bucketed:
        return grid, 0, grid.r_max
    grid, offset = rebase_rounds(grid)
    grid = pad_grid(grid)
    return grid, offset, _bucket(grid.r_max, 64, factor=2)


def run_passes(
    grid: DagGrid,
    d_max: Optional[int] = None,
    bucketed: bool = False,
    adaptive_r: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    packed: Optional[bool] = None,
) -> PassResults:
    """Passes 1-3 of any grid (base or post-reset) through the level scan,
    on the CUDA card by default (device="cpu" runs the plain versions).

    With bucketed=True, the round axis is rebased and shapes are padded as
    in the reference; with adaptive_r, the fame/received round axis starts
    from the grow-only hint shared with run_frontier_passes and re-runs one
    bucket up on overflow. Raises NotImplementedError for the packed
    layout, as run_frontier_passes does."""
    dev = resolve_device(device)
    refuse_packed(grid, packed)
    e_real = grid.e
    grid, offset, r_max = scan_layout(grid, bucketed)
    inputs = stage_scan(grid, dev)

    def run_fn(r_fame):
        # the fame offset loop is self-bounding (j <= last_round); d_cap is
        # a safety net only
        d_cap = d_max if d_max is not None else r_fame + 2
        return consensus_pipeline(
            *inputs, grid.super_majority, grid.n, r_max, r_fame, d_cap,
        )

    if adaptive_r:
        res, _ = _adaptive_r_loop(run_fn, grid.n, r_max)
    else:
        res = run_fn(r_max)

    def host(x):
        return x.cpu().numpy()

    rounds = host(res.rounds)[:e_real]
    received = host(res.received)[:e_real]
    if offset:
        rounds = np.where(rounds >= 0, rounds + offset, rounds)
        received = np.where(received >= 0, received + offset, received)
    return PassResults(
        rounds=rounds,
        witness=host(res.witness)[:e_real],
        lamport=host(res.lamport)[:e_real],
        witness_table=host(res.witness_table),
        fame_decided=host(res.fame_decided),
        famous=host(res.famous),
        rounds_decided=host(res.rounds_decided),
        received=received,
        last_round=int(res.last_round) + offset,
        round_offset=offset,
    )
