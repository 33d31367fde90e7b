"""Round-frontier DivideRounds for the PyTorch port.

Counterpart of babble_tpu/tpu/frontier.py. Rounds are assigned by walking
ROUND frontiers: X(r)[c] is the first chain-c index at round >= r, and

    X(r+1)[c] = min( m0[c],  min_c' INV[c, c', m0[c']] ),  clamped >= X(r)

where m0[c] is the first chain-c index strongly seeing a supermajority of
the round-r frontier rows and INV[c, p, v] the first chain-c index whose
p-coordinate reaches v. A chain has a true round-r witness iff
X(r+1) > X(r), and round(e) = |{r : index(e) >= X(r)[creator(e)]}| - 1.
The module docstring of the reference states why each step is exact.

The reference contracts INV's value axis with one-hot float32 einsums on
the TPU's matrix unit; here every INV lookup is a direct int32 indexed
load, in the plain versions and in the CUDA kernels alike
(babble_tpu_torch/csrc/build_inv.cu, frontier_walk.cu). INV stays int32.

Scope: base (non-reset) grids; the fame vote of frontier_pipeline takes
either voting-table layout (`packed`). Host staging (chain_table,
sp_index_of, level_lamport) is numpy, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _ext
from .grid import MAX_INT32, DagGrid
from .kernels import (
    PipelineResult,
    decide_fame,
    decide_round_received,
    suffix_min,
)


# ---------------------------------------------------------------------------
# host-side staging
# ---------------------------------------------------------------------------


def chain_table(grid: DagGrid) -> np.ndarray:
    """(N, L) row table: rows_by[c, i] = grid row of creator c's event with
    per-creator index i (-1 = none). Host-side, O(E)."""
    n, e = grid.n, grid.e
    l_max = int(grid.index.max(initial=0)) + 1 if e else 1
    rows_by = np.full((n, max(l_max, 1)), -1, dtype=np.int32)
    if e:
        rows_by[grid.creator, grid.index] = np.arange(e, dtype=np.int32)
    return rows_by


def sp_index_of(grid: DagGrid) -> np.ndarray:
    """(E,) per-creator index of each event's self-parent (-1 = root)."""
    sp = grid.self_parent
    out = np.full(grid.e, -1, dtype=np.int32)
    mask = sp >= 0
    out[mask] = grid.index[sp[mask]]
    return out


def level_lamport(grid: DagGrid) -> np.ndarray:
    """(E,) lamport timestamps = DAG depth, from the grid's level layout
    (valid for base grids, whose external lamport seeds are all absent)."""
    out = np.zeros(grid.e, dtype=np.int32)
    levels = grid.levels[: grid.num_levels]
    mask = levels >= 0
    out[levels[mask]] = np.broadcast_to(
        np.arange(grid.num_levels, dtype=np.int32)[:, None], levels.shape
    )[mask]
    return out


# ---------------------------------------------------------------------------
# K1: threshold tables
# ---------------------------------------------------------------------------


def _build_inv_plain(rows_by: torch.Tensor, la: torch.Tensor) -> torch.Tensor:
    n_c, l = rows_by.shape
    e, n_p = la.shape
    dev = rows_by.device
    pad = rows_by < 0
    rb = rows_by.clamp(0, max(e - 1, 0)).long()
    la_chain = torch.where(pad[:, :, None], torch.full_like(la[rb], -1), la[rb])
    keep = la_chain >= 0  # the reference's v_slot = L: dropped
    v_slot = la_chain.clamp(max=l - 1).long()
    c_idx = torch.arange(n_c, device=dev)[:, None, None].expand(n_c, l, n_p)
    i_idx = torch.arange(l, device=dev, dtype=torch.int32)[None, :, None].expand(n_c, l, n_p)
    p_idx = torch.arange(n_p, device=dev)[None, None, :].expand(n_c, l, n_p)
    flat = (c_idx[keep] * n_p + p_idx[keep]) * l + v_slot[keep]
    inv0 = torch.full((n_c * n_p * l,), l, dtype=torch.int32, device=dev)
    inv0.scatter_reduce_(0, flat, i_idx[keep], reduce="amin", include_self=True)
    return suffix_min(inv0.view(n_c, n_p, l), dim=2)


def build_inv(rows_by: torch.Tensor, la: torch.Tensor) -> torch.Tensor:
    """INV[c, p, v] = first chain-c index whose p-coordinate >= v
    (v in [0, L)); L = "never". (N_c, N_p, L) int32. CPU: the plain
    version; CUDA: the kernel."""
    if rows_by.device.type == "cpu":
        return _build_inv_plain(rows_by, la)
    return _ext.build_inv(rows_by, la)


# ---------------------------------------------------------------------------
# K2: the frontier walk
# ---------------------------------------------------------------------------


class FrontierResult(NamedTuple):
    rounds: torch.Tensor  # (E,) int32
    witness: torch.Tensor  # (E,) bool
    witness_table: torch.Tensor  # (r_cap, N) int32 rows, -1 none
    last_round: torch.Tensor  # () int32


# chain count from which the plain m0 stage switches from the gather+sort
# form (an (N, N, N) tensor) to the per-chain binary search (N^2-sized
# intermediates only). The CUDA kernel computes the same integers at any N.
M0_BINSEARCH_MIN_N = 512


def _m0_einsum_sort(fd_w, w_ok, inv, super_majority: int, l: int):
    """m0 via INV lookups: u[w, c, p] = first chain-c index whose
    p-coordinate reaches fd_w[w, p] (a direct gather where the reference
    uses a one-hot einsum), then the supermajority-th smallest along p and
    along w."""
    n_c, n_p, _ = inv.shape
    dev = inv.device
    v = fd_w.clamp(0, l - 1).long()  # (w, p)
    c_idx = torch.arange(n_c, device=dev)[None, :, None]
    p_idx = torch.arange(n_p, device=dev)[None, None, :]
    u = inv[c_idx, p_idx, v[:, None, :]]  # (w, c, p)
    sent = torch.full_like(u, l)
    u = torch.where((fd_w < MAX_INT32)[:, None, :], u, sent)
    u = torch.where(w_ok[:, None, None], u, sent)
    t = torch.sort(u, dim=2).values[:, :, super_majority - 1]
    return torch.sort(t, dim=0).values[super_majority - 1, :]


def _m0_binsearch(fd_w, w_ok, rb, chain_len, la, super_majority: int, l: int):
    """m0 via per-chain binary search over the chain index: "event i of
    chain c strongly sees >= supermajority of the frontier rows" is
    monotone in i, so ~log2(l) probes of one event per chain find it."""
    n = rb.shape[0]
    dev = rb.device
    cc = torch.arange(n, device=dev)
    last = (chain_len - 1).clamp(min=0)
    lo = torch.zeros((n,), dtype=torch.int32, device=dev)
    hi = torch.full((n,), l, dtype=torch.int32, device=dev)
    steps = max(1, (l - 1).bit_length()) + 1
    for _ in range(steps):
        mid = torch.minimum((lo + hi) // 2, torch.full_like(lo, l - 1))
        probe = torch.minimum(mid, last)
        ev = rb[cc, probe.long()]
        la_mid = la[ev.long()]  # (N_c, N_p)
        cnt_p = (la_mid[:, None, :] >= fd_w[None, :, :]).sum(dim=-1, dtype=torch.int32)
        sees = (cnt_p >= super_majority) & w_ok[None, :]
        pred = (sees.sum(dim=1, dtype=torch.int32) >= super_majority) & (chain_len > 0)
        hi = torch.where(pred, torch.minimum(mid, hi), hi)
        lo = torch.where(pred, lo, mid + 1)
    return torch.where(hi < chain_len, hi, torch.full_like(hi, l))


def make_walk_step(inv, rows_by, fd, la, super_majority: int,
                   m0_mode: str = "auto"):
    """The one-round transition X(r) -> X(r+1) over the given tables
    (plain version). m0_mode: "auto" picks by N (M0_BINSEARCH_MIN_N), or
    force "binsearch" / "sort".

    fd may be None: the frontier rows' first descendants then come from
    INV by the identity fd[e, p] == INV[p, creator(e), index(e)], a direct
    gather fd_w[c, p] = INV[p, c, X[c]] where the reference contracts a
    one-hot with INV; INV's sentinel L maps to MAX_INT32 (the frontier-live
    engine keeps no fd matrix)."""
    n, l = rows_by.shape
    dev = rows_by.device
    # event rows, clamped as the reference's gathers clamp them
    e_rows = (fd if fd is not None else la).shape[0]
    rb = rows_by.clamp(0, max(e_rows - 1, 0))
    cc = torch.arange(n, device=dev)
    use_binsearch = m0_mode == "binsearch" or (
        m0_mode == "auto" and n >= M0_BINSEARCH_MIN_N and la is not None
    )
    chain_len = (rows_by >= 0).sum(dim=1, dtype=torch.int32)
    c_idx = cc[:, None]

    def step(x_cur):
        w_ok = x_cur < l
        xc = x_cur.clamp(0, l - 1).long()
        if fd is None:
            fdw = inv[cc[None, :], cc[:, None], xc[:, None]]  # (N_w, N_p)
            fd_w = torch.where(w_ok[:, None] & (fdw < l), fdw, torch.full_like(fdw, MAX_INT32))
        else:
            w_row = rb[cc, xc].long()  # (N,)
            fd_w = torch.where(w_ok[:, None], fd[w_row], torch.full_like(fd[w_row], MAX_INT32))
        if use_binsearch:
            m0 = _m0_binsearch(fd_w, w_ok, rb, chain_len, la, super_majority, l)
        else:
            m0 = _m0_einsum_sort(fd_w, w_ok, inv, super_majority, l)
        # cross-chain closure, one pass (coordinate transitivity)
        reach = inv[c_idx, cc[None, :], m0.clamp(0, l - 1).long()[None, :]]  # (c, c')
        reach = torch.where((m0 < l)[None, :], reach, torch.full_like(reach, l))
        x_next = torch.minimum(m0, reach.amin(dim=1))
        return torch.clamp(torch.maximum(x_next, x_cur), max=l)

    return step


def frontier_x0(rows_by: torch.Tensor) -> torch.Tensor:
    """X(0): every non-empty chain's first event is root-attached with
    round 0 (base grids)."""
    l = rows_by.shape[1]
    zero = torch.zeros_like(rows_by[:, 0])
    return torch.where(rows_by[:, 0] >= 0, zero, zero + l)


def frontier_post(x_hist, rows_by, creator, index, sp_index) -> FrontierResult:
    """Witness table + per-event rounds from the frontier history."""
    n, l = rows_by.shape
    rb = rows_by.clamp(min=0)
    cc = torch.arange(n, device=rows_by.device)
    x_next_hist = torch.cat([x_hist[1:], torch.full_like(x_hist[:1], l)], dim=0)
    w_rows = rb[cc[None, :], x_hist.clamp(0, l - 1).long()]
    w_valid = (x_hist < l) & (x_next_hist > x_hist)
    wtable = torch.where(w_valid, w_rows, torch.full_like(w_rows, -1))

    xh_c = x_hist.T[creator.clamp(0, n - 1).long()]  # (E, r_cap)
    rounds = (index[:, None] >= xh_c).sum(dim=1, dtype=torch.int32) - 1
    sp_round = (sp_index[:, None] >= xh_c).sum(dim=1, dtype=torch.int32) - 1
    witness = rounds > sp_round
    return FrontierResult(rounds, witness, wtable, rounds.max())


def _frontier_history_plain(inv, rows_by, fd, super_majority: int, r_cap: int, la=None,
                            m0_mode: str = "auto") -> torch.Tensor:
    """The frontier history X(0 .. r_cap - 1) (r_cap, N) of the plain walk,
    every step taken (the reference's scan)."""
    step = make_walk_step(inv, rows_by, fd, la, super_majority, m0_mode)
    x = frontier_x0(rows_by)
    hist = []
    for _ in range(r_cap):
        hist.append(x)
        x = step(x)
    return torch.stack(hist)


def _frontier_rounds_plain(inv, rows_by, creator, index, sp_index, fd,
                           super_majority: int, r_cap: int, la=None,
                           m0_mode: str = "auto") -> FrontierResult:
    hist = _frontier_history_plain(inv, rows_by, fd, super_majority, r_cap, la=la,
                                   m0_mode=m0_mode)
    return frontier_post(hist, rows_by, creator, index, sp_index)


def frontier_rounds(inv, rows_by, creator, index, sp_index, fd,
                    super_majority: int, r_cap: int, la=None) -> FrontierResult:
    """The r_cap-step frontier walk, then the witness table and per-event
    rounds. CPU: the plain version; CUDA: the kernel (which needs no la),
    one cooperative launch that stops at the walk's fixed point (F depends
    on X alone, so the rows past it repeat X) and the post pass."""
    if rows_by.device.type == "cpu":
        return _frontier_rounds_plain(
            inv, rows_by, creator, index, sp_index, fd, super_majority, r_cap, la=la,
        )
    return FrontierResult(*_ext.frontier_rounds(
        inv, rows_by, creator, index, sp_index, fd, super_majority, r_cap,
    ))


def frontier_pipeline(
    inv: torch.Tensor,  # (N, N, L) int32 from build_inv
    rows_by: torch.Tensor,  # (N, L) int32
    creator: torch.Tensor,  # (E,) int32
    index: torch.Tensor,  # (E,) int32
    sp_index: torch.Tensor,  # (E,) int32
    la: torch.Tensor,  # (E, N) int32
    fd: torch.Tensor,  # (E, N) int32
    lamport: torch.Tensor,  # (E,) int32 (host-maintained DAG depth)
    coin_bit: torch.Tensor,  # (E,) bool
    super_majority: int,
    n_participants: int,
    r_cap: int,
    d_cap: Optional[int] = None,
    packed: bool = False,
) -> PipelineResult:
    """DivideRounds (frontier walk) + DecideFame + DecideRoundReceived;
    the same output contract as the reference's frontier_pipeline. d_cap
    caps the fame voting offset; default r_cap + 2. `packed` picks the
    fame vote's voting-table layout."""
    fr = frontier_rounds(
        inv, rows_by, creator, index, sp_index, fd, super_majority, r_cap, la=la,
    )
    fame = decide_fame(
        fr.witness_table, la, fd, index, coin_bit, fr.last_round,
        super_majority, n_participants, r_cap + 2 if d_cap is None else d_cap,
        packed=packed,
    )
    received = decide_round_received(
        fr.witness_table, la, index, creator, fr.rounds,
        fame.decided, fame.famous, fame.rounds_decided, fr.last_round,
    )
    return PipelineResult(
        rounds=fr.rounds,
        witness=fr.witness,
        lamport=lamport,
        witness_table=fr.witness_table,
        fame_decided=fame.decided,
        famous=fame.famous,
        rounds_decided=fame.rounds_decided,
        received=received,
        last_round=fr.last_round,
    )
