"""Virtual voting and round-received for the PyTorch port.

Counterparts of babble_tpu/tpu/kernels.py (suffix_min, the DecideFame
tables and loop, the round-received tables and search), wide layout only.
Each public function is a wrapper: on a CPU tensor it runs the plain
PyTorch version below, on a CUDA tensor it launches the hand-written
kernel (babble_tpu_torch/csrc/decide_fame.cu, round_received.cu) or
raises. The plain versions repeat the reference's integer arithmetic with
explicit index masks where JAX clamps gathers; they are the CPU path and
the yardstick the kernels are held to on the card.

All arithmetic is exact int32 / bool: the reference's float32 vote tally
(an einsum of 0/1 values) is an integer count here.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from . import _ext
from .grid import MAX_INT32

Scalar = Union[int, torch.Tensor]


def suffix_min(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Reverse cumulative minimum along `dim` (the reference's shift-doubling
    suffix_min with a fill no smaller than any element)."""
    flipped = torch.flip(x, dims=(dim,))
    return torch.flip(torch.cummin(flipped, dim=dim).values, dims=(dim,))


class FameResult(NamedTuple):
    decided: torch.Tensor  # (R, N) bool — fame known for witness of (round, creator)
    famous: torch.Tensor  # (R, N) bool — fame value where decided
    rounds_decided: torch.Tensor  # (R,) bool — all witnesses of round decided


class PipelineResult(NamedTuple):
    rounds: torch.Tensor  # (E,) int32
    witness: torch.Tensor  # (E,) bool
    lamport: torch.Tensor  # (E,) int32
    witness_table: torch.Tensor  # (R, N) int32
    fame_decided: torch.Tensor  # (R, N) bool
    famous: torch.Tensor  # (R, N) bool
    rounds_decided: torch.Tensor  # (R,) bool
    received: torch.Tensor  # (E,) int32
    last_round: torch.Tensor  # () int32


def _rows(table: torch.Tensor, e: int) -> torch.Tensor:
    """Event rows of a witness table, clamped into [0, e) the way a JAX
    gather clamps (absent witnesses, -1, read row 0)."""
    return table.clamp(0, e - 1).long()


def _fame_setup_tables(wvalid, la_w, fd_w, idx_w, coin_w, super_majority: int):
    """Round-adjacent strongly-see tensor ss[j, y, w] and the d=1 ancestry
    votes votes0[i, y, x]. The reference rolls the round axis and masks the
    wrapped row; here the neighbouring round is indexed directly and the
    same rows are masked."""
    r_max, n = wvalid.shape
    ss = torch.zeros((r_max, n, n), dtype=torch.bool, device=wvalid.device)
    votes0 = torch.zeros_like(ss)
    if r_max > 1:
        cmp = la_w[1:, :, None, :] >= fd_w[:-1, None, :, :]  # (R-1, y, w, p)
        counts = cmp.sum(dim=-1)
        ss[1:] = (
            (counts >= super_majority)
            & wvalid[1:, :, None]
            & wvalid[:-1, None, :]
        )
        see0 = la_w[1:] >= idx_w[:-1, None, :]  # y of round i+1 sees x of round i
        votes0[:-1] = see0 & wvalid[1:, :, None]
    return ss, votes0, wvalid, coin_w


def _fame_setup(wtable, la, fd, index, coin_bit, super_majority: int):
    """Gather the per-witness tables, then the table math."""
    wvalid = wtable >= 0
    wrows = _rows(wtable, la.shape[0])
    return _fame_setup_tables(
        wvalid, la[wrows], fd[wrows], index[wrows], coin_bit[wrows],
        super_majority,
    )


def _decide_fame_tables(ss, votes0, wvalid, coin_w, last_round: Scalar,
                        super_majority: int, n_participants: int,
                        d_cap: int) -> FameResult:
    """Virtual voting from a prebuilt strongly-see tensor, batched over
    every round i; a loop over the round offset d (voters of round i + d)
    that stops once no undecided witness has voters left."""
    r_max, n = wvalid.shape
    dev = wvalid.device
    last_round = int(last_round)
    i_arr = torch.arange(r_max, device=dev)
    votes = votes0
    decided = torch.zeros((r_max, n), dtype=torch.bool, device=dev)
    famous = torch.zeros_like(decided)
    d = 2
    while d <= d_cap:
        active = wvalid & ~decided & ((i_arr[:, None] + d) <= last_round)
        if not bool(active.any()):
            break
        j = i_arr + d
        j_ok = j <= last_round
        jc = j.clamp(0, r_max - 1)
        vy = wvalid[jc] & j_ok[:, None]  # (R, N_y)
        ss_d = ss[jc] & j_ok[:, None, None]  # (R, N_y, N_w)
        # yays[r, y, x] = sum_w ss_d[r, y, w] * votes[r, w, x], as a count
        yays = (ss_d[:, :, :, None] & votes[:, None, :, :]).sum(dim=2, dtype=torch.int32)
        total = ss_d.sum(dim=-1, dtype=torch.int32)
        nays = total[:, :, None] - yays
        v = yays >= nays
        t = torch.where(v, yays, nays)
        is_coin = (d % n_participants) == 0
        strong = t >= super_majority
        if is_coin:
            votes = torch.where(strong, v, coin_w[jc][:, :, None])
        else:
            decide_now = strong & vy[:, :, None] & wvalid[:, None, :] & ~decided[:, None, :]
            any_decide = decide_now.any(dim=1)
            fame_val = (decide_now & v).any(dim=1)
            famous = torch.where(any_decide, fame_val, famous)
            decided = decided | any_decide
            votes = v
        d += 1
    rounds_decided = (decided | ~wvalid).all(dim=1) & wvalid.any(dim=1)
    return FameResult(decided, famous, rounds_decided)


def _decide_fame_plain(wtable, la, fd, index, coin_bit, last_round,
                       super_majority, n_participants, d_cap) -> FameResult:
    ss, votes0, wvalid, coin_w = _fame_setup(
        wtable, la, fd, index, coin_bit, super_majority
    )
    return _decide_fame_tables(
        ss, votes0, wvalid, coin_w, last_round,
        super_majority, n_participants, d_cap,
    )


def decide_fame(wtable, la, fd, index, coin_bit, last_round,
                super_majority: int, n_participants: int,
                d_cap: int) -> FameResult:
    """DecideFame over the witness table (R, N) with tables gathered from
    the flat event arrays. CPU: the plain version; CUDA: the kernel."""
    if wtable.device.type == "cpu":
        return _decide_fame_plain(
            wtable, la, fd, index, coin_bit, last_round,
            super_majority, n_participants, d_cap,
        )
    return FameResult(*_ext.decide_fame(
        wtable, la, fd, index, coin_bit, last_round,
        super_majority, n_participants, d_cap,
    ))


def _received_tables_from(wvalid, la_w, decided, famous, rounds_decided,
                          last_round: Scalar):
    """Per-round tables of the received search: famous-witness column
    minima of lastAncestors, famous counts, eligibility and the
    first-undecided-round horizon."""
    r_max = wvalid.shape[0]
    is_famous = decided & famous & wvalid  # (R, N)
    famous_count = is_famous.sum(dim=1, dtype=torch.int32)
    max_fill = torch.full_like(la_w, MAX_INT32)
    min_la = torch.where(is_famous[:, :, None], la_w, max_fill).amin(dim=1)
    idx = torch.arange(r_max, device=wvalid.device, dtype=torch.int32)
    i_ok = rounds_decided & (idx <= last_round)
    bad = torch.where(~i_ok, idx, torch.full_like(idx, r_max))
    horizon = suffix_min(bad)
    return min_la, famous_count, i_ok, horizon


def _received_tables(wtable, la, decided, famous, rounds_decided, last_round):
    return _received_tables_from(
        wtable >= 0, la[_rows(wtable, la.shape[0])], decided, famous,
        rounds_decided, last_round,
    )


def received_core(index, rounds, seen_min, famous_count, i_ok, horizon_start):
    """Candidate selection: the least round i > round(e) before the
    horizon with a famous witness, all of whose famous witnesses see e."""
    r_dim = seen_min.shape[1]
    idx = torch.arange(r_dim, device=index.device, dtype=torch.int32)
    cand = (
        (index[:, None] <= seen_min)
        & (famous_count[None, :] > 0)
        & i_ok[None, :]
        & (idx[None, :] > rounds[:, None])
        & (idx[None, :] < horizon_start[:, None])
    )
    received = torch.where(cand, idx[None, :], torch.full_like(cand, r_dim, dtype=torch.int32))
    received = received.amin(dim=1)
    return torch.where(received == r_dim, torch.full_like(received, -1), received)


def received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon):
    """received(e) = min { i > round(e) : every round in (round(e), i] is
    fully fame-decided, round i has >= 1 famous witness, and all famous
    witnesses of i see e }; -1 if none."""
    r_dim, n = min_la.shape
    seen_min = min_la[:, creator.clamp(0, n - 1).long()].T  # (E, R)
    start = (rounds + 1).clamp(0, r_dim - 1).long()
    return received_core(index, rounds, seen_min, famous_count, i_ok, horizon[start])


def _decide_round_received_plain(wtable, la, index, creator, rounds, decided,
                                 famous, rounds_decided, last_round):
    min_la, famous_count, i_ok, horizon = _received_tables(
        wtable, la, decided, famous, rounds_decided, last_round
    )
    return received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon)


def decide_round_received(wtable, la, index, creator, rounds, decided, famous,
                          rounds_decided, last_round) -> torch.Tensor:
    """Round-received per event, (E,) int32, -1 while undetermined. CPU:
    the plain version; CUDA: the kernel."""
    if wtable.device.type == "cpu":
        return _decide_round_received_plain(
            wtable, la, index, creator, rounds, decided, famous,
            rounds_decided, last_round,
        )
    return _ext.round_received(
        wtable, la, index, creator, rounds, decided, famous, rounds_decided,
        last_round,
    )
