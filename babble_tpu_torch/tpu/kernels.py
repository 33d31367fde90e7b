"""Level-scan DivideRounds, virtual voting and round-received for the
PyTorch port.

Counterparts of babble_tpu/tpu/kernels.py (suffix_min, the level scan
_divide_rounds, the DecideFame tables and loop, the round-received tables
and search, consensus_pipeline), in both voting-table layouts: `packed`
takes the reference's packed branch (tpu/packed.py), integer-equal to the
wide one. Each public function is a wrapper: on a CPU tensor it runs the
plain PyTorch version below, on a CUDA tensor it launches the hand-written
kernel (babble_tpu_torch/csrc/divide_rounds.cu, decide_fame.cu,
round_received.cu) in the same layout, or raises. The plain versions repeat the reference's integer arithmetic with
explicit index masks where JAX clamps gathers; they are the CPU path and
the yardstick the kernels are held to on the card.

All arithmetic is exact int32 / bool: the reference's float32 vote tally
(an einsum of 0/1 values) is an integer count here. The fame setup's
compares and the vote tallies, (rounds, N, N, N) tensors in the
reference, are taken a chunk of rounds at a time (PLAIN_CHUNK_CELLS):
the same integers, without 32 GiB tensors at 1,024 validators.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from . import _ext
from .grid import MAX_INT32, MIN_INT32
from .packed import pack_bits, pack_votes_t, packed_count, packed_tally, popcount_sum

Scalar = Union[int, torch.Tensor]

# elements of one chunk of the plain versions' (rounds, N, N, N) compares
# and tallies: a round's N^3 is 1 G at 1,024 validators, so there a chunk
# is one round
PLAIN_CHUNK_CELLS = 1 << 28


def round_chunks(rounds: int, cells_per_round: int):
    """Slices of at most PLAIN_CHUNK_CELLS // cells_per_round rounds (at
    least one) covering range(rounds)."""
    step = max(1, PLAIN_CHUNK_CELLS // max(cells_per_round, 1))
    return [slice(a, min(a + step, rounds)) for a in range(0, rounds, step)]


def vote_tallies(ss_d: torch.Tensor, votes: torch.Tensor, packed: bool) -> torch.Tensor:
    """yays[r, y, x] = |{w : ss_d[r, y, w] and votes[r, w, x]}| (int32),
    or with `packed` sum_w popcount(ss_d[r, y, w] & votes[r, x, w]) over
    the words, a chunk of rounds at a time."""
    r, n = ss_d.shape[0], ss_d.shape[1]
    cells = n * n * ss_d.shape[2]
    parts = []
    for c in round_chunks(r, cells):
        if packed:
            parts.append(packed_tally(ss_d[c], votes[c]))
        else:
            parts.append((ss_d[c][:, :, :, None] & votes[c][:, None, :, :])
                         .sum(dim=2, dtype=torch.int32))
    return torch.cat(parts) if parts else torch.zeros((0, n, n), dtype=torch.int32,
                                                      device=ss_d.device)


def suffix_min(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Reverse cumulative minimum along `dim` (the reference's shift-doubling
    suffix_min with a fill no smaller than any element)."""
    flipped = torch.flip(x, dims=(dim,))
    return torch.flip(torch.cummin(flipped, dim=dim).values, dims=(dim,))


class DivideRoundsResult(NamedTuple):
    rounds: torch.Tensor  # (E,) int32
    witness: torch.Tensor  # (E,) bool
    lamport: torch.Tensor  # (E,) int32
    witness_table: torch.Tensor  # (R, N) int32 event rows, -1 = none


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


def last_level(levels: torch.Tensor) -> int:
    """Index of the last level row that holds an event, -1 if none. Rows
    past it are all padding, and a padding row changes nothing."""
    occupied = torch.nonzero((levels >= 0).any(dim=1))
    return int(occupied.max()) if occupied.numel() else -1


def _divide_rounds_plain(levels, creator, index, self_parent, other_parent,
                         la, fd, ext_sp_round, ext_op_round, fixed_round,
                         ext_sp_lamport, ext_op_lamport, fixed_lamport,
                         super_majority: int, r_max: int,
                         packed: bool = False) -> DivideRoundsResult:
    """The reference's lax.scan over topological levels, one loop step per
    level. Each step reads the carry in full before it writes, as the scan
    does; dropped scatters land in one sink slot past the end of each
    buffer (event row E, witness-table row r_max). `packed` counts by
    popcount over uint32 lanes, as the reference's packed branch does."""
    e_count, n = la.shape
    dev = la.device
    i32 = torch.int32
    rounds = torch.full((e_count + 1,), -1, dtype=i32, device=dev)
    lamport = torch.full((e_count + 1,), -1, dtype=i32, device=dev)
    witness = torch.zeros((e_count + 1,), dtype=torch.bool, device=dev)
    wtable = torch.full((r_max + 1, n), -1, dtype=i32, device=dev)
    lanes = torch.arange(levels.shape[1], device=dev)

    def parent(ptr, own, ext):
        # the in-grid parent's value, else the host-supplied external one
        return torch.where(ptr >= 0, own[ptr.clamp(0, e_count - 1).long()], ext)

    for lv in range(last_level(levels) + 1):
        level_rows = levels[lv]
        valid = level_rows >= 0
        rows = level_rows.clamp(0, e_count - 1).long()
        c = creator[rows]
        sp, op = self_parent[rows], other_parent[rows]

        sp_round = parent(sp, rounds, ext_sp_round[rows])
        op_round = parent(op, rounds, ext_op_round[rows])
        parent_round = torch.maximum(sp_round, op_round)

        # strongly-see counts against the parent round's witnesses
        wrows = wtable[parent_round.clamp(0, r_max - 1).long()]  # (N_lvl, N)
        wvalid = (wrows >= 0) & (parent_round[:, None] >= 0)
        fd_w = fd[wrows.clamp(0, e_count - 1).long()]  # (N_lvl, N, N)
        la_e = la[rows]  # (N_lvl, N)
        if packed:
            counts = packed_count(la_e[:, None, :] >= fd_w)
            ss = (counts >= super_majority) & wvalid
            c_seen = packed_count(ss)
        else:
            counts = (la_e[:, None, :] >= fd_w).sum(dim=-1, dtype=i32)
            ss = (counts >= super_majority) & wvalid
            c_seen = ss.sum(dim=-1, dtype=i32)

        new_round = parent_round + (c_seen >= super_majority).to(i32)
        fixed = fixed_round[rows]
        new_round = torch.where(fixed >= 0, fixed, new_round)
        new_witness = new_round > sp_round

        sp_lt = parent(sp, lamport, ext_sp_lamport[rows])
        op_lt = parent(op, lamport, ext_op_lamport[rows])
        new_lt = torch.maximum(sp_lt, op_lt) + 1
        fl = fixed_lamport[rows]
        new_lt = torch.where(fl != MIN_INT32, fl, new_lt)

        scatter_rows = torch.where(valid, rows, e_count)
        rounds[scatter_rows] = new_round
        lamport[scatter_rows] = new_lt
        witness[scatter_rows] = new_witness
        w_mask = valid & new_witness & (c >= 0) & (c < n)
        wr = torch.where(w_mask, new_round.clamp(0, r_max - 1), r_max).long()
        # dropped lanes land on distinct cells of the sink row
        wtable[wr, torch.where(w_mask, c.long(), lanes % n)] = level_rows
    return DivideRoundsResult(
        rounds[:e_count], witness[:e_count], lamport[:e_count], wtable[:r_max],
    )


def divide_rounds(levels, creator, index, self_parent, other_parent, la, fd,
                  ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
                  ext_op_lamport, fixed_lamport, super_majority: int,
                  r_max: int, packed: bool = False) -> DivideRoundsResult:
    """DivideRounds by a scan over the (L, N) level table: rounds, witness
    flags, lamport timestamps and the (r_max, N) witness table. External
    parents take the host-supplied ext_* values; fixed_round >= 0 and
    fixed_lamport != MIN_INT32 override. CPU: the plain version; CUDA: the
    kernel, in the layout `packed` names."""
    args = (levels, creator, index, self_parent, other_parent, la, fd,
            ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
            ext_op_lamport, fixed_lamport, super_majority, r_max, packed)
    if la.device.type == "cpu":
        return _divide_rounds_plain(*args)
    return DivideRoundsResult(*_ext.divide_rounds(*args))


def _rows(table: torch.Tensor, e: int) -> torch.Tensor:
    """Event rows of a witness table, clamped into [0, e) the way a JAX
    gather clamps (absent witnesses, -1, read row 0)."""
    return table.clamp(0, e - 1).long()


def _fame_setup_tables(wvalid, la_w, fd_w, idx_w, coin_w, super_majority: int,
                       packed: bool = False):
    """Round-adjacent strongly-see tensor ss[j, y, w] and the d=1 ancestry
    votes votes0[i, y, x]. The reference rolls the round axis and masks the
    wrapped row; here the neighbouring round is indexed directly and the
    same rows are masked. `packed` counts the compares by popcount over
    uint32 lanes (integer-equal)."""
    r_max, n = wvalid.shape
    ss = torch.zeros((r_max, n, n), dtype=torch.bool, device=wvalid.device)
    votes0 = torch.zeros_like(ss)
    if r_max > 1:
        for c in round_chunks(r_max - 1, n ** 3):
            j = slice(c.start + 1, c.stop + 1)
            cmp = la_w[j, :, None, :] >= fd_w[c, None, :, :]  # (rounds, y, w, p)
            counts = packed_count(cmp) if packed else cmp.sum(dim=-1)
            ss[j] = (
                (counts >= super_majority)
                & wvalid[j, :, None]
                & wvalid[c, None, :]
            )
        see0 = la_w[1:] >= idx_w[:-1, None, :]  # y of round i+1 sees x of round i
        votes0[:-1] = see0 & wvalid[1:, :, None]
    return ss, votes0, wvalid, coin_w


def _fame_setup(wtable, la, fd, index, coin_bit, super_majority: int,
                packed: bool = False):
    """Gather the per-witness tables, then the table math."""
    wvalid = wtable >= 0
    wrows = _rows(wtable, la.shape[0])
    return _fame_setup_tables(
        wvalid, la[wrows], fd[wrows], index[wrows], coin_bit[wrows],
        super_majority, packed=packed,
    )


def _decide_fame_tables(ss, votes0, wvalid, coin_w, last_round: Scalar,
                        super_majority: int, n_participants: int,
                        d_cap: int, packed: bool = False) -> FameResult:
    """Virtual voting from a prebuilt strongly-see tensor, batched over
    every round i; a loop over the round offset d (voters of round i + d)
    that stops once no undecided witness has voters left.

    With `packed`, as in the reference: ss packs its voted-witness axis
    into words (ss_p, with row tallies total_p), the carried votes are the
    transposed-packed (R, N_x, W) matrix, and the yay tally is the
    popcount of ANDed words (packed_tally). The step's verdict v is wide
    (the coin step reads wide coin bits) and is re-packed for the next
    step."""
    r_max, n = wvalid.shape
    dev = wvalid.device
    last_round = int(last_round)
    i_arr = torch.arange(r_max, device=dev)
    if packed:
        ss_p = pack_bits(ss)  # (R, N_y, W)
        total_p = popcount_sum(ss_p)  # (R, N_y)
        votes = pack_votes_t(votes0)
    else:
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
        if packed:
            ss_d = torch.where(j_ok[:, None, None], ss_p[jc], torch.zeros_like(ss_p[jc]))
            yays = vote_tallies(ss_d, votes, True)  # (R, N_y, N_x)
            total = torch.where(j_ok[:, None], total_p[jc], torch.zeros_like(total_p[jc]))
        else:
            ss_d = ss[jc] & j_ok[:, None, None]  # (R, N_y, N_w)
            # yays[r, y, x] = sum_w ss_d[r, y, w] * votes[r, w, x], as a count
            yays = vote_tallies(ss_d, votes, False)
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
        if packed:
            # this step's voters y are the next step's voted witnesses w
            votes = pack_votes_t(votes)
        d += 1
    rounds_decided = (decided | ~wvalid).all(dim=1) & wvalid.any(dim=1)
    return FameResult(decided, famous, rounds_decided)


def _decide_fame_plain(wtable, la, fd, index, coin_bit, last_round,
                       super_majority, n_participants, d_cap,
                       packed: bool = False) -> FameResult:
    ss, votes0, wvalid, coin_w = _fame_setup(
        wtable, la, fd, index, coin_bit, super_majority, packed=packed
    )
    return _decide_fame_tables(
        ss, votes0, wvalid, coin_w, last_round,
        super_majority, n_participants, d_cap, packed=packed,
    )


def decide_fame(wtable, la, fd, index, coin_bit, last_round,
                super_majority: int, n_participants: int,
                d_cap: int, packed: bool = False) -> FameResult:
    """DecideFame over the witness table (R, N) with tables gathered from
    the flat event arrays. CPU: the plain version; CUDA: the kernel, in
    the layout `packed` names."""
    if wtable.device.type == "cpu":
        return _decide_fame_plain(
            wtable, la, fd, index, coin_bit, last_round,
            super_majority, n_participants, d_cap, packed=packed,
        )
    return FameResult(*_ext.decide_fame(
        wtable, la, fd, index, coin_bit, last_round,
        super_majority, n_participants, d_cap, packed=packed,
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
    # the reference's gather: a negative creator counted from the end
    # once, then clamped to [0, n)
    col = torch.where(creator < 0, creator + n, creator).clamp(0, n - 1)
    seen_min = min_la[:, col.long()].T  # (E, R)
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


def consensus_pipeline(levels, creator, index, self_parent, other_parent, la,
                       fd, ext_sp_round, ext_op_round, fixed_round,
                       ext_sp_lamport, ext_op_lamport, fixed_lamport,
                       coin_bit, super_majority: int, n_participants: int,
                       r_max: int, r_fame: int, d_cap: int,
                       packed: bool = False) -> PipelineResult:
    """Level-scan DivideRounds + DecideFame + DecideRoundReceived, with
    last_round reduced on the device. r_max bounds the scan's witness
    table, r_fame the round axis of the fame and received tables; a caller
    checks last_round + 2 <= r_fame and re-runs one bucket up otherwise.
    `packed` picks the voting-table layout of the level scan and the fame
    vote. Inputs are never written."""
    dr = divide_rounds(
        levels, creator, index, self_parent, other_parent, la, fd,
        ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
        ext_op_lamport, fixed_lamport, super_majority, r_max, packed=packed,
    )
    last_round = dr.rounds.max()
    wtable = dr.witness_table[:r_fame]
    fame = decide_fame(
        wtable, la, fd, index, coin_bit, last_round,
        super_majority, n_participants, d_cap, packed=packed,
    )
    received = decide_round_received(
        wtable, la, index, creator, dr.rounds,
        fame.decided, fame.famous, fame.rounds_decided, last_round,
    )
    return PipelineResult(
        rounds=dr.rounds,
        witness=dr.witness,
        lamport=dr.lamport,
        witness_table=wtable,
        fame_decided=fame.decided,
        famous=fame.famous,
        rounds_decided=fame.rounds_decided,
        received=received,
        last_round=last_round,
    )
