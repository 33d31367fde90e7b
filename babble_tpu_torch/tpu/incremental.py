"""Incremental device consensus for the PyTorch port: persistent DAG state
on the card, advanced by gossip-sized append batches and by whole trains.

Counterpart of babble_tpu/tpu/incremental.py. The host ships
O(batch) data per append: the new rows' coordinates, identity and parent
pointers, the write-once first-descendant cell writes their inserts cause,
and a dependency-level table. Everything the strongly-see / fame /
received math touches per round lives in dense per-witness buffers
(la_w / fd_w / idx_w / coin_w, shape (R_cap, N, ...)), filled when a
witness registers and kept current by mirroring the fd deltas through
the row -> witness-slot map.

JAX donates the state and gets in-place updates from XLA; here the entry
points update the resident tensors in place and return the same state.
The read-before-write orders JAX gets for free are kept by hand: the fd
delta mirror reads the pre-batch slot map, each level reads the whole
carry before it writes, the decide reads the old fame rows before it
writes the window back, and the train body reads the pre-train rounds and
lamports before its write-back. `last_round`, `count`, `stale` and
`fame_lag` stay 0-d tensors on the state's device: no entry point reads
anything back to the host on the card.

Four kernels carry the card path (babble_tpu_torch/csrc/):

- K9 apply_deltas.cu   `_apply_deltas_and_stage`: fd delta min-scatter,
  its mirror into fd_w, and the new rows' staging;
- K10 step_levels.cu   `_step_levels`: the L_MAX within-batch levels,
  witness registration, the latches;
- K11 train_levels.cu  `_train_levels`: a train's level scan on
  train-local carries, bulk registration, one write-back, the latches
  (each walks its levels in one block below its crossover width and
  across the card from there: `_ext.step_levels_form`,
  `_ext.train_levels_form`);
- K12 decide_window.cu `_decide_body`: windowed fame with D_UNROLL fixed
  voting offsets and the freeze mask, round received over the trailing
  row window, the stale detector; where a caller passes a vector (`pack`),
  K13's layout of what the live engine's write-back reads, in its last
  two launches (tpu/live.py asks for it on the last decide of a call).

`step` = K9 -> K10 -> K12, `multi_step` = K x (K9 -> K10) then K12,
`train_step` = K9 -> K11 -> K12, `multi_train` = K x (K9 -> K11) then K12.
On the card K9 runs as phase 0 of K10's launch, and in a launch of its
own before K11, whose first launch reads its fd_w mirror.
Every entry point takes either voting-table layout (`packed`, as in the
reference: K10, K11 and K12 count by popcount over uint32 lanes, with the
same integers).
Each wrapper runs its plain PyTorch version when the state lies on the
CPU and its kernel when it lies on a CUDA card. The plain versions repeat
the reference's integer arithmetic with explicit index masks where JAX
clamps gathers and drops scatters; the reference's one-hot float32
matmuls (train gathers, received lookups) are direct integer loads here,
which give the same integers. Out-of-range scatter targets are dropped;
negative ones, which JAX would wrap and the builders never produce, are
dropped too.

The host builders (`batches_from_grid`, `trains_from_grid`,
`stack_batches`, `stack_trains`, `empty_batch`) are the port's own numpy
copies.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Union

import numpy as np
import torch

from . import _ext
from .device import resolve_device, to_device
from .frontier import level_lamport
from .grid import MAX_INT32, DagGrid
from .kernels import _fame_setup_tables, received_core, suffix_min, vote_tallies
from .packed import pack_bits, pack_votes_t, packed_count, popcount_sum

# cap for "no first descendant yet" sentinels: every real event index is
# < 2^24, so a 2^24 sentinel loses exactly like MAX_INT32 against any
# real last-ancestor index. The reference's fp32 compare paths store it.
FD_CLAMP = 1 << 24

# statically unrolled fame-voting depth: decisions normally land at d <= 5;
# anything deeper latches fame_lag
D_UNROLL = 8

# static height of the within-batch level table; a deeper gossip batch
# (one creator chaining > L_MAX events) is split by the builder
L_MAX = 16

_I32 = torch.int32


class IncState(NamedTuple):
    """Device-resident DAG state (E_cap rows, R_cap rounds), updated in
    place by the entry points."""

    la: torch.Tensor  # (E_cap, N) int32
    fd: torch.Tensor  # (E_cap, N) int32
    creator: torch.Tensor  # (E_cap,) int32
    index: torch.Tensor  # (E_cap,) int32 (MAX = empty row)
    rounds: torch.Tensor  # (E_cap,) int32 (-1 = unknown)
    lamport: torch.Tensor  # (E_cap,) int32
    witness: torch.Tensor  # (E_cap,) bool
    received: torch.Tensor  # (E_cap,) int32 (-1 = undetermined)
    w_of_row: torch.Tensor  # (E_cap,) int32 flat witness slot r*N+c (-1 = none)
    wtable: torch.Tensor  # (R_cap, N) int32 event rows (-1 = none)
    la_w: torch.Tensor  # (R_cap, N, N) int32 lastAnc of registered witnesses
    fd_w: torch.Tensor  # (R_cap, N, N) int32 firstDesc of registered witnesses
    idx_w: torch.Tensor  # (R_cap, N) int32
    coin_w: torch.Tensor  # (R_cap, N) bool
    fame_decided: torch.Tensor  # (R_cap, N) bool
    famous: torch.Tensor  # (R_cap, N) bool
    rounds_decided: torch.Tensor  # (R_cap,) bool
    last_round: torch.Tensor  # () int32
    count: torch.Tensor  # () int32 rows in use
    # latched true if an undetermined row slid below the received window,
    # or the round capacity or a late witness made the state unreliable
    stale: torch.Tensor  # () bool
    # latched true if fame voting needed more offsets than the unroll
    fame_lag: torch.Tensor  # () bool


_BOOL_FIELDS = frozenset(
    ("witness", "coin_w", "fame_decided", "famous", "rounds_decided",
     "stale", "fame_lag")
)


def init_state(n: int, e_cap: int, r_cap: int, device=None) -> IncState:
    """An empty state on `device` (the card unless the caller passes
    "cpu")."""
    dev = resolve_device(device)

    def full(shape, value, dtype=_I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return IncState(
        la=full((e_cap, n), -1),
        fd=full((e_cap, n), MAX_INT32),
        creator=full((e_cap,), 0),
        index=full((e_cap,), MAX_INT32),
        rounds=full((e_cap,), -1),
        lamport=full((e_cap,), -1),
        witness=full((e_cap,), False, torch.bool),
        received=full((e_cap,), -1),
        w_of_row=full((e_cap,), -1),
        wtable=full((r_cap, n), -1),
        la_w=full((r_cap, n, n), -1),
        fd_w=full((r_cap, n, n), MAX_INT32),
        idx_w=full((r_cap, n), MAX_INT32),
        coin_w=full((r_cap, n), False, torch.bool),
        fame_decided=full((r_cap, n), False, torch.bool),
        famous=full((r_cap, n), False, torch.bool),
        rounds_decided=full((r_cap,), False, torch.bool),
        last_round=full((), 0),
        count=full((), 0),
        stale=full((), False, torch.bool),
        fame_lag=full((), False, torch.bool),
    )


def state_from_arrays(d: Mapping, device=None) -> IncState:
    """The port's IncState from a mapping of field name -> numpy array
    (for example the reference's state, field by field through
    np.asarray). Arrays are copied."""
    dev = resolve_device(device)
    fields = {}
    for f in IncState._fields:
        dtype = np.bool_ if f in _BOOL_FIELDS else np.int32
        # torch.from_numpy keeps the 0-d scalars 0-d
        fields[f] = torch.from_numpy(np.array(d[f], dtype=dtype, copy=True)).to(dev)
    return IncState(**fields)


def state_to_arrays(state: IncState) -> dict:
    """Field name -> host numpy array (copies)."""
    return {f: getattr(state, f).cpu().numpy().copy() for f in IncState._fields}


def clone_state(state: IncState) -> IncState:
    """An independent copy of every buffer, on the same device."""
    return IncState(*[t.clone() for t in state])


class Batch(NamedTuple):
    """One append batch, fixed static shapes (padded)."""

    rows: torch.Tensor  # (B,) int32 target rows, -1 padding
    creator: torch.Tensor  # (B,) int32
    index: torch.Tensor  # (B,) int32
    sp_row: torch.Tensor  # (B,) int32 (-1 = root-attached)
    op_row: torch.Tensor  # (B,) int32 (-1 = none)
    la_rows: torch.Tensor  # (B, N) int32
    coin: torch.Tensor  # (B,) bool
    fixed_round: torch.Tensor  # (B,) int32 (-1 = compute)
    upd_row: torch.Tensor  # (U,) int32 fd-update rows (E_cap = padding)
    upd_col: torch.Tensor  # (U,) int32
    upd_val: torch.Tensor  # (U,) int32
    levels: torch.Tensor  # (L_MAX, W) int32 positions into the batch, -1 padding


class Train(NamedTuple):
    """A flattened run of append batches processed as one program: the
    level scan keeps the new rows' rounds / lamports / witness flags in
    train-local buffers and writes the big arrays once at the end. Level
    positions are train-local; sp_pos / op_pos point at in-train parents
    (-1 when the parent is pre-train state)."""

    rows: torch.Tensor  # (KB,) int32 target rows, -1 padding
    creator: torch.Tensor  # (KB,) int32
    index: torch.Tensor  # (KB,) int32 (MAX = padding)
    sp_row: torch.Tensor  # (KB,) int32 global row (-1 = root-attached)
    op_row: torch.Tensor  # (KB,) int32 global row (-1 = none)
    sp_pos: torch.Tensor  # (KB,) int32 train-local position (-1 = pre-train)
    op_pos: torch.Tensor  # (KB,) int32
    la_rows: torch.Tensor  # (KB, N) int32
    coin: torch.Tensor  # (KB,) bool
    fixed_round: torch.Tensor  # (KB,) int32 (-1 = compute)
    upd_row: torch.Tensor  # (U,) int32 fd-update rows (E_cap = padding)
    upd_col: torch.Tensor  # (U,) int32
    upd_val: torch.Tensor  # (U,) int32
    levels: torch.Tensor  # (T, W) int32 train-local positions, -1 padding
    # host-maintained lamports; the level-scan body computes its own and
    # ignores this (the frontier-live engine consumes it)
    lamport: torch.Tensor  # (KB,) int32


Inputs = Union[Batch, Train]


def device_put(x: Inputs, device=None) -> Inputs:
    """A Batch or Train (numpy or torch fields) with every field on
    `device` (the card unless the caller passes "cpu"). Fields already
    there are passed through as they are."""
    dev = resolve_device(device)
    return type(x)(*[
        (f if f.device == dev else f.to(dev)) if isinstance(f, torch.Tensor)
        else to_device(np.asarray(f), dev)
        for f in x
    ])


def _row_get(a: torch.Tensor, rows: torch.Tensor, fill) -> torch.Tensor:
    """a[rows] with JAX's mode="fill": rows outside [0, len) read `fill`."""
    ok = (rows >= 0) & (rows < a.shape[0])
    got = a[rows.clamp(0, a.shape[0] - 1).long()]
    ok = ok.view(ok.shape + (1,) * (got.dim() - 1))
    return torch.where(ok, got, torch.full_like(got, fill))


# ---------------------------------------------------------------------------
# K9: fd deltas and row staging
# ---------------------------------------------------------------------------


def _apply_deltas_and_stage_plain(state: IncState, b: Inputs) -> None:
    """Min-scatter the fd deltas (write-once cells, so order-free) and
    mirror them into fd_w through the pre-batch slot map; stage the new
    rows' coordinates, identity and own fd cell."""
    e_cap, n = state.la.shape
    r_cap = state.wtable.shape[0]
    urow, ucol, uval = b.upd_row.long(), b.upd_col.long(), b.upd_val
    ok = (urow >= 0) & (urow < e_cap) & (ucol >= 0) & (ucol < n)
    # the slot map as it stood before this batch: in-batch witnesses copy
    # their fd row at registration instead
    uslot = _row_get(state.w_of_row, urow, -1).long()
    big = torch.full_like(uval, MAX_INT32)
    # dropped updates become min(cell 0, MAX): no change
    state.fd.view(-1).scatter_reduce_(
        0, torch.where(ok, urow * n + ucol, 0), torch.where(ok, uval, big), "amin")
    mirror = ok & (uslot >= 0) & (uslot < r_cap * n)
    state.fd_w.view(-1).scatter_reduce_(
        0, torch.where(mirror, uslot * n + ucol, 0), torch.where(mirror, uval, big),
        "amin")

    sel = torch.nonzero((b.rows >= 0) & (b.rows < e_cap)).squeeze(1)
    rows = b.rows[sel].long()
    c = b.creator[sel]
    state.la[rows] = b.la_rows[sel]
    state.creator[rows] = c
    state.index[rows] = b.index[sel]
    own = (c >= 0) & (c < n)
    state.fd.view(-1).scatter_reduce_(
        0, torch.where(own, rows * n + c.long(), 0),
        torch.where(own, b.index[sel], torch.full_like(c, MAX_INT32)), "amin")


def _apply_deltas_and_stage(state: IncState, b: Inputs) -> None:
    """K9 (babble_tpu/tpu/incremental.py:213). CPU: the plain version;
    CUDA: csrc/apply_deltas.cu."""
    if state.la.device.type == "cpu":
        _apply_deltas_and_stage_plain(state, b)
        return
    _ext.apply_deltas(
        state.fd, state.fd_w, state.la, state.creator, state.index,
        state.w_of_row, b.rows, b.creator, b.index, b.la_rows, b.upd_row,
        b.upd_col, b.upd_val,
    )


# ---------------------------------------------------------------------------
# K10: the within-batch level scan
# ---------------------------------------------------------------------------


def _late_witness(state: IncState, rounds_b, witness_b, valid) -> torch.Tensor:
    """A witness landing in an already-decided round (a laggard's old
    events arriving after the round settled) needs the host engine's
    freeze semantics, which the dense window does not reproduce."""
    r_cap = state.wtable.shape[0]
    rd = state.rounds_decided[rounds_b.clamp(0, r_cap - 1).long()]
    return (witness_b & valid & rd & (rounds_b >= 0) & (rounds_b < r_cap)).any()


def _step_levels_plain(state: IncState, batch: Batch, super_majority: int,
                       packed: bool = False) -> None:
    """Rounds / lamport / witness of the batch's rows, one level at a time
    (each level reads the carry in full before it writes), witness
    registration into the dense buffers, then last_round, count and the
    round-capacity and late-witness latches. `packed` counts by popcount
    over uint32 lanes, as the reference's packed branch does."""
    e_cap, n = state.la.shape
    r_cap = state.wtable.shape[0]
    n_b = batch.rows.shape[0]
    for i in range(batch.levels.shape[0]):
        sel = torch.nonzero(batch.levels[i] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue  # a padding level: every scatter would drop
        p = batch.levels[i][sel].clamp(max=n_b - 1).long()
        rows = batch.rows[p]
        sp, op = batch.sp_row[p], batch.op_row[p]
        sp_round = torch.where(sp >= 0, state.rounds[sp.clamp(0, e_cap - 1).long()], -1)
        op_round = torch.where(op >= 0, state.rounds[op.clamp(0, e_cap - 1).long()], -1)
        parent_round = torch.maximum(sp_round, op_round)

        pr = parent_round.clamp(0, r_cap - 1).long()
        wvalid = (state.wtable[pr] >= 0) & (parent_round[:, None] >= 0)
        la_e = batch.la_rows[p]
        if packed:
            counts = packed_count(la_e[:, None, :] >= state.fd_w[pr])
            ss = (counts >= super_majority) & wvalid
            c_seen = packed_count(ss)
        else:
            counts = (la_e[:, None, :] >= state.fd_w[pr]).sum(dim=-1, dtype=_I32)
            ss = (counts >= super_majority) & wvalid
            c_seen = ss.sum(dim=-1, dtype=_I32)

        new_round = parent_round + (c_seen >= super_majority).to(_I32)
        fixed = batch.fixed_round[p]
        new_round = torch.where(fixed >= 0, fixed, new_round)
        new_witness = new_round > sp_round

        sp_lt = torch.where(sp >= 0, state.lamport[sp.clamp(0, e_cap - 1).long()], -1)
        op_lt = torch.where(op >= 0, state.lamport[op.clamp(0, e_cap - 1).long()], -1)
        new_lt = torch.maximum(sp_lt, op_lt) + 1

        # write phase
        ok = (rows >= 0) & (rows < e_cap)
        tr = rows[ok].long()
        state.rounds[tr] = new_round[ok]
        state.lamport[tr] = new_lt[ok]
        state.witness[tr] = new_witness[ok]

        c = batch.creator[p]
        reg = new_witness & (c >= 0) & (c < n)
        wr = new_round.clamp(0, r_cap - 1).long()[reg]
        cr = c.long()[reg]
        rr = rows[reg]
        state.wtable[wr, cr] = rr
        okw = (rr >= 0) & (rr < e_cap)
        state.w_of_row[rr[okw].long()] = (wr * n + cr)[okw].to(_I32)
        state.la_w[wr, cr] = la_e[reg]
        # the witness's own fd row as it stands: every cell already
        # written (this batch's deltas included) is current
        state.fd_w[wr, cr] = state.fd[rr.clamp(0, e_cap - 1).long()]
        state.idx_w[wr, cr] = batch.index[p][reg]
        state.coin_w[wr, cr] = batch.coin[p][reg]

    valid = batch.rows >= 0
    last_round = torch.maximum(state.last_round, state.rounds.max())
    state.last_round.copy_(last_round)
    state.count.add_(valid.sum(dtype=_I32))
    # round-capacity latch: registration clips rounds >= r_cap onto row
    # r_cap-1, which would corrupt that round's tables
    overflow = last_round >= r_cap - 1
    b_rounds = _row_get(state.rounds, batch.rows, -1)
    b_witness = _row_get(state.witness, batch.rows, False)
    late = _late_witness(state, b_rounds, b_witness, valid)
    state.stale.logical_or_(overflow | late)


def _step_levels(state: IncState, batch: Batch, super_majority: int,
                 packed: bool = False) -> None:
    """K9 then K10 (babble_tpu/tpu/incremental.py:243 _step_body, with
    :213 _apply_deltas_and_stage). CPU: the plain versions; CUDA:
    csrc/step_levels.cu, in the layout `packed` names, with K9 as the
    launch's phase 0."""
    if state.la.device.type == "cpu":
        _apply_deltas_and_stage_plain(state, batch)
        _step_levels_plain(state, batch, super_majority, packed)
        return
    _ext.step_levels(
        state.fd, state.rounds, state.lamport, state.witness, state.wtable,
        state.w_of_row, state.la_w, state.fd_w, state.idx_w, state.coin_w,
        state.rounds_decided, state.last_round, state.count, state.stale,
        batch.rows, batch.creator, batch.index, batch.sp_row, batch.op_row,
        batch.la_rows, batch.coin, batch.fixed_round, batch.levels,
        state.la, state.creator, state.index, batch.upd_row, batch.upd_col, batch.upd_val,
        super_majority, packed=packed,
    )


def _step_body(state: IncState, batch: Batch, super_majority: int,
               n_participants: int, packed: bool = False) -> IncState:
    """Append one batch: K9 then K10, in one launch on the card.
    Fame and received are _decide_body's."""
    batch = device_put(batch, state.la.device)
    _step_levels(state, batch, super_majority, packed)
    return state


# ---------------------------------------------------------------------------
# K11: the train body
# ---------------------------------------------------------------------------


def _train_levels_plain(state: IncState, train: Train, super_majority: int,
                        packed: bool = False) -> None:
    """A whole train after its deltas: pre-gathers, the level scan over
    train-local carries (with compare copies of fd_w, clamped to FD_CLAMP,
    and of the witness-valid mask, which in-train registrations update),
    then one bulk registration, one write-back and the latches. `packed`
    counts by popcount over uint32 lanes, as the reference's packed branch
    (babble_tpu/tpu/incremental.py:649-652) does."""
    e_cap, n = state.la.shape
    r_cap = state.wtable.shape[0]
    kb = train.rows.shape[0]
    if e_cap >= FD_CLAMP:
        raise ValueError("event capacity exceeds the 2^24 compare range")
    dev = state.la.device

    valid = train.rows >= 0
    # pre-gathers: fd rows after this train's deltas, and the pre-train
    # parent rounds / lamports (read before the write-back below)
    fd_rows_cmp = _row_get(state.fd, train.rows, MAX_INT32).clamp(max=FD_CLAMP)
    sp_round_pre = _row_get(state.rounds, train.sp_row, -1)
    op_round_pre = _row_get(state.rounds, train.op_row, -1)
    sp_lt_pre = _row_get(state.lamport, train.sp_row, -1)
    op_lt_pre = _row_get(state.lamport, train.op_row, -1)
    fd_cmp = state.fd_w.clamp(max=FD_CLAMP).view(r_cap * n, n)
    wv = (state.wtable >= 0).view(-1)

    rounds_b = torch.full((kb,), -1, dtype=_I32, device=dev)
    lamport_b = torch.full((kb,), -1, dtype=_I32, device=dev)
    witness_b = torch.zeros((kb,), dtype=torch.bool, device=dev)
    for lv in range(train.levels.shape[0]):
        sel = torch.nonzero(train.levels[lv] >= 0).squeeze(1)
        if sel.numel() == 0:
            continue
        p = train.levels[lv][sel].clamp(max=kb - 1).long()
        sp_p, op_p = train.sp_pos[p], train.op_pos[p]
        spc, opc = sp_p.clamp(0, kb - 1).long(), op_p.clamp(0, kb - 1).long()
        sp_round = torch.where(sp_p >= 0, rounds_b[spc], sp_round_pre[p])
        op_round = torch.where(op_p >= 0, rounds_b[opc], op_round_pre[p])
        parent_round = torch.maximum(sp_round, op_round)

        pr = parent_round.clamp(0, r_cap - 1).long()
        slots = pr[:, None] * n + torch.arange(n, device=dev)[None, :]  # (w, N)
        wvalid = wv[slots] & (parent_round[:, None] >= 0)
        cmp = train.la_rows[p][:, None, :] >= fd_cmp[slots]
        if packed:
            counts = packed_count(cmp)
            ss = (counts >= super_majority) & wvalid
            c_seen = packed_count(ss)
        else:
            counts = cmp.sum(dim=-1, dtype=_I32)
            ss = (counts >= super_majority) & wvalid
            c_seen = ss.sum(dim=-1, dtype=_I32)

        new_round = parent_round + (c_seen >= super_majority).to(_I32)
        fixed = train.fixed_round[p]
        new_round = torch.where(fixed >= 0, fixed, new_round)
        new_witness = new_round > sp_round
        sp_lt = torch.where(sp_p >= 0, lamport_b[spc], sp_lt_pre[p])
        op_lt = torch.where(op_p >= 0, lamport_b[opc], op_lt_pre[p])
        new_lt = torch.maximum(sp_lt, op_lt) + 1

        rounds_b[p] = new_round
        lamport_b[p] = new_lt
        witness_b[p] = new_witness
        # the compare copies register at the clipped round, overflow or not
        slot = new_round.clamp(0, r_cap - 1).long() * n + train.creator[p].long()
        reg = new_witness & (slot >= 0) & (slot < r_cap * n)
        fd_cmp[slot[reg]] = fd_rows_cmp[p[reg]]
        wv[slot[reg]] = True

    # bulk registration, for rounds within capacity only: an overflowed
    # round is already latched unreliable by the capacity latch
    w_mask = witness_b & valid & (rounds_b < r_cap)
    wr = rounds_b.clamp(0, r_cap - 1).long()
    slot = wr * n + train.creator.long()
    reg = torch.nonzero(w_mask & (slot >= 0) & (slot < r_cap * n)).squeeze(1)
    s = slot[reg]
    state.wtable.view(-1)[s] = train.rows[reg]
    state.la_w.view(r_cap * n, n)[s] = train.la_rows[reg]
    # the clamped compare row, as the reference stores it
    state.fd_w.view(r_cap * n, n)[s] = fd_rows_cmp[reg]
    state.idx_w.view(-1)[s] = train.index[reg]
    state.coin_w.view(-1)[s] = train.coin[reg]

    tgt_ok = valid & (train.rows < e_cap)
    tgt = train.rows[tgt_ok].long()
    state.rounds[tgt] = rounds_b[tgt_ok]
    state.lamport[tgt] = lamport_b[tgt_ok]
    state.witness[tgt] = witness_b[tgt_ok]
    wrow = w_mask & tgt_ok
    state.w_of_row[train.rows[wrow].long()] = slot[wrow].to(_I32)

    top = torch.where(valid, rounds_b, torch.full_like(rounds_b, -1)).max()
    last_round = torch.maximum(state.last_round, top)
    state.last_round.copy_(last_round)
    state.count.add_(valid.sum(dtype=_I32))
    overflow = last_round >= r_cap - 1
    late = _late_witness(state, rounds_b, witness_b, valid)
    state.stale.logical_or_(overflow | late)


def _train_levels(state: IncState, train: Train, super_majority: int,
                  packed: bool = False) -> None:
    """K11 (babble_tpu/tpu/incremental.py:570 _train_body after its
    deltas; K11p its packed branch). CPU: the plain version; CUDA:
    csrc/train_levels.cu, whose counts are the packed layout's integers
    too (the packed launch is counted as train_levels/packed)."""
    if state.la.device.type == "cpu":
        _train_levels_plain(state, train, super_majority, packed)
        return
    _ext.train_levels(
        state.fd, state.rounds, state.lamport, state.witness, state.wtable,
        state.w_of_row, state.la_w, state.fd_w, state.idx_w, state.coin_w,
        state.rounds_decided, state.last_round, state.count, state.stale,
        train.rows, train.creator, train.index, train.sp_row, train.op_row,
        train.sp_pos, train.op_pos, train.la_rows, train.coin,
        train.fixed_round, train.levels, super_majority, packed=packed,
    )


def _train_body(state: IncState, train: Train, super_majority: int,
                n_participants: int, packed: bool = False) -> IncState:
    """Append a whole train: K9 then K11. Equal to running its batches
    through _step_body one by one, apart from the clamped fd rows the
    train registers (see _train_levels_plain)."""
    train = device_put(train, state.la.device)
    _apply_deltas_and_stage(state, train)
    _train_levels(state, train, super_majority, packed)
    return state


# ---------------------------------------------------------------------------
# K12: windowed fame and round received
# ---------------------------------------------------------------------------


def _fame_window(w_valid, la_w, fd_w, idx_w, coin_w, last_round_rel,
                 super_majority: int, n_participants: int,
                 packed: bool = False):
    """DecideFame over a contiguous window of r_win rounds, with the fixed
    offsets d = 2 .. D_UNROLL + 1 and no early exit. Returns (decided,
    famous, rounds_decided, overflow); overflow reports witnesses that
    needed votes beyond the unroll or the window top. The reference rolls
    the round axis and masks the wrapped rows; here the neighbour round is
    indexed directly and the same rows are masked. With `packed` the
    strongly-see tensor and the carried votes hold their voted-witness
    axis in uint32 lanes and the tallies are popcounts, as in the
    reference's packed branch."""
    r_win, n = w_valid.shape
    dev = w_valid.device
    ss, votes, _, _ = _fame_setup_tables(
        w_valid, la_w, fd_w, idx_w, coin_w, super_majority, packed=packed)
    lrr = torch.as_tensor(last_round_rel, dtype=_I32, device=dev)
    i_arr = torch.arange(r_win, device=dev)
    if packed:
        ss_p = pack_bits(ss)  # (r_win, N_y, W)
        total_p = popcount_sum(ss_p)
        votes = pack_votes_t(votes)
    decided = torch.zeros((r_win, n), dtype=torch.bool, device=dev)
    famous = torch.zeros_like(decided)
    for d in range(2, 2 + D_UNROLL):
        j = i_arr + d
        # voters must be real window rows: beyond the window top the vote
        # waits, and the overflow flag reports the state
        j_ok = (j <= lrr) & (j <= r_win - 1)
        jc = j.clamp(0, r_win - 1)
        vy = w_valid[jc] & j_ok[:, None]
        if packed:
            ss_d = torch.where(j_ok[:, None, None], ss_p[jc], torch.zeros_like(ss_p[jc]))
            yays = vote_tallies(ss_d, votes, True)
            total = torch.where(j_ok[:, None], total_p[jc], torch.zeros_like(total_p[jc]))
        else:
            ss_d = ss[jc] & j_ok[:, None, None]
            yays = vote_tallies(ss_d, votes, False)
            total = ss_d.sum(dim=-1, dtype=_I32)
        nays = total[:, :, None] - yays
        v = yays >= nays
        t = torch.where(v, yays, nays)
        strong = t >= super_majority
        if d % n_participants == 0:
            votes = torch.where(strong, v, coin_w[jc][:, :, None])
        else:
            decide_now = (strong & vy[:, :, None] & w_valid[:, None, :]
                          & ~decided[:, None, :])
            any_decide = decide_now.any(dim=1)
            fame_val = (decide_now & v).any(dim=1)
            famous = torch.where(any_decide, fame_val, famous)
            decided = decided | any_decide
            votes = v
        if packed:
            # voters y of this step are the next step's voted witnesses
            votes = pack_votes_t(votes)
    rounds_decided = (decided | ~w_valid).all(dim=1) & w_valid.any(dim=1)
    overflow = (
        (w_valid & ~decided & ((i_arr[:, None] + 2 + D_UNROLL) <= lrr)).any()
        | (lrr >= r_win)
    )
    return decided, famous, rounds_decided, overflow


def _check_windows(state: IncState, r_win: int, e_win: int) -> None:
    e_cap = state.la.shape[0]
    r_cap = state.wtable.shape[0]
    if not (1 <= r_win <= r_cap and 1 <= e_win <= e_cap):
        raise ValueError(
            f"windows r_win={r_win}, e_win={e_win} must fit the state's "
            f"capacities r_cap={r_cap}, e_cap={e_cap}"
        )


def _decide_body_plain(state: IncState, super_majority: int, n_participants: int,
                       r_win: int, e_win: int, packed: bool = False) -> None:
    """Fame over the r_win rounds from the first undecided one (rounds
    below it are settled for good: the freeze keeps their stored values),
    round received over the trailing e_win rows, the stale detector over
    all rows."""
    e_cap, n = state.la.shape
    r_cap = state.wtable.shape[0]
    dev = state.la.device
    r_idx = torch.arange(r_cap, device=dev, dtype=_I32)
    last_round = state.last_round
    undecided = ~state.rounds_decided & (r_idx <= last_round)
    floor_true = torch.where(undecided, r_idx, last_round).min()
    floor = floor_true.clamp(0, r_cap - r_win)
    f0 = int(floor)
    win = slice(f0, f0 + r_win)
    dec_w, fam_w, rdec_w, fame_overflow = _fame_window(
        state.wtable[win] >= 0, state.la_w[win], state.fd_w[win],
        state.idx_w[win], state.coin_w[win], last_round - floor,
        super_majority, n_participants, packed=packed,
    )
    frozen = (floor + torch.arange(r_win, device=dev)) < floor_true
    state.fame_decided[win] = torch.where(frozen[:, None], state.fame_decided[win], dec_w)
    state.famous[win] = torch.where(frozen[:, None], state.famous[win], fam_w)
    state.rounds_decided[win] = torch.where(frozen, state.rounds_decided[win], rdec_w)

    is_famous = state.fame_decided & state.famous & (state.wtable >= 0)
    famous_count = is_famous.sum(dim=1, dtype=_I32)
    min_la = torch.where(
        is_famous[:, :, None], state.la_w, torch.full_like(state.la_w, MAX_INT32)
    ).amin(dim=1)  # (R, N_c)
    i_ok = state.rounds_decided & (r_idx <= last_round)
    horizon = suffix_min(torch.where(~i_ok, r_idx, torch.full_like(r_idx, r_cap)))

    lo = (state.count - e_win).clamp(0, e_cap - e_win)
    l0 = int(lo)
    ew = slice(l0, l0 + e_win)
    idx_e, cre_e, rnd_e = state.index[ew], state.creator[ew], state.rounds[ew]
    # creator -> min_la column (the reference's one-hot product reads 0
    # for a creator outside [0, N)), clamped as the reference clamps it
    c_ok = (cre_e >= 0) & (cre_e < n)
    seen_min = min_la.clamp(max=FD_CLAMP)[:, cre_e.clamp(0, n - 1).long()].T
    seen_min = torch.where(c_ok[:, None], seen_min, torch.zeros_like(seen_min))
    start = (rnd_e + 1).clamp(0, r_cap - 1).long()
    horizon_start = horizon.clamp(max=r_cap)[start]
    rec_e = received_core(idx_e, rnd_e, seen_min, famous_count, i_ok, horizon_start)
    old_e = state.received[ew]
    occ_e = idx_e != MAX_INT32
    state.received[ew] = torch.where((old_e < 0) & occ_e, rec_e, old_e)

    # window-miss detector: an undetermined occupied row below the window
    # can never be decided again
    row_ids = torch.arange(e_cap, device=dev)
    miss = ((row_ids < lo) & (state.received < 0) & (state.index != MAX_INT32)).any()
    state.stale.logical_or_(miss)
    state.fame_lag.logical_or_(fame_overflow)


def pack_window_start(lo: int, e_cap: int, e_win: int) -> int:
    """Where K13's row window starts: jax.lax.dynamic_slice's rule, a
    negative start counted from the end once, then clamped to
    [0, e_cap - e_win]. The live engine's lo = max(count - e_win, 0)
    never needs either."""
    lo = int(lo)
    if lo < 0:
        lo += e_cap
    return min(max(lo, 0), e_cap - e_win)


def pack_size(e_win: int, r_cap: int, n: int) -> int:
    """The words of K13's vector."""
    return 4 * e_win + 3 * r_cap * n + 3


def pack_results_plain(st: IncState, lo: int, e_win: int, r_cap: int,
                       n: int) -> torch.Tensor:
    """K13's plain version (babble_tpu/tpu/live.py:757 _pack_results):
    slices, casts and one concatenation, with the row window's start
    placed as jax.lax.dynamic_slice places it."""
    l0 = pack_window_start(lo, st.rounds.shape[0], e_win)
    i32 = torch.int32

    def sl(a):
        return a[l0 : l0 + e_win].to(i32)

    return torch.cat([
        sl(st.rounds), sl(st.lamport), sl(st.witness), sl(st.received),
        st.wtable.reshape(r_cap * n).to(i32),
        st.fame_decided.reshape(r_cap * n).to(i32),
        st.famous.reshape(r_cap * n).to(i32),
        torch.stack([st.stale.to(i32), st.fame_lag.to(i32), st.last_round.to(i32)]),
    ])


def _decide_body(state: IncState, super_majority: int, n_participants: int,
                 r_win: int = 32, e_win: int = 8192,
                 packed: bool = False, pack=None, pack_lo: int = 0) -> IncState:
    """K12 (babble_tpu/tpu/incremental.py:361 _decide_body with :125
    _fame_window). Timing-independent: running it once per K appended
    batches gives the values per-batch evaluation would. CPU: the plain
    version; CUDA: csrc/decide_window.cu, whose tallies are bit words in
    both layouts (the packed launch is counted as decide_window/packed).
    The entry points check the windows before they change the state.

    With `pack` (int32, pack_size(e_win, R_cap, N) words on the state's
    device) K13's vector of the state the decide leaves is written into
    it at window start `pack_lo`, which must be where the decide's own
    window starts (clamp(count - e_win, 0, E_cap - e_win)): on the card
    by K12's last two launches (the last traps where it is not); on the CPU by
    pack_results_plain after the plain decide, which raises."""
    if state.la.device.type == "cpu":
        _decide_body_plain(state, super_majority, n_participants, r_win, e_win,
                           packed)
        if pack is not None:
            e_cap = state.la.shape[0]
            lo = min(max(int(state.count) - e_win, 0), e_cap - e_win)
            if pack_lo != lo:
                raise RuntimeError(f"decide: the pack's window starts at {pack_lo}, the "
                                   f"state's count places it at {lo}")
            r_cap, n = state.wtable.shape
            pack.copy_(pack_results_plain(state, pack_lo, e_win, r_cap, n))
        return state
    _ext.decide_window(
        state.wtable, state.la_w, state.fd_w, state.idx_w, state.coin_w,
        state.fame_decided, state.famous, state.rounds_decided,
        state.last_round, state.count, state.index, state.creator,
        state.rounds, state.received, state.stale, state.fame_lag,
        super_majority, n_participants, r_win, e_win, D_UNROLL, packed=packed,
        lamport=state.lamport, witness=state.witness, pack=pack, pack_lo=pack_lo,
    )
    return state


# ---------------------------------------------------------------------------
# entry points (compositions)
# ---------------------------------------------------------------------------


def _step_full(state: IncState, batch: Batch, super_majority: int,
               n_participants: int, r_win: int = 32, e_win: int = 8192,
               packed: bool = False, pack=None, pack_lo: int = 0) -> IncState:
    """Append one batch and decide: K9 -> K10 -> K12, in place, in the
    voting-table layout `packed` names. `pack` and `pack_lo` as
    _decide_body takes them (every entry point that decides passes them
    through)."""
    _check_windows(state, r_win, e_win)
    _step_body(state, batch, super_majority, n_participants, packed)
    return _decide_body(state, super_majority, n_participants, r_win=r_win,
                        e_win=e_win, packed=packed, pack=pack, pack_lo=pack_lo)


step = _step_full


def _unstack(stacked: Inputs, k: int) -> Inputs:
    return type(stacked)(*[f[k] for f in stacked])


def multi_step(state: IncState, stacked: Batch, super_majority: int,
               n_participants: int, r_win: int = 32, e_win: int = 8192,
               packed: bool = False, pack=None, pack_lo: int = 0) -> IncState:
    """K stacked batches (every field with a leading K axis), then one
    decide. Equal to K step calls: decisions are timing-independent."""
    _check_windows(state, r_win, e_win)
    stacked = device_put(stacked, state.la.device)
    for k in range(stacked.rows.shape[0]):
        _step_body(state, _unstack(stacked, k), super_majority, n_participants,
                   packed)
    return _decide_body(state, super_majority, n_participants, r_win=r_win,
                        e_win=e_win, packed=packed, pack=pack, pack_lo=pack_lo)


def train_step(state: IncState, train: Train, super_majority: int,
               n_participants: int, r_win: int = 32, e_win: int = 8192,
               packed: bool = False, pack=None, pack_lo: int = 0) -> IncState:
    """One whole train, then one decide: K9 -> K11 -> K12, in place, in
    the voting-table layout `packed` names. The throughput path of the
    incremental engine."""
    _check_windows(state, r_win, e_win)
    _train_body(state, train, super_majority, n_participants, packed)
    return _decide_body(state, super_majority, n_participants, r_win=r_win, e_win=e_win,
                        packed=packed, pack=pack, pack_lo=pack_lo)


def multi_train(state: IncState, stacked: Train, super_majority: int,
                n_participants: int, r_win: int = 32, e_win: int = 8192,
                packed: bool = False, pack=None, pack_lo: int = 0) -> IncState:
    """K stacked trains, then one decide. Equal to K train_step calls."""
    _check_windows(state, r_win, e_win)
    stacked = device_put(stacked, state.la.device)
    for k in range(stacked.rows.shape[0]):
        _train_body(state, _unstack(stacked, k), super_majority, n_participants, packed)
    return _decide_body(state, super_majority, n_participants, r_win=r_win, e_win=e_win,
                        packed=packed, pack=pack, pack_lo=pack_lo)


# ---------------------------------------------------------------------------
# host builders (numpy)
# ---------------------------------------------------------------------------


def empty_batch(n: int, batch: int, upd_cap: int, e_cap: int) -> Batch:
    """A no-op Batch (numpy fields; every scatter drops), as the live
    engine pads multi_step groups to their fixed stack shapes
    (babble_tpu/tpu/live.py _empty_batch)."""
    return Batch(
        rows=np.full(batch, -1, dtype=np.int32),
        creator=np.zeros(batch, dtype=np.int32),
        index=np.full(batch, MAX_INT32, dtype=np.int32),
        sp_row=np.full(batch, -1, dtype=np.int32),
        op_row=np.full(batch, -1, dtype=np.int32),
        la_rows=np.full((batch, n), -1, dtype=np.int32),
        coin=np.zeros(batch, dtype=bool),
        fixed_round=np.full(batch, -1, dtype=np.int32),
        upd_row=np.full(upd_cap, e_cap, dtype=np.int32),
        upd_col=np.zeros(upd_cap, dtype=np.int32),
        upd_val=np.zeros(upd_cap, dtype=np.int32),
        levels=np.full((L_MAX, batch), -1, dtype=np.int32),
    )


def stack_batches(batches):
    """Stack equal-shape Batches along a new leading axis."""
    return Batch(*[
        np.stack([np.asarray(getattr(b, f)) for b in batches])
        for f in Batch._fields
    ])


def stack_trains(trains):
    """Stack equal-shape Trains along a new leading axis, padding the level
    tables to the tallest member first."""
    t_max = max(t.levels.shape[0] for t in trains)
    w = trains[0].levels.shape[1]

    def padded(t):
        lv = np.asarray(t.levels)
        if lv.shape[0] < t_max:
            lv = np.concatenate(
                [lv, np.full((t_max - lv.shape[0], w), -1, dtype=np.int32)]
            )
        return t._replace(levels=lv)

    ts = [padded(t) for t in trains]
    return Train(*[
        np.stack([np.asarray(getattr(t, f)) for t in ts])
        for f in Train._fields
    ])


def _pad1(a, pad, fill, dtype=np.int32):
    a = np.asarray(a, dtype=dtype)
    return np.concatenate([a, np.full(pad, fill, dtype=dtype)])


def _pack_upd(upd, upd_cap, e_cap):
    """An (row, col, val) update list as fixed-shape scatter operands
    (row e_cap = dropped padding)."""
    urow = np.full(upd_cap, e_cap, dtype=np.int32)
    ucol = np.zeros(upd_cap, dtype=np.int32)
    uval = np.zeros(upd_cap, dtype=np.int32)
    if upd:
        a = np.asarray(upd, dtype=np.int32).reshape(-1, 3)
        k = a.shape[0]
        urow[:k], ucol[:k], uval[:k] = a[:, 0], a[:, 1], a[:, 2]
    return urow, ucol, uval


def _grid_slice_fields(grid: DagGrid, rows: np.ndarray, pad: int):
    """The Batch / Train fields both builders stage identically for a
    contiguous grid slice, padded to the static shape."""
    return dict(
        rows=_pad1(rows, pad, -1),
        creator=_pad1(grid.creator[rows], pad, 0),
        index=_pad1(grid.index[rows], pad, MAX_INT32),
        la_rows=np.concatenate(
            [grid.last_ancestors[rows],
             np.full((pad, grid.n), -1, dtype=np.int32)]
        ),
        coin=_pad1(grid.coin_bit[rows], pad, False, dtype=bool),
        fixed_round=_pad1(grid.fixed_round[rows], pad, -1),
    )


def _dep_levels(sp_pos: np.ndarray, op_pos: np.ndarray) -> np.ndarray:
    """Dependency depth of each slice member over slice-local parent
    positions (-1 = parent outside the slice)."""
    lvl = np.zeros(len(sp_pos), dtype=np.int64)
    for k in range(len(sp_pos)):
        d = 0
        for parent in (int(sp_pos[k]), int(op_pos[k])):
            if parent >= 0:
                d = max(d, lvl[parent] + 1)
        lvl[k] = d
    return lvl


def _pack_levels(lvl: np.ndarray, w_cap: int) -> np.ndarray:
    """Dependency levels as a (T, w_cap) position table; a level wider
    than w_cap spills over consecutive rows (moving a row later never
    breaks the parents-before-children order)."""
    table_rows = []
    depth = int(lvl.max(initial=-1)) + 1
    for d in range(depth):
        members = np.nonzero(lvl == d)[0].astype(np.int32)
        for s in range(0, len(members), w_cap):
            chunk = members[s : s + w_cap]
            row = np.full(w_cap, -1, dtype=np.int32)
            row[: len(chunk)] = chunk
            table_rows.append(row)
    if not table_rows:
        return np.full((1, w_cap), -1, dtype=np.int32)
    return np.stack(table_rows)


def _pad_rows(table: np.ndarray, t_cap: int, bucket: int = 32) -> np.ndarray:
    """The level table's height padded to the next bucket multiple (not
    to t_cap), as the reference pads it."""
    t, w = table.shape
    t_pad = min(-(-t // bucket) * bucket, t_cap)
    if t == t_pad:
        return table
    return np.concatenate([table, np.full((t_pad - t, w), -1, dtype=np.int32)])


def trains_from_grid(grid: DagGrid, train_size: int, upd_cap: int,
                     e_cap: int, w_cap: int = 64, t_cap: int = 96):
    """Slice a recorded synthetic DAG into fixed-shape Trains (numpy
    fields). Trains whose dependency depth or fd-update burst exceeds the
    caps are split in half."""
    if grid.fd_update_stream is None:
        raise ValueError("trains_from_grid needs a grid built with record_fd_updates=True")
    lamport_all = level_lamport(grid)
    spans = [(s, min(s + train_size, grid.e)) for s in range(0, grid.e, train_size)]
    out = []
    while spans:
        start, end = spans.pop(0)
        rows = np.arange(start, end)
        b = len(rows)
        pad = train_size - b

        sp = np.asarray(grid.self_parent[rows], dtype=np.int32)
        op = np.asarray(grid.other_parent[rows], dtype=np.int32)
        sp_pos = np.where((sp >= start) & (sp < end), sp - start, -1)
        op_pos = np.where((op >= start) & (op < end), op - start, -1)

        table = _pack_levels(_dep_levels(sp_pos, op_pos), w_cap)
        # one creator per level row (fork-free input): the registrations
        # of a level never collide
        for row in table:
            cs = grid.creator[rows[row[row >= 0]]]
            if len(np.unique(cs)) != len(cs):
                raise ValueError(
                    "forked creator within a dependency level; "
                    "train path requires fork-free grids"
                )
        upd = [t for r in rows for t in grid.fd_update_stream[r]]
        if table.shape[0] > t_cap or len(upd) > upd_cap:
            if b <= 1:
                raise ValueError(
                    f"single-event train exceeds caps (depth "
                    f"{table.shape[0]}/{t_cap}, upd {len(upd)}/{upd_cap})"
                )
            mid = (start + end) // 2
            spans[:0] = [(start, mid), (mid, end)]
            continue
        urow, ucol, uval = _pack_upd(upd, upd_cap, e_cap)
        out.append(Train(
            sp_row=_pad1(sp, pad, -1),
            op_row=_pad1(op, pad, -1),
            sp_pos=_pad1(sp_pos, pad, -1),
            op_pos=_pad1(op_pos, pad, -1),
            upd_row=urow, upd_col=ucol, upd_val=uval,
            levels=_pad_rows(table, t_cap),
            lamport=_pad1(lamport_all[rows], pad, -1),
            **_grid_slice_fields(grid, rows, pad),
        ))
    return out


def batches_from_grid(grid: DagGrid, batch_size: int, upd_cap: int, e_cap: int):
    """Slice a recorded synthetic DAG into fixed-shape append batches
    (numpy fields), the host work a live node does during inserts.
    Batches whose within-batch dependency depth exceeds L_MAX are split."""
    if grid.fd_update_stream is None:
        raise ValueError("batches_from_grid needs a grid built with record_fd_updates=True")
    spans = [(s, min(s + batch_size, grid.e)) for s in range(0, grid.e, batch_size)]
    out = []
    while spans:
        start, end = spans.pop(0)
        rows = np.arange(start, end)
        b = len(rows)
        pad = batch_size - b

        sp = grid.self_parent[rows]
        op = grid.other_parent[rows]
        sp_loc = np.where((sp >= start) & (sp < end), sp - start, -1)
        op_loc = np.where((op >= start) & (op < end), op - start, -1)
        lvl = _dep_levels(sp_loc, op_loc)
        l_b = int(lvl.max(initial=-1)) + 1 if b else 0
        if l_b > L_MAX:
            mid = (start + end) // 2
            spans[:0] = [(start, mid), (mid, end)]
            continue
        levels_full = np.full((L_MAX, batch_size), -1, dtype=np.int32)
        slot = np.zeros(max(l_b, 1), dtype=np.int64)
        for k in range(b):
            levels_full[lvl[k], slot[lvl[k]]] = k
            slot[lvl[k]] += 1

        upd = [t for r in rows for t in grid.fd_update_stream[r]]
        if len(upd) > upd_cap:
            raise ValueError(f"fd update burst {len(upd)} exceeds cap {upd_cap}")
        urow, ucol, uval = _pack_upd(upd, upd_cap, e_cap)
        out.append(Batch(
            sp_row=_pad1(sp, pad, -1),
            op_row=_pad1(op, pad, -1),
            upd_row=urow, upd_col=ucol, upd_val=uval,
            levels=levels_full,
            **_grid_slice_fields(grid, rows, pad),
        ))
    return out
