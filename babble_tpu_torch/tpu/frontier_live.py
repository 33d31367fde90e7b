"""Frontier-based incremental device consensus for the PyTorch port: the
round-frontier pipeline (tpu/frontier.py) with its INV / chain tables
maintained incrementally across append trains.

Counterpart of babble_tpu/tpu/frontier_live.py. INV[c, p, v] (the first
chain-c index whose p-coordinate reaches v) is a suffix-min closure over
per-event scatter entries, and lastAncestors are non-decreasing along a
chain, so appending an event touches only its own chain's (N, L) plane:
one scatter-min of its index at v = la[e, p] per coordinate that advanced
past its self-parent's, then the idempotent suffix-min re-closure.
Frontier values X(r)[c] only ever fill in, so a walk of R_WIN rounds from
the lowest round a dirty chain can still change, over the maintained
tables, gives the one-shot pipeline's rounds; fame and round received
follow from the witness tables. No first-descendant matrix is kept:
fd[e, p] == INV[p, creator(e), index(e)].

Latches, as in the reference (the host falls back when one is set):
`l_over` (a chain outgrew the index axis), `r_over` (rounds outgrew the
walk window or the round axis), `frozen_violation` (a witness registered
into a round whose fame the previous state had fully decided).

Two kernels carry the card path (babble_tpu_torch/csrc/):

- K14 frontier_append.cu  `_append_train`: the train's rows, the INV
  scatter-min and the dirty planes' re-closure, rows_by and the flags;
- K15 frontier_walk.cu    `_decide`'s walk half (babble_frontier_window):
  the warm-start windowed walk with fd rows from INV, one cooperative
  launch that stops at the walk's fixed point (the window's rows past it
  repeat X, and r_over reads that row), the post pass and the voting's
  witness tables;

then the ported K3 / K3p `decide_fame` and K4 `round_received` vote and
receive over those tables through a compact witness table (witness slot
r * N + c on a row of the (R * N, N) tables). Each wrapper runs its plain
PyTorch version when the state lies on the CPU and its kernel on a CUDA
card.

JAX donates the state to frontier_train_step / frontier_multi_train; here
they update the state's tensors in place and return the same state.
`_decide` never writes its input (the bootstrap reads its input again)
and returns a state with fresh tensors for the fields it decides. INV is
int32 here (float32 with exact integer values in the reference).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from . import _ext
from .device import resolve_device, to_device
from .frontier import frontier_post, frontier_x0, make_walk_step, suffix_min
from .grid import MAX_INT32, GridUnsupported
from .incremental import Train, _row_get, _unstack, device_put
from .kernels import decide_fame, decide_round_received

# rounds recomputed per decide call: must cover the unsettled suffix (the
# top ~2 rounds whose frontier entries are still filling) plus every round
# a single train can add (the reference's constant)
R_WIN = 24

_I32 = torch.int32


class FrState(NamedTuple):
    """Frontier-engine state (E_cap rows, N chains x L indexes, r_cap
    rounds), resident on one device."""

    inv: torch.Tensor  # (N, N, L) int32 threshold tables (maintained)
    rows_by: torch.Tensor  # (N, L) int32 chain tables (-1 = none)
    x_hist: torch.Tensor  # (r_cap, N) int32 frontier history (L = sentinel)
    dirty: torch.Tensor  # (N,) bool: chains appended to since the last walk
    la: torch.Tensor  # (E_cap, N) int32
    creator: torch.Tensor  # (E_cap,) int32
    index: torch.Tensor  # (E_cap,) int32 (-1 = empty row)
    lamport: torch.Tensor  # (E_cap,) int32 (host-maintained, shipped per train)
    coin: torch.Tensor  # (E_cap,) bool
    rounds: torch.Tensor  # (E_cap,) int32
    witness: torch.Tensor  # (E_cap,) bool
    received: torch.Tensor  # (E_cap,) int32
    wtable: torch.Tensor  # (r_cap, N) int32
    fame_decided: torch.Tensor  # (r_cap, N) bool
    famous: torch.Tensor  # (r_cap, N) bool
    rounds_decided: torch.Tensor  # (r_cap,) bool
    last_round: torch.Tensor  # () int32
    count: torch.Tensor  # () int32
    l_over: torch.Tensor  # () bool: chain index axis exhausted
    r_over: torch.Tensor  # () bool: walk round window exhausted
    frozen_violation: torch.Tensor  # () bool: late witness in a decided round


_BOOL_FIELDS = frozenset(
    ("dirty", "coin", "witness", "fame_decided", "famous", "rounds_decided",
     "l_over", "r_over", "frozen_violation")
)

# the fields _decide computes; the train steps copy them into the state
_DECIDED = ("x_hist", "dirty", "rounds", "witness", "received", "wtable",
            "fame_decided", "famous", "rounds_decided", "last_round", "r_over",
            "frozen_violation")


def init_frontier_state(n: int, e_cap: int, l_cap: int, r_cap: int,
                        device=None) -> FrState:
    """An empty state on `device` (the card unless the caller passes
    "cpu")."""
    dev = resolve_device(device)

    def full(shape, value, dtype=_I32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return FrState(
        inv=full((n, n, l_cap), l_cap),
        rows_by=full((n, l_cap), -1),
        x_hist=full((r_cap, n), l_cap),
        dirty=full((n,), False, torch.bool),
        la=full((e_cap, n), -1),
        creator=full((e_cap,), 0),
        index=full((e_cap,), -1),
        lamport=full((e_cap,), -1),
        coin=full((e_cap,), False, torch.bool),
        rounds=full((e_cap,), -1),
        witness=full((e_cap,), False, torch.bool),
        received=full((e_cap,), -1),
        wtable=full((r_cap, n), -1),
        fame_decided=full((r_cap, n), False, torch.bool),
        famous=full((r_cap, n), False, torch.bool),
        rounds_decided=full((r_cap,), False, torch.bool),
        last_round=full((), 0),
        count=full((), 0),
        l_over=full((), False, torch.bool),
        r_over=full((), False, torch.bool),
        frozen_violation=full((), False, torch.bool),
    )


def frontier_state_from_numpy(fr_state_np, device=None) -> FrState:
    """The port's FrState from the reference's (a FrState of arrays, or a
    mapping of field name -> array, e.g. through np.asarray), on `device`.
    The reference's float32 INV holds exact integers and becomes int32.
    Arrays are copied."""
    get = (fr_state_np.__getitem__ if isinstance(fr_state_np, Mapping)
           else lambda f: getattr(fr_state_np, f))
    dev = resolve_device(device)
    fields = {}
    for f in FrState._fields:
        a = np.asarray(get(f))
        if f == "inv" and a.dtype.kind == "f":
            if not (np.rint(a) == a).all():
                raise ValueError("frontier_state_from_numpy: INV holds non-integers")
        dtype = np.bool_ if f in _BOOL_FIELDS else np.int32
        # torch.from_numpy keeps the 0-d scalars 0-d
        fields[f] = torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(dev)
    return FrState(**fields)


def clone_frontier_state(state: FrState) -> FrState:
    """An independent copy of every buffer, on the same device."""
    return FrState(*[t.clone() for t in state])


# ---------------------------------------------------------------------------
# K14: one append train
# ---------------------------------------------------------------------------


def _append_train_plain(state: FrState, train: Train) -> None:
    """The reference's _append_train, in place: the INV scatter-min of
    each advanced coordinate (against the pre-train la of self-parents
    outside the train) and the suffix-min re-closure, then the rows'
    staging, rows_by (its clipped cell past the index axis overwritten,
    the last event in train order winning), the flags and the count."""
    e_cap, n = state.la.shape
    l = state.rows_by.shape[1]
    kb = train.rows.shape[0]
    dev = state.la.device
    valid = train.rows >= 0
    c = train.creator
    c_ok = valid & (c >= 0) & (c < n)

    la_rows = train.la_rows
    la_sp_pre = _row_get(state.la, train.sp_row, -1)  # mode="fill"
    la_sp_train = la_rows[train.sp_pos.clamp(0, kb - 1).long()]
    la_sp = torch.where((train.sp_pos >= 0)[:, None], la_sp_train, la_sp_pre)
    scatter = c_ok[:, None] & (la_rows >= 0) & (la_rows > la_sp)
    v_slot = la_rows.clamp(max=l - 1).long()
    p_idx = torch.arange(n, device=dev)[None, :]
    flat = (c.long()[:, None] * n + p_idx) * l + v_slot
    idx_b = train.index[:, None].expand(kb, n)
    state.inv.view(-1).scatter_reduce_(0, flat[scatter], idx_b[scatter], "amin")
    state.inv.copy_(suffix_min(state.inv, dim=2))

    ok = valid & (train.rows < e_cap)
    tr = train.rows[ok].long()
    state.la[tr] = la_rows[ok]
    state.creator[tr] = c[ok]
    state.index[tr] = train.index[ok]
    state.lamport[tr] = train.lamport[ok]
    state.coin[tr] = train.coin[ok]

    key = c.long().clamp(0, n - 1) * l + train.index.clamp(0, l - 1).long()
    pos = torch.arange(kb, device=dev)
    last = torch.full((n * l,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, key[c_ok], pos[c_ok], "amax")
    win = c_ok & (last[key] == pos)
    state.rows_by.view(-1)[key[win]] = train.rows[win]

    state.l_over.logical_or_((valid & (train.index >= l)).any())
    state.dirty[c[c_ok].long()] = True
    state.count.add_(valid.sum(dtype=_I32))


def _append_train(state: FrState, train: Train) -> None:
    """K14 (babble_tpu/tpu/frontier_live.py:113), in place. CPU: the plain
    version; CUDA: csrc/frontier_append.cu."""
    if state.la.device.type == "cpu":
        _append_train_plain(state, train)
        return
    _ext.frontier_append(
        state.la, state.creator, state.index, state.lamport, state.coin,
        state.rows_by, state.inv, state.dirty, state.count, state.l_over,
        train.rows, train.creator, train.index, train.lamport, train.coin,
        train.sp_row, train.sp_pos, train.la_rows,
    )


# ---------------------------------------------------------------------------
# K15: the decide's walk half
# ---------------------------------------------------------------------------


class WindowResult(NamedTuple):
    x_hist: torch.Tensor  # (r_cap, N) int32, the window's rows rewritten
    r_over: torch.Tensor  # () bool, latched by the window
    rounds: torch.Tensor  # (E_cap,) int32
    witness: torch.Tensor  # (E_cap,) bool
    wtable: torch.Tensor  # (r_cap, N) int32 event rows (-1 = none)
    last_round: torch.Tensor  # () int32
    la_w: torch.Tensor  # (r_cap, N, N) int32
    idx_w: torch.Tensor  # (r_cap, N) int32 (MAX = none)
    coin_w: torch.Tensor  # (r_cap, N) bool
    fd_w: torch.Tensor  # (r_cap, N, N) int32 (MAX = none)
    wtable_c: torch.Tensor  # (r_cap, N) int32 witness slot r * N + c (-1 = none)


def _decide_window_plain(state: FrState, super_majority: int) -> WindowResult:
    """The walk half of the reference's _decide, line for line: floor,
    seed and the R_WIN binary-search steps with fd rows from INV, the post
    pass over the whole history, then the witness tables."""
    e_cap, n = state.la.shape
    l = state.rows_by.shape[1]
    r_cap = state.wtable.shape[0]
    dev = state.la.device
    r_win = min(R_WIN, r_cap)

    # X(r)[c] is non-decreasing in r: the first sentinel row per chain is
    # the count of non-sentinel rows
    first_sent = (state.x_hist < l).sum(dim=0, dtype=_I32)
    floor = int(torch.where(state.dirty, first_sent, torch.full_like(first_sent, r_cap)).min())
    floor = min(max(floor, 0), r_cap - r_win)
    start = max(floor - 1, 0)
    x = frontier_x0(state.rows_by) if floor == 0 else state.x_hist[start]

    step = make_walk_step(state.inv, state.rows_by, None, state.la, super_majority,
                          m0_mode="binsearch")
    rows = []
    for _ in range(r_win):
        rows.append(x)
        x = step(x)
    x_hist = state.x_hist.clone()
    x_hist[start:start + r_win] = torch.stack(rows)
    r_over = state.r_over | (x < l).any()

    fr = frontier_post(x_hist, state.rows_by, state.creator, state.index, state.index - 1)
    wtable = fr.witness_table
    wvalid = wtable >= 0
    wrows = wtable.clamp(0, e_cap - 1).long()
    la_w = state.la[wrows]
    idx_w = torch.where(wvalid, state.index[wrows], torch.full_like(wtable, MAX_INT32))
    coin_w = state.coin[wrows]
    cc = torch.arange(n, device=dev)
    fdw = state.inv[cc[None, None, :], cc[None, :, None],
                    idx_w.clamp(0, l - 1).long()[:, :, None]]  # (R, C, P)
    fd_w = torch.where(wvalid[:, :, None] & (fdw < l), fdw, torch.full_like(fdw, MAX_INT32))
    slots = torch.arange(r_cap * n, dtype=_I32, device=dev).view(r_cap, n)
    wtable_c = torch.where(wvalid, slots, torch.full_like(slots, -1))
    return WindowResult(x_hist, r_over, fr.rounds, fr.witness, wtable, fr.last_round,
                        la_w, idx_w, coin_w, fd_w, wtable_c)


def _decide_window(state: FrState, super_majority: int) -> WindowResult:
    """K15 (the walk half of babble_tpu/tpu/frontier_live.py:184 _decide).
    CPU: the plain version; CUDA: csrc/frontier_walk.cu
    babble_frontier_window."""
    if state.la.device.type == "cpu":
        return _decide_window_plain(state, super_majority)
    return WindowResult(*_ext.frontier_window(
        state.inv, state.rows_by, state.x_hist, state.dirty, state.creator,
        state.index, state.coin, state.la, state.r_over, super_majority,
        min(R_WIN, state.wtable.shape[0]),
    ))


def _decide_from(state: FrState, win: WindowResult, super_majority: int,
                 n_participants: int, packed: bool = False) -> FrState:
    """Fame and round received over the window's witness tables (K3 / K3p
    and K4 through the compact table), then the frozen-round and
    round-capacity latches; a new state, the input unchanged."""
    r_cap, n = win.wtable.shape
    la_flat = win.la_w.view(r_cap * n, n)
    fame = decide_fame(
        win.wtable_c, la_flat, win.fd_w.view(r_cap * n, n), win.idx_w.view(-1),
        win.coin_w.view(-1), win.last_round, super_majority, n_participants, r_cap + 2,
        packed=packed,
    )
    received = decide_round_received(
        win.wtable_c, la_flat, state.index, state.creator, win.rounds, fame.decided,
        fame.famous, fame.rounds_decided, win.last_round,
    )
    # a witness whose round the PREVIOUS state had fully fame-decided: the
    # host engine freezes that round; recomputation would silently unblock
    new_w = win.witness & ~state.witness
    prev_rd = state.rounds_decided[win.rounds.clamp(0, r_cap - 1).long()]
    frozen = state.frozen_violation | (new_w & prev_rd & (win.rounds >= 0)).any()
    r_over = win.r_over | (win.last_round + 2 >= r_cap)
    return state._replace(
        x_hist=win.x_hist, dirty=torch.zeros_like(state.dirty), rounds=win.rounds,
        witness=win.witness, received=received, wtable=win.wtable,
        fame_decided=fame.decided, famous=fame.famous,
        rounds_decided=fame.rounds_decided, last_round=win.last_round,
        r_over=r_over, frozen_violation=frozen,
    )


def _decide(state: FrState, super_majority: int, n_participants: int,
            packed: bool = False) -> FrState:
    """Warm-start windowed frontier walk + fame + received over the
    maintained tables: K15, then K3 (K3p with `packed`) and K4. Returns a
    new state; the input is left intact."""
    return _decide_from(state, _decide_window(state, super_majority), super_majority,
                        n_participants, packed)


def _assign(state: FrState, decided: FrState) -> FrState:
    """Copy _decide's fields into the state's tensors, in place."""
    for f in _DECIDED:
        getattr(state, f).copy_(getattr(decided, f))
    return state


def frontier_train_step(state: FrState, train: Train, super_majority: int,
                        n_participants: int, packed: bool = False) -> FrState:
    """One whole append train (K14), then walk + fame + received (K15, K3
    or K3p, K4), in place; returns the state. The train is moved to the
    state's device where it is not there yet."""
    train = device_put(train, state.la.device)
    _append_train(state, train)
    return _assign(state, _decide(state, super_majority, n_participants, packed))


def frontier_multi_train(state: FrState, stacked: Train, super_majority: int,
                         n_participants: int, packed: bool = False) -> FrState:
    """K stacked trains (every field with a leading K axis) appended, then
    one decide, in place. Equal to K frontier_train_step calls: decisions
    are pure functions of the maintained tables."""
    stacked = device_put(stacked, state.la.device)
    for k in range(stacked.rows.shape[0]):
        _append_train(state, _unstack(stacked, k))
    return _assign(state, _decide(state, super_majority, n_participants, packed))


# ---------------------------------------------------------------------------
# cold-start bootstrap (the log-diameter cold path, tpu/doubling.py)
# ---------------------------------------------------------------------------


def bootstrap_frontier_state(grid, e_cap: int, l_cap: int, r_cap: int,
                             n_participants: int, packed: bool = False,
                             device=None) -> FrState:
    """A ready FrState for an existing base-state DAG without replaying
    it through append trains: the frontier history from the cold path's
    pointer-doubling walk, INV and the chain table from one build_inv,
    then one _decide over the installed history (every chain clean, so
    its window lands on the sentinel tail).

    Raises GridUnsupported for seeded grids (post-reset states replay
    through doubling.maybe_cold_replay) and past the state's capacities,
    as the reference does."""
    from .doubling import _doubling_walk
    from .engine import _frontier_safe
    from .frontier import build_inv, level_lamport

    dev = resolve_device(device)
    n, e = grid.n, grid.e
    if e == 0 or not _frontier_safe(grid):
        raise GridUnsupported("frontier bootstrap: empty or seeded grid")
    if e > e_cap or r_cap < R_WIN:
        raise GridUnsupported("frontier bootstrap: capacity")
    l_real = int(grid.index.max(initial=0)) + 1
    if l_real > l_cap:
        raise GridUnsupported("frontier bootstrap: chain axis capacity")

    rows_by = np.full((n, l_cap), -1, dtype=np.int32)
    rows_by[grid.creator, grid.index] = np.arange(e, dtype=np.int32)
    counts = np.bincount(grid.creator, minlength=n)
    if not bool(((np.arange(l_cap)[None, :] < counts[:, None]) == (rows_by >= 0)).all()):
        raise GridUnsupported("frontier bootstrap: non-contiguous chains")

    la_np = np.full((e_cap, n), -1, dtype=np.int32)
    la_np[:e] = grid.last_ancestors
    fd_np = np.full((e_cap, n), MAX_INT32, dtype=np.int32)
    fd_np[:e] = grid.first_descendants
    creator_np = np.zeros(e_cap, dtype=np.int32)
    creator_np[:e] = grid.creator
    index_np = np.full(e_cap, -1, dtype=np.int32)
    index_np[:e] = grid.index
    lamport_np = np.full(e_cap, -1, dtype=np.int32)
    lamport_np[:e] = level_lamport(grid)
    coin_np = np.zeros(e_cap, dtype=bool)
    coin_np[:e] = grid.coin_bit

    def put(a):
        return to_device(a, dev)

    rows_by_d = put(rows_by)
    la_d = put(la_np)
    inv = build_inv(rows_by_d, la_d)  # (N, N, l_cap) int32

    x0 = np.where(rows_by[:, 0] >= 0, 0, l_cap).astype(np.int32)
    x_hist = _doubling_walk(
        put, inv, rows_by_d, put(fd_np), la_d, x0,
        np.full((1, n), l_cap, dtype=np.int32), np.full(n, -1, dtype=np.int32),
        grid.super_majority, l_cap, False, {},
    )
    # trim the chunked walk's sentinel overshoot; X rows past the last
    # round stay at the init sentinel
    live_rows = int((x_hist < l_cap).any(axis=1).sum())
    if live_rows + 2 >= r_cap:
        raise GridUnsupported("frontier bootstrap: round axis capacity")
    x_np = np.full((r_cap, n), l_cap, dtype=np.int32)
    x_np[:live_rows] = x_hist[:live_rows]

    state = init_frontier_state(n, e_cap, l_cap, r_cap, device=dev)._replace(
        inv=inv, rows_by=rows_by_d, x_hist=put(x_np), la=la_d, creator=put(creator_np),
        index=put(index_np), lamport=put(lamport_np), coin=put(coin_np),
        count=torch.tensor(e, dtype=_I32, device=dev),
    )
    return _decide(state, grid.super_majority, n_participants, packed=packed)
