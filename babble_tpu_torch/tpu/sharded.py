"""Multi-device consensus on a DeviceMesh: the virtual-voting pipeline
partitioned over mesh positions (counterpart of babble_tpu/tpu/sharded.py).

Layout, as in the reference:

- **DivideRounds** runs replicated: once, on the mesh's device (the level
  scan K5, the frontier walk's post pass, or the cold path's stage 1).
- **DecideFame** shards over the *rounds* axis. Each position owns
  R / dr rounds of the j-aligned voting state; the voters of step d sit d
  rows ahead, so the strongly-see rows, the voter validity and the coin
  bits ring-shift one row per step (`mesh.ppermute_shift_left`). On a 2-D
  (validators, rounds) mesh the voted-witness axis is split too: each
  position tallies its witness columns, and one `mesh.psum` of the tallies
  over the validator axis closes every step. The early exit is
  host-chunked: `chunk` steps, then one int per position read on the host.
  Where every position lies on one device the whole loop is one launch
  (B21's one-card form: K3's vote on tables gathered from the shards, the
  ring shift an address offset, each witness column stopping at its own
  exit); `_ext.shard_fame_form` chooses, by layout, and takes the step
  form past the one launch's 19,296 voters.
- **DecideRoundReceived** shards over the *events* axis against the
  replicated (R, N) fame tables. Where every position lies on one device
  the tables and every event are one launch (B22's events after B23's
  tables, the event axis unsharded).
- The frontier walk shards over *chains*: each position builds and keeps
  its chains' INV (K1 on its slice of the chain table; on one device one
  K1 launch over every position's chains, each position's INV a view).
  Where every position lies on one device the whole walk is one launch
  over every position's chains, stopping at its fixed point; where
  positions lie on distinct cards the frontier rows and m0 cross the mesh
  by two tiled all-gathers per step (`_ext.shard_walk_form` chooses, by
  layout alone, for K1, the walk and pass 3 alike).

Each kernel of a position's shard is a wrapper: on a CPU tensor it runs
the plain PyTorch version below, on a CUDA tensor the hand-written kernel
(babble_tpu_torch/csrc/shard_fame.cu for B21 `local_fame`, in one launch
`babble_shard_fame_grid` or step by step;
round_received.cu's `babble_received_search` and `babble_fame_tables` for
B22 `local_received` and B23 `_fame_tables`, `babble_fame_received` for
both in one launch; frontier_walk.cu's
`babble_shard_walk` for B24 `local_walk` in one launch, and its
`babble_shard_walk_rows`, `_m0`, `_close` step by step), or raises. The replicated
fame setup and the walk's post pass run K3's and K2's kernels on their own
(`babble_fame_setup`, `babble_frontier_post`). Padding, rolls, slices and
the collectives are glue. The reference donates its carried buffers; here
the staged buffers are written in place.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..obs.devledger import ledger_call
from . import _ext
from .device import to_device
from .engine import PassResults
from .frontier import (
    M0_BINSEARCH_MIN_N, _m0_binsearch, _m0_einsum_sort, build_inv, frontier_post,
)
from .grid import MAX_INT32, DagGrid, GridUnsupported
from .kernels import _fame_setup, _received_tables, received_search, vote_tallies
from .mesh import (
    DeviceMesh, all_gather, axis_index, axis_size, ppermute_shift_left, psum, replicate, shard,
    unshard,
)
from .packed import LANE, pack_bits, pack_votes_t, popcount_sum, resolve_packed


def _mesh_axes(mesh: DeviceMesh):
    """(rounds_axis, validator_axis) of a consensus mesh. 1-D meshes
    shard rounds/events/chains over their single axis (validator_axis
    None); 2-D ``(validators, rounds)`` meshes additionally partition the
    fame working set's witness axis."""
    names = mesh.axis_names
    if len(names) == 1:
        return names[0], None
    if len(names) == 2:
        return names[1], names[0]
    raise GridUnsupported(f"unsupported mesh rank: axes {names!r}")


def mesh_validator_shards(mesh: DeviceMesh) -> int:
    """Validator-axis extent of the mesh (1 on 1-D meshes)."""
    _, v_axis = _mesh_axes(mesh)
    return int(mesh.shape[v_axis]) if v_axis is not None else 1


def sharded_engine_tag(mesh: DeviceMesh, doubling: bool = False) -> str:
    """Engine label for decision-provenance capture: distinguishes the
    1-D event-sharded layout from the 2-D validator-sharded one (and the
    sharded doubling cold path)."""
    tag = "mesh2d" if mesh_validator_shards(mesh) > 1 else "mesh"
    return tag + "-doubling" if doubling else tag


def _pad_axis0(a: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full((size,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


# ---------------------------------------------------------------------------
# B21 local_fame: one voting step on a position's shard
# ---------------------------------------------------------------------------


def _j_ok(i_rows, last_round, d: int) -> torch.Tensor:
    return (i_rows + d) <= last_round


def _shard_tally_plain(ss_s, votes, i_rows, last_round, d: int, packed: bool):
    """yays (B, N_y, N_x) and total (B, N_y), int32: the reference step's
    local einsum (or AND + popcount) over the rounds whose voting round
    j = i + d is at most last_round; the other rows tally 0."""
    b, ny = ss_s.shape[0], ss_s.shape[1]
    nx = votes.shape[1] if packed else votes.shape[2]
    yays = torch.zeros((b, ny, nx), dtype=torch.int32, device=ss_s.device)
    total = torch.zeros((b, ny), dtype=torch.int32, device=ss_s.device)
    rows = torch.nonzero(_j_ok(i_rows, last_round, d)).flatten()
    if rows.numel():
        ss_d = ss_s[rows]
        yays[rows] = vote_tallies(ss_d, votes[rows], packed)
        total[rows] = (popcount_sum(ss_d) if packed
                       else ss_d.sum(dim=-1, dtype=torch.int32))
    return yays, total


def shard_tally(ss_s, votes, i_rows, last_round, d: int, packed: bool):
    """B21 (a): CPU the plain version; CUDA the kernel."""
    if ss_s.device.type == "cpu":
        return _shard_tally_plain(ss_s, votes, i_rows, last_round, d, packed)
    return _ext.shard_fame_tally(ss_s, votes, i_rows, last_round, d, packed)


def _shard_decide_plain(yays, total, i_rows, last_round, wvalid, decided, famous,
                        wv_s, coin_s, votes, v_off: int, d: int, n_participants: int,
                        super_majority: int, packed: bool) -> None:
    """The reference step after its psum, in place: first decisions win,
    coin steps take the voter's coin bit where not strong, and the next
    votes (repacked transposed when packed) are cut to the shard's slice."""
    nays = total[:, :, None] - yays
    v = yays >= nays
    t = torch.where(v, yays, nays)
    is_coin = (d % n_participants) == 0
    strong = t >= super_majority
    if is_coin:
        new_votes = torch.where(strong, v, coin_s[:, :, None])
    else:
        vy = wv_s & _j_ok(i_rows, last_round, d)[:, None]
        decide_now = strong & vy[:, :, None] & wvalid[:, None, :] & ~decided[:, None, :]
        any_decide = decide_now.any(dim=1)
        fame_val = (decide_now & v).any(dim=1)
        famous.copy_(torch.where(any_decide, fame_val, famous))
        decided.copy_(decided | any_decide)
        new_votes = v
    if packed:
        w_local = votes.shape[2]
        votes.copy_(pack_votes_t(new_votes)[:, :, v_off: v_off + w_local])
    else:
        w_local = votes.shape[1]
        votes.copy_(new_votes[:, v_off: v_off + w_local, :])


def shard_decide(yays, total, i_rows, last_round, wvalid, decided, famous, wv_s, coin_s,
                 votes, v_off: int, d: int, n_participants: int, super_majority: int,
                 packed: bool) -> None:
    """B21 (b), in place: CPU the plain version; CUDA the kernel."""
    args = (yays, total, i_rows, last_round, wvalid, decided, famous, wv_s, coin_s, votes,
            v_off, d, n_participants, super_majority, packed)
    if yays.device.type == "cpu":
        _shard_decide_plain(*args)
    else:
        _ext.shard_fame_decide(*args)


def _shard_active_plain(wvalid, decided, i_rows, last_round, d0: int) -> torch.Tensor:
    act = (wvalid & ~decided & _j_ok(i_rows, last_round, d0)[:, None]).any()
    return act.to(torch.int32).reshape(1)


def shard_active(wvalid, decided, i_rows, last_round, d0: int) -> torch.Tensor:
    """B21 (c): (1,) int32; CPU the plain version; CUDA the kernel."""
    if wvalid.device.type == "cpu":
        return _shard_active_plain(wvalid, decided, i_rows, last_round, d0)
    return _ext.shard_fame_active(wvalid, decided, i_rows, last_round, d0)


def _step_fame(mesh: DeviceMesh, axis: str, v_axis: Optional[str], chunk: int,
               n_participants: int, super_majority: int, d_bound: int, packed: bool,
               last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s, coin_s,
               plain: bool) -> None:
    """The voting pass step by step (the reference's shard_mapped
    while_loop), in place on the per-position lists: one chunk always runs;
    after it, chunks of `chunk` steps while some position still has an
    active witness (read on the host once per chunk) and d0 <= d_bound. Each
    step: a tally per position, on a 2-D mesh a psum of the tallies over
    the validator axis, a decide per position, then the ring shift of ss_s,
    wv_s and coin_s. plain=False: the three per-step wrappers (the "step"
    form); plain=True: their plain versions (the plain version of the
    one-launch form)."""
    positions = range(mesh.size)
    if packed:
        v_offs = [axis_index(p, mesh, v_axis) * votes[p].shape[2] for p in positions]
    else:
        v_offs = [axis_index(p, mesh, v_axis) * votes[p].shape[1] for p in positions]
    tally, decide, active = ((_shard_tally_plain, _shard_decide_plain, _shard_active_plain)
                             if plain else (shard_tally, shard_decide, shard_active))

    def step(d):
        tallies = [tally(ss_s[p], votes[p], i_rows[p], last_round[p], d, packed)
                   for p in positions]
        yays = [t[0] for t in tallies]
        total = [t[1] for t in tallies]
        if v_axis is not None:
            # close the witness-shard partial tallies over the validator axis
            yays = psum(yays, mesh, v_axis)
            total = psum(total, mesh, v_axis)
        for p in positions:
            decide(yays[p], total[p], i_rows[p], last_round[p], wvalid[p], decided[p],
                   famous[p], wv_s[p], coin_s[p], votes[p], v_offs[p], d, n_participants,
                   super_majority, packed)
        for parts in (ss_s, wv_s, coin_s):
            ppermute_shift_left(parts, mesh, axis)

    def chunk_body(d0):
        for k in range(chunk):
            step(d0 + k)
        d0 += chunk
        flags = [active(wvalid[p], decided[p], i_rows[p], last_round[p], d0)
                 for p in positions]
        dev = flags[0].device
        active_any = int(torch.cat([f.to(dev) for f in flags]).sum().item()) > 0
        return d0, active_any

    d0, active_any = chunk_body(2)  # voting always runs at least one chunk
    while active_any and d0 <= d_bound:
        d0, active_any = chunk_body(d0)


def fame_grid(mesh: DeviceMesh, axis: str, v_axis: Optional[str], chunk: int,
              n_participants: int, super_majority: int, d_bound: int, packed: bool,
              last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s,
              coin_s) -> None:
    """B21's whole loop in one launch, every position on one device, in
    place on decided and famous (the votes and the shifted state are left as
    they were): CPU the plain version, the step-by-step loop of the plain
    steps (which also leaves the final votes and shifted state); CUDA the
    cooperative kernel, positions passed in (rounds index, validator index)
    order. Each column of the kernel stops at its own exit (decided, or i +
    d > last_round), which the step-by-step loop never passes before it
    stops (last_round < r_pad < d_bound: a column still active at a chunk's
    end keeps the loop going)."""
    if mesh.device.type == "cpu":
        _step_fame(mesh, axis, v_axis, chunk, n_participants, super_majority, d_bound, packed,
                   last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s, coin_s,
                   plain=True)
        return
    _ext.shard_fame_grid(*grid_operands(mesh, axis, v_axis, ss_s, votes, wv_s, coin_s, wvalid,
                                        decided, famous), last_round[0], n_participants,
                         super_majority, packed)


def grid_operands(mesh: DeviceMesh, axis: str, v_axis: Optional[str], *tables):
    """The one-launch loop's operands: each per-position list of `tables`
    in (rounds index, validator index) order, then the number of validator
    positions to a rounds index."""
    n_v = axis_size(mesh, v_axis) if v_axis is not None else 1
    order = sorted(range(mesh.size), key=lambda p: (
        axis_index(p, mesh, axis), axis_index(p, mesh, v_axis) if v_axis is not None else 0))
    return (*([parts[p] for p in order] for parts in tables), n_v)


def _fame_loop(mesh: DeviceMesh, axis: str, v_axis: Optional[str], chunk: int,
               n_participants: int, super_majority: int, d_bound: int, packed: bool,
               last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s,
               coin_s, form: Optional[str] = None) -> None:
    """The whole voting pass over the mesh, in place on decided and famous.
    `form` is _ext.shard_fame_form's unless named: "grid", one launch for
    every position (every position on one device, up to 32 *
    _ext.FV_MAX_WORDS voters; on the CPU the plain step-by-step loop), or
    "step", three launches per step and position (positions on distinct
    cards, or more voters). Both give the same decided and famous."""
    if form is None:
        form = _ext.shard_fame_form(mesh.devices, ss_s[0].shape[1])
    args = (mesh, axis, v_axis, chunk, n_participants, super_majority, d_bound, packed,
            last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s, coin_s)
    if form == "grid":
        if _ext.shard_walk_form(mesh.devices) != "grid":
            raise ValueError("local_fame: the one-launch loop needs every position on one "
                             "device")
        fame_grid(*args)
    elif form == "step":
        _step_fame(*args, plain=False)
    else:
        raise ValueError(f"local_fame: no form {form!r}; {_ext.SHARD_WALK_FORMS}")


# ---------------------------------------------------------------------------
# B23 _fame_tables and B22 local_received
# ---------------------------------------------------------------------------


def _fame_tables_plain(wtable, la, decided, famous, last_round):
    wvalid = wtable >= 0
    rounds_decided = (decided | ~wvalid).all(dim=1) & wvalid.any(dim=1)
    min_la, famous_count, i_ok, horizon = _received_tables(
        wtable, la, decided, famous, rounds_decided, last_round
    )
    return min_la, famous_count, i_ok, horizon, rounds_decided


def fame_tables(wtable, la, decided, famous, last_round):
    """B23, the replicated post-fame tables (min_la, famous_count, i_ok,
    horizon, rounds_decided): CPU the plain version; CUDA the kernel."""
    if wtable.device.type == "cpu":
        return _fame_tables_plain(wtable, la, decided, famous, last_round)
    return _ext.fame_tables(wtable, la, decided, famous, last_round)


def local_received(index, creator, rounds, min_la, famous_count, i_ok, horizon):
    """B22, received over one event shard: CPU the plain version
    (kernels.received_search); CUDA the kernel."""
    if index.device.type == "cpu":
        return received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon)
    return _ext.received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon)


def fame_received(wtable, la, decided, famous, last_round, index, creator, rounds):
    """B23 then B22 over the whole event axis, every position on one
    device: (the five tables fame_tables gives, received (E,)). CPU the
    plain versions; CUDA one launch (the tables, a grid barrier, the
    events)."""
    if wtable.device.type == "cpu":
        tables = _fame_tables_plain(wtable, la, decided, famous, last_round)
        return tables, received_search(index, creator, rounds, *tables[:4])
    *tables, received = _ext.fame_received(wtable, la, decided, famous, last_round, index,
                                           creator, rounds)
    return tuple(tables), received


# ---------------------------------------------------------------------------
# the replicated fame setup (K3's setup) and the staging of passes 2+3
# ---------------------------------------------------------------------------


def fame_setup(wtable, la, fd, index, coin_bit, super_majority: int, packed: bool):
    """(ss, votes0, wvalid, coin_w) of the reference's kernels._fame_setup:
    wide ss and votes0 (R, N, N) bool; packed ss (R, N, W) words and votes0
    already transposed-packed, (R, N_x, W). CPU: the plain version; CUDA:
    K3's setup kernel. The validity and coin gathers are glue."""
    wvalid = wtable >= 0
    coin_w = coin_bit[wtable.clamp(0, coin_bit.shape[0] - 1).long()]
    if wtable.device.type == "cpu":
        ss, votes0 = _fame_setup_plain(wtable, la, fd, index, super_majority, packed)
    else:
        ss, votes0 = _ext.fame_setup(wtable, la, fd, index, super_majority, packed=packed)
    return ss, votes0, wvalid, coin_w


def _fame_setup_plain(wtable, la, fd, index, super_majority: int, packed: bool):
    """(ss, votes0) of kernels._fame_setup, packed as K3p's setup lays
    them out when `packed`."""
    coin = torch.zeros((la.shape[0],), dtype=torch.bool, device=la.device)
    ss, votes0, _, _ = _fame_setup(wtable, la, fd, index, coin, super_majority)
    if packed:
        return pack_bits(ss), pack_votes_t(votes0)
    return ss, votes0


def _pad_last(x: torch.Tensor, dims, size: int, fill=0) -> torch.Tensor:
    """x padded with `fill` along each dim in `dims` up to `size`."""
    for dim in dims:
        extra = size - x.shape[dim]
        if extra > 0:
            shape = list(x.shape)
            shape[dim] = extra
            x = torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=dim)
    return x


def _as_scalar(last_round, dev) -> torch.Tensor:
    if isinstance(last_round, torch.Tensor):
        return last_round.to(device=dev, dtype=torch.int32).reshape(())
    return torch.tensor(int(last_round), dtype=torch.int32, device=dev)


class FameStage(NamedTuple):
    """The global (unsharded) inputs of the rounds-sharded fame loop, as
    _sharded_fame_received stages them: padded, rolled, packed."""

    wtable: torch.Tensor  # (r_pad, N) int32
    ss_s: torch.Tensor  # wide (r_pad, N_y, N_y) bool; packed (r_pad, N_y, W) words
    votes: torch.Tensor  # wide (r_pad, N_y, N) bool; packed (r_pad, N, W) words
    wv_s: torch.Tensor  # (r_pad, N_y) bool
    coin_s: torch.Tensor  # (r_pad, N_y) bool
    wvalid: torch.Tensor  # (r_pad, N) bool
    r_pad: int
    n_pad_v: int


def stage_fame(mesh: DeviceMesh, grid: DagGrid, wtable_np, la, fd, index,
               packed: bool) -> FameStage:
    """The replicated fame setup (K3's setup on the card), then the
    witness padding (lane-aligned per validator shard when packed) and the
    j-alignment roll by -2, on the mesh's device."""
    axis, v_axis = _mesh_axes(mesh)
    ndev_r = int(mesh.shape[axis])
    ndev_v = int(mesh.shape[v_axis]) if v_axis is not None else 1
    dev = mesh.device
    n = grid.n
    r_rows = wtable_np.shape[0]
    r_pad = ((r_rows + ndev_r - 1) // ndev_r) * ndev_r
    n_quant = LANE * ndev_v if packed else ndev_v
    n_pad_v = ((n + n_quant - 1) // n_quant) * n_quant

    wtable = to_device(_pad_axis0(np.asarray(wtable_np, dtype=np.int32), r_pad, -1), dev)
    coin = to_device(np.asarray(grid.coin_bit, dtype=bool), dev)
    ss, votes0, wvalid, coin_w = fame_setup(wtable, la, fd, index, coin, grid.super_majority,
                                            packed)
    # witness padding: padded columns are never strongly seen, so their
    # vote rows tally 0; padded voter rows are invalid and decide nothing
    if packed:
        words = n_pad_v // LANE
        ss_y = _pad_last(_pad_last(ss, (1,), n_pad_v), (2,), words)
        votes = _pad_last(votes0, (2,), words)
    else:
        ss_y = _pad_last(ss, (1, 2), n_pad_v, False)
        votes = _pad_last(votes0, (1,), n_pad_v, False)
    wv_y = _pad_last(wvalid, (1,), n_pad_v, False)
    coin_y = _pad_last(coin_w, (1,), n_pad_v, False)
    # j-aligned buffers start at d0 = 2: a global left-shift by 2
    return FameStage(wtable, torch.roll(ss_y, -2, dims=0), votes,
                     torch.roll(wv_y, -2, dims=0), torch.roll(coin_y, -2, dims=0), wvalid,
                     r_pad, n_pad_v)


def sharded_fame(mesh: DeviceMesh, stage: FameStage, last_round, chunk: int,
                 n_participants: int, super_majority: int, packed: bool,
                 form: Optional[str] = None):
    """The rounds-sharded fame loop on a staged input: shards it, runs the
    loop in place (`form` as _fame_loop takes it), returns (decided,
    famous) (r_pad, N) on the mesh's device."""
    axis, v_axis = _mesh_axes(mesh)
    dev = mesh.device
    r_pad, n = stage.wvalid.shape
    ss_parts = shard(stage.ss_s, mesh, (axis, None, v_axis))
    votes_parts = shard(stage.votes, mesh,
                        (axis, None, v_axis) if packed else (axis, v_axis, None))
    wv_parts = shard(stage.wv_s, mesh, (axis, None))
    coin_parts = shard(stage.coin_s, mesh, (axis, None))
    wvalid_parts = shard(stage.wvalid, mesh, (axis, None))
    zeros = torch.zeros((r_pad, n), dtype=torch.bool, device=dev)
    decided_parts = shard(zeros, mesh, (axis, None))
    famous_parts = shard(zeros, mesh, (axis, None))
    i_rows = shard(torch.arange(r_pad, dtype=torch.int32, device=dev), mesh, (axis,))
    lr_parts = replicate(_as_scalar(last_round, dev), mesh)
    ledger_call("local_fame", _fame_loop, mesh, axis, v_axis, chunk, n_participants,
                super_majority, r_pad + 2, packed, lr_parts, i_rows, wvalid_parts,
                votes_parts, decided_parts, famous_parts, ss_parts, wv_parts, coin_parts,
                form=form)
    return (unshard(decided_parts, mesh, (axis, None)),
            unshard(famous_parts, mesh, (axis, None)))


def sharded_received(mesh: DeviceMesh, index_np, creator_np, rounds_np, fame,
                     form: Optional[str] = None):
    """Pass 3 over the mesh from the decided fame, fame = (wtable, la,
    decided, famous, last_round) on the mesh's device: (B23's replicated
    tables (min_la, famous_count, i_ok, horizon, rounds_decided), round
    received (E,)) on the mesh's device. `form` is _ext.shard_walk_form's
    unless named: "grid", one launch of both over the unsharded event axis
    (every position on one device; on the CPU the plain versions); "step",
    B23's launch, then B22 on each position's padded event shard against
    the replicated tables (positions on distinct cards). Both give the same
    tables and received."""
    if form is None:
        form = _ext.shard_walk_form(mesh.devices)
    e = len(index_np)
    if form == "grid":
        if _ext.shard_walk_form(mesh.devices) != "grid":
            raise ValueError("sharded_received: the one launch needs every position on one "
                             "device")
        ev = [to_device(np.asarray(a, dtype=np.int32), mesh.device)
              for a in (index_np, creator_np, rounds_np)]
        return ledger_call("fame_received", fame_received, *fame, *ev)
    if form != "step":
        raise ValueError(f"sharded_received: no form {form!r}; {_ext.SHARD_WALK_FORMS}")
    tables = ledger_call("_fame_tables", fame_tables, *fame)
    axis, v_axis = _mesh_axes(mesh)
    ev_axes = (v_axis, axis) if v_axis is not None else axis
    e_pad = ((max(e, 1) + mesh.size - 1) // mesh.size) * mesh.size

    def pute(a, fill):
        return shard(_pad_axis0(np.asarray(a, dtype=np.int32), e_pad, fill), mesh, (ev_axes,))

    idx_p, cr_p, rd_p = pute(index_np, 0), pute(creator_np, 0), pute(rounds_np, -1)
    reps = [replicate(t, mesh) for t in tables[:4]]
    received = unshard(
        [ledger_call("local_received", local_received, idx_p[p], cr_p[p], rd_p[p],
                     *(t[p] for t in reps))
         for p in range(mesh.size)],
        mesh, (ev_axes,),
    )
    return tables, received[:e]


def _sharded_fame_received(mesh: DeviceMesh, grid: DagGrid, wtable_np, la, fd, index,
                           rounds_np, last_round, chunk: int, packed=None):
    """Passes 2+3 over the mesh, shared by the three entry points:
    rounds-sharded fame voting with ring-shifted voters (witness-sharded
    too on a 2-D mesh), then round-received (sharded_received). la, fd,
    index are tensors on the mesh's device. Returns host numpy results."""
    pk = resolve_packed(packed, grid.n)
    r_rows = wtable_np.shape[0]
    lr = _as_scalar(last_round, mesh.device)
    stage = stage_fame(mesh, grid, wtable_np, la, fd, index, pk)
    decided, famous = sharded_fame(mesh, stage, lr, chunk, grid.n, grid.super_majority, pk)
    tables, received = sharded_received(mesh, grid.index, grid.creator, rounds_np,
                                        (stage.wtable, la, decided, famous, lr))
    rounds_decided = tables[4]
    return (
        decided.cpu().numpy()[:r_rows],
        famous.cpu().numpy()[:r_rows],
        rounds_decided.cpu().numpy()[:r_rows],
        received.cpu().numpy(),
    )


def sharded_run_passes(mesh: DeviceMesh, grid: DagGrid, chunk: int = 8,
                       packed=None) -> PassResults:
    """The three-pass pipeline over a device mesh; results identical to
    the single-device `engine.run_passes`. Pass 1 (K5) runs replicated,
    once, on the mesh's device."""
    from .engine import stage_scan
    from .kernels import divide_rounds

    pk = resolve_packed(packed, grid.n)
    dev = mesh.device
    (levels, creator, index, sp, op, la, fd, esr, eor, fr, esl, eol, fl,
     _coin) = stage_scan(grid, dev)
    dr = divide_rounds(levels, creator, index, sp, op, la, fd, esr, eor, fr, esl, eol, fl,
                       grid.super_majority, grid.r_max, packed=pk)
    last_round = dr.rounds.max()
    rounds_np = dr.rounds.cpu().numpy()
    decided, famous, rounds_decided, received = _sharded_fame_received(
        mesh, grid, dr.witness_table.cpu().numpy(), la, fd, index, rounds_np,
        last_round, chunk, packed=pk,
    )
    return PassResults(
        rounds=rounds_np,
        witness=dr.witness.cpu().numpy(),
        lamport=dr.lamport.cpu().numpy(),
        witness_table=dr.witness_table.cpu().numpy(),
        fame_decided=decided,
        famous=famous,
        rounds_decided=rounds_decided,
        received=received,
        last_round=int(last_round),
    )


# ---------------------------------------------------------------------------
# B24 local_walk: the chains-sharded frontier walk
# ---------------------------------------------------------------------------


def _joined(parts: List[torch.Tensor]) -> torch.Tensor:
    """Equal-shaped parts back to back along dim 0: a view where they
    already lie so in one buffer, in list order (stage_walk's one-device
    staging), else their concatenation."""
    first = parts[0]
    step = first.numel() * first.element_size()
    if all(t.shape == first.shape and t.is_contiguous()
           and t.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
           and t.data_ptr() == first.data_ptr() + k * step for k, t in enumerate(parts)):
        shape = (first.shape[0] * len(parts),) + tuple(first.shape[1:])
        return torch.as_strided(first, shape, first.stride())
    return torch.cat(parts)


def sharded_build_inv(mesh: DeviceMesh, rb_parts, la_parts,
                      form: Optional[str] = None) -> List[torch.Tensor]:
    """K1 on each position's slice of the chain table: INV (B, N_p, L) per
    position. `form` is _ext.shard_walk_form's unless named: "grid", one
    build_inv over every position's chains (every position on one device;
    a chain's INV depends on its row alone), each part a view of its
    chains; "step", one build_inv a position (positions on distinct
    cards). Both give the same integers."""
    if form is None:
        form = _ext.shard_walk_form(mesh.devices)
    if form == "grid":
        if _ext.shard_walk_form(mesh.devices) != "grid":
            raise ValueError("sharded_build_inv: the one launch needs every position on one "
                             "device")
        b = rb_parts[0].shape[0]
        return list(build_inv(_joined(list(rb_parts)), la_parts[0]).split(b))
    if form != "step":
        raise ValueError(f"sharded_build_inv: no form {form!r}; {_ext.SHARD_WALK_FORMS}")
    return [build_inv(rb_parts[p], la_parts[p]) for p in range(mesh.size)]


def _walk_rows_plain(rows_by, fd, x_cur):
    l = rows_by.shape[1]
    b = rows_by.shape[0]
    rb = rows_by.clamp(min=0)
    w_row = rb[torch.arange(b, device=rows_by.device), x_cur.clamp(0, l - 1).long()]
    w_ok = x_cur < l
    rows = fd[w_row.clamp(0, fd.shape[0] - 1).long()]
    return torch.where(w_ok[:, None], rows, torch.full_like(rows, MAX_INT32)), w_ok


def walk_rows(rows_by, fd, x_cur):
    """B24 (a): (fd_w_local, w_ok); CPU the plain version; CUDA the kernel."""
    if rows_by.device.type == "cpu":
        return _walk_rows_plain(rows_by, fd, x_cur)
    return _ext.shard_walk_rows(rows_by, fd, x_cur)


def _walk_m0_plain(inv, fd_w, w_ok, rows_by, la, super_majority: int, l: int,
                   use_binsearch: bool):
    """The reference's form switch: the per-chain binary search at or above
    M0_BINSEARCH_MIN_N padded chains, the gather + sort form below."""
    if use_binsearch:
        rb = rows_by.clamp(min=0)
        chain_len = (rows_by >= 0).sum(dim=1, dtype=torch.int32)
        return _m0_binsearch(fd_w, w_ok, rb, chain_len, la, super_majority, l)
    return _m0_einsum_sort(fd_w, w_ok, inv, super_majority, l)


def walk_m0(inv, fd_w, w_ok, rows_by, la, super_majority: int, l: int,
            use_binsearch: bool):
    """B24 (b): m0 of the local chains; CPU the plain version; CUDA the
    kernel (one count-based selection, the integers of both forms)."""
    if inv.device.type == "cpu":
        return _walk_m0_plain(inv, fd_w, w_ok, rows_by, la, super_majority, l, use_binsearch)
    return _ext.shard_walk_m0(inv, fd_w, w_ok, super_majority)


def _walk_close_plain(inv, m0_all, m0_local, x_cur, n_p: int, l: int):
    b = inv.shape[0]
    m0 = m0_all[:n_p]
    reach = inv[torch.arange(b, device=inv.device)[:, None],
                torch.arange(n_p, device=inv.device)[None, :],
                m0.clamp(0, l - 1).long()[None, :]]
    reach = torch.where((m0 < l)[None, :], reach, torch.full_like(reach, l))
    x_next = torch.minimum(m0_local, reach.amin(dim=1))
    return torch.clamp(torch.maximum(x_next, x_cur), max=l)


def walk_close(inv, m0_all, c_off: int, x_cur, x_next) -> None:
    """B24 (c), into x_next; CPU the plain version; CUDA the kernel."""
    if inv.device.type == "cpu":
        b, n_p, l = inv.shape
        x_next.copy_(_walk_close_plain(inv, m0_all, m0_all[c_off: c_off + b], x_cur, n_p, l))
    else:
        _ext.shard_walk_close(inv, m0_all, x_cur, x_next, c_off)


def _step_walk(mesh: DeviceMesh, axis, super_majority: int, r_cap: int, l: int,
               inv_parts, rb_parts, fd_parts, la_parts, x0_parts,
               plain: bool) -> List[torch.Tensor]:
    """The walk step by step: each step the local frontier rows, a tiled
    gather of them (and their validity), the local m0, a tiled gather of
    m0, the local closure. plain=False: through the three per-step
    wrappers, all r_cap - 1 steps (the "step" form); plain=True: the plain
    pieces, stopping at the first step that moves no chain and repeating
    its X to the last row (_local_walk_plain)."""
    b = rb_parts[0].shape[0]
    n_p = fd_parts[0].shape[1]
    use_binsearch = b * mesh.size >= M0_BINSEARCH_MIN_N
    c_offs = [axis_index(p, mesh, axis) * b for p in range(mesh.size)]
    hist = []
    for p in range(mesh.size):
        h = torch.empty((r_cap, b), dtype=torch.int32, device=x0_parts[p].device)
        h[0] = x0_parts[p]
        hist.append(h)
    rows_fn, m0_fn = (_walk_rows_plain, _walk_m0_plain) if plain else (walk_rows, walk_m0)
    for r in range(r_cap - 1):
        rows = [rows_fn(rb_parts[p], fd_parts[p], hist[p][r]) for p in range(mesh.size)]
        fd_w = all_gather([x[0] for x in rows], mesh, axis)
        w_ok = all_gather([x[1] for x in rows], mesh, axis)
        m0_local = [m0_fn(inv_parts[p], fd_w[p], w_ok[p], rb_parts[p], la_parts[p],
                          super_majority, l, use_binsearch) for p in range(mesh.size)]
        m0 = all_gather(m0_local, mesh, axis)
        for p in range(mesh.size):
            if plain:
                hist[p][r + 1] = _walk_close_plain(inv_parts[p], m0[p],
                                                   m0[p][c_offs[p]: c_offs[p] + b],
                                                   hist[p][r], n_p, l)
            else:
                walk_close(inv_parts[p], m0[p], c_offs[p], hist[p][r], hist[p][r + 1])
        if plain and all(torch.equal(h[r + 1], h[r]) for h in hist):
            # F depends on X alone: every later row repeats the fixed point
            for h in hist:
                h[r + 2:] = h[r + 1]
            break
    return hist


def _local_walk_plain(mesh: DeviceMesh, axis, super_majority: int, r_cap: int, l: int,
                      inv_parts, rb_parts, fd_parts, la_parts, x0_parts) -> List[torch.Tensor]:
    """The plain version of the whole walk: the plain pieces step by step,
    the gathers as torch.cat, up to the fixed point (the first step that
    moves no chain), whose X fills the remaining rows. Equal row for row to
    the reference's full-length scan."""
    return _step_walk(mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts,
                      la_parts, x0_parts, plain=True)


def walk_grid(mesh: DeviceMesh, axis, super_majority: int, r_cap: int, l: int,
              inv_parts, rb_parts, fd_parts, la_parts, x0_parts) -> List[torch.Tensor]:
    """B24 in one launch, every position on one device: CPU the plain whole
    walk; CUDA the cooperative kernel (positions passed in gather order)."""
    if mesh.device.type == "cpu":
        return _local_walk_plain(mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts,
                                 fd_parts, la_parts, x0_parts)
    if axis_size(mesh, axis) != mesh.size:
        raise ValueError(f"local_walk: the one-launch walk shards chains over every position; "
                         f"{axis!r} spans {axis_size(mesh, axis)} of {mesh.size}")
    order = sorted(range(mesh.size), key=lambda p: axis_index(p, mesh, axis))
    hist = _ext.shard_walk([inv_parts[p] for p in order], [rb_parts[p] for p in order],
                           fd_parts[0], [x0_parts[p] for p in order], super_majority, r_cap)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for k, p in enumerate(order):
        out[p] = hist[k]
    return out


def local_walk(mesh: DeviceMesh, axis, super_majority: int, r_cap: int, l: int,
               inv_parts, rb_parts, fd_parts, la_parts, x0_parts,
               form: Optional[str] = None) -> List[torch.Tensor]:
    """The chains-sharded frontier walk: x_hist (r_cap, B) per position, row
    r the frontier X(r) of its chains. `form` is _ext.shard_walk_form's
    unless named: "grid", the whole walk in one launch (every position on
    one device; on the CPU the plain whole walk), or "step", three
    launches per step per position with two tiled gathers between them
    (positions on distinct cards). Both give the same history."""
    if form is None:
        form = _ext.shard_walk_form(mesh.devices)
    if form == "grid":
        if _ext.shard_walk_form(mesh.devices) != "grid":
            raise ValueError("local_walk: the one-launch walk needs every position on one "
                             "device")
        return walk_grid(mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts,
                         la_parts, x0_parts)
    if form != "step":
        raise ValueError(f"local_walk: no form {form!r}; {_ext.SHARD_WALK_FORMS}")
    return _step_walk(mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts,
                      la_parts, x0_parts, plain=False)


class WalkStage(NamedTuple):
    """The frontier walk's inputs on a mesh, as sharded_frontier_passes
    stages them: the chain table padded to n_pad chains of l_b indices
    (host), each position's INV slice (K1 on its chains), chain table and
    X(0), fd and la replicated; r_cap is the provable cap l_b + 2."""
    axis: object
    super_majority: int
    r_cap: int
    l: int
    rb_pad: np.ndarray
    inv_parts: List[torch.Tensor]
    rb_parts: List[torch.Tensor]
    fd_parts: List[torch.Tensor]
    la_parts: List[torch.Tensor]
    x0_parts: List[torch.Tensor]

    def walk(self, mesh: DeviceMesh, form: Optional[str] = None) -> List[torch.Tensor]:
        return local_walk(mesh, self.axis, self.super_majority, self.r_cap, self.l,
                          self.inv_parts, self.rb_parts, self.fd_parts, self.la_parts,
                          self.x0_parts, form=form)


def stage_walk(mesh: DeviceMesh, grid: DagGrid, grid_p: Optional[DagGrid] = None) -> WalkStage:
    """Pass 1a of sharded_frontier_passes: the walk's inputs on the mesh
    (`grid_p`: the grid padded by engine.pad_grid, made here if not given)."""
    from .engine import _bucket, pad_grid
    from .frontier import chain_table

    r_axis, v_axis = _mesh_axes(mesh)
    axis = (v_axis, r_axis) if v_axis is not None else r_axis
    if grid_p is None:
        grid_p = pad_grid(grid)
    rows_by = chain_table(grid)
    l_b = _bucket(rows_by.shape[1], 64, factor=2)
    n_pad = ((grid.n + mesh.size - 1) // mesh.size) * mesh.size
    rb_pad = np.full((n_pad, l_b), -1, dtype=np.int32)
    rb_pad[: grid.n, : rows_by.shape[1]] = rows_by
    la = to_device(grid_p.last_ancestors, mesh.device)
    fd = to_device(grid_p.first_descendants, mesh.device)
    if _ext.shard_walk_form(mesh.devices) == "grid":
        # one device: the table staged once, each position's chains a view
        # of it (K1 builds every position's INV from it in one launch)
        rb_all = to_device(rb_pad, mesh.device)
        b = n_pad // mesh.size
        rb_parts = [rb_all[k * b: (k + 1) * b]
                    for k in (axis_index(p, mesh, axis) for p in range(mesh.size))]
    else:
        rb_parts = shard(rb_pad, mesh, (axis, None))
    la_parts, fd_parts = replicate(la, mesh), replicate(fd, mesh)
    inv_parts = sharded_build_inv(mesh, rb_parts, la_parts)
    x0_parts = shard(np.where(rb_pad[:, 0] >= 0, 0, l_b).astype(np.int32), mesh, (axis,))
    # l_b + 2 is the provable cap: a round advance moves every chain's
    # frontier index by >= 1, so last_round < L <= l_b
    return WalkStage(axis, grid.super_majority, l_b + 2, l_b, rb_pad, inv_parts, rb_parts,
                     fd_parts, la_parts, x0_parts)


def post(x_hist, rows_by, creator, index, sp_index):
    """The walk's post pass on the gathered history (rounds, witness,
    wtable, last_round): CPU the plain frontier_post; CUDA K2's post
    kernels on their own."""
    if x_hist.device.type == "cpu":
        return tuple(frontier_post(x_hist, rows_by, creator, index, sp_index))
    return _ext.frontier_post(x_hist, rows_by, creator, index, sp_index)


def sharded_frontier_passes(mesh: DeviceMesh, grid: DagGrid, chunk: int = 8,
                            r_cap: Optional[int] = None, packed=None) -> PassResults:
    """The round-frontier pipeline over a device mesh: INV and the chain
    table sharded over chains, fame rounds-sharded, received
    events-sharded. Results identical to engine.run_frontier_passes.
    Requires a frontier-safe (base-state) grid."""
    from .engine import pad_grid
    from .frontier import level_lamport, sp_index_of

    dev = mesh.device
    e_real = grid.e
    sp_index = sp_index_of(grid)
    lamport = level_lamport(grid)
    grid_p = pad_grid(grid)
    pad_e = grid_p.creator.shape[0] - e_real
    # index -1 keeps padded rows below every frontier value
    index_np = np.concatenate([grid.index, np.full(pad_e, -1, np.int32)])
    sp_index = np.concatenate([sp_index, np.full(pad_e, -1, np.int32)])
    lamport = np.concatenate([lamport, np.full(pad_e, -1, np.int32)])

    # pass 1a: INV, chains-sharded
    stage = stage_walk(mesh, grid, grid_p)
    r_hard = stage.r_cap
    if r_cap is None:
        r_cap = r_hard
    la, fd = stage.la_parts[0], stage.fd_parts[0]
    index = to_device(index_np, dev)
    rb_dev = to_device(stage.rb_pad, dev)
    creator = to_device(grid_p.creator, dev)
    sp_d = to_device(sp_index, dev)
    # pass 1b: the walk, chains-sharded
    while True:
        hist = ledger_call("local_walk", local_walk, mesh, stage.axis, stage.super_majority,
                           r_cap, stage.l, stage.inv_parts, stage.rb_parts, stage.fd_parts,
                           stage.la_parts, stage.x0_parts)
        # pass 1c: witness table + per-event rounds on the gathered history
        x_hist = unshard(hist, mesh, (None, stage.axis))
        rounds, witness, wtable, last_round = post(x_hist, rb_dev, creator, index, sp_d)
        # an undersized r_cap truncates the walk: re-run at the provable cap
        if int(last_round) + 2 <= r_cap or r_cap >= r_hard:
            break
        r_cap = r_hard
    wtable_np = wtable.cpu().numpy()[:, : grid.n]

    # passes 2+3; the rounds of the padded walk are cut back to real events
    rounds_np = rounds.cpu().numpy()[:e_real]
    decided, famous, rounds_decided, received = _sharded_fame_received(
        mesh, grid, wtable_np, la, fd, index, rounds_np, last_round, chunk, packed=packed,
    )
    return PassResults(
        rounds=rounds_np,
        witness=witness.cpu().numpy()[:e_real],
        lamport=lamport[:e_real],
        witness_table=wtable_np,
        fame_decided=decided,
        famous=famous,
        rounds_decided=rounds_decided,
        received=received,
        last_round=int(last_round),
    )


# ---------------------------------------------------------------------------
# the log-diameter cold path, mesh variant
# ---------------------------------------------------------------------------


def sharded_doubling_passes(mesh: DeviceMesh, grid: DagGrid, chunk: int = 8, stats=None,
                            packed=None) -> PassResults:
    """Cold-path pipeline: pass 1 (the closure, the contracted walk, K6-K8)
    on the mesh's device, passes 2+3 on the shared rounds-/events-sharded
    stages. Results identical to `doubling.run_doubling_passes`."""
    from .doubling import _doubling_stage1

    dev = mesh.device
    st = stats if stats is not None else {}
    (grid_rb, offset, rounds_np, witness_np, lamport_np, wtable_np,
     last_round) = _doubling_stage1(grid, dev, st)
    st["passes"] = st.get("closure_passes", 0) + st.get("walk_chunks", 0) + 1

    la = to_device(grid.last_ancestors, dev)
    fd = to_device(grid.first_descendants, dev)
    index = to_device(grid.index, dev)
    decided, famous, rounds_decided, received = _sharded_fame_received(
        mesh, grid, wtable_np, la, fd, index, rounds_np, last_round, chunk, packed=packed,
    )

    rounds = rounds_np
    received = received.astype(np.int32)
    if offset:
        rounds = np.where(rounds >= 0, rounds + offset, rounds)
        received = np.where(received >= 0, received + offset, received)
    return PassResults(
        rounds=rounds.astype(np.int32),
        witness=witness_np,
        lamport=lamport_np,
        witness_table=wtable_np,
        fame_decided=decided,
        famous=famous,
        rounds_decided=rounds_decided,
        received=received,
        last_round=last_round + offset,
        round_offset=offset,
    )
