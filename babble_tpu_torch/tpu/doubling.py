"""Log-diameter cold path of the PyTorch port: pointer-doubling ancestry
closure + contracted frontier walk for deep DAG sections.

Counterpart of babble_tpu/tpu/doubling.py. A section that arrives
thousands of rounds deep (recovery, fast-sync replay, cold batch ingest)
is replayed in O(log depth) device passes instead of one step per level
(the level scan) or one step per round over the whole chain axis:

1. `_closure_la` closes lastAncestors from the parent tables by repeated
   squaring: each pass takes a prefix max down every self-chain, then
   every event jumps to its latest ancestor on each chain and absorbs
   that event's vector. The result is checked against the staged
   coordinates; a section that is not ancestry-closed raises
   GridUnsupported.
2. `_walk_chunk` runs the round-frontier recurrence in chunks of 16, 32,
   ... steps (one launch each). The strongly-seeing binary search starts
   at the current frontier, and the cross-chain closure reads INV
   directly.
3. Seeded (post-reset) sections enter the walk through a per-round seed
   table and the first_nw mask; their lamports come from
   `_lamport_levels_scan`, the lamport slice of the level scan.

Fame and round-received reuse decide_fame / decide_round_received over the
host-assembled witness table, the fame vote in the voting-table layout the
knob resolves (tpu/packed.py). Each kernel wrapper runs its plain PyTorch
version on a CPU tensor and launches its hand-written kernel
(babble_tpu_torch/csrc/closure_la.cu, walk_chunk.cu, lamport_scan.cu) on a
CUDA tensor. Host staging is numpy, copied from the reference.

`maybe_cold_replay` is the live engine's bootstrap hook: a deep or
post-reset hashgraph is settled through this path and stamped into the
store before the frontier attach; `observe_catchup` is the telemetry the
one-shot ladder and the hook share.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import _ext
from .device import resolve_device, to_device
from .engine import (
    PassResults,
    _bucket,
    _frontier_safe,
    pad_grid,
    rebase_rounds,
)
from .frontier import build_inv, level_lamport
from .grid import MAX_INT32, MIN_INT32, DagGrid, GridUnsupported
from .kernels import decide_fame, decide_round_received, last_level
from .packed import resolve_packed

# ---------------------------------------------------------------------------
# crossover selection (engine ladder)
# ---------------------------------------------------------------------------

# depth (topological levels) above which the cold path is taken: the
# reference's defaults; BABBLE_DOUBLING_CROSSOVER overrides with a number
# (both paths) or "auto" (one-shot timing probe on this package's device)
_CROSSOVER_BASE = 1024
_CROSSOVER_SEEDED = 192
# a batched multi-round train pays one dispatch for the whole train, so
# the cold path wins earlier there
_CROSSOVER_BATCHED = 64

_calibrated: Optional[tuple] = None


def calibrate_crossover() -> tuple:
    """One-shot probe: time the frontier walk against the doubling path on
    a small deep synthetic grid and place the base crossover on the
    winning side; the seeded crossover scales down from it. Cached for the
    process; never run unless BABBLE_DOUBLING_CROSSOVER=auto."""
    from .engine import run_frontier_passes
    from .grid import synthetic_deep_grid

    g = synthetic_deep_grid(8, 512, seed=0, zipf_a=1.2)

    def timed(fn):
        fn(g)  # the first call builds the kernels
        t0 = time.perf_counter()
        fn(g)
        return time.perf_counter() - t0

    t_fr = timed(run_frontier_passes)
    t_dbl = timed(run_doubling_passes)
    base = 512 if t_dbl < t_fr else 2048
    base = min(max(base, 128), 4096)
    seeded = min(max(base // 4, 64), 1024)
    return base, seeded


def doubling_crossover(seeded: bool) -> int:
    """Depth threshold for routing a grid onto the doubling cold path."""
    global _calibrated
    env = os.environ.get("BABBLE_DOUBLING_CROSSOVER", "").strip()
    if env and env != "auto":
        try:
            return max(int(env), 1)
        except ValueError:
            pass
    if env == "auto":
        if _calibrated is None:
            _calibrated = calibrate_crossover()
        return _calibrated[1] if seeded else _calibrated[0]
    return _CROSSOVER_SEEDED if seeded else _CROSSOVER_BASE


def use_doubling(grid: DagGrid, prefer: bool = False) -> bool:
    """Ladder predicate: deep enough that log-diameter passes win.
    `prefer` (a batched multi-round train) lowers the crossover."""
    if grid.e == 0:
        return False
    cross = doubling_crossover(not _frontier_safe(grid))
    if prefer:
        cross = min(cross, _CROSSOVER_BATCHED)
    return grid.num_levels >= cross


# ---------------------------------------------------------------------------
# pass 1a: pointer-doubling lastAncestors closure
# ---------------------------------------------------------------------------


def _closure_init(creator, index, sp, op, n: int):
    """la0: the own coordinate plus both parents' own coordinates."""
    e = creator.shape[0]
    cols = torch.arange(n, device=creator.device)[None, :]
    la0 = torch.where(
        (cols == creator[:, None]) & (index[:, None] >= 0), index[:, None], -1,
    ).to(torch.int32)
    for parent in (sp, op):
        prow = parent.clamp(0, e - 1).long()
        hit = (parent >= 0)[:, None] & (cols == creator[prow][:, None])
        la0 = torch.maximum(la0, torch.where(hit, index[prow][:, None], -1))
    return la0


def _closure_la_plain(creator, index, sp, op, rows_by, l: int, block: int,
                      pass_cap: int):
    """The reference's while loop: each pass squares the chain-prefixed
    iterate into a new buffer (every row reads the previous iterate) and
    compares the result with the iterate before the prefix."""
    e = creator.shape[0]
    n = rows_by.shape[0]
    rb = rows_by.clamp(min=0).long()
    cols = torch.arange(n, device=rows_by.device)[None, :]
    on_chain = (index >= 0)[:, None]
    chain_c = creator.clamp(0, n - 1).long()
    chain_i = index.clamp(0, l - 1).long()

    def chain_prefix(la):
        lat = torch.where((rows_by >= 0)[:, :, None], la[rb], -1)  # (N, l, N)
        lat = torch.cummax(lat, dim=1).values
        return torch.where(on_chain, lat[chain_c, chain_i], la)

    def square(la):
        out = torch.empty_like(la)
        for b0 in range(0, e, block):
            la_blk = la[b0:b0 + block]
            tgt = rb[cols, la_blk.clamp(0, l - 1).long()]  # (block, N) rows
            contrib = torch.where((la_blk >= 0)[:, :, None], la[tgt], -1)
            out[b0:b0 + block] = torch.maximum(la_blk, contrib.amax(dim=1))
        return out

    la = _closure_init(creator, index, sp, op, n)
    passes, changed = 0, True
    while changed and passes < pass_cap:
        la2 = square(chain_prefix(la))
        changed = bool((la2 != la).any())
        la, passes = la2, passes + 1
    return la, passes


def _closure_la(creator, index, sp, op, rows_by, l: int, block: int,
                pass_cap: int):
    """lastAncestors (E, N) int32 closed from the parent tables by repeated
    squaring, and the pass count (int). All coordinates are per-chain
    indexes (rebased for sections); padded rows carry index -1 and stay
    inert. CPU: the plain version; CUDA: the kernel (block, which bounds
    the plain version's (block, N, N) transient, is not needed there)."""
    if rows_by.device.type == "cpu":
        return _closure_la_plain(creator, index, sp, op, rows_by, l, block, pass_cap)
    return _ext.closure_la(creator, index, sp, op, rows_by, l, pass_cap)


# ---------------------------------------------------------------------------
# pass 1b: contracted frontier walk
# ---------------------------------------------------------------------------


def _m0_binsearch_from(fd_w, w_ok, rb, chain_len, la, lo0,
                       super_majority: int, l: int, steps: int):
    """The per-chain binary search for the first index strongly seeing a
    supermajority of the frontier rows, started at lo0 (the answer never
    lies below the current frontier) and run for exactly `steps` probes."""
    n = rb.shape[0]
    cc = torch.arange(n, device=rb.device)
    last = (chain_len - 1).clamp(min=0)
    lo = lo0.clamp(0, l)
    hi = torch.full((n,), l, dtype=torch.int32, device=rb.device)
    for _ in range(steps):
        mid = torch.clamp((lo + hi) // 2, max=l - 1)
        probe = torch.minimum(mid, last)
        la_mid = la[rb[cc, probe.long()].long()]  # (N_c, N_p)
        cnt_p = (la_mid[:, None, :] >= fd_w[None, :, :]).sum(dim=-1, dtype=torch.int32)
        sees = (cnt_p >= super_majority) & w_ok[None, :]
        pred = (sees.sum(dim=1, dtype=torch.int32) >= super_majority) & (chain_len > 0)
        hi = torch.where(pred, torch.minimum(mid, hi), hi)
        lo = torch.where(pred, lo, mid + 1)
    return torch.where(hi < chain_len, hi, torch.full_like(hi, l))


def _walk_chunk_plain(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
                      super_majority: int, l: int, length: int, steps: int,
                      use_seeds: bool):
    n = rows_by.shape[0]
    rb = rows_by.clamp(min=0)
    cc = torch.arange(n, device=rows_by.device)
    chain_len = (rows_by >= 0).sum(dim=1, dtype=torch.int32)
    x_cur = x0
    xs = []
    for k in range(length):
        w_ok = x_cur < l
        if use_seeds:
            w_ok = w_ok & ~((x_cur == 0) & (r_abs[k] == first_nw))
        w_row = rb[cc, x_cur.clamp(0, l - 1).long()].long()
        fd_w = torch.where(w_ok[:, None], fd[w_row], MAX_INT32)
        m0 = _m0_binsearch_from(
            fd_w, w_ok, rb, chain_len, la, x_cur, super_majority, l, steps,
        )
        # cross-chain closure: reach[c, x] = INV[c, x, m0[x]]
        reach = inv[:, cc, m0.clamp(0, l - 1).long()]
        reach = torch.where((m0 < l)[None, :], reach, l)
        x_next = torch.minimum(m0, reach.amin(dim=1))
        if use_seeds:
            x_next = torch.minimum(x_next, seeds[k])
        x_cur = torch.clamp(torch.maximum(x_next, x_cur), max=l)
        xs.append(x_cur)
    return x_cur, torch.stack(xs)


def _walk_chunk(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
                super_majority: int, l: int, length: int, steps: int,
                use_seeds: bool):
    """`length` frontier transitions from x0; returns (X(r+length),
    X(r+1)..X(r+length)). seeds (length, N) is the per-round seed row and
    r_abs (length,) the round of each step; first_nw masks a chain-first
    section row that is a frontier row but not a witness. CPU: the plain
    version; CUDA: the kernel."""
    args = (inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
            super_majority, l, length, steps, use_seeds)
    if rows_by.device.type == "cpu":
        return _walk_chunk_plain(*args)
    return _ext.walk_chunk(*args)


_WALK_CHUNK0 = 16
_WALK_CHUNK_MAX = 4096


def _doubling_walk(put, inv, rows_by_d, fd_d, la_d, x0, s_np, first_nw,
                   super_majority: int, l: int, use_seeds: bool,
                   stats: dict, walk=_walk_chunk) -> np.ndarray:
    """Host driver: geometric chunk growth keeps the launch count
    logarithmic in the round count; the walk stops once the frontier is
    saturated, or stalled with no seed rounds left. One readback per
    chunk. Returns the (R+1, N) frontier history X(0..R). `walk` is the
    chunk function (the dispatching wrapper unless a caller swaps it)."""
    n = x0.shape[0]
    r_seed_max = s_np.shape[0] - 1 if use_seeds else -1
    first_nw_d = put(first_nw)
    x_cur = x0
    rows = [x0[None, :]]
    r_done = 0
    chunk = _WALK_CHUNK0
    chunks = 0
    full_steps = max(1, (l - 1).bit_length()) + 1
    # every non-stalled round advances some chain, and stalls only happen
    # under pending seed rounds
    cap = l + max(r_seed_max, 0) + 8
    while True:
        seg = np.full((chunk, n), l, dtype=np.int32)
        if use_seeds:
            lo_r = r_done + 1
            hi_r = min(lo_r + chunk, s_np.shape[0])
            if hi_r > lo_r:
                seg[: hi_r - lo_r] = s_np[lo_r:hi_r]
        # contraction: probe count from the widest un-settled interval,
        # in multiples of 4
        rem = max(l - int(x_cur.min()), 1)
        steps = min(-(-(rem.bit_length() + 1) // 4) * 4, full_steps)
        r_vec = (r_done + np.arange(chunk)).astype(np.int32)
        x_last_d, xs_d = walk(
            inv, rows_by_d, fd_d, la_d, put(x_cur), put(seg), put(r_vec),
            first_nw_d, super_majority, l, chunk, steps, use_seeds,
        )
        xs = xs_d.cpu().numpy()
        x_last = x_last_d.cpu().numpy()
        rows.append(xs)
        chunks += 1
        r_done += chunk
        stalled = bool((x_last == x_cur).all())
        x_cur = x_last
        if bool((x_last >= l).all()):
            break
        if stalled and r_done > r_seed_max:
            break
        if r_done > cap:
            raise GridUnsupported("doubling walk failed to converge")
        chunk = min(chunk * 2, _WALK_CHUNK_MAX)
    stats["walk_chunks"] = chunks
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------------
# passes 2+3: the existing fame/received kernels
# ---------------------------------------------------------------------------


def _fame_received(wtable, la, fd, index, creator, coin, rounds, last_round,
                   super_majority: int, n_participants: int, d_cap: int,
                   packed: bool = False):
    """DecideFame (in the layout `packed` names) then DecideRoundReceived
    over a host-assembled witness table: (decided, famous, rounds_decided,
    received)."""
    fame = decide_fame(
        wtable, la, fd, index, coin, last_round,
        super_majority, n_participants, d_cap, packed=packed,
    )
    received = decide_round_received(
        wtable, la, index, creator, rounds,
        fame.decided, fame.famous, fame.rounds_decided, last_round,
    )
    return fame.decided, fame.famous, fame.rounds_decided, received


# ---------------------------------------------------------------------------
# seeded lamports
# ---------------------------------------------------------------------------


def _lamport_levels_scan_plain(levels, sp, op, esp, eop, fpin):
    """The lamport slice of the level scan, from 0 (not -1): each level
    reads the carry in full before it writes; padding lanes write a sink
    slot past the end."""
    e = sp.shape[0]
    lam = torch.zeros((e + 1,), dtype=torch.int32, device=sp.device)

    def parent(ptr, ext, rows):
        return torch.where(ptr >= 0, lam[ptr.clamp(0, e - 1).long()], ext[rows])

    for lv in range(last_level(levels) + 1):
        level_rows = levels[lv]
        rows = level_rows.clamp(0, e - 1).long()
        v = torch.maximum(parent(sp[rows], esp, rows), parent(op[rows], eop, rows)) + 1
        pin = fpin[rows]
        v = torch.where(pin != MIN_INT32, pin, v)
        lam[torch.where(level_rows >= 0, rows, e)] = v
    return lam[:e]


def _lamport_levels_scan(levels, sp, op, esp, eop, fpin):
    """(E,) lamport timestamps by the level scan's recurrence with external
    parent lamports and pinned overrides. CPU: the plain version; CUDA:
    the kernel."""
    if sp.device.type == "cpu":
        return _lamport_levels_scan_plain(levels, sp, op, esp, eop, fpin)
    return _ext.lamport_scan(levels, sp, op, esp, eop, fpin)


def lamport_inputs(grid: DagGrid, device: torch.device):
    """_lamport_levels_scan's inputs as seeded_lamport stages them: the
    level axis bucketed by 64 * 2^k and the event axis by 256 * 4^k."""
    lev_b = _bucket(grid.num_levels, 64, factor=2)
    levels = np.full((lev_b, grid.levels.shape[1]), -1, dtype=np.int32)
    levels[: grid.num_levels] = grid.levels[: grid.num_levels]
    pad_e = _bucket(grid.e, 256) - grid.e
    put = functools.partial(to_device, device=device)
    return (
        put(levels),
        put(_pad1(grid.self_parent, pad_e, -1)),
        put(_pad1(grid.other_parent, pad_e, -1)),
        put(_pad1(grid.ext_sp_lamport, pad_e, -1)),
        put(_pad1(grid.ext_op_lamport, pad_e, MIN_INT32)),
        put(_pad1(grid.fixed_lamport, pad_e, MIN_INT32)),
    )


def seeded_lamport(grid: DagGrid,
                   device: Optional[Union[str, torch.device]] = None) -> np.ndarray:
    """(E,) lamport timestamps replicating the level scan's recurrence on
    seeded grids (external parent lamports + pinned overrides), as one
    device scan over the level table; on the card by default."""
    lam = _lamport_levels_scan(*lamport_inputs(grid, resolve_device(device)))
    return lam.cpu().numpy()[: grid.e]


# ---------------------------------------------------------------------------
# host staging (numpy, as in the reference)
# ---------------------------------------------------------------------------


def _seed_table(creator, idx_rb, la_rb, oseed, chain_len, n: int, l: int):
    """S[r, c] = first chain-c (rebased) index whose ancestry certifies
    round >= r, from the per-event origin seeds (fixed/external rounds)."""
    m = np.full((n, l), -1, dtype=np.int64)
    m[creator, idx_rb] = oseed
    np.maximum.accumulate(m, axis=1, out=m)
    lap = np.clip(la_rb, 0, l - 1)
    contrib = m[np.arange(n)[None, :], lap]  # (E, N)
    contrib = np.where(la_rb >= 0, contrib, -1)
    aseed = np.maximum(oseed, contrib.max(axis=1, initial=-1))

    r_seed_max = int(aseed.max(initial=-1))
    if r_seed_max < 0:
        return np.full((1, n), l, dtype=np.int32)
    a = np.full((n, l), np.iinfo(np.int64).max, dtype=np.int64)
    a[creator, idx_rb] = aseed
    s = np.full((r_seed_max + 2, n), l, dtype=np.int32)
    rr = np.arange(r_seed_max + 2)
    for c in range(n):
        ln = int(chain_len[c])
        if ln == 0:
            continue
        pos = np.searchsorted(a[c, :ln], rr, side="left")
        s[:, c] = np.where(pos < ln, pos, l).astype(np.int32)
    return s


def _chain_layout(grid: DagGrid):
    """Per-chain index rebasing + structural guards. Returns
    (chain_min, idx_rb, chain_len); raises GridUnsupported on forks,
    duplicate coordinates or non-contiguous chains."""
    n, e = grid.n, grid.e
    creator = grid.creator
    index = grid.index.astype(np.int64)
    chain_min = np.full(n, MAX_INT32, dtype=np.int64)
    np.minimum.at(chain_min, creator, index)
    chain_max = np.full(n, -1, dtype=np.int64)
    np.maximum.at(chain_max, creator, index)
    counts = np.bincount(creator, minlength=n)
    nonempty = counts > 0
    chain_min[~nonempty] = 0
    if not bool(
        (chain_max[nonempty] - chain_min[nonempty] + 1
         == counts[nonempty]).all()
    ):
        raise GridUnsupported("doubling: non-contiguous chain indexes")
    pairs = creator.astype(np.int64) * (int(index.max(initial=0)) + 2) + index
    if np.unique(pairs).size != e:
        raise GridUnsupported("doubling: duplicate (creator, index) rows")
    idx_rb = (index - chain_min[creator]).astype(np.int32)
    return chain_min, idx_rb, counts.astype(np.int32)


def _pad1(a: np.ndarray, pad: int, fill) -> np.ndarray:
    if pad == 0:
        return a
    return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])


class DoublingInputs(NamedTuple):
    """A grid staged for the cold path: host arrays and device tensors."""

    grid_rb: DagGrid  # round axis rebased
    offset: int
    seeded: bool
    idx_rb: np.ndarray  # (E,) per-chain rebased index
    chain_len: np.ndarray  # (N,)
    la_rb: np.ndarray  # (E, N) rebased lastAncestors, -1 below the section
    rows_by: np.ndarray  # (N, l_b) event rows, -1 padded
    l_b: int
    block: int
    pass_cap: int
    rows_by_d: torch.Tensor
    la_d: torch.Tensor  # (E_b, N) rebased, -1 padded
    fd_d: torch.Tensor  # (E_b, N) rebased, MAX padded
    creator_d: torch.Tensor  # (E_b,)
    idx_d: torch.Tensor  # (E_b,) rebased, -1 padded
    sp_d: torch.Tensor  # (E_b,)
    op_d: torch.Tensor  # (E_b,)


def stage_doubling(grid: DagGrid, device: torch.device) -> DoublingInputs:
    """Rebase the round axis and every per-chain coordinate, check the
    section's structure (GridUnsupported otherwise), bucket the chain and
    event axes and copy the closure's and the walk's inputs to device."""
    if grid.e == 0:
        raise GridUnsupported("doubling: empty grid")
    e_real, n = grid.e, grid.n
    grid_rb, offset = rebase_rounds(grid)
    seeded = not _frontier_safe(grid)

    chain_min, idx_rb, chain_len = _chain_layout(grid)
    # the walk starts at round 0: every chain-first event must carry a
    # round anchor (genesis pin or external-parent metadata)
    first_rows = grid.index.astype(np.int64) == chain_min[grid.creator]
    anchored = (
        (grid_rb.fixed_round >= 0)
        | (grid_rb.ext_sp_round >= 0)
        | (grid_rb.ext_op_round >= 0)
    )
    if not bool(anchored[first_rows].all()):
        raise GridUnsupported("doubling: unanchored chain-first event")

    # rebase every per-chain coordinate into section-local space; an
    # ancestor below the section floor has no in-section coordinate (-1)
    la64 = grid.last_ancestors.astype(np.int64) - chain_min[None, :]
    la_rb = np.where(grid.last_ancestors >= 0, la64, -1)
    la_rb = np.where(la_rb >= 0, la_rb, -1).astype(np.int32)
    fd64 = grid.first_descendants.astype(np.int64) - chain_min[None, :]
    fd_rb = np.where(grid.first_descendants == MAX_INT32, MAX_INT32, fd64)
    if bool((fd_rb < 0).any()):
        raise GridUnsupported("doubling: first descendant below section")
    fd_rb = fd_rb.astype(np.int32)

    l_real = int(idx_rb.max(initial=0)) + 1
    l_b = _bucket(l_real, 64, factor=2)
    rows_by = np.full((n, l_b), -1, dtype=np.int32)
    rows_by[grid.creator, idx_rb] = np.arange(e_real, dtype=np.int32)

    e_b = _bucket(e_real, 256)
    pad_e = e_b - e_real
    la_p = np.concatenate([la_rb, np.full((pad_e, n), -1, dtype=np.int32)])
    fd_p = np.concatenate([fd_rb, np.full((pad_e, n), MAX_INT32, dtype=np.int32)])

    # the reference's closure block (it bounds a (block, N, N) transient;
    # the plain version chunks by it) and its pass cap
    block = min(e_b, max(256, min(2048, (1 << 24) // max(n * n, 1))))
    block = 1 << (block.bit_length() - 1)
    pass_cap = max(l_b.bit_length(), 1) + 4
    put = functools.partial(to_device, device=device)
    return DoublingInputs(
        grid_rb=grid_rb, offset=offset, seeded=seeded, idx_rb=idx_rb,
        chain_len=chain_len, la_rb=la_rb, rows_by=rows_by, l_b=l_b,
        block=block, pass_cap=pass_cap,
        rows_by_d=put(rows_by), la_d=put(la_p), fd_d=put(fd_p),
        creator_d=put(_pad1(grid.creator, pad_e, 0)),
        idx_d=put(_pad1(idx_rb, pad_e, -1)),
        sp_d=put(_pad1(grid.self_parent, pad_e, -1)),
        op_d=put(_pad1(grid.other_parent, pad_e, -1)),
    )


def walk_seeds(grid: DagGrid, st: DoublingInputs):
    """(seed table S (R_s, N), first_nw (N,), X(0) (N,)) for the walk."""
    n, l_b = grid.n, st.l_b
    first_nw = np.full(n, -1, dtype=np.int32)
    if st.seeded:
        g = st.grid_rb
        oseed = np.maximum.reduce([
            g.fixed_round.astype(np.int64),
            g.ext_sp_round.astype(np.int64),
            g.ext_op_round.astype(np.int64),
        ])
        s_np = _seed_table(
            grid.creator, st.idx_rb, st.la_rb, oseed, st.chain_len, n, l_b,
        )
        # a chain-first row is a non-witness frontier row at a pinned
        # round <= its external self-parent round, or exactly at that
        # round when unpinned
        fr = st.rows_by[:, 0]
        ne = fr >= 0
        fx = g.fixed_round[fr[ne]]
        es = g.ext_sp_round[fr[ne]]
        first_nw[ne] = np.where(fx >= 0, np.where(fx <= es, fx, -1), es)
    else:
        s_np = np.full((1, n), l_b, dtype=np.int32)
    x0 = np.where(st.rows_by[:, 0] >= 0, 0, l_b).astype(np.int32)
    return s_np, first_nw, x0


def _doubling_stage1(grid: DagGrid, device: torch.device, stats: dict):
    """Pass 1 of the cold path: closure, contracted walk, witness and
    round assembly. Returns (grid_rb, offset, rounds_np, witness_np,
    lamport_np, wtable_np, last_round): rounds and last_round on the
    rebased round axis, wtable rows indexed by round - offset."""
    st = stage_doubling(grid, device)
    e_real, n = grid.e, grid.n
    grid_rb = st.grid_rb

    la_closed, closure_passes = _closure_la(
        st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d,
        st.l_b, st.block, st.pass_cap,
    )
    stats["closure_passes"] = closure_passes
    if not bool((la_closed.cpu().numpy()[:e_real] == st.la_rb).all()):
        # staged coordinates disagree with in-section reachability: the
        # section is not ancestry-closed (or the store is corrupt)
        raise GridUnsupported("doubling: closure/staged ancestor mismatch")

    inv = build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = walk_seeds(grid, st)
    x_hist = _doubling_walk(
        functools.partial(to_device, device=device), inv, st.rows_by_d, st.fd_d, st.la_d, x0, s_np, first_nw,
        grid.super_majority, st.l_b, st.seeded, stats,
    )

    # rounds from the frontier history: X(:, c) is non-decreasing, so
    # round(e) = |{r : idx(e) >= X(r)[c]}| - 1 is one searchsorted per chain
    rounds_np = np.full(e_real, -1, dtype=np.int32)
    for c in range(n):
        ch = st.rows_by[c, : st.chain_len[c]]
        if ch.size == 0:
            continue
        rounds_np[ch] = (
            np.searchsorted(x_hist[:, c], st.idx_rb[ch], side="right") - 1
        )
    rounds_np = np.where(
        grid_rb.fixed_round[:e_real] >= 0, grid_rb.fixed_round[:e_real],
        rounds_np,
    ).astype(np.int32)
    if bool((rounds_np < 0).any()):
        raise GridUnsupported("doubling: walk left events unrounded")

    # the scan's witness rule, verbatim: round(e) > round(self-parent)
    sp = grid.self_parent
    sp_round = np.where(
        sp >= 0, rounds_np[np.maximum(sp, 0)], grid_rb.ext_sp_round[:e_real]
    )
    witness_np = rounds_np > sp_round

    last_round = int(rounds_np.max(initial=0))
    r_rows = _bucket(last_round + 4, 64, factor=2)
    w = np.nonzero(witness_np)[0]
    wtable_np = np.full((r_rows, n), -1, dtype=np.int32)
    wtable_np[rounds_np[w], grid.creator[w]] = w.astype(np.int32)
    if int((wtable_np >= 0).sum()) != w.size:
        raise GridUnsupported("doubling: colliding witness coordinates")

    lamport_np = (
        seeded_lamport(grid, device) if st.seeded else level_lamport(grid)
    )
    stats["depth"] = int(grid.num_levels)
    stats["rounds"] = last_round
    return (
        grid_rb, st.offset, rounds_np, witness_np, lamport_np, wtable_np,
        last_round,
    )


# ---------------------------------------------------------------------------
# engine entry point
# ---------------------------------------------------------------------------


def run_doubling_passes(
    grid: DagGrid,
    d_max: Optional[int] = None,
    stats: Optional[dict] = None,
    device: Optional[Union[str, torch.device]] = None,
    packed: Optional[bool] = None,
) -> PassResults:
    """Passes 1-3 through the cold path, on the CUDA card by default
    (device="cpu" runs the plain versions); the same PassResults contract
    as run_passes / run_frontier_passes. `stats` receives closure_passes,
    walk_chunks, depth, rounds and passes. The fame vote's layout is
    `packed`, or the knob's when None. Raises GridUnsupported on anything
    the cold path cannot certify."""
    dev = resolve_device(device)
    pk = resolve_packed(packed, grid.n)
    st = stats if stats is not None else {}
    (grid_rb, offset, rounds_np, witness_np, lamport_np, wtable_np,
     last_round) = _doubling_stage1(grid, dev, st)

    e_real = grid.e
    grid_p = pad_grid(grid_rb)
    rounds_p = _pad1(rounds_np, grid_p.creator.shape[0] - e_real, -1)
    d_cap = d_max if d_max is not None else wtable_np.shape[0] + 2
    put = functools.partial(to_device, device=dev)
    decided, famous, rdec, received = _fame_received(
        put(wtable_np), put(grid_p.last_ancestors),
        put(grid_p.first_descendants), put(grid_p.index), put(grid_p.creator),
        put(grid_p.coin_bit.astype(bool)), put(rounds_p),
        torch.tensor(last_round, dtype=torch.int32, device=dev),
        grid.super_majority, grid.n, d_cap, packed=pk,
    )
    received = received.cpu().numpy()[:e_real]
    st["passes"] = st.get("closure_passes", 0) + st.get("walk_chunks", 0) + 1

    rounds = rounds_np
    if offset:
        rounds = np.where(rounds >= 0, rounds + offset, rounds)
        received = np.where(received >= 0, received + offset, received)
    return PassResults(
        rounds=rounds.astype(np.int32),
        witness=np.asarray(witness_np),
        lamport=lamport_np,
        witness_table=wtable_np,
        fame_decided=decided.cpu().numpy(),
        famous=famous.cpu().numpy(),
        rounds_decided=rdec.cpu().numpy(),
        received=received.astype(np.int32),
        last_round=last_round + offset,
        round_offset=offset,
    )


def maybe_cold_replay(hg, grid: DagGrid,
                      device: Optional[Union[str, torch.device]] = None) -> bool:
    """Live-engine bootstrap hook: replay a deep/post-reset grid through
    the cold path on `device` and stamp its results into the store, so the
    frontier attach that follows only carries the unsettled tail. Returns
    False (and leaves no trace) when the grid is shallow or unsupported."""
    if not use_doubling(grid):
        return False
    from .engine import integrate_pass_results

    clock = hg.obs.clock
    t0 = clock.monotonic()
    st: dict = {}
    try:
        res = run_doubling_passes(grid, stats=st, device=device)
    except GridUnsupported:
        return False
    integrate_pass_results(hg, grid, res)
    dt = clock.monotonic() - t0
    observe_catchup(hg.obs, st, dt)
    return True


def observe_catchup(obs, stats: dict, seconds: float) -> None:
    """Shared cold-path telemetry: the replay histogram, plus the
    flight-recorder record."""
    obs.histogram(
        "babble_catchup_replay_seconds",
        "Cold-path (pointer-doubling) section replay wall time",
    ).observe(seconds)
    obs.flightrec.record(
        "catchup.replay",
        depth=int(stats.get("depth", 0)),
        passes=int(stats.get("passes", 0)),
        ms=round(seconds * 1e3, 3),
    )
