"""Device consensus engine of the PyTorch port: passes 1-3 (DivideRounds,
DecideFame, DecideRoundReceived) over a DagGrid, through the
round-frontier pipeline (base grids) or the level scan (any grid).

Counterpart of babble_tpu/tpu/engine.py's one-shot engines. The host
stages the grid with numpy, pads it to the reference's bucketed shapes (so
the port's tensors equal the reference's, shape for shape), runs the
pipeline on the card (or, when asked, on the CPU through the plain
versions) and stages the results back to numpy. The log-diameter cold
path is in doubling.py.

The hashgraph seam is here too: `run_consensus_device` stages a host
Hashgraph with grid_from_hashgraph, runs the reference's rung order
(cold path when deep, else the frontier walk on base grids, else the
level scan) and writes the results back through the same validation
gates (`validate_round_writeback`, `admissible_receptions`,
`integrate_pass_results`), so the host's passes 4-5 commit byte-identical
blocks. The voting-table layout resolves as in the reference
(`resolve_packed(packed, n)`: the packed one from 128 validators up by
default, tpu/packed.py). With `mesh` (a tpu/mesh.py DeviceMesh) the same
rungs run sharded over its positions (tpu/sharded.py).
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
from .grid import MAX_INT32, MIN_INT32, DagGrid, GridUnsupported, grid_from_hashgraph
from .kernels import consensus_pipeline
from .packed import observe_table_bytes, resolve_packed


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

    The voting-table layout is `packed`, or the knob's when None (the
    packed one from 128 validators up). Raises GridUnsupported on a grid
    that is not frontier-safe (post-reset grids take run_passes or
    run_doubling_passes)."""
    dev = resolve_device(device)
    pk = resolve_packed(packed, grid.n)
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
            d_cap=d_max, packed=pk,
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
    bucket up on overflow. The layout resolves as in run_frontier_passes."""
    dev = resolve_device(device)
    pk = resolve_packed(packed, grid.n)
    e_real = grid.e
    grid, offset, r_max = scan_layout(grid, bucketed)
    inputs = stage_scan(grid, dev)

    def run_fn(r_fame):
        # the fame offset loop is self-bounding (j <= last_round); d_cap is
        # a safety net only
        d_cap = d_max if d_max is not None else r_fame + 2
        return consensus_pipeline(
            *inputs, grid.super_majority, grid.n, r_max, r_fame, d_cap,
            packed=pk,
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


def validate_round_writeback(hg, proposed) -> None:
    """Boundary gate for every device->host round stamp: the host round
    function is write-once and the source of all downstream consensus
    metadata, so a single wrong stamp silently diverges the node forever
    (observed on long-lived post-reset states: a re-joined node minting
    one empty block per sync, thousands ahead of its peers). Before
    anything is written, enforce two theorems of the hashgraph round
    function on the whole batch:

    1. never overwrite: an event with a known host round must be proposed
       the SAME round;
    2. parent bounds: round(e) is in [max(parent rounds), max + 1]
       (rounds are non-decreasing along chains and advance by at most one
       per event), checked against every parent whose round is resolvable
       from the batch or the store.

    Violations raise GridUnsupported — the caller's ladder falls back to
    a sound engine instead of stamping garbage."""
    from ..common import StoreErr

    pro = dict(proposed)
    for h, (rnum, lam) in pro.items():
        ev = hg.store.get_event(h)
        if ev.round is not None and ev.round != rnum:
            raise GridUnsupported(
                f"round write-back would overwrite {ev.round} with {rnum} "
                f"({h[:18]}…)"
            )
        if (
            lam is not None
            and ev.lamport_timestamp is not None
            and ev.lamport_timestamp != lam
        ):
            # lamports order events inside frames; overwriting one reorders
            # committed frame bodies and diverges the FrameHash
            raise GridUnsupported(
                f"lamport write-back would overwrite {ev.lamport_timestamp} "
                f"with {lam} ({h[:18]}…)"
            )
        pmax = None
        lmax = None
        lam_known = True
        for ph in (ev.self_parent(), ev.other_parent()):
            if not ph:
                continue
            pr = pl = None
            got = pro.get(ph)
            if got is not None:
                pr, pl = got
            else:
                try:
                    pev = hg.store.get_event(ph)
                    pr, pl = pev.round, pev.lamport_timestamp
                except StoreErr:
                    pass
            if pr is not None:
                pmax = pr if pmax is None else max(pmax, pr)
            if pl is not None:
                lmax = pl if lmax is None else max(lmax, pl)
            else:
                lam_known = False
        if pmax is not None and not (pmax <= rnum <= pmax + 1):
            raise GridUnsupported(
                f"round write-back violates parent bounds: {rnum} vs "
                f"parents<= {pmax} ({h[:18]}…)"
            )
        if (
            lam is not None and lam_known and lmax is not None
            and lam != lmax + 1
        ):
            # lamport(e) is EXACTLY max(parent lamports) + 1 when every
            # parent's lamport is resolvable
            raise GridUnsupported(
                f"lamport write-back violates parent identity: {lam} vs "
                f"max(parents)+1 = {lmax + 1} ({h[:18]}…)"
            )


def admissible_receptions(hg, round_infos, proposed) -> bool:
    """Boundary gate for device->host round_received stamps, mirroring the
    host rule (decide_round_received): an event is received at round rr
    only if every round in (round(x), rr] is known and fully fame-decided
    in the HOST's state. The device recomputes fame over the whole grid
    and can "unblock" a round the host froze forever (a late witness in an
    already-decided round) — stamping such a reception diverges this node
    from every host-disciplined peer.

    Returns True iff EVERY proposal is admissible. On False the caller
    must NOT stamp device receptions at all and instead run the host's
    own decide_round_received for this call: merely skipping the
    inadmissible ones would delay receptions past their round's block
    composition and diverge block bodies from a host-engine peer."""
    from ..common import StoreErr

    for h, rr in proposed:
        ev = hg.store.get_event(h)
        if ev.round is None:
            # the host rule checks every round in (round(x), rr]; with the
            # event's round unknown that range is unknowable — force the
            # host's own reception pass rather than guess (DivideRounds
            # write-back normally runs first, but nothing enforces it)
            return False
        r0 = ev.round
        for i in range(r0 + 1, rr + 1):
            ri = round_infos.get(i)
            if ri is None:
                try:
                    ri = hg.store.get_round(i)
                except StoreErr:
                    if hg.reset_floor is not None and i <= hg.reset_floor:
                        continue
                    return False
            if not ri.witnesses_decided():
                return False
    return True


def run_consensus_device(
    hg,
    d_max: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
) -> None:
    """Full five-pass pipeline with passes 1-3 on the device (the CUDA
    card unless the caller passes device="cpu").

    Equivalent to Hashgraph.run_consensus() on a freshly-inserted DAG:
    extract grid -> device passes -> write rounds/witness/lamport/fame/
    received back into the store -> host ProcessDecidedRounds +
    ProcessSigPool (unchanged, so blocks come out byte-identical). Deep
    grids take the cold path, base grids the round-frontier walk,
    post-reset states the level scan, each in the voting-table layout
    the knob resolves for this validator count (tpu/packed.py). With
    `mesh` (a DeviceMesh) the same rungs run sharded over its positions
    (tpu/sharded.py); the device is the mesh's, and a `device` naming
    another raises ValueError."""
    if mesh is not None:
        if device is not None:
            want, have = torch.device(device), mesh.device
            if (want.type, want.index or 0) != (have.type, have.index or 0):
                raise ValueError(f"run_consensus_device: device {device} is not the "
                                 f"mesh's {have}")
        return _run_consensus_mesh(hg, mesh)
    dev = resolve_device(device)
    # resolve the voting-table layout once so every engine rung below runs
    # the same one
    pk = resolve_packed(None, len(hg.participants.to_peer_slice()))
    obs, clock = hg.obs, hg.obs.clock
    _t0 = clock.monotonic()
    grid = grid_from_hashgraph(hg)
    _stage_s = clock.monotonic() - _t0
    if grid.e == 0:
        hg.process_decided_rounds()
        hg.process_sig_pool()
        return
    # per-call staging-vs-device breakdown: the one-shot restage is O(E)
    # host work per call
    _path = "oneshot"
    obs.histogram(
        "babble_device_stage_seconds",
        "Host staging (restage) time per device consensus call",
        labels=("path",),
    ).labels(path=_path).observe(_stage_s)
    _m_run = obs.histogram(
        "babble_device_run_seconds",
        "Device wall time per device consensus call",
        labels=("path",),
    )
    _led = obs.devledger
    _layout = "packed" if pk else "wide"
    from .doubling import observe_catchup, run_doubling_passes, use_doubling

    res = None
    _engine = "oneshot"
    if use_doubling(grid):
        _t1 = clock.monotonic()
        _dbl_stats = {}
        try:
            with _led.activate("doubling", layout=_layout):
                res = run_doubling_passes(
                    grid, d_max=d_max, stats=_dbl_stats, device=dev, packed=pk
                )
        except GridUnsupported:
            res = None
        if res is not None:
            _run_s = clock.monotonic() - _t1
            _m_run.labels(path="oneshot").observe(_run_s)
            observe_catchup(obs, _dbl_stats, _run_s)
            _led.component("doubling", "stage", _stage_s, layout=_layout)
            _engine = "doubling"
    if res is None and _frontier_safe(grid):
        _t1 = clock.monotonic()
        with _led.activate("frontier", layout=_layout):
            res = run_frontier_passes(grid, d_max=d_max, device=dev, packed=pk)
        _m_run.labels(path="oneshot").observe(clock.monotonic() - _t1)
        _led.component("frontier", "stage", _stage_s, layout=_layout)
    elif res is None:
        _t1 = clock.monotonic()
        with _led.activate("oneshot", layout=_layout):
            res = run_passes(
                grid, d_max=d_max, bucketed=True, adaptive_r=True,
                device=dev, packed=pk,
            )
        _m_run.labels(path="oneshot").observe(clock.monotonic() - _t1)
        _led.component("oneshot", "stage", _stage_s, layout=_layout)

    observe_table_bytes(obs, grid.n, res.witness_table.shape[0], pk)
    _ti0 = _led.now()
    integrate_pass_results(hg, grid, res, engine=_engine)
    _ti = _led.now() - _ti0
    if _engine == "doubling":
        _led.component("doubling", "integrate", _ti, layout=_layout)
    elif _frontier_safe(grid):
        _led.component("frontier", "integrate", _ti, layout=_layout)
    else:
        _led.component("oneshot", "integrate", _ti, layout=_layout)


def _run_consensus_mesh(hg, mesh) -> None:
    """The mesh branch of run_consensus_device: the rungs of the one-shot
    path (the sharded cold path when deep, falling through on
    GridUnsupported; the sharded frontier walk on base grids; else the
    sharded level scan), serialized against queued-mesh workers."""
    from .dispatch import _MESH_EXEC_LOCK
    from .doubling import observe_catchup, use_doubling
    from .sharded import (
        mesh_validator_shards,
        sharded_doubling_passes,
        sharded_engine_tag,
        sharded_frontier_passes,
        sharded_run_passes,
    )

    obs, clock = hg.obs, hg.obs.clock
    _t0 = clock.monotonic()
    grid = grid_from_hashgraph(hg)
    _stage_s = clock.monotonic() - _t0
    if grid.e == 0:
        hg.process_decided_rounds()
        hg.process_sig_pool()
        return
    # one layout for every rung below
    pk = resolve_packed(None, grid.n)
    obs.histogram(
        "babble_device_stage_seconds",
        "Host staging (restage) time per device consensus call",
        labels=("path",),
    ).labels(path="mesh").observe(_stage_s)
    _m_run = obs.histogram(
        "babble_device_run_seconds",
        "Device wall time per device consensus call",
        labels=("path",),
    )
    _led = obs.devledger
    _layout = "packed" if pk else "wide"
    _led.component("sharded", "stage", _stage_s, layout=_layout)
    _t1 = clock.monotonic()
    _dbl_stats = None
    # serialize against queued-mesh workers: an orphaned dispatch would
    # otherwise interleave its collectives with this call's
    with _MESH_EXEC_LOCK, _led.activate("sharded", layout=_layout):
        res = None
        if use_doubling(grid):
            # deep section: the log-diameter cold path, sharded
            _dbl_stats = {}
            try:
                res = sharded_doubling_passes(mesh, grid, stats=_dbl_stats, packed=pk)
            except GridUnsupported:
                res, _dbl_stats = None, None
        if res is None:
            if _frontier_safe(grid):
                res = sharded_frontier_passes(mesh, grid, packed=pk)
            else:
                res = sharded_run_passes(mesh, grid, packed=pk)
    _engine = sharded_engine_tag(mesh, doubling=_dbl_stats is not None)
    _run_s = clock.monotonic() - _t1
    _m_run.labels(path="mesh").observe(_run_s)
    if _dbl_stats is not None:
        observe_catchup(obs, _dbl_stats, _run_s)
    obs.gauge(
        "babble_mesh_staged_events",
        "Events staged onto the mesh in the latest mesh call",
    ).set(grid.e)
    obs.gauge(
        "babble_mesh_validator_shards",
        "Validator-axis shards in the active mesh layout",
    ).set(mesh_validator_shards(mesh))

    observe_table_bytes(obs, grid.n, res.witness_table.shape[0], pk)
    _ti0 = _led.now()
    integrate_pass_results(hg, grid, res, engine=_engine)
    _led.component("sharded", "integrate", _led.now() - _ti0, layout=_layout)


def integrate_pass_results(hg, grid, res, topo_hi: Optional[int] = None,
                           engine: str = "device") -> None:
    """Write device pass results back into the host hashgraph and run the
    host passes 4-5 — the shared integration tail of every one-shot-style
    device call.

    `engine` labels the decision-provenance capture (obs/provenance.py):
    every cell below is fingerprinted from the ALREADY-FETCHED host numpy
    buffers (res.* / grid.*) as it is stamped, so provenance adds no
    device work and no host syncs to the staged paths.

    `topo_hi` (the hashgraph's topological index at STAGING time) is the
    queued-dispatch escape hatch (the reference's mesh dispatch queue): by
    integration time the hashgraph may hold events the grid never modeled. An undetermined
    event inserted at/after topo_hi is simply not covered by this dispatch
    (the next staging models it); an unmodeled event from BEFORE the
    staging means the walk silently lost one — GridUnsupported, because
    silently never receiving it would skew block composition. With
    topo_hi=None (the synchronous one-shot path) every undetermined event
    must be in the grid, as before."""
    from ..common import StoreErr, StoreErrType, is_store_err
    from ..hashgraph import RoundInfo, PendingRound

    # --- write-back: DivideRounds (reference: hashgraph.go:767-849) ---
    # validate the WHOLE batch before stamping anything: a partial stamp
    # of wrong rounds poisons the host's (write-once) round function
    validate_round_writeback(
        hg,
        (
            (grid.hashes[r], (int(res.rounds[r]), int(res.lamport[r])))
            for r in range(grid.e)
        ),
    )
    undetermined = set(hg.undetermined_events)
    row_of = {h: r for r, h in enumerate(grid.hashes)}
    round_infos = {}
    prov = hg.obs.provenance
    prov_cells = 0
    for r in range(grid.e):  # rows are topo-ordered
        h = grid.hashes[r]
        ev = hg.store.get_event(h)
        ev.set_round(int(res.rounds[r]))
        ev.set_lamport_timestamp(int(res.lamport[r]))
        hg.store.set_event(ev)
        if h in undetermined:
            rnum = int(res.rounds[r])
            prov_cells += prov.note_event(
                h, rnum, int(res.lamport[r]), grid.last_ancestors[r],
            )
            if bool(res.witness[r]):
                prov_cells += prov.note_witness(h, rnum, int(grid.creator[r]))
            ri = round_infos.get(rnum)
            if ri is None:
                try:
                    ri = hg.store.get_round(rnum)
                except StoreErr as err:
                    if not is_store_err(err, StoreErrType.KEY_NOT_FOUND):
                        raise
                    ri = RoundInfo()
                round_infos[rnum] = ri
            if not ri.queued and (
                hg.last_consensus_round is None or rnum >= hg.last_consensus_round
            ):
                hg.pending_rounds.append(PendingRound(rnum, False))
                ri.queued = True
            elif (
                bool(res.witness[r])
                and ri.queued
                and not ri.is_decided(h)
                # rounds at/below a fast-sync cut are the donor's to decide
                and (hg.reset_floor is None or rnum > hg.reset_floor)
                and not any(p.index == rnum for p in hg.pending_rounds)
            ):
                # late witness into a decided-and-dequeued round: re-queue
                # so fame resolves, mirroring the host divide_rounds rule —
                # otherwise the cpu engine un-freezes the round this call
                # and a device-backend node diverges from it
                hg.pending_rounds.append(PendingRound(rnum, False))
            ri.add_event(h, bool(res.witness[r]))

    # --- write-back: DecideFame (reference: hashgraph.go:852-947) ---
    if hg.reset_floor is not None:
        # POST-RESET DELEGATION: fame/reception DECISION TIMING must match
        # the host engine call-for-call — block composition locks in when
        # a round is processed, and on post-reset states the device's
        # whole-grid fame can decide rounds on a different call than the
        # host's pending-round scan (observed as a one-event difference in
        # a committed block body between a cpu- and a tpu-backend joiner
        # fed identical syncs). The device still contributes the O(E*N)
        # DivideRounds bulk above; fame + received run host-side until the
        # reset ages out.
        for rnum, ri in round_infos.items():
            hg.store.set_round(rnum, ri)
        if prov_cells:
            prov.mark("prov.capture", engine=engine, cells=prov_cells)
        hg.decide_fame()
        hg.decide_round_received()
        hg.process_decided_rounds()
        hg.process_sig_pool()
        return
    # the (R, N) tables are indexed by round - round_offset (rebasing)
    decided_rounds = set()
    for pr in hg.pending_rounds:
        ri = round_infos.get(pr.index)
        if ri is None:
            ri = hg.store.get_round(pr.index)
            round_infos[pr.index] = ri
        ti = pr.index - res.round_offset
        if ti < 0 or ti >= res.witness_table.shape[0]:
            continue
        for c in range(grid.n):
            wrow = int(res.witness_table[ti, c])
            if wrow < 0:
                continue
            if res.fame_decided[ti, c]:
                ri.set_fame(grid.hashes[wrow], bool(res.famous[ti, c]))
                prov_cells += prov.note_fame(
                    grid.hashes[wrow], pr.index, bool(res.famous[ti, c]),
                    engine=engine,
                )
        if ri.witnesses_decided():
            decided_rounds.add(pr.index)
    undecided_pending = [
        pr for pr in hg.pending_rounds if pr.index not in decided_rounds
    ]
    for pr in hg.pending_rounds:
        pr.decided = pr.index in decided_rounds
    if undecided_pending:
        # completeness net: a re-queued round can sit below the device
        # table's rebased window (ti out of range above), so its late
        # witness would never get fame from the device write-back. The
        # host pass skips every already-decided witness, so on a healthy
        # state this is O(pending) dict lookups; it only votes for the
        # stragglers — and recomputes pr.decided itself.
        for rnum, ri in round_infos.items():
            hg.store.set_round(rnum, ri)
        hg.decide_fame()
        for pr in hg.pending_rounds:
            ri = round_infos.get(pr.index)
            if ri is not None:
                round_infos[pr.index] = hg.store.get_round(pr.index)

    # --- write-back: DecideRoundReceived (reference: hashgraph.go:951-1036) ---
    def _covered(h):
        """Grid row for h, or None when h postdates this dispatch's
        staging (queued path only — the next staging covers it)."""
        row = row_of.get(h)
        if row is not None:
            return row
        if topo_hi is not None:
            try:
                ev = hg.store.get_event(h)
            except StoreErr:
                ev = None
            if ev is not None and ev.topological_index >= topo_hi:
                return None
        raise GridUnsupported(f"undetermined event unmodeled ({h[:18]}…)")

    def _proposed():
        for h in hg.undetermined_events:
            row = _covered(h)
            if row is None:
                continue
            rr = int(res.received[row])
            if rr >= 0:
                yield h, rr

    rr_clean = admissible_receptions(hg, round_infos, _proposed())
    if rr_clean:
        new_undetermined = []
        for h in hg.undetermined_events:
            row = _covered(h)
            rr = -1 if row is None else int(res.received[row])
            if rr >= 0:
                ev = hg.store.get_event(h)
                ev.set_round_received(rr)
                prov_cells += prov.note_received(h, rr)
                hg.store.set_event(ev)
                tri = round_infos.get(rr)
                if tri is None:
                    tri = hg.store.get_round(rr)
                    round_infos[rr] = tri
                tri.set_consensus_event(h)
            else:
                new_undetermined.append(h)
        hg.undetermined_events = new_undetermined

        for rnum, ri in round_infos.items():
            hg.store.set_round(rnum, ri)
    else:
        # the device "unblocked" at least one reception the host rule
        # refuses (post-reset frozen/missing rounds): persist the fame
        # state and run the HOST's own reception pass this call — exact
        # host timing, so block composition cannot skew
        for rnum, ri in round_infos.items():
            hg.store.set_round(rnum, ri)
        hg.decide_round_received()

    if prov_cells:
        prov.mark("prov.capture", engine=engine, cells=prov_cells)

    # --- host passes 4-5 ---
    hg.process_decided_rounds()
    hg.process_sig_pool()
