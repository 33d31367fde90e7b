"""Live-node incremental device consensus for the PyTorch port: the
persistent append-batch pipeline (tpu/incremental.py) wired into a running
Hashgraph. Counterpart of babble_tpu/tpu/live.py.

Where run_consensus_device re-stages the full DAG every sync (O(E) host
work per call), this engine keeps the DAG on device and ships only the
events inserted since the last consensus call — the host work per sync is
O(batch), mirroring the reference's UndeterminedEvents discipline
(reference: src/hashgraph/hashgraph.go:36-40,767-780) with device-resident
state.

Wiring: the Hashgraph's insert path reports each inserted event plus the
first-descendant cells its insert wrote (hashgraph.insert_listener);
run_consensus_live drains that queue into fixed-shape append batches,
advances the device state, and writes new rounds/fame/received back into
the store exactly like the one-shot engine. Passes 4-5 stay host-side, so
blocks remain byte-identical by construction.

Scope and fallback: base-state hashgraphs only (no resets — the dense
incremental state has no external-parent metadata). Any unsupported
condition (post-reset state, capacity overflow, fame-unroll exhaustion,
received-window staleness) raises GridUnsupported. The caller decides
what runs next: a node's ladder takes the one-shot device path
(run_consensus_device), and only the caller's ladder may go on to the
host engine. The port itself never moves to the CPU unless the caller
passes device="cpu".

The engine holds its device (the CUDA card unless the caller passes
device="cpu") and updates its IncState there in place: K9-K12 per append
(tpu/incremental.py), then K13's layout flattens what the write-back
reads into one fresh int32 vector, all on the one compute stream, so
stream order keeps its reads ahead of the next append's writes. `advance`
asks the call's last decide for that vector (K12's last two launches write
it: csrc/decide_window.cu dw_tables, dw_events) and keeps it; `_dispatch` hands it over
where nothing has written the state since (a rebase or an attach drops
it; the bootstrap's replay packs the same way), and launches K13
`_pack_results` (csrc/pack_results.cu) of its own only where no decide
ran since the last pack: a call with no new events, an attach from the
frontier. That vector is the only device read of a call: the
synchronous discipline copies it to the host at once, the pipelined one
hands it to a side stream and a reader thread (`_AsyncFetch`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..obs.devledger import ledger_call
from . import _ext
from .device import resolve_device
from .grid import MAX_INT32, DagGrid, GridUnsupported, grid_from_hashgraph
from .incremental import (
    Batch,
    IncState,
    L_MAX,
    empty_batch,
    init_state,
    multi_step,
    pack_results_plain,
    pack_size,
    pack_window_start,
    stack_batches,
    state_from_arrays,
    step,
)
from .packed import observe_table_bytes, packed_enabled


def derive_fd_updates(grid: DagGrid) -> List[List[Tuple[int, int, int]]]:
    """Reconstruct the per-event first-descendant write stream from a
    completed grid: cell fd[row, c] == v was written by the insert of the
    event (creator c, index v). O(E*N)."""
    rows_by = np.full(
        (grid.n, int(grid.index.max(initial=0)) + 1), -1, dtype=np.int32
    )
    if grid.e:
        rows_by[grid.creator, grid.index] = np.arange(grid.e, dtype=np.int32)
    stream: List[List[Tuple[int, int, int]]] = [[] for _ in range(grid.e)]
    rows, cols = np.nonzero(grid.first_descendants != MAX_INT32)
    vals = grid.first_descendants[rows, cols]
    for row, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()):
        updater = int(rows_by[c, v])
        if updater != row:  # own-cell writes ride with the appended row
            stream[updater].append((int(row), int(c), int(v)))
    return stream


# constructor defaults, module-level so tests can shrink the capacities
# to force rebases quickly; the port's own dict, equal to the
# reference's. r_win (the live-stepping round window) is 64, not 32:
# post-fast-sync recovery states exhibit round spans past 32 that trip
# the attach span guard into attach/demote/retry churn. It is a named
# default so tests/benchmarks can narrow it explicitly.
ENGINE_DEFAULTS = dict(
    e_cap=1 << 16, r_cap=64, batch_cap=64, upd_cap=8192, e_win=8192,
    r_win=64,
    # async dispatch queue: up to queue_depth dispatches in flight before
    # the serve path blocks to integrate the oldest; 1 is a single-slot
    # overlap. batch_deadline > 0 holds gossip-staged rows for that many
    # Clock seconds (or until batch_cap rows accumulate) before
    # dispatching, so the device sees fewer, larger trains.
    queue_depth=4, batch_deadline=0.0,
)


class LiveDeviceEngine:
    """Device-resident DAG state for one live Hashgraph.

    Capacities are finite (e_cap event rows, r_cap round slots) but the
    DAG is not: when either axis nears exhaustion the engine REBASES —
    it rebuilds its device state from the undecided frontier (events of
    recent rounds + still-undetermined events), with all rounds stored
    relative to a new ``round_base``. Decided history below the base is
    final and never consulted again (the same windowing argument as the
    reference's RollingIndex pruning, SURVEY §5), so a live node streams
    indefinitely through bounded device memory."""

    def __init__(self, hg, e_cap: int = None, r_cap: int = None,
                 batch_cap: int = None, upd_cap: int = None,
                 e_win: int = None, r_win: int = None,
                 queue_depth: int = None, batch_deadline: float = None,
                 device: Optional[Union[str, torch.device]] = None):
        d = ENGINE_DEFAULTS
        self.device = resolve_device(device)
        self.hg = hg
        self.n = len(hg.participants.to_peer_slice())
        # voting-table layout, resolved once at engine construction
        # (tpu/packed.py; per-engine override via BABBLE_PACKED_VOTING)
        self.packed = packed_enabled(self.n)
        self.e_cap = d["e_cap"] if e_cap is None else e_cap
        self.r_cap = d["r_cap"] if r_cap is None else r_cap
        self.batch_cap = d["batch_cap"] if batch_cap is None else batch_cap
        self.upd_cap = d["upd_cap"] if upd_cap is None else upd_cap
        self.e_win = min(d["e_win"] if e_win is None else e_win, self.e_cap)
        # single source of truth for the device round window: the span
        # guard in _install_state and every step() call must agree, or
        # clamped rounds slip past the guard. The default is the
        # deliberate 64-wide window (see ENGINE_DEFAULTS).
        self.r_win = min(d["r_win"] if r_win is None else r_win, self.r_cap)
        observe_table_bytes(hg.obs, self.n, self.r_win, self.packed)
        self.round_base = 0
        self.rebases = 0
        # latency accounting: device dispatches vs result fetches.
        # Durations go to the obs registry
        # histograms (babble_device_dispatch/fetch_seconds, shared with
        # the Node's /stats adapter); structural counts stay here because
        # the pipelining heuristic reads them per-engine.
        self.dispatches = 0
        self.consensus_calls = 0
        self._m_dispatch = hg.obs.histogram(
            "babble_device_dispatch_seconds",
            "Host-side device program launch time per advance",
        )
        self._m_fetch = hg.obs.histogram(
            "babble_device_fetch_seconds",
            "Blocking device result fetch (round-trip) time",
        )
        self._m_rebase = hg.obs.counter(
            "babble_device_rebases_total",
            "Live-engine grid rebases onto a committed frontier",
        )
        # pipelined-fetch discipline: flips on when the measured blocking
        # fetch is consistently expensive. inflight is a bounded FIFO of
        # (_AsyncFetch, snapshot, t_dispatch) tuples — up to queue_depth
        # dispatches ride concurrently, integrated oldest-first on
        # DETERMINISTIC conditions only (queue full, or no dispatch this
        # call) so same-seed sim runs never diverge on thread timing.
        self.async_fetch = ENGINE_DEFAULTS.get("async_fetch") is True
        self.queue_depth = (
            d["queue_depth"] if queue_depth is None else queue_depth
        )
        self.batch_deadline = (
            d["batch_deadline"] if batch_deadline is None else batch_deadline
        )
        self.inflight: List[tuple] = []
        self._pending_since: Optional[float] = None
        self._slow_fetches = 0
        self._m_qdepth = hg.obs.gauge(
            "babble_device_queue_depth",
            "Device dispatches currently in flight in the async queue",
        )
        self._m_overlap = hg.obs.histogram(
            "babble_device_overlap_utilization",
            "Fraction of each dispatch's in-flight time overlapped with "
            "gossip (1.0 = the fetch never blocked the serve path)",
            buckets=[i / 10 for i in range(11)],
        )
        self.state: IncState = init_state(
            self.n, self.e_cap, self.r_cap, device=self.device
        )
        # K13's vector from the last decide of the latest advance, with the
        # row count it was packed at, until a dispatch takes it or anything
        # else writes the state; and which route each dispatch's vector came
        # by ("fused": that decide's; "own": K13's own launch)
        self._pack: Optional[Tuple[torch.Tensor, int]] = None
        self.packs = {"fused": 0, "own": 0}
        self.row_of: Dict[str, int] = {}
        self.hashes: List[str] = []
        self.pending: List[tuple] = []  # (event, fd_writes)
        self._bootstrap()
        hg.insert_listener = self._on_insert

    # -- hashgraph hooks ---------------------------------------------------

    def _on_insert(self, event, fd_writes) -> None:
        """Called by Hashgraph.insert_event with the event and the
        (ancestor_hash, creator_pos, index) first-descendant cells its
        insert wrote."""
        if not self.pending:
            # batch-deadline anchor, on the injected Clock (sim-safe)
            self._pending_since = self.hg.obs.clock.monotonic()
        self.pending.append((event, fd_writes))

    def detach(self) -> None:
        if getattr(self.hg, "insert_listener", None) is self._on_insert:
            self.hg.insert_listener = None
        self.inflight = []  # results of a dropped engine are never stamped

    # -- construction ------------------------------------------------------

    def _bootstrap(self) -> None:
        """Build device state from the hashgraph's existing DAG.

        Small base-state DAGs replay through the append pipeline (the
        cheapest path and the one that exercises no store round lookups).
        Anything else — post-reset states, DAGs past the write-back
        window, rolled store windows — attaches FROM THE FRONTIER: the
        same store-driven assembly a rebase performs, keeping only events
        of rounds >= base plus undetermined ones. This is what lets a
        restarted node with a deep sqlite history, or a node returning
        from fast-sync, ride the live engine instead of being stuck on
        the one-shot path forever."""
        try:
            grid = grid_from_hashgraph(self.hg)
        except GridUnsupported:
            # rolled store window: full history is unreachable, but the
            # frontier assembly only touches recent rows
            self._attach_from_frontier()
            return
        base_state = not grid.e or (
            (grid.ext_sp_round == -1).all() and (grid.ext_op_round == -1).all()
        )
        if not base_state or grid.e > self.e_win:
            # deep or post-reset history: settle it through the
            # log-diameter cold path first (O(log depth) device passes vs
            # the store-driven replay's per-round work), so the frontier
            # attach below only carries the unsettled tail
            from .doubling import maybe_cold_replay

            maybe_cold_replay(self.hg, grid, device=self.device)
            # capacity for the kept rows is enforced by _install_state
            self._attach_from_frontier()
            return
        self.hashes = list(grid.hashes)
        self.row_of = {h: r for r, h in enumerate(self.hashes)}
        if grid.e == 0:
            return
        import dataclasses

        grid = dataclasses.replace(
            grid, fd_update_stream=derive_fd_updates(grid)
        )
        from .incremental import batches_from_grid

        batches = list(batches_from_grid(grid, self.batch_cap, self.upd_cap, self.e_cap))
        # the replay's last decide packs the attach call's results
        vec, lo = self._pack_target()
        for j, b in enumerate(batches):
            self.state = step(
                self.state, b, self.hg.super_majority, self.n,
                e_win=self.e_win, r_win=self.r_win, packed=self.packed,
                pack=vec if j == len(batches) - 1 else None, pack_lo=lo,
            )
        self._pack = (vec, len(self.hashes))

    def _pack_target(self) -> Tuple[torch.Tensor, int]:
        """A fresh vector for K13's layout and the window start of the row
        count the engine holds now (every row staged)."""
        lo = pack_window_start(max(len(self.hashes) - self.e_win, 0), self.e_cap, self.e_win)
        return torch.empty((pack_size(self.e_win, self.r_cap, self.n),), dtype=torch.int32,
                           device=self.device), lo

    def _attach_base_round(self):
        """(base, floor): floor = first fame-undecided round, base =
        floor - 1 — the rebase invariant: fame voting for round j only
        consults round j-1's witnesses, and an event no decided round
        received can only be received at or after the first undecided
        round."""
        hg = self.hg
        undecided = [p.index for p in hg.pending_rounds if not p.decided]
        if undecided:
            floor = min(undecided)
        elif hg.last_consensus_round is not None:
            floor = hg.last_consensus_round + 1
        else:
            floor = 0
        return max(0, floor - 1), floor

    def _attach_from_frontier(self) -> None:
        """Fresh attach from the undecided frontier: walk each validator's
        chain back from its head, keeping events of rounds >= base plus
        undetermined ones — O(kept), no full-history enumeration, valid on
        post-reset states (coordinates are reset-relative but internally
        consistent) and rolled store windows."""
        from ..common import StoreErr

        hg = self.hg
        base, floor = self._attach_base_round()

        undet = set(hg.undetermined_events)
        # stop the walk-back only below every undetermined event's round
        stop = base
        # det-ok: pure min-reduction over the set — order-independent
        for h in undet:
            try:
                ev = hg.store.get_event(h)
            except StoreErr as e:
                raise GridUnsupported(f"attach: undetermined event lost ({e})")
            if ev.round is not None:
                stop = min(stop, ev.round)

        kept_map = {}
        for p in hg.participants.to_peer_slice():
            try:
                h, is_root = hg.store.last_event_from(p.pub_key_hex)
            except StoreErr:
                continue
            if is_root:
                continue
            chain = []
            while h:
                try:
                    ev = hg.store.get_event(h)
                except StoreErr:
                    break  # below the store window: everything older is final
                if (
                    ev.round is not None and ev.round < stop
                    and h not in undet
                ):
                    break
                chain.append((h, ev))
                h = ev.self_parent()
            for h2, ev2 in reversed(chain):
                if (ev2.round is not None and ev2.round >= base) or h2 in undet:
                    kept_map[h2] = ev2

        # ROUND CLOSURE: an event without a host round must be computable
        # WITHIN the modeled window — both parents either carry known
        # rounds or are themselves kept. _install_state stages no external
        # round seeds (unlike grid_from_hashgraph, which seeds from roots
        # and frozen refs), so an unrounded event with an out-of-window
        # parent would be mis-derived as root-attached at the engine base
        # (observed: a fresh post-fast-sync attach stamping base-relative
        # rounds onto genesis events). Refuse and let the one-shot path —
        # which has full external seeding — run until rounds settle; the
        # attach succeeds on a later call.
        def _parent_ok(ph: str) -> bool:
            # membership only: a parent with a known round but OUTSIDE the
            # window is still unusable — the engine has no row to read the
            # round from and no external seed channel
            return ph == "" or ph in kept_map
        for h2, ev2 in kept_map.items():
            if ev2.round is None and not (
                _parent_ok(ev2.self_parent()) and _parent_ok(ev2.other_parent())
            ):
                raise GridUnsupported(
                    f"attach: unrounded event with out-of-window parent "
                    f"({h2[:18]}…)"
                )

        # topological order (coordinates reference earlier rows only)
        kept = sorted(kept_map.items(), key=lambda kv: kv[1].topological_index)
        self._install_state(base, floor, kept)

    # -- rebasing ----------------------------------------------------------

    def rebase(self) -> None:
        """Rebuild the device state from the undecided frontier.

        Kept rows: every event of an absolute round >= base, plus every
        event whose round-received is still undetermined, where
        base = (first fame-undecided round) - 1 — fame voting for round j
        only ever consults round j-1's witnesses, and an event that no
        decided round received can only be received at a round >= the
        first undecided one, so nothing below the base can influence any
        future decision. Rounds are stored base-relative on device;
        run_consensus_live translates at the write-back boundary.

        Everything is assembled host-side from the store (coordinates are
        host-maintained and write-once) — one device upload, no replay.
        """
        from ..common import StoreErr

        if self.inflight:
            # invariant of the backend ladder: a rebase replaces
            # the row containers in-flight snapshots alias — callers must
            # drain the dispatch queue first (_settle_capacity does)
            raise GridUnsupported("rebase with dispatches in flight")
        hg = self.hg
        base, floor = self._attach_base_round()
        if base <= self.round_base:
            raise GridUnsupported(
                f"rebase cannot advance the round base (stuck at {base})"
            )

        undet = set(hg.undetermined_events)
        kept: List[tuple] = []  # (hash, event)
        try:
            for h in self.hashes:
                ev = hg.store.get_event(h)
                if (ev.round is not None and ev.round >= base) or h in undet:
                    kept.append((h, ev))
        except StoreErr as e:
            raise GridUnsupported(f"rebase: frontier event evicted ({e})")
        self._install_state(base, floor, kept)
        self.rebases += 1
        self._m_rebase.inc()
        hg.obs.flightrec.record(
            "live.rebase", base=base, kept=len(kept), rebases=self.rebases,
        )

    def _install_state(self, base: int, floor: int, kept: List[tuple]) -> None:
        """Assemble IncState host-side from (hash, event) rows of rounds
        >= base plus undetermined ones, rounds stored base-relative — one
        device upload, no replay. Shared by rebase() and the fresh
        frontier attach."""
        from ..common import StoreErr
        from ..hashgraph.hashgraph import middle_bit
        from ..hashgraph.round_info import Trilean

        hg = self.hg
        n, e_cap, r_cap = self.n, self.e_cap, self.r_cap
        undet = set(hg.undetermined_events)
        self._pack = None  # the state is rebuilt below

        min_undet_round = floor
        for h, ev in kept:
            if h in undet and ev.round is not None:
                min_undet_round = min(min_undet_round, ev.round)

        # host-frozen rounds: a round below the frontier whose witness set
        # gained a late member has UNDEFINED fame forever on the host and
        # blocks receptions of older events behind it. The rebased state
        # cannot represent that block (the round is below the base), so
        # refuse and let the host engine carry this hashgraph.
        for r_abs in range(min_undet_round + 1, floor):
            try:
                if not hg.store.get_round(r_abs).witnesses_decided():
                    raise GridUnsupported(
                        f"rebase: round {r_abs} is host-frozen below the "
                        f"frontier"
                    )
            except StoreErr:
                continue
        # ROUND-SPAN GUARD: rounds are staged base-relative on a finite
        # round axis; a kept event whose known round falls outside it
        # would be CLAMPED, and every child computed from the clamped
        # value comes out a few rounds low — the write-back gate then
        # rejects the whole batch ("round write-back violates parent
        # bounds: 9783 vs parents<= 9785" in a strict-loop capture),
        # so the attach churns demote/retry forever while stamping
        # nothing. Refuse up front instead: the host keeps deciding fame,
        # the span shrinks, and a later attach fits.
        r_win = self.r_win
        max_known = max(
            (ev.round for _, ev in kept if ev.round is not None),
            default=base,
        )
        if max_known - base >= r_win - 2:  # margin for rounds formed mid-flight
            raise GridUnsupported(
                f"attach: round span {max_known - base} exceeds the device "
                f"round window {r_win}"
            )
        if len(kept) > e_cap - 4 * self.batch_cap:
            raise GridUnsupported(
                f"rebase keeps {len(kept)} rows; capacity {e_cap} too small"
            )
        if len(kept) > self.e_win - 2 * self.batch_cap:
            # undetermined rows must stay inside the received fetch window
            # (same constraint the bootstrap imposes on grid.e)
            raise GridUnsupported(
                f"rebase keeps {len(kept)} rows; write-back window "
                f"{self.e_win} too small"
            )

        la = np.full((e_cap, n), -1, np.int32)
        fd = np.full((e_cap, n), MAX_INT32, np.int32)
        creator = np.zeros(e_cap, np.int32)
        index = np.full(e_cap, MAX_INT32, np.int32)
        rounds = np.full(e_cap, -1, np.int32)
        lamport = np.full(e_cap, -1, np.int32)
        witness = np.zeros(e_cap, bool)
        received = np.full(e_cap, -1, np.int32)
        w_of_row = np.full(e_cap, -1, np.int32)
        wtable = np.full((r_cap, n), -1, np.int32)
        la_w = np.full((r_cap, n, n), -1, np.int32)
        fd_w = np.full((r_cap, n, n), MAX_INT32, np.int32)
        idx_w = np.full((r_cap, n), MAX_INT32, np.int32)
        coin_w = np.zeros((r_cap, n), bool)
        fame_decided = np.zeros((r_cap, n), bool)
        famous = np.zeros((r_cap, n), bool)
        rounds_decided = np.zeros(r_cap, bool)

        new_row_of: Dict[str, int] = {}
        new_hashes: List[str] = []
        last_abs = base
        for k, (h, ev) in enumerate(kept):
            new_row_of[h] = k
            new_hashes.append(h)
            creator[k] = hg.peer_position(ev.creator())
            index[k] = ev.index()
            la[k] = [c[0] for c in ev.last_ancestors]
            fd[k] = [c[0] for c in ev.first_descendants]
            if ev.round is not None:
                if ev.round >= base:
                    rounds[k] = ev.round - base
                    last_abs = max(last_abs, ev.round)
                # else: a still-undetermined event below the base — its
                # reception is pending at rounds >= floor but its round
                # cannot be represented base-relative; leave the sentinel
                # (-1). The write-back never re-stamps host-known rounds,
                # so the true round is preserved host-side.
            lamport[k] = (
                ev.lamport_timestamp if ev.lamport_timestamp is not None else -1
            )
            rr = ev.round_received
            received[k] = (rr - base) if (rr is not None and h not in undet) else -1

        # witness tables + fame state for the kept round window
        for r_abs in range(base, min(last_abs, base + r_cap - 1) + 1):
            sh = r_abs - base
            try:
                ri = hg.store.get_round(r_abs)
            except StoreErr:
                continue
            for h, re in ri.events.items():
                if not re.witness:
                    continue
                row = new_row_of.get(h)
                if row is None:
                    raise GridUnsupported(
                        f"rebase: witness of round {r_abs} not kept"
                    )
                c = int(creator[row])
                wtable[sh, c] = row
                la_w[sh, c] = la[row]
                fd_w[sh, c] = fd[row]
                idx_w[sh, c] = index[row]
                coin_w[sh, c] = middle_bit(h)
                w_of_row[row] = sh * n + c
                if re.famous != Trilean.UNDEFINED:
                    fame_decided[sh, c] = True
                    famous[sh, c] = re.famous == Trilean.TRUE
            rounds_decided[sh] = ri.witnesses_decided()

        self.state = state_from_arrays(dict(
            la=la, fd=fd, creator=creator, index=index, rounds=rounds,
            lamport=lamport, witness=witness, received=received,
            w_of_row=w_of_row, wtable=wtable, la_w=la_w, fd_w=fd_w,
            idx_w=idx_w, coin_w=coin_w, fame_decided=fame_decided,
            famous=famous, rounds_decided=rounds_decided,
            last_round=np.int32(last_abs - base), count=np.int32(len(kept)),
            stale=np.bool_(False), fame_lag=np.bool_(False),
        ), self.device)
        self.row_of = new_row_of
        self.hashes = new_hashes
        self.round_base = base

    # -- advancing ---------------------------------------------------------

    def advance(self) -> List[int]:
        """Append all events inserted since the last call; returns their
        device rows.

        Hybrid dispatch: a normal gossip sync stages 1-2 batches and goes
        through the straight-line ``step`` program (cheapest per small
        append); a catch-up burst (3+ batches) is stacked into
        ``multi_step`` trains — one device program per up to 16 batches —
        padded with no-op batches to two fixed shapes (K=4/K=16) so the
        live path compiles at most three programs."""
        if not self.pending:
            return []
        self._pack = None
        clock = self.hg.obs.clock
        t0 = clock.monotonic()
        drained, self.pending = self.pending, []
        new_rows: List[int] = []
        if len(self.hashes) + len(drained) > self.e_cap:
            raise GridUnsupported("device event capacity exhausted")

        # greedy chunking: cap both the batch size and the within-batch
        # dependency depth (a creator chaining deeply in one sync would
        # otherwise exceed the level table — split instead of failing)
        built: List[Batch] = []
        pos = 0
        while pos < len(drained):
            chunk = drained[pos : pos + self.batch_cap]
            chunk = self._depth_cut(chunk)
            pos += len(chunk)
            batch, rows = self._build_batch(chunk)
            built.append(batch)
            new_rows.extend(rows)

        led = self.hg.obs.devledger
        layout = "packed" if self.packed else "wide"
        # batch building is the live rung's host staging work; the step/
        # multi_step launches below are attributed by their own seams
        led.component("live", "stage", clock.monotonic() - t0, layout=layout)
        # the call's last decide also packs the results (K13's layout)
        vec, lo = self._pack_target()
        with led.activate("live", layout=layout):
            if len(built) <= 2:
                for j, b in enumerate(built):
                    last = j == len(built) - 1
                    self.state = ledger_call(
                        "_step_full", step,
                        self.state, b, self.hg.super_majority, self.n,
                        e_win=self.e_win, r_win=self.r_win,
                        packed=self.packed, pack=vec if last else None, pack_lo=lo,
                    )
                    self.dispatches += 1
            else:
                for i in range(0, len(built), 16):
                    group = built[i : i + 16]
                    last = i + 16 >= len(built)
                    k = 4 if len(group) <= 4 else 16
                    group = group + [self._empty_batch()] * (k - len(group))
                    self.state = ledger_call(
                        "multi_step", multi_step,
                        self.state, stack_batches(group),
                        self.hg.super_majority, self.n, e_win=self.e_win,
                        r_win=self.r_win, packed=self.packed,
                        pack=vec if last else None, pack_lo=lo,
                    )
                    self.dispatches += 1
        self._pack = (vec, len(self.hashes))
        dt = clock.monotonic() - t0
        led.component("live", "stage", dt, layout=layout)
        self._m_dispatch.observe(dt)
        self.hg.obs.tracer.record(
            "device.dispatch", t0, dt,
            {"node": self.hg.obs.node_id, "batches": len(built)},
        )
        return new_rows

    def _empty_batch(self) -> Batch:
        """A no-op Batch (every scatter drops) for padding multi_step
        groups to their fixed stack shapes."""
        cached = getattr(self, "_empty_batch_cache", None)
        if cached is not None:
            return cached
        b = empty_batch(self.n, self.batch_cap, self.upd_cap, self.e_cap)
        self._empty_batch_cache = b
        return b

    def _depth_cut(self, chunk):
        """Longest prefix of `chunk` whose within-chunk dependency depth
        stays under the level-table height."""
        depth: Dict[str, int] = {}
        for k, (ev, _) in enumerate(chunk):
            d = 0
            for parent in (ev.self_parent(), ev.other_parent()):
                if parent in depth:
                    d = max(d, depth[parent] + 1)
            if d >= L_MAX:
                return chunk[:k]
            depth[ev.hex()] = d
        return chunk

    def _build_batch(self, chunk) -> Tuple[Batch, List[int]]:
        n, b_cap = self.n, self.batch_cap
        b = len(chunk)
        rows = []
        creator = np.zeros(b_cap, dtype=np.int32)
        index = np.full(b_cap, MAX_INT32, dtype=np.int32)
        sp_row = np.full(b_cap, -1, dtype=np.int32)
        op_row = np.full(b_cap, -1, dtype=np.int32)
        la_rows = np.full((b_cap, n), -1, dtype=np.int32)
        coin = np.zeros(b_cap, dtype=bool)
        fixed_round = np.full(b_cap, -1, dtype=np.int32)
        upd: List[Tuple[int, int, int]] = []

        from ..hashgraph.hashgraph import middle_bit

        for k, (ev, fd_writes) in enumerate(chunk):
            row = len(self.hashes)
            h = ev.hex()
            self.row_of[h] = row
            self.hashes.append(h)
            rows.append(row)

            creator[k] = self.hg.peer_position(ev.creator())
            index[k] = ev.index()
            sp = self.row_of.get(ev.self_parent(), -1)
            op = self.row_of.get(ev.other_parent(), -1)
            if sp < 0 and ev.index() != 0:
                # a rebased engine dropped decided history: a creator
                # reviving after rounds of silence has a pruned self-parent
                raise GridUnsupported("self-parent outside device state")
            if op < 0 and ev.other_parent() != "":
                raise GridUnsupported("other-parent outside device state")
            if sp < 0 and ev.other_parent() == "":
                # directly root-attached: round forced to the base root's
                # next_round (reference: hashgraph.go:207-236); first
                # events WITH an other-parent compute theirs normally.
                # Rounds are base-relative on device; genesis attachment
                # can only occur before any rebase (base 0).
                if self.round_base > 0:
                    raise GridUnsupported("root attachment after rebase")
                fixed_round[k] = 0
            sp_row[k] = sp
            op_row[k] = op
            la_rows[k] = [c[0] for c in ev.last_ancestors]
            coin[k] = middle_bit(h)
            for ah, pos, val in fd_writes:
                arow = self.row_of.get(ah)
                if arow is None:
                    # pruned-by-rebase ancestor: its fd row is final and
                    # can never be read again — drop the update. (fd
                    # writes come from the hashgraph's own insert walk,
                    # so the hash is always a real ancestor.)
                    continue
                upd.append((arow, pos, val))

        if len(upd) > self.upd_cap:
            raise GridUnsupported("fd update burst exceeds device staging")

        # within-batch levels over batch-local dependencies
        base_row = rows[0]
        lvl = np.zeros(b, dtype=np.int64)
        for k in range(b):
            d = 0
            for parent in (int(sp_row[k]), int(op_row[k])):
                if parent >= base_row:
                    d = max(d, lvl[parent - base_row] + 1)
            lvl[k] = d
        # caller (_depth_cut) guarantees depth < L_MAX
        levels = np.full((L_MAX, b_cap), -1, dtype=np.int32)
        slot = np.zeros(L_MAX, dtype=np.int64)
        for k in range(b):
            levels[lvl[k], slot[lvl[k]]] = k
            slot[lvl[k]] += 1

        urow = np.full(self.upd_cap, self.e_cap, dtype=np.int32)
        ucol = np.zeros(self.upd_cap, dtype=np.int32)
        uval = np.zeros(self.upd_cap, dtype=np.int32)
        for k, (r, c, v) in enumerate(upd):
            urow[k], ucol[k], uval[k] = r, c, v

        brows = np.full(b_cap, -1, dtype=np.int32)
        brows[:b] = rows
        return (
            Batch(
                rows=brows, creator=creator, index=index,
                sp_row=sp_row, op_row=op_row, la_rows=la_rows, coin=coin,
                fixed_round=fixed_round,
                upd_row=urow, upd_col=ucol, upd_val=uval, levels=levels,
            ),
            rows,
        )


# K13's plain version (tpu/incremental.py, where the decide's CPU route
# packs too)
_pack_results_plain = pack_results_plain


def _pack_results(st: IncState, lo: int, e_win: int, r_cap: int,
                  n: int) -> torch.Tensor:
    """K13 (babble_tpu/tpu/live.py:757): everything the host write-back
    reads, flattened into ONE fresh int32 vector on the state's device (a
    single transfer instead of nine). CPU: the plain version; CUDA:
    csrc/pack_results.cu."""
    if st.rounds.device.type == "cpu":
        return _pack_results_plain(st, lo, e_win, r_cap, n)
    if tuple(st.wtable.shape) != (r_cap, n):
        raise ValueError(
            f"pack_results: wtable {tuple(st.wtable.shape)} is not ({r_cap}, {n})"
        )
    return _ext.pack_results(
        st.rounds, st.lamport, st.witness, st.received, st.wtable,
        st.fame_decided, st.famous, st.stale, st.fame_lag, st.last_round,
        int(lo), e_win,
    )


def _unpack_results(packed, e_win: int, r_cap: int, n: int):
    o = 0
    def take(sz, shape=None):
        nonlocal o
        part = packed[o : o + sz]
        o += sz
        return part if shape is None else part.reshape(shape)
    rounds_w = take(e_win)
    lamport_w = take(e_win)
    witness_w = take(e_win).astype(bool)
    received_w = take(e_win)
    wtable = take(r_cap * n, (r_cap, n))
    fame_decided = take(r_cap * n, (r_cap, n)).astype(bool)
    famous = take(r_cap * n, (r_cap, n)).astype(bool)
    flags = take(3)
    return (rounds_w, lamport_w, witness_w, received_w, wtable,
            fame_decided, famous, bool(flags[0]), bool(flags[1]),
            int(flags[2]))


def run_consensus_live(hg, queue_depth: int = None,
                       batch_deadline: float = None,
                       batch_cap: int = None,
                       device: Optional[Union[str, torch.device]] = None) -> None:
    """Incremental device consensus for a live node: advance the persistent
    state by the events inserted since the last call, then write decisions
    back and run the host passes (mirrors engine.run_consensus_device's
    write-back, restricted to new/undetermined work).

    The engine is created on the first call, on `device` (the CUDA card
    unless the caller passes "cpu"; a host without CUDA raises); later
    calls use the engine's device.

    Two fetch disciplines (a slow fetch must not serialize gossip):

    - synchronous (default): dispatch, fetch, integrate, all in this call.
      Correct everywhere and cheapest when the device is colocated.
    - pipelined (self-activating): when the measured blocking fetch is
      expensive (threshold ASYNC_FETCH_MIN_S over 3
      consecutive calls), the fetch moves OFF the consensus critical
      path: up to ``queue_depth`` dispatches ride concurrently, each
      call integrating the OLDEST dispatch's results (already resident
      host-side via a side-stream copy and a reader thread) and launching a new
      dispatch whose transfer overlaps the next gossip intervals.
      Decisions lag up to queue_depth syncs — pure timing, not content:
      rounds, fame, and receptions are DAG facts, so block bodies stay
      byte-identical (pinned by the strict joiner differentials), they
      just seal a few calls later. The write-back validation gates run
      unchanged at integration time against a dispatch-time snapshot of
      the row mapping (rebases build fresh containers, so snapshots are
      O(1) references), and integration order is FIFO so parents' rounds
      always land before children's. Integration TRIGGERS are
      deterministic (queue occupancy and call sequence, never thread
      completion state) so same-seed sim runs stay byte-identical.
    """
    dev = resolve_device(device)
    eng: Optional[LiveDeviceEngine] = getattr(hg, "_live_device_engine", None)
    if eng is None:
        eng = LiveDeviceEngine(
            hg, queue_depth=queue_depth, batch_deadline=batch_deadline,
            batch_cap=batch_cap, device=dev,
        )
        hg._live_device_engine = eng
        # the bootstrap replayed the whole pre-existing DAG on device; its
        # rows still need the host write-back — the attach call is always
        # synchronous so the node leaves it with a fully written store
        new_rows = list(range(len(eng.hashes)))
        new_rows.extend(eng.advance())
        _run_sync(hg, eng, new_rows)
        return
    if eng.async_fetch:
        _run_pipelined(hg, eng)
    else:
        _run_sync(hg, eng, eng.advance())


# blocking-fetch cost that flips an engine to the pipelined discipline
# (3 consecutive calls over the threshold); ENGINE_DEFAULTS["async_fetch"]
# forces True/False for tests
ASYNC_FETCH_MIN_S = 0.010


_FETCH_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _fetch_stream(dev: torch.device):
    """One side stream per card for the pipelined result copies."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    st = _FETCH_STREAMS.get(idx)
    if st is None:
        st = _FETCH_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return st


class _AsyncFetch:
    """Background device->host reader for one dispatch's packed results.

    On the card: an event recorded after K13 on the compute stream, a side
    stream that waits on it and copies into pinned host memory without
    blocking, and a reader thread that waits on the copy's event and hands
    the numpy array over. The device buffer is held (and recorded on the
    side stream for the caching allocator) until the copy is done. On the
    CPU the thread copies the tensor."""

    def __init__(self, device_array: torch.Tensor):
        self.done = threading.Event()
        # unguarded-ok: Event handoff — _run's writes happen-before
        # done.set(), and result() reads only after done.wait()
        self.value = None
        # unguarded-ok: same Event handoff as value
        self.error: Optional[BaseException] = None
        copied = host = None
        dev = device_array.device
        if dev.type == "cuda":
            launched = torch.cuda.Event()
            launched.record(torch.cuda.current_stream(dev))
            side = _fetch_stream(dev)
            host = torch.empty(
                device_array.shape, dtype=device_array.dtype, pin_memory=True
            )
            with torch.cuda.stream(side):
                side.wait_event(launched)
                host.copy_(device_array, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            device_array.record_stream(side)
        # unguarded-ok: released by the reader thread only, after the copy
        self._hold = device_array
        threading.Thread(
            target=self._run, args=(dev, copied, host), name="live-fetch",
            daemon=True,
        ).start()

    def _run(self, dev, copied, host) -> None:
        try:
            if copied is None:
                self.value = self._hold.numpy()
            else:
                torch.cuda.set_device(dev)
                copied.synchronize()
                self.value = host.numpy()
        except BaseException as e:  # noqa: BLE001 — surfaced in result()
            self.error = e
        finally:
            self._hold = None
            self.done.set()

    def result(self):
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.value


def _snapshot(eng: LiveDeviceEngine, new_rows: List[int]) -> dict:
    """Dispatch-time view the integration needs: row mapping references,
    the fetch window, the round base, and the insertion high-water mark
    that separates 'inserted after this dispatch' from 'lost by staging'.

    hashes/row_of are the LIVE objects — advance() appends to both in
    place — so `count` is the consistency fence: any row >= count was
    appended after this dispatch and must be ignored by readers of this
    snapshot (_covered enforces it). Rebases REPLACE both objects, so a
    snapshot taken before a rebase keeps the pre-rebase view intact."""
    count = len(eng.hashes)
    return dict(
        new_rows=new_rows,
        hashes=eng.hashes,
        row_of=eng.row_of,
        count=count,
        lo=max(count - eng.e_win, 0),
        base=eng.round_base,
        topo_hi=eng.hg.topological_index,
    )


def _dispatch(eng: LiveDeviceEngine, new_rows: List[int]):
    """The packed results of the current device state: the vector the last
    advance's last decide wrote, where nothing has written the state since
    (its row count must be the snapshot's: it raises otherwise), else a
    launch of K13 of its own. Returns (device_array, snapshot); does NOT
    block on the transfer."""
    snap = _snapshot(eng, new_rows)
    stash, eng._pack = eng._pack, None
    if stash is not None:
        vec, count = stash
        if count != snap["count"]:
            raise RuntimeError(f"live: the decide packed {count} rows, the snapshot holds "
                               f"{snap['count']}")
        eng.packs["fused"] += 1
        return vec, snap
    with eng.hg.obs.devledger.activate(
        "live", layout="packed" if eng.packed else "wide",
    ):
        packed = ledger_call(
            "_pack_results", _pack_results,
            eng.state, snap["lo"], eng.e_win, eng.r_cap, eng.n,
        )
    eng.packs["own"] += 1
    return packed, snap


def _run_sync(hg, eng: LiveDeviceEngine, new_rows: List[int]) -> None:
    """Dispatch + blocking fetch + integrate, all under the caller's core
    lock (the original discipline)."""
    clock = hg.obs.clock
    packed_dev, snap = _dispatch(eng, new_rows)
    t0 = clock.monotonic()
    packed = packed_dev.cpu().numpy()
    dt = clock.monotonic() - t0
    eng._m_fetch.observe(dt)
    hg.obs.devledger.component(
        "live", "fetch", dt, layout="packed" if eng.packed else "wide",
    )
    hg.obs.tracer.record(
        "device.fetch", t0, dt, {"node": hg.obs.node_id},
    )
    eng.consensus_calls += 1

    last_round_rel = _integrate(hg, eng, packed, snap)
    hg.process_decided_rounds()
    hg.process_sig_pool()
    _manage_capacity(eng, last_round_rel)

    # self-activation of the pipelined discipline on consistently slow
    # fetches; ENGINE_DEFAULTS["async_fetch"] pins it
    forced = ENGINE_DEFAULTS.get("async_fetch")
    if forced is False:
        return
    if dt > ASYNC_FETCH_MIN_S:
        eng._slow_fetches += 1
    else:
        eng._slow_fetches = 0
    if forced is True or eng._slow_fetches >= 3:
        eng.async_fetch = True


def _integrate_oldest(hg, eng: LiveDeviceEngine) -> int:
    """Pop + integrate the oldest in-flight dispatch (FIFO — parents'
    rounds land before children's). Blocks only if the background reader
    has not finished; the blocked fraction of the dispatch's in-flight
    wall time feeds the overlap-utilization histogram."""
    clock = hg.obs.clock
    fetch, snap, t_disp = eng.inflight.pop(0)
    t0 = clock.monotonic()
    packed = fetch.result()  # normally already resident
    dt = clock.monotonic() - t0
    eng._m_fetch.observe(dt)
    hg.obs.devledger.component(
        "live", "fetch", dt, layout="packed" if eng.packed else "wide",
    )
    in_flight = max(t0 + dt - t_disp, 1e-9)
    eng._m_overlap.observe(max(0.0, min(1.0, 1.0 - dt / in_flight)))
    hg.obs.tracer.record(
        "device.fetch", t0, dt, {"node": hg.obs.node_id},
    )
    hg.obs.flightrec.record(
        "live.integrate", blocked=dt, depth=len(eng.inflight),
    )
    eng.consensus_calls += 1
    return _integrate(hg, eng, packed, snap)


def _settle_capacity(hg, eng: LiveDeviceEngine, last_round_rel: int) -> None:
    """Rebase barrier: a rebase must NEVER run with a dispatch in flight
    (it replaces the row containers the in-flight snapshots alias and
    reads store rounds the pending integrations have not written yet).
    On capacity pressure the queue therefore drains fully — blocking
    FIFO integration — before _manage_capacity may rebase."""
    if not _capacity_soft(eng, last_round_rel):
        return
    while eng.inflight:
        last_round_rel = _integrate_oldest(hg, eng)
    _manage_capacity(eng, last_round_rel)


def flush_live_engine(hg) -> None:
    """Blocking barrier: integrate every in-flight live-engine dispatch
    (callers and benches run it before asserting on store state)."""
    eng: Optional[LiveDeviceEngine] = getattr(hg, "_live_device_engine", None)
    if eng is None or not eng.inflight:
        return
    last_round_rel = 0
    while eng.inflight:
        last_round_rel = _integrate_oldest(hg, eng)
    _manage_capacity(eng, last_round_rel)
    hg.process_decided_rounds()
    hg.process_sig_pool()


def _run_pipelined(hg, eng: LiveDeviceEngine) -> None:
    """Multi-slot overlap: keep up to queue_depth dispatches in flight,
    integrating the oldest when the queue is full (steady state:
    integrate N-1, dispatch N) or when gossip staged nothing this call
    (so the queue drains when traffic quiets). Both triggers are
    functions of queue occupancy and the call sequence — never of
    whether a background fetch happens to have finished — so the
    integration schedule is deterministic under the sim's virtual clock.
    """
    clock = hg.obs.clock
    depth = max(1, eng.queue_depth)
    while len(eng.inflight) >= depth:
        _settle_capacity(hg, eng, _integrate_oldest(hg, eng))

    # cross-round dispatch batching: hold gossip-staged rows (all of
    # them — a partial drain would strand events no snapshot models)
    # until batch_cap rows accumulate or the Clock deadline passes
    hold = (
        eng.batch_deadline > 0.0
        and eng.pending
        and len(eng.pending) < eng.batch_cap
        and eng._pending_since is not None
        and clock.monotonic() - eng._pending_since < eng.batch_deadline
    )
    dispatched = False
    if not hold:
        new_rows = eng.advance()
        if new_rows:
            packed_dev, snap = _dispatch(eng, new_rows)
            eng.inflight.append(
                (_AsyncFetch(packed_dev), snap, clock.monotonic())
            )
            dispatched = True
            hg.obs.flightrec.record(
                "live.dispatch", rows=len(new_rows),
                depth=len(eng.inflight),
            )
    if not dispatched and eng.inflight:
        _settle_capacity(hg, eng, _integrate_oldest(hg, eng))
    eng._m_qdepth.set(float(len(eng.inflight)))

    hg.process_decided_rounds()
    hg.process_sig_pool()


def _integrate(hg, eng: LiveDeviceEngine, packed, snap: dict) -> int:
    """Write one dispatch's results into the host hashgraph, behind the
    same validation gates as the one-shot engine. Returns the dispatch's
    last_round (base-relative) for capacity management.

    All row arithmetic uses the dispatch-time snapshot: under the
    pipelined discipline the engine may have appended further rows since,
    and those are simply not covered here (the next integration handles
    them)."""
    from ..common import StoreErr, StoreErrType, is_store_err
    from ..hashgraph import PendingRound, RoundInfo

    _led = hg.obs.devledger
    _ti0 = _led.now()
    count, lo, base = snap["count"], snap["lo"], snap["base"]
    if base != eng.round_base:
        # rebases are ordered strictly between integrations; a mismatch
        # means the discipline was violated somewhere — refuse to stamp
        raise GridUnsupported(
            f"integration base {base} != engine base {eng.round_base}"
        )
    (rounds_w, lamport_w, witness_w, received_w, wtable, fame_decided,
     famous, stale, fame_lag, last_round_rel) = _unpack_results(
        packed, eng.e_win, eng.r_cap, eng.n)
    hashes = snap["hashes"]
    new_rows = snap["new_rows"]
    rounds_w = rounds_w[: count - lo]
    lamport_w = lamport_w[: count - lo]
    witness_w = witness_w[: count - lo]
    received_w = received_w[: count - lo]
    if bool(stale) or bool(fame_lag):
        eng.detach()
        hg._live_device_engine = None
        raise GridUnsupported(
            "device window/unroll exhausted; rebuilding via one-shot path"
        )

    def at(row, arr):
        if row < lo:
            raise GridUnsupported("decision row below fetch window")
        return arr[row - lo]

    # --- DivideRounds write-back for the new events -----------------------
    # boundary gate: validate the whole batch before stamping (a wrong
    # round poisons the write-once host round function; see
    # engine.validate_round_writeback) — violations demote this engine
    from .engine import validate_round_writeback

    # host-known rounds are AUTHORITATIVE: never re-stamp them (a fresh
    # attach write-back covers every staged row, including rows below the
    # engine base whose device-side round is a sentinel)
    def _fresh_rows():
        for row in new_rows:
            if hg.store.get_event(hashes[row]).round is None:
                yield row

    validate_round_writeback(
        hg,
        (
            (
                hashes[row],
                (int(at(row, rounds_w)) + base, int(at(row, lamport_w))),
            )
            for row in _fresh_rows()
        ),
    )
    undetermined = set(hg.undetermined_events)
    round_infos: Dict[int, RoundInfo] = {}
    # decision provenance (obs/provenance.py): cells captured from the
    # fetched host buffers / host store only — no extra device syncs
    prov = hg.obs.provenance
    prov_cells = 0
    for row in new_rows:
        h = hashes[row]
        ev = hg.store.get_event(h)
        if ev.round is None:
            rnum = int(at(row, rounds_w)) + base
            ev.set_round(rnum)
            ev.set_lamport_timestamp(int(at(row, lamport_w)))
            hg.store.set_event(ev)
        else:
            rnum = ev.round
        if h in undetermined:
            if ev.lamport_timestamp is not None and ev.last_ancestors is not None:
                prov_cells += prov.note_event(
                    h, rnum, ev.lamport_timestamp, ev.last_ancestors,
                )
            if bool(at(row, witness_w)):
                prov_cells += prov.note_witness(
                    h, rnum, hg.peer_position(ev.creator()),
                )
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
                hg.last_consensus_round is None
                or rnum >= hg.last_consensus_round
            ):
                hg.pending_rounds.append(PendingRound(rnum, False))
                ri.queued = True
            ri.add_event(h, bool(at(row, witness_w)))

    # --- DecideFame write-back (pending rounds only) ----------------------
    delegated = hg.reset_floor is not None
    if delegated:
        # post-reset delegation, same reasoning as engine.py: fame and
        # reception decision TIMING must match the host call-for-call or
        # block composition skews between backends. Falls through to the
        # capacity management — the engine still windows (rebases) like
        # any other.
        for rnum, ri in round_infos.items():
            hg.store.set_round(rnum, ri)
        hg.decide_fame()
        hg.decide_round_received()
    decided_rounds = set()
    for pr in ([] if delegated else hg.pending_rounds):
        ri = round_infos.get(pr.index)
        if ri is None:
            ri = hg.store.get_round(pr.index)
            round_infos[pr.index] = ri
        sh = pr.index - base
        if 0 <= sh < eng.r_cap:
            for c in range(eng.n):
                wrow = int(wtable[sh, c])
                if wrow < 0:
                    continue
                if fame_decided[sh, c]:
                    ri.set_fame(hashes[wrow], bool(famous[sh, c]))
                    prov_cells += prov.note_fame(
                        hashes[wrow], pr.index, bool(famous[sh, c]),
                        engine="live",
                    )
        if ri.witnesses_decided():
            decided_rounds.add(pr.index)
    for pr in hg.pending_rounds:
        if pr.index in decided_rounds:
            pr.decided = True

    # --- DecideRoundReceived write-back (undetermined only) ---------------
    from .engine import admissible_receptions

    def _covered(h):
        """Row for h in THIS dispatch, None if h postdates it (pipelined
        lag: the next integration covers it), or GridUnsupported if the
        staging genuinely lost it."""
        row = snap["row_of"].get(h)
        if row is not None:
            if row >= snap["count"]:
                # appended to the live row_of AFTER this dispatch (the
                # snapshot aliases the live dict); the packed results
                # don't model it yet — next integration covers it
                return None
            return row
        try:
            ev = hg.store.get_event(h)
        except StoreErr:
            ev = None
        if ev is not None and ev.topological_index >= snap["topo_hi"]:
            return None  # inserted after this dispatch
        # every undetermined event known at dispatch time must be modeled
        # (the attach keeps undetermined events regardless of round);
        # anything unmodeled means the staging walk silently lost one —
        # demote rather than silently never receiving it (that skews
        # block composition)
        raise GridUnsupported(f"undetermined event unmodeled ({h[:18]}…)")

    def _proposed_receptions():
        for h in hg.undetermined_events:
            row = _covered(h)
            if row is None:
                continue
            rr = int(at(row, received_w))
            if rr >= 0:
                yield h, rr + base

    if not delegated:
        if admissible_receptions(hg, round_infos, _proposed_receptions()):
            new_undetermined = []
            for h in hg.undetermined_events:
                row = _covered(h)
                rr = -1 if row is None else int(at(row, received_w))
                if rr >= 0:
                    rr += base
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
            # the device "unblocked" a reception the host rule refuses
            # (frozen/missing rounds): persist the fame state and run the
            # HOST's reception pass this call — exact host timing, so
            # block composition cannot skew (engine.admissible_receptions)
            for rnum, ri in round_infos.items():
                hg.store.set_round(rnum, ri)
            hg.decide_round_received()

    if prov_cells:
        prov.mark("prov.capture", engine="live", cells=prov_cells)
    _led.component(
        "live", "integrate", _led.now() - _ti0,
        layout="packed" if eng.packed else "wide",
    )
    return last_round_rel


def _capacity_soft(eng: LiveDeviceEngine, last_round_rel: int) -> bool:
    """Soft capacity-pressure predicate: the round axis needs headroom
    for fame-decision lag (~8 rounds), the event axis for the next few
    syncs' appends. len(eng.hashes) is the LIVE count, so rows appended
    by still-queued dispatches are included (conservative)."""
    return (
        last_round_rel >= eng.r_cap - 8
        or len(eng.hashes) >= eng.e_cap - 4 * eng.batch_cap
    )


def _manage_capacity(eng: LiveDeviceEngine, last_round_rel: int) -> None:
    """Rebase BEFORE either device axis exhausts. A momentarily-stuck
    rebase (fame decisions lagging, so the base cannot advance yet) is
    tolerated while hard room remains — it is retried on every
    subsequent sync; only an exhausted axis escalates to the caller's
    fallback. Under the queued discipline last_round_rel is up to
    queue_depth dispatches old; the soft margin (8 rounds) absorbs the
    lag, and the caller (_settle_capacity) guarantees the in-flight
    queue is empty before this may rebase."""
    hard = (
        last_round_rel >= eng.r_cap - 3
        or len(eng.hashes) >= eng.e_cap - eng.batch_cap
    )
    if _capacity_soft(eng, last_round_rel):
        try:
            eng.rebase()
        except GridUnsupported:
            if hard:
                raise
