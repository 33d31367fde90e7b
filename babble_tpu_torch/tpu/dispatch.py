"""Async mesh dispatch queue: the sharded multi-device backend as a rung of
a live node's backend ladder (counterpart of babble_tpu/tpu/dispatch.py).

The serve path stages the grid (host work, delta rows only, through the
resident `GridStager`) and hands the whole sharded pass to a background
worker thread, so the device work rides the gossip intervals instead of
the serve path. Up to ``queue_depth`` dispatches are in flight at once;
the serve path blocks only to integrate the oldest when the queue is full
or when gossip staged nothing new. On a CUDA mesh each worker launches on
a stream of its own on the mesh's card.

Determinism discipline (byte-equality across same-seed runs depends on it):

- integration TRIGGERS are functions of queue occupancy and the call
  sequence, never of whether a worker happens to have finished, so
  same-seed runs integrate on the same serve call every time;
- the injected Clock is read ONLY on the serve thread;
- results are DAG facts (rounds/fame/receptions), so dispatch lag shifts
  WHEN blocks seal, never their contents.

Scope: base-state hashgraphs only. Post-reset states (reset_floor set)
refuse at once, so the ladder falls to the synchronous one-shot mesh path,
whose host delegation keeps call-for-call decision timing. Any failure
discards the in-flight results wholesale: nothing was stamped, so the
one-shot restage recomputes everything.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from .grid import GridStager, GridUnsupported

# size threshold for cross-round dispatch batching: with a deadline set,
# staged events are held until this many accumulate (or the deadline
# passes), so one dispatch amortizes the walk across syncs
MESH_BATCH_ROWS = 64

# One mesh, one program: two sharded passes in flight on the same
# positions would interleave their collectives. Workers take this
# process-wide lock around execution; staging and integration still
# overlap gossip, only device programs serialize among themselves.
_MESH_EXEC_LOCK = threading.Lock()


class _AsyncPass:
    """Background worker running one sharded three-pass pipeline. All
    device work and its host syncs (the fetches, the frontier r_cap retry)
    happen on this thread; the serve thread only blocks in result()."""

    def __init__(self, mesh, grid, prefer_doubling: bool = False,
                 packed=None, ledger=None):
        self.done = threading.Event()
        # written by _run before done.set(); read by result() after done.wait()
        self.value = None
        self.error: Optional[BaseException] = None
        # the device-time ledger: the worker re-activates it on its own
        # thread (thread-locals do not cross the spawn)
        self._ledger = ledger
        # layout resolved at dispatch time, so a knob flip cannot split one
        # queued pipeline across layouts
        from .packed import resolve_packed

        packed = resolve_packed(packed, grid.n)
        self.layout = "packed" if packed else "wide"
        threading.Thread(
            target=self._run, args=(mesh, grid, prefer_doubling, packed),
            name="mesh-dispatch", daemon=True,
        ).start()

    def _run(self, mesh, grid, prefer_doubling: bool, packed: bool) -> None:
        try:
            from .doubling import use_doubling
            from .engine import _frontier_safe
            from .sharded import (
                sharded_doubling_passes,
                sharded_frontier_passes,
                sharded_run_passes,
            )

            seam = (
                self._ledger.activate("mesh_queued", layout=self.layout)
                if self._ledger is not None
                else contextlib.nullcontext()
            )
            dev = mesh.device
            stream = (torch.cuda.stream(torch.cuda.Stream(dev)) if dev.type == "cuda"
                      else contextlib.nullcontext())
            # seam outside the exec lock: time queued behind another
            # worker's dispatch is part of what the integrator sees blocked
            with seam, _MESH_EXEC_LOCK, stream:
                # a batched dispatch (prefer_doubling) lowers the cold-path
                # crossover: one doubling train amortizes the whole batch
                if use_doubling(grid, prefer=prefer_doubling):
                    try:
                        self.value = sharded_doubling_passes(mesh, grid, packed=packed)
                    except GridUnsupported:
                        self.value = None
                if self.value is None:
                    if _frontier_safe(grid):
                        self.value = sharded_frontier_passes(mesh, grid, packed=packed)
                    else:
                        self.value = sharded_run_passes(mesh, grid, packed=packed)
        except BaseException as e:  # noqa: BLE001 — surfaced in result()
            self.error = e
        finally:
            self.done.set()

    def result(self):
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.value


class MeshDispatchQueue:
    """Bounded FIFO of in-flight sharded dispatches for one live node.

    Each entry is (worker, grid, topo_hi, t_dispatch): the grid is the
    staging-time view the integration stamps against, topo_hi the
    insertion high-water mark separating "inserted after this dispatch"
    from "lost by staging" (engine.integrate_pass_results), t_dispatch
    the Clock time the overlap-utilization histogram is computed from.
    """

    def __init__(self, hg, mesh, queue_depth: int = 4,
                 batch_deadline: float = 0.0,
                 batch_rows: int = MESH_BATCH_ROWS):
        self.hg = hg
        self.mesh = mesh
        self.queue_depth = max(1, queue_depth)
        self.batch_deadline = batch_deadline
        self.batch_rows = max(1, int(batch_rows))
        self.inflight: List[tuple] = []
        self.serves = 0
        self.dispatches = 0
        self.integrations = 0
        self._last_topo = 0  # insertion high-water mark at last dispatch
        self._pending_since: Optional[float] = None
        # resident staging: the grid arrays live across dispatches; each
        # dispatch appends only the delta rows
        self.stager = GridStager(hg)
        # highest round integrated so far (rounds per dispatch is its
        # delta across integrations, a DAG fact)
        self._last_round_seen = -1
        obs = hg.obs
        self._m_stage = obs.histogram(
            "babble_device_stage_seconds",
            "Host staging (restage) time per device consensus call",
            labels=("path",),
        )
        self._m_run = obs.histogram(
            "babble_device_run_seconds",
            "Device wall time per device consensus call",
            labels=("path",),
        )
        self._m_dispatch = obs.histogram(
            "babble_device_dispatch_seconds",
            "Host-side device program launch time per advance",
        )
        self._m_qdepth = obs.gauge(
            "babble_device_queue_depth",
            "Device dispatches currently in flight in the async queue",
        )
        self._m_overlap = obs.histogram(
            "babble_device_overlap_utilization",
            "Fraction of each dispatch's in-flight time overlapped with "
            "gossip (1.0 = the fetch never blocked the serve path)",
            buckets=[i / 10 for i in range(11)],
        )
        from ..obs.metrics import DEFAULT_COUNT_BUCKETS

        self._m_batch_rows = obs.histogram(
            "babble_mesh_batch_rows",
            "Delta event rows staged per mesh dispatch (the cross-round "
            "batch size)",
            buckets=DEFAULT_COUNT_BUCKETS,
        )
        self._m_rounds_per_dispatch = obs.histogram(
            "babble_mesh_rounds_per_dispatch",
            "Consensus rounds newly covered per integrated mesh dispatch",
            buckets=DEFAULT_COUNT_BUCKETS,
        )

    # -- lifecycle ---------------------------------------------------------

    def detach(self) -> None:
        """Discard every in-flight dispatch. Nothing was stamped from
        them, so the next path down the ladder recomputes from the store;
        the orphaned workers finish in the background and are dropped."""
        if self.inflight:
            self.hg.obs.flightrec.record(
                "dispatch.detach", discarded=len(self.inflight),
                dispatches=self.dispatches,
            )
        self.inflight = []

    def quiesce(self) -> None:
        """Wait for every in-flight worker to finish, then discard the
        results unstamped. Shutdown only; unlike flush() this never
        touches the hashgraph."""
        for task, _grid, _topo_hi, _t in self.inflight:
            task.done.wait()
        self.inflight = []

    def flush(self) -> None:
        """Blocking barrier: integrate every in-flight dispatch, then
        dispatch-and-integrate anything still staged."""
        hg = self.hg
        while self.inflight:
            self._integrate_oldest()
        if hg.topological_index > self._last_topo:
            self._dispatch()
            while self.inflight:
                self._integrate_oldest()
        hg.process_decided_rounds()
        hg.process_sig_pool()

    # -- serving -----------------------------------------------------------

    def serve(self) -> None:
        """One consensus call on the queued-mesh rung: integrate the
        oldest dispatch if the queue is full, stage-and-dispatch new
        gossip (subject to the batching gate), and drain one slot when
        gossip staged nothing (so the queue empties as traffic quiets)."""
        hg = self.hg
        if hg.reset_floor is not None:
            # post-reset decision timing is delegated to the host
            # call-for-call by the synchronous one-shot mesh path
            raise GridUnsupported("queued mesh dispatch on post-reset state")
        clock = hg.obs.clock
        self.serves += 1
        while len(self.inflight) >= self.queue_depth:
            self._integrate_oldest()

        staged_behind = hg.topological_index - self._last_topo
        if staged_behind > 0 and self._pending_since is None:
            self._pending_since = clock.monotonic()
        # cross-round dispatch batching: hold staged rows until the size
        # or Clock-deadline threshold, so one dispatch covers many syncs
        hold = (
            self.batch_deadline > 0.0
            and 0 < staged_behind < self.batch_rows
            and self._pending_since is not None
            and clock.monotonic() - self._pending_since < self.batch_deadline
        )
        dispatched = False
        if staged_behind > 0 and not hold:
            dispatched = self._dispatch()
        if not dispatched and self.inflight:
            self._integrate_oldest()
        self._m_qdepth.set(float(len(self.inflight)))

        hg.process_decided_rounds()
        hg.process_sig_pool()

    def _dispatch(self) -> bool:
        """Stage the delta rows onto the resident grid on the serve thread
        and hand the sharded pass to a worker. Returns False when the grid
        is empty."""
        hg = self.hg
        clock = hg.obs.clock
        t0 = clock.monotonic()
        grid = self.stager.stage()  # GridUnsupported falls the ladder
        topo_hi = hg.topological_index
        dt = clock.monotonic() - t0
        self._m_stage.labels(path="mesh_queued").observe(dt)
        self._m_dispatch.observe(dt)
        self._last_topo = topo_hi
        self._pending_since = None
        if grid.e == 0:
            return False
        delta_rows = self.stager.last_delta_rows
        self._m_batch_rows.observe(float(delta_rows))
        # a full batch coalesced: route it down the log-diameter cold path
        batched = delta_rows >= self.batch_rows
        hg.obs.gauge(
            "babble_mesh_staged_events",
            "Events staged onto the mesh in the latest mesh call",
        ).set(grid.e)
        from .sharded import mesh_validator_shards

        hg.obs.gauge(
            "babble_mesh_validator_shards",
            "Validator-axis extent of the consensus mesh (1 = voting "
            "state unsharded over validators)",
        ).set(float(mesh_validator_shards(self.mesh)))
        hg.obs.tracer.record(
            "device.dispatch", t0, dt,
            {"node": hg.obs.node_id, "batches": 1, "rows": delta_rows},
        )
        from .packed import observe_table_bytes, resolve_packed

        pk = resolve_packed(None, grid.n)
        observe_table_bytes(hg.obs, grid.n, grid.r_max, pk)
        layout = "packed" if pk else "wide"
        hg.obs.devledger.component("mesh_queued", "stage", dt, layout=layout)
        self.inflight.append(
            (
                _AsyncPass(self.mesh, grid, prefer_doubling=batched, packed=pk,
                           ledger=hg.obs.devledger),
                grid, topo_hi, clock.monotonic(),
            )
        )
        self.dispatches += 1
        hg.obs.flightrec.record(
            "dispatch.enqueue", events=grid.e, topo_hi=topo_hi,
            depth=len(self.inflight), rows=delta_rows,
        )
        return True

    def _integrate_oldest(self) -> None:
        """Pop + integrate the oldest dispatch (FIFO: earlier stagings'
        rounds land before later ones that build on them). Blocks only if
        the worker has not finished; the blocked fraction feeds the
        overlap-utilization histogram and the blocked wall time is the
        queued path's `babble_device_run_seconds`."""
        from .engine import integrate_pass_results

        hg = self.hg
        clock = hg.obs.clock
        task, grid, topo_hi, t_disp = self.inflight.pop(0)
        t0 = clock.monotonic()
        res = task.result()
        dt = clock.monotonic() - t0
        self._m_run.labels(path="mesh_queued").observe(dt)
        in_flight = max(t0 + dt - t_disp, 1e-9)
        self._m_overlap.observe(max(0.0, min(1.0, 1.0 - dt / in_flight)))
        hg.obs.tracer.record(
            "device.fetch", t0, dt, {"node": hg.obs.node_id},
        )
        led = hg.obs.devledger
        layout = getattr(task, "layout", "wide")
        led.component("mesh_queued", "fetch", dt, layout=layout)
        _ti0 = clock.monotonic()
        integrate_pass_results(hg, grid, res, topo_hi=topo_hi,
                               engine="mesh-queued")
        led.component(
            "mesh_queued", "integrate", clock.monotonic() - _ti0,
            layout=layout,
        )
        self.integrations += 1
        # rounds newly covered by this dispatch: a DAG fact (last_round
        # delta), the same across same-seed runs whatever the worker timing
        new_rounds = max(0, int(res.last_round) - self._last_round_seen)
        self._last_round_seen = max(self._last_round_seen, int(res.last_round))
        self._m_rounds_per_dispatch.observe(float(new_rounds))
        hg.obs.flightrec.record(
            "dispatch.integrate", blocked=dt, depth=len(self.inflight),
            integrations=self.integrations, rounds=new_rounds,
        )


def run_consensus_mesh_queued(hg, mesh, queue_depth: int = 4,
                              batch_deadline: float = 0.0,
                              batch_rows: int = MESH_BATCH_ROWS) -> None:
    """Queued-mesh rung entry point: get-or-create the hashgraph's
    dispatch queue and serve one consensus call through it. The queue
    hangs off the hashgraph as the live engine does, so a node's demotion
    can discard both."""
    q: Optional[MeshDispatchQueue] = getattr(hg, "_mesh_dispatch_queue", None)
    if q is None:
        q = MeshDispatchQueue(
            hg, mesh, queue_depth=queue_depth, batch_deadline=batch_deadline,
            batch_rows=batch_rows,
        )
        hg._mesh_dispatch_queue = q
    q.serve()
