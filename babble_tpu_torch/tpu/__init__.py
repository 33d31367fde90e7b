"""Device layer of the PyTorch/CUDA port: the one-shot consensus engines
(round-frontier pipeline, level scan, log-diameter cold path), the
incremental append engine (step, multi_step, train_step, multi_train),
the frontier-live engine (frontier_train_step, frontier_multi_train,
bootstrap_frontier_state), the device mesh (DeviceMesh and the sharded
engines sharded_run_passes, sharded_frontier_passes,
sharded_doubling_passes) and the hashgraph seam (run_consensus_device,
with or without a mesh; the live engine behind run_consensus_live; the
queued mesh dispatch behind run_consensus_mesh_queued), with hand-written
CUDA kernels for the H100."""

from .dispatch import MeshDispatchQueue, run_consensus_mesh_queued
from .doubling import maybe_cold_replay, run_doubling_passes
from .frontier_live import (
    FrState,
    bootstrap_frontier_state,
    frontier_multi_train,
    frontier_state_from_numpy,
    frontier_train_step,
    init_frontier_state,
)
from .engine import (
    PassResults,
    integrate_pass_results,
    run_consensus_device,
    run_frontier_passes,
    run_passes,
)
from .grid import (
    DagGrid,
    GridStager,
    GridUnsupported,
    grid_from_arrays,
    grid_from_hashgraph,
    section_grid,
    synthetic_grid,
)
from .incremental import (
    Batch,
    IncState,
    Train,
    batches_from_grid,
    device_put,
    empty_batch,
    init_state,
    multi_step,
    multi_train,
    stack_batches,
    stack_trains,
    state_from_arrays,
    state_to_arrays,
    step,
    train_step,
    trains_from_grid,
)
from .live import LiveDeviceEngine, flush_live_engine, run_consensus_live
from .mesh import DeviceMesh
from .sharded import (
    sharded_doubling_passes,
    sharded_frontier_passes,
    sharded_run_passes,
)

__all__ = [
    "Batch",
    "DagGrid",
    "DeviceMesh",
    "FrState",
    "GridStager",
    "GridUnsupported",
    "IncState",
    "LiveDeviceEngine",
    "MeshDispatchQueue",
    "PassResults",
    "Train",
    "batches_from_grid",
    "bootstrap_frontier_state",
    "device_put",
    "empty_batch",
    "flush_live_engine",
    "frontier_multi_train",
    "frontier_state_from_numpy",
    "frontier_train_step",
    "grid_from_arrays",
    "grid_from_hashgraph",
    "init_frontier_state",
    "init_state",
    "integrate_pass_results",
    "maybe_cold_replay",
    "multi_step",
    "multi_train",
    "run_consensus_device",
    "run_consensus_live",
    "run_consensus_mesh_queued",
    "run_doubling_passes",
    "run_frontier_passes",
    "run_passes",
    "section_grid",
    "sharded_doubling_passes",
    "sharded_frontier_passes",
    "sharded_run_passes",
    "stack_batches",
    "stack_trains",
    "state_from_arrays",
    "state_to_arrays",
    "step",
    "synthetic_grid",
    "train_step",
    "trains_from_grid",
]
