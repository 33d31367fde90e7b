"""Device layer of the PyTorch/CUDA port: the one-shot consensus engines
(round-frontier pipeline, level scan, log-diameter cold path), the
incremental append engine (step, multi_step, train_step, multi_train),
the frontier-live engine (frontier_train_step, frontier_multi_train,
bootstrap_frontier_state) and the hashgraph seam (run_consensus_device,
the live engine behind run_consensus_live), with hand-written CUDA
kernels for the H100."""

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

__all__ = [
    "Batch",
    "DagGrid",
    "FrState",
    "GridUnsupported",
    "IncState",
    "LiveDeviceEngine",
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
    "run_doubling_passes",
    "run_frontier_passes",
    "run_passes",
    "section_grid",
    "stack_batches",
    "stack_trains",
    "state_from_arrays",
    "state_to_arrays",
    "step",
    "synthetic_grid",
    "train_step",
    "trains_from_grid",
]
