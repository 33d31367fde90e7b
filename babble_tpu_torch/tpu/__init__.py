"""Device layer of the PyTorch/CUDA port: the one-shot consensus engines
(round-frontier pipeline, level scan, log-diameter cold path) and the
incremental append engine (step, multi_step, train_step, multi_train),
with hand-written CUDA kernels for the H100."""

from .doubling import run_doubling_passes
from .engine import PassResults, run_frontier_passes, run_passes
from .grid import (
    DagGrid,
    GridUnsupported,
    grid_from_arrays,
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

__all__ = [
    "Batch",
    "DagGrid",
    "GridUnsupported",
    "IncState",
    "PassResults",
    "Train",
    "batches_from_grid",
    "device_put",
    "empty_batch",
    "grid_from_arrays",
    "init_state",
    "multi_step",
    "multi_train",
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
