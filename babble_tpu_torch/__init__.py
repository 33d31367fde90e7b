"""PyTorch/CUDA port of babble-tpu's device consensus engine.

A package of its own beside `babble_tpu` (the JAX reference): it imports
torch and numpy, never jax and nothing of `babble_tpu`. Its entry points
run on the CUDA card unless the caller passes device="cpu"."""

from .tpu import (
    DagGrid,
    GridUnsupported,
    PassResults,
    grid_from_arrays,
    run_doubling_passes,
    run_frontier_passes,
    run_passes,
    section_grid,
    synthetic_grid,
)

__all__ = [
    "DagGrid",
    "GridUnsupported",
    "PassResults",
    "grid_from_arrays",
    "run_doubling_passes",
    "run_frontier_passes",
    "run_passes",
    "section_grid",
    "synthetic_grid",
]
