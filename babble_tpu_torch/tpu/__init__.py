"""Device layer of the PyTorch/CUDA port: the one-shot consensus engines
(round-frontier pipeline, level scan, log-diameter cold path) with
hand-written CUDA kernels for the H100."""

from .doubling import run_doubling_passes
from .engine import PassResults, run_frontier_passes, run_passes
from .grid import (
    DagGrid,
    GridUnsupported,
    grid_from_arrays,
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
