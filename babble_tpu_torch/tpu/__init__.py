"""Device layer of the PyTorch/CUDA port: the round-frontier consensus
pipeline (passes 1-3) with hand-written CUDA kernels for the H100."""

from .engine import PassResults, run_frontier_passes
from .grid import DagGrid, GridUnsupported, grid_from_arrays, synthetic_grid

__all__ = [
    "DagGrid",
    "GridUnsupported",
    "PassResults",
    "grid_from_arrays",
    "run_frontier_passes",
    "synthetic_grid",
]
