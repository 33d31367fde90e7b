"""PyTorch/CUDA port of babble-tpu's device consensus engine, with the
host layer it runs under.

A package of its own beside `babble_tpu` (the JAX reference): it imports
torch and numpy, never jax and nothing of `babble_tpu`. It keeps its own
copies of the host packages the device engines stand on (common, crypto,
peers, utils.codec, the parts of obs they call, and hashgraph), with the
reference's names and layout. Its entry points run on the CUDA card
unless the caller passes device="cpu"."""

from . import common, crypto, hashgraph, obs, peers, utils
from .tpu import (
    DagGrid,
    GridUnsupported,
    PassResults,
    flush_live_engine,
    grid_from_arrays,
    grid_from_hashgraph,
    run_consensus_device,
    run_consensus_live,
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
    "common",
    "crypto",
    "flush_live_engine",
    "grid_from_arrays",
    "grid_from_hashgraph",
    "hashgraph",
    "obs",
    "peers",
    "run_consensus_device",
    "run_consensus_live",
    "run_doubling_passes",
    "run_frontier_passes",
    "run_passes",
    "section_grid",
    "synthetic_grid",
    "utils",
]
