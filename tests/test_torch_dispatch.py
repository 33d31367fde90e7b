"""The port's mesh branch of run_consensus_device, its queued-mesh rung
(babble_tpu_torch.tpu.dispatch) and the resident GridStager on the CPU:
blocks byte-identical to the JAX package's mesh runs and to the host
engine, the stager's grids equal to fresh restages (ports
tests/test_multichip.py :332-420), and the mesh's device rules."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from babble_tpu.hashgraph import Hashgraph as RefHashgraph
from babble_tpu.hashgraph import InmemStore as RefInmemStore
from babble_tpu.tpu import run_consensus_device as ref_run_consensus_device
from babble_tpu.tpu import synthetic_grid
from babble_tpu.tpu.grid import GridStager as RefGridStager
from babble_tpu_torch.hashgraph import Event
from babble_tpu_torch.tpu import (
    DeviceMesh, GridStager, grid_from_hashgraph, run_consensus_device,
    run_consensus_mesh_queued,
)
from babble_tpu_torch.tpu import synthetic_grid as port_synthetic_grid
from babble_tpu_torch.tpu.doubling import use_doubling

from dsl import CACHE_SIZE, init_consensus_hashgraph
from test_torch_hashgraph import assert_same_consensus, carry, ref_events
from test_tpu_differential import build_hashgraph_from_grid, clone_hashgraph

STAGER_COLUMNS = (
    "creator", "index", "self_parent", "other_parent", "last_ancestors",
    "first_descendants", "ext_sp_round", "ext_op_round", "fixed_round",
    "ext_sp_lamport", "ext_op_lamport", "fixed_lamport", "coin_bit",
)


def assert_grid_equal(got, want, what):
    assert got.e == want.e, what
    assert got.num_levels == want.num_levels, what
    for col in STAGER_COLUMNS:
        np.testing.assert_array_equal(np.asarray(getattr(got, col))[: got.e],
                                      np.asarray(getattr(want, col))[: want.e],
                                      err_msg=f"{what}: {col}")
    for lv in range(want.num_levels):
        np.testing.assert_array_equal(
            np.sort(got.levels[lv][got.levels[lv] >= 0]),
            np.sort(want.levels[lv][want.levels[lv] >= 0]), err_msg=f"{what}: level {lv}")
    assert list(got.hashes) == list(want.hashes), what


def empty_pair(src):
    """Empty hashgraphs over the fixture's peers: the JAX package's and the
    port's."""
    ref = RefHashgraph(src.participants, RefInmemStore(src.participants, CACHE_SIZE))
    return ref, carry(src, [], cache_size=CACHE_SIZE)


# ---------------------------------------------------------------------------
# GridStager
# ---------------------------------------------------------------------------


def test_grid_stager_incremental_matches_full_restage():
    """The consensus fixture's events replayed a few at a time: after every
    chunk the port stager's grid equals a fresh grid_from_hashgraph and
    the JAX package's stager fed the same events."""
    src, _, ordered = init_consensus_hashgraph()
    ref, hg = empty_pair(src)
    ref_stager, stager = RefGridStager(ref), GridStager(hg)
    chunk = 3
    for lo in range(0, len(ordered), chunk):
        for ev in ordered[lo: lo + chunk]:
            ref.insert_event(type(ev).from_json(ev.to_json()), True)
            hg.insert_event(Event.from_json(ev.to_json()), True)
        got = stager.stage()
        assert_grid_equal(got, grid_from_hashgraph(hg), f"restage at {lo}")
        assert_grid_equal(got, ref_stager.stage(), f"JAX stager at {lo}")
    assert stager.full_restages == 1, "delta path never took over"
    assert stager.delta_stages > 0
    assert stager.last_delta_rows == len(ordered) - ((len(ordered) - 1) // chunk) * chunk


def test_grid_stager_snapshots_are_immutable():
    src, _, ordered = init_consensus_hashgraph()
    _, hg = empty_pair(src)
    stager = GridStager(hg)
    half = len(ordered) // 2
    for ev in ordered[:half]:
        hg.insert_event(Event.from_json(ev.to_json()), True)
    snap = stager.stage()
    fd_before = snap.first_descendants.copy()
    levels_before = snap.levels.copy()
    for ev in ordered[half:]:
        hg.insert_event(Event.from_json(ev.to_json()), True)
    stager.stage()
    np.testing.assert_array_equal(snap.first_descendants, fd_before)
    np.testing.assert_array_equal(snap.levels, levels_before)


def test_use_doubling_prefer_lowers_crossover():
    grid = port_synthetic_grid(8, 512, seed=3)
    assert grid.num_levels >= 64, "fixture too shallow for the assertion"
    assert not use_doubling(grid)
    assert use_doubling(grid, prefer=True)


# ---------------------------------------------------------------------------
# run_consensus_device(hg, mesh=...)
# ---------------------------------------------------------------------------


def jax_mesh(shape, names):
    devices = jax.devices("cpu")
    k = int(np.prod(shape))
    if len(devices) < k:
        pytest.skip(f"need {k} CPU devices, have {len(devices)}")
    return Mesh(np.array(devices[:k]).reshape(shape), names)


def host_run(src):
    h = clone_hashgraph(src)
    blocks = []
    h.commit_callback = blocks.append
    h.run_consensus()
    return h, blocks


MESH_RUNS = [
    ("consensus", (8,), ("rounds",)),
    ("synthetic", (2, 2), ("validators", "rounds")),
]


def fixture(name):
    if name == "consensus":
        return init_consensus_hashgraph()[0]
    return build_hashgraph_from_grid(synthetic_grid(5, 240, seed=13))[0]


@pytest.mark.parametrize("name,shape,names", MESH_RUNS)
def test_run_consensus_device_on_a_mesh_matches_reference_and_host(name, shape, names):
    src = fixture(name)
    ref = clone_hashgraph(src)
    ref_blocks = []
    ref.commit_callback = ref_blocks.append
    ref_run_consensus_device(ref, mesh=jax_mesh(shape, names))
    port_blocks = []
    port = carry(src, commit_callback=port_blocks.append)
    run_consensus_device(port, mesh=DeviceMesh.on("cpu", shape, names))
    assert port_blocks, "the run committed no block"
    assert_same_consensus(ref, ref_blocks, port, port_blocks, f"{name} on {shape}")
    host, host_blocks = host_run(src)
    assert_same_consensus(host, host_blocks, port, port_blocks, f"{name} vs host")
    cells = port.obs.devledger.snapshot()
    assert any(k.startswith("sharded/") and k.endswith("/integrate") for k in cells), cells


def test_run_consensus_device_refuses_a_device_beside_the_mesh():
    src = fixture("consensus")
    port = carry(src)
    mesh = DeviceMesh.on("cpu", (2,), ("rounds",))
    with pytest.raises(ValueError, match="mesh"):
        run_consensus_device(port, device="cuda", mesh=mesh)
    blocks = []
    port.commit_callback = blocks.append
    run_consensus_device(port, device="cpu", mesh=mesh)  # the mesh's own device
    assert blocks


# ---------------------------------------------------------------------------
# run_consensus_mesh_queued
# ---------------------------------------------------------------------------


def queued_run(src, mesh, sync, queue_depth=4):
    """The DAG's events fed in syncs, one queued-mesh call after each, then
    the flush. Returns (hashgraph, blocks, integrations after each call)."""
    events = ref_events(src)
    blocks = []
    hg = carry(src, [], commit_callback=blocks.append, cache_size=CACHE_SIZE)
    trace = []
    for lo in range(0, len(events), sync):
        for ev in events[lo: lo + sync]:
            hg.insert_event(Event.from_json(ev.to_json()), True)
        run_consensus_mesh_queued(hg, mesh, queue_depth=queue_depth)
        trace.append(hg._mesh_dispatch_queue.integrations)
    q = hg._mesh_dispatch_queue
    q.flush()
    return hg, blocks, trace


def test_run_consensus_mesh_queued_matches_host_and_is_deterministic():
    src = build_hashgraph_from_grid(synthetic_grid(5, 240, seed=13))[0]
    mesh = DeviceMesh.on("cpu", (2, 2), ("validators", "rounds"))
    hg, blocks, trace = queued_run(src, mesh, 16)
    host, host_blocks = host_run(src)
    assert blocks, "the queued run committed no block"
    assert_same_consensus(host, host_blocks, hg, blocks, "queued mesh vs host")
    q = hg._mesh_dispatch_queue
    assert q.stager.delta_stages > 0 and q.dispatches > 1
    assert not q.inflight
    hg2, blocks2, trace2 = queued_run(src, mesh, 16)
    assert trace2 == trace, "same-seed runs integrated on different serve calls"
    assert [b.marshal() for b in blocks2] == [b.marshal() for b in blocks]


# ---------------------------------------------------------------------------
# the mesh's device rules
# ---------------------------------------------------------------------------


def test_mesh_refuses_mixed_device_types():
    with pytest.raises(ValueError, match="mix"):
        DeviceMesh(["cpu", "cuda", "cpu", "cpu"], (4,), ("rounds",))


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    """No move to the CPU: a CUDA mesh on a host without a card raises, as
    every entry point does (the card's absence is simulated, so the test
    holds on any host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMesh.on("cuda", (2, 4), ("validators", "rounds"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMesh(["cuda:0", "cuda:0"], (2,), ("rounds",))


def test_mesh_shape_and_axes_are_checked():
    with pytest.raises(ValueError):
        DeviceMesh.on("cpu", (2, 2), ("rounds",))
    with pytest.raises(ValueError):
        DeviceMesh(["cpu"] * 3, (2, 2), ("validators", "rounds"))
    mesh = DeviceMesh.on("cpu", (2, 4), ("validators", "rounds"))
    assert mesh.shape["validators"] == 2 and mesh.shape["rounds"] == 4
    assert mesh.axis_names == ("validators", "rounds") and mesh.size == 8
