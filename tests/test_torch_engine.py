"""run_frontier_passes of the port (device="cpu", the plain versions)
against the JAX package's run_frontier_passes: on the synthetic fixtures
and on the frontier-safe hashgraph fixtures of test_tpu_differential.py,
staged by the reference's grid_from_hashgraph and carried across with
grid_from_arrays. Per-event fields compared in full; the (R, N) tables on
the real rounds, since the two adaptive round-axis hints may differ."""

import numpy as np
import pytest

from babble_tpu.tpu import grid_from_hashgraph, synthetic_grid
from babble_tpu.tpu import engine as ref_engine
from babble_tpu.tpu.grid import section_grid
from babble_tpu_torch.tpu import GridUnsupported, grid_from_arrays
from babble_tpu_torch.tpu import engine as port_engine

from dsl import (
    init_consensus_hashgraph,
    init_funky_hashgraph,
    init_round_hashgraph,
    init_simple_hashgraph,
    init_sparse_hashgraph,
)
from test_torch_grid import FRONTIER_FIXTURES
from test_tpu_differential import build_hashgraph_from_grid


def assert_same_passes(got, want):
    assert got.last_round == want.last_round
    assert got.round_offset == want.round_offset == 0
    for name in ("rounds", "witness", "lamport", "received"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    k = want.last_round + 1
    for name in ("witness_table", "fame_decided", "famous", "rounds_decided"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a[:k], b[:k], err_msg=name)


def run_both(ref_grid):
    assert ref_engine._frontier_safe(ref_grid)
    want = ref_engine.run_frontier_passes(ref_grid)
    got = port_engine.run_frontier_passes(grid_from_arrays(vars(ref_grid)), device="cpu")
    assert_same_passes(got, want)
    return got


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES)
def test_synthetic_fixture_matches_reference(n, e, seed, zipf, byz):
    run_both(synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz))


def partial_participation_hashgraph():
    """test_tpu_differential.py's fixture: 4 participants, 3 ever create."""
    from dsl import Play, create_hashgraph, init_hashgraph_nodes, play_events
    from babble_tpu.hashgraph import Event, root_self_parent

    nodes, index, ordered, participants = init_hashgraph_nodes(4)
    plist = participants.to_peer_slice()
    for i in range(3):
        ev = Event(parents=[root_self_parent(plist[i].id), ""], creator=nodes[i].pub, index=0)
        nodes[i].sign_and_add_event(ev, f"e{i}", index, ordered)
    plays = [
        Play(0, 1, "e0", "e1", "a0", [b"a0"]),
        Play(1, 1, "e1", "a0", "a1", [b"a1"]),
        Play(2, 1, "e2", "a1", "a2", [b"a2"]),
        Play(0, 2, "a0", "a2", "b0", [b"b0"]),
        Play(1, 2, "a1", "b0", "b1", [b"b1"]),
        Play(2, 2, "a2", "b1", "b2", [b"b2"]),
        Play(0, 3, "b0", "b2", "c0", [b"c0"]),
        Play(1, 3, "b1", "c0", "c1", [b"c1"]),
        Play(2, 3, "b2", "c1", "c2", [b"c2"]),
    ]
    play_events(plays, nodes, index, ordered)
    return create_hashgraph(ordered, participants)


HASHGRAPHS = {
    "simple": lambda: init_simple_hashgraph()[0],
    "round": lambda: init_round_hashgraph()[0],
    "consensus": lambda: init_consensus_hashgraph()[0],
    "funky": lambda: init_funky_hashgraph(full=True)[0],
    "sparse": lambda: init_sparse_hashgraph()[0],
    "partial_participation": partial_participation_hashgraph,
    "synthetic_5x120": lambda: build_hashgraph_from_grid(synthetic_grid(5, 120, seed=13))[0],
}


@pytest.mark.parametrize("name", sorted(HASHGRAPHS))
def test_hashgraph_fixture_matches_reference(name):
    run_both(grid_from_hashgraph(HASHGRAPHS[name]()))


def test_bench_shaped_padding_matches_reference():
    """pad_grid and the chain-axis bucket give the reference's shapes."""
    g = synthetic_grid(8, 300, seed=7, zipf_a=2.0)
    p = port_engine.pad_grid(grid_from_arrays(vars(g)))
    r = ref_engine.pad_grid(g)
    for name in ("creator", "index", "last_ancestors", "first_descendants",
                 "coin_bit", "levels"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name), err_msg=name)
    assert port_engine._bucket(560, 64, factor=2) == ref_engine._bucket(560, 64, factor=2) == 1024


def test_post_reset_grid_is_refused():
    """A section grid (post-reset shape) is not frontier-safe: the port
    raises instead of falling back."""
    g = synthetic_grid(4, 64, seed=1)
    sec = section_grid(g, ref_engine.run_passes(g), cut=6)
    assert not ref_engine._frontier_safe(sec)
    with pytest.raises(GridUnsupported):
        port_engine.run_frontier_passes(grid_from_arrays(vars(sec)), device="cpu")


def test_packed_layout_is_refused():
    """The packed layout, once refused, now runs: packed=True equals the
    reference's packed run; at 128 validators the knob's default (packed)
    equals the reference's default and the port's wide run."""
    ref_small = synthetic_grid(4, 64, seed=1)
    g = grid_from_arrays(vars(ref_small))
    got = port_engine.run_frontier_passes(g, device="cpu", packed=True)
    assert_same_passes(got, ref_engine.run_frontier_passes(ref_small, packed=True))
    ref_wide = synthetic_grid(128, 200, seed=1)
    wide = grid_from_arrays(vars(ref_wide))
    got = port_engine.run_frontier_passes(wide, device="cpu")
    assert_same_passes(got, ref_engine.run_frontier_passes(ref_wide))
    res = port_engine.run_frontier_passes(wide, device="cpu", packed=False)
    assert res.rounds.shape == (200,)
    assert_same_passes(got, res)
