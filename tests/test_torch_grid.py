"""The port's grid layer (babble_tpu_torch.tpu.grid) against the JAX
package's: the synthetic gossip generator draws the same numpy stream, so
one seed gives the same grid field for field, and grid_from_arrays carries
a reference grid across unchanged."""

import dataclasses

import numpy as np
import pytest

from babble_tpu.tpu import grid as ref_grid
from babble_tpu_torch.tpu import grid as port_grid

# tests/test_frontier.py's fixtures (n, e, seed, zipf, byzantine)
FRONTIER_FIXTURES = [
    (4, 64, 1, 0.0, 0.0),
    (8, 256, 2, 0.0, 0.0),
    (8, 512, 3, 1.1, 0.0),
    (16, 1024, 4, 1.1, 0.0),
    (8, 300, 7, 2.0, 0.0),
    (32, 768, 9, 1.1, 0.0),
    (32, 1024, 11, 1.05, 1.0 / 3.0),
    (64, 2048, 13, 1.05, 1.0 / 3.0),
]
# tests/test_tpu_differential.py FUZZ_CASES (n, e, seed)
FUZZ_CASES = [
    (4, 150, 101), (4, 200, 102), (4, 250, 103), (4, 180, 104),
    (5, 150, 201), (5, 220, 202), (5, 250, 203), (5, 170, 204),
    (6, 200, 301), (6, 240, 302),
]


def assert_same_grid(port, ref):
    for f in dataclasses.fields(ref_grid.DagGrid):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES)
def test_synthetic_grid_matches_reference(n, e, seed, zipf, byz):
    port = port_grid.synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    ref = ref_grid.synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    assert_same_grid(port, ref)


@pytest.mark.parametrize("n,e,seed", FUZZ_CASES)
def test_synthetic_grid_matches_reference_fuzz(n, e, seed):
    assert_same_grid(
        port_grid.synthetic_grid(n, e, seed=seed),
        ref_grid.synthetic_grid(n, e, seed=seed),
    )


def test_fd_update_stream_and_deep_grid_match_reference():
    port = port_grid.synthetic_grid(5, 120, seed=3, zipf_a=1.1, record_fd_updates=True)
    ref = ref_grid.synthetic_grid(5, 120, seed=3, zipf_a=1.1, record_fd_updates=True)
    assert port.fd_update_stream == ref.fd_update_stream
    deep_p = port_grid.synthetic_deep_grid(6, 128, seed=2, zipf_a=1.2)
    deep_r = ref_grid.synthetic_deep_grid(6, 128, seed=2, zipf_a=1.2)
    assert_same_grid(deep_p, deep_r)
    np.testing.assert_array_equal(port_grid.row_levels(deep_p), ref_grid.row_levels(deep_r))
    lv_p = port_grid.build_levels(deep_p.n, deep_p.self_parent, deep_p.other_parent)
    lv_r = ref_grid.build_levels(deep_r.n, deep_r.self_parent, deep_r.other_parent)
    np.testing.assert_array_equal(lv_p[0], lv_r[0])
    assert lv_p[1] == lv_r[1]


def test_grid_from_arrays_round_trips_a_reference_grid():
    ref = ref_grid.synthetic_grid(8, 256, seed=2)
    port = port_grid.grid_from_arrays(vars(ref))
    assert isinstance(port, port_grid.DagGrid)
    assert port.fd_update_stream is None
    ref.fd_update_stream = None
    assert_same_grid(port, ref)
    # copies: mutating the port's grid leaves the reference's alone
    port.last_ancestors[0, 0] = 12345
    assert ref.last_ancestors[0, 0] != 12345
    assert port.r_max == ref.r_max and port.r_base == ref.r_base


@pytest.mark.parametrize("cut_frac,pin", [(1.0 / 3.0, True), (1.0 / 2.0, True), (1.0 / 2.0, False)])
def test_section_grid_matches_reference(cut_frac, pin):
    """The port's section_grid, cut from the port's grid with the same
    solved rounds and lamports, equals the reference's field for field."""
    from babble_tpu.tpu.engine import run_passes

    ref = ref_grid.synthetic_deep_grid(6, 256, seed=2, zipf_a=1.0)
    port = port_grid.grid_from_arrays(vars(ref))
    full = run_passes(ref)
    cut = int(ref.num_levels * cut_frac)
    want = ref_grid.section_grid(ref, full, cut, pin_cut=pin)
    got = port_grid.section_grid(port, full, cut, pin_cut=pin)
    assert isinstance(got, port_grid.DagGrid)
    assert_same_grid(got, want)
    with pytest.raises(ValueError):
        port_grid.section_grid(port, full, ref.num_levels + 1)
