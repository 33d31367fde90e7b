"""The port's round-frontier DivideRounds (babble_tpu_torch.tpu.frontier,
plain versions on the CPU) against the JAX package's jitted functions on
the same inputs: exact integer equality, no tolerance."""

import numpy as np
import pytest
import torch

import babble_tpu.tpu.frontier as ref
from babble_tpu.tpu import synthetic_grid
from babble_tpu.tpu.grid import synthetic_deep_grid
from babble_tpu.tpu.kernels import suffix_min as ref_suffix_min
from babble_tpu_torch.tpu import frontier as port
from babble_tpu_torch.tpu.kernels import suffix_min

from test_torch_grid import FRONTIER_FIXTURES

R_CAP = 64


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def staged(grid):
    """The unpadded inputs tests/test_frontier.py feeds the pipeline."""
    return dict(
        rows_by=ref.chain_table(grid),
        creator=grid.creator,
        index=grid.index,
        sp_index=ref.sp_index_of(grid),
        la=grid.last_ancestors,
        fd=grid.first_descendants,
        lamport=ref.level_lamport(grid),
        coin=grid.coin_bit,
    )


def assert_fields_equal(port_res, ref_res):
    for name in ref_res._fields:
        a = getattr(port_res, name).numpy()
        b = np.asarray(getattr(ref_res, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES)
def test_build_inv_matches_reference(n, e, seed, zipf, byz):
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    rows_by = ref.chain_table(grid)
    want = np.asarray(ref.build_inv(rows_by, grid.last_ancestors)).astype(np.int32)
    got = port.build_inv(t(rows_by), t(grid.last_ancestors))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_inv_masks_out_of_range_slots():
    """Padding chain slots (-1), absent coordinates (la < 0) and
    coordinates past the chain axis (clamped to L-1) — the reference's
    dropped scatter slot and clamped gathers, reproduced by masks."""
    rng = np.random.default_rng(5)
    n, l, e = 6, 16, 40
    rows_by = rng.integers(-1, e, size=(n, l)).astype(np.int32)
    rows_by[:, 10:] = -1
    la = rng.integers(-3, 2 * l, size=(e, n)).astype(np.int32)
    want = np.asarray(ref.build_inv(rows_by, la)).astype(np.int32)
    np.testing.assert_array_equal(port.build_inv(t(rows_by), t(la)).numpy(), want)


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES)
def test_frontier_pipeline_matches_reference(n, e, seed, zipf, byz):
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    s = staged(grid)
    inv_ref = ref.build_inv(s["rows_by"], s["la"])
    want = ref.frontier_pipeline(
        inv_ref, s["rows_by"], s["creator"], s["index"], s["sp_index"],
        s["la"], s["fd"], s["lamport"], s["coin"],
        grid.super_majority, grid.n, R_CAP,
    )
    ts = {k: t(v) for k, v in s.items()}
    inv = port.build_inv(ts["rows_by"], ts["la"])
    got = port.frontier_pipeline(
        inv, ts["rows_by"], ts["creator"], ts["index"], ts["sp_index"],
        ts["la"], ts["fd"], ts["lamport"], ts["coin"],
        grid.super_majority, grid.n, R_CAP,
    )
    assert_fields_equal(got, want)
    assert int(got.last_round) >= 1


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES[:4])
def test_frontier_rounds_matches_reference(n, e, seed, zipf, byz):
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    s = staged(grid)
    want = ref.frontier_rounds(
        ref.build_inv(s["rows_by"], s["la"]), s["rows_by"], s["creator"],
        s["index"], s["sp_index"], s["fd"], super_majority=grid.super_majority,
        r_cap=R_CAP,
    )
    ts = {k: t(v) for k, v in s.items()}
    got = port.frontier_rounds(
        port.build_inv(ts["rows_by"], ts["la"]), ts["rows_by"], ts["creator"],
        ts["index"], ts["sp_index"], ts["fd"], grid.super_majority, R_CAP,
    )
    assert_fields_equal(got, want)


def test_suffix_min_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3000, size=(4, 5, 2801)).astype(np.int32)
    want = np.asarray(ref_suffix_min(x, 3000, axis=2))
    np.testing.assert_array_equal(suffix_min(t(x), dim=2).numpy(), want)
    np.testing.assert_array_equal(
        want, np.minimum.accumulate(x[:, :, ::-1], axis=2)[:, :, ::-1]
    )


@pytest.mark.parametrize("n,e,seed,zipf", [(8, 256, 2, 0.0), (16, 1024, 4, 1.1),
                                           (8, 300, 7, 2.0)])
def test_m0_binsearch_matches_sort(n, e, seed, zipf):
    """The two m0 forms give the same integers (the CUDA kernel computes
    the sort form's at every N)."""
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf)
    ts = {k: t(v) for k, v in staged(grid).items()}
    inv = port.build_inv(ts["rows_by"], ts["la"])
    args = (inv, ts["rows_by"], ts["creator"], ts["index"], ts["sp_index"],
            ts["fd"], grid.super_majority, R_CAP)
    a = port._frontier_rounds_plain(*args, la=ts["la"], m0_mode="sort")
    b = port._frontier_rounds_plain(*args, la=ts["la"], m0_mode="binsearch")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert port.M0_BINSEARCH_MIN_N == ref.M0_BINSEARCH_MIN_N


def test_level_lamport_and_staging_match_reference():
    grids = [
        synthetic_grid(4, 64, seed=1),
        synthetic_grid(16, 1024, seed=4, zipf_a=1.1),
        synthetic_deep_grid(6, 128, seed=2, zipf_a=1.2),
    ]
    for grid in grids:
        np.testing.assert_array_equal(port.level_lamport(grid), ref.level_lamport(grid))
        np.testing.assert_array_equal(port.chain_table(grid), ref.chain_table(grid))
        np.testing.assert_array_equal(port.sp_index_of(grid), ref.sp_index_of(grid))
