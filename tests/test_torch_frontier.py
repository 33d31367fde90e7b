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
from babble_tpu_torch.tpu import _ext
from babble_tpu_torch.tpu import frontier as port
from babble_tpu_torch.tpu.kernels import suffix_min
from chip_smoke import build_inv_trap_cases

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


def _random_slots():
    rng = np.random.default_rng(5)
    n, l, e = 6, 16, 40
    rows_by = rng.integers(-1, e, size=(n, l)).astype(np.int32)
    rows_by[:, 10:] = -1
    return rows_by, rng.integers(-3, 2 * l, size=(e, n)).astype(np.int32)


# chip_smoke.py's trap table of K1 (the card holds the kernel to the plain
# version on the same cases), after the original random case
INV_TRAPS = [("random slots", *_random_slots())] + build_inv_trap_cases()


def _clamped(rows_by, la):
    """(N_c, L, N_p) clamped coordinates, -1 where a slot or an entry is
    absent (csrc/build_inv.cu's values before the running maximum)."""
    n_c, l = rows_by.shape
    e, n_p = la.shape
    if e == 0:
        return np.full((n_c, l, n_p), -1, dtype=np.int64)
    a = la[np.minimum(np.maximum(rows_by, 0), e - 1)].astype(np.int64)
    a = np.where((rows_by >= 0)[:, :, None], a, -1)
    return np.where(a < 0, -1, np.minimum(a, l - 1))


def inv_model(rows_by, la):
    """INV by the kernel's formulation: M the running maximum of the clamped
    coordinates down each chain, INV[c, p, v] the count of i with M < v (L
    where none reaches v)."""
    n_c, l = rows_by.shape
    m = np.maximum.accumulate(_clamped(rows_by, la), axis=1)  # (N_c, L, N_p)
    v = np.arange(l)
    return np.stack([np.stack([np.searchsorted(m[c, :, p], v, side="left")
                               for p in range(m.shape[2])]) for c in range(n_c)]
                    ).astype(np.int32).reshape(n_c, la.shape[1], l)


def inv_schedule(rows_by, la, segments=None):
    """INV by csrc/build_inv.cu's order of work on _ext.build_inv_plan's
    launch: per block (chain, tile, segment) the segment's column maxima;
    from every segment's, the carry (the maximum of the segments before
    it) and the final maximum; then chunk by chunk the running maximum
    from the carry and the run of v in (carry, chunk maximum], each by a
    lower-bound search of the chunk's maxima; then the segment's share of
    the slots above the final maximum, L. Every word must be written
    exactly once."""
    n_c, l = rows_by.shape
    n_p = la.shape[1]
    plan = _ext.build_inv_plan(n_c, n_p, l, segments)
    a = _clamped(rows_by, la)
    inv = np.full((n_c, n_p, l), -7, dtype=np.int64)
    writes = np.zeros((n_c, n_p, l), dtype=np.int64)
    seg_len, n_s, chunk = plan["seg_len"], plan["segments"], _ext.BI_CHUNK
    for c in range(n_c):
        for tile in range(plan["tiles"]):
            cols = slice(tile * _ext.BI_COLS, min((tile + 1) * _ext.BI_COLS, n_p))
            seg_max = [np.maximum(a[c, s * seg_len: (s + 1) * seg_len, cols].max(axis=0), -1)
                       for s in range(n_s)]
            fin = np.maximum.reduce(seg_max)
            for s in range(n_s):
                carry = np.full(fin.shape, -1)
                for q in range(s):
                    carry = np.maximum(carry, seg_max[q])
                i_hi = min((s + 1) * seg_len, l)
                for i0 in range(s * seg_len, i_hi, chunk):
                    part = np.full((chunk, carry.shape[0]), -1)
                    rows = a[c, i0: min(i0 + chunk, i_hi), cols]
                    part[: rows.shape[0]] = rows
                    m = np.maximum(np.maximum.accumulate(part, axis=0), carry)
                    for q, p in enumerate(range(n_p)[cols]):
                        v = np.arange(carry[q] + 1, m[-1, q] + 1)
                        inv[c, p, v] = i0 + np.searchsorted(m[:, q], v, side="left")
                        writes[c, p, v] += 1
                    carry = m[-1]
                for q, p in enumerate(range(n_p)[cols]):
                    size = l - 1 - fin[q]
                    lo = fin[q] + 1 + size * s // n_s
                    hi = fin[q] + 1 + size * (s + 1) // n_s
                    inv[c, p, lo:hi] = l
                    writes[c, p, lo:hi] += 1
    assert (writes == 1).all(), "a word written other than once"
    return inv.astype(np.int32)


@pytest.mark.parametrize("name,rows_by,la", INV_TRAPS, ids=[c[0] for c in INV_TRAPS])
def test_build_inv_masks_out_of_range_slots(name, rows_by, la):
    """Padding chain slots (-1), absent coordinates (la < 0) and
    coordinates past the chain axis (clamped to L-1), rows past E, chains
    that fall and rise, L = 1, ragged tiles and chains of several chunks —
    the reference's dropped scatter slot and clamped gathers, reproduced by
    masks. With no rows (e = 0) the reference's gather refuses, and so does
    the plain version."""
    if la.shape[0] == 0:
        with pytest.raises(Exception):
            ref.build_inv(rows_by, la)
        with pytest.raises(Exception):
            port.build_inv(t(rows_by), t(la))
        return
    want = np.asarray(ref.build_inv(rows_by, la)).astype(np.int32)
    np.testing.assert_array_equal(port.build_inv(t(rows_by), t(la)).numpy(), want)


@pytest.mark.parametrize("name,rows_by,la", INV_TRAPS, ids=[c[0] for c in INV_TRAPS])
def test_build_inv_running_maximum_matches_reference(name, rows_by, la):
    """The kernel's formulation (inv_model) and its order of work on the
    plan's launch (inv_schedule: one segment a chain, two, the plan's own,
    one a chunk) equal the JAX build_inv on K1's trap table; with no rows
    they give L everywhere, as the kernel does."""
    n_c, l = rows_by.shape
    if la.shape[0] == 0:
        want = np.full((n_c, la.shape[1], l), l, dtype=np.int32)
    else:
        want = np.asarray(ref.build_inv(rows_by, la)).astype(np.int32)
    np.testing.assert_array_equal(inv_model(rows_by, la), want)
    chunks = -(-l // _ext.BI_CHUNK)
    for segments in sorted({1, 2, None, chunks}, key=str):
        np.testing.assert_array_equal(inv_schedule(rows_by, la, segments), want,
                                      err_msg=f"segments {segments}")


def test_build_inv_plan_splits_few_chains():
    """The plan splits the chain axis where (chain, tile) blocks are few,
    into whole chunks, at most one segment a chunk, within the card's
    cooperative reach (a named count too, on a card of any SM count); many
    chains take one segment; shared memory is the same at every L."""
    reach = _ext.BI_BLOCKS_PER_SM * _ext.H100_SMS
    catch_up = _ext.build_inv_plan(8, 8, 4608)
    assert catch_up["segments"] == 36 and catch_up["blocks"] == 288
    bench = _ext.build_inv_plan(64, 64, 1024)
    assert bench["tiles"] == 2 and bench["segments"] == 4 and bench["blocks"] <= reach
    assert bench["seg_len"] % _ext.BI_CHUNK == 0
    assert _ext.build_inv_plan(1024, 1024, 64)["segments"] == 1
    assert _ext.build_inv_plan(256, 256, 512)["segments"] == 1
    for n_c, l in ((3, 448), (1, 1), (2, 129), (5, 70000)):
        plan = _ext.build_inv_plan(n_c, 40, l)
        assert plan["blocks"] <= reach
        assert (plan["segments"] - 1) * plan["seg_len"] < l <= plan["segments"] * plan["seg_len"]
    assert _ext.build_inv_plan(64, 64, 1024, segments=8)["blocks"] <= reach
    small = _ext.build_inv_plan(8, 8, 8192, sms=16)
    assert small["blocks"] <= _ext.BI_BLOCKS_PER_SM * 16 < _ext.build_inv_plan(8, 8, 8192)["blocks"]
    assert _ext.build_inv_plan(64, 64, 1024, sms=8)["segments"] == 1
    assert len({_ext.block_smem("build_inv", 64, l=l)["walk"] for l in (64, 4096)}) == 1
    with pytest.raises(ValueError):
        _ext.build_inv_plan(0, 8, 8)


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


ROUNDS_CASES = [
    pytest.param(*fx, R_CAP, None, id="-".join(map(str, fx))) for fx in FRONTIER_FIXTURES[:4]
] + [
    # the engine's round axis (its floor min(n, 64)): the walk reaches its
    # fixed point mid-history, and the rows past it repeat X
    pytest.param(16, 1024, 4, 1.1, 0.0, 16, "fixed point", id="16-1024-4-engine-cap"),
    pytest.param(32, 768, 9, 1.1, 0.0, 32, "fixed point", id="32-768-9-engine-cap"),
    pytest.param(64, 2048, 13, 1.05, 1.0 / 3.0, 64, "fixed point", id="64-2048-13-engine-cap"),
    # caps short of the fixed point: the walk still moves at the last row
    pytest.param(8, 512, 3, 1.1, 0.0, 4, "moving", id="8-512-3-still-moving"),
    pytest.param(16, 1024, 4, 1.1, 0.0, 8, "moving", id="16-1024-4-still-moving"),
]


@pytest.mark.parametrize("n,e,seed,zipf,byz,r_cap,walk", ROUNDS_CASES)
def test_frontier_rounds_matches_reference(n, e, seed, zipf, byz, r_cap, walk):
    """K2's plain version against the reference at r_cap; where `walk` is
    named, the plain walk's history shows it: a fixed point mid-history
    (the CUDA walk stops there and repeats X), or a last row that still
    moves."""
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    s = staged(grid)
    want = ref.frontier_rounds(
        ref.build_inv(s["rows_by"], s["la"]), s["rows_by"], s["creator"],
        s["index"], s["sp_index"], s["fd"], super_majority=grid.super_majority,
        r_cap=r_cap,
    )
    ts = {k: t(v) for k, v in s.items()}
    inv = port.build_inv(ts["rows_by"], ts["la"])
    got = port.frontier_rounds(
        inv, ts["rows_by"], ts["creator"], ts["index"], ts["sp_index"], ts["fd"],
        grid.super_majority, r_cap,
    )
    assert_fields_equal(got, want)
    hist = port._frontier_history_plain(inv, ts["rows_by"], ts["fd"], grid.super_majority,
                                        r_cap, la=ts["la"])
    moved = [not torch.equal(hist[r + 1], hist[r]) for r in range(r_cap - 1)]
    if walk == "fixed point":
        fixed = moved.index(False)
        assert fixed + 2 < r_cap and not any(moved[fixed:]), "no fixed point mid-history"
    if walk == "moving":
        assert moved[-1], "the walk stopped moving before r_cap"


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
