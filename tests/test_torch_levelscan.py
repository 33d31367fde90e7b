"""The port's level scan (babble_tpu_torch.tpu.kernels.divide_rounds and
consensus_pipeline, engine.run_passes; plain versions on the CPU) against
the JAX package's on the same grids: the non-slow rows of
test_doubling.py's fixture matrix, section_grid cuts of a deep grid (a
third pinned, half unpinned) and real post-reset grids (the funky and
sparse hashgraphs of test_reset_frame.py, reset from block 0 and block 1
with the wire diff inserted, staged by the reference's grid_from_hashgraph)
and a hashgraph in which one of four validators never creates an event.
Exact equality, no tolerance."""

import functools

import numpy as np
import pytest
import torch

import babble_tpu.tpu.engine as ref_engine
import babble_tpu.tpu.kernels as ref_kernels
from babble_tpu.hashgraph import Frame, Hashgraph, InmemStore
from babble_tpu.tpu import grid_from_hashgraph, synthetic_grid
from babble_tpu.tpu.grid import section_grid, synthetic_deep_grid
from babble_tpu_torch.tpu import GridUnsupported, grid_from_arrays
from babble_tpu_torch.tpu import _ext
from babble_tpu_torch.tpu import engine as port_engine
from babble_tpu_torch.tpu import kernels as port_kernels

from chip_smoke import level_traps
from dsl import CACHE_SIZE, init_funky_hashgraph, init_sparse_hashgraph
from test_doubling import assert_matches
from test_reset_frame import _wire_diff
from test_torch_engine import partial_participation_hashgraph

# test_doubling.py's fixture matrix, its non-slow rows (n, e, seed, zipf, byz)
SCAN_FIXTURES = [
    (4, 64, 1, 0.0, 0.0),
    (8, 512, 3, 1.1, 0.0),
    (16, 1024, 4, 1.1, 0.0),
    (32, 1024, 11, 1.05, 1.0 / 3.0),
    (64, 2048, 13, 1.05, 1.0 / 3.0),
]
# (cut fraction, pin_cut) of test_doubling.py's non-slow section cuts
SECTION_CUTS = [(1.0 / 3.0, True), (1.0 / 2.0, False)]
RESET_CASES = [("funky", 0), ("funky", 1), ("sparse", 0), ("sparse", 1)]
# the hand-built trap tables the kernels are held to on the card too
TRAPS = level_traps()


@functools.lru_cache(maxsize=None)
def deep_grid():
    """The deep base grid test_doubling.py cuts its sections from, and the
    reference's level-scan results on it."""
    g = synthetic_deep_grid(6, 256, seed=2, zipf_a=1.0)
    return g, ref_engine.run_passes(g)


@functools.lru_cache(maxsize=None)
def reset_grid(name: str, block_index: int):
    """A real post-reset grid: the fixture hashgraph decided, a fresh one
    reset from block `block_index`'s frame, the wire diff above it
    inserted, staged by the reference's grid_from_hashgraph."""
    builder = {
        "funky": lambda: init_funky_hashgraph(full=True),
        "sparse": init_sparse_hashgraph,
    }[name]
    h, _, _ = builder()
    h.divide_rounds()
    h.decide_fame()
    h.decide_round_received()
    h.process_decided_rounds()
    block = h.store.get_block(block_index)
    frame = Frame.from_json(h.get_frame(block.round_received()).to_json())
    h2 = Hashgraph(h.participants, InmemStore(h.participants, CACHE_SIZE))
    h2.reset(block, frame)
    for wev in _wire_diff(h, h2):
        h2.insert_event(h2.read_wire_info(wev), False)
    return grid_from_hashgraph(h2)


def fixture_grid(case):
    """The reference DagGrid of a case id."""
    kind, *params = case
    if kind == "synthetic":
        n, e, seed, zipf, byz = params
        return synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    if kind == "section":
        frac, pin = params
        g, full = deep_grid()
        return section_grid(g, full, int(g.num_levels * frac), pin_cut=pin)
    if kind == "hashgraph":
        # 4 participants, 3 ever create: one chain stays empty
        return grid_from_hashgraph(partial_participation_hashgraph())
    name, block_index = params
    return reset_grid(name, block_index)


CASES = (
    [("synthetic",) + fx for fx in SCAN_FIXTURES]
    + [("section",) + cut for cut in SECTION_CUTS]
    + [("reset",) + rc for rc in RESET_CASES]
    + [("hashgraph", "partial_participation")]
)
CASE_IDS = [
    "-".join(str(round(p, 3)) if isinstance(p, float) else str(p) for p in c)
    for c in CASES
]


def t(a):
    return torch.from_numpy(np.array(a))


def scan_args(grid):
    """The scan's thirteen array arguments, numpy, in the reference's order."""
    return [getattr(grid, f) for f in port_engine.SCAN_FIELDS[:13]]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_divide_rounds_matches_reference(case):
    grid = fixture_grid(case)
    args = scan_args(grid)
    want = ref_kernels.divide_rounds(
        *args, super_majority=grid.super_majority, r_max=grid.r_max,
    )
    got = port_kernels.divide_rounds(
        *[t(a) for a in args], grid.super_majority, grid.r_max,
    )
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_consensus_pipeline_matches_reference(case):
    """At run_passes(bucketed=True)'s shapes: rebased, padded, r_max
    bucketed; a fame axis of 64 rounds (or r_max, if smaller)."""
    grid, _, r_max = port_engine.scan_layout(grid_from_arrays(vars(fixture_grid(case))), True)
    args = scan_args(grid) + [grid.coin_bit]
    r_fame = min(64, r_max)
    statics = dict(super_majority=grid.super_majority, n_participants=grid.n,
                   r_max=r_max, r_fame=r_fame, d_cap=r_fame + 2)
    want = ref_kernels.consensus_pipeline(*args, **statics)
    got = port_kernels.consensus_pipeline(*[t(a) for a in args], *statics.values())
    assert int(want.last_round) + 2 <= r_fame
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("bucketed", [False, True], ids=["plain", "bucketed_adaptive"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_run_passes_matches_reference(case, bucketed):
    grid = fixture_grid(case)
    kw = dict(bucketed=True, adaptive_r=True) if bucketed else {}
    want = ref_engine.run_passes(grid, **kw)
    got = port_engine.run_passes(grid_from_arrays(vars(grid)), device="cpu", **kw)
    assert got.round_offset == want.round_offset
    for name in ("rounds", "witness", "lamport", "received"):
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert_matches(got, want, f"{case} bucketed={bucketed}")


def test_reset_grids_are_post_reset_from_block_one():
    """Block 0 resets give base-shaped grids; block 1 resets carry external
    round metadata, which only the level scan (and the cold path) take."""
    for name, block_index in RESET_CASES:
        grid = reset_grid(name, block_index)
        assert ref_engine._frontier_safe(grid) == (block_index == 0), name


def test_rebase_rounds_matches_reference():
    g, full = deep_grid()
    sec = section_grid(g, full, g.num_levels // 2)
    want, want_off = ref_engine.rebase_rounds(sec)
    got, got_off = port_engine.rebase_rounds(grid_from_arrays(vars(sec)))
    assert got_off == want_off > 0
    for name in ("fixed_round", "ext_sp_round", "ext_op_round"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_post_reset_refusal_points_at_the_other_engines():
    g, full = deep_grid()
    sec = grid_from_arrays(vars(section_grid(g, full, g.num_levels // 3)))
    with pytest.raises(GridUnsupported, match="run_passes.*run_doubling_passes"):
        port_engine.run_frontier_passes(sec, device="cpu")
    res = port_engine.run_passes(sec, device="cpu", bucketed=True, adaptive_r=True)
    assert res.round_offset > 0


def test_run_passes_refuses_packed_and_a_missing_card(monkeypatch):
    """packed=True (once refused) equals the reference's packed run and the
    port's wide one; a host without a card still raises."""
    ref_g = synthetic_grid(4, 64, seed=1)
    g = grid_from_arrays(vars(ref_g))
    got = port_engine.run_passes(g, device="cpu", packed=True)
    assert_matches(got, ref_engine.run_passes(ref_g, packed=True), "packed")
    assert_matches(got, port_engine.run_passes(g, device="cpu", packed=False), "wide")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.run_passes(g)


def test_last_level_skips_trailing_padding_only():
    levels = torch.tensor([[0, -1], [-1, -1], [1, 2], [-1, -1]], dtype=torch.int32)
    assert port_kernels.last_level(levels) == 2
    assert port_kernels.last_level(torch.full((3, 2), -1, dtype=torch.int32)) == -1


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_divide_rounds_traps(name):
    """Index clamps, dropped scatters and the order of a level's reads and
    writes on hand-built level tables (chip_smoke.level_traps, which phase
    6 runs through the kernel in every carry form): a padding lane beside
    row 0 must not overwrite row 0; a round past r_max clamps into the
    last witness-table row; a negative parent round reads no witness row;
    an external parent's round and lamport come from the ext_* metadata;
    the fixed overrides win; a parent in the same or a later level reads
    the initial carry; a parent index at or past E clamps to E - 1;
    lamport wraps around at 2^31 - 1; padding lanes ahead of real ones and
    levels of padding alone change nothing."""
    arrays, super_majority, r_maxes = TRAPS[name]
    e, n = arrays[5].shape
    for r_max in r_maxes:
        want = ref_kernels.divide_rounds(
            *arrays, super_majority=super_majority, r_max=r_max,
        )
        got = port_kernels.divide_rounds(
            *[t(a) for a in arrays], super_majority, r_max,
        )
        for field in want._fields:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{name} r_max={r_max} {field}",
            )
        assert np.asarray(want.witness_table).shape == (r_max, n)
    lamport, rounds = got.lamport.tolist(), got.rounds.tolist()
    if name == "clamps_and_overrides":
        assert lamport == [0, 41, 7]
        assert rounds[1] == 5 and got.witness[1].item() is False
    elif name == "same_level_parent":
        # rows 1 and 3 read their same-level parents' initial -1
        assert rounds[1] == rounds[3] == -1 and lamport[1] == 0 and lamport[3] == 1
        assert rounds[0] == 2 and lamport[0] == 11
    elif name == "parent_past_e":
        # row 0's parents clamp to row 3, written at the level before
        assert lamport[0] == lamport[3] + 1 and rounds[0] == rounds[3]
    elif name == "lamport_wraps":
        assert lamport == [-(2 ** 31), 6, 2 ** 31 - 1, -(2 ** 31)]
    else:
        assert got.witness.tolist() == [True, False, True, False]
        assert lamport == [5, 6, 7, 8]


def test_level_walk_plan_places_the_carry():
    """The one rule that lays out the staged level walks (K5's one-block
    walk, K8): each carry's first rows in shared memory as far as the card
    allows beside the ring (and K5's window), the rest in device memory;
    "device" keeps every row there. At the catch-up section's shapes (8
    validators, 65,536 bucketed events, 16,384 witness-table rows) every
    row of the section (32,760 events) is on chip; the whole catch-up grid
    (65,536 events) keeps the rows past what fits in device memory; a
    witness table too large for the window's written-round bits goes
    without the window; K8's levels too wide for the ring are read in
    place; no size is refused, and every launch fits the card."""
    sec = _ext.level_walk_plan("divide_rounds", 65536, 8, 8, 16384)
    assert sec["carry"] == "shared" and sec["rounds"]["win"] == _ext.WALK_WINDOW
    assert sec["rounds"]["chip"] >= 32760 and sec["lamport"]["chip"] >= 32760
    assert sec["rounds"]["group"] * 8 <= 32 and sec["rounds"]["warps"] == 1
    grid = _ext.level_walk_plan("divide_rounds", 65536, 8, 8, 32768)
    assert 0 < grid["rounds"]["chip"] < 65536 and 0 < grid["lamport"]["chip"] < 65536
    dev = _ext.level_walk_plan("divide_rounds", 65536, 8, 8, 16384, carry="device")
    assert dev["rounds"]["chip"] == dev["lamport"]["chip"] == dev["rounds"]["win"] == 0
    assert dev["smem"] < sec["smem"] == _ext.MAX_SMEM_BYTES
    small = _ext.level_walk_plan("divide_rounds", 256, 4, 4, 64)
    assert small["rounds"]["chip"] == small["lamport"]["chip"] == 256
    assert _ext.level_walk_plan("divide_rounds", 4096, 31, 31, 1 << 26)["rounds"]["win"] == 0
    wide = _ext.level_walk_plan("divide_rounds", 32768, 24, 24, 4096)
    assert (wide["rounds"]["group"], wide["rounds"]["warps"]) == (32, 24)
    assert _ext.level_walk_plan("lamport_scan", 65536, 1, 8)["lamport"]["staged"]
    far = _ext.level_walk_plan("lamport_scan", 100, 1, 60000)
    assert not far["lamport"]["staged"] and far["lamport"]["chip"] == 100
    for plan in (sec, grid, dev, small, wide, far):
        assert plan["smem"] <= _ext.MAX_SMEM_BYTES and plan["threads"] <= 1024
    assert _ext.walk_form_fits("divide_rounds", "block", 31, n_lvl=31)
    assert not _ext.walk_form_fits("divide_rounds", "block", 1000, n_lvl=64)
    with pytest.raises(ValueError, match="carry form"):
        _ext.level_walk_plan("lamport_scan", 8, 1, 8, carry="l2")
