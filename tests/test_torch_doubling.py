"""The port's log-diameter cold path (babble_tpu_torch.tpu.doubling, plain
versions on the CPU) against the JAX package's tpu/doubling.py on the same
inputs: the closure with its pass count, every chunk of the contracted
walk (seeded and unseeded, with the first_nw mask), the seeded lamport
scan and run_doubling_passes with its stats, on the level-scan suite's
grids (base fixtures, section cuts, real post-reset grids). Exact
equality, no tolerance."""

import numpy as np
import pytest
import torch

import babble_tpu.tpu.doubling as ref
from babble_tpu_torch.tpu import GridUnsupported, grid_from_arrays
from babble_tpu_torch.tpu import doubling as port
from babble_tpu_torch.tpu import engine as port_engine
from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid

from test_doubling import assert_matches
from test_torch_levelscan import CASE_IDS, CASES, fixture_grid


def staged(case):
    """(reference grid, port grid, the port's cold-path staging on the
    CPU); None for the grids the reference's cold path refuses."""
    grid = fixture_grid(case)
    pg = grid_from_arrays(vars(grid))
    try:
        st = port.stage_doubling(pg, torch.device("cpu"))
        la, _ = port._closure_la(
            st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d,
            st.l_b, st.block, st.pass_cap,
        )
        if not (la.numpy()[: grid.e] == st.la_rb).all():
            return grid, pg, None
    except GridUnsupported:
        return grid, pg, None
    return grid, pg, st


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_closure_la_matches_reference_with_pass_count(case):
    """The plain closure squares into a second buffer, as the reference's
    blocked map does, so its pass count is the reference's on every grid,
    including those whose staged coordinates the closure contradicts."""
    grid = fixture_grid(case)
    pg = grid_from_arrays(vars(grid))
    try:
        st = port.stage_doubling(pg, torch.device("cpu"))
    except GridUnsupported:
        with pytest.raises(ref.GridUnsupported):
            ref.run_doubling_passes(grid)
        return
    args = (st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d)
    want_la, want_passes = ref._closure_la(
        *[a.numpy() for a in args], l=st.l_b, block=st.block, pass_cap=st.pass_cap,
    )
    got_la, got_passes = port._closure_la(*args, st.l_b, st.block, st.pass_cap)
    np.testing.assert_array_equal(got_la.numpy(), np.asarray(want_la))
    assert got_passes == int(want_passes)
    # a smaller block changes the plain version's chunking, not its result
    small = port._closure_la(*args, st.l_b, 64, st.pass_cap)
    np.testing.assert_array_equal(small[0].numpy(), np.asarray(want_la))
    assert small[1] == got_passes


def squares_in_place_passes(st):
    """The pass count of a closure that squares in place, row by row in
    order (each row already sees the rows updated before it in the same
    pass): the mistake chip_smoke.py's pass-count comparison catches."""
    la = port._closure_init(st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by.shape[0])
    l = st.l_b
    rb = st.rows_by_d.clamp(min=0).long()
    n = la.shape[1]
    passes, changed = 0, True
    while changed and passes < st.pass_cap:
        before = la.clone()
        lat = torch.where((st.rows_by_d >= 0)[:, :, None], la[rb], -1)
        lat = torch.cummax(lat, dim=1).values
        on = (st.idx_d >= 0)[:, None]
        la = torch.where(on, lat[st.creator_d.clamp(0, n - 1).long(),
                                 st.idx_d.clamp(0, l - 1).long()], la)
        for e in range(la.shape[0]):
            row = la[e]
            ok = row >= 0
            tgt = rb[torch.arange(n), row.clamp(0, l - 1).long()]
            contrib = torch.where(ok[:, None], la[tgt], -1).amax(dim=0)
            la[e] = torch.maximum(row, contrib)
        changed = bool((la != before).any())
        passes += 1
    return passes


def test_in_place_squaring_changes_the_pass_count():
    grid = fixture_grid(("section", 1.0 / 3.0, True))
    st = port.stage_doubling(grid_from_arrays(vars(grid)), torch.device("cpu"))
    _, passes = port._closure_la(
        st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d,
        st.l_b, st.block, st.pass_cap,
    )
    assert squares_in_place_passes(st) != passes


# the grids the cold path accepts (it refuses the block-1 resets, see
# test_cold_path_refuses_what_the_reference_refuses)
WALK_CASES = [c for c in CASES if c[:1] != ("reset",) or c[2] == 0]
WALK_IDS = [i for c, i in zip(CASES, CASE_IDS) if c in WALK_CASES]


@pytest.mark.parametrize("case", WALK_CASES, ids=WALK_IDS)
def test_walk_chunks_match_reference(case):
    """Every chunk of the host-driven walk: the port's plain chunk and the
    reference's _walk_chunk on the same inputs, compared before the walk
    goes on."""
    grid, pg, st = staged(case)
    assert st is not None
    inv = port.build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = port.walk_seeds(pg, st)
    seen = []

    def walk(*a):
        got = port._walk_chunk(*a)
        statics = dict(zip(("super_majority", "l", "length", "steps", "use_seeds"), a[8:]))
        want = ref._walk_chunk(*[np_(x) for x in a[:8]], **statics)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        seen.append((a[10], a[11], a[12]))
        return got

    stats = {}
    hist = port._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)), inv, st.rows_by_d,
        st.fd_d, st.la_d, x0, s_np, first_nw, pg.super_majority, st.l_b,
        st.seeded, stats, walk=walk,
    )
    assert len(seen) == stats["walk_chunks"] >= 1
    assert all(use_seeds == st.seeded for _, _, use_seeds in seen)
    assert hist.shape[0] == 1 + sum(length for length, _, _ in seen)


def test_walk_grids_cover_seeded_unseeded_and_first_nw():
    """The walk test's grids include unseeded and seeded walks, and on the
    unpinned section the first_nw mask fires: some chain's frontier sits at
    its first row at exactly the round first_nw names."""
    assert {staged(case)[2].seeded for case in WALK_CASES} == {False, True}
    for case in CASES:
        if case not in WALK_CASES:
            assert staged(case)[2] is None
    grid, pg, st = staged(("section", 0.5, False))
    s_np, first_nw, x0 = port.walk_seeds(pg, st)
    hist = port._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)),
        port.build_inv(st.rows_by_d, st.la_d), st.rows_by_d, st.fd_d, st.la_d,
        x0, s_np, first_nw, pg.super_majority, st.l_b, True, {},
    )
    fired = [c for c in range(pg.n)
             if 0 <= first_nw[c] < hist.shape[0] and hist[first_nw[c], c] == 0]
    assert fired


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_lamport_scan_and_seeded_lamport_match_reference(case):
    grid = fixture_grid(case)
    pg = grid_from_arrays(vars(grid))
    args = port.lamport_inputs(pg, torch.device("cpu"))
    want = ref._lamport_levels_scan(*[a.numpy() for a in args])
    got = port._lamport_levels_scan(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port.seeded_lamport(pg, device="cpu"), ref.seeded_lamport(grid),
    )


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_run_doubling_passes_matches_reference(case):
    grid = fixture_grid(case)
    pg = grid_from_arrays(vars(grid))
    want_stats, got_stats = {}, {}
    try:
        want = ref.run_doubling_passes(grid, stats=want_stats)
    except ref.GridUnsupported as refused:
        with pytest.raises(GridUnsupported, match=str(refused)):
            port.run_doubling_passes(pg, stats=got_stats, device="cpu")
        return
    got = port.run_doubling_passes(pg, stats=got_stats, device="cpu")
    assert got_stats == want_stats
    assert got.round_offset == want.round_offset
    np.testing.assert_array_equal(got.witness_table, want.witness_table)
    assert_matches(got, want, str(case))


def test_cold_path_refuses_what_the_reference_refuses():
    """Real post-reset grids reset from block 1 are not ancestry-closed in
    section coordinates: both packages refuse them on the cold path."""
    for case in (("reset", "funky", 1), ("reset", "sparse", 1)):
        grid = fixture_grid(case)
        with pytest.raises(ref.GridUnsupported):
            ref.run_doubling_passes(grid)
        with pytest.raises(GridUnsupported, match="closure"):
            port.run_doubling_passes(grid_from_arrays(vars(grid)), device="cpu")


def test_crossover_and_ladder_predicate(monkeypatch):
    monkeypatch.delenv("BABBLE_DOUBLING_CROSSOVER", raising=False)
    assert port.doubling_crossover(False) == ref.doubling_crossover(False) == 1024
    assert port.doubling_crossover(True) == ref.doubling_crossover(True) == 192
    monkeypatch.setenv("BABBLE_DOUBLING_CROSSOVER", "7")
    assert port.doubling_crossover(False) == port.doubling_crossover(True) == 7
    g = synthetic_deep_grid(8, 64, seed=1, zipf_a=1.2)
    assert port.use_doubling(g)
    monkeypatch.delenv("BABBLE_DOUBLING_CROSSOVER")
    assert not port.use_doubling(g)
    assert port.use_doubling(g, prefer=True) == ref.use_doubling(g, prefer=True)
    sec = section_grid(g, port_engine.run_passes(g, device="cpu"), g.num_levels // 2)
    assert port.use_doubling(sec) == ref.use_doubling(sec)


def test_run_doubling_passes_refuses_packed_empty_and_a_missing_card(monkeypatch):
    import dataclasses

    g = grid_from_arrays(vars(fixture_grid(("synthetic", 4, 64, 1, 0.0, 0.0))))
    with pytest.raises(NotImplementedError):
        port.run_doubling_passes(g, device="cpu", packed=True)
    with pytest.raises(GridUnsupported):
        port.run_doubling_passes(dataclasses.replace(g, e=0), device="cpu")
    assert not port.use_doubling(dataclasses.replace(g, e=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_doubling_passes(g)
