"""The port's frontier-live engine (babble_tpu_torch.tpu.frontier_live,
plain versions on the CPU) against the JAX package's: every FrState field
after every frontier_train_step, in both voting-table layouts, on the
fixtures of test_incremental.py's frontier-live tests (one-shot equality,
small against large trains, multi-train against per-train, the l_over
latch) and test_doubling.py's bootstrap tests, with an r_over case, a
state carried across from the reference mid-stream, the rows_by quirk past the index axis, the walk
step with first descendants from INV, and the decide alone (its input
left intact). Exact equality, no tolerance; INV is compared as integers
(float32 in the reference, int32 in the port)."""

import functools

import numpy as np
import pytest
import torch

import babble_tpu.tpu.frontier as ref_frontier
import babble_tpu.tpu.frontier_live as ref
import babble_tpu.tpu.incremental as ref_inc
from babble_tpu.tpu import synthetic_grid as ref_synthetic_grid
from babble_tpu.tpu.engine import run_frontier_passes as ref_run_frontier_passes
from babble_tpu.tpu.engine import run_passes as ref_run_passes
from babble_tpu.tpu.grid import section_grid as ref_section_grid
from babble_tpu.tpu.grid import synthetic_deep_grid as ref_synthetic_deep_grid
from babble_tpu_torch.tpu import GridUnsupported
from babble_tpu_torch.tpu import frontier as port_frontier
from babble_tpu_torch.tpu import frontier_live as fl
from babble_tpu_torch.tpu import incremental as inc
from babble_tpu_torch.tpu.engine import run_frontier_passes, run_passes, stage_frontier
from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def grids(n, e, seed, zipf, byz=0.0):
    """The reference's and the port's grid of one fixture (same RNG stream)."""
    kw = dict(seed=seed, zipf_a=zipf, byzantine_frac=byz, record_fd_updates=True)
    return ref_synthetic_grid(n, e, **kw), synthetic_grid(n, e, **kw)


def ref_train(t):
    """A port Train (numpy fields) as the reference's."""
    return ref_inc.Train(*[np.asarray(f) for f in t])


def assert_fr_equal(ps, js, what):
    for f in fl.FrState._fields:
        g = getattr(ps, f).cpu().numpy()
        w = np.asarray(getattr(js, f))
        if f == "inv":
            assert (np.rint(w) == w).all()
            w = w.astype(np.int32)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {f} {g.dtype}{g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def replay(fixture, train_size, e_cap=4096, l_cap=256, r_cap=64, packed=False):
    """Both packages through the fixture's trains, every field held equal
    after every train; returns the port's final state."""
    g, pg = grids(*fixture)
    trains = inc.trains_from_grid(pg, train_size, 16384, e_cap)
    js = ref.init_frontier_state(g.n, e_cap, l_cap, r_cap)
    ps = fl.init_frontier_state(g.n, e_cap, l_cap, r_cap, device=CPU)
    for k, t in enumerate(trains):
        js = ref.frontier_train_step(js, ref_train(t), g.super_majority, g.n, packed=packed)
        out = fl.frontier_train_step(ps, t, g.super_majority, g.n, packed=packed)
        assert out is ps
        assert_fr_equal(ps, js, f"train {k} (size {train_size}, packed {packed})")
    return ps


def no_latch(st):
    return not bool(st.l_over) and not bool(st.r_over) and not bool(st.frozen_violation)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("zipf", [0.0, 1.1])
def test_frontier_live_matches_one_shot(zipf, packed):
    """test_incremental.py: after train-sized appends the state equals the
    one-shot pipeline on the same DAG (here: equal to the reference after
    every train, and at the end to both packages' run_passes)."""
    fixture = (16, 2048, 3, zipf)
    st = replay(fixture, 256, packed=packed)
    assert no_latch(st)
    g, pg = grids(*fixture)
    want = ref_run_passes(g, adaptive_r=True)
    got = run_passes(pg, adaptive_r=True, device=CPU)
    e = g.e
    for f in ("rounds", "witness", "lamport", "received"):
        np.testing.assert_array_equal(getattr(st, f)[:e].numpy(), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert int(st.last_round) == want.last_round


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_live_small_trains_match_large(packed):
    """Trains of 32 and of 512 events land in the same decisions."""
    fixture = (8, 1024, 9, 1.1)
    a = replay(fixture, 32, packed=packed)
    b = replay(fixture, 512, packed=packed)
    for f in ("rounds", "witness", "received", "wtable", "fame_decided", "famous"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_multi_train_matches_per_train(packed):
    """frontier_multi_train over the stacked trains equals the reference's
    in every field and the port's per-train steps in the decisions."""
    fixture = (8, 1024, 5, 1.1)
    g, pg = grids(*fixture)
    e_cap, l_cap, r_cap = 2048, 256, 64
    trains = inc.trains_from_grid(pg, 128, 16384, e_cap)
    a = replay(fixture, 128, e_cap, l_cap, r_cap, packed=packed)
    js = ref.frontier_multi_train(
        ref.init_frontier_state(g.n, e_cap, l_cap, r_cap),
        ref_inc.stack_trains([ref_train(t) for t in trains]), g.super_majority, g.n,
        packed=packed)
    b = fl.init_frontier_state(g.n, e_cap, l_cap, r_cap, device=CPU)
    assert fl.frontier_multi_train(b, inc.stack_trains(trains), g.super_majority, g.n,
                                   packed=packed) is b
    assert_fr_equal(b, js, "multi_train")
    for f in ("rounds", "witness", "received", "last_round"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("packed", [False, True])
def test_frontier_live_l_over_latch(packed):
    """A chain outgrowing the index axis latches l_over in both packages,
    with every field (rows_by's overwritten last cell too) equal."""
    st = replay((8, 512, 2, 2.0), 128, e_cap=1024, l_cap=16, packed=packed)
    assert bool(st.l_over)


def test_frontier_live_r_over_latch():
    """A round axis too short for the grid latches r_over in both packages
    (r_cap 8: the window is the whole axis), every field equal."""
    st = replay((8, 1024, 9, 1.1), 128, e_cap=2048, r_cap=8)
    assert bool(st.r_over) and not bool(st.l_over)


@pytest.mark.parametrize("packed", [False, True])
def test_state_from_numpy_carries_a_mid_stream_state(packed):
    """frontier_state_from_numpy of the reference's state after some
    trains, then one more train in both packages: equal states."""
    fixture = (8, 1024, 5, 1.1)
    g, pg = grids(*fixture)
    e_cap, l_cap, r_cap = 2048, 256, 64
    trains = inc.trains_from_grid(pg, 128, 16384, e_cap)
    js = ref.init_frontier_state(g.n, e_cap, l_cap, r_cap)
    for t in trains[:4]:
        js = ref.frontier_train_step(js, ref_train(t), g.super_majority, g.n, packed=packed)
    ps = fl.frontier_state_from_numpy(js, device=CPU)
    assert ps.inv.dtype == torch.int32
    assert_fr_equal(ps, js, "carried state")
    js = ref.frontier_train_step(js, ref_train(trains[4]), g.super_majority, g.n,
                                 packed=packed)
    fl.frontier_train_step(ps, trains[4], g.super_majority, g.n, packed=packed)
    assert_fr_equal(ps, js, "one more train")


def test_decide_alone_leaves_its_input_intact():
    """_decide on a mid-stream state (dirty chains pending, appended
    without a walk) equals the reference's _decide and writes nothing of
    its input."""
    fixture = (8, 1024, 5, 1.1)
    g, pg = grids(*fixture)
    e_cap, l_cap, r_cap = 2048, 256, 64
    trains = inc.trains_from_grid(pg, 128, 16384, e_cap)
    js = ref.init_frontier_state(g.n, e_cap, l_cap, r_cap)
    for t in trains[:3]:
        js = ref.frontier_train_step(js, ref_train(t), g.super_majority, g.n)
    js = ref._append_train(js, ref_train(trains[3]))
    ps = fl.frontier_state_from_numpy(js, device=CPU)
    before = fl.clone_frontier_state(ps)
    assert bool(ps.dirty.any())
    got = fl._decide(ps, g.super_majority, g.n, packed=True)
    want = ref._decide(js, g.super_majority, g.n, packed=True)
    assert_fr_equal(got, want, "_decide")
    for f in fl.FrState._fields:
        assert torch.equal(getattr(ps, f), getattr(before, f)), f


@pytest.mark.parametrize("k,moving", [(0, False), (1, True)],
                         ids=["stops-before-r_win", "moving-at-its-end"])
def test_decide_window_walk_ends(k, moving):
    """_decide on a mid-stream state (train k appended, not yet walked)
    equals the reference's, with the window's walk either reaching its
    fixed point before r_win steps (the CUDA walk stops there and the
    window's later rows repeat X; r_over stays clear) or still moving at
    its last step, where r_over latches (r_cap 8: the window is the whole
    axis)."""
    fixture = (8, 1024, 9, 1.1)
    g, pg = grids(*fixture)
    e_cap, l_cap, r_cap = 2048, 256, 8
    trains = inc.trains_from_grid(pg, 256, 16384, e_cap)
    js = ref.init_frontier_state(g.n, e_cap, l_cap, r_cap)
    for t in trains[:k]:
        js = ref.frontier_train_step(js, ref_train(t), g.super_majority, g.n)
    js = ref._append_train(js, ref_train(trains[k]))
    ps = fl.frontier_state_from_numpy(js, device=CPU)
    assert not bool(ps.r_over)
    win = fl._decide_window_plain(ps, g.super_majority)
    l = ps.rows_by.shape[1]
    r_win = min(fl.R_WIN, r_cap)
    first_sent = (ps.x_hist < l).sum(dim=0)
    floor = int(torch.where(ps.dirty, first_sent, torch.full_like(first_sent, r_cap)).min())
    start = max(min(floor, r_cap - r_win) - 1, 0)
    rows = win.x_hist[start:start + r_win]
    fixed = [torch.equal(rows[r + 1], rows[r]) for r in range(r_win - 1)]
    assert any(fixed) != moving and bool(win.r_over) == moving
    if not moving:
        first = fixed.index(True)
        assert all(fixed[first:]) and first + 2 < r_win, "no fixed point mid-window"
    got = fl._decide(ps, g.super_majority, g.n)
    assert_fr_equal(got, ref._decide(js, g.super_majority, g.n), "_decide")


def test_rows_by_overwrites_its_last_cell_past_the_index_axis():
    """Events past the index axis write rows_by's clipped last cell, the
    last one in train order winning, and latch l_over; INV, the staging
    and the flags equal the reference's _append_train."""
    n, l, e_cap = 4, 4, 16
    kb = 6
    # chain 1 gets indexes 2, 3, 4, 5 (two past the axis); chain 0 index 0
    creator = np.array([1, 1, 1, 1, 0, 0], np.int32)
    index = np.array([2, 3, 4, 5, 0, 0], np.int32)
    rows = np.array([3, 4, 5, 6, 7, -1], np.int32)
    la = np.full((kb, n), -1, np.int32)
    la[:, 1] = index
    la[4, 0] = 0
    la[:4, 0] = [0, 0, 0, 1]
    sp_pos = np.array([-1, 0, 1, 2, -1, -1], np.int32)
    sp_row = np.array([2, 3, 4, 5, -1, -1], np.int32)
    train = inc.Train(
        rows=rows, creator=creator, index=index, sp_row=sp_row, op_row=np.full(kb, -1, np.int32),
        sp_pos=sp_pos, op_pos=np.full(kb, -1, np.int32), la_rows=la,
        coin=np.array([1, 0, 1, 0, 1, 0], bool), fixed_round=np.full(kb, -1, np.int32),
        upd_row=np.full(1, e_cap, np.int32), upd_col=np.zeros(1, np.int32),
        upd_val=np.zeros(1, np.int32), levels=np.full((1, kb), -1, np.int32),
        lamport=np.arange(kb, dtype=np.int32),
    )
    js = ref._append_train(ref.init_frontier_state(n, e_cap, l, 8), ref_train(train))
    ps = fl.init_frontier_state(n, e_cap, l, 8, device=CPU)
    fl._append_train(ps, inc.device_put(train, CPU))
    assert_fr_equal(ps, js, "_append_train")
    assert int(ps.rows_by[1, l - 1]) == 6 and bool(ps.l_over)


@pytest.mark.parametrize("fixture", [(8, 512, 3, 1.1), (16, 1024, 4, 1.1)])
def test_walk_step_with_first_descendants_from_inv(fixture):
    """make_walk_step with fd=None (fd rows from INV) and the binary-search
    m0 equals the reference's step, and the step over the grid's own fd,
    at every round of the grid's walk."""
    g, pg = grids(*fixture)
    s = stage_frontier(pg, torch.device(CPU))
    inv = port_frontier.build_inv(s.rows_by, s.la)
    step = port_frontier.make_walk_step(inv, s.rows_by, None, s.la, g.super_majority,
                                        m0_mode="binsearch")
    step_fd = port_frontier.make_walk_step(inv, s.rows_by, s.fd, s.la, g.super_majority)
    ref_step = ref_frontier.make_walk_step(
        inv.numpy().astype(np.float32), s.rows_by.numpy(), None, s.la.numpy(),
        g.super_majority, m0_mode="binsearch")
    x = port_frontier.frontier_x0(s.rows_by)
    l = s.rows_by.shape[1]
    steps = 0
    while bool((x < l).any()):
        nxt = step(x)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_step(x.numpy())))
        assert torch.equal(nxt, step_fd(x))
        x = nxt
        steps += 1
    assert steps > 3


@pytest.mark.parametrize("packed", [False, True])
def test_bootstrap_frontier_state_matches_oneshot(packed):
    """test_doubling.py: the cold-started state carries the one-shot
    pipeline's decisions with every latch clear; here every field equals
    the reference's bootstrap too."""
    kw = dict(seed=4, zipf_a=1.1)
    g, pg = ref_synthetic_grid(8, 600, **kw), synthetic_grid(8, 600, **kw)
    caps = dict(e_cap=g.e + 64, l_cap=int(g.index.max()) + 32, r_cap=256, n_participants=g.n)
    st = fl.bootstrap_frontier_state(pg, packed=packed, device=CPU, **caps)
    assert_fr_equal(st, ref.bootstrap_frontier_state(g, packed=packed, **caps), "bootstrap")
    want = ref_run_frontier_passes(g)
    got = run_frontier_passes(pg, device=CPU)
    for f in ("rounds", "witness", "received"):
        np.testing.assert_array_equal(getattr(st, f)[:g.e].numpy(), getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert int(st.last_round) == int(want.last_round)
    assert int(st.count) == g.e and no_latch(st)


def test_bootstrap_frontier_state_rejects_seeded():
    """A seeded (post-reset) section is refused in both packages."""
    g = ref_synthetic_deep_grid(6, 96, seed=2, zipf_a=1.0)
    pg = synthetic_deep_grid(6, 96, seed=2, zipf_a=1.0)
    sec = ref_section_grid(g, ref_run_passes(g), g.num_levels // 2)
    psec = section_grid(pg, run_passes(pg, device=CPU), pg.num_levels // 2)
    caps = dict(e_cap=sec.e + 64, l_cap=4096, r_cap=256, n_participants=6)
    with pytest.raises(Exception) as ref_err:
        ref.bootstrap_frontier_state(sec, **caps)
    assert type(ref_err.value).__name__ == "GridUnsupported"
    with pytest.raises(GridUnsupported, match="seeded"):
        fl.bootstrap_frontier_state(psec, device=CPU, **caps)
