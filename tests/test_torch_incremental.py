"""The port's incremental engine (babble_tpu_torch.tpu.incremental, plain
versions on the CPU) against the JAX package's: the host builders field
for field, and every IncState field after every step / multi_step /
train_step / multi_train call, on the fixtures of test_incremental.py,
with a round window narrower than the round capacity (the freeze acts), a
round capacity small enough to fire the capacity latch on both append
paths, the stale latch, and the decide alone on states carried across
from the reference mid-run. Exact equality, no tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import babble_tpu.tpu.incremental as ref
from babble_tpu.tpu import synthetic_grid as ref_synthetic_grid
from babble_tpu_torch.tpu import engine as port_engine
from babble_tpu_torch.tpu import incremental as inc
from babble_tpu_torch.tpu.grid import synthetic_grid

# (n, e, seed, zipf) of test_incremental.py's grids, and a Zipf-2 grid
# whose hottest chain forces batch splits (within-batch depth > L_MAX)
GRIDS = [(8, 768, 3, 0.0), (8, 768, 3, 1.1), (8, 512, 5, 1.1), (8, 512, 7, 1.1)]
SPLIT_GRID = (8, 300, 7, 2.0)
# a random voting window at 8 validators whose verdicts change with the
# coin bits: the unrolled offset d = 8 is a coin step
COIN_WINDOW = (8, 12, 43)


@functools.lru_cache(maxsize=None)
def grids(n, e, seed, zipf):
    """The reference's and the port's grid of one fixture (same RNG stream)."""
    kw = dict(seed=seed, zipf_a=zipf, record_fd_updates=True)
    return ref_synthetic_grid(n, e, **kw), synthetic_grid(n, e, **kw)


def ref_arrays(st):
    return {f: np.asarray(getattr(st, f)) for f in ref.IncState._fields}


def assert_state_equal(port_state, ref_state, what):
    got, want = inc.state_to_arrays(port_state), ref_arrays(ref_state)
    for f in inc.IncState._fields:
        g, w = got[f], want[f]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {f} {g.dtype}{g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def assert_inputs_equal(port_x, ref_x, what):
    assert type(port_x).__name__ == type(ref_x).__name__
    for f in ref_x._fields:
        g, w = np.asarray(getattr(port_x, f)), np.asarray(getattr(ref_x, f))
        assert g.dtype == w.dtype, f"{what}: {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def both_batches(fixture, batch=32, e_cap=None):
    g, pg = grids(*fixture)
    e_cap = e_cap or g.e
    return (ref.batches_from_grid(g, batch, 8192, e_cap),
            inc.batches_from_grid(pg, batch, 8192, e_cap))


def both_trains(fixture, train, w_cap, t_cap, e_cap=None):
    g, pg = grids(*fixture)
    e_cap = e_cap or g.e
    return (ref.trains_from_grid(g, train, 8192, e_cap, w_cap=w_cap, t_cap=t_cap),
            inc.trains_from_grid(pg, train, 8192, e_cap, w_cap=w_cap, t_cap=t_cap))


@pytest.mark.parametrize("fixture", GRIDS + [SPLIT_GRID])
def test_batches_and_trains_from_grid_match_reference(fixture):
    for batch in (32, 64):
        jb, pb = both_batches(fixture, batch)
        assert len(jb) == len(pb)
        for k, (a, b) in enumerate(zip(jb, pb)):
            assert_inputs_equal(b, a, f"batch {k} (size {batch})")
    for train, w_cap, t_cap in ((256, 16, 96), (128, 16, 64), (64, 8, 32)):
        jt, pt = both_trains(fixture, train, w_cap, t_cap)
        assert len(jt) == len(pt)
        for k, (a, b) in enumerate(zip(jt, pt)):
            assert_inputs_equal(b, a, f"train {k} ({train}, {w_cap}, {t_cap})")
    np.testing.assert_array_equal(inc.stack_batches(pb[:3]).levels,
                                  ref.stack_batches(jb[:3]).levels)
    st_p, st_j = inc.stack_trains(pt[:2]), ref.stack_trains(jt[:2])
    assert_inputs_equal(st_p, st_j, "stacked trains")


def test_split_grid_batches_are_split():
    g, _ = grids(*SPLIT_GRID)
    jb, pb = both_batches(SPLIT_GRID, 64)
    assert len(pb) == len(jb) > -(-g.e // 64)  # the within-batch depth forced splits


@functools.lru_cache(maxsize=None)
def ref_bodies(sm, n, r_win, e_win):
    """The reference's append body and decide, jitted once per static
    configuration and shared by every test of it (its step is exactly
    decide(body(state, batch)))."""
    body = jax.jit(functools.partial(ref._step_body, super_majority=sm, n_participants=n))
    decide = jax.jit(functools.partial(
        ref._decide_body, super_majority=sm, n_participants=n, r_win=r_win, e_win=e_win))
    return body, decide


def run_steps(fixture, r_cap, r_win, e_win, e_cap=768, on_step=None):
    """Every batch through the reference's body + decide and the port's
    step, all fields compared after each call; returns (port state,
    reference state)."""
    g, _ = grids(*fixture)
    n = g.n
    body, decide = ref_bodies(g.super_majority, n, r_win, e_win)
    jb, pb = both_batches(fixture, e_cap=e_cap)
    js = ref.init_state(n, e_cap, r_cap)
    ps = inc.init_state(n, e_cap, r_cap, device="cpu")
    for k, (a, b) in enumerate(zip(jb, pb)):
        js = decide(body(js, a))
        out = inc.step(ps, b, g.super_majority, n, r_win=r_win, e_win=e_win)
        assert out is ps  # updated in place
        assert_state_equal(ps, js, f"step {k}")
        if on_step is not None:
            on_step(ps)
    return ps, js


def port_steps(fixture, r_cap=64, r_win=32, e_win=512, e_cap=768):
    """The port's per-batch path alone (held to the reference above)."""
    g, pg = grids(*fixture)
    ps = inc.init_state(g.n, e_cap, r_cap, device="cpu")
    for b in inc.batches_from_grid(pg, 32, 8192, e_cap):
        inc.step(ps, b, g.super_majority, g.n, r_win=r_win, e_win=e_win)
    return ps


@functools.lru_cache(maxsize=None)
def ref_train_body(sm, n):
    return jax.jit(functools.partial(ref._train_body, super_majority=sm, n_participants=n))


def run_trains(fixture, train, w_cap, t_cap, r_cap, r_win, e_win):
    """Every train through the reference's train body + decide (its
    train_step) and the port's train_step, all fields compared after each
    call."""
    g, _ = grids(*fixture)
    n = g.n
    body = ref_train_body(g.super_majority, n)
    _, decide = ref_bodies(g.super_majority, n, r_win, e_win)
    jt, pt = both_trains(fixture, train, w_cap, t_cap)
    js = ref.init_state(n, g.e, r_cap)
    ps = inc.init_state(n, g.e, r_cap, device="cpu")
    for k, (a, b) in enumerate(zip(jt, pt)):
        js = decide(body(js, a))
        inc.train_step(ps, b, g.super_majority, n, r_win=r_win, e_win=e_win)
        assert_state_equal(ps, js, f"train {k}")
    return ps, js


@pytest.mark.parametrize("zipf", [0.0, 1.1])
def test_step_matches_reference_and_one_shot(zipf):
    fixture = (8, 768, 3, zipf)
    ps, _ = run_steps(fixture, r_cap=64, r_win=32, e_win=512)
    assert not bool(ps.stale) and not bool(ps.fame_lag)
    _, pg = grids(*fixture)
    one = port_engine.run_passes(pg, device="cpu")
    e = pg.e
    np.testing.assert_array_equal(ps.rounds[:e].numpy(), one.rounds)
    np.testing.assert_array_equal(ps.lamport[:e].numpy(), one.lamport)
    np.testing.assert_array_equal(ps.witness[:e].numpy(), one.witness)
    np.testing.assert_array_equal(ps.received[:e].numpy(), one.received)
    assert int(ps.last_round) == one.last_round


def test_multi_step_matches_reference_and_per_batch():
    fixture = (8, 512, 5, 1.1)
    g, _ = grids(*fixture)
    n, sm = g.n, g.super_majority
    jb, pb = both_batches(fixture)
    one = port_steps(fixture, e_cap=g.e)
    k = 4
    js = ref.init_state(n, g.e, 64)
    ps = inc.init_state(n, g.e, 64, device="cpu")
    for i in range(0, len(jb), k):
        js = ref.multi_step(js, ref.stack_batches(jb[i : i + k]), sm, n, e_win=512)
        inc.multi_step(ps, inc.stack_batches(pb[i : i + k]), sm, n, e_win=512)
        assert_state_equal(ps, js, f"multi_step group {i // k}")
    for f in ("rounds", "lamport", "witness", "received"):
        assert torch.equal(getattr(one, f), getattr(ps, f)), f
    assert not bool(ps.stale) and not bool(ps.fame_lag)


@pytest.mark.parametrize("zipf", [0.0, 1.1])
def test_train_matches_reference_and_per_batch(zipf):
    fixture = (8, 768, 3, zipf)
    tr, _ = run_trains(fixture, 256, 16, 96, r_cap=64, r_win=32, e_win=512)
    one = port_steps(fixture)
    assert not bool(tr.stale) and not bool(tr.fame_lag)
    for f in ("rounds", "lamport", "witness", "received", "wtable",
              "fame_decided", "famous", "rounds_decided", "last_round"):
        assert torch.equal(getattr(one, f), getattr(tr, f)), f
    # the train registers clamped fd rows where the step path keeps MAX
    regs = tr.wtable >= 0
    assert (tr.fd_w[regs] == inc.FD_CLAMP).any()
    assert not (one.fd_w[regs] == inc.FD_CLAMP).any()


def test_multi_train_matches_reference_and_per_train():
    fixture = (8, 512, 5, 1.1)
    g, _ = grids(*fixture)
    n, sm = g.n, g.super_majority
    jt, pt = both_trains(fixture, 128, 16, 64)
    one = inc.init_state(n, g.e, 64, device="cpu")
    for t in pt:
        inc.train_step(one, t, sm, n, e_win=512)
    k = 2
    js = ref.init_state(n, g.e, 64)
    ps = inc.init_state(n, g.e, 64, device="cpu")
    for i in range(0, len(jt), k):
        group_j, group_p = jt[i : i + k], pt[i : i + k]
        if len(group_j) < k:
            for a, b in zip(group_j, group_p):
                js = ref.train_step(js, a, sm, n, e_win=512)
                inc.train_step(ps, b, sm, n, e_win=512)
        else:
            js = ref.multi_train(js, ref.stack_trains(group_j), sm, n, e_win=512)
            inc.multi_train(ps, inc.stack_trains(group_p), sm, n, e_win=512)
        assert_state_equal(ps, js, f"multi_train group {i // k}")
    for f in ("rounds", "lamport", "witness", "received"):
        assert torch.equal(getattr(one, f), getattr(ps, f)), f
    assert not bool(ps.stale) and not bool(ps.fame_lag)


def test_multi_step_groups_padded_with_no_op_batches():
    """Groups of three batches padded to four with no-op batches, as the
    live engine pads its multi_step stacks: every field equal to the
    reference's after each call, and to the unpadded per-batch path."""
    fixture = (8, 512, 5, 1.1)
    g, _ = grids(*fixture)
    n, sm = g.n, g.super_majority
    jb, pb = both_batches(fixture)
    pad = inc.empty_batch(n, 32, 8192, g.e)
    js = ref.init_state(n, g.e, 64)
    ps = inc.init_state(n, g.e, 64, device="cpu")
    for i in range(0, len(jb), 3):
        group_j, group_p = jb[i : i + 3], pb[i : i + 3]
        group_j = group_j + [ref.Batch(*pad)] * (4 - len(group_j))
        group_p = group_p + [pad] * (4 - len(group_p))
        js = ref.multi_step(js, ref.stack_batches(group_j), sm, n, e_win=512)
        inc.multi_step(ps, inc.stack_batches(group_p), sm, n, e_win=512)
        assert_state_equal(ps, js, f"padded group {i // 3}")
    one = port_steps(fixture, e_cap=g.e)
    for f in inc.IncState._fields:
        assert torch.equal(getattr(one, f), getattr(ps, f)), f


def test_multi_train_window_must_hold_two_trains():
    """One decide per two trains needs both trains' rows and the tail
    still undecided before them in its window: at e_win 384 (three trains
    of 128) train_step keeps every row decidable, while multi_train with
    K = 2 leaves rows below the window undetermined and latches stale, in
    the reference as in the port."""
    fixture = (8, 512, 5, 1.1)
    g, _ = grids(*fixture)
    n, sm = g.n, g.super_majority
    jt, pt = both_trains(fixture, 128, 16, 64)
    one = inc.init_state(n, g.e, 64, device="cpu")
    for t in pt:
        inc.train_step(one, t, sm, n, e_win=384)
    assert not bool(one.stale)
    js = ref.init_state(n, g.e, 64)
    ps = inc.init_state(n, g.e, 64, device="cpu")
    for i in range(0, len(jt), 2):
        js = ref.multi_train(js, ref.stack_trains(jt[i : i + 2]), sm, n, e_win=384)
        inc.multi_train(ps, inc.stack_trains(pt[i : i + 2]), sm, n, e_win=384)
        assert_state_equal(ps, js, f"multi_train group {i // 2}")
    assert bool(ps.stale)
    assert int((ps.received >= 0).sum()) < int((one.received >= 0).sum())


@pytest.mark.slow
@pytest.mark.parametrize("e_win,received,stale", [(16384, 23380, True), (24576, 28065, False)])
def test_multi_train_window_on_the_bench_grid(e_win, received, stale):
    """The bench grid's train cell (bench_incremental.py's constants, full
    width; about 20 s on the CPU): multi_train with K = 2 at the train
    path's e_win 16,384 latches stale with 23,380 rows received, at 24,576
    it gives 26 / 28,065 with no latch, in the reference as in the port
    (chip_smoke.py phase 10 holds the card to both outcomes)."""
    kw = dict(seed=0, zipf_a=1.1, record_fd_updates=True)
    g, pg = ref_synthetic_grid(64, 32768, **kw), synthetic_grid(64, 32768, **kw)
    jt = ref.trains_from_grid(g, 8192, 524288, 32768, t_cap=832)
    pt = inc.trains_from_grid(pg, 8192, 524288, 32768, t_cap=832)
    js = ref.init_state(64, 32768, 64)
    ps = inc.init_state(64, 32768, 64, device="cpu")
    for i in range(0, 4, 2):
        js = ref.multi_train(js, ref.stack_trains(jt[i : i + 2]), g.super_majority, 64,
                             e_win=e_win)
        inc.multi_train(ps, inc.stack_trains(pt[i : i + 2]), g.super_majority, 64,
                        e_win=e_win)
        assert_state_equal(ps, js, f"multi_train group {i // 2}")
    assert int(ps.last_round) == 26
    assert int((ps.received >= 0).sum()) == received
    assert bool(ps.stale) == stale and not bool(ps.fame_lag)


def test_stale_latch_fires_on_undersized_window():
    ps, _ = run_steps((8, 512, 7, 1.1), r_cap=64, r_win=32, e_win=64)
    assert bool(ps.stale)
    assert not bool(port_steps((8, 512, 7, 1.1)).stale)  # a window that fits


def test_round_window_below_capacity_freezes_settled_rounds():
    """r_win 8 < r_cap 16: the window start clips at r_cap - r_win, so it
    slides up (floor > 0) and later starts below the first undecided
    round, where the freeze keeps the settled rows."""
    floors = []

    def record(ps):
        undecided = ~ps.rounds_decided & (torch.arange(16) <= ps.last_round)
        floor_true = int(torch.where(undecided, torch.arange(16), ps.last_round).min())
        floors.append((min(max(floor_true, 0), 16 - 8), floor_true))

    run_steps((8, 768, 3, 0.0), r_cap=16, r_win=8, e_win=512, on_step=record)
    assert any(f > 0 for f, _ in floors)
    assert any(f < ft for f, ft in floors)  # the freeze acted


@pytest.mark.parametrize("path", ["step", "train"])
def test_round_capacity_latch_on_both_paths(path):
    """r_cap 8 on a grid of 15 rounds: the step path clips overflowing
    witness rounds onto row r_cap-1, the train path drops them; both latch
    stale, as the reference does."""
    fixture = (8, 768, 3, 0.0)
    if path == "step":
        ps, _ = run_steps(fixture, r_cap=8, r_win=8, e_win=512)
    else:
        ps, _ = run_trains(fixture, 256, 16, 96, r_cap=8, r_win=8, e_win=512)
    assert bool(ps.stale)
    assert int(ps.last_round) >= 7


def coin_window(n, r, seed):
    """_fame_window inputs over n validators and r rounds, random from a
    numpy seed: about a tenth of the witnesses absent, lastAncestors mostly
    above firstDescendants, so strongly-seeing is common and the votes stay
    split for long stretches."""
    rng = np.random.default_rng(seed)
    w_valid = rng.random((r, n)) >= 0.1
    w_valid[0] = True
    return dict(
        w_valid=w_valid,
        la_w=rng.integers(2, 10, size=(r, n, n), dtype=np.int32),
        fd_w=rng.integers(0, 8, size=(r, n, n), dtype=np.int32),
        idx_w=rng.integers(0, 10, size=(r, n), dtype=np.int32),
        coin_w=rng.random((r, n)) < 0.5,
    )


def test_fame_window_coin_step_in_the_unroll():
    n, r, seed = COIN_WINDOW
    c = coin_window(n, r, seed)
    sm = 2 * n // 3 + 1
    verdicts = []
    for coin in (c["coin_w"], ~c["coin_w"]):
        want = ref._fame_window(
            jnp.asarray(c["w_valid"]), jnp.asarray(c["la_w"]), jnp.asarray(c["fd_w"]),
            jnp.asarray(c["idx_w"]), jnp.asarray(coin), jnp.int32(r - 1), sm, n)
        got = inc._fame_window(
            torch.from_numpy(c["w_valid"]), torch.from_numpy(c["la_w"]),
            torch.from_numpy(c["fd_w"]), torch.from_numpy(c["idx_w"]),
            torch.from_numpy(coin), r - 1, sm, n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        verdicts.append([np.asarray(w) for w in want])
    # the coin bits change the verdicts: the coin branch is exercised
    assert any(not np.array_equal(a, b) for a, b in zip(*verdicts))


# (label, r_cap, r_win): at 8 validators the unroll holds a coin step;
# r_win < r_cap moves the window and freezes; r_cap 8 overflows
DECIDE_CASES = [("coin_n8", 64, 32), ("window_floor", 16, 8), ("capacity", 8, 8)]


@pytest.mark.parametrize("label,r_cap,r_win", DECIDE_CASES)
def test_decide_body_on_states_carried_from_the_reference(label, r_cap, r_win):
    """The reference appends batches with its own body; before each of its
    decides, its state is carried into the port (state_from_arrays) and
    both decide. The port's state after that decide equals the
    reference's."""
    fixture = (8, 768, 3, 0.0)
    g, _ = grids(*fixture)
    n, sm = g.n, g.super_majority
    body, decide = ref_bodies(sm, n, r_win, 512)
    jb, _ = both_batches(fixture)
    js = ref.init_state(n, g.e, r_cap)
    for k, a in enumerate(jb):
        js = body(js, a)
        if k % 3 == 2 or k == len(jb) - 1:
            ps = inc.state_from_arrays(ref_arrays(js), device="cpu")
            assert_state_equal(ps, js, f"carried state {k}")
            inc._decide_body(ps, sm, n, r_win=r_win, e_win=512)
            js = decide(js)
            assert_state_equal(ps, js, f"decide after batch {k}")
        else:
            js = decide(js)
    assert bool(js.stale) == (label == "capacity")


def test_entry_points_refuse_packed_and_bad_windows():
    st = inc.init_state(4, 64, 8, device="cpu")
    b = inc.Batch(*[np.zeros(1, np.int32)] * 12)
    with pytest.raises(NotImplementedError):
        inc.step(st, b, 3, 4, packed=True)
    before = inc.clone_state(st)
    with pytest.raises(ValueError):
        inc.step(st, b, 3, 4, r_win=16, e_win=64)
    # the windows are checked before the state changes
    for f in inc.IncState._fields:
        assert torch.equal(getattr(st, f), getattr(before, f)), f


def test_device_put_and_state_round_trip():
    _, pg = grids(8, 512, 5, 1.1)
    b = inc.batches_from_grid(pg, 32, 8192, pg.e)[0]
    on = inc.device_put(b, "cpu")
    assert all(isinstance(f, torch.Tensor) for f in on)
    assert on.coin.dtype == torch.bool and on.rows.dtype == torch.int32
    st = inc.init_state(8, 512, 64, device="cpu")
    inc.step(st, on, pg.super_majority, 8, e_win=512)
    back = inc.state_from_arrays(inc.state_to_arrays(st), device="cpu")
    for f in inc.IncState._fields:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    copy = inc.clone_state(st)
    copy.rounds.fill_(7)
    assert not torch.equal(copy.rounds, st.rounds)
