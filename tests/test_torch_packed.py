"""The port's packed voting layout (babble_tpu_torch/tpu/packed.py and the
packed branches of the plain versions, on the CPU) against the JAX
package's: the lane helpers bit for bit (words compared as uint32); the
packed plain versions of K3 decide_fame, K5 divide_rounds, K10
step_levels, K11 train_levels and K12 decide_window with their
intermediate words, on test_packed.py's fixtures, section cuts, the
consensus fixture and a coin-round table; the three one-shot engines and
the append paths (step, multi_step, train_step, multi_train) with
packed=True; the knob's switch at 128 validators on both node rungs; the
plain versions of the two kernels repaired for 256 validators (K7
walk_chunk, K12 decide_window) at that width; the plain versions' round
chunks against one chunk; the shared-memory formulas of the tiled
launches (no staging form is left), and divide_rounds' walk; and the plain
fame window at a ragged width. Exact equality, no tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import babble_tpu.tpu.doubling as ref_doubling
import babble_tpu.tpu.incremental as ref_inc
import babble_tpu.tpu.kernels as ref_kernels
import babble_tpu.tpu.live as ref_live
import babble_tpu.tpu.packed as ref_packed
from babble_tpu.tpu import engine as ref_engine
from babble_tpu.tpu import grid_from_hashgraph as ref_grid_from_hashgraph
from babble_tpu.tpu import run_consensus_device as ref_run_consensus_device
from babble_tpu.tpu import synthetic_grid
from babble_tpu.tpu.grid import section_grid, synthetic_deep_grid
from babble_tpu_torch.tpu import _ext, grid_from_arrays, run_consensus_device
from babble_tpu_torch.tpu import doubling as port_doubling
from babble_tpu_torch.tpu import engine as port_engine
from babble_tpu_torch.tpu import incremental as inc
from babble_tpu_torch.tpu import kernels as port_kernels
from babble_tpu_torch.tpu import live
from babble_tpu_torch.tpu import packed as port_packed

from chip_smoke import COIN_CASES, coin_round_case
from dsl import init_consensus_hashgraph
from test_torch_hashgraph import assert_same_consensus, carry
from test_torch_incremental import assert_state_equal, coin_window
from test_doubling import assert_matches
from test_torch_live import case_hashgraphs, dag, rung_cells

# test_packed.py's one-shot fixtures: non-lane-aligned, crossing a word,
# lane-aligned
FIXTURES = [(7, 160, 9), (33, 400, 4), (64, 512, 1)]
# the knob's switch: validators at and past PACKED_AUTO_MIN_N, a few
# hundred events each
SWITCH_GRID = (130, 400, 5)
SWITCH_DAG = (128, 384, 7)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def u32(words):
    """Port words (int32 tensor) as the reference's uint32 array."""
    return words.numpy().view(np.uint32)


def assert_same(got, want):
    """PassResults equality: per-event fields, last_round, the fame tables
    on the absolute round axis and the witness table on the real rounds."""
    assert got.round_offset == want.round_offset
    assert_matches(got, want)
    k = want.last_round - want.round_offset + 1
    np.testing.assert_array_equal(got.witness_table[:k], np.asarray(want.witness_table)[:k])


# ---------------------------------------------------------------------------
# the lane helpers (babble_tpu/tpu/packed.py:120-171)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 64, 100])
def test_pack_unpack_round_trip_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2, size=(3, 5, n)).astype(bool)
    xp = port_packed.pack_bits(t(x))
    assert xp.dtype == torch.int32 and xp.shape == (3, 5, port_packed.packed_words(n))
    np.testing.assert_array_equal(u32(xp), np.asarray(ref_packed.pack_bits(x)))
    np.testing.assert_array_equal(port_packed.unpack_bits(xp, n).numpy(), x)
    want = x.sum(axis=-1).astype(np.int32)
    np.testing.assert_array_equal(port_packed.popcount_sum(xp).numpy(), want)
    np.testing.assert_array_equal(port_packed.packed_count(t(x)).numpy(), want)
    np.testing.assert_array_equal(
        port_packed.popcount_sum(xp).numpy(), np.asarray(ref_packed.popcount_sum(u32(xp))))


def test_padding_lanes_are_vote_neutral():
    """The trailing partial word is zero-filled: the all-ones row of a
    non-lane-aligned width counts exactly its width, and a full word is
    the uint32 pattern 2^32 - 1 (the int32 sign bit set)."""
    for n in (7, 33, 64):
        ones = torch.ones((4, n), dtype=torch.bool)
        xp = port_packed.pack_bits(ones)
        np.testing.assert_array_equal(u32(xp), np.asarray(ref_packed.pack_bits(ones.numpy())))
        assert (port_packed.popcount_sum(xp) == n).all()
    assert (u32(port_packed.pack_bits(torch.ones((1, 7), dtype=torch.bool))) == 127).all()


def test_packed_tally_equals_wide_product_and_reference():
    rng = np.random.default_rng(17)
    r_, ny, nx, w = 3, 9, 9, 70
    ss = rng.integers(0, 2, size=(r_, ny, w)).astype(bool)
    votes = rng.integers(0, 2, size=(r_, w, nx)).astype(bool)
    wide = np.einsum("ryw,rwx->ryx", ss.astype(np.int64), votes.astype(np.int64))
    ss_p = port_packed.pack_bits(t(ss))
    vt_p = port_packed.pack_votes_t(t(votes))
    got = port_packed.packed_tally(ss_p, vt_p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), wide)
    want = ref_packed.packed_tally(ref_packed.pack_bits(ss), ref_packed.pack_votes_t(votes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(u32(vt_p), np.asarray(ref_packed.pack_votes_t(votes)))


def test_pack_votes_t_packs_the_voter_axis():
    rng = np.random.default_rng(5)
    votes = rng.integers(0, 2, size=(2, 33, 6)).astype(bool)  # (R, W, X)
    vp = port_packed.pack_votes_t(t(votes))
    assert vp.shape == (2, 6, port_packed.packed_words(33))
    np.testing.assert_array_equal(port_packed.unpack_bits(vp, 33).numpy(),
                                  np.swapaxes(votes, 1, 2))
    np.testing.assert_array_equal(u32(vp), np.asarray(ref_packed.pack_votes_t(votes)))


# ---------------------------------------------------------------------------
# the packed plain versions of K5 and K3 against the reference's branches
# ---------------------------------------------------------------------------


def scan_inputs(grid):
    """The level scan's inputs (port_engine.SCAN_FIELDS order, coin_bit
    last) as numpy arrays, and its r_max."""
    return [np.asarray(getattr(grid, f)) for f in port_engine.SCAN_FIELDS], grid.r_max


LAYOUT_IDS = ([f"synthetic-{n}-{e}-{s}" for n, e, s in FIXTURES]
              + ["section-pin_cut-True", "section-pin_cut-False", "consensus-fixture"])


@functools.lru_cache(maxsize=None)
def layout_grid(label):
    """The reference grid of one fixture the plain versions are held to in
    the packed layout: test_packed.py's one-shot fixtures, its section
    cuts (pinned and amnesiac) and the consensus fixture."""
    kind, *rest = label.split("-")
    if kind == "synthetic":
        n, e, seed = map(int, rest)
        return synthetic_grid(n, e, seed=seed)
    if kind == "section":
        g = synthetic_grid(7, 320, seed=6)
        return section_grid(g, ref_engine.run_passes(g), g.num_levels // 2,
                            pin_cut=rest[1] == "True")
    return ref_grid_from_hashgraph(init_consensus_hashgraph()[0])


@pytest.mark.parametrize("label", LAYOUT_IDS)
def test_divide_rounds_packed_matches_reference(label):
    grid = layout_grid(label)
    ins, r_max = scan_inputs(grid)
    sm = grid.super_majority
    want = ref_kernels.divide_rounds(*[jnp.asarray(a) for a in ins[:13]], sm, r_max,
                                     packed=True)
    got = port_kernels.divide_rounds(*[t(a) for a in ins[:13]], sm, r_max, packed=True)
    wide = port_kernels.divide_rounds(*[t(a) for a in ins[:13]], sm, r_max)
    for g, w, v in zip(got, want, wide):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, v)


def witness_tables(grid):
    """The inputs of decide_fame on a grid: its witness table from the
    reference's scan, the la / fd / index / coin columns, last_round."""
    ins, r_max = scan_inputs(grid)
    dr = ref_kernels.divide_rounds(*[jnp.asarray(a) for a in ins[:13]],
                                   grid.super_majority, r_max)
    last_round = int(np.asarray(dr.rounds).max())
    wtable = np.asarray(dr.witness_table)[: max(last_round + 2, 2)]
    return wtable, ins[5], ins[6], ins[2], ins[13].astype(bool), last_round


def fame_both(wtable, la, fd, index, coin, last_round, sm, n, d_cap):
    """The packed decide_fame of both packages on the same tables, with
    the intermediate words compared first: the ss words (pack_bits of the
    setup's ss) and the d = 1 vote words (pack_votes_t of votes0).
    Returns the port's FameResult."""
    rows = np.clip(wtable, 0, la.shape[0] - 1)
    tabs = (wtable >= 0, la[rows], fd[rows], index[rows], coin[rows])
    ref_ss, ref_v0, _, _ = ref_kernels._fame_setup_tables(
        *[jnp.asarray(a) for a in tabs], sm, packed=True)
    ss, v0, _, _ = port_kernels._fame_setup_tables(*[t(a) for a in tabs], sm, packed=True)
    np.testing.assert_array_equal(u32(port_packed.pack_bits(ss)),
                                  np.asarray(ref_packed.pack_bits(ref_ss)))
    np.testing.assert_array_equal(u32(port_packed.pack_votes_t(v0)),
                                  np.asarray(ref_packed.pack_votes_t(ref_v0)))
    args = (wtable, la, fd, index, coin)
    want = ref_kernels.decide_fame(*[jnp.asarray(a) for a in args], jnp.int32(last_round),
                                   sm, n, d_cap, packed=True)
    got = port_kernels.decide_fame(*[t(a) for a in args], torch.tensor(last_round),
                                   sm, n, d_cap, packed=True)
    wide = port_kernels.decide_fame(*[t(a) for a in args], torch.tensor(last_round),
                                    sm, n, d_cap)
    for g, w, v in zip(got, want, wide):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, v)
    return got


@pytest.mark.parametrize("label", LAYOUT_IDS)
def test_decide_fame_packed_matches_reference(label):
    grid = layout_grid(label)
    wtable, la, fd, index, coin, last_round = witness_tables(grid)
    fame_both(wtable, la, fd, index, coin, last_round, grid.super_majority, grid.n,
              wtable.shape[0] + 2)


@pytest.mark.parametrize("n,r,seed", COIN_CASES)
def test_decide_fame_packed_on_coin_rounds(n, r, seed):
    """The voting tables of chip_smoke.py's coin cases reach a coin round:
    the packed layout matches the reference for both coin settings, and
    the coin bits change its verdicts."""
    c = coin_round_case(n, r, seed)
    verdicts = [fame_both(c["wtable"], c["la"], c["fd"], c["index"], coin,
                          c["last_round"], c["super_majority"], n, c["d_cap"])
                for coin in (c["coin_bit"], ~c["coin_bit"])]
    assert any(not torch.equal(a, b) for a, b in zip(*verdicts))


# ---------------------------------------------------------------------------
# the packed plain versions of K10 and K12: the append paths
# ---------------------------------------------------------------------------


STEP_GRID = (7, 512, 3, 1.1)


@functools.lru_cache(maxsize=None)
def step_grids():
    from babble_tpu_torch.tpu.grid import synthetic_grid as port_synthetic_grid

    n, e, seed, zipf = STEP_GRID
    kw = dict(seed=seed, zipf_a=zipf, record_fd_updates=True)
    return synthetic_grid(n, e, **kw), port_synthetic_grid(n, e, **kw)


@functools.lru_cache(maxsize=None)
def ref_packed_bodies(sm, n, r_win, e_win):
    body = jax.jit(functools.partial(ref_inc._step_body, super_majority=sm,
                                     n_participants=n, packed=True))
    decide = jax.jit(functools.partial(ref_inc._decide_body, super_majority=sm,
                                       n_participants=n, r_win=r_win, e_win=e_win,
                                       packed=True))
    return body, decide


@pytest.mark.parametrize("r_cap,r_win", [(64, 32), (16, 8)])
def test_step_packed_matches_reference_and_wide(r_cap, r_win):
    """step with packed=True against the reference's packed body + decide,
    every IncState field after every call, and against the port's wide
    step; r_win < r_cap moves the window and freezes."""
    g, pg = step_grids()
    n, sm, e = g.n, g.super_majority, g.e
    body, decide = ref_packed_bodies(sm, n, r_win, 512)
    jb = ref_inc.batches_from_grid(g, 32, 8192, e)
    pb = inc.batches_from_grid(pg, 32, 8192, e)
    js = ref_inc.init_state(n, e, r_cap)
    ps = inc.init_state(n, e, r_cap, device="cpu")
    ws = inc.init_state(n, e, r_cap, device="cpu")
    for k, (a, b) in enumerate(zip(jb, pb)):
        js = decide(body(js, a))
        inc.step(ps, b, sm, n, r_win=r_win, e_win=512, packed=True)
        inc.step(ws, b, sm, n, r_win=r_win, e_win=512)
        assert_state_equal(ps, js, f"packed step {k}")
        for f in inc.IncState._fields:
            assert torch.equal(getattr(ps, f), getattr(ws, f)), f"step {k}: {f}"
    assert int(ps.last_round) > 2 and int((ps.received >= 0).sum()) > 0


def test_multi_step_packed_matches_reference():
    g, pg = step_grids()
    n, sm, e = g.n, g.super_majority, g.e
    jb = ref_inc.batches_from_grid(g, 32, 8192, e)
    pb = inc.batches_from_grid(pg, 32, 8192, e)
    js = ref_inc.init_state(n, e, 64)
    ps = inc.init_state(n, e, 64, device="cpu")
    for i in range(0, len(jb), 4):
        js = ref_inc.multi_step(js, ref_inc.stack_batches(jb[i : i + 4]), sm, n,
                                e_win=512, packed=True)
        inc.multi_step(ps, inc.stack_batches(pb[i : i + 4]), sm, n, e_win=512, packed=True)
        assert_state_equal(ps, js, f"packed multi_step group {i // 4}")


def test_fame_window_packed_on_a_coin_window():
    """test_torch_incremental.py's 8-validator coin window: the packed
    window equals the reference's packed window for both coin settings."""
    from test_torch_incremental import COIN_WINDOW

    n, r, seed = COIN_WINDOW
    c = coin_window(n, r, seed)
    sm = 2 * n // 3 + 1
    for coin in (c["coin_w"], ~c["coin_w"]):
        want = ref_inc._fame_window(
            jnp.asarray(c["w_valid"]), jnp.asarray(c["la_w"]), jnp.asarray(c["fd_w"]),
            jnp.asarray(c["idx_w"]), jnp.asarray(coin), jnp.int32(r - 1), sm, n,
            packed=True)
        got = inc._fame_window(
            t(c["w_valid"]), t(c["la_w"]), t(c["fd_w"]), t(c["idx_w"]), t(coin),
            r - 1, sm, n, packed=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_train_paths_still_refuse_packed():
    """K11's packed branch (K11p) is ported: train_step and multi_train
    take packed=True, equal to the reference's packed branch and to the
    port's wide train paths, every IncState field."""
    g, pg = step_grids()
    n, sm, e = g.n, g.super_majority, g.e
    jt = ref_inc.trains_from_grid(g, 128, 8192, e, w_cap=16, t_cap=64)
    pt = inc.trains_from_grid(pg, 128, 8192, e, w_cap=16, t_cap=64)
    js = ref_inc.init_state(n, e, 64)
    ps = inc.init_state(n, e, 64, device="cpu")
    ws = inc.init_state(n, e, 64, device="cpu")
    js = ref_inc.train_step(js, jt[0], sm, n, e_win=512, packed=True)
    inc.train_step(ps, pt[0], sm, n, e_win=512, packed=True)
    inc.train_step(ws, pt[0], sm, n, e_win=512)
    assert_state_equal(ps, js, "packed train_step")
    js = ref_inc.multi_train(js, ref_inc.stack_trains(jt[1:3]), sm, n, e_win=512, packed=True)
    inc.multi_train(ps, inc.stack_trains(pt[1:3]), sm, n, e_win=512, packed=True)
    inc.multi_train(ws, inc.stack_trains(pt[1:3]), sm, n, e_win=512)
    assert_state_equal(ps, js, "packed multi_train")
    for f in inc.IncState._fields:
        assert torch.equal(getattr(ps, f), getattr(ws, f)), f


@pytest.mark.parametrize("r_cap,r_win", [(64, 32), (16, 8)])
def test_train_step_packed_matches_reference_and_wide(r_cap, r_win):
    """K11p: train_step with packed=True against the reference's packed
    train_step, every IncState field after every train, and against the
    port's wide train_step; r_win < r_cap moves the window."""
    g, pg = step_grids()
    n, sm, e = g.n, g.super_majority, g.e
    jt = ref_inc.trains_from_grid(g, 64, 8192, e, w_cap=16, t_cap=64)
    pt = inc.trains_from_grid(pg, 64, 8192, e, w_cap=16, t_cap=64)
    js = ref_inc.init_state(n, e, r_cap)
    ps = inc.init_state(n, e, r_cap, device="cpu")
    ws = inc.init_state(n, e, r_cap, device="cpu")
    for k, (a, b) in enumerate(zip(jt, pt)):
        js = ref_inc.train_step(js, a, sm, n, r_win=r_win, e_win=512, packed=True)
        inc.train_step(ps, b, sm, n, r_win=r_win, e_win=512, packed=True)
        inc.train_step(ws, b, sm, n, r_win=r_win, e_win=512)
        assert_state_equal(ps, js, f"packed train_step {k}")
        for f in inc.IncState._fields:
            assert torch.equal(getattr(ps, f), getattr(ws, f)), f"train {k}: {f}"
    assert int(ps.last_round) > 2 and int((ps.received >= 0).sum()) > 0


def test_train_levels_packed_plain_matches_reference_body():
    """The packed level scan alone (K11p's plain version after K9) equals
    the reference's packed _train_body on a 33-validator grid, whose
    words cross a lane boundary."""
    kw = dict(seed=4, record_fd_updates=True)
    from babble_tpu_torch.tpu.grid import synthetic_grid as port_synthetic_grid

    g, pg = synthetic_grid(33, 400, **kw), port_synthetic_grid(33, 400, **kw)
    n, sm, e = g.n, g.super_majority, g.e
    body = jax.jit(functools.partial(ref_inc._train_body, super_majority=sm,
                                     n_participants=n, packed=True))
    js = ref_inc.init_state(n, e, 32)
    ps = inc.init_state(n, e, 32, device="cpu")
    for k, (a, b) in enumerate(zip(ref_inc.trains_from_grid(g, 100, 65536, e),
                                   inc.trains_from_grid(pg, 100, 65536, e))):
        js = body(js, a)
        inc._apply_deltas_and_stage(ps, inc.device_put(b, "cpu"))
        inc._train_levels_plain(ps, inc.device_put(b, "cpu"), sm, packed=True)
        assert_state_equal(ps, js, f"train body {k}")


# ---------------------------------------------------------------------------
# the engines in the packed layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,seed", FIXTURES)
def test_one_shot_engines_packed_match_reference_and_wide(n, e, seed):
    g = synthetic_grid(n, e, seed=seed)
    pg = grid_from_arrays(vars(g))
    for run_ref, run_port in (
        (lambda p: ref_engine.run_frontier_passes(g, packed=p),
         lambda p: port_engine.run_frontier_passes(pg, device="cpu", packed=p)),
        (lambda p: ref_engine.run_passes(g, bucketed=True, adaptive_r=True, packed=p),
         lambda p: port_engine.run_passes(pg, device="cpu", bucketed=True, adaptive_r=True,
                                          packed=p)),
    ):
        got = run_port(True)
        assert_same(got, run_ref(True))
        assert_same(got, run_port(False))


def test_cold_path_packed_matches_reference_and_wide():
    deep = synthetic_deep_grid(7, 2000, seed=11)
    pg = grid_from_arrays(vars(deep))
    got = port_doubling.run_doubling_passes(pg, device="cpu", packed=True)
    assert_same(got, ref_doubling.run_doubling_passes(deep, packed=True))
    assert_same(got, port_doubling.run_doubling_passes(pg, device="cpu", packed=False))


def spy_layouts(monkeypatch):
    """Record the `packed` argument of every plain decide_fame, divide_rounds
    and step_levels call."""
    seen = []
    for mod, name in ((port_kernels, "_decide_fame_plain"),
                      (port_kernels, "_divide_rounds_plain"),
                      (inc, "_step_levels_plain")):
        real = getattr(mod, name)

        def spied(*a, _real=real, _name=name, **kw):
            packed = kw.get("packed", a[-1] if isinstance(a[-1], bool) else False)
            seen.append((_name, packed))
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spied)
    return seen


def test_knob_switch_at_128_validators_one_shot_engines(monkeypatch):
    """Past PACKED_AUTO_MIN_N the knob's default takes the packed layout in
    all three engines, as in the reference, with the same results; below
    it (or with the knob at 0) the wide one."""
    assert port_packed.PACKED_AUTO_MIN_N == ref_packed.PACKED_AUTO_MIN_N == 128
    n, e, seed = SWITCH_GRID
    g = synthetic_grid(n, e, seed=seed)
    pg = grid_from_arrays(vars(g))
    assert port_packed.resolve_packed(None, n) and ref_packed.resolve_packed(None, n)
    seen = spy_layouts(monkeypatch)
    assert_same(port_engine.run_frontier_passes(pg, device="cpu"),
                ref_engine.run_frontier_passes(g))
    assert_same(port_engine.run_passes(pg, device="cpu"), ref_engine.run_passes(g))
    assert_same(port_doubling.run_doubling_passes(pg, device="cpu"),
                ref_doubling.run_doubling_passes(g))
    assert seen and all(packed for _, packed in seen), seen
    assert {name for name, _ in seen} == {"_decide_fame_plain", "_divide_rounds_plain"}
    seen.clear()
    monkeypatch.setenv("BABBLE_PACKED_VOTING", "0")
    port_engine.run_frontier_passes(pg, device="cpu")
    assert seen and not any(packed for _, packed in seen)


@functools.lru_cache(maxsize=None)
def switch_dag():
    return dag(*SWITCH_DAG)


def test_knob_switch_at_128_validators_one_shot_rung(monkeypatch):
    """run_consensus_device on a 128-validator hashgraph: the frontier
    rung in the packed layout, the same blocks and fields as the JAX
    package's rung and the host engine."""
    ref, ref_blocks, port, port_blocks, host, host_blocks = case_hashgraphs(
        ("synthetic",) + SWITCH_DAG, switch_dag())
    seen = spy_layouts(monkeypatch)
    host.run_consensus()
    ref_run_consensus_device(ref)
    run_consensus_device(port, device="cpu")
    assert rung_cells(port) == ["frontier"]
    assert any(k.startswith("frontier/dispatch/packed/")
               for k in port.obs.devledger.snapshot())
    assert seen and all(packed for _, packed in seen)
    assert_same_consensus(ref, ref_blocks, port, port_blocks, "port vs JAX, 128 validators")
    assert_same_consensus(host, host_blocks, port, port_blocks, "port vs host, 128 validators")


def test_knob_switch_at_128_validators_live_rung(monkeypatch):
    """run_consensus_live on the same hashgraph, syncs of 64, small
    capacities in both packages: the engine resolves the packed layout as
    the reference's does, every IncState field equal after every call, and
    the blocks equal to the host engine's after the flush."""
    from babble_tpu.hashgraph import Event as RefEvent
    from babble_tpu_torch.hashgraph import Event
    from test_torch_hashgraph import ref_events
    from test_torch_live import assert_engines_equal, carry_ref, host_reference, patch_both

    # the fetch discipline is pinned: its automatic switch reads host timings
    patch_both(monkeypatch, {"r_cap": 16, "r_win": 8, "e_cap": 1024, "e_win": 512,
                             "async_fetch": False})
    ref_hg = switch_dag()
    events = ref_events(ref_hg)
    ref_blocks, port_blocks = [], []
    ref = carry_ref(ref_hg, [], ref_blocks)
    port = carry(ref_hg, [], commit_callback=port_blocks.append)
    seen = spy_layouts(monkeypatch)
    for i in range(0, len(events), 64):
        for ev in events[i : i + 64]:
            ref.insert_event(RefEvent.from_json(ev.to_json()), True)
            port.insert_event(Event.from_json(ev.to_json()), True)
        ref_live.run_consensus_live(ref)
        live.run_consensus_live(port, device="cpu")
        assert port._live_device_engine.packed and ref._live_device_engine.packed
        assert_engines_equal(port, ref, f"after the sync at {i}")
    ref_live.flush_live_engine(ref)
    live.flush_live_engine(port)
    assert_engines_equal(port, ref, "after the flush")
    assert seen and all(packed for _, packed in seen)
    host, host_blocks = host_reference(ref_hg)
    assert_same_consensus(host, host_blocks, port, port_blocks, "port live vs host")


@pytest.mark.parametrize("caps,refusal", [
    ({"upd_cap": 600}, "fd update burst exceeds device staging"),
    ({"e_win": 256}, "device window/unroll exhausted"),
    ({}, None),
], ids=["upd_cap-below-a-burst", "e_win-below-the-tail", "held"])
def test_live_capacities_refuse_alike_at_128_validators(monkeypatch, caps, refusal):
    """The live engine's capacities decide whether its rung holds a wider
    DAG, alike in both packages: on the 128-validator hashgraph in syncs of
    64, an upd_cap below a sync's fd burst, or an e_win below the
    undecided tail, makes both packages' live rungs raise GridUnsupported
    at the same call for the same reason; capacities that cover the DAG
    hold every call, in the packed layout."""
    from babble_tpu.hashgraph import Event as RefEvent
    from babble_tpu.tpu import GridUnsupported as RefGridUnsupported
    from babble_tpu_torch.hashgraph import Event
    from babble_tpu_torch.tpu import GridUnsupported
    from test_torch_hashgraph import ref_events
    from test_torch_live import carry_ref, patch_both

    patch_both(monkeypatch, {"r_cap": 16, "r_win": 8, "e_cap": 1024, "e_win": 512,
                             "async_fetch": False, **caps})
    ref_hg = switch_dag()
    events = ref_events(ref_hg)
    ref = carry_ref(ref_hg, [], [])
    port = carry(ref_hg, [])
    rungs = ((ref, ref_live.run_consensus_live, RefGridUnsupported),
             (port, lambda h: live.run_consensus_live(h, device="cpu"), GridUnsupported))
    for call, i in enumerate(range(0, len(events), 64), 1):
        for ev in events[i : i + 64]:
            ref.insert_event(RefEvent.from_json(ev.to_json()), True)
            port.insert_event(Event.from_json(ev.to_json()), True)
        outcome = []
        for hg, run, unsupported in rungs:
            try:
                run(hg)
                outcome.append(None)
            except unsupported as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], f"call {call}: JAX {outcome[0]!r}, port {outcome[1]!r}"
        if outcome[0] is not None:
            assert refusal is not None and refusal in outcome[0], f"call {call}: {outcome[0]}"
            return
        assert port._live_device_engine.packed and ref._live_device_engine.packed
    assert refusal is None, f"no call refused; expected {refusal!r}"


# ---------------------------------------------------------------------------
# the kernels repaired for 256 validators: their plain versions at that
# width, and the wrappers' shared-memory checks
# ---------------------------------------------------------------------------


WIDE_GRID = (256, 640, 2)


@functools.lru_cache(maxsize=None)
def wide_grids():
    from babble_tpu_torch.tpu.grid import synthetic_grid as port_synthetic_grid

    n, e, seed = WIDE_GRID
    kw = dict(seed=seed, record_fd_updates=True)
    return synthetic_grid(n, e, **kw), port_synthetic_grid(n, e, **kw)


def test_walk_chunk_plain_at_256_validators_matches_reference():
    """Every chunk of the cold path's walk on a 256-validator grid: the
    port's plain chunk equals the reference's _walk_chunk."""
    g, pg = wide_grids()
    st = port_doubling.stage_doubling(pg, torch.device("cpu"))
    inv = port_doubling.build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = port_doubling.walk_seeds(pg, st)
    seen = []

    def walk(*a):
        got = port_doubling._walk_chunk_plain(*a)
        statics = dict(zip(("super_majority", "l", "length", "steps", "use_seeds"), a[8:]))
        want = ref_doubling._walk_chunk(*[x.numpy() for x in a[:8]], **statics)
        for p, w in zip(got, want):
            np.testing.assert_array_equal(p.numpy(), np.asarray(w))
        seen.append(a[10])
        return got

    hist = port_doubling._doubling_walk(t, inv, st.rows_by_d, st.fd_d, st.la_d, x0, s_np,
                                        first_nw, pg.super_majority, st.l_b, st.seeded,
                                        {}, walk=walk)
    assert seen and hist.shape[0] == 1 + sum(seen)
    assert (hist[-1] > hist[0]).any()


def test_decide_window_plain_at_256_validators_matches_reference():
    """The append path on a 256-validator grid (r_cap 8, r_win 4): the
    port's step (K9, K10, K12 plain) equals the reference's body + decide,
    every IncState field after every call."""
    g, pg = wide_grids()
    n, sm, e = g.n, g.super_majority, g.e
    body = jax.jit(functools.partial(ref_inc._step_body, super_majority=sm, n_participants=n))
    decide = jax.jit(functools.partial(ref_inc._decide_body, super_majority=sm,
                                       n_participants=n, r_win=4, e_win=e))
    js = ref_inc.init_state(n, e, 8)
    ps = inc.init_state(n, e, 8, device="cpu")
    for k, (a, b) in enumerate(zip(ref_inc.batches_from_grid(g, 128, 65536, e),
                                   inc.batches_from_grid(pg, 128, 65536, e))):
        js = decide(body(js, a))
        inc.step(ps, b, sm, n, r_win=4, e_win=e)
        assert_state_equal(ps, js, f"step {k}")


def test_fame_window_plain_at_256_validators_matches_reference():
    """K12's fame window on random 256-validator tables (strongly-seeing
    common, votes split): the port's plain window equals the reference's,
    and it decides witnesses."""
    n, r = 256, 4
    c = coin_window(n, r, 11)
    sm = 2 * n // 3 + 1
    want = ref_inc._fame_window(
        jnp.asarray(c["w_valid"]), jnp.asarray(c["la_w"]), jnp.asarray(c["fd_w"]),
        jnp.asarray(c["idx_w"]), jnp.asarray(c["coin_w"]), jnp.int32(r - 1), sm, n)
    got = inc._fame_window(t(c["w_valid"]), t(c["la_w"]), t(c["fd_w"]), t(c["idx_w"]),
                           t(c["coin_w"]), r - 1, sm, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[0].any())


@pytest.mark.parametrize("packed", [False, True])
def test_plain_round_chunks_equal_one_chunk(monkeypatch, packed):
    """The plain fame setup and vote tallies (K3's, and K12's window) taken
    one round at a time equal the same functions in one chunk, on a coin
    case's voting tables (decisions and a coin round) and a coin
    window."""
    from test_torch_incremental import COIN_WINDOW

    case = coin_round_case(*COIN_CASES[1])
    fame_args = (t(case["wtable"]), t(case["la"]), t(case["fd"]), t(case["index"]),
                 t(case["coin_bit"]), case["last_round"], case["super_majority"],
                 case["n_participants"], case["d_cap"])
    n, r, seed = COIN_WINDOW
    c = coin_window(n, r, seed)
    win_args = (t(c["w_valid"]), t(c["la_w"]), t(c["fd_w"]), t(c["idx_w"]), t(c["coin_w"]),
                r - 1, 2 * n // 3 + 1, n)
    whole = (port_kernels._decide_fame_plain(*fame_args, packed=packed),
             inc._fame_window(*win_args, packed=packed))
    monkeypatch.setattr(port_kernels, "PLAIN_CHUNK_CELLS", 1)
    assert len(port_kernels.round_chunks(5, 33 ** 3)) == 5
    chunked = (port_kernels._decide_fame_plain(*fame_args, packed=packed),
               inc._fame_window(*win_args, packed=packed))
    for a, b in zip(whole, chunked):
        for x, y in zip(a, b):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert bool(whole[0].decided.any())


# the widest shared form K12, K5 (at level width 32), K10, K11 (at the
# shapes named) and K3p had before their launches were tiled: their shared
# memory no longer grows with N, and none has a staging form
OLD_TOPS = {
    ("decide_fame", True, ()): 736,
    ("decide_window", False, ()): 384,
    ("divide_rounds", False, (("n_lvl", 32),)): 906,
    ("step_levels", False, (("w", 64), ("l_lv", 16), ("b", 64), ("r_cap", 64))): 702,
    ("train_levels", False, (("kb", 8192), ("w", 64), ("r_cap", 64))): 488,
}


@pytest.mark.parametrize("name,packed,shape", [
    ("decide_window", False, ()),
    ("walk_chunk", False, ()),
    ("decide_fame", True, ()),
    ("divide_rounds", False, (("n_lvl", 32),)),
    ("step_levels", False, (("w", 64), ("l_lv", 16), ("b", 64), ("r_cap", 64))),
    ("train_levels", False, (("kb", 8192), ("w", 64), ("r_cap", 64))),
])
def test_shared_memory_formula_holds_256_and_refuses_past_its_maximum(name, packed, shape):
    """Each kernel's blocks fit one block's shared memory at 256 validators
    and up to its old maximum; K7 (65,536 validators, 29,056 before its L2
    form took the same shared memory at every width) still refuses past its
    maximum with the check its wrapper runs first. K3p (its setup's pair
    tile, its vote's ring), K12 and the level walks K5, K10 and K11 (from
    their *_GRID_FROM validators: the grid walk) take the same shared
    memory at 256, at their old maximum, past it and at 1,024, and the
    port has no staging form left."""
    kw = dict(shape)
    if name == "walk_chunk":
        top = _ext.WC_MAX_WIDTH
        assert top == 65536
        assert _ext.max_width(name) == top
        assert _ext.smem_bytes(name, 256) <= _ext.MAX_SMEM_BYTES
        assert _ext.smem_bytes(name, 29056) == _ext.smem_bytes(name, top) <= _ext.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match=f"{top + 1} validators"):
            _ext.smem_bytes(name, top + 1)
        _ext.check_smem(name, 256)
        with pytest.raises(ValueError, match=f"{top + 1} validators"):
            _ext.check_smem(name, top + 1)
        return
    if (name, packed, shape) in OLD_TOPS:
        top = OLD_TOPS[(name, packed, shape)]
        sizes = {_ext.smem_bytes(name, m, packed=packed, **kw) for m in (256, top, top + 1, 1024)}
        assert len(sizes) == 1 and sizes.pop() <= _ext.MAX_SMEM_BYTES
        if name in _ext.WALK_SMEM:
            assert _ext.block_smem(name, 256, **kw) == {"grid": _ext.LEVEL_GRID_SMEM}
        assert not hasattr(_ext, "staging")


@pytest.mark.parametrize("n,want", [
    (256, ("shared", "shared", "shared", "shared")),
    (384, ("shared", "shared", "shared", "shared")),
    (385, ("shared", "shared", "shared", "shared")),
    (736, ("shared", "shared", "shared", "shared")),
    (737, ("shared", "shared", "shared", "shared")),
    (1024, ("shared", "shared", "shared", "shared")),
])
def test_staging_choice_around_the_old_limits(n, want):
    """The form of each launch of K12 (both layouts: one kernel) and K3p at
    the widths around their old limits (384 and 736): every launch of both
    stays in shared memory at every width (the pair tile of both setups,
    the same at every width; K12's vote tile; K3p's vote ring, at most the
    ring of 32 words), and neither wrapper has a device staging form to
    choose."""
    k12 = {k: "shared" if b <= _ext.MAX_SMEM_BYTES else "device"
           for k, b in _ext.block_smem("decide_window", n).items()}
    for packed in (False, True):
        per_block = _ext.block_smem("decide_fame", n, packed=packed)
        k3p = {k: "shared" if b <= _ext.MAX_SMEM_BYTES else "device"
               for k, b in per_block.items()}
        assert (k12["setup"], k12["vote"], k3p["setup"], k3p["vote"]) == want
        assert per_block["setup"] == _ext.block_smem("decide_window", n)["setup"]
        assert per_block["vote"] <= max(_ext.fame_vote_plan(w)["smem"]
                                        for w in range(1, _ext.FV_MAX_WORDS + 1))
    assert not any(hasattr(_ext, k) for k in ("staging", "_stage_scratch", "STAGED_KERNELS"))
    assert not any(k.endswith("/dev") for k in _ext.LAUNCHES)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_tiled_launches_take_the_same_shared_memory_at_every_width(n):
    """The grid walks of K5 (at level widths from 1 to N), K10 (at level
    widths 1 to 64, batches of 64) and K11 (at level widths 1 to 64, trains
    of 1 and 8,192 rows), and K12's setup and vote, ask one block for the
    same shared memory at 256, 1,024 and 4,096 validators, under the card's
    maximum: no width is refused for want of it."""
    assert _ext.divide_rounds_form(n, n) == "grid"
    for n_lvl in (1, 97, n):
        assert _ext.block_smem("divide_rounds", n, n_lvl=n_lvl) == {"grid": _ext.LEVEL_GRID_SMEM}
    for w in (1, 37, 64):
        shape = dict(w=w, l_lv=16, b=64, r_cap=64)
        assert _ext.step_levels_form(n, **shape) == "grid"
        assert _ext.block_smem("step_levels", n, **shape) == {"grid": _ext.LEVEL_GRID_SMEM}
        for kb in (1, 8192):
            shape = dict(kb=kb, w=w, r_cap=64)
            assert _ext.train_levels_form(n, **shape) == "grid"
            assert _ext.block_smem("train_levels", n, **shape) == {"grid": _ext.LEVEL_GRID_SMEM}
    assert _ext.block_smem("decide_window", n) == {"setup": _ext.DW_SETUP_SMEM,
                                                   "vote": _ext.DW_VOTE_SMEM}
    for b in (_ext.LEVEL_GRID_SMEM, _ext.DW_SETUP_SMEM, _ext.DW_VOTE_SMEM):
        assert 0 < b <= _ext.MAX_SMEM_BYTES


@pytest.mark.parametrize("packed", [False, True])
def test_divide_rounds_form_around_the_crossover(packed):
    """K5's wrapper launches the one-block walk below
    DIVIDE_ROUNDS_GRID_FROM validators and the grid walk from there (the
    launch is stubbed: CPU tensors here), handing the grid walk alone its
    scratch (per-lane c_seen, parent round, self-parent round, lamport, and
    the barrier count) and counting it under "<key>/grid"; a forced form
    overrides the rule, and a one-block walk whose rows cannot fit one
    block's shared memory raises before anything is launched."""
    top = _ext.DIVIDE_ROUNDS_GRID_FROM
    i32 = torch.int32
    seen = []
    real = _ext._launch
    _ext._launch = lambda name, dev, args, packed=False, staged=False, grid=False: seen.append(
        (name, args, packed, staged, grid))

    def call(n, n_lvl=4, form=None):
        e, r_max = 8, 2
        z = lambda *s: torch.zeros(s, dtype=i32)  # noqa: E731
        _ext.divide_rounds(z(3, n_lvl), *[z(e) for _ in range(4)], z(e, n), z(e, n),
                           *[z(e) for _ in range(6)], 2 * n // 3 + 1, r_max, packed=packed,
                           form=form)
        return seen[-1]

    try:
        for n, form in ((top - 1, "block"), (top, "grid"), (top + 1, "grid"), (1024, "grid")):
            assert _ext.divide_rounds_form(n, 4) == form
            name, args, pk, staged, grid = call(n)
            assert (name, pk, staged, grid) == ("divide_rounds", packed, False, form == "grid")
            scratch = args[17]
            assert (scratch is None) == (form == "block")
            if form == "grid":
                assert scratch.dtype == i32 and scratch.numel() == 4 * 4 + 1
        assert call(8, form="grid")[4] and not call(top, form="block")[4]
        n_wide = 1000
        assert not _ext.divide_rounds_form_fits("block", n_wide, 64)
        count = len(seen)
        with pytest.raises(ValueError, match="one-block walk"):
            call(n_wide, n_lvl=64, form="block")
        assert len(seen) == count
    finally:
        _ext._launch = real


def stub_launches():
    """Replace _ext._launch by a recorder (CPU tensors here); returns the
    list it appends (name, args, packed, staged, grid) to and the real one."""
    seen = []
    real = _ext._launch
    _ext._launch = lambda name, dev, args, packed=False, staged=False, grid=False: seen.append(
        (name, args, packed, staged, grid))
    return seen, real


def level_state(n, e_cap=8, r_cap=2):
    """A zero incremental state on the CPU (the level kernels' wrappers
    check its shapes)."""
    return inc.init_state(n, e_cap, r_cap, device="cpu")


@pytest.mark.parametrize("packed", [False, True])
def test_step_levels_form_around_the_crossover(packed):
    """K10's wrapper launches the one-block walk below
    STEP_LEVELS_GRID_FROM validators and the grid walk from there (the
    launch is stubbed: CPU tensors here), handing the grid walk alone its
    scratch (per-lane c_seen, parent round, self-parent round, lamport, and
    the barrier, ticket and round-max words: 4 w + 3) and counting it under
    "<key>/grid"; a forced form overrides the rule, and a one-block walk
    whose rows cannot fit one block's shared memory raises before anything
    is launched."""
    top = _ext.STEP_LEVELS_GRID_FROM
    i32 = torch.int32
    seen, real = stub_launches()

    def call(n, form=None, b=8, l_lv=4, w=5):
        st = level_state(n)
        z = lambda *s: torch.zeros(s, dtype=i32)  # noqa: E731
        batch = inc.Batch(rows=z(b), creator=z(b), index=z(b), sp_row=z(b), op_row=z(b),
                          la_rows=z(b, n), coin=torch.zeros(b, dtype=torch.bool),
                          fixed_round=z(b), upd_row=z(1), upd_col=z(1), upd_val=z(1),
                          levels=z(l_lv, w))
        _ext.step_levels(st.fd, st.rounds, st.lamport, st.witness, st.wtable, st.w_of_row,
                         st.la_w, st.fd_w, st.idx_w, st.coin_w, st.rounds_decided,
                         st.last_round, st.count, st.stale, batch.rows, batch.creator,
                         batch.index, batch.sp_row, batch.op_row, batch.la_rows, batch.coin,
                         batch.fixed_round, batch.levels, st.la, st.creator, st.index,
                         batch.upd_row, batch.upd_col, batch.upd_val, 2 * n // 3 + 1,
                         packed=packed, form=form)
        return seen[-1]

    try:
        for n, form in ((top - 1, "block"), (top, "grid"), (top + 1, "grid"), (1024, "grid")):
            assert _ext.step_levels_form(n, 5, 4, 8, 2) == form
            name, args, pk, staged, grid = call(n)
            assert (name, pk, staged, grid) == ("step_levels", packed, False, form == "grid")
            scratch = args[23]
            assert (scratch is None) == (form == "block")
            if form == "grid":
                assert scratch.dtype == i32 and scratch.numel() == 4 * 5 + 3
        assert call(8, form="grid")[4] and not call(top, form="block")[4]
        # a batch of 64 in 16 levels of 64 lanes: the lanes' la rows alone
        # pass one block's shared memory at 1,000 validators
        n_wide = 1000
        assert not _ext.step_levels_form_fits("block", n_wide, 64, 16, 64, 2)
        count = len(seen)
        with pytest.raises(ValueError, match="one-block walk"):
            call(n_wide, form="block", b=64, l_lv=16, w=64)
        assert len(seen) == count
    finally:
        _ext._launch = real


@pytest.mark.parametrize("packed", [False, True])
def test_train_levels_form_around_the_crossover(packed):
    """K11's wrapper launches the one-block walk below
    TRAIN_LEVELS_GRID_FROM validators and the grid walk from there (the
    launch is stubbed), handing the grid walk alone its scratch (the
    per-lane words, eight counters, the rounds and lamport carries, then
    the witness carry and the witness-valid copy as bytes:
    train_levels_scratch_words) beside the compare copy both walks take,
    and counting it under "<key>/grid"; a forced form overrides the rule,
    and a one-block walk whose carries cannot fit one block's shared memory
    raises before anything is launched."""
    top = _ext.TRAIN_LEVELS_GRID_FROM
    i32 = torch.int32
    kb, t_lv, w, r_cap = 6, 3, 5, 2
    seen, real = stub_launches()

    def call(n, form=None, kb=kb, w=w):
        st = level_state(n, r_cap=r_cap)
        z = lambda *s: torch.zeros(s, dtype=i32)  # noqa: E731
        _ext.train_levels(st.fd, st.rounds, st.lamport, st.witness, st.wtable, st.w_of_row,
                          st.la_w, st.fd_w, st.idx_w, st.coin_w, st.rounds_decided,
                          st.last_round, st.count, st.stale, *[z(kb) for _ in range(7)],
                          z(kb, n), torch.zeros(kb, dtype=torch.bool), z(kb), z(t_lv, w),
                          2 * n // 3 + 1, packed=packed, form=form)
        return seen[-1]

    try:
        for n, form in ((top - 1, "block"), (top, "grid"), (top + 1, "grid"), (1024, "grid")):
            assert _ext.train_levels_form(n, kb, w, r_cap) == form
            name, args, pk, staged, grid = call(n)
            assert (name, pk, staged, grid) == ("train_levels", packed, False, form == "grid")
            fd_cmp, scratch = args[25], args[26]
            assert fd_cmp.shape == (r_cap, n, n)
            assert (scratch is None) == (form == "block")
            if form == "grid":
                words = 4 * w + 8 + 2 * kb + (kb + r_cap * n + 3) // 4
                assert _ext.train_levels_scratch_words(kb, w, r_cap, n) == words
                assert scratch.dtype == i32 and scratch.numel() == words
        assert call(8, form="grid")[4] and not call(top, form="block")[4]
        # trains of 8,192 rows at r_cap 64 pass one block's shared memory
        # past 488 validators; one of 16,384 rows at 489 does at r_cap 2
        assert _ext.train_levels_form_fits("block", 488, 8192, 64, 64)
        assert not _ext.train_levels_form_fits("block", 489, 8192, 64, 64)
        assert not _ext.train_levels_form_fits("block", 489, 16384, 64, r_cap)
        count = len(seen)
        with pytest.raises(ValueError, match="one-block walk"):
            call(489, form="block", kb=16384, w=64)
        assert len(seen) == count
    finally:
        _ext._launch = real


# a seeded grid at a ragged width: 40 validators (neither a multiple of 32
# nor of the level walks' 8-lane tile) and 4; (n, events, seed, zipf)
RAGGED_LEVEL_GRIDS = {40: (40, 1600, 1, 1.1), 4: (4, 240, 2, 1.1)}


def mixed_parent_tiles(st, x, e_cap):
    """How many 8-lane tiles of x's levels hold lanes of two different
    parent rounds (>= 0) on state st, before the call."""
    def rounds_of(r):
        return torch.where((r >= 0) & (r < e_cap), st.rounds[r.clamp(0, e_cap - 1).long()], -1)

    pr = torch.maximum(rounds_of(x.sp_row), rounds_of(x.op_row))
    mixed = 0
    for row in x.levels:
        for t0 in range(0, row.shape[0], 8):
            pos = row[t0 : t0 + 8]
            got = pr[pos[pos >= 0].long()]
            mixed += int(got[got >= 0].unique().numel() >= 2)
    return mixed


@pytest.mark.parametrize("n", sorted(RAGGED_LEVEL_GRIDS))
def test_level_plains_at_a_ragged_width_match_reference(n):
    """K10's and K11's plain versions (the kernels' references on the card,
    both walks) after K9 equal the reference's _step_body and _train_body
    at a ragged width, in both layouts, on every field after every call:
    batches of 32 and trains of 400 rows in levels of at most 20 lanes (a
    ragged last tile), with levels whose 8-lane tiles mix two parent
    rounds."""
    from babble_tpu_torch.tpu.grid import synthetic_grid as port_synthetic_grid

    n_, e, seed, zipf = RAGGED_LEVEL_GRIDS[n]
    kw = dict(seed=seed, zipf_a=zipf, record_fd_updates=True)
    g, pg = synthetic_grid(n_, e, **kw), port_synthetic_grid(n_, e, **kw)
    sm, r_cap = g.super_majority, 32
    for packed in (False, True):
        mixed = 0
        body = jax.jit(functools.partial(ref_inc._step_body, super_majority=sm,
                                         n_participants=n, packed=packed))
        js, ps = ref_inc.init_state(n, e, r_cap), inc.init_state(n, e, r_cap, device="cpu")
        for k, (a, b) in enumerate(zip(ref_inc.batches_from_grid(g, 32, 8192, e),
                                       inc.batches_from_grid(pg, 32, 8192, e))):
            js = body(js, a)
            b = inc.device_put(b, "cpu")
            inc._apply_deltas_and_stage(ps, b)
            mixed += mixed_parent_tiles(ps, b, e)
            inc._step_levels_plain(ps, b, sm, packed=packed)
            assert_state_equal(ps, js, f"step body {k} (packed {packed})")
        assert mixed and int(ps.last_round) >= 2
        body = jax.jit(functools.partial(ref_inc._train_body, super_majority=sm,
                                         n_participants=n, packed=packed))
        js, ps = ref_inc.init_state(n, e, r_cap), inc.init_state(n, e, r_cap, device="cpu")
        trains = zip(ref_inc.trains_from_grid(g, 400, 8192, e, w_cap=20, t_cap=128),
                     inc.trains_from_grid(pg, 400, 8192, e, w_cap=20, t_cap=128))
        for k, (a, b) in enumerate(trains):
            js = body(js, a)
            b = inc.device_put(b, "cpu")
            inc._apply_deltas_and_stage(ps, b)
            inc._train_levels_plain(ps, b, sm, packed=packed)
            assert_state_equal(ps, js, f"train body {k} (packed {packed})")
        assert int(ps.last_round) >= 2


@pytest.mark.parametrize("n_participants", [40, 4])
def test_fame_window_plain_at_a_ragged_width_matches_reference(n_participants):
    """K12's fame window at 40 validators (not a multiple of 32, nor of the
    vote's 32-column blocks or the setup's 64-row tiles, so every tile of
    the kernel is ragged) on random coin tables, without and with coin
    steps in the unroll (d = 4, 8): the port's plain window, the kernel's
    reference on the card, equals the reference's, and decides
    witnesses."""
    n, r, seed = 40, 8, 5
    c = coin_window(n, r, seed)
    sm = 2 * n // 3 + 1
    for packed in (False, True):
        want = ref_inc._fame_window(
            jnp.asarray(c["w_valid"]), jnp.asarray(c["la_w"]), jnp.asarray(c["fd_w"]),
            jnp.asarray(c["idx_w"]), jnp.asarray(c["coin_w"]), jnp.int32(r - 1), sm,
            n_participants, packed=packed)
        got = inc._fame_window(t(c["w_valid"]), t(c["la_w"]), t(c["fd_w"]), t(c["idx_w"]),
                               t(c["coin_w"]), r - 1, sm, n_participants, packed=packed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert bool(got[0].any())


def test_wrappers_run_the_width_check_before_anything_else():
    """Past its old limit of 384 validators the K12 wrapper neither raises
    nor stages: its launches take the same shared memory at every width,
    so it hands the C entry point its vote scratch (the second vote-word
    buffer and the per-round counts) and no staging scratch, counted as
    the packed launch (the launch is stubbed: CPU tensors here). K7 still
    runs its width check before anything else."""
    n = 385
    r_cap, e_cap, r_win = 1, 4, 1
    i32 = torch.int32
    z = lambda *s: torch.zeros(s, dtype=i32)  # noqa: E731
    b = lambda *s: torch.zeros(s, dtype=torch.bool)  # noqa: E731
    seen = []
    real = _ext._launch
    _ext._launch = lambda name, dev, args, packed=False, staged=False, grid=False: seen.append(
        (name, args, packed, staged, grid))
    try:
        _ext.decide_window(z(r_cap, n), z(r_cap, n, n), z(r_cap, n, n), z(r_cap, n),
                           b(r_cap, n), b(r_cap, n), b(r_cap, n), b(r_cap), z(), z(),
                           z(e_cap), z(e_cap), z(e_cap), z(e_cap), b(), b(),
                           3, n, r_win, 1, inc.D_UNROLL, packed=True)
    finally:
        _ext._launch = real
    (name, args, packed, staged, grid), = seen
    assert (name, packed, staged, grid) == ("decide_window", True, False, False)
    vt0, vt1, rcnt = args[18:21]
    assert vt1.shape == vt0.shape == (r_win, n, (n + 31) // 32)
    assert rcnt.shape == (3 * r_win,)
    assert all(x is not None for x in args[:24])
    assert max(_ext.block_smem("decide_window", n).values()) <= _ext.MAX_SMEM_BYTES
    # walk_chunk reads the width off rows_by and checks it first, so the
    # (N, N, L) table need not be built at this width
    n, l = _ext.WC_MAX_WIDTH + 1, 1
    with pytest.raises(ValueError, match=f"{n} validators"):
        _ext.walk_chunk(z(1, 1, l), z(n, l), z(1, 1), z(1, 1), z(1), z(1, 1), z(1), z(1),
                        3, l, 1, 1, False)
