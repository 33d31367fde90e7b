"""The port's DecideFame and DecideRoundReceived (babble_tpu_torch.tpu.
kernels, plain versions on the CPU) against the JAX package's functions:
on witness tables the frontier walk produces for the suite's fixtures, on
hand-built voting tables that reach coin rounds, and (K4 and the mesh's
B23) on trap tables at two column tiles; the received tables' plan
(`_ext.received_tables_plan`) and a numpy emulation of the kernel's
schedule over it. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import babble_tpu.tpu.frontier as ref_frontier
import babble_tpu.tpu.kernels as ref
from babble_tpu.tpu import sharded as ref_sharded
from babble_tpu.tpu import synthetic_grid
from babble_tpu_torch.tpu import _ext
from babble_tpu_torch.tpu import kernels as port
from babble_tpu_torch.tpu import sharded as port_sharded

from chip_smoke import (
    COIN_CASES,
    coin_fame_args,
    coin_round_case,
    received_trap_args,
    received_trap_case,
)
from test_torch_grid import FRONTIER_FIXTURES

R_CAP = 64


def t(a):
    return torch.from_numpy(np.array(a))


def witness_inputs(grid):
    """The reference walk's witness table, rounds and last_round."""
    rows_by = ref_frontier.chain_table(grid)
    fr = ref_frontier.frontier_rounds(
        ref_frontier.build_inv(rows_by, grid.last_ancestors), rows_by,
        grid.creator, grid.index, ref_frontier.sp_index_of(grid),
        grid.first_descendants, super_majority=grid.super_majority, r_cap=R_CAP,
    )
    return np.asarray(fr.witness_table), np.asarray(fr.rounds), int(fr.last_round)


@pytest.mark.parametrize("n,e,seed,zipf,byz", FRONTIER_FIXTURES)
def test_decide_fame_and_received_match_reference(n, e, seed, zipf, byz):
    grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
    wtable, rounds, last_round = witness_inputs(grid)
    la, fd = grid.last_ancestors, grid.first_descendants
    d_cap = R_CAP + 2

    want = ref.decide_fame(
        wtable, la, fd, grid.index, grid.coin_bit, jnp.int32(last_round),
        super_majority=grid.super_majority, n_participants=grid.n, d_cap=d_cap,
    )
    got = port.decide_fame(
        t(wtable), t(la), t(fd), t(grid.index), t(grid.coin_bit),
        torch.tensor(last_round, dtype=torch.int32),
        grid.super_majority, grid.n, d_cap,
    )
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )

    want_r = ref.decide_round_received(
        wtable, la, grid.index, grid.creator, rounds, want.decided, want.famous,
        want.rounds_decided, jnp.int32(last_round),
    )
    got_r = port.decide_round_received(
        t(wtable), t(la), t(grid.index), t(grid.creator), t(rounds),
        got.decided, got.famous, got.rounds_decided,
        torch.tensor(last_round, dtype=torch.int32),
    )
    assert got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def voting_tables(seed, r=12, n=4):
    """Random strongly-see and vote tables over n=4 validators: with a
    supermajority of 3 of 4, many witnesses stay undecided past d = 4,
    the first coin round. Every witness valid in round 0 and round R-1,
    so a wrap-around of the round axis would show."""
    rng = np.random.default_rng(seed)
    wvalid = rng.random((r, n)) < 0.85
    wvalid[0] = wvalid[-1] = True
    ss = (rng.random((r, n, n)) < 0.55) & wvalid[:, :, None] & np.roll(wvalid, 1, 0)[:, None, :]
    ss[0] = False
    votes0 = rng.random((r, n, n)) < 0.5
    coin = rng.random((r, n)) < 0.5
    return ss, votes0, wvalid, coin


def fame_both(ss, votes0, wvalid, coin, last_round, d_cap, n=4, sm=3):
    want = ref._decide_fame_tables(
        jnp.asarray(ss), jnp.asarray(votes0), jnp.asarray(wvalid),
        jnp.asarray(coin), jnp.int32(last_round), sm, n, d_cap,
    )
    got = port._decide_fame_tables(
        t(ss), t(votes0), t(wvalid), t(coin), last_round, sm, n, d_cap,
    )
    for name in want._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    return got


@pytest.mark.parametrize("seed", range(6))
def test_decide_fame_tables_coin_rounds_match_reference(seed):
    ss, votes0, wvalid, coin = voting_tables(seed)
    fame_both(ss, votes0, wvalid, coin, last_round=11, d_cap=14)
    fame_both(ss, votes0, wvalid, coin, last_round=7, d_cap=14)


def test_coin_bits_reach_the_verdicts():
    """The hand-built case really goes through a coin round: flipping the
    coin bits, or stopping before d = 4, changes the verdicts."""
    ss, votes0, wvalid, coin = voting_tables(1)
    a = fame_both(ss, votes0, wvalid, coin, last_round=11, d_cap=14)
    b = fame_both(ss, votes0, wvalid, ~coin, last_round=11, d_cap=14)
    c = fame_both(ss, votes0, wvalid, coin, last_round=11, d_cap=4)
    assert not torch.equal(a.decided & a.famous, b.decided & b.famous) or not torch.equal(
        a.decided, b.decided
    )
    assert not torch.equal(a.decided, c.decided)


@pytest.mark.parametrize("n,r,seed", COIN_CASES)
def test_chip_smoke_coin_cases_reach_a_coin_round(n, r, seed):
    """The event tables chip_smoke.py holds the card's decide_fame to on
    coin rounds: the port equals the reference through the setup from
    la/fd for both coin settings, and the coin bits change the verdicts."""
    case = coin_round_case(n, r, seed)
    verdicts = []
    for coin in (case["coin_bit"], ~case["coin_bit"]):
        want = ref.decide_fame(
            case["wtable"], case["la"], case["fd"], case["index"], coin,
            jnp.int32(case["last_round"]), super_majority=case["super_majority"],
            n_participants=case["n_participants"], d_cap=case["d_cap"],
        )
        got = port.decide_fame(*coin_fame_args(case, coin, "cpu"))
        for name in want._fields:
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
            )
        verdicts.append(got)
    assert not all(torch.equal(a, b) for a, b in zip(*verdicts))


def test_fame_setup_masks_round_wrap():
    """ss has no round -1 and votes0 no round R: the reference's jnp.roll
    wrap is masked, and so is the port's direct indexing."""
    rng = np.random.default_rng(3)
    r, n, sm = 5, 4, 3
    wvalid = np.ones((r, n), dtype=bool)
    la_w = rng.integers(0, 6, size=(r, n, n)).astype(np.int32)
    fd_w = rng.integers(0, 6, size=(r, n, n)).astype(np.int32)
    idx_w = rng.integers(0, 6, size=(r, n)).astype(np.int32)
    coin_w = rng.random((r, n)) < 0.5
    want = ref._fame_setup_tables(
        jnp.asarray(wvalid), jnp.asarray(la_w), jnp.asarray(fd_w),
        jnp.asarray(idx_w), jnp.asarray(coin_w), sm,
    )
    got = port._fame_setup_tables(t(wvalid), t(la_w), t(fd_w), t(idx_w), t(coin_w), sm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][0].any() and not got[1][-1].any()


def test_received_search_clamps_like_reference():
    """Rounds at the top of the axis and creators at the edge: the start
    and creator gathers clamp as JAX's do."""
    rng = np.random.default_rng(9)
    r, n, e = 6, 3, 50
    min_la = rng.integers(-1, 8, size=(r, n)).astype(np.int32)
    famous_count = rng.integers(0, 3, size=r).astype(np.int32)
    i_ok = rng.random(r) < 0.8
    horizon = np.asarray(
        ref.suffix_min(np.where(~i_ok, np.arange(r), r).astype(np.int32), r)
    )
    index = rng.integers(-1, 8, size=e).astype(np.int32)
    creator = rng.integers(0, n, size=e).astype(np.int32)
    rounds = rng.integers(-1, r + 2, size=e).astype(np.int32)
    want = ref.received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon)
    got = port.received_search(
        t(index), t(creator), t(rounds), t(min_la), t(famous_count), t(i_ok),
        t(horizon),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_checks_reject_bad_tensors():
    """The CUDA wrappers' argument checks (run before any launch)."""
    dev = torch.device("cpu")
    x = torch.zeros((4, 6), dtype=torch.int32)
    _ext.check_tensor("x", x, torch.int32, (4, 6), dev)
    with pytest.raises(ValueError, match="dtype"):
        _ext.check_tensor("x", x.long(), torch.int32, (4, 6), dev)
    with pytest.raises(ValueError, match="shape"):
        _ext.check_tensor("x", x, torch.int32, (6, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        _ext.check_tensor("x", x.T, torch.int32, (6, 4), dev)
    with pytest.raises(ValueError, match="expected cuda"):
        _ext.check_tensor("x", x, torch.int32, (4, 6), torch.device("cuda"))


# widths of the received tables' plan: one word, two words, two column
# tiles with a ragged one, the width cell, and past it with a ragged word
PLAN_WIDTHS = (8, 64, 136, 1024, 1056)


def plan_cells(plan, n, r_max):
    """Each (round, column, witness) the plan's blocks walk, once per
    block that walks it: items (round, tile of columns), slice s of each
    the bit words [s * wps, (s + 1) * wps) clipped to the round's words
    (its four warps split a slice's witnesses by bit, b % 4)."""
    cells = np.zeros((r_max, n, n), np.int32)
    th, words = plan["cols"], plan["words"]
    for it in range(plan["items"]):
        r, t = divmod(it, plan["tiles"])
        cols = slice(t * th, min(t * th + th, n))
        for s in range(plan["slices"]):
            k_lo = min(s * plan["wps"], words)
            k_hi = min(k_lo + plan["wps"], words)
            cells[r, cols, 32 * k_lo : min(32 * k_hi, n)] += 1
    return cells


@pytest.mark.parametrize("n", PLAN_WIDTHS)
@pytest.mark.parametrize("r_max", (1, 6, 28))
def test_received_tables_plan_covers_every_cell_once(n, r_max):
    """Every (round, column, witness) is walked by exactly one block; the
    slices are a power of two that a portable cluster holds, each a word
    at least; the shared memory is the same at every width."""
    plan = _ext.received_tables_plan(n, r_max)
    assert (plan_cells(plan, n, r_max) == 1).all()
    s = plan["slices"]
    assert s & (s - 1) == 0 and 1 <= s <= _ext.RT_MAX_SLICES
    assert (s - 1) * plan["wps"] < plan["words"] <= s * plan["wps"]
    assert plan["items"] * (s // 2) < _ext.RT_TARGET_BLOCKS or s == 1
    assert _ext.block_smem("round_received", n) == {"tables": _ext.RT_SMEM}
    assert plan["smem"] == _ext.RT_SMEM <= 48 * 1024


def test_received_tables_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match=f"1 to {_ext.RT_MAX_WIDTH} validators"):
        _ext.received_tables_plan(_ext.RT_MAX_WIDTH + 1, 4)
    with pytest.raises(ValueError, match="need a round"):
        _ext.received_tables_plan(64, 0)
    # the coin case spreads over the card: 6 rounds x 8 tiles x 8 slices
    assert _ext.received_tables_plan(1024, 6)["slices"] == 8


def emulate_tables(plan, wtable, la, decided, famous):
    """min_la and famous_count as csrc/round_received.cu rt_grid builds
    them: per item and slice, RT_CHUNK words at a time, the chunk's famous
    flags as bit words and its witnesses' clamped la rows, each warp's
    column minima over its quarter of the set bits (b % 4 == warp), the
    warps' minima and then the slices' merged by min, the slices' famous
    counts summed (block 0 of the cluster, on tile 0 for the count)."""
    r_max, n = wtable.shape
    e_la = la.shape[0]
    big = np.iinfo(np.int32).max
    out = np.full((r_max, n), -7, np.int64)
    count = np.full(r_max, -7, np.int64)
    th, words = plan["cols"], plan["words"]
    for it in range(plan["items"]):
        r, t = divmod(it, plan["tiles"])
        cols = np.arange(t * th, min(t * th + th, n))
        parts, counts = [], []
        for s in range(plan["slices"]):
            k_lo = min(s * plan["wps"], words)
            k_hi = min(k_lo + plan["wps"], words)
            m = np.full(len(cols), big, np.int64)
            cnt = 0
            for k0 in range(k_lo, k_hi, _ext.RT_CHUNK):
                w = np.arange(32 * k0, min(32 * min(k0 + _ext.RT_CHUNK, k_hi), n))
                wt = wtable[r, w]
                f = (wt >= 0) & decided[r, w] & famous[r, w]
                cnt += int(f.sum())
                for q in range(_ext.RT_THREADS // 32):
                    rows = np.clip(wt, 0, e_la - 1)[f & (w % 4 == q)]
                    if len(rows):
                        m = np.minimum(m, la[np.ix_(rows, cols)].min(axis=0))
            parts.append(m)
            counts.append(cnt)
        out[r, cols] = np.min(parts, axis=0)
        if t == 0:
            count[r] = sum(counts)
    return out.astype(np.int32), count.astype(np.int32)


@pytest.mark.parametrize("n,r", [(136, 7), (1056, 5)])
def test_received_tables_schedule_matches_reference(n, r):
    """The kernel's schedule (its plan, chunks, set-bit walks and merge)
    emulated in numpy gives the JAX package's famous-witness minima and
    counts."""
    case = received_trap_case(n, r, seed=n)
    plan = _ext.received_tables_plan(n, r)
    got, got_count = emulate_tables(plan, case["wtable"], case["la"], case["decided"],
                                    case["famous"])
    want = ref_sharded._fame_tables(
        jnp.asarray(case["wtable"]), jnp.asarray(case["la"]), jnp.asarray(case["decided"]),
        jnp.asarray(case["famous"]), jnp.int32(r - 1))
    np.testing.assert_array_equal(got, np.asarray(want[0]))
    np.testing.assert_array_equal(got_count, np.asarray(want[1]))


@pytest.mark.parametrize("last_round", (-1, 3, 6))
def test_received_plain_matches_reference_on_traps(last_round):
    """K4 and B23's plain versions at 136 validators (two column tiles,
    the second ragged) equal the JAX package's on received_trap_case:
    rounds with no famous witness or none at all, witness rows past la,
    creators outside [0, n) (clamped as the reference clamps them),
    rounds outside the axis, last_round -1 (nothing eligible), inside and
    at the top."""
    case = received_trap_case(136, 7, seed=11)
    k4, b23 = received_trap_args(case, last_round, "cpu")
    want = ref.decide_round_received(
        case["wtable"], case["la"], case["index"], case["creator"], case["rounds"],
        case["decided"], case["famous"], case["rounds_decided"], jnp.int32(last_round))
    got = port.decide_round_received(*k4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if last_round == -1:
        assert (got.numpy() == -1).all()
    else:
        assert (got.numpy() >= 0).any()
    want_t = ref_sharded._fame_tables(
        jnp.asarray(case["wtable"]), jnp.asarray(case["la"]), jnp.asarray(case["decided"]),
        jnp.asarray(case["famous"]), jnp.int32(last_round))
    got_t = port_sharded.fame_tables(*b23)
    for g, w in zip(got_t, want_t):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    famous_count = got_t[1].numpy()
    assert (famous_count[::3] == 0).all() and famous_count.any()
