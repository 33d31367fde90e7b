"""The virtual vote's new schedules on the CPU, where no kernel runs: numpy
emulations of K3 decide_fame's vote (babble_tpu_torch/csrc/decide_fame.cu
and fame_vote.cuh: a warp per witness column, its votes in bit words,
every (round, column) voted alone to its own exit, the strongly-see planes
taken item by item in the ring's order, the producer stopping early once
no column is left) and of B21's one-card form (csrc/shard_fame.cu
shard_fame/grid: each position's shards gathered into the vote's tables
through the address arithmetic of its first phase, the ring shift as a
plane offset, the validator shards' sums in one popcount). Each is held to
the JAX package's decide_fame and to the port's plain versions in both
layouts, or to the port's plain step-by-step fame loop on CPU meshes (1-D
of 8 and 2-D (2, 4)). The tables' shapes come from the port's own plan
(`_ext.fame_vote_plan`), which the kernels' launchers mirror. Exact
equality, no tolerance."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import babble_tpu.tpu.kernels as ref_kernels
from babble_tpu.tpu import synthetic_grid
from babble_tpu_torch.tpu import _ext
from babble_tpu_torch.tpu import kernels as port_kernels
from babble_tpu_torch.tpu import sharded
from babble_tpu_torch.tpu.device import to_device
from babble_tpu_torch.tpu.mesh import DeviceMesh
from babble_tpu_torch.tpu.packed import pack_bits, pack_votes_t

from chip_smoke import coin_round_case
from test_torch_packed import witness_tables

CPU = torch.device("cpu")
LANES = np.arange(32)
# chip_smoke.py's coin case (coin steps at d = 8 and 16), test_packed.py's
# non-lane-aligned and word-crossing fixtures
COIN = (8, 20, 52)
FIXTURES = [(7, 160, 9), (33, 400, 4)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def u32(words):
    return words.numpy().view(np.uint32)


def pack_lanes(bits):
    """(32,) bools -> the word __ballot_sync gives, bit t from lane t."""
    return np.uint32((bits.astype(np.uint64) << LANES.astype(np.uint64)).sum())


def vote(ss_k, aux_k, vt, valid, plane, d_end, n_participants, super_majority, lag):
    """fame_vote.cuh fame_task over every (round i, tile of FV_COLS
    columns): ss_k (P, n_pad, ldw) and aux_k (P, n_pad) the planes, vt (R,
    N_x, W) the d = 1 vote words, valid (R, N_x), plane(i, d) and d_end(i)
    the caller's layout. The producer checks the live columns before it
    fetches item k, after the consumers have finished item k - lag (lag 1:
    right behind them; FV_STAGES: a full ring ahead), and stops early once
    none is left. Returns (decided, famous) (R, N_x)."""
    r_max, n_x, words = vt.shape
    plan = _ext.fame_vote_plan(words)
    items, blocks_item = plan["items"], plan["rows_item"] // 32
    decided = np.zeros((r_max, n_x), bool)
    famous = np.zeros((r_max, n_x), bool)
    for i in range(r_max):
        end = d_end(i)
        for x0 in range(0, n_x, _ext.FV_COLS):
            cols = [x for x in range(x0, min(x0 + _ext.FV_COLS, n_x))]
            running = {x: bool(valid[i, x]) and end >= 2 for x in cols}
            col = {x: vt[i, x].copy() for x in cols}
            mine = {x: np.zeros(words, np.uint32) for x in cols}
            any_dn, any_dv = dict.fromkeys(cols, False), dict.fromkeys(cols, False)
            live = [sum(running.values())]  # live[k + 1]: after item k
            total = (end - 1) * items if live[0] else 0
            for k in range(total):
                if live[max(k - lag + 1, 0)] == 0:
                    break  # the producer's stop_at: every consumer ends here
                d, c = 2 + k // items, k % items
                p = plane(i, d)
                is_coin = d % n_participants == 0
                for x in cols:
                    if not running[x]:
                        continue
                    for vb in range(c * blocks_item, min((c + 1) * blocks_item, words)):
                        y = 32 * vb + LANES
                        ya = np.bitwise_count(ss_k[p, y, :words] & col[x]).sum(axis=1)
                        ax = aux_k[p, y]
                        nays = (ax >> 2) - ya
                        v = ya >= nays
                        strong = np.where(v, ya, nays) >= super_majority
                        nv = np.where(strong, v, (ax >> 1) & 1 == 1) if is_coin else v
                        dn = strong & (ax & 1 == 1) & (not is_coin)
                        mine[x][vb] = pack_lanes(nv)
                        any_dn[x] |= bool(dn.any())
                        any_dv[x] |= bool((dn & v).any())
                    if c == items - 1:
                        if any_dn[x]:
                            decided[i, x], famous[i, x] = True, any_dv[x]
                            running[x] = False
                        else:
                            col[x] = mine[x].copy()
                        any_dn[x] = any_dv[x] = False
                live.append(sum(running.values()))
    return decided, famous


# ---------------------------------------------------------------------------
# (a) K3: the tables in the vote's layout, the vote column by column
# ---------------------------------------------------------------------------


def k3_tables(wtable, la, fd, index, coin, super_majority):
    """decide_fame.cu's setup output from the port's plain setup: ss
    (R, n_pad, ldw) words, aux (R, n_pad) = popcount * 4 + coin * 2 +
    present, vt0 (R, N, W) words."""
    ss, votes0, wvalid, coin_w = port_kernels._fame_setup(
        t(wtable), t(la), t(fd), t(index), t(coin), super_majority, packed=True)
    r_max, n = wtable.shape
    words = (n + 31) // 32
    plan = _ext.fame_vote_plan(words)
    ss_p = u32(pack_bits(ss))
    ss_k = np.zeros((r_max, plan["n_pad"], plan["ldw"]), np.uint32)
    ss_k[:, :n, :words] = ss_p
    aux = np.zeros((r_max, plan["n_pad"]), np.int64)
    aux[:, :n] = (np.bitwise_count(ss_p).sum(axis=2) * 4 + coin_w.numpy() * 2
                  + wvalid.numpy())
    return ss_k, aux, u32(pack_votes_t(votes0)), wvalid.numpy()


def k3_emulate(wtable, la, fd, index, coin, last_round, super_majority, n_participants,
               d_cap, lag):
    ss_k, aux, vt0, wvalid = k3_tables(wtable, la, fd, index, coin, super_majority)
    r_max = wtable.shape[0]
    decided, famous = vote(ss_k, aux, vt0, wvalid, lambda i, d: min(i + d, r_max - 1),
                           lambda i: min(last_round - i, d_cap), n_participants,
                           super_majority, lag)
    rounds_decided = (decided | ~wvalid).all(axis=1) & wvalid.any(axis=1)
    return decided, famous, rounds_decided


def random_tables(n, r, seed):
    """Random voting tables over n validators and r rounds (chip_smoke.py's
    coin_round_case), their last round one short of the table."""
    c = coin_round_case(n, r, seed)
    c["last_round"] = r - 2
    return c


def fame_cases():
    for n, e, seed in FIXTURES:
        yield f"fixture-{n}-{e}-{seed}", lambda n=n, e=e, seed=seed: fixture_case(n, e, seed)
    yield "coin-8-20-52", lambda: coin_round_case(*COIN)
    yield "random-40-9-3", lambda: random_tables(40, 9, 3)
    yield "random-70-7-5", lambda: random_tables(70, 7, 5)


def fixture_case(n, e, seed):
    grid = synthetic_grid(n, e, seed=seed)
    wtable, la, fd, index, coin, last_round = witness_tables(grid)
    return dict(wtable=wtable, la=la, fd=fd, index=index, coin_bit=coin,
                last_round=last_round, super_majority=grid.super_majority,
                n_participants=grid.n, d_cap=wtable.shape[0] + 2)


FAME_CASES = list(fame_cases())


@pytest.mark.parametrize("make", [m for _, m in FAME_CASES], ids=[k for k, _ in FAME_CASES])
def test_k3_schedule_matches_reference_and_plain(make):
    """K3's vote, each column alone to its own exit with the planes in ring
    order (the producer right behind the consumers, and a ring ahead),
    equals the JAX decide_fame and the port's plain version in both
    layouts: decided, famous and rounds_decided."""
    c = make()
    args = (c["wtable"], c["la"], c["fd"], c["index"], c["coin_bit"])
    scal = (c["super_majority"], c["n_participants"], c["d_cap"])
    want = ref_kernels.decide_fame(*[jnp.asarray(a) for a in args],
                                   jnp.int32(c["last_round"]), *scal)
    want = tuple(np.asarray(w) for w in want)
    for packed in (False, True):
        plain = port_kernels._decide_fame_plain(*[t(a) for a in args],
                                                torch.tensor(c["last_round"]), *scal,
                                                packed=packed)
        for g, w in zip(plain, want):
            np.testing.assert_array_equal(g.numpy(), w)
    for lag in (1, _ext.FV_STAGES):
        got = k3_emulate(*args, c["last_round"], *scal, lag=lag)
        for name, g, w in zip(("decided", "famous", "rounds_decided"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name}, lag {lag}")
    # the fixtures' grids are shallow: the 33-validator one decides nothing
    assert want[0].any() or c.get("n_participants") == 33, "the case decides nothing"


def test_k3_coin_bits_change_the_schedules_verdicts():
    """On the coin case the coin steps take the voter's coin bit: flipping
    every coin bit changes the emulated vote's verdicts, as it changes the
    reference's."""
    c = coin_round_case(*COIN)
    args = (c["wtable"], c["la"], c["fd"], c["index"])
    scal = (c["last_round"], c["super_majority"], c["n_participants"], c["d_cap"])
    a = k3_emulate(*args, c["coin_bit"], *scal, lag=1)
    b = k3_emulate(*args, ~c["coin_bit"], *scal, lag=1)
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("words", [1, 2, 3, 8, 9, 16, 17, 32, 33, 64, 190, 200, 301, 603])
def test_vote_plan_is_what_the_launchers_take(words):
    """fame_vote_plan: odd row stride, items of whole voter blocks covering
    every voter row once per step, bulk copies in 16-byte units, and one
    block's shared memory under the card's limit at every width (no
    staging form for the vote): up to 32 words (1,024 validators) the
    column's words in registers and a ring of FV_STAGES slots in at most
    48 KB, past it the words' two buffers a column in shared memory and
    as many slots as fit beside them, at least two (603 words, 19,296
    validators, the widest); block_smem's "vote" entry is the plan's."""
    p = _ext.fame_vote_plan(words)
    assert p["ldw"] % 2 == 1 and p["ldw"] >= words
    assert p["rows_item"] % 32 == 0 and p["items"] * p["rows_item"] >= p["n_pad"] == 32 * words
    assert (p["items"] - 1) * p["rows_item"] < p["n_pad"]
    assert (p["rows_item"] * p["ldw"] * 4) % 16 == 0
    slot = 4 * p["rows_item"] * (p["ldw"] + 1)
    cols = 8 * _ext.FV_COLS * words
    if words <= _ext.FV_REG_WORDS:
        assert p["columns"] == "registers" and p["stages"] == _ext.FV_STAGES
        assert p["smem"] == 16 * _ext.FV_STAGES + 16 + _ext.FV_STAGES * slot <= 48 * 1024
    else:
        assert p["columns"] == "shared" and 2 <= p["stages"] <= _ext.FV_STAGES
        assert p["smem"] == 16 * _ext.FV_STAGES + 16 + cols + p["stages"] * slot
        assert p["stages"] == _ext.FV_STAGES or p["smem"] + slot > _ext.MAX_SMEM_BYTES
    assert p["smem"] <= _ext.MAX_SMEM_BYTES
    assert (words == 603) == (words == _ext.FV_MAX_WORDS)
    n = 32 * words
    for packed in (False, True):
        assert _ext.block_smem("decide_fame", n, packed=packed)["vote"] == p["smem"]
        assert max(_ext.block_smem("decide_fame", n, packed=packed).values()) \
            <= _ext.MAX_SMEM_BYTES
    with pytest.raises(ValueError):
        _ext.fame_vote_plan(_ext.FV_MAX_WORDS + 1)


def test_fame_form_by_layout_and_voters(monkeypatch):
    """B21's form: the one launch where every position lies on one device,
    up to 32 * FV_MAX_WORDS voters; the per-step kernels on distinct cards
    at any width, and past that width on one device too, so that no width
    the per-step form takes is refused. _fame_loop takes it from the
    shards' voter rows."""
    one = [torch.device("cuda", 0)] * 8
    two = [torch.device("cuda", 0), torch.device("cuda", 1)] * 4
    top = 32 * _ext.FV_MAX_WORDS
    assert [_ext.shard_fame_form(one, v) for v in (8, 1024, 1056, top, top + 1)] == \
        ["grid"] * 4 + ["step"]
    assert {_ext.shard_fame_form(two, v) for v in (8, 1024, top + 1)} == {"step"}
    seen = []
    monkeypatch.setattr(_ext, "shard_fame_form",
                        lambda devices, n_voters: seen.append(n_voters) or "step")
    monkeypatch.setattr(sharded, "_step_fame", lambda *a, plain: seen.append(plain))
    mesh = DeviceMesh.on(CPU, (8,), ("rounds",))
    ss = [torch.zeros((1, 40, 40), dtype=torch.bool)] * 8
    sharded._fame_loop(mesh, "rounds", None, 8, 40, 27, 10, False, *([None] * 6), ss, None,
                       None)
    assert seen == [40, False]


# ---------------------------------------------------------------------------
# (b) shard_fame/grid: the shards gathered into the vote's tables
# ---------------------------------------------------------------------------


def shard_grid_emulate(ss_parts, votes_parts, wv_parts, coin_parts, wvalid_parts,
                       decided_parts, famous_parts, n_v, last_round, n_participants,
                       super_majority, packed, lag=_ext.FV_STAGES):
    """_ext.shard_fame_grid's launch, in place on decided_parts and
    famous_parts: phase 1's address arithmetic (position (a, v) at a * n_v
    + v; word k of a packed row in shard k // nw_l, bit t of a wide word
    32 k + t in shard (32 k + t) // nw_l; the totals over every shard's
    words; rows past last_round - 2, which do not vote, left out), then
    phase 2's vote with plane (g + d - 2) mod r_pad."""
    n_pos = len(ss_parts)
    b, ny, nw_l = ss_parts[0].shape
    n_x = wvalid_parts[0].shape[1]
    cols = n_v * nw_l
    words = cols if packed else -(-cols // 32)
    plan = _ext.fame_vote_plan(words)
    r_pad = (n_pos // n_v) * b
    ss_np = [u32(p) if packed else p.numpy() for p in ss_parts]
    votes_np = [u32(p) if packed else p.numpy() for p in votes_parts]
    ss_k = np.zeros((r_pad, plan["n_pad"], plan["ldw"]), np.uint32)
    aux_k = np.zeros((r_pad, plan["n_pad"]), np.int64)
    vt = np.zeros((r_pad, n_x, words), np.uint32)
    lr = int(last_round)
    # only rows g < g_end vote, and they read planes g' < g_end only
    g_end = min(r_pad, max(lr - 1, 0))
    for g in range(g_end):
        a, bb = divmod(g, b)
        for k in range(words):
            if packed:
                v, kl = divmod(k, nw_l)
                ss_k[g, :ny, k] = ss_np[a * n_v + v][bb, :, kl]
                vt[g, :, k] = votes_np[a * n_v + v][bb, :, kl]
                continue
            for q in range(32):
                w = 32 * k + q
                if w >= cols:
                    break
                v, wl = divmod(w, nw_l)
                ss_k[g, :ny, k] |= ss_np[a * n_v + v][bb, :, wl].astype(np.uint32) << q
                vt[g, :, k] |= votes_np[a * n_v + v][bb, wl, :].astype(np.uint32) << q
        tot = np.bitwise_count(ss_k[g, :ny, :words]).sum(axis=1)
        aux_k[g, :ny] = (tot * 4 + coin_parts[a * n_v][bb].numpy() * 2
                         + wv_parts[a * n_v][bb].numpy())
    valid = np.concatenate([wvalid_parts[a * n_v].numpy() for a in range(n_pos // n_v)])
    decided, famous = vote(ss_k, aux_k, vt, valid, lambda g, d: (g + d - 2) % r_pad,
                           lambda g: lr - g, n_participants, super_majority, lag)
    for p in range(n_pos):
        a = p // n_v
        decided_parts[p].copy_(t(decided[a * b:(a + 1) * b]))
        famous_parts[p].copy_(t(famous[a * b:(a + 1) * b]))


def emulated_fame_grid(mesh, axis, v_axis, chunk, n_participants, super_majority, d_bound,
                       packed, last_round, i_rows, wvalid, votes, decided, famous, ss_s,
                       wv_s, coin_s):
    """sharded.fame_grid's CUDA branch, with the launch emulated."""
    shard_grid_emulate(*sharded.grid_operands(mesh, axis, v_axis, ss_s, votes, wv_s, coin_s,
                                              wvalid, decided, famous), last_round[0],
                       n_participants, super_majority, packed)


def mesh_case(kind):
    if kind == "coin":
        c = coin_round_case(*COIN)
        return dict(wtable=c["wtable"], la=c["la"], fd=c["fd"], index=c["index"],
                    coin_bit=c["coin_bit"], last_round=c["last_round"], n=COIN[0],
                    super_majority=c["super_majority"])
    if kind == "random":
        c = random_tables(40, 9, 3)
        return dict(wtable=c["wtable"], la=c["la"], fd=c["fd"], index=c["index"],
                    coin_bit=c["coin_bit"], last_round=c["last_round"], n=40,
                    super_majority=c["super_majority"])
    grid = synthetic_grid(8, 192, seed=11)
    wtable, la, fd, index, coin, last_round = witness_tables(grid)
    return dict(wtable=wtable, la=la, fd=fd, index=index, coin_bit=coin,
                last_round=last_round, n=grid.n, super_majority=grid.super_majority)


MESHES = {"1-D 8": ((8,), ("rounds",)), "2-D (2, 4)": ((2, 4), ("validators", "rounds"))}
GRID_CASES = [(kind, m, packed, chunk) for kind, chunk in (("coin", 8), ("coin", 1),
                                                           ("random", 3), ("grid", 8))
              for m in MESHES for packed in (False, True)]


@pytest.mark.parametrize("kind,mesh_name,packed,chunk", GRID_CASES,
                         ids=[f"{k}-{m.replace(' ', '')}-{'packed' if p else 'wide'}-chunk{c}"
                              for k, m, p, c in GRID_CASES])
def test_shard_fame_grid_matches_plain_loop(monkeypatch, kind, mesh_name, packed, chunk):
    """sharded_fame in the one-launch form, its launch emulated, equals the
    port's plain step-by-step loop (the per-step form on the CPU) on the
    same staged input: decided and famous of every position. The coin case
    votes to d = 19 (three chunks of 8, nineteen of 1); the random tables
    (40 validators) put a wide word across two validator shards on the 2-D
    mesh. Each column stops at i + d > last_round; the step loop, whose own
    stop comes in whole chunks while d0 <= r_pad + 2, never stops earlier."""
    c = mesh_case(kind)
    mesh = DeviceMesh.on("cpu", *MESHES[mesh_name])
    n, sm = c["n"], c["super_majority"]
    g = SimpleNamespace(n=n, super_majority=sm, coin_bit=c["coin_bit"])
    la, fd, index = (to_device(c[k], CPU) for k in ("la", "fd", "index"))
    st = sharded.stage_fame(mesh, g, c["wtable"], la, fd, index, packed)
    assert c["last_round"] < st.r_pad
    lr = torch.tensor(c["last_round"], dtype=torch.int32)
    want = sharded.sharded_fame(mesh, st, lr, chunk, n, sm, packed, form="step")
    monkeypatch.setattr(sharded, "fame_grid", emulated_fame_grid)
    got = sharded.sharded_fame(mesh, st, lr, chunk, n, sm, packed, form="grid")
    for name, a, b in zip(("decided", "famous"), got, want):
        assert torch.equal(a, b), name
    assert want[0].any(), "the case decides nothing"
