"""The port's device mesh (babble_tpu_torch.tpu.mesh, .sharded) on the CPU
against the JAX package's sharded engines on a JAX CPU mesh of the same
shape and axis names, and against the port's single-device engines: exact
equality, no tolerance (INV compared as integers). Every position of a
port mesh lies on "cpu", so each kernel wrapper runs its plain version.
Ports the differentials of tests/test_multichip.py (:43-121, :288-330)
and holds the staged per-position functions (local_fame, local_received,
_fame_tables, local_walk) to the JAX functions on the same staged
inputs."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from babble_tpu.tpu import grid_from_hashgraph as ref_grid_from_hashgraph
from babble_tpu.tpu import kernels as ref_kernels
from babble_tpu.tpu import run_passes as ref_run_passes
from babble_tpu.tpu import sharded as ref_sharded
from babble_tpu.tpu import synthetic_grid
from babble_tpu.tpu.engine import run_frontier_passes as ref_run_frontier_passes
from babble_tpu.tpu.frontier import build_inv as ref_build_inv
from babble_tpu.tpu.grid import section_grid
from babble_tpu.tpu.packed import pack_bits as ref_pack_bits
from babble_tpu.tpu.packed import pack_votes_t as ref_pack_votes_t
from babble_tpu_torch.tpu import engine as port_engine
from babble_tpu_torch.tpu import grid_from_arrays
from babble_tpu_torch.tpu import mesh as port_mesh_mod
from babble_tpu_torch.tpu import sharded as port
from babble_tpu_torch.tpu.device import to_device
from babble_tpu_torch.tpu.mesh import DeviceMesh

from dsl import init_consensus_hashgraph, init_simple_hashgraph

CPU = torch.device("cpu")


def jax_mesh(shape, names):
    devices = jax.devices("cpu")
    k = int(np.prod(shape))
    if len(devices) < k:
        pytest.skip(f"need {k} CPU devices, have {len(devices)}")
    return Mesh(np.array(devices[:k]).reshape(shape), names)


def port_mesh_like(jmesh):
    """The port DeviceMesh of a JAX mesh's shape and axis names, every
    position on the CPU."""
    return DeviceMesh.on("cpu", jmesh.devices.shape, jmesh.axis_names)


def meshes(shape, names):
    jm = jax_mesh(shape, names)
    return jm, port_mesh_like(jm)


MESH_1D = {k: ((k,), ("rounds",)) for k in (2, 4, 8)}
MESH_2D = ((2, 2), ("validators", "rounds"))


def assert_same(got, want, what, tables="all"):
    """PassResults fields; the fame tables in full, or on their overlap
    (tables="overlap", the adaptive single-device round axis), famous
    where decided."""
    for f in ("rounds", "witness", "lamport", "received"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f"{what}: {f}")
    assert got.last_round == want.last_round, what
    gd, wd = np.asarray(got.fame_decided), np.asarray(want.fame_decided)
    gf, wf = np.asarray(got.famous) & gd, np.asarray(want.famous) & wd
    r = min(gd.shape[0], wd.shape[0]) if tables == "overlap" else None
    np.testing.assert_array_equal(gd[:r], wd[:r], err_msg=f"{what}: fame_decided")
    np.testing.assert_array_equal(gf[:r], wf[:r], err_msg=f"{what}: famous")
    if tables == "all":
        np.testing.assert_array_equal(np.asarray(got.rounds_decided),
                                      np.asarray(want.rounds_decided),
                                      err_msg=f"{what}: rounds_decided")
        np.testing.assert_array_equal(np.asarray(got.witness_table),
                                      np.asarray(want.witness_table),
                                      err_msg=f"{what}: witness_table")


def port_grid(grid):
    return grid_from_arrays(vars(grid))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_mesh_shard_unshard_and_collectives():
    mesh = DeviceMesh.on("cpu", (2, 4), ("validators", "rounds"))
    x = torch.arange(8 * 6).reshape(8, 6)
    # a dim over (validators, rounds): block of (v, r) is v * 4 + r
    parts = port_mesh_mod.shard(x, mesh, (("validators", "rounds"), None))
    for pos in range(8):
        v, r = mesh.coords(pos)
        assert torch.equal(parts[pos], x[v * 4 + r: v * 4 + r + 1])
    assert torch.equal(port_mesh_mod.unshard(parts, mesh, (("validators", "rounds"),)), x)
    rows = port_mesh_mod.shard(x, mesh, ("rounds", "validators"))
    assert rows[mesh.position((1, 2))].shape == (2, 3)
    assert torch.equal(port_mesh_mod.unshard(rows, mesh, ("rounds", "validators")), x)
    # psum over validators, all_gather and axis_index over rounds
    summed = port_mesh_mod.psum(rows, mesh, "validators")
    for pos in range(8):
        v, r = mesh.coords(pos)
        other = rows[mesh.position((1 - v, r))]
        assert torch.equal(summed[pos], rows[pos] + other)
    gathered = port_mesh_mod.all_gather(rows, mesh, "rounds")
    assert torch.equal(gathered[mesh.position((1, 0))], x[:, 3:])
    assert port_mesh_mod.axis_index(mesh.position((1, 3)), mesh, "rounds") == 3
    assert port_mesh_mod.axis_index(mesh.position((1, 3)), mesh, ("validators", "rounds")) == 7
    # the left ring shift along rounds: position r takes r + 1's first row
    before = [p.clone() for p in rows]
    port_mesh_mod.ppermute_shift_left(rows, mesh, "rounds")
    for pos in range(8):
        v, r = mesh.coords(pos)
        nxt = before[mesh.position((v, (r + 1) % 4))]
        assert torch.equal(rows[pos], torch.cat([before[pos][1:], nxt[:1]]))


def test_mesh_helpers_match_reference():
    for shape, names in (((8,), ("rounds",)), MESH_2D):
        jm, pm = meshes(shape, names)
        assert port._mesh_axes(pm) == ref_sharded._mesh_axes(jm)
        assert port.mesh_validator_shards(pm) == ref_sharded.mesh_validator_shards(jm)
        for dbl in (False, True):
            assert (port.sharded_engine_tag(pm, doubling=dbl)
                    == ref_sharded.sharded_engine_tag(jm, doubling=dbl))
    a = np.arange(6, dtype=np.int32).reshape(3, 2)
    np.testing.assert_array_equal(port._pad_axis0(a, 5, -1), ref_sharded._pad_axis0(a, 5, -1))


# ---------------------------------------------------------------------------
# tests/test_multichip.py's differentials
# ---------------------------------------------------------------------------


def assert_run_matches(grid, shape, names, packed=None):
    jm, pm = meshes(shape, names)
    want = ref_sharded.sharded_run_passes(jm, grid, packed=packed)
    pg = port_grid(grid)
    got = port.sharded_run_passes(pm, pg, packed=packed)
    assert_same(got, want, f"sharded_run_passes {shape}")
    single = port_engine.run_passes(pg, device="cpu", packed=packed)
    assert_same(got, single, f"sharded_run_passes {shape} vs run_passes")


def assert_frontier_matches(grid, shape, names, packed=None, r_cap=None):
    jm, pm = meshes(shape, names)
    want = ref_sharded.sharded_frontier_passes(jm, grid, r_cap=r_cap, packed=packed)
    pg = port_grid(grid)
    got = port.sharded_frontier_passes(pm, pg, r_cap=r_cap, packed=packed)
    assert_same(got, want, f"sharded_frontier_passes {shape}")
    single = port_engine.run_frontier_passes(pg, device="cpu", packed=packed)
    assert_same(got, single, f"sharded_frontier_passes {shape} vs run_frontier_passes",
                tables="overlap")


@pytest.mark.parametrize("n_devices,packed", [(2, None), (8, None), (8, True)])
def test_synthetic_sharded_differential(n_devices, packed):
    assert_run_matches(synthetic_grid(8, 192, seed=11), *MESH_1D[n_devices], packed=packed)


def test_zipf_sharded_differential():
    assert_run_matches(synthetic_grid(16, 384, seed=23, zipf_a=1.1), *MESH_1D[8])


def test_fixture_sharded_differential():
    hg, _, _ = init_consensus_hashgraph()
    assert_run_matches(ref_grid_from_hashgraph(hg), *MESH_1D[4])


def test_simple_fixture_sharded_differential():
    hg, _, _ = init_simple_hashgraph()
    assert_run_matches(ref_grid_from_hashgraph(hg), *MESH_1D[2])


@pytest.mark.parametrize("n_devices,packed", [(2, None), (8, None), (8, True)])
def test_frontier_sharded_differential(n_devices, packed):
    assert_frontier_matches(synthetic_grid(8, 192, seed=11), *MESH_1D[n_devices],
                            packed=packed)


def test_frontier_sharded_zipf():
    assert_frontier_matches(synthetic_grid(16, 384, seed=23, zipf_a=1.1), *MESH_1D[8])


def test_frontier_sharded_chain_padding():
    """12 validators over 8 positions: the chain axis pads to 16."""
    assert_frontier_matches(synthetic_grid(12, 300, seed=7), *MESH_1D[8])


def test_frontier_sharded_fixture():
    hg, _, _ = init_consensus_hashgraph()
    assert_frontier_matches(ref_grid_from_hashgraph(hg), *MESH_1D[4])


def test_frontier_sharded_n256():
    """256 validators, Zipf fan-out, r_cap 16 (the retry at the provable
    cap), 32 chains per position: against the JAX single-device engine
    only (the JAX sharded run of this case takes about 25 s)."""
    grid = synthetic_grid(256, 1024, seed=41, zipf_a=1.05)
    pm = DeviceMesh.on("cpu", (8,), ("rounds",))
    pg = port_grid(grid)
    got = port.sharded_frontier_passes(pm, pg, r_cap=16)
    want = ref_run_frontier_passes(grid)
    assert_same(got, want, "n256 vs the JAX run_frontier_passes", tables="overlap")


def assert_2d_matches(grid, packed=None):
    assert_run_matches(grid, *MESH_2D, packed=packed)
    assert_frontier_matches(grid, *MESH_2D, packed=packed)


@pytest.mark.parametrize("packed", [None, True])
def test_2d_mesh_synthetic_differential(packed):
    assert_2d_matches(synthetic_grid(8, 192, seed=11), packed=packed)


def test_2d_mesh_witness_padding():
    """7 validators over 2 validator shards: the witness axes pad to 8 (to
    64 when packed: 32 x the validator shards)."""
    assert_2d_matches(synthetic_grid(7, 128, seed=9))
    assert_run_matches(synthetic_grid(7, 128, seed=9), *MESH_2D, packed=True)


def test_2d_mesh_fixture_differential():
    hg, _, _ = init_consensus_hashgraph()
    assert_2d_matches(ref_grid_from_hashgraph(hg))


def test_2d_mesh_post_reset_section():
    """A post-reset section: the level scan against the JAX package and
    the single-device run_passes; the frontier walk (which the port's
    one-shot engine refuses on such a grid, and the sharded one takes as
    the reference's does) against the JAX package's sharded walk."""
    grid = synthetic_grid(8, 192, seed=11)
    sec = section_grid(grid, ref_run_passes(grid), cut=4)
    assert_run_matches(sec, *MESH_2D)
    jm, pm = meshes(*MESH_2D)
    want = ref_sharded.sharded_frontier_passes(jm, sec)
    got = port.sharded_frontier_passes(pm, port_grid(sec))
    assert_same(got, want, "sharded_frontier_passes on the section")


@pytest.mark.parametrize("packed", [None, True])
def test_2d_mesh_doubling_cold_path(packed):
    grid = synthetic_grid(8, 192, seed=11)
    jm, pm = meshes(*MESH_2D)
    want = ref_sharded.sharded_doubling_passes(jm, grid, packed=packed)
    st = {}
    got = port.sharded_doubling_passes(pm, port_grid(grid), stats=st, packed=packed)
    assert_same(got, want, "sharded_doubling_passes")
    assert got.round_offset == want.round_offset
    assert st["passes"] >= 1
    single = port_engine.run_frontier_passes(port_grid(grid), device="cpu")
    np.testing.assert_array_equal(got.received, single.received)


# ---------------------------------------------------------------------------
# the staged per-position functions against the JAX ones
# ---------------------------------------------------------------------------


def jax_stage(jmesh, n, sm, coin_bit, wtable_np, la, fd, index, packed):
    """sharded.py:373-413's staging on the JAX side, as numpy: (ss_s,
    votes, wv_s, coin_s, wvalid)."""
    axis, v_axis = ref_sharded._mesh_axes(jmesh)
    ndev_r = int(jmesh.shape[axis])
    ndev_v = int(jmesh.shape[v_axis]) if v_axis is not None else 1
    r_rows = wtable_np.shape[0]
    r_pad = ((r_rows + ndev_r - 1) // ndev_r) * ndev_r
    n_quant = 32 * ndev_v if packed else ndev_v
    n_pad_v = ((n + n_quant - 1) // n_quant) * n_quant
    wtable = ref_sharded._pad_axis0(wtable_np, r_pad, -1)
    ss, votes0, wvalid, coin_w = ref_kernels._fame_setup(
        jnp.asarray(wtable), jnp.asarray(la), jnp.asarray(fd), jnp.asarray(index),
        jnp.asarray(coin_bit), sm)
    padw = n_pad_v - n
    ss_y = jnp.pad(ss, ((0, 0), (0, padw), (0, padw)))
    votes0 = jnp.pad(votes0, ((0, 0), (0, padw), (0, 0)))
    wv_y = jnp.pad(wvalid, ((0, 0), (0, padw)))
    coin_y = jnp.pad(coin_w, ((0, 0), (0, padw)))
    if packed:
        ss_s = ref_pack_bits(jnp.roll(ss_y, -2, axis=0))
        votes = ref_pack_votes_t(votes0)
    else:
        ss_s = jnp.roll(ss_y, -2, axis=0)
        votes = votes0
    return tuple(np.asarray(a) for a in (ss_s, votes, jnp.roll(wv_y, -2, axis=0),
                                         jnp.roll(coin_y, -2, axis=0), wvalid))


def as_np(t, packed_words=False):
    a = t.cpu().numpy()
    return a.view(np.uint32) if packed_words else a


def coin_tables(n, r, seed):
    """Random voting tables that reach coin steps (chip_smoke.py's
    coin_round_case): witness (round, creator) on row round * n + creator,
    a tenth absent, lastAncestors mostly above firstDescendants."""
    rng = np.random.default_rng(seed)
    e = r * n
    wtable = np.arange(e, dtype=np.int32).reshape(r, n)
    absent = rng.random((r, n)) < 0.1
    absent[0] = absent[-1] = False
    wtable[absent] = -1
    return dict(wtable=wtable, la=rng.integers(2, 10, size=(e, n), dtype=np.int32),
                fd=rng.integers(0, 8, size=(e, n), dtype=np.int32),
                index=rng.integers(0, 10, size=e, dtype=np.int32),
                coin_bit=rng.random(e) < 0.5, last_round=r - 1, n=n,
                super_majority=2 * n // 3 + 1)


def grid_tables(grid):
    """The fame inputs of a grid: its single-device witness table and rounds."""
    res = ref_run_passes(grid)
    return dict(wtable=np.asarray(res.witness_table), la=grid.last_ancestors,
                fd=grid.first_descendants, index=grid.index, coin_bit=grid.coin_bit,
                last_round=int(res.last_round), n=grid.n,
                super_majority=grid.super_majority, rounds=np.asarray(res.rounds),
                creator=grid.creator)


FAME_CASES = [
    ("grid", (8,), False), ("grid", (8,), True), ("grid", (2, 2), False),
    ("grid", (2, 2), True), ("coin", (2, 2), True), ("coin", (4,), False),
]


@pytest.mark.parametrize("kind,shape,packed", FAME_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}-{'packed' if p else 'wide'}"
                              for k, s, p in FAME_CASES])
def test_fame_loop_matches_reference(kind, shape, packed):
    """stage_fame's inputs equal the JAX staging; the port's fame loop and
    its _fame_tables and local_received equal _fame_loop_fn, _fame_tables
    and _received_fn on them. The coin cases reach coin steps (8
    validators, 20 rounds: d = 8 and 16)."""
    tab = coin_tables(8, 20, 52) if kind == "coin" else grid_tables(synthetic_grid(8, 192,
                                                                                  seed=11))
    names = ("rounds",) if len(shape) == 1 else ("validators", "rounds")
    jm, pm = meshes(shape, names)
    axis, v_axis = ref_sharded._mesh_axes(jm)
    n, sm, chunk = tab["n"], tab["super_majority"], 8
    g = SimpleNamespace(n=n, super_majority=sm, coin_bit=tab["coin_bit"])
    la, fd, index = (to_device(tab[k], CPU) for k in ("la", "fd", "index"))
    st = port.stage_fame(pm, g, tab["wtable"], la, fd, index, packed)
    want_in = jax_stage(jm, n, sm, tab["coin_bit"], tab["wtable"], tab["la"], tab["fd"],
                        tab["index"], packed)
    got_in = (as_np(st.ss_s, packed), as_np(st.votes, packed), as_np(st.wv_s),
              as_np(st.coin_s), as_np(st.wvalid))
    for name, a, b in zip(("ss_s", "votes", "wv_s", "coin_s", "wvalid"), got_in, want_in):
        np.testing.assert_array_equal(a, b, err_msg=f"staged {name}")

    lr = tab["last_round"]
    decided, famous = port.sharded_fame(pm, st, lr, chunk, n, sm, packed)
    r_pad = st.r_pad

    def put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(jm, spec))

    fn = ref_sharded._fame_loop_fn(jm, axis, chunk, n, sm, r_pad + 2, v_axis, packed=packed)
    votes_spec = P(axis, None, v_axis) if packed else P(axis, v_axis, None)
    zeros = np.zeros((r_pad, n), bool)
    _, w_dec, w_fam = fn(
        put(np.int32(lr), P()), put(np.arange(r_pad, dtype=np.int32), P(axis)),
        put(want_in[4], P(axis, None)), put(want_in[1], votes_spec),
        put(zeros, P(axis, None)), put(zeros.copy(), P(axis, None)),
        put(want_in[0], P(axis, None, v_axis)), put(want_in[2], P(axis, None)),
        put(want_in[3], P(axis, None)))
    np.testing.assert_array_equal(decided.numpy(), np.asarray(w_dec))
    np.testing.assert_array_equal(famous.numpy(), np.asarray(w_fam))
    assert decided.any(), "the case decides nothing"

    wt = st.wtable
    got_t = port.fame_tables(wt, la, decided, famous, torch.tensor(lr, dtype=torch.int32))
    want_t = ref_sharded._fame_tables(jnp.asarray(wt.numpy()), jnp.asarray(tab["la"]),
                                      jnp.asarray(w_dec), jnp.asarray(w_fam), jnp.int32(lr))
    for a, b in zip(got_t, want_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind == "coin":
        return
    ev_axes = (v_axis, axis) if v_axis is not None else axis
    rfn = ref_sharded._received_fn(jm, ev_axes)
    e = len(tab["index"])
    e_pad = ((e + pm.size - 1) // pm.size) * pm.size
    pad = ref_sharded._pad_axis0
    want_r = np.asarray(rfn(
        put(pad(tab["index"], e_pad, 0), P(ev_axes)), put(pad(tab["creator"], e_pad, 0),
                                                           P(ev_axes)),
        put(pad(tab["rounds"], e_pad, -1), P(ev_axes)),
        *(put(np.asarray(t), P()) for t in want_t[:4])))[:e]
    fame = (wt, la, decided, famous, torch.tensor(lr, dtype=torch.int32))
    for form in ("grid", "step"):
        tables, got_r = port.sharded_received(pm, tab["index"], tab["creator"], tab["rounds"],
                                              fame, form=form)
        for a, b in zip(tables, want_t):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=form)
        np.testing.assert_array_equal(got_r.numpy(), want_r, err_msg=form)


MESH_FORM_CASES = [((8,), ("rounds",)), ((2, 4), ("validators", "rounds"))]


@pytest.mark.parametrize("shape,names", MESH_FORM_CASES, ids=["1-D 8", "2-D (2, 4)"])
def test_received_forms_match_reference(shape, names):
    """sharded_received in both forms (one launch of B23 and B22 over the
    unsharded event axis; B23, then B22 on each position's padded event
    shard) on chip_smoke.received_trap_case's tables and events (creators
    and rounds outside their ranges, rounds with no famous witness, witness
    rows past la) with 955 events, not a multiple of 8: equal to each other
    and to the JAX _fame_tables, then _received_fn over the event shards."""
    from chip_smoke import received_trap_case

    case = received_trap_case(40, 6, 3)
    e = 955
    index, creator, rounds = (case[k][:e] for k in ("index", "creator", "rounds"))
    jm, pm = meshes(shape, names)
    axis, v_axis = ref_sharded._mesh_axes(jm)
    ev_axes = (v_axis, axis) if v_axis is not None else axis
    lr = 3
    want_t = ref_sharded._fame_tables(*(jnp.asarray(case[k]) for k in (
        "wtable", "la", "decided", "famous")), jnp.int32(lr))

    def put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(jm, spec))

    e_pad = ((e + pm.size - 1) // pm.size) * pm.size
    pad = ref_sharded._pad_axis0
    want_r = np.asarray(ref_sharded._received_fn(jm, ev_axes)(
        put(pad(index, e_pad, 0), P(ev_axes)), put(pad(creator, e_pad, 0), P(ev_axes)),
        put(pad(rounds, e_pad, -1), P(ev_axes)),
        *(put(np.asarray(x), P()) for x in want_t[:4])))[:e]
    assert (want_r >= 0).any() and (want_r < 0).any()
    fame = tuple(to_device(case[k], CPU) for k in ("wtable", "la", "decided", "famous")) + (
        torch.tensor(lr, dtype=torch.int32),)
    got = {form: port.sharded_received(pm, index, creator, rounds, fame, form=form)
           for form in ("grid", "step")}
    for form, (tables, received) in got.items():
        for a, b in zip(tables, want_t):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=form)
        np.testing.assert_array_equal(received.numpy(), want_r, err_msg=form)
    assert port.sharded_received(pm, index, creator, rounds, fame)[1].shape == (e,)
    with pytest.raises(ValueError):
        port.sharded_received(pm, index, creator, rounds, fame, form="bogus")


@pytest.mark.parametrize("shape,names", MESH_FORM_CASES, ids=["1-D 8", "2-D (2, 4)"])
def test_build_inv_forms_match_reference(shape, names):
    """sharded_build_inv in both forms (one build over every position's
    chains, each part a view; one build a position) on a chain table of 20
    validators padded to 24 chains: equal to each other and to the JAX
    _sharded_build_inv_fn; stage_walk on one device stages the chain table
    once and gives each position views of it and of one INV."""
    from babble_tpu.tpu.engine import _bucket, pad_grid
    from babble_tpu.tpu.frontier import chain_table

    grid = synthetic_grid(20, 500, seed=3, zipf_a=1.1)
    jm, pm = meshes(shape, names)
    r_axis, v_axis = ref_sharded._mesh_axes(jm)
    axis = (v_axis, r_axis) if v_axis is not None else r_axis
    rows_by = chain_table(grid)
    l_b = _bucket(rows_by.shape[1], 64, factor=2)
    rb_pad = np.full((24, l_b), -1, dtype=np.int32)
    rb_pad[:20, : rows_by.shape[1]] = rows_by
    gp = pad_grid(grid)

    def put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(jm, spec))

    want = np.asarray(ref_sharded._sharded_build_inv_fn(jm, axis)(
        put(rb_pad, P(axis, None)), put(gp.last_ancestors, P()))).astype(np.int32)
    la_parts = port_mesh_mod.replicate(to_device(gp.last_ancestors, CPU), pm)
    rb_parts = port_mesh_mod.shard(rb_pad, pm, (axis, None))
    for form in ("grid", "step", None):
        parts = port.sharded_build_inv(pm, rb_parts, la_parts, form=form)
        got = port_mesh_mod.unshard(parts, pm, (axis, None, None))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(form))
    st = port.stage_walk(pm, port_grid(grid))
    base = st.inv_parts[0].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in st.inv_parts)
    assert all(p.untyped_storage().data_ptr() == st.rb_parts[0].untyped_storage().data_ptr()
               for p in st.rb_parts)
    np.testing.assert_array_equal(
        port_mesh_mod.unshard(st.inv_parts, pm, (axis, None, None)).numpy(), want)
    with pytest.raises(ValueError):
        port.sharded_build_inv(pm, rb_parts, la_parts, form="bogus")


WALK_CASES = [
    # (n, events, seed, mesh shape, r_cap, form): 8 x 2 = 16 and 4 x 64 =
    # 256 chains in the sort form, 8 x 64 = 512 chains in the binary
    # search. r_cap "engine" is sharded_frontier_passes' own cap l_b + 2,
    # where the walk reaches its fixed point mid-history; r_cap 3 stops it
    # while it still moves. form None is local_walk's default (one device:
    # the one-launch form, on the CPU the plain whole walk), "step" the
    # per-step form.
    pytest.param(12, 300, 7, (8,), 12, None, id="12-300-7-shape0"),
    pytest.param(64, 512, 3, (2, 2), 12, None, id="64-512-3-shape1"),
    pytest.param(512, 1024, 5, (8,), 12, None, id="512-1024-5-shape2"),
    pytest.param(12, 300, 7, (8,), "engine", None, id="12-300-7-1d-engine-cap"),
    pytest.param(12, 300, 7, (8,), "engine", "step", id="12-300-7-1d-engine-cap-step"),
    pytest.param(64, 512, 3, (2, 2), "engine", None, id="64-512-3-2d-engine-cap"),
    pytest.param(64, 512, 3, (2, 2), "engine", "step", id="64-512-3-2d-engine-cap-step"),
    pytest.param(512, 1024, 5, (8,), "engine", None, id="512-1024-5-1d-engine-cap"),
    pytest.param(64, 512, 3, (2, 2), 12, "step", id="64-512-3-2d-step"),
    pytest.param(12, 300, 7, (8,), 3, None, id="12-300-7-1d-still-moving"),
]


@pytest.mark.parametrize("n,e,seed,shape,r_cap,form", WALK_CASES)
def test_frontier_walk_matches_reference(n, e, seed, shape, r_cap, form):
    """The chains-sharded INV (as integers) and local_walk against
    _sharded_build_inv_fn and _frontier_walk_fn on the same staged inputs;
    the m0 form switches on the padded chain count as the reference's. At
    the engine's cap the reference's full-length scan reaches its fixed
    point mid-history, and the port's history equals it row for row; at
    r_cap 3 it still moves at the last row."""
    from babble_tpu.tpu.engine import _bucket, pad_grid
    from babble_tpu.tpu.frontier import M0_BINSEARCH_MIN_N, chain_table

    grid = synthetic_grid(n, e, seed=seed, zipf_a=1.1)
    names = ("rounds",) if len(shape) == 1 else ("validators", "rounds")
    jm, pm = meshes(shape, names)
    r_axis, v_axis = ref_sharded._mesh_axes(jm)
    axis = (v_axis, r_axis) if v_axis is not None else r_axis
    rows_by = chain_table(grid)
    l_b = _bucket(rows_by.shape[1], 64, factor=2)
    ndev = pm.size
    n_pad = ((n + ndev - 1) // ndev) * ndev
    rb_pad = np.full((n_pad, l_b), -1, dtype=np.int32)
    rb_pad[:n, : rows_by.shape[1]] = rows_by
    gp = pad_grid(grid)
    x0 = np.where(rb_pad[:, 0] >= 0, 0, l_b).astype(np.int32)
    if r_cap == "engine":
        r_cap = l_b + 2
    assert (n_pad >= M0_BINSEARCH_MIN_N) == (n >= 512)

    def put(a, spec):
        return jax.device_put(np.asarray(a), NamedSharding(jm, spec))

    rb_j = put(rb_pad, P(axis, None))
    inv_j = ref_sharded._sharded_build_inv_fn(jm, axis)(rb_j, put(gp.last_ancestors, P()))
    want = np.asarray(ref_sharded._frontier_walk_fn(jm, axis, grid.super_majority, r_cap,
                                                    l_b)(
        inv_j, rb_j, put(gp.first_descendants, P()), put(gp.last_ancestors, P()),
        put(x0, P(axis))))

    la_parts = port_mesh_mod.replicate(to_device(gp.last_ancestors, CPU), pm)
    fd_parts = port_mesh_mod.replicate(to_device(gp.first_descendants, CPU), pm)
    rb_parts = port_mesh_mod.shard(rb_pad, pm, (axis, None))
    inv_parts = port.sharded_build_inv(pm, rb_parts, la_parts)
    inv = port_mesh_mod.unshard(inv_parts, pm, (axis, None, None))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_j).astype(np.int32))
    np.testing.assert_array_equal(
        inv[:n].numpy(), np.asarray(ref_build_inv(rb_pad[:n], gp.last_ancestors)).astype(
            np.int32))
    hist = port.local_walk(pm, axis, grid.super_majority, r_cap, l_b, inv_parts, rb_parts,
                           fd_parts, la_parts, port_mesh_mod.shard(x0, pm, (axis,)), form=form)
    got = port_mesh_mod.unshard(hist, pm, (None, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    still = [bool((want[r + 1] != want[r]).any()) for r in range(r_cap - 1)]
    if r_cap == l_b + 2:
        fixed = still.index(False)
        assert fixed + 2 < r_cap and not any(still[fixed:]), "no fixed point mid-history"
    if r_cap == 3:
        assert still[-1], "the walk stopped moving before r_cap"
    assert (want[-1] > 0).any(), "the walk never advanced"


def test_shard_walk_form_follows_the_layout():
    """B24's form is chosen by layout alone: one device, the one-launch
    walk; distinct cards, the per-step form; an unknown form raises."""
    assert port._ext.shard_walk_form(["cpu"] * 8) == "grid"
    assert port._ext.shard_walk_form([torch.device("cuda", 0)] * 4) == "grid"
    assert port._ext.shard_walk_form(["cuda:0", "cuda:1", "cuda:0"]) == "step"
    pm = DeviceMesh.on("cpu", (2,), ("rounds",))
    with pytest.raises(ValueError):
        port.local_walk(pm, "rounds", 1, 2, 64, [], [], [], [], [], form="bogus")
