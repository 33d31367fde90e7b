"""The port's hashgraph seam against the JAX package's, on the CPU (plain
versions): grid_from_hashgraph field for field, run_consensus_device on
each rung of its ladder (the round-frontier walk on a base DAG, the level
scan after a reset, the cold path when forced), K13 `_pack_results`
against the JAX program including a clamped window start, the vector
each live call fetches (the last decide's, or K13's own launch where no
decide ran since the last pack) against the JAX engine's, and
run_consensus_live fed one sync at a time against the JAX live engine,
every IncState field equal after every call, in the default, rebase,
pipelined-fetch, multi_step and large-history-attach variants. Each DAG
is built in the JAX package and carried across with
hashgraph_from_events; blocks are compared byte for byte with the host
engine's. Exact equality, no tolerance."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import babble_tpu.tpu.incremental as ref_inc
import babble_tpu.tpu.live as ref_live
from babble_tpu.hashgraph import Event as RefEvent
from babble_tpu.hashgraph import Hashgraph as RefHashgraph
from babble_tpu.hashgraph import InmemStore as RefInmemStore
from babble_tpu.tpu import GridUnsupported as RefGridUnsupported
from babble_tpu.tpu import grid_from_hashgraph as ref_grid_from_hashgraph
from babble_tpu.tpu import run_consensus_device as ref_run_consensus_device
from babble_tpu.tpu import synthetic_grid
from babble_tpu_torch.hashgraph import Event
from babble_tpu_torch.tpu import GridUnsupported, grid_from_hashgraph, run_consensus_device
from babble_tpu_torch.tpu import incremental as inc
from babble_tpu_torch.tpu import live

from test_torch_hashgraph import (
    assert_same_consensus,
    carry,
    ref_events,
    reset_pair,
)
from test_tpu_differential import build_hashgraph_from_grid, clone_hashgraph

# one validator count and one DAG for the live engine's variants, so that
# the JAX side compiles a few programs: the issue's sizing grid
LIVE_GRID = (5, 240, 13)
SYNC = 16


@functools.lru_cache(maxsize=None)
def dag(n, e, seed, zipf=0.0):
    """A synthetic DAG built as signed events in a JAX-package hashgraph
    (no consensus run): the source every copy below is made from."""
    return build_hashgraph_from_grid(synthetic_grid(n, e, seed=seed, zipf_a=zipf))[0]


def host_reference(ref_hg):
    """The JAX package's host engine on a copy: (hashgraph, blocks)."""
    h = clone_hashgraph(ref_hg)
    blocks = []
    h.commit_callback = blocks.append
    h.run_consensus()
    return h, blocks


def assert_grids_equal(got, want, what):
    for f in ("n", "e", "super_majority", "num_levels", "hashes"):
        assert getattr(got, f) == getattr(want, f), f"{what}: {f}"
    for f in ("creator", "index", "self_parent", "other_parent", "last_ancestors",
              "first_descendants", "coin_bit", "fixed_round", "ext_sp_round",
              "ext_op_round", "ext_sp_lamport", "ext_op_lamport", "fixed_lamport",
              "levels"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {f}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


GRID_CASES = [("synthetic",) + LIVE_GRID, ("reset", "funky", 1), ("reset", "sparse", 1)]
GRID_IDS = ["-".join(str(p) for p in c) for c in GRID_CASES]


def case_hashgraphs(case, ref_hg=None):
    """(reference hashgraph, its blocks list, port hashgraph, its blocks
    list, host-engine hashgraph, its blocks list), all holding the same
    DAG, no consensus run: the host copy is the reference's for a base
    DAG and a second port copy after a reset."""
    if case[0] == "reset":
        return reset_pair(case[1], case[2], copies=2)
    if ref_hg is None:
        ref_hg = dag(*case[1:])
    out = []
    for make in (lambda cb: clone_hashgraph(ref_hg),
                 lambda cb: carry(ref_hg, commit_callback=cb),
                 lambda cb: clone_hashgraph(ref_hg)):
        blocks = []
        hg = make(blocks.append)
        hg.commit_callback = blocks.append
        out += [hg, blocks]
    return tuple(out)


@pytest.mark.parametrize("case", GRID_CASES, ids=GRID_IDS)
def test_grid_from_hashgraph_matches_reference(case):
    ref, _, port, _, _, _ = case_hashgraphs(case)
    assert_grids_equal(grid_from_hashgraph(port), ref_grid_from_hashgraph(ref), str(case))


def rung_cells(hg):
    """The ledger's integrate cells of the engine rungs that ran."""
    return sorted(k.split("/")[0] for k in hg.obs.devledger.snapshot()
                  if k.endswith("/integrate"))


@pytest.mark.parametrize("case,rung", [
    (GRID_CASES[0], "frontier"),
    (GRID_CASES[1], "oneshot"),
    (GRID_CASES[2], "oneshot"),
    (("synthetic", 4, 96, 11), "doubling"),
], ids=["base-frontier", "reset-funky-1-levelscan", "reset-sparse-1-levelscan",
        "forced-doubling"])
def test_run_consensus_device_matches_reference_and_host(case, rung, monkeypatch):
    """The port's one-shot rung (device="cpu"), the JAX package's and the
    host engine give the same blocks and per-event fields; the port took
    the named rung of its ladder (the cold path forced as
    test_doubling.py forces it, for both packages)."""
    ref_hg = None
    if rung == "doubling":
        monkeypatch.setenv("BABBLE_DOUBLING_CROSSOVER", "1")
        ref_hg = dag(4, 96, 11, 1.1)
    ref, ref_blocks, port, port_blocks, host, host_blocks = case_hashgraphs(case, ref_hg)
    host.run_consensus()
    ref_run_consensus_device(ref)
    run_consensus_device(port, device="cpu")
    assert rung_cells(port) == [rung]
    assert_same_consensus(ref, ref_blocks, port, port_blocks, f"{case}: port vs JAX")
    assert_same_consensus(host, host_blocks, port, port_blocks, f"{case}: port vs host")


@functools.lru_cache(maxsize=None)
def ref_step_states():
    """JAX IncStates after each step over an 8-validator grid's batches
    (n 8, e_cap 1,024, r_cap 16, e_win 256, r_win 8), as numpy arrays."""
    g = synthetic_grid(8, 512, seed=5, zipf_a=1.1, record_fd_updates=True)
    st = ref_inc.init_state(g.n, 1024, 16)
    out = []
    for b in ref_inc.batches_from_grid(g, 32, 8192, 1024):
        st = ref_inc.step(st, b, g.super_majority, g.n, r_win=8, e_win=256)
        out.append({f: np.asarray(getattr(st, f)) for f in ref_inc.IncState._fields})
    return out


def test_pack_results_plain_matches_reference():
    """K13's plain version equals the JAX program on states carried across
    with state_from_arrays, at window starts inside the rows, at and past
    the clamp and negative (counted from the end, as
    jax.lax.dynamic_slice counts it); _unpack_results round-trips it."""
    states = ref_step_states()
    e_cap, e_win, r_cap, n = 1024, 256, 16, 8
    for k in (0, len(states) // 2, len(states) - 1):
        arrays = states[k]
        count = int(arrays["count"])
        port_st = inc.state_from_arrays(arrays, device="cpu")
        ref_st = ref_inc.IncState(**{f: jnp.asarray(a) for f, a in arrays.items()})
        for lo in (0, max(count - e_win, 0), count - e_win, -7,
                   e_cap - e_win, e_cap - e_win + 1000):
            want = np.asarray(ref_live._pack_results(ref_st, jnp.int32(lo), e_win, r_cap, n))
            got = live._pack_results(port_st, lo, e_win, r_cap, n)
            assert got.dtype == torch.int32 and got.shape == (4 * e_win + 3 * r_cap * n + 3,)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"state {k}, lo {lo}")
            got_u = live._unpack_results(got.numpy(), e_win, r_cap, n)
            want_u = ref_live._unpack_results(want, e_win, r_cap, n)
            for g, w in zip(got_u, want_u):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            l0 = min(max(lo + e_cap if lo < 0 else lo, 0), e_cap - e_win)
            np.testing.assert_array_equal(got_u[0], arrays["rounds"][l0 : l0 + e_win])
            np.testing.assert_array_equal(got_u[6], arrays["famous"])
            assert got_u[7:] == (bool(arrays["stale"]), bool(arrays["fame_lag"]),
                                 int(arrays["last_round"]))


def test_live_pack_rides_the_last_decide(monkeypatch):
    """The live engine on the 8-validator fixture (ref_step_states' grid
    and capacities, e_cap 1,024, r_cap 16, e_win 256, with r_win 16: at
    r_win 8 fame_lag latches in a live run, in both packages; batches of
    16): after every call the vector _dispatch hands back equals the JAX
    engine's (its _pack_results of its state at the same lo), on one-batch,
    two-batch and multi_step calls and the attach, whose bootstrap replays
    the DAG's first events (the vector the call's last decide wrote, the
    only decide asked for one), on a call with no new events (K13's own
    launch: no decide since the last pack), and
    after a rebase forced on both engines, which drops a vector left
    from before it (own launch, then the last decide's again); 432 of the
    DAG's 512 events, before its undecided tail outgrows e_win (the stale
    latch demotes both engines at 480). A vector whose row count is not
    the snapshot's is refused."""
    settings = {"e_cap": 1024, "r_cap": 16, "e_win": 256, "r_win": 16, "batch_cap": 16,
                "async_fetch": False}
    patch_both(monkeypatch, settings)
    ref_hg = dag(8, 512, 5, 1.1)
    events = ref_events(ref_hg)
    ref_blocks, port_blocks = [], []
    ref = carry_ref(ref_hg, [], ref_blocks)
    port = carry(ref_hg, [], commit_callback=port_blocks.append)
    seen = {}
    port_dispatch = live._dispatch
    for side, mod in (("port", live), ("ref", ref_live)):
        real = mod._dispatch

        def captured(eng, new_rows, _real=real, _side=side):
            vec, snap = _real(eng, new_rows)
            seen[_side] = (vec, snap["lo"])
            return vec, snap

        monkeypatch.setattr(mod, "_dispatch", captured)
    asks = []
    for name in ("step", "multi_step"):
        real = getattr(live, name)

        def asked(*a, _real=real, **kw):
            asks.append(kw.get("pack") is not None)
            return _real(*a, **kw)

        monkeypatch.setattr(live, name, asked)
    pos = 0

    def call(k, route):
        nonlocal pos
        for ev in events[pos : pos + k]:
            ref.insert_event(RefEvent.from_json(ev.to_json()), True)
            port.insert_event(Event.from_json(ev.to_json()), True)
        pos += k
        eng = getattr(port, "_live_device_engine", None)
        before = dict(eng.packs) if eng is not None else {"fused": 0, "own": 0}
        asks.clear()
        ref_live.run_consensus_live(ref)
        live.run_consensus_live(port, device="cpu")
        eng = port._live_device_engine
        what = f"call at {pos} events"
        assert_engines_equal(port, ref, what)
        (got, got_lo), (want, want_lo) = seen.pop("port"), seen.pop("ref")
        assert got_lo == want_lo == max(len(eng.hashes) - 256, 0), what
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)
        assert {k: eng.packs[k] - before[k] for k in before} == {
            "fused": route == "fused", "own": route == "own"}, what
        if route == "fused":
            assert asks and asks[-1] and sum(asks) == 1, (what, asks)
        assert eng._pack is None, what
        return eng

    call(16, "fused")               # the attach: its bootstrap's replay packs
    call(16, "fused")               # one batch: step
    call(32, "fused")               # two batches: two steps, the last packs
    eng = call(64, "fused")         # four batches: multi_step
    assert asks == [True]
    while pos < 368:
        call(48, "fused")           # three batches: multi_step; lo > 0 from 272
    call(0, "own")                  # nothing new: no decide since the last pack
    # a vector left from before a rebase is dropped with the state
    eng._pack = (torch.full((inc.pack_size(256, 16, 8),), -9, dtype=torch.int32),
                 len(eng.hashes))
    eng.rebase()
    ref._live_device_engine.rebase()
    assert eng._pack is None and eng.rebases == 1
    assert_engines_equal(port, ref, "after the forced rebase")
    call(0, "own")
    call(16, "fused")
    call(48, "fused")
    # a vector whose row count is not the snapshot's is refused
    eng._pack = (torch.zeros(1, dtype=torch.int32), len(eng.hashes) - 1)
    with pytest.raises(RuntimeError, match="packed"):
        port_dispatch(eng, [])


def assert_engines_equal(port_hg, ref_hg, what):
    """The port's live engine and the JAX package's agree on every IncState
    field, the round base, the row hashes, the rebases and the queue."""
    pe = port_hg._live_device_engine
    re = ref_hg._live_device_engine
    assert (pe is None) == (re is None), what
    if pe is None:
        return
    got = inc.state_to_arrays(pe.state)
    for f in ref_inc.IncState._fields:
        w = np.asarray(getattr(re.state, f))
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, f"{what}: {f}"
        np.testing.assert_array_equal(got[f], w, err_msg=f"{what}: {f}")
    assert pe.round_base == re.round_base, what
    assert pe.hashes == re.hashes, what
    assert pe.rebases == re.rebases, what
    assert pe.async_fetch == re.async_fetch, what
    assert len(pe.inflight) == len(re.inflight), what


LIVE_VARIANTS = {
    # the pipelined fetch pinned off except where it is the point: left to
    # the host clock, either engine could switch to it on its own under
    # load (three slow fetches)
    "defaults": {"async_fetch": False},
    "rebase": {"r_cap": 16, "async_fetch": False},
    "pipelined": {"async_fetch": True},
    "multi_step": {"batch_cap": 4, "async_fetch": False},
}


def patch_both(monkeypatch, settings):
    for mod in (ref_live, live):
        for k, v in settings.items():
            monkeypatch.setitem(mod.ENGINE_DEFAULTS, k, v)


def ladder_call(hg, run_live, run_device, unsupported):
    """One consensus call down a node's device ladder: the live rung, or,
    where it raises GridUnsupported, the engine dropped and the one-shot
    rung run instead (the next call re-attaches). Returns the rung."""
    try:
        run_live(hg)
        return "live"
    except unsupported:
        eng = getattr(hg, "_live_device_engine", None)
        if eng is not None:
            eng.detach()
        hg._live_device_engine = None
        run_device(hg)
        return "oneshot"


def drive_live(monkeypatch, settings, first, sync, ref_hg, attach_first=True):
    """Both packages' live engines over the same DAG: the first `first`
    events inserted and decided by the host engine, then (attach_first)
    one call with nothing new, then syncs of `sync` events with one
    ladder call after each, the rungs and the engines compared after
    every call; flushed at the end and the blocks compared with the host
    engine's. Returns the port's engine and the rung of each call."""
    patch_both(monkeypatch, settings)
    events = ref_events(ref_hg)
    ref_blocks, port_blocks = [], []
    ref = carry_ref(ref_hg, events[:first], ref_blocks)
    port = carry(ref_hg, events[:first], commit_callback=port_blocks.append)
    rungs = []

    def call():
        want = ladder_call(ref, ref_live.run_consensus_live, ref_run_consensus_device,
                           RefGridUnsupported)
        got = ladder_call(port, lambda h: live.run_consensus_live(h, device="cpu"),
                          lambda h: run_consensus_device(h, device="cpu"),
                          GridUnsupported)
        rungs.append(got)
        assert got == want, f"call {len(rungs)}: the port took {got}, the JAX package {want}"
        assert_engines_equal(port, ref, f"after call {len(rungs)}")

    if first:
        # the history decided by the host engine, then (attach_first) an
        # attach with no event inserted since: every kept row has its round
        ref.run_consensus()
        port.run_consensus()
        if attach_first:
            call()
    for i in range(first, len(events), sync):
        for ev in events[i : i + sync]:
            ref.insert_event(RefEvent.from_json(ev.to_json()), True)
            port.insert_event(Event.from_json(ev.to_json()), True)
        call()
    ref_live.flush_live_engine(ref)
    live.flush_live_engine(port)
    assert_engines_equal(port, ref, "after the flush")
    host, host_blocks = host_reference(ref_hg)
    assert_same_consensus(ref, ref_blocks, port, port_blocks, "port vs JAX live")
    assert_same_consensus(host, host_blocks, port, port_blocks, "port live vs host")
    assert port_blocks, "the run committed no block"
    return port._live_device_engine, rungs


def carry_ref(ref_hg, events, blocks):
    """A fresh JAX-package hashgraph holding `events` (JSON copies)."""
    h = RefHashgraph(ref_hg.participants,
                     RefInmemStore(ref_hg.participants, ref_hg.store.cache_size()),
                     commit_callback=blocks.append)
    for ev in events:
        h.insert_event(RefEvent.from_json(ev.to_json()), True)
    return h


@pytest.mark.parametrize("variant", list(LIVE_VARIANTS))
def test_run_consensus_live_matches_reference(variant, monkeypatch):
    ref_hg = dag(*LIVE_GRID)
    eng, rungs = drive_live(monkeypatch, LIVE_VARIANTS[variant], 0, SYNC, ref_hg)
    assert rungs == ["live"] * len(rungs)
    if variant == "rebase":
        assert eng.rebases > 0 and eng.round_base > 0
    if variant == "pipelined":
        assert eng.async_fetch and eng.consensus_calls > 0


def test_multi_step_variant_takes_the_multi_step_path(monkeypatch):
    """batch_cap 4 with syncs of 16 stages four batches per call: after
    the attach, advance goes through multi_step, not step."""
    ref_hg = dag(*LIVE_GRID)
    patch_both(monkeypatch, {"batch_cap": 4})
    events = ref_events(ref_hg)
    port = carry(ref_hg, events[:SYNC])
    live.run_consensus_live(port, device="cpu")
    calls = {"step": 0, "multi_step": 0}
    for name in calls:
        real = getattr(live, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(live, name, counted)
    for ev in events[SYNC : 2 * SYNC]:
        port.insert_event(Event.from_json(ev.to_json()), True)
    live.run_consensus_live(port, device="cpu")
    assert calls == {"step": 0, "multi_step": 1}


def test_live_engine_attaches_large_history(monkeypatch):
    """test_device_backend.py's large-history attach without a cluster: a
    hashgraph decided by the host engine past the write-back window
    (e_win 256, batch_cap 16) attaches from the frontier with fewer rows
    than it holds, its rows' rounds base-relative, and then follows the
    JAX engine call for call (both on the live rung throughout) to the
    same blocks as the host engine. An attach with events inserted since
    the last consensus call installs them with unknown rounds, and the
    write-back gate refuses the result in both packages: the ladder's
    one-shot rung takes such a call (checked too)."""
    ref_hg = dag(5, 480, 13)
    events = ref_events(ref_hg)
    first = 360
    settings = {"e_win": 256, "batch_cap": 16, "async_fetch": False}
    eng, rungs = drive_live(monkeypatch, settings, first, SYNC, ref_hg)
    assert rungs == ["live"] * len(rungs) and len(eng.hashes) < len(events)
    # attaches with a sync's events not yet rounded: both packages demote
    _, rungs = drive_live(monkeypatch, settings, first, SYNC, ref_hg, attach_first=False)
    assert rungs == ["oneshot"] * len(rungs)
    patch_both(monkeypatch, settings)
    port = carry(ref_hg, events[:first])
    port.run_consensus()
    eng = live.LiveDeviceEngine(port, device="cpu")
    try:
        assert len(eng.hashes) < first and len(eng.hashes) <= 256
        rounds = eng.state.rounds.numpy()
        for h, row in eng.row_of.items():
            ev = port.store.get_event(h)
            if ev.round is not None and ev.round >= eng.round_base:
                assert rounds[row] == ev.round - eng.round_base
    finally:
        eng.detach()


def test_both_rungs_refuse_a_host_without_cuda(monkeypatch):
    """No card and no device="cpu": both rungs raise before they change
    anything. Where the packed layout resolves (once refused), both rungs
    run it: the one-shot rung equals the JAX package's and the host
    engine, and the live engine resolves it as the JAX package's does."""
    ref_hg = dag(*LIVE_GRID)
    events = ref_events(ref_hg)[:48]
    port = carry(ref_hg, events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_consensus_device(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live.run_consensus_live(port)
    assert getattr(port, "_live_device_engine", None) is None
    assert port.insert_listener is None
    assert all(port.store.get_event(h).round is None for h in port.undetermined_events)
    monkeypatch.setenv("BABBLE_PACKED_VOTING", "1")
    ref_blocks, port_blocks, host_blocks = [], [], []
    ref = carry_ref(ref_hg, events, ref_blocks)
    one = carry(ref_hg, events, commit_callback=port_blocks.append)
    host = carry(ref_hg, events, commit_callback=host_blocks.append)
    ref_run_consensus_device(ref)
    run_consensus_device(one, device="cpu")
    host.run_consensus()
    assert any("/packed/" in k for k in one.obs.devledger.snapshot())
    assert_same_consensus(ref, ref_blocks, one, port_blocks, "packed one-shot vs JAX")
    assert_same_consensus(host, host_blocks, one, port_blocks, "packed one-shot vs host")
    live.run_consensus_live(port, device="cpu")
    assert port._live_device_engine.packed
    monkeypatch.delenv("BABBLE_PACKED_VOTING")
    fresh = carry(ref_hg, events)
    live.run_consensus_live(fresh, device="cpu")
    assert fresh._live_device_engine.device.type == "cpu"
    assert not fresh._live_device_engine.packed
