"""The port's own host layer (babble_tpu_torch.hashgraph and the common,
crypto, peers, utils and obs copies under it) against the JAX package's:
each DAG is built in the JAX package (the tests/dsl.py fixtures, a
synthetic gossip grid, fuzz cases of test_tpu_differential.py), carried
across as peer and event JSON with hashgraph_from_events, and both
packages' host engines (run_consensus) must give the same blocks, byte
for byte, and the same round, lamport, round received, witness and fame
per event. Also resets from block 0 and 1 with the Block and Frame carried
as JSON, and signatures checked across the packages. Exact equality, no
tolerance."""

import pytest

from babble_tpu import crypto as ref_crypto
from babble_tpu.hashgraph import Event as RefEvent
from babble_tpu.hashgraph import Frame as RefFrame
from babble_tpu.hashgraph import Hashgraph as RefHashgraph
from babble_tpu.hashgraph import InmemStore as RefInmemStore
from babble_tpu.tpu import synthetic_grid
from babble_tpu_torch import crypto as port_crypto
from babble_tpu_torch.hashgraph import Block, Event, Frame, Hashgraph, InmemStore
from babble_tpu_torch.hashgraph import WireEvent, hashgraph_from_events

from dsl import (
    CACHE_SIZE,
    init_consensus_hashgraph,
    init_funky_hashgraph,
    init_round_hashgraph,
    init_simple_hashgraph,
    init_sparse_hashgraph,
)
from test_reset_frame import _wire_diff
from test_tpu_differential import FUZZ_CASES, build_hashgraph_from_grid, clone_hashgraph


def ref_events(hg):
    """The reference hashgraph's events in topological order."""
    events = []
    for p in hg.participants.to_peer_slice():
        for h in hg.store.participant_events(p.pub_key_hex, -1):
            events.append(hg.store.get_event(h))
    events.sort(key=lambda ev: ev.topological_index)
    return events


def carry(hg, events=None, commit_callback=None, cache_size=None):
    """A port Hashgraph holding the reference hashgraph's peers and
    `events` (all of them by default), carried across as JSON."""
    events = ref_events(hg) if events is None else events
    return hashgraph_from_events(
        [p.to_json() for p in hg.participants.to_peer_slice()],
        [ev.to_json() for ev in events],
        cache_size=cache_size or hg.store.cache_size(),
        commit_callback=commit_callback,
    )


def event_fields(hg):
    """hash -> (round, lamport, round received) over the store's events
    (above each participant's root: a reset store holds nothing below)."""
    out = {}
    for p in hg.participants.to_peer_slice():
        skip = hg.store.get_root(p.pub_key_hex).self_parent.index
        for h in hg.store.participant_events(p.pub_key_hex, skip):
            ev = hg.store.get_event(h)
            out[h] = (ev.round, ev.lamport_timestamp, ev.round_received)
    return out


def round_fields(hg):
    """round -> sorted (witness hash, fame) over the rounds the store holds
    (a reset store has none below its anchor)."""
    out = {}
    for r in range(hg.store.last_round() + 1):
        try:
            ri = hg.store.get_round(r)
        except Exception as err:  # either package's StoreErr
            if type(err).__name__ != "StoreErr":
                raise
            continue
        out[r] = sorted((w, int(ri.events[w].famous)) for w in ri.witnesses())
    return out


def assert_same_consensus(ref_hg, ref_blocks, port_hg, port_blocks, what):
    """Blocks byte for byte, consensus order, per-event and per-round
    fields: port against reference (or any two hashgraphs)."""
    assert len(port_blocks) == len(ref_blocks), what
    for k, (a, b) in enumerate(zip(ref_blocks, port_blocks)):
        assert b.marshal() == a.marshal(), f"{what}: block {k}"
    assert port_hg.store.consensus_events() == ref_hg.store.consensus_events(), what
    assert event_fields(port_hg) == event_fields(ref_hg), what
    assert port_hg.store.last_round() == ref_hg.store.last_round(), what
    assert round_fields(port_hg) == round_fields(ref_hg), what
    assert port_hg.undetermined_events == ref_hg.undetermined_events, what


def fixture_hashgraph(case):
    kind, *params = case
    if kind == "dsl":
        builder = {
            "simple": init_simple_hashgraph,
            "round": init_round_hashgraph,
            "consensus": init_consensus_hashgraph,
            "funky": lambda: init_funky_hashgraph(full=True),
            "sparse": init_sparse_hashgraph,
        }[params[0]]
        return builder()[0]
    n, e, seed = params
    return build_hashgraph_from_grid(synthetic_grid(n, e, seed=seed))[0]


CASES = (
    [("dsl", name) for name in ("simple", "round", "consensus", "funky", "sparse")]
    + [("synthetic", 5, 120, 13)]
    + [("fuzz",) + fc for fc in FUZZ_CASES]
)
CASE_IDS = ["-".join(str(p) for p in c) for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_run_consensus_matches_reference(case):
    hg = fixture_hashgraph(case)
    ref = clone_hashgraph(hg)
    ref_blocks = []
    ref.commit_callback = ref_blocks.append
    ref.run_consensus()
    port_blocks = []
    port = carry(hg, commit_callback=port_blocks.append)
    port.run_consensus()
    assert_same_consensus(ref, ref_blocks, port, port_blocks, str(case))


def decided_pair(name):
    """The fixture decided in the reference and, carried across, in the
    port (host engine, the pass-by-pass order test_reset_frame.py uses)."""
    builder = {
        "funky": lambda: init_funky_hashgraph(full=True),
        "sparse": init_sparse_hashgraph,
    }[name]
    h = builder()[0]
    port = carry(h)
    for g in (h, port):
        g.divide_rounds()
        g.decide_fame()
        g.decide_round_received()
        g.process_decided_rounds()
    return h, port


def reset_pair(name, block_index, copies=1):
    """A fresh hashgraph reset from block `block_index`'s (block, frame)
    checkpoint in both packages (the port's Block and Frame carried as
    JSON), the wire diff above it inserted, no consensus run yet: (h2,
    its block list, then a port copy and its block list, `copies` times
    over)."""
    h, port = decided_pair(name)
    block = h.store.get_block(block_index)
    frame = RefFrame.from_json(h.get_frame(block.round_received()).to_json())
    assert port.store.get_block(block_index).marshal() == block.marshal()

    ref_blocks = []
    h2 = RefHashgraph(h.participants, RefInmemStore(h.participants, CACHE_SIZE),
                      commit_callback=ref_blocks.append)
    h2.reset(block, frame)
    wire = _wire_diff(h, h2)
    for wev in wire:
        h2.insert_event(h2.read_wire_info(wev), False)
    out = [h2, ref_blocks]
    for _ in range(copies):
        port_blocks = []
        p2 = Hashgraph(port.participants, InmemStore(port.participants, CACHE_SIZE),
                       commit_callback=port_blocks.append)
        p2.reset(Block.from_json(block.to_json()), Frame.from_json(frame.to_json()))
        for wev in wire:
            p2.insert_event(p2.read_wire_info(WireEvent.from_json(wev.to_json())), False)
        out += [p2, port_blocks]
    return tuple(out)


RESET_CASES = [("funky", 0), ("funky", 1), ("sparse", 0), ("sparse", 1)]


@pytest.mark.parametrize("name,block_index", RESET_CASES)
def test_reset_matches_reference(name, block_index):
    """Reset from a (block, frame) checkpoint in both packages, insert the
    wire diff above it, run consensus: the same blocks byte for byte."""
    h2, ref_blocks, p2, port_blocks = reset_pair(name, block_index)
    h2.run_consensus()
    p2.run_consensus()
    assert ref_blocks, f"{name} from block {block_index}: no block above the anchor"
    assert len(port_blocks) == len(ref_blocks)
    for k, (a, b) in enumerate(zip(ref_blocks, port_blocks)):
        assert b.marshal() == a.marshal(), f"block {k} above the anchor"
    assert p2.store.consensus_events() == h2.store.consensus_events()
    assert p2.undetermined_events == h2.undetermined_events


def test_signatures_verify_across_packages():
    """An event signed by either package verifies in the other, with the
    same signature bytes for the same key and body (deterministic
    nonces in both backends)."""
    assert port_crypto.HAVE_REAL_CRYPTO == ref_crypto.HAVE_REAL_CRYPTO
    ref_key = ref_crypto.derive_key(12345)
    port_key = port_crypto.derive_key(12345)
    pub = ref_crypto.pub_key_bytes(ref_key)
    assert port_crypto.pub_key_bytes(port_key) == pub

    def body(cls):
        return cls(transactions=[b"tx"], parents=["", ""], creator=pub, index=0)

    signed_ref, signed_port = body(RefEvent), body(Event)
    signed_ref.sign(ref_key)
    signed_port.sign(port_key)
    assert signed_port.signature == signed_ref.signature
    assert Event.from_json(signed_ref.to_json()).verify()
    assert RefEvent.from_json(signed_port.to_json()).verify()
    tampered = signed_port.to_json()
    tampered["Body"]["Index"] = 1
    assert not RefEvent.from_json(tampered).verify()
    assert not Event.from_json(tampered).verify()
