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

from babble_tpu_torch.tpu import _ext
from chip_smoke import CLOSURE_TRAP_CAPS, walk_chunk_traps
from test_doubling import assert_matches
from test_torch_levelscan import CASE_IDS, CASES, SCAN_FIXTURES, TRAPS, fixture_grid


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


# a section whose closure takes more passes than the caps, and a base grid
CAP_CASES = [("section", 1.0 / 3.0, True), ("synthetic", 16, 1024, 4, 1.1, 0.0)]


@pytest.mark.parametrize("cap", CLOSURE_TRAP_CAPS)
@pytest.mark.parametrize("case", CAP_CASES, ids=["section-0.333-True", "synthetic-16-1024"])
def test_closure_la_pass_caps_below_the_fixed_point(case, cap):
    """The pass caps the card's closure is held to on the bench grid
    (chip_smoke.CLOSURE_TRAP_CAPS): both packages stop after `cap` passes,
    before the fixed point, with the same intermediate iterate."""
    grid = fixture_grid(case)
    st = port.stage_doubling(grid_from_arrays(vars(grid)), torch.device("cpu"))
    args = (st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d)
    _, full = port._closure_la(*args, st.l_b, st.block, st.pass_cap)
    assert full > cap
    want_la, want_passes = ref._closure_la(
        *[a.numpy() for a in args], l=st.l_b, block=st.block, pass_cap=cap,
    )
    got_la, got_passes = port._closure_la(*args, st.l_b, st.block, cap)
    assert got_passes == int(want_passes) == cap
    np.testing.assert_array_equal(got_la.numpy(), np.asarray(want_la))


def largest_chunk(case):
    """The _walk_chunk arguments of the largest chunk of a case's walk."""
    grid, pg, st = staged(case)
    inv = port.build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = port.walk_seeds(pg, st)
    chunks = []

    def walk(*a):
        chunks.append(a)
        return port._walk_chunk(*a)

    port._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)), inv, st.rows_by_d, st.fd_d,
        st.la_d, x0, s_np, first_nw, pg.super_majority, st.l_b, st.seeded, {}, walk=walk,
    )
    return max(chunks, key=lambda a: a[10])


# a seeded walk and an unseeded one whose largest chunk every trap changes
TRAP_WALK_CASES = [("section", 1.0 / 3.0, True), ("synthetic", 16, 1024, 4, 1.1, 0.0)]


@pytest.mark.parametrize("trap", ["steps 1", "steps 4", "steps 5", "non-monotone la",
                                  "skip, unsaturated", "skip, seeded", "skip, seeded, steps 1"])
@pytest.mark.parametrize("case", TRAP_WALK_CASES, ids=["section-0.333-True", "synthetic-16-1024"])
def test_walk_chunk_traps_match_reference(case, trap):
    """The traps the card's walk is held to (chip_smoke.walk_chunk_traps):
    searches cut to 1, 4 and 5 probes, which end before they converge, la
    rows reversed along the longest chain from its frontier row, so the
    predicate is not monotone along it, and the skip's (fewer than
    super_majority countable rows while X is not saturated; seeded, a seed
    row holding or moving X in the skipped step, first_nw making the next
    step search; that with one probe a search); the port's plain chunk
    against the reference's _walk_chunk on the same inputs."""
    a = walk_chunk_traps(largest_chunk(case))[trap]
    got = port._walk_chunk(*a)
    statics = dict(zip(("super_majority", "l", "length", "steps", "use_seeds"), a[8:]))
    want = ref._walk_chunk(*[np_(x) for x in a[:8]], **statics)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", TRAP_WALK_CASES, ids=["section-0.333-True", "synthetic-16-1024"])
def test_walk_chunk_traps_change_the_walk(case):
    """Each trap changes the largest chunk's frontier history on these
    cases, so that holding a walk to the plain version on them tests the
    search's exact iteration and not only its converged answer."""
    big = largest_chunk(case)
    base = port._walk_chunk(*big)[1]
    for name, a in walk_chunk_traps(big).items():
        assert not torch.equal(port._walk_chunk(*a)[1], base), name


@pytest.mark.parametrize("n", [1, 4, 5, 8, 9, 16, 17, 24, 32])
def test_walk_chunk_tree_plan(n):
    """The one-block walk's rule: the tree depth by width from
    WC_TREE_DEPTHS (one at every width up to WC_BLOCK_MAX, not increasing
    with it), and block_smem's entry, which is the kernel's shared memory
    at that depth and fits one block; past WC_BLOCK_MAX the grid forms
    (walk_chunk_plan), whose depth also comes from WC_TREE_DEPTHS, up to
    WC_MAX_WIDTH."""
    depth = _ext.walk_chunk_depth(n)
    assert 1 <= depth <= _ext.WC_TREE_DEPTH_MAX
    assert all(_ext.walk_chunk_depth(m) >= depth for m in range(1, n + 1))
    smem = _ext.block_smem("walk_chunk", n)["walk"]
    assert smem == _ext.walk_chunk_tree_smem(n, depth) <= _ext.MAX_SMEM_BYTES
    assert _ext.walk_chunk_plan(n)["form"] == "tree"
    # each chain's probed rows (2^d - 1 rows of the power of two at or
    # above n, at least 4) and its closure terms by leaf (2^d x n words)
    np_ = max(4, 1 << (n - 1).bit_length())
    nodes = (1 << depth) - 1
    assert smem == n * (nodes * np_ + ((nodes + 1) * n + 3) // 4 * 4) * 4
    assert _ext.walk_chunk_plan(_ext.WC_BLOCK_MAX + 1)["form"] != "tree"
    assert 1 <= _ext.walk_chunk_depth(_ext.WC_MAX_WIDTH) <= _ext.WC_TREE_DEPTH_MAX
    with pytest.raises(ValueError):
        _ext.walk_chunk_depth(_ext.WC_MAX_WIDTH + 1)


@pytest.mark.parametrize("n", [8, 64, 512, 640, 1100])
def test_walk_chunk_hands_its_plan_to_the_launcher(monkeypatch, n):
    """_ext.walk_chunk launches one walk_chunk whose last seven ints are
    walk_chunk_plan's form code (WC_FORMS), k, cw, chains, slots, threads
    and shared memory, as the launcher takes them, with a scratch of the
    plan's size (the grid forms' step counters last; the L2 form's table of
    N slots, lo and hi of two rounds, the verdict sums of three rounds)
    (the launch is stubbed: CPU tensors here)."""
    plan = hands_plan_to_launcher(monkeypatch, n, None)
    assert plan["form"] == {8: "tree", 64: "cluster", 512: "l2", 640: "l2", 1100: "l2"}[n]


@pytest.mark.parametrize("n,form", [(256, "l2"), (512, "cluster"), (1100, "l2")])
def test_walk_chunk_hands_a_named_form_to_the_launcher(monkeypatch, n, form):
    """The same with the form named (`form=`): the plan's fields and scratch
    of that form."""
    assert hands_plan_to_launcher(monkeypatch, n, form)["form"] == form


def hands_plan_to_launcher(monkeypatch, n, form):
    """_ext.walk_chunk at n validators (form named or not) with its launch
    stubbed, its arguments checked against walk_chunk_plan; the plan."""
    l, e, length = 4, 16, 3
    plan = _ext.walk_chunk_plan(n, l, form=form)
    seen = []
    monkeypatch.setattr(_ext, "_launch", lambda name, dev, args, **kw: seen.append((name, args)))
    i32 = torch.int32
    z = lambda *s: torch.zeros(s, dtype=i32)  # noqa: E731
    _ext.walk_chunk(z(n, n, l), z(n, l), z(e, n), z(e, n), z(n), z(length, n), z(length), z(n),
                    2 * n // 3 + 1, l, length, 3, True, form=form)
    assert [name for name, _ in seen] == ["walk_chunk"]
    args = seen[0][1]
    kinds = _ext.KERNELS["walk_chunk"][2]
    assert len(args) == len(kinds)
    assert args[-8] == plan["depth"]
    assert args[-7:] == (_ext.WC_FORMS.index(plan["form"]), plan["k"], plan["cw"],
                         plan["chains"], plan["slots"], plan["threads"], plan["smem"])
    ld4 = (n + 3) // 4 * 4
    words = {"tree": 2 * n * l * _ext._walk_np(n) + n,
             "cluster": n * plan["k"] * plan["cw"] + plan["k"] * plan["cw"] + 3 * n + 4,
             "l2": n * ld4 + 2 * 2 * n + 3 * n * ((1 << plan["depth"]) - 1) + 3 * n + 4,
             }[plan["form"]]
    assert args[10].numel() == words
    assert all(0 <= a < 2 ** 31 for a in args[-7:])
    return plan


@pytest.mark.parametrize("n,l", [(4, 64), (5, 64), (8, 8192), (12, 128), (33, 64), (64, 1024),
                                 (256, 512), (1024, 64)])
def test_closure_la_plan(n, l):
    """K6's launch shape: rows of n rounded up to 4 words; the prefix's
    lanes fill a block and its segments (at most CL_K_MAX slots a thread)
    cover the chain; the squaring's tile is CL_ROWS rows a row group; the
    shared memory is block_smem's and fits one block up to 1,024
    validators."""
    plan = _ext.closure_la_plan(n, l)
    assert plan["ld"] % 4 == 0 and n <= plan["ld"] < n + 4
    sl = _ext.CL_THREADS // plan["ql"]
    assert plan["ql"] * sl == _ext.CL_THREADS
    assert 1 <= plan["k"] <= _ext.CL_K_MAX
    assert (plan["groups"] - 1) * sl * plan["k"] < l <= plan["groups"] * sl * plan["k"]
    assert _ext.CL_THREADS % plan["ql4"] == 0 and plan["ql4"] * 4 >= min(plan["ld"], 256)
    assert plan["tile"] == _ext.CL_THREADS // plan["ql4"] * _ext.CL_ROWS
    assert plan["smem"] == _ext.block_smem("closure_la", n)["pass"] <= _ext.MAX_SMEM_BYTES
    assert [plan[k] for k in _ext.CLOSURE_PLAN_KEYS][-1] == plan["smem"]
    _ext.check_smem("closure_la", n)


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


@pytest.mark.parametrize("name", sorted(TRAPS))
def test_lamport_scan_traps(name):
    """K8 on the level scan's trap tables (chip_smoke.level_traps: its
    levels, parents, external lamports and pins), the carry from 0: a
    parent in the same or a later level reads 0, a parent index at or
    past E clamps to E - 1, max + 1 wraps at 2^31 - 1, a pin wins,
    padding lanes and levels of padding write nothing."""
    arrays = TRAPS[name][0]
    args = [arrays[i] for i in (0, 3, 4, 10, 11, 12)]
    want = np.asarray(ref._lamport_levels_scan(*args))
    got = port._lamport_levels_scan(*[torch.from_numpy(a) for a in args])
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "same_level_parent":
        assert got.tolist() == [11, 1, 12, 2]
    elif name == "lamport_wraps":
        assert got.tolist() == [-(2 ** 31), 6, 2 ** 31 - 1, -(2 ** 31)]


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

    ref_g = fixture_grid(("synthetic", 4, 64, 1, 0.0, 0.0))
    g = grid_from_arrays(vars(ref_g))
    # the packed layout, once refused, equals the reference's and the wide run
    got = port.run_doubling_passes(g, device="cpu", packed=True)
    assert_matches(got, ref.run_doubling_passes(ref_g, packed=True), "packed")
    assert_matches(got, port.run_doubling_passes(g, device="cpu", packed=False), "wide")
    with pytest.raises(GridUnsupported):
        port.run_doubling_passes(dataclasses.replace(g, e=0), device="cpu")
    assert not port.use_doubling(dataclasses.replace(g, e=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_doubling_passes(g)


def cluster_walk_chunk(args, k, chains, depth):
    """A numpy emulation of csrc/walk_chunk.cu walk_chunk_cluster's
    schedule on one chunk's _walk_chunk arguments: each step's frontier
    table (n coordinates x k * cw witness columns, MAX and not countable
    past n) split by columns over a cluster of k blocks; the chains in
    groups of `chains`, each group's searches run together as speculative
    trees of `depth` (2^d - 1 probes a chain a round, the last round
    shorter), each block counting every probe against its cw columns and
    summing its strongly-seen witnesses, the cluster adding the k partial
    sums per probe, then the round's d decisions (no search in a step with
    fewer than super_majority countable rows); then the advance."""
    inv, rows_by, fd, la, x0, seeds, r_abs, first_nw = (np_(a) for a in args[:8])
    sm, l, length, steps, use_seeds = args[8:]
    n = rows_by.shape[0]
    ld4 = (n + 3) // 4 * 4
    cw = ((ld4 + k - 1) // k + 3) // 4 * 4
    big = np.iinfo(np.int32).max
    clen = (rows_by >= 0).sum(axis=1)
    x = x0.astype(np.int64).copy()
    xs = []
    for step in range(length):
        tab = np.full((n, k * cw), big, dtype=np.int64)
        wok = np.zeros(k * cw, dtype=bool)
        for w in range(n):
            ok = x[w] < l and not (use_seeds and x[w] == 0 and r_abs[step] == first_nw[w])
            if ok:
                tab[:, w] = fd[np.clip(rows_by[w, min(max(x[w], 0), l - 1)], 0, fd.shape[0] - 1)]
            wok[w] = ok
        m0 = np.full(n, l, dtype=np.int64)
        # the skip: too few countable rows, no search (every m0 is l)
        for c0 in range(0, n, chains) if wok.sum() >= sm else ():
            grp = np.arange(c0, min(c0 + chains, n))
            gi = np.arange(grp.size)
            lo = np.clip(x[grp], 0, l)
            hi = np.full(grp.size, l)
            done = 0
            while done < steps:
                d = min(depth, steps - done)
                nodes = (1 << d) - 1
                # node j's interval of every chain's tree, then its probe
                ev = np.empty((grp.size, nodes), dtype=np.int64)
                for node in range(nodes):
                    j, a, b = node + 1, lo.copy(), hi.copy()
                    for bit in range(j.bit_length() - 2, -1, -1):
                        mid = np.minimum((a + b) // 2, l - 1)
                        a, b = (mid + 1, b) if (j >> bit) & 1 else (a, np.minimum(mid, b))
                    probe = np.minimum(np.minimum((a + b) // 2, l - 1),
                                       np.maximum(clen[grp] - 1, 0))
                    ev[:, node] = np.clip(rows_by[grp, probe], 0, la.shape[0] - 1)
                rows = la[ev.reshape(-1)]
                tot = np.zeros(ev.size, dtype=np.int64)
                for r in range(k):  # block r's columns, its partial sums
                    cols = slice(r * cw, (r + 1) * cw)
                    cnt = (rows[:, :, None] >= tab[None, :, cols]).sum(axis=1)
                    tot += ((cnt >= sm) & wok[None, cols]).sum(axis=1)
                tot = tot.reshape(grp.size, nodes)
                j = np.ones(grp.size, dtype=np.int64)
                for _ in range(d):
                    mid = np.minimum((lo + hi) // 2, l - 1)
                    pred = (clen[grp] > 0) & (tot[gi, j - 1] >= sm)
                    hi, lo = np.where(pred, np.minimum(mid, hi), hi), np.where(pred, lo, mid + 1)
                    j = np.where(pred, 2 * j, 2 * j + 1)
                done += d
            m0[grp] = np.where(hi < clen[grp], hi, l)
        cc = np.arange(n)
        reach = inv[cc[:, None], cc[None, :], np.clip(m0, 0, l - 1)[None, :]]
        xn = np.minimum(m0, np.where((m0 < l)[None, :], reach, l).min(axis=1))
        if use_seeds:
            xn = np.minimum(xn, seeds[step])
        xn = np.minimum(np.maximum(xn, x), l)
        x = xn
        xs.append(x.copy())
    return x.astype(np.int32), np.stack(xs).astype(np.int32)


# the 64-validator walk case and the two sections: (k, chains a block, tree
# depth) of the emulated cluster, each block count k in turn
CLUSTER_CASES = [("synthetic",) + SCAN_FIXTURES[-1], ("section", 1.0 / 3.0, True),
                 ("section", 0.5, False)]
CLUSTER_SCHEDULES = [(1, 1, 3), (2, 3, 2), (4, 5, 1)]


@pytest.mark.parametrize("schedule", CLUSTER_SCHEDULES, ids=["k1", "k2", "k4"])
@pytest.mark.parametrize("case", CLUSTER_CASES, ids=["synthetic-64", "section-0.333-True",
                                                     "section-0.5-False"])
def test_cluster_schedule_matches_reference_on_every_chunk(case, schedule):
    """K7's cluster form as the card runs it (walk_chunk_cluster: the
    table split by witness columns over k blocks, the per-block partial
    counts summed per probe, chains searched a group at a time as trees)
    emulated in numpy on every chunk of the walk, equal to the JAX
    package's _walk_chunk and to the port's plain version, and on the
    largest chunk's traps (searches cut short, a non-monotone la)."""
    k, chains, depth = schedule
    grid, pg, st = staged(case)
    inv = port.build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = port.walk_seeds(pg, st)
    seen = []

    def check(a):
        got = port._walk_chunk(*a)
        statics = dict(zip(("super_majority", "l", "length", "steps", "use_seeds"), a[8:]))
        want = ref._walk_chunk(*[np_(v) for v in a[:8]], **statics)
        emulated = cluster_walk_chunk(a, k, chains, depth)
        for g, w, e in zip(got, want, emulated):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(e, np.asarray(w))
        return got

    def walk(*a):
        seen.append(a)
        return check(a)

    port._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)), inv, st.rows_by_d, st.fd_d,
        st.la_d, x0, s_np, first_nw, pg.super_majority, st.l_b, st.seeded, {}, walk=walk,
    )
    assert seen
    for a in walk_chunk_traps(max(seen, key=lambda a: a[10])).values():
        check(a)


@pytest.mark.parametrize("l", [1, 512, 4096])
def test_walk_chunk_plan_by_width(l):
    """K7's plan past the one-block walk, at every width from 33 to
    WC_MAX_WIDTH (65,536; the old L2 form's 29,056 is inside) validators
    and chain length l: every block fits one block's shared memory; below
    WC_L2_FROM a cluster of k <= WC_CLUSTER_MAX blocks (a power of two)
    splits the padded witness columns into slices of cw (a multiple of 4)
    that cover every column, and the least such k is taken; its groups of
    `chains` chains cover every chain, with a probe row for every node of
    every chain's tree; from WC_L2_FROM, or past a cluster's reach, the L2
    form, tiles of WC_TILE probe rows x WC_TILE table slots of ld4 words,
    whose shared memory is the count tile's at every width; a named form
    is taken where it fits; the plan is block_smem's, and one more
    validator is refused."""
    last_form = None
    for n in range(_ext.WC_BLOCK_MAX + 1, _ext.WC_MAX_WIDTH + 1):
        plan = _ext.walk_chunk_plan(n, l)
        assert plan["smem"] <= _ext.MAX_SMEM_BYTES
        ld4 = (n + 3) // 4 * 4
        if plan["form"] == "cluster":
            assert last_form in (None, "cluster") and n < _ext.WC_L2_FROM
            k, cw = plan["k"], plan["cw"]
            assert k in (1, 2, 4, 8) and cw % 4 == 0 and k * cw >= ld4 > (k - 1) * cw
            assert plan["threads"] == (_ext.WC_GRID_THREADS if k <= 2
                                       else _ext.WC_GRID_THREADS_WIDE)
            assert 1 <= plan["chains"] <= max(1, -(-n * k // _ext._wc_resident_blocks(k)))
            assert -(-n // plan["chains"]) * plan["chains"] >= n
            assert plan["slots"] >= plan["chains"] * plan["nodes"]
            assert plan["slots"] % _ext.WC_SLOT_CHUNK == 0
            for smaller in (1, 2, 4):
                if smaller < k:  # one chain a block does not fit a smaller cluster
                    cw_s = ((ld4 + smaller - 1) // smaller + 3) // 4 * 4
                    slots_1 = -(-plan["nodes"] // _ext.WC_SLOT_CHUNK) * _ext.WC_SLOT_CHUNK
                    assert (_ext._wc_cluster_smem(n, l, cw_s, 1, slots_1)
                            > _ext.MAX_SMEM_BYTES)
        else:
            assert plan["form"] == "l2" and plan["cw"] == ld4 and plan["k"] == 1
            assert plan["threads"] % 32 == 0 and plan["threads"] <= 512
            assert plan["chains"] == plan["slots"] == _ext.WC_TILE
            assert plan["threads"] == _ext.WC_TILE_THREADS
            assert plan["smem"] == _ext.WC_TILE_SMEM
            assert plan["nodes"] == (1 << plan["depth"]) - 1
            assert n >= _ext.WC_L2_FROM or _ext._wc_cluster_plan(n, l, plan["depth"]) is None
        last_form = plan["form"]
        if n % 97 == 0 or n < 700:
            assert plan["smem"] == _ext.block_smem("walk_chunk", n, l=l)["walk"]
    assert last_form == "l2"
    # where one block holds the table the cluster is one block
    assert _ext.walk_chunk_plan(64, l)["k"] == 1
    # the crossover: the L2 form from WC_L2_FROM, a cluster below it where
    # one holds the table; either form where named and it takes the width
    assert _ext.walk_chunk_plan(_ext.WC_L2_FROM, l)["form"] == "l2"
    below = _ext.walk_chunk_plan(_ext.WC_L2_FROM - 1, l)
    assert below["form"] == ("cluster" if _ext._wc_cluster_plan(
        _ext.WC_L2_FROM - 1, l, _ext.walk_chunk_depth(_ext.WC_L2_FROM - 1)) else "l2")
    assert _ext.walk_chunk_plan(256, l, form="l2")["form"] == "l2"
    assert _ext.walk_chunk_plan(_ext.WC_L2_FROM, l, form="l2")["depth"] == \
        _ext.walk_chunk_depth(_ext.WC_L2_FROM, "l2")
    with pytest.raises(ValueError, match="cluster"):
        _ext.walk_chunk_plan(4096, l, form="cluster")
    with pytest.raises(ValueError, match="tree"):
        _ext.walk_chunk_plan(64, l, form="tree")
    with pytest.raises(ValueError, match="validators"):
        _ext.walk_chunk_plan(_ext.WC_MAX_WIDTH + 1, l)
    with pytest.raises(ValueError, match="validators"):
        _ext.check_smem("walk_chunk", _ext.WC_MAX_WIDTH + 1, l=l)


def tiled_walk_chunk(args, bm, bn, depth, order_seed=0):
    """A numpy emulation of csrc/walk_chunk.cu walk_chunk_tiles' schedule
    on one chunk's _walk_chunk arguments: each step's table holds the
    countable frontier rows compacted into slots, in an order the slots'
    atomics may give them (a permutation drawn from order_seed); a step
    with fewer than super_majority slots searches nothing (every m0 is l),
    and the emulation checks that the full search would have found every
    m0 at l there; a searched step runs its rounds as trees of `depth`
    (2^d - 1 probe rows a chain, the last round shorter), each round's
    probe rows (chain, node) counted against the slots in tiles of bm rows
    x bn slots, each tile's strongly-seen slots per row added into the
    row's sum, then every chain's d decisions from the sums; a settled
    chain (lo >= hi, hi <= l - 1) probes nothing (its sums stay 0, which
    moves only its lo) and a tile of settled chains is not counted; then
    the advance (closure, seed row, clamp). Returns (x_last, xs, the
    skipped steps, the live chains of every round of every searched
    step)."""
    inv, rows_by, fd, la, x0, seeds, r_abs, first_nw = (np_(a) for a in args[:8])
    sm, l, length, steps, use_seeds = args[8:]
    n = rows_by.shape[0]
    clen = (rows_by >= 0).sum(axis=1)
    rng = np.random.default_rng(order_seed)
    cc = np.arange(n)
    lo_int = np.iinfo(np.int32).min

    def search(tab, n_ok, x, live_rounds):
        lo, hi = np.clip(x, 0, l), np.full(n, l, dtype=np.int64)
        done = 0
        while done < steps:
            d = min(depth, steps - done)
            nodes = (1 << d) - 1
            live = (clen > 0) & ~((lo >= hi) & (hi <= l - 1))
            live_rounds.append(int(live.sum()))
            # every probe row (chain, node): node j's interval, then its probe
            probe = np.empty((n, nodes), dtype=np.int64)
            for node in range(nodes):
                j, a, b = node + 1, lo.copy(), hi.copy()
                for bit in range(j.bit_length() - 2, -1, -1):
                    mid = np.minimum((a + b) // 2, l - 1)
                    a, b = ((mid + 1, b) if (j >> bit) & 1 else (a, np.minimum(mid, b)))
                probe[:, node] = np.minimum(np.minimum((a + b) // 2, l - 1),
                                            np.maximum(clen - 1, 0))
            ev = np.clip(rows_by[cc[:, None], probe], 0, la.shape[0] - 1).reshape(-1)
            rows = np.where(live.repeat(nodes)[:, None], la[ev], lo_int)
            sums = np.zeros(n * nodes, dtype=np.int64)
            for r0 in range(0, n * nodes, bm):  # a tile's partial sums, added per row
                if not live.repeat(nodes)[r0:r0 + bm].any():
                    continue
                for w0 in range(0, max(n_ok, 1), bn):
                    cnt = (rows[r0:r0 + bm, None, :] >= tab[None, w0:w0 + bn, :]).sum(axis=2)
                    sums[r0:r0 + bm] += (cnt >= sm).sum(axis=1)
            sums = sums.reshape(n, nodes)
            j = np.ones(n, dtype=np.int64)
            for _ in range(d):
                mid = np.minimum((lo + hi) // 2, l - 1)
                pred = (clen > 0) & (sums[cc, j - 1] >= sm)
                hi, lo = np.where(pred, np.minimum(mid, hi), hi), np.where(pred, lo, mid + 1)
                j = np.where(pred, 2 * j, 2 * j + 1)
            done += d
        return np.where(hi < clen, hi, l)

    x = x0.astype(np.int64).copy()
    xs, skipped, live = [], 0, []
    for step in range(length):
        ok = (x < l) & ~(bool(use_seeds) & (x == 0) & (r_abs[step] == first_nw))
        slots = rng.permutation(np.flatnonzero(ok))
        tab = fd[np.clip(rows_by[slots, np.clip(x[slots], 0, l - 1)], 0, fd.shape[0] - 1)]
        if slots.size < sm or steps < 1:
            skipped += 1
            m0 = np.full(n, l, dtype=np.int64)
            assert (search(tab, slots.size, x, []) == l).all()
        else:
            live.append([])
            m0 = search(tab, slots.size, x, live[-1])
        reach = inv[cc[:, None], cc[None, :], np.clip(m0, 0, l - 1)[None, :]]
        reach = np.where((m0 < l)[None, :], reach, l)
        xn = np.minimum(m0, reach.min(axis=1))
        if use_seeds:
            xn = np.minimum(xn, seeds[step])
        x = np.minimum(np.maximum(xn, x), l)
        xs.append(x.copy())
    return x.astype(np.int32), np.stack(xs).astype(np.int32), skipped, live


# (probe rows, slots) of a tile and the tree depth of the emulated L2 form:
# tiles that divide none of the widths (64 on the synthetic case, 6 on the
# sections, not a multiple of 4), one and two rounds a decision
TILE_SCHEDULES = [(24, 20, 1), (5, 3, 2)]


@pytest.mark.parametrize("schedule", TILE_SCHEDULES, ids=["24x20-d1", "5x3-d2"])
@pytest.mark.parametrize("case", CLUSTER_CASES, ids=["synthetic-64", "section-0.333-True",
                                                     "section-0.5-False"])
def test_tiled_schedule_matches_reference_on_every_chunk(case, schedule):
    """K7's L2 form as the card runs it (walk_chunk_tiles: the countable
    frontier rows compacted into a table in any order, every chain's
    probes of a round counted against it tile by tile, each tile's partial
    sums added per probe, the skip of a step with too few countable rows)
    emulated in numpy on every chunk of the walk and on the largest
    chunk's traps (the skip's among them), equal to the JAX package's
    _walk_chunk and to the port's plain version; the skip fires on the
    skip traps and in the saturated tail of the walk, and settled chains
    leave the rounds (the live chains of a step's rounds fall)."""
    bm, bn, depth = schedule
    grid, pg, st = staged(case)
    inv = port.build_inv(st.rows_by_d, st.la_d)
    s_np, first_nw, x0 = port.walk_seeds(pg, st)
    seen, skipped, live = [], {}, []

    def check(a, name):
        got = port._walk_chunk(*a)
        statics = dict(zip(("super_majority", "l", "length", "steps", "use_seeds"), a[8:]))
        want = ref._walk_chunk(*[np_(v) for v in a[:8]], **statics)
        *emulated, skipped[name], live_a = tiled_walk_chunk(a, bm, bn, depth,
                                                            order_seed=len(seen))
        live.extend(live_a)
        for g, w, e in zip(got, want, emulated):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(e, np.asarray(w))
        return got

    def walk(*a):
        seen.append(a)
        return check(a, f"chunk {len(seen)}")

    port._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)), inv, st.rows_by_d, st.fd_d,
        st.la_d, x0, s_np, first_nw, pg.super_majority, st.l_b, st.seeded, {}, walk=walk,
    )
    assert seen
    for name, a in walk_chunk_traps(max(seen, key=lambda a: a[10])).items():
        check(a, name)
    assert all(skipped[name] >= 1 for name in skipped if name.startswith("skip"))
    assert skipped[f"chunk {len(seen)}"] >= 1
    # settled chains leave the rounds (on the unpinned section every search
    # ends before a chain settles)
    assert any(rounds[-1] < rounds[0] for rounds in live) or case == ("section", 0.5, False)
