"""Dense host staging of the gossip DAG for the PyTorch port.

The port's own copy of the reference grid layer (babble_tpu/tpu/grid.py):
the `DagGrid` record, the topological level table and the synthetic
gossip generator, which draws the same numpy RNG stream so one seed gives
the same grid in both packages. `grid_from_arrays` carries a grid built
elsewhere (for example by the reference's `grid_from_hashgraph`) across as
plain numpy arrays, so the port needs no import of the reference package.

Each event is a row; its lastAncestors / firstDescendants coordinate
vectors are two (E, N) int32 matrices (MAX_INT32 = no first descendant).
Parents outside the grid (roots, reset `others` entries) arrive as
per-event external metadata; the round-frontier path handles base grids
only, where every chain is anchored at a genesis root, and the level scan
and the cold path also take post-reset grids. `section_grid` cuts such a
grid out of a solved one, as a fast-sync joiner receives it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import numpy as np


MAX_INT32 = 2**31 - 1
MIN_INT32 = -(2**31)


@dataclass
class DagGrid:
    """Host-side numpy staging of one consensus batch."""

    n: int  # validators
    e: int  # events
    super_majority: int
    creator: np.ndarray  # (E,) int32 peer position
    index: np.ndarray  # (E,) int32 per-creator sequence number
    self_parent: np.ndarray  # (E,) int32 event row, -1 = outside grid
    other_parent: np.ndarray  # (E,) int32 event row, -1 = none/outside grid
    last_ancestors: np.ndarray  # (E, N) int32
    first_descendants: np.ndarray  # (E, N) int32 (MAX_INT32 = none)
    coin_bit: np.ndarray  # (E,) bool
    # external-parent metadata (used where the parent row is -1):
    fixed_round: np.ndarray  # (E,) int32: >=0 forces the round (root-attached)
    ext_sp_round: np.ndarray  # (E,) int32 self-parent round outside grid
    ext_op_round: np.ndarray  # (E,) int32 other-parent round outside grid (-1 none)
    ext_sp_lamport: np.ndarray  # (E,) int32
    ext_op_lamport: np.ndarray  # (E,) int32 (MIN_INT32 = none)
    fixed_lamport: np.ndarray  # (E,) int32: != MIN_INT32 forces the lamport
    levels: np.ndarray  # (L, N) int32 event rows, -1 padding
    num_levels: int
    hashes: Optional[List[str]] = None  # row -> event hex (host bookkeeping)
    # per-event (row, col, value) first-descendant writes caused by that
    # event's insert — the delta stream for the incremental engine
    fd_update_stream: Optional[List[List[Tuple[int, int, int]]]] = None

    @property
    def r_base(self) -> int:
        """Highest externally-supplied round — the starting point of any
        round numbering inside the grid."""
        base = 0
        if self.e:
            base = max(
                base,
                int(self.fixed_round.max(initial=0)),
                int(self.ext_sp_round.max(initial=0)),
                int(self.ext_op_round.max(initial=0)),
            )
        return base

    @property
    def r_max(self) -> int:
        # round(e) <= level(e) + r_base + 1 (a round advance needs at least
        # one new level); +2 margin for the fame lookahead
        return self.num_levels + self.r_base + 2


class GridUnsupported(Exception):
    """Raised when a grid cannot run on a device path: a hashgraph state
    with an other-parent that is resolvable nowhere, or (in this package)
    a post-reset grid that the round-frontier walk does not cover."""


_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(DagGrid)
    if f.name not in ("n", "e", "super_majority", "num_levels", "hashes",
                      "fd_update_stream")
)


def grid_from_arrays(d: Mapping) -> DagGrid:
    """Build a port `DagGrid` from a mapping of a grid's fields (numpy
    arrays plus the integers n, e, super_majority and num_levels), such as
    `vars(reference_grid)`. Arrays are copied, so the result shares no
    buffer with the source; unknown keys are ignored."""
    arrays = {k: np.array(d[k], copy=True) for k in _ARRAY_FIELDS}
    hashes = d.get("hashes")
    return DagGrid(
        n=int(d["n"]),
        e=int(d["e"]),
        super_majority=int(d["super_majority"]),
        num_levels=int(d["num_levels"]),
        hashes=list(hashes) if hashes is not None else None,
        **arrays,
    )


def build_levels(n: int, self_parent: np.ndarray, other_parent: np.ndarray):
    """Topological level table: (L, N) of event rows, -1 padded."""
    e_count = len(self_parent)
    level = np.zeros(e_count, dtype=np.int64)
    for i in range(e_count):
        lv = 0
        sp = self_parent[i]
        if sp >= 0:
            lv = level[sp] + 1
        op = other_parent[i]
        if op >= 0:
            lv = max(lv, level[op] + 1)
        level[i] = lv

    num_levels = int(level.max(initial=-1)) + 1 if e_count else 0
    levels = np.full((max(num_levels, 1), n), -1, dtype=np.int32)
    slot = np.zeros(max(num_levels, 1), dtype=np.int64)
    for i in range(e_count):
        lv = level[i]
        levels[lv, slot[lv]] = i
        slot[lv] += 1
    return levels, num_levels


def synthetic_grid(
    n: int,
    e_count: int,
    seed: int = 0,
    zipf_a: float = 0.0,
    record_fd_updates: bool = False,
    byzantine_frac: float = 0.0,
    withhold_span: int = 24,
) -> DagGrid:
    """Generate a random gossip DAG the way gossip produces one: each new
    event is a sync — creator c extends its own chain with an other-parent
    drawn from another validator's head (Zipf-skewed fan-out when zipf_a>0,
    reference scenario: BASELINE.json config #3).

    byzantine_frac > 0 gives the first floor(frac*n) validators an
    adversarial withhold/flush lifecycle (BASELINE.json config #4's
    "adversarial 1/3-byzantine event graph"): while withholding, a
    validator's new events are invisible to partner choice (nobody
    references its head, its own other-parents go stale), then the hidden
    chain is revealed all at once by an honest event referencing it.
    Withholding is staggered at n//8 concurrent validators so the visible
    set keeps a supermajority (the structure mirror of
    tests/test_byzantine_scale.py's host-path generator).

    Coordinates (lastAncestors/firstDescendants) are built exactly as the
    host insert path does (reference: src/hashgraph/hashgraph.go:439-544).
    Used by the offline replay bench and kernel tests; no signatures — the
    synthetic coin bits are pseudorandom.
    """
    rng = np.random.default_rng(seed)
    super_majority = 2 * n // 3 + 1
    # per-event (row, col, value) first-descendant cell writes — the exact
    # delta stream an incremental engine replays (own-cell write excluded;
    # it rides with the appended row)
    fd_updates: List[List[Tuple[int, int, int]]] = [[] for _ in range(e_count)]

    creator = np.zeros(e_count, dtype=np.int32)
    index = np.zeros(e_count, dtype=np.int32)
    self_parent = np.full(e_count, -1, dtype=np.int32)
    other_parent = np.full(e_count, -1, dtype=np.int32)
    la = np.full((e_count, n), -1, dtype=np.int32)
    fd = np.full((e_count, n), MAX_INT32, dtype=np.int32)

    head = np.full(n, -1, dtype=np.int64)  # validator -> head event row
    next_index = np.zeros(n, dtype=np.int64)
    rows_by = [[] for _ in range(n)]  # validator -> [index -> event row]

    if zipf_a > 0:
        weights = 1.0 / np.arange(1, n + 1) ** zipf_a
        weights /= weights.sum()
    else:
        weights = np.full(n, 1.0 / n)

    n_byz = int(byzantine_frac * n)
    visible_head = np.full(n, -1, dtype=np.int64)
    withholding = np.zeros(n, dtype=bool)
    hidden_since = np.zeros(n, dtype=np.int64)

    # first event per validator, then gossip syncs
    for i in range(e_count):
        forced_op = None
        if i < n:
            c = i
            op_row = -1
        else:
            c = int(rng.integers(n))
            if c < n_byz:
                if (
                    not withholding[c]
                    and int(withholding.sum()) < max(n // 8, 1)
                    and rng.random() < 1.0 / withhold_span
                ):
                    withholding[c] = True
                    hidden_since[c] = next_index[c]
                elif (
                    withholding[c]
                    and next_index[c] - hidden_since[c] >= withhold_span
                ):
                    # flush: an honest event reveals the hidden chain
                    withholding[c] = False
                    visible_head[c] = head[c]
                    forced_op = int(head[c])
                    c = n_byz + int(rng.integers(n - n_byz)) if n_byz < n else c
            if forced_op is not None:
                op_row = forced_op
            else:
                partner = int(rng.choice(n, p=weights))
                while partner == c or visible_head[partner] < 0:
                    partner = int(rng.choice(n, p=weights))
                op_row = int(visible_head[partner])
        creator[i] = c
        index[i] = next_index[c]
        self_parent[i] = head[c]
        other_parent[i] = op_row

        # merge parents' lastAncestors
        sp_row = head[c]
        if sp_row < 0 and op_row < 0:
            pass  # stays all -1
        elif sp_row < 0:
            la[i] = la[op_row]
        elif op_row < 0:
            la[i] = la[sp_row]
        else:
            la[i] = np.maximum(la[sp_row], la[op_row])
        la[i, c] = index[i]
        fd[i, c] = index[i]

        rows_by[c].append(i)  # before the walk: own fd cell is already set

        # mark first descendants along ancestors' self-parent chains;
        # amortized O(E*N): each (row, c) cell is written at most once
        for p in range(n):
            a = int(la[i, p])
            while a >= 0:
                row = rows_by[p][a]
                if fd[row, c] == MAX_INT32:
                    fd[row, c] = index[i]
                    if record_fd_updates:
                        fd_updates[i].append((row, c, int(index[i])))
                    a -= 1
                else:
                    break

        head[c] = i
        if not withholding[c]:
            visible_head[c] = i
        next_index[c] += 1

    coin = rng.integers(0, 2, size=e_count).astype(bool)
    levels, num_levels = build_levels(n, self_parent, other_parent)

    # base-root external metadata: first events per creator attach to base
    # roots (next_round 0, self-parent round/lamport -1)
    fixed_round = np.where(
        (self_parent < 0) & (other_parent < 0), 0, -1
    ).astype(np.int32)
    ext_sp_round = np.full(e_count, -1, dtype=np.int32)
    ext_op_round = np.full(e_count, -1, dtype=np.int32)
    ext_sp_lamport = np.full(e_count, -1, dtype=np.int32)
    ext_op_lamport = np.full(e_count, MIN_INT32, dtype=np.int32)
    fixed_lamport = np.full(e_count, MIN_INT32, dtype=np.int32)

    return DagGrid(
        n=n,
        e=e_count,
        super_majority=super_majority,
        creator=creator,
        index=index,
        self_parent=self_parent,
        other_parent=other_parent,
        last_ancestors=la,
        first_descendants=fd,
        coin_bit=coin,
        fixed_round=fixed_round,
        ext_sp_round=ext_sp_round,
        ext_op_round=ext_op_round,
        ext_sp_lamport=ext_sp_lamport,
        ext_op_lamport=ext_op_lamport,
        fixed_lamport=fixed_lamport,
        levels=levels,
        num_levels=num_levels,
        fd_update_stream=fd_updates if record_fd_updates else None,
    )


def synthetic_deep_grid(
    n: int, depth: int, seed: int = 0, zipf_a: float = 1.2,
) -> DagGrid:
    """Deep synthetic gossip DAG: smallest synthetic_grid (same generator,
    same coordinate construction) whose level count reaches `depth`.
    Deterministic: the event count doubles from a fixed starting size until
    the depth target is met, so (n, depth, seed, zipf_a) always yields the
    same grid. Cold-path fixture — depth is what the doubling kernels'
    pass count scales against."""
    e_count = max(2 * depth, 4 * n)
    while True:
        g = synthetic_grid(n, e_count, seed=seed, zipf_a=zipf_a)
        if g.num_levels >= depth:
            return g
        e_count *= 2


def row_levels(grid: DagGrid) -> np.ndarray:
    """(E,) per-row topological level, inverted from the grid's level
    table."""
    out = np.zeros(grid.e, dtype=np.int32)
    for lvl in range(grid.num_levels):
        rows = grid.levels[lvl]
        out[rows[rows >= 0]] = lvl
    return out



def section_grid(grid: DagGrid, res, cut: int, pin_cut: bool = True) -> DagGrid:
    """Cut a post-reset / fast-sync-frame style SECTION out of a solved
    grid: keep rows at topological level >= cut, rewrite dropped parents as
    external metadata carrying the authoritative rounds/lamports from
    `res` (a PassResults/PipelineResult for the full grid) — exactly the
    shape `grid_from_hashgraph` produces after a reset, where the store
    holds only the section and roots/frozen refs carry the history below
    the cut.

    Creator indexes are intentionally NOT renumbered: chains start at
    non-zero per-creator indexes, exercising the per-chain rebasing of the
    cold path. Coordinate matrices are sliced unchanged (they live in
    (creator, index) space); out-of-section lastAncestors entries are the
    callee's problem, first descendants of kept rows are always kept
    (descendants sit at higher levels).

    pin_cut=True (the realistic shape) pins round/lamport on rows whose
    self-parent fell below the cut, mirroring the root next_round /
    memoized-metadata pins a real reset carries. pin_cut=False yields the
    amnesiac variant: chain-first rows continue their below-cut round via
    ext_sp_round alone and are then NOT witnesses — with few enough
    surviving witnesses the section's rounds stall entirely, which is
    exactly the host engine's (and the level scan's) behavior on such a
    store; it makes a sharp differential fixture for the frontier-row
    masking in the cold path."""
    lv = row_levels(grid)
    keep = lv >= cut
    old_rows = np.nonzero(keep)[0]
    if old_rows.size == 0:
        raise ValueError("section cut keeps no rows")
    new_of = np.full(grid.e, -1, dtype=np.int32)
    new_of[old_rows] = np.arange(old_rows.size, dtype=np.int32)

    rounds = np.asarray(res.rounds)
    lamport = np.asarray(res.lamport)

    sp_old = grid.self_parent[old_rows]
    op_old = grid.other_parent[old_rows]
    sp_in = (sp_old >= 0) & keep[np.maximum(sp_old, 0)]
    op_in = (op_old >= 0) & keep[np.maximum(op_old, 0)]
    sp_cut = (sp_old >= 0) & ~sp_in
    op_cut = (op_old >= 0) & ~op_in

    self_parent = np.where(sp_in, new_of[np.maximum(sp_old, 0)], -1)
    other_parent = np.where(op_in, new_of[np.maximum(op_old, 0)], -1)
    ext_sp_round = np.where(
        sp_cut, rounds[np.maximum(sp_old, 0)], grid.ext_sp_round[old_rows]
    ).astype(np.int32)
    ext_op_round = np.where(
        op_cut, rounds[np.maximum(op_old, 0)], grid.ext_op_round[old_rows]
    ).astype(np.int32)
    ext_sp_lamport = np.where(
        sp_cut, lamport[np.maximum(sp_old, 0)], grid.ext_sp_lamport[old_rows]
    ).astype(np.int32)
    ext_op_lamport = np.where(
        op_cut, lamport[np.maximum(op_old, 0)], grid.ext_op_lamport[old_rows]
    ).astype(np.int32)

    fixed_round = grid.fixed_round[old_rows].copy()
    fixed_lamport = grid.fixed_lamport[old_rows].copy()
    if pin_cut:
        fixed_round = np.where(
            sp_cut, rounds[old_rows], fixed_round
        ).astype(np.int32)
        fixed_lamport = np.where(
            sp_cut, lamport[old_rows], fixed_lamport
        ).astype(np.int32)

    levels, num_levels = build_levels(grid.n, self_parent, other_parent)
    return DagGrid(
        n=grid.n,
        e=old_rows.size,
        super_majority=grid.super_majority,
        creator=grid.creator[old_rows].copy(),
        index=grid.index[old_rows].copy(),
        self_parent=self_parent.astype(np.int32),
        other_parent=other_parent.astype(np.int32),
        last_ancestors=grid.last_ancestors[old_rows].copy(),
        first_descendants=grid.first_descendants[old_rows].copy(),
        coin_bit=grid.coin_bit[old_rows].copy(),
        fixed_round=fixed_round,
        ext_sp_round=ext_sp_round,
        ext_op_round=ext_op_round,
        ext_sp_lamport=ext_sp_lamport,
        ext_op_lamport=ext_op_lamport,
        fixed_lamport=fixed_lamport,
        levels=levels,
        num_levels=num_levels,
    )
