#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (babble_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds every kernel of the round-frontier path from
   babble_tpu_torch/csrc into build/torch_kernels (one nvcc per source, in
   parallel), with the build seconds and each kernel's ptxas report;
3. kernels: each kernel against its plain PyTorch version on the card,
   exact integer equality (torch.equal, tolerance 0), on the bench grid
   (64 validators, 32,768 Zipf-skewed events) and the small fixtures of
   the JAX suite's frontier tests, with CUDA-event times at the bench shapes;
   decide_fame also on random voting tables that reach a coin round (shown
   on the CPU first: flipping the coin bits changes the verdicts);
4. end to end: run_frontier_passes on the card at the bench size, every
   field equal to the port's CPU run, last_round 26 and 28,065 received
   events (the JAX reference's result on this grid), every kernel's launch
   count above zero, and the median wall time over warm runs;
5. grids of the cold path: the catch-up cell of bench_catchup.py (8
   validators, synthetic_deep_grid(8, 16384, seed=0, zipf_a=1.2), 65,536
   events and 20,359 levels, cut at half its levels into a section of
   32,760 events and 10,180 levels) and an unpinned section, whose
   rounds stall (synthetic_deep_grid(8, 2048), pin_cut=False);
6. kernels of the level scan and the cold path against their plain
   versions on the card, torch.equal: divide_rounds and lamport_scan on
   the bench grid and both sections, closure_la (with its pass count) on
   the bench grid and the catch-up section, walk_chunk on every chunk of
   the bench grid's walk (unseeded) and both sections' (seeded; the
   first_nw mask must fire on the unpinned section), with launches and
   CUDA-event times;
7. the bench grid through run_doubling_passes and run_passes(bucketed,
   adaptive_r) on the card: equal to run_frontier_passes field for field,
   closure passes 5 and walk chunks 2, each path's kernels launched, and
   the median wall time over warm runs;
8. the catch-up cell: both engines on the card equal to each other and to
   the port's CPU run, last_round 1,022, round_offset 511, 32,536
   received, closure passes 4, walk chunks 6, 11 passes, each path's
   kernels launched, and events ordered per second replaying the section
   from cold (32,760 / the median wall time);
9. the incremental engine's kernels (apply_deltas, step_levels,
   train_levels, decide_window) against their plain versions on the card:
   one state driven through the kernels and a clone through the plain
   versions, every IncState field torch.equal after every call, at the
   live step shape (the bench grid's 512 batches of batches_from_grid(grid,
   64, 8192, 65536), e_win 8192, r_win 64, r_cap 64), the train shape (its
   4 trains of trains_from_grid(grid, 8192, 524288, 32768, t_cap=832),
   e_win 16384) and test_incremental.py's 8-validator grid (batch 32,
   train 256; the unrolled offset d = 8 is a coin step), there also with
   r_win 8 < r_cap 16 (the window slides and freezes) and with two no-op
   batches (the live engine's padding) after its own, with each kernel's
   launches and CUDA-event times at the bench shapes;
10. both append paths end to end on the bench grid, inputs on the card
   before timing: step over the 512 batches, multi_step in groups of 16
   (padded with no-op batches as the live engine pads them), train_step
   over the 4 trains and multi_train with K = 2 (e_win 24,576: a decide
   per two trains needs both trains' rows and the undecided tail in its
   window; at 16,384 the stale latch fires, in the JAX reference too,
   which is checked as well); each equal to run_passes
   on the card on rows [:e] of rounds, lamport, witness and received, with
   last_round 26, 28,065 received and no latch set, each path's kernels
   launched, and events appended per second (32,768 / the median wall
   time over 5 warm runs from a fresh state, one synchronize at the end).

The next-to-last line is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX and
nothing of the babble_tpu package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BENCH = dict(n=64, e_count=32768, seed=0, zipf_a=1.1)
BENCH_LAST_ROUND = 26
BENCH_RECEIVED = 28065
# the small fixtures of tests/test_frontier.py (n, e, seed, zipf, byzantine)
FIXTURES = [
    (4, 64, 1, 0.0, 0.0),
    (8, 256, 2, 0.0, 0.0),
    (8, 512, 3, 1.1, 0.0),
    (16, 1024, 4, 1.1, 0.0),
    (8, 300, 7, 2.0, 0.0),
    (32, 768, 9, 1.1, 0.0),
    (32, 1024, 11, 1.05, 1.0 / 3.0),
    (64, 2048, 13, 1.05, 1.0 / 3.0),
]
# (n, rounds, seed) of coin_round_case tables whose verdicts depend on the
# coin bits, i.e. whose voting reaches d = n with a witness undecided
COIN_CASES = [(4, 12, 9), (8, 20, 52)]
R_CAP = 64
DEVICE = "cuda"
E2E_RUNS = 20

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, non-tensor ALU
# operations/s (the float32 rate; int32 compare/min/add run on the same
# pipes), int8 tensor-core operations/s for 0/1 products
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
INT8_TC_OPS_S = 1979e12

# the catch-up cell of bench_catchup.py, with the JAX reference's results
CATCHUP = dict(n=8, depth=16384, seed=0, zipf_a=1.2)
CATCHUP_GRID = (65536, 20359)  # events, levels
CATCHUP_SECTION = (32760, 10180)
CATCHUP_EXPECT = dict(last_round=1022, round_offset=511, received=32536,
                      closure_passes=4, walk_chunks=6, passes=11)
BENCH_DOUBLING = dict(closure_passes=5, walk_chunks=2)
UNPINNED = dict(n=8, depth=2048, seed=0, zipf_a=1.2)
UNPINNED_LAST_ROUND = 127
CATCHUP_RUNS = 5
SLOW_PLAIN_REPS = 3

# the incremental engine: the live engine's defaults (babble_tpu/tpu/live.py
# ENGINE_DEFAULTS) for the step path, bench_incremental.py's constants for
# the train path, and the JAX reference's results on the bench grid
INC_STEP = dict(batch=64, upd_cap=8192, e_cap=65536, r_cap=64, r_win=64, e_win=8192)
INC_TRAIN = dict(size=8192, upd_cap=524288, e_cap=32768, t_cap=832, r_cap=64,
                 r_win=32, e_win=16384)
INC_BATCHES = 512
INC_TRAIN_LEVELS = [416, 384, 416, 384]
INC_WITNESSES = 1727
MULTI_STEP_K = 16
MULTI_TRAIN_K = 2
# one decide per two trains must see both trains' rows and the tail still
# undecided before them; at the train path's e_win 16,384 rows below the
# window stay undetermined and the stale latch fires with 23,380 received,
# at 24,576 none does: the JAX reference's results on the CPU, every field
# equal to the port's (tests/test_torch_incremental.py
# ::test_multi_train_window_on_the_bench_grid, marked slow)
MULTI_TRAIN_E_WIN = 24576
MULTI_TRAIN_UNDERSIZED = dict(stale=True, fame_lag=False, received=23380)
INC_RUNS = 5
# about half a millisecond of spinning at the H100's clock
SPIN_CYCLES = 1_000_000
# test_incremental.py's 8-validator grid, its batch and train sizes
INC_FIXTURE = dict(n=8, e=768, seed=3, zipf_a=1.1, batch=32, train=256, w_cap=16,
                   t_cap=96, r_cap=64, e_win=512)

REPLACES = {
    "build_inv": ("babble_tpu_torch/csrc/build_inv.cu", "babble_tpu/tpu/frontier.py:116"),
    "frontier_rounds": ("babble_tpu_torch/csrc/frontier_walk.cu", "babble_tpu/tpu/frontier.py:299"),
    "decide_fame": ("babble_tpu_torch/csrc/decide_fame.cu", "babble_tpu/tpu/kernels.py:335"),
    "round_received": ("babble_tpu_torch/csrc/round_received.cu", "babble_tpu/tpu/kernels.py:424"),
    "divide_rounds": ("babble_tpu_torch/csrc/divide_rounds.cu", "babble_tpu/tpu/kernels.py:118"),
    "closure_la": ("babble_tpu_torch/csrc/closure_la.cu", "babble_tpu/tpu/doubling.py:172"),
    "walk_chunk": ("babble_tpu_torch/csrc/walk_chunk.cu", "babble_tpu/tpu/doubling.py:296"),
    "lamport_scan": ("babble_tpu_torch/csrc/lamport_scan.cu", "babble_tpu/tpu/doubling.py:443"),
    "apply_deltas": ("babble_tpu_torch/csrc/apply_deltas.cu", "babble_tpu/tpu/incremental.py:213"),
    "step_levels": ("babble_tpu_torch/csrc/step_levels.cu", "babble_tpu/tpu/incremental.py:243"),
    "train_levels": ("babble_tpu_torch/csrc/train_levels.cu", "babble_tpu/tpu/incremental.py:570"),
    "decide_window": ("babble_tpu_torch/csrc/decide_window.cu", "babble_tpu/tpu/incremental.py:361"),
}
# the kernels each engine's call must launch
PATH_KERNELS = {
    "run_frontier_passes": ("build_inv", "frontier_rounds", "decide_fame", "round_received"),
    "run_passes": ("divide_rounds", "decide_fame", "round_received"),
    "run_doubling_passes": ("closure_la", "build_inv", "walk_chunk", "decide_fame",
                            "round_received"),
    "run_doubling_passes, seeded": ("closure_la", "build_inv", "walk_chunk", "lamport_scan",
                                    "decide_fame", "round_received"),
    "step": ("apply_deltas", "step_levels", "decide_window"),
    "multi_step": ("apply_deltas", "step_levels", "decide_window"),
    "train_step": ("apply_deltas", "train_levels", "decide_window"),
    "multi_train": ("apply_deltas", "train_levels", "decide_window"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of fn() over reps runs, each between two CUDA
    events, after `warmup` warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def coin_round_case(n, r, seed):
    """decide_fame inputs over n validators and r rounds of witnesses, random
    from a numpy seed: witness (round, creator) on event row round * n +
    creator, about a tenth of them absent, lastAncestors mostly above
    firstDescendants, so that strongly-seeing is common but the votes stay
    split for long stretches. Returns numpy arrays and the scalar arguments."""
    rng = np.random.default_rng(seed)
    e = r * n
    wtable = np.arange(e, dtype=np.int32).reshape(r, n)
    absent = rng.random((r, n)) < 0.1
    absent[0] = absent[-1] = False
    wtable[absent] = -1
    return dict(
        wtable=wtable,
        la=rng.integers(2, 10, size=(e, n), dtype=np.int32),
        fd=rng.integers(0, 8, size=(e, n), dtype=np.int32),
        index=rng.integers(0, 10, size=e, dtype=np.int32),
        coin_bit=rng.random(e) < 0.5,
        last_round=r - 1, super_majority=2 * n // 3 + 1, n_participants=n,
        d_cap=r + 2,
    )


def coin_fame_args(case, coin_bit, device):
    """decide_fame's positional arguments for a coin_round_case, on device."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(case["wtable"]), t(case["la"]), t(case["fd"]), t(case["index"]),
            t(coin_bit), torch.tensor(case["last_round"], dtype=torch.int32, device=device),
            case["super_majority"], case["n_participants"], case["d_cap"])


def max_abs_err(got, want):
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


def require_equal(what, got, want):
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    for k, (g, w) in enumerate(zip(got_t, want_t)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: field {k} differs from the plain version")


def require_same_results(what, got, want):
    """PassResults equality: per-event fields in full, the (R, N) tables on
    the real rounds (the adaptive round axis may size them differently;
    their rows are indexed by round - round_offset)."""
    if got.last_round != want.last_round:
        raise AssertionError(f"{what}: last_round {got.last_round} != {want.last_round}")
    if got.round_offset != want.round_offset:
        raise AssertionError(f"{what}: round_offset {got.round_offset} != {want.round_offset}")
    k = want.last_round - want.round_offset + 1
    for field in ("rounds", "witness", "lamport", "received", "witness_table",
                  "fame_decided", "famous", "rounds_decided"):
        g, w = getattr(got, field), getattr(want, field)
        if field in ("witness_table", "fame_decided", "famous", "rounds_decided"):
            g, w = g[:k], w[:k]
        if g.shape != w.shape or g.dtype != w.dtype or not (g == w).all():
            raise AssertionError(f"{what}: {field} differs from the CPU run")


def wall_ms(fn, runs):
    """Median host-clock milliseconds of fn() over `runs` warm runs, each
    ending in a synchronize, after two warm-up runs."""
    walls = []
    for _ in range(runs + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[2:]) * 1e3


def run_path(label, fn):
    """Run one engine call with every launch count set to 0 just before it
    and read just after; fail unless each kernel of the path launched."""
    from babble_tpu_torch.tpu import _ext

    _ext.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    missing = [k for k in PATH_KERNELS[label] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: never launched {missing}")
    log(f"  {label}: launches {({k: v for k, v in launches.items() if v})}")
    return res, launches


def scan_pair_count(levels, sp, op, ext_sp_round, ext_op_round, rounds, wtable):
    """(event, witness) pairs whose strongly-see count the level scan needs:
    each event against the witnesses of its parent round that an earlier
    level placed in the table (CPU tensors, the scan's own outputs)."""
    e = rounds.shape[0]
    r_max = wtable.shape[0]
    lvl = torch.full((e,), -1, dtype=torch.long)
    pos = torch.nonzero(levels >= 0)
    lvl[levels[pos[:, 0], pos[:, 1]].long()] = pos[:, 0]
    sp_r = torch.where(sp >= 0, rounds[sp.clamp(0, e - 1).long()], ext_sp_round)
    op_r = torch.where(op >= 0, rounds[op.clamp(0, e - 1).long()], ext_op_round)
    pr = torch.maximum(sp_r, op_r)
    w = wtable[pr.clamp(0, r_max - 1).long()]
    ok = ((w >= 0) & (pr >= 0)[:, None] & (lvl >= 0)[:, None]
          & (lvl[w.clamp(0, e - 1).long()] < lvl[:, None]))
    return int(ok.sum())


def state_diff(a, b):
    """Names of the IncState fields in which two states differ."""
    return [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]


class PairedRun:
    """One incremental state driven through the kernels and a clone of it
    through the plain versions, call by call: every IncState field is held
    torch.equal after each call, and each call's kernel and plain times
    (CUDA events) and the work its data needs are kept by kernel name."""

    def __init__(self, label, state):
        from babble_tpu_torch.tpu import incremental as inc

        self.label = label
        self.k = state
        self.p = inc.clone_state(state)
        self.events = {}
        self.work = {}

    def call(self, name, kern, plain, work=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        # the card spins while the host runs the wrapper and enqueues the
        # launch, so the events time the kernel and not the enqueue
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        kern(self.k)
        ev[1].record()
        ev[2].record()
        plain(self.p)
        ev[3].record()
        bad = state_diff(self.k, self.p)
        calls = self.events.setdefault(name, [])
        if bad:
            raise AssertionError(f"{name} on the {self.label}, call {len(calls)}: "
                                 f"{bad} differ from the plain version")
        calls.append(ev)
        if work is not None:
            nbytes, alu, tc = work(self.k)
            acc = self.work.setdefault(name, [0, 0, 0])
            acc[0] += nbytes
            acc[1] += alu
            acc[2] += tc

    def times(self, name):
        """(calls, total kernel ms, total plain ms)."""
        torch.cuda.synchronize()
        evs = self.events[name]
        return (len(evs), sum(e[0].elapsed_time(e[1]) for e in evs),
                sum(e[2].elapsed_time(e[3]) for e in evs))


def inc_work_deltas(st, x):
    """(bytes, ALU ops, tensor-core ops) apply_deltas needs for input x:
    each real delta's 12 bytes, its row's slot and one fd cell (and one
    fd_w cell where mirrored); each staged row's la row in and out, its
    identity and own fd cell."""
    e_cap, n = st.la.shape
    ok = (x.upd_row >= 0) & (x.upd_row < e_cap)
    u = int(ok.sum())
    slot = st.w_of_row[x.upd_row.clamp(0, e_cap - 1).long()]
    mirrored = int((ok & (slot >= 0)).sum())
    rows = int(((x.rows >= 0) & (x.rows < e_cap)).sum())
    return u * 20 + mirrored * 4 + rows * (8 * n + 24), u + mirrored + rows, 0


def inc_work_levels(st, x, rounds_scan):
    """(bytes, ALU ops, 0) of one level-scan call, each input read once and
    each output written once: per real lane its level-table entry, batch
    metadata, la row, parents' rounds and lamports and its results; per
    distinct parent round its witness row and the fd_w rows of its
    witnesses (as the call leaves the table), however many lanes compare
    against them; each registration's fd row in and its la_w, fd_w and
    table cells out; the step path also reads every row's round (its
    last_round is a max over all of them). The lane-by-witness compares
    (pairs x n) count as ALU work."""
    e_cap, n = st.la.shape
    r_cap = st.wtable.shape[0]
    pos = x.levels[x.levels >= 0].long()
    lanes = pos.numel()

    def parent_round(r):
        ok = (r >= 0) & (r < e_cap)
        return torch.where(ok, st.rounds[r.clamp(0, e_cap - 1).long()], -1)

    pr = torch.maximum(parent_round(x.sp_row[pos]), parent_round(x.op_row[pos]))
    present = (st.wtable[pr.clamp(0, r_cap - 1).long()] >= 0) & (pr >= 0)[:, None]
    pairs = int(present.sum())
    slabs = pr[pr >= 0].clamp(0, r_cap - 1).unique().long()
    slab_rows = int((st.wtable[slabs] >= 0).sum())
    regs = int(st.witness[x.rows[pos].clamp(0, e_cap - 1).long()].sum())
    nbytes = (lanes * (4 + 29 + 4 * n + 16 + 9) + slabs.numel() * 4 * n
              + slab_rows * 4 * n + regs * (12 * n + 13)
              + (e_cap * 4 if rounds_scan else 0))
    return nbytes, pairs * n + lanes * n, 0


def inc_work_decide(st, r_win, e_win):
    """(bytes, ALU ops, tensor-core ops) of one decide: the window's
    witness rows of la_w and fd_w and its tables, the famous witnesses' la
    rows, the fame tables, the trailing e_win rows (index, creator,
    rounds, received) and the rows below them the stale detector reads;
    the strongly-see compares at ALU rate and the eight offsets' 0/1
    tallies at the int8 tensor-core rate."""
    e_cap, n = st.la.shape
    r_cap = st.wtable.shape[0]
    lr = int(st.last_round)
    undecided = ~st.rounds_decided & (torch.arange(r_cap, device=st.la.device) <= lr)
    idx = torch.nonzero(undecided)
    floor_true = min(int(idx[0]), lr) if idx.numel() else lr
    floor = min(max(floor_true, 0), r_cap - r_win)
    wv = st.wtable[floor : floor + r_win] >= 0
    n_wit = int(wv.sum())
    pairs = int((wv[1:].sum(dim=1) * wv[:-1].sum(dim=1)).sum())
    n_famous = int((st.fame_decided & st.famous & (st.wtable >= 0)).sum())
    lo = min(max(int(st.count) - e_win, 0), e_cap - e_win)
    nbytes = (n_wit * (8 * n + 5) + r_win * n * 4 + n_famous * n * 4 + r_cap * n * 6
              + r_cap + e_win * 16 + lo * 8)
    return nbytes, pairs * n, 2 * 8 * r_win * n ** 3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from babble_tpu_torch.tpu import _ext, doubling, engine, frontier, kernels
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False  # the bmm yardstick stays exact

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    paths = _ext.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernel libraries")
    for name, path in paths.items():
        report = path.with_suffix(".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version
    def pipeline_inputs(grid, st, r_cap):
        inv = frontier.build_inv(st.rows_by, st.la)
        fr = frontier.frontier_rounds(
            inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd,
            grid.super_majority, r_cap,
        )
        fame = kernels.decide_fame(
            fr.witness_table, st.la, st.fd, st.index, st.coin_bit,
            fr.last_round, grid.super_majority, grid.n, r_cap + 2,
        )
        return inv, fr, fame

    def calls(grid, st, r_cap):
        """(name, kernel call, plain call) over the same card inputs."""
        inv, fr, fame = pipeline_inputs(grid, st, r_cap)
        sm, n = grid.super_majority, grid.n
        fame_args = (fr.witness_table, st.la, st.fd, st.index, st.coin_bit,
                     fr.last_round, sm, n, r_cap + 2)
        recv_args = (fr.witness_table, st.la, st.index, st.creator, fr.rounds,
                     fame.decided, fame.famous, fame.rounds_decided, fr.last_round)
        return [
            ("build_inv",
             lambda: frontier.build_inv(st.rows_by, st.la),
             lambda: frontier._build_inv_plain(st.rows_by, st.la)),
            ("frontier_rounds",
             lambda: tuple(frontier.frontier_rounds(
                 inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, r_cap)),
             lambda: tuple(frontier._frontier_rounds_plain(
                 inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, r_cap,
                 la=st.la))),
            ("decide_fame",
             lambda: tuple(kernels.decide_fame(*fame_args)),
             lambda: tuple(kernels._decide_fame_plain(*fame_args))),
            ("round_received",
             lambda: kernels.decide_round_received(*recv_args),
             lambda: kernels._decide_round_received_plain(*recv_args)),
        ], (inv, fr, fame)

    for fx in FIXTURES:
        n, e, seed, zipf, byz = fx
        grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
        st = engine.stage_frontier(grid, dev)
        triples, _ = calls(grid, st, R_CAP)
        for name, kern, plain in triples:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            require_equal(f"{name} on fixture {fx}", got, want)
        require_same_results(
            f"run_frontier_passes on fixture {fx}",
            engine.run_frontier_passes(grid, device=dev),
            engine.run_frontier_passes(grid, device="cpu"),
        )
        log(f"kernels == plain and e2e == cpu on fixture n={n} e={e} seed={seed} zipf={zipf} byz={byz:.3f}")

    for n, r, seed in COIN_CASES:
        case = coin_round_case(n, r, seed)
        coin = case["coin_bit"]
        verdicts = [kernels.decide_fame(*coin_fame_args(case, c, "cpu")) for c in (coin, ~coin)]
        if all(torch.equal(a, b) for a, b in zip(*verdicts)):
            raise AssertionError(f"coin case n={n} rounds={r} seed={seed}: the coin bits "
                                 "decide nothing, so no coin round is reached")
        for c in (coin, ~coin):
            args = coin_fame_args(case, c, dev)
            got, want = tuple(kernels.decide_fame(*args)), tuple(kernels._decide_fame_plain(*args))
            torch.cuda.synchronize()
            require_equal(f"decide_fame on coin case n={n} rounds={r} seed={seed}", got, want)
        log(f"decide_fame == plain on coin case n={n} rounds={r} seed={seed}, both coin "
            f"settings: coin round reached (flipping the coin bits changes the verdicts)")

    t0 = time.perf_counter()
    bench = synthetic_grid(BENCH["n"], BENCH["e_count"], seed=BENCH["seed"],
                           zipf_a=BENCH["zipf_a"], record_fd_updates=True)
    log(f"bench grid: {bench.n} validators, {bench.e} events, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    st = engine.stage_frontier(bench, dev)
    triples, (inv, fr, fame) = calls(bench, st, R_CAP)
    summary = {}
    for name, kern, plain in triples:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require_equal(f"{name} on the bench grid", got, want)
        summary[name] = {"max_abs_err": max_abs_err(got, want)}
        summary[name]["ms"] = cuda_ms(kern, 20)
        summary[name]["plain_ms"] = cuda_ms(plain, 5)
    log("kernels == plain on the bench grid")

    # the K3 tally as one batched 0/1 product, a yardstick the port never calls
    r_max, n = fr.witness_table.shape
    a = (torch.rand((r_max, n, n), device=dev) < 0.5).float()
    b = (torch.rand((r_max, n, n), device=dev) < 0.5).float()
    tally_bmm_ms = cuda_ms(lambda: torch.bmm(a, b), 20)

    # work bounds from this run's data (see PERF.md for the counting rules):
    # only the la rows the chain table names, the walk steps whose frontier
    # still holds a witness, and the la/fd rows of the witnesses present
    # (all of them for K3, the famous ones for K4)
    n, l = st.rows_by.shape
    e_b = st.la.shape[0]
    real_rows = int((st.rows_by >= 0).sum().item())
    valid_rounds = int((fr.witness_table >= 0).any(dim=1).sum().item())
    wvalid = fr.witness_table >= 0
    n_wit = int(wvalid.sum().item())
    n_pairs = int((wvalid[1:].sum(dim=1) * wvalid[:-1].sum(dim=1)).sum().item())
    n_famous = int((fame.decided & fame.famous & wvalid).sum().item())
    # K4's per-event scan: rounds round(e)+1 .. received(e), or up to the
    # horizon when nothing is received
    *_, horizon = kernels._received_tables(
        fr.witness_table, st.la, fame.decided, fame.famous, fame.rounds_decided,
        fr.last_round)
    recv = kernels._decide_round_received_plain(
        fr.witness_table, st.la, st.index, st.creator, fr.rounds, fame.decided,
        fame.famous, fame.rounds_decided, fr.last_round)
    start = (fr.rounds + 1).clamp(0, r_max - 1).long()
    stop = torch.where(recv >= 0, recv, horizon[start].clamp(max=r_max) - 1)
    scan_ops = int((stop - fr.rounds).clamp(min=0).sum().item())
    inv_bytes = inv.numel() * 4
    work = {
        "build_inv": (st.rows_by.numel() * 4 + real_rows * n * 4 + inv_bytes,
                      (real_rows * n + n * n * l) / ALU_OPS_S),
        "frontier_rounds": (
            min(inv_bytes, valid_rounds * (n ** 3 + n * n) * 4)
            + valid_rounds * n * n * 4 + st.rows_by.numel() * 4 + 3 * e_b * 4
            + e_b * 5 + R_CAP * n * 4 + 4,
            (valid_rounds * (n ** 3 + n * n) + e_b * valid_rounds) / ALU_OPS_S),
        "decide_fame": (
            r_max * n * 4 + n_wit * n * 4 * 2 + n_wit * 5 + 4
            + r_max * n * 2 + r_max,
            n_pairs * (n + 1) / ALU_OPS_S + valid_rounds * 2 * n ** 3 / INT8_TC_OPS_S),
        "round_received": (
            r_max * n * 4 + n_famous * n * 4 + r_max * n * 2 + r_max + 4
            + 3 * e_b * 4 + e_b * 4,
            (n_famous * n + scan_ops) / ALU_OPS_S),
    }
    log(f"bound inputs: {real_rows} chain rows, {valid_rounds} rounds with witnesses, "
        f"{n_wit} witnesses, {n_famous} famous")

    # 4. end to end
    t0 = time.perf_counter()
    cpu = engine.run_frontier_passes(bench, device="cpu")
    log(f"cpu reference run (plain versions): {time.perf_counter() - t0:.1f} s")
    _ext.reset_launches()
    res = engine.run_frontier_passes(bench, device=dev)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    require_same_results("end to end", res, cpu)
    if res.witness_table.shape != cpu.witness_table.shape:
        raise AssertionError("end to end: the round axes differ")
    n_received = int((res.received >= 0).sum())
    if res.last_round != BENCH_LAST_ROUND or n_received != BENCH_RECEIVED:
        raise AssertionError(
            f"end to end: last_round {res.last_round}, {n_received} received; "
            f"the reference gives {BENCH_LAST_ROUND} and {BENCH_RECEIVED}"
        )
    missing = [k for k in PATH_KERNELS["run_frontier_passes"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    log(f"end to end == cpu run; launches on the main path: {launches}")

    walls = []
    for _ in range(E2E_RUNS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_frontier_passes(bench, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls[2:])
    log(f"e2e run_frontier_passes: median {wall * 1e3:.3f} ms over {E2E_RUNS} warm runs, "
        f"{bench.e / wall:.0f} events/s, last_round {res.last_round}, "
        f"{n_received} received, card: {smi}")
    # the device share of that call: build_inv + the pipeline on staged tensors
    def device_pipeline():
        inv_d = frontier.build_inv(st.rows_by, st.la)
        return frontier.frontier_pipeline(
            inv_d, st.rows_by, st.creator, st.index, st.sp_index, st.la, st.fd,
            st.lamport, st.coin_bit, bench.super_majority, bench.n, R_CAP,
        )
    pipe_ms = cuda_ms(device_pipeline, E2E_RUNS)
    stage_walls = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        engine.stage_frontier(bench, dev)
        torch.cuda.synchronize()
        stage_walls.append(time.perf_counter() - t0)
    log(f"host staging + host-to-device copies (stage_frontier): median "
        f"{statistics.median(stage_walls) * 1e3:.3f} ms over {E2E_RUNS} runs")
    log(f"device pipeline (build_inv + frontier_pipeline, r_cap {R_CAP}, staged "
        f"inputs): median {pipe_ms:.3f} ms")
    log(f"tally yardstick: one torch.bmm of ({r_max}, {n}, {n}) 0/1 float32 "
        f"matrices {tally_bmm_ms:.4f} ms (never called by the port)")

    # 5. grids of the cold path
    t0 = time.perf_counter()
    deep = synthetic_deep_grid(CATCHUP["n"], CATCHUP["depth"], seed=CATCHUP["seed"],
                               zipf_a=CATCHUP["zipf_a"])
    if (deep.e, deep.num_levels) != CATCHUP_GRID:
        raise AssertionError(f"catch-up grid: {deep.e} events, {deep.num_levels} levels; "
                             f"expected {CATCHUP_GRID}")
    sec = section_grid(deep, engine.run_frontier_passes(deep, device=dev), deep.num_levels // 2)
    if (sec.e, sec.num_levels) != CATCHUP_SECTION:
        raise AssertionError(f"catch-up section: {sec.e} events, {sec.num_levels} levels; "
                             f"expected {CATCHUP_SECTION}")
    ug = synthetic_deep_grid(UNPINNED["n"], UNPINNED["depth"], seed=UNPINNED["seed"],
                             zipf_a=UNPINNED["zipf_a"])
    usec = section_grid(ug, engine.run_passes(ug, device=dev), ug.num_levels // 2,
                        pin_cut=False)
    log(f"catch-up grid: {deep.e} events, {deep.num_levels} levels; section "
        f"{sec.e} events, {sec.num_levels} levels; unpinned section {usec.e} events, "
        f"{usec.num_levels} levels; {time.perf_counter() - t0:.1f} s to build")

    # 6. the level scan's and the cold path's kernels against their plain
    #    versions, on the bench grid and both sections; timed on the bench
    #    grid and the catch-up section
    def compare(name, label, kern, plain, timed):
        _ext.reset_launches()
        got = kern()
        torch.cuda.synchronize()
        n_launch = _ext.LAUNCHES[name]
        want = plain()
        torch.cuda.synchronize()
        require_equal(f"{name} on the {label}", got, want)
        line = f"{name} == plain on the {label}: {n_launch} launches"
        if timed:
            k_ms = cuda_ms(kern, 10)
            p_ms = cuda_ms(plain, SLOW_PLAIN_REPS, warmup=1)
            line += f", {k_ms:.4f} ms, plain {p_ms:.3f} ms"
            if label == "catch-up section":
                summary[name] = {"max_abs_err": max_abs_err(got, want), "ms": k_ms,
                                 "plain_ms": p_ms}
        log(line)
        return got

    def as_tensors(out):
        return tuple(torch.tensor(x, device=dev) if isinstance(x, int) else x for x in out)

    cold = [("bench grid", bench), ("catch-up section", sec), ("unpinned section", usec)]
    for label, g in cold:
        timed = label != "unpinned section"
        gp, _, scan_r_max = engine.scan_layout(g, True)
        ins = engine.stage_scan(gp, dev)
        dr_args = ins[:13] + (gp.super_majority, scan_r_max)
        dr = compare("divide_rounds", label,
                     lambda: tuple(kernels.divide_rounds(*dr_args)),
                     lambda: tuple(kernels._divide_rounds_plain(*dr_args)), timed)
        lam_args = doubling.lamport_inputs(g, dev)
        compare("lamport_scan", label,
                lambda: doubling._lamport_levels_scan(*lam_args),
                lambda: doubling._lamport_levels_scan_plain(*lam_args), timed)
        cs = doubling.stage_doubling(g, dev)
        cl_args = (cs.creator_d, cs.idx_d, cs.sp_d, cs.op_d, cs.rows_by_d, cs.l_b,
                   cs.block, cs.pass_cap)
        if label != "unpinned section":
            cl = compare("closure_la", label,
                         lambda: as_tensors(doubling._closure_la(*cl_args)),
                         lambda: as_tensors(doubling._closure_la_plain(*cl_args)), timed)
        # every chunk of the walk, kernel against plain; the largest is timed
        inv_c = frontier.build_inv(cs.rows_by_d, cs.la_d)
        s_np, first_nw, x0 = doubling.walk_seeds(g, cs)
        chunks = []

        def walk(*a):
            got = doubling._walk_chunk(*a)
            want = doubling._walk_chunk_plain(*a)
            torch.cuda.synchronize()
            require_equal(f"walk_chunk (length {a[10]}) on the {label}", got, want)
            chunks.append(a)
            return got

        hist = doubling._doubling_walk(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), inv_c,
            cs.rows_by_d, cs.fd_d, cs.la_d, x0, s_np, first_nw, g.super_majority,
            cs.l_b, cs.seeded, {}, walk=walk)
        fired = sum(1 for c in range(g.n)
                    if 0 <= first_nw[c] < hist.shape[0] and hist[first_nw[c], c] == 0)
        if label == "unpinned section" and fired == 0:
            raise AssertionError("unpinned section: the first_nw mask never fired")
        big = max(chunks, key=lambda a: a[10])
        compare("walk_chunk", f"{label} (largest chunk, {big[10]} steps)",
                lambda: doubling._walk_chunk(*big), lambda: doubling._walk_chunk_plain(*big),
                False)
        if timed:
            k_ms = cuda_ms(lambda: doubling._walk_chunk(*big), 10)
            p_ms = cuda_ms(lambda: doubling._walk_chunk_plain(*big), SLOW_PLAIN_REPS, warmup=1)
            log(f"  walk_chunk on the {label}: {big[10]} steps x {big[11]} probes, "
                f"{k_ms:.4f} ms, plain {p_ms:.3f} ms")
        log(f"walk_chunk == plain on every chunk of the {label} "
            f"({', '.join(str(a[10]) for a in chunks)} steps, seeded {cs.seeded}); "
            f"first_nw mask fired on {fired} of {g.n} chains")
        if label != "catch-up section":
            continue
        summary["walk_chunk"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}

        # work bounds at the catch-up section's shapes, from this run's data
        def cpu(x):
            return x.cpu()

        n_s = g.n
        lv_c, _, _, sp_c, op_c, la_c, fd_c, esr_c, eor_c = (
            cpu(ins[i]) for i in (0, 1, 2, 3, 4, 5, 6, 7, 8))
        e_b = la_c.shape[0]
        last_lv = kernels.last_level(lv_c)
        used_level_bytes = (last_lv + 1) * lv_c.shape[1] * 4
        n_wit = int(dr[1].sum().item())
        pairs = scan_pair_count(lv_c, sp_c, op_c, esr_c, eor_c, cpu(dr[0]), cpu(dr[3]))
        work["divide_rounds"] = (
            used_level_bytes + g.e * (9 * 4 + n_s * 4) + n_wit * n_s * 4
            + e_b * 9 + scan_r_max * n_s * 4,
            (pairs * n_s + g.e * 4) / ALU_OPS_S)
        work["lamport_scan"] = (
            (kernels.last_level(cpu(lam_args[0])) + 1) * lam_args[0].shape[1] * 4
            + g.e * 5 * 4 + lam_args[1].shape[0] * 4,
            2 * g.e / ALU_OPS_S)
        la_fin, passes = cl
        l_c = cs.l_b
        la0 = doubling._closure_init(cs.creator_d, cs.idx_d, cs.sp_d, cs.op_d, n_s)
        nonneg_fin = int((la_fin >= 0).sum().item())
        nonneg_0 = int((la0 >= 0).sum().item())
        prefix_ops = n_s * l_c * n_s
        work["closure_la"] = (
            4 * cs.idx_d.shape[0] * 4 + n_s * l_c * 4 + la_fin.numel() * 4,
            (nonneg_fin * n_s + prefix_ops
             + (int(passes) - 1) * (nonneg_0 * n_s + prefix_ops)) / ALU_OPS_S)
        # walk: the timed chunk's working steps (frontier holding a row)
        x_before = torch.cat([big[4][None, :], doubling._walk_chunk_plain(*big)[1][:-1]])
        working = int((x_before < l_c).any(dim=1).sum().item())
        steps = big[11]
        step_bytes = n_s * n_s * 4 * 2 + n_s * steps * n_s * 4 + n_s * (steps + 1) * 4
        work["walk_chunk"] = (
            min(working * step_bytes, big[0].numel() * 4 + big[2].numel() * 4
                + big[3].numel() * 4 + big[1].numel() * 4)
            + big[5].numel() * 4 + big[6].numel() * 4 + big[10] * n_s * 4 + 3 * n_s * 4,
            working * (n_s * steps * n_s * n_s + n_s * n_s) / ALU_OPS_S)
        log(f"  bound inputs (catch-up section): {pairs} scan (event, witness) pairs, "
            f"{n_wit} witnesses, closure {int(passes)} passes with {nonneg_0} -> "
            f"{nonneg_fin} set coordinates, {working} working walk steps of {big[10]}")

    # 7. the bench grid through the level scan and the cold path
    bstats = {}
    dbl_b, _ = run_path("run_doubling_passes", lambda: doubling.run_doubling_passes(
        bench, stats=bstats, device=dev))
    require_same_results("run_doubling_passes on the bench grid", dbl_b, res)
    scan_b, _ = run_path("run_passes", lambda: engine.run_passes(
        bench, bucketed=True, adaptive_r=True, device=dev))
    require_same_results("run_passes on the bench grid", scan_b, res)
    got = {k: bstats[k] for k in BENCH_DOUBLING}
    if got != BENCH_DOUBLING:
        raise AssertionError(f"bench grid doubling stats {got}, expected {BENCH_DOUBLING}")
    for label, fn in (
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(bench, device=dev)),
        ("run_passes(bucketed, adaptive_r)", lambda: engine.run_passes(
            bench, bucketed=True, adaptive_r=True, device=dev)),
    ):
        ms = wall_ms(fn, E2E_RUNS)
        log(f"e2e {label} on the bench grid: median {ms:.3f} ms over {E2E_RUNS} warm runs, "
            f"{bench.e / ms * 1e3:.0f} events/s, card: {smi}")
    log(f"bench grid: the three engines agree field for field; last_round "
        f"{dbl_b.last_round}, {int((dbl_b.received >= 0).sum())} received, "
        f"closure passes {bstats['closure_passes']}, walk chunks {bstats['walk_chunks']}")

    # 8. the catch-up cell
    t0 = time.perf_counter()
    cpu_stats = {}
    cpu_d = doubling.run_doubling_passes(sec, stats=cpu_stats, device="cpu")
    cpu_s = engine.run_passes(sec, bucketed=True, adaptive_r=True, device="cpu")
    log(f"catch-up section on the CPU (plain versions): {time.perf_counter() - t0:.1f} s")
    sstats = {}
    dbl_s, launches_d = run_path("run_doubling_passes, seeded", lambda: doubling.run_doubling_passes(
        sec, stats=sstats, device=dev))
    scan_s, launches_s = run_path("run_passes", lambda: engine.run_passes(
        sec, bucketed=True, adaptive_r=True, device=dev))
    require_same_results("catch-up run_doubling_passes == CPU", dbl_s, cpu_d)
    require_same_results("catch-up run_passes == CPU", scan_s, cpu_s)
    require_same_results("catch-up run_doubling_passes == run_passes", dbl_s, scan_s)
    if sstats != cpu_stats:
        raise AssertionError(f"catch-up stats {sstats} != CPU {cpu_stats}")
    got = dict(last_round=dbl_s.last_round, round_offset=dbl_s.round_offset,
               received=int((dbl_s.received >= 0).sum()),
               closure_passes=sstats["closure_passes"], walk_chunks=sstats["walk_chunks"],
               passes=sstats["passes"])
    if got != CATCHUP_EXPECT:
        raise AssertionError(f"catch-up cell: {got}, the reference gives {CATCHUP_EXPECT}")
    log(f"catch-up cell: both engines == each other == CPU run; {got}")
    for label, fn in (
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(sec, device=dev)),
        ("run_passes(bucketed, adaptive_r)", lambda: engine.run_passes(
            sec, bucketed=True, adaptive_r=True, device=dev)),
    ):
        ms = wall_ms(fn, CATCHUP_RUNS)
        log(f"e2e catch-up {label}: median {ms:.3f} ms over {CATCHUP_RUNS} warm runs, "
            f"{sec.e / ms * 1e3:.0f} events ordered/s replaying the section from cold, "
            f"card: {smi}")
    launches["divide_rounds"] = launches_s["divide_rounds"]
    for k in ("closure_la", "walk_chunk", "lamport_scan"):
        launches[k] = launches_d[k]

    # 9. the incremental engine's kernels against their plain versions
    from babble_tpu_torch.tpu import incremental as inc

    sm, n = bench.super_majority, bench.n
    t0 = time.perf_counter()
    batches = inc.batches_from_grid(bench, INC_STEP["batch"], INC_STEP["upd_cap"],
                                    INC_STEP["e_cap"])
    trains = inc.trains_from_grid(bench, INC_TRAIN["size"], INC_TRAIN["upd_cap"],
                                  INC_TRAIN["e_cap"], t_cap=INC_TRAIN["t_cap"])
    if len(batches) != INC_BATCHES or [t.levels.shape[0] for t in trains] != INC_TRAIN_LEVELS:
        raise AssertionError(f"builders: {len(batches)} batches, train levels "
                             f"{[t.levels.shape[0] for t in trains]}; expected "
                             f"{INC_BATCHES} and {INC_TRAIN_LEVELS}")
    max_burst = max(int((b.upd_row < INC_STEP["e_cap"]).sum()) for b in batches)
    max_train_burst = max(int((t.upd_row < INC_TRAIN["e_cap"]).sum()) for t in trains)
    batches_d = [inc.device_put(b, dev) for b in batches]
    trains_d = [inc.device_put(t, dev) for t in trains]
    torch.cuda.synchronize()
    log(f"incremental inputs: {len(batches)} batches (largest fd burst {max_burst} of "
        f"{INC_STEP['upd_cap']}), {len(trains)} trains (levels "
        f"{[t.levels.shape[0] for t in trains]}, largest burst {max_train_burst} of "
        f"{INC_TRAIN['upd_cap']}); {time.perf_counter() - t0:.1f} s to build and copy")

    def step_calls(run, x, r_win, e_win, work):
        run.call("apply_deltas", lambda st: inc._apply_deltas_and_stage(st, x),
                 lambda st: inc._apply_deltas_and_stage_plain(st, x),
                 (lambda st: inc_work_deltas(st, x)) if work else None)
        run.call("step_levels", lambda st: inc._step_levels(st, x, sm_of[0]),
                 lambda st: inc._step_levels_plain(st, x, sm_of[0]),
                 (lambda st: inc_work_levels(st, x, True)) if work else None)
        decide_calls(run, r_win, e_win, work)

    def train_calls(run, x, r_win, e_win, work):
        run.call("apply_deltas", lambda st: inc._apply_deltas_and_stage(st, x),
                 lambda st: inc._apply_deltas_and_stage_plain(st, x),
                 (lambda st: inc_work_deltas(st, x)) if work else None)
        run.call("train_levels", lambda st: inc._train_levels(st, x, sm_of[0]),
                 lambda st: inc._train_levels_plain(st, x, sm_of[0]),
                 (lambda st: inc_work_levels(st, x, False)) if work else None)
        decide_calls(run, r_win, e_win, work)

    def decide_calls(run, r_win, e_win, work):
        run.call("decide_window",
                 lambda st: inc._decide_body(st, sm_of[0], n_of[0], r_win=r_win, e_win=e_win),
                 lambda st: inc._decide_body_plain(st, sm_of[0], n_of[0], r_win, e_win),
                 (lambda st: inc_work_decide(st, r_win, e_win)) if work else None)

    # the 8-validator fixture: the coin step lies in the unroll; with r_win 8
    # below r_cap 16 the window slides and freezes
    fx = INC_FIXTURE
    fgrid = synthetic_grid(fx["n"], fx["e"], seed=fx["seed"], zipf_a=fx["zipf_a"],
                           record_fd_updates=True)
    sm_of, n_of = [fgrid.super_majority], [fgrid.n]
    fb = [inc.device_put(b, dev) for b in inc.batches_from_grid(fgrid, fx["batch"], 8192, fx["e"])]
    # two no-op batches (the live engine's multi_step padding) at the end
    fb += [inc.device_put(inc.empty_batch(fgrid.n, fx["batch"], 8192, fx["e"]), dev)] * 2
    ft = [inc.device_put(t, dev) for t in inc.trains_from_grid(
        fgrid, fx["train"], 8192, fx["e"], w_cap=fx["w_cap"], t_cap=fx["t_cap"])]
    for r_cap, r_win in ((fx["r_cap"], 32), (16, 8)):
        run = PairedRun(f"8-validator grid, r_cap {r_cap}, r_win {r_win}",
                        inc.init_state(fgrid.n, fx["e"], r_cap, device=dev))
        for b in fb:
            step_calls(run, b, r_win, fx["e_win"], False)
        trun = PairedRun(run.label + ", trains", inc.init_state(fgrid.n, fx["e"], r_cap, device=dev))
        for t in ft:
            train_calls(trun, t, r_win, fx["e_win"], False)
        log(f"apply_deltas, step_levels, train_levels, decide_window == plain after every "
            f"call on the {run.label}: {len(fb)} batches, {len(ft)} trains, last_round "
            f"{int(run.k.last_round)}, stale {bool(run.k.stale)}")

    sm_of, n_of = [sm], [n]
    t0 = time.perf_counter()
    srun = PairedRun("live step shape", inc.init_state(
        n, INC_STEP["e_cap"], INC_STEP["r_cap"], device=dev))
    for b in batches_d:
        step_calls(srun, b, INC_STEP["r_win"], INC_STEP["e_win"], True)
    trun = PairedRun("train shape", inc.init_state(
        n, INC_TRAIN["e_cap"], INC_TRAIN["r_cap"], device=dev))
    for t in trains_d:
        train_calls(trun, t, INC_TRAIN["r_win"], INC_TRAIN["e_win"], True)
    log(f"apply_deltas, step_levels, train_levels, decide_window == plain after every call "
        f"at the live step shape ({len(batches_d)} batches) and the train shape "
        f"({len(trains_d)} trains): {time.perf_counter() - t0:.1f} s")
    inc_summary = {}
    for label, run, names in (("live step shape", srun, ("apply_deltas", "step_levels", "decide_window")),
                              ("train shape", trun, ("apply_deltas", "train_levels", "decide_window"))):
        for name in names:
            calls, k_ms, p_ms = run.times(name)
            nbytes, alu, tc = run.work[name]
            log(f"  {name} at the {label}: {calls} calls, kernel {k_ms:.3f} ms in all "
                f"({k_ms / calls:.4f} ms per call), plain {p_ms:.1f} ms in all; work "
                f"{nbytes} bytes, {alu} ALU and {tc} tensor-core operations in all")
            if label == "live step shape" or name == "train_levels":
                inc_summary[name] = (calls, k_ms, p_ms, nbytes, alu, tc)

    # 10. both append paths end to end
    e = bench.e
    scan_ref = engine.run_passes(bench, device=dev)

    def check_path(label, st):
        got = {f: getattr(st, f)[:e].cpu().numpy() for f in ("rounds", "lamport", "witness", "received")}
        for f, g in got.items():
            if not (g == getattr(scan_ref, f)).all():
                raise AssertionError(f"{label}: {f} differs from run_passes on the card")
        n_received = int((got["received"] >= 0).sum())
        res = dict(last_round=int(st.last_round), received=n_received,
                   witnesses=int(got["witness"].sum()), stale=bool(st.stale),
                   fame_lag=bool(st.fame_lag))
        want = dict(last_round=BENCH_LAST_ROUND, received=BENCH_RECEIVED,
                    witnesses=INC_WITNESSES, stale=False, fame_lag=False)
        if res != want:
            raise AssertionError(f"{label}: {res}, the reference gives {want}")
        return res

    empty = inc.device_put(inc.empty_batch(n, INC_STEP["batch"], INC_STEP["upd_cap"],
                                           INC_STEP["e_cap"]), dev)
    step_groups = []
    for i in range(0, len(batches_d), MULTI_STEP_K):
        group = batches_d[i : i + MULTI_STEP_K]
        k = 4 if len(group) <= 4 else MULTI_STEP_K
        group = group + [empty] * (k - len(group))
        step_groups.append(inc.Batch(*[torch.stack(f) for f in zip(*group)]))
    train_groups = [inc.device_put(inc.stack_trains(trains[i : i + MULTI_TRAIN_K]), dev)
                    for i in range(0, len(trains), MULTI_TRAIN_K)]
    torch.cuda.synchronize()
    st_cfg, tr_cfg = INC_STEP, INC_TRAIN
    append_paths = {
        "step": (st_cfg, lambda st: [inc.step(st, b, sm, n, r_win=st_cfg["r_win"],
                                              e_win=st_cfg["e_win"]) for b in batches_d]),
        "multi_step": (st_cfg, lambda st: [inc.multi_step(
            st, g, sm, n, r_win=st_cfg["r_win"], e_win=st_cfg["e_win"]) for g in step_groups]),
        "train_step": (tr_cfg, lambda st: [inc.train_step(
            st, t, sm, n, r_win=tr_cfg["r_win"], e_win=tr_cfg["e_win"]) for t in trains_d]),
        "multi_train": (tr_cfg, lambda st: [inc.multi_train(
            st, g, sm, n, r_win=tr_cfg["r_win"], e_win=MULTI_TRAIN_E_WIN)
            for g in train_groups]),
    }
    inc_launches = {}
    for label, (cfg, drive) in append_paths.items():
        st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
        torch.cuda.synchronize()
        _, path_launches = run_path(label, lambda: drive(st))
        res = check_path(label, st)
        inc_launches[label] = path_launches
        walls = []
        for _ in range(INC_RUNS + 2):
            st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive(st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check_path(label, st)
        wall = statistics.median(walls[2:])
        log(f"e2e {label} on the bench grid: median {wall * 1e3:.3f} ms over {INC_RUNS} warm "
            f"runs, {e / wall:.0f} events appended/s; {res}; card: {smi}")
    st = inc.init_state(n, tr_cfg["e_cap"], tr_cfg["r_cap"], device=dev)
    for g in train_groups:
        inc.multi_train(st, g, sm, n, r_win=tr_cfg["r_win"], e_win=tr_cfg["e_win"])
    got = dict(stale=bool(st.stale), fame_lag=bool(st.fame_lag),
               received=int((st.received >= 0).sum()))
    if got != MULTI_TRAIN_UNDERSIZED:
        raise AssertionError(f"multi_train at e_win {tr_cfg['e_win']}: {got}, the reference "
                             f"gives {MULTI_TRAIN_UNDERSIZED}")
    log(f"multi_train at e_win {tr_cfg['e_win']} (undersized for a decide per "
        f"{MULTI_TRAIN_K} trains): {got}, as the reference")
    launches["apply_deltas"] = inc_launches["step"]["apply_deltas"]
    launches["step_levels"] = inc_launches["step"]["step_levels"]
    launches["decide_window"] = inc_launches["step"]["decide_window"]
    launches["train_levels"] = inc_launches["train_step"]["train_levels"]
    for name, (calls, k_ms, p_ms, nbytes, alu, tc) in inc_summary.items():
        summary[name] = {"max_abs_err": 0, "ms": k_ms / calls, "plain_ms": p_ms / calls}
        work[name] = (nbytes / calls, (alu / ALU_OPS_S + tc / INT8_TC_OPS_S) / calls)


    out = []
    for name, (source, replaces) in REPLACES.items():
        nbytes, ops_s = work[name]
        bytes_s = nbytes / HBM_BYTES_S
        s = summary[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": None,
        })
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
