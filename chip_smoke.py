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
   from cold (32,760 / the median wall time).

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

REPLACES = {
    "build_inv": ("babble_tpu_torch/csrc/build_inv.cu", "babble_tpu/tpu/frontier.py:116"),
    "frontier_rounds": ("babble_tpu_torch/csrc/frontier_walk.cu", "babble_tpu/tpu/frontier.py:299"),
    "decide_fame": ("babble_tpu_torch/csrc/decide_fame.cu", "babble_tpu/tpu/kernels.py:335"),
    "round_received": ("babble_tpu_torch/csrc/round_received.cu", "babble_tpu/tpu/kernels.py:424"),
    "divide_rounds": ("babble_tpu_torch/csrc/divide_rounds.cu", "babble_tpu/tpu/kernels.py:118"),
    "closure_la": ("babble_tpu_torch/csrc/closure_la.cu", "babble_tpu/tpu/doubling.py:172"),
    "walk_chunk": ("babble_tpu_torch/csrc/walk_chunk.cu", "babble_tpu/tpu/doubling.py:296"),
    "lamport_scan": ("babble_tpu_torch/csrc/lamport_scan.cu", "babble_tpu/tpu/doubling.py:443"),
}
# the kernels each engine's call must launch
PATH_KERNELS = {
    "run_frontier_passes": ("build_inv", "frontier_rounds", "decide_fame", "round_received"),
    "run_passes": ("divide_rounds", "decide_fame", "round_received"),
    "run_doubling_passes": ("closure_la", "build_inv", "walk_chunk", "decide_fame",
                            "round_received"),
    "run_doubling_passes, seeded": ("closure_la", "build_inv", "walk_chunk", "lamport_scan",
                                    "decide_fame", "round_received"),
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
                           zipf_a=BENCH["zipf_a"])
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
