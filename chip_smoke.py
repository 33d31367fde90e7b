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
   count above zero, and the median wall time over warm runs.

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

REPLACES = {
    "build_inv": ("babble_tpu_torch/csrc/build_inv.cu", "babble_tpu/tpu/frontier.py:116"),
    "frontier_rounds": ("babble_tpu_torch/csrc/frontier_walk.cu", "babble_tpu/tpu/frontier.py:299"),
    "decide_fame": ("babble_tpu_torch/csrc/decide_fame.cu", "babble_tpu/tpu/kernels.py:335"),
    "round_received": ("babble_tpu_torch/csrc/round_received.cu", "babble_tpu/tpu/kernels.py:424"),
}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() over reps runs, each between two CUDA
    events, after two warm-up runs."""
    for _ in range(2):
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
    the real rounds (the adaptive round axis may size them differently)."""
    if got.last_round != want.last_round:
        raise AssertionError(f"{what}: last_round {got.last_round} != {want.last_round}")
    k = want.last_round + 1
    for field in ("rounds", "witness", "lamport", "received", "witness_table",
                  "fame_decided", "famous", "rounds_decided"):
        g, w = getattr(got, field), getattr(want, field)
        if field in ("witness_table", "fame_decided", "famous", "rounds_decided"):
            g, w = g[:k], w[:k]
        if g.shape != w.shape or g.dtype != w.dtype or not (g == w).all():
            raise AssertionError(f"{what}: {field} differs from the CPU run")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from babble_tpu_torch.tpu import _ext, engine, frontier, kernels
    from babble_tpu_torch.tpu.grid import synthetic_grid

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
    missing = [k for k, v in launches.items() if v == 0]
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
