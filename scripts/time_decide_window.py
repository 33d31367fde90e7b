#!/usr/bin/env python3
"""Time the decide_window kernel (K12, windowed fame and round received of
the incremental engine) of one checkout of the PyTorch/CUDA port on one
CUDA card, call by call and launch by launch.

    python3 scripts/time_decide_window.py [--root DIR] [--reps N] [--device cuda|cpu]
                                          [--shapes LABEL,...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels and drives the append path (`step`'s three
kernels) over a grid's batches; at evenly spaced batches it takes the state
just before the decide and times the decide on it: every rep restores the
fields the decide writes, runs between two CUDA events behind a spin, and
is held to the plain version's state (torch.equal, every field). Shapes:
the bench cell's step state (64 validators, r_win 64, wide), the switch
cell's live shape (128, packed), BASELINE.json config #4's step state (256,
e_win 65,536, packed), config #5's width (1,024 validators, 16,384 events,
r_win 32, packed) and `coin_round_case(1024, 6, 3)`'s voting tables (both
layouts). Prints one JSON line per shape: the mean over the sampled states
of the median kernel ms, the plain version's ms, the bound
(chip_smoke.inc_work_decide), the per-launch split (`dw_setup`, `dw_vote`,
`dw_tables`, `dw_events`: device time from torch.profiler, null where it
records none), and the card's name and power limit. The grids are kept in
--cache (default build/timing_cache) so that later runs skip the host
grid builder.

To compare two versions, run it against both checkouts in one call, in
the order A, B, B, A (README.md shows the command). `--device
cpu` rehearses it on the plain versions (wall-clock times, no split).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_CYCLES = 1_000_000
LAUNCH_NAMES = ("dw_setup", "dw_vote", "dw_tables", "dw_events")
# the fields a decide writes, restored before every timed rep
WRITTEN = ("fame_decided", "famous", "rounds_decided", "received", "stale", "fame_lag")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def shapes(cs):
    """(label, grid spec, step config, packed, sampled states)."""
    width = dict(batch=cs.FL_WIDTH_BATCH, e_cap=cs.FL_WIDTH["e_count"], r_cap=32, r_win=32,
                 e_win=cs.FL_WIDTH["e_count"])
    return (
        ("bench step state", cs.BENCH, cs.INC_STEP, False, 8),
        ("switch state", cs.SWITCH, cs.SWITCH_STEP, True, 8),
        ("config #4 state", cs.WIDE, cs.WIDE_STEP, True, 8),
        ("width state", cs.FL_WIDTH, width, True, 4),
        ("coin case", None, None, None, 1),
    )


def cached_grid(spec, path):
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    from babble_tpu_torch.tpu.grid import synthetic_grid

    g = synthetic_grid(spec["n"], spec["e_count"], seed=spec["seed"], zipf_a=spec["zipf_a"],
                       byzantine_frac=spec.get("byzantine_frac", 0.0), record_fd_updates=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(g, f, protocol=pickle.HIGHEST_PROTOCOL)
    return g


def profiled_split(fn, calls):
    """Device ms per call of each of the decide's launches, by kernel name,
    from torch.profiler over `calls` calls of fn; None where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(LAUNCH_NAMES, 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        for name in LAUNCH_NAMES:
            if name in evt.key:
                split[name] += us / 1e3 / calls
    if not any(split.values()):
        return None
    return split


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="comma-separated labels (default: all)")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    cs = load_chip_smoke()
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("time_decide_window: no CUDA device", file=sys.stderr)
            return 1
        card = card_name()
        _ext.build_all()

    def timed(fn):
        if not cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def time_state(label, snap, sm, n_part, r_win, e_win, packed):
        """(median kernel ms, plain ms, split, work) of the decide on state
        snap, every rep held to the plain version."""
        want = inc.clone_state(snap)
        plain_ms = timed(lambda: inc._decide_body_plain(want, sm, n_part, r_win, e_win,
                                                        packed=packed))
        work = cs.inc_work_decide(want, r_win, e_win)
        st = inc.clone_state(snap)

        def restore():
            for f in WRITTEN:
                getattr(st, f).copy_(getattr(snap, f))

        def call():
            inc._decide_body(st, sm, n_part, r_win=r_win, e_win=e_win, packed=packed)

        times = []
        for k in range(args.reps + 2):
            restore()
            ms = timed(call)
            bad = cs.state_diff(st, want)
            if bad:
                raise AssertionError(f"decide_window on the {label}: {bad} differ from the "
                                     f"plain version")
            if k >= 2:
                times.append(ms)
        split = None
        if cuda:
            def restored_call():
                restore()
                call()
            split = profiled_split(restored_call, 3)
        return statistics.median(times), plain_ms, split, work

    wanted = {s for s in args.shapes.split(",") if s}
    for label, spec, cfg, packed, samples in shapes(cs):
        if wanted and label not in wanted:
            continue
        rows = []
        if spec is None:  # the coin case's voting tables, both layouts
            case = cs.coin_round_case(*cs.FL_WIDTH_COIN)
            snap = cs.coin_case_state(case, dev)
            r, n = snap.wtable.shape
            for pk in (True, False):
                rows.append((pk, time_state(f"{label} {cs.FL_WIDTH_COIN}", snap,
                                            case["super_majority"], n, r, r * n, pk)))
            r_win, e_win, n_calls = r, r * n, 0
        else:
            key = label.replace(" ", "_").replace("#", "")
            g = cached_grid(spec, os.path.join(args.cache, f"decide_window_{key}.pkl"))
            sm, n = g.super_majority, g.n
            upd_cap = cfg.get("upd_cap", cfg["e_cap"])
            while True:
                try:
                    batches = inc.batches_from_grid(g, cfg["batch"], upd_cap, cfg["e_cap"])
                    break
                except ValueError:  # a burst above the cap
                    upd_cap *= 2
            r_win, e_win = cfg["r_win"], cfg["e_win"]
            st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
            n_calls = len(batches)
            picks = {n_calls * (k + 1) // samples - 1 for k in range(samples)}
            for k, b in enumerate(batches):
                b = inc.device_put(b, dev)
                inc._step_body(st, b, sm, n, packed=packed)
                if k in picks:
                    rows.append((packed, time_state(f"{label}, batch {k}", inc.clone_state(st),
                                                    sm, n, r_win, e_win, packed)))
                inc._decide_body(st, sm, n, r_win=r_win, e_win=e_win, packed=packed)
            del g, batches
        for pk in sorted({p for p, _ in rows}, reverse=True):
            got = [x for p, x in rows if p == pk]
            splits = [s for _, _, s, _ in got if s is not None]
            nbytes = statistics.mean(w[0] for _, _, _, w in got)
            ops_s = statistics.mean(w[1] / cs.ALU_OPS_S + w[2] / cs.INT8_TC_OPS_S
                                    for _, _, _, w in got)
            print(json.dumps({
                "kernel": "decide_window", "shape": label, "packed": pk,
                "validators": int(snap.wtable.shape[1]) if spec is None else spec["n"],
                "r_win": r_win, "e_win": e_win, "states": len(got), "path_calls": n_calls,
                "ms": statistics.mean(x[0] for x in got), "reps": args.reps,
                "plain_ms": statistics.mean(x[1] for x in got),
                "split_ms": ({k: statistics.mean(s[k] for s in splits) for k in LAUNCH_NAMES}
                             if splits else None),
                "bound_ms": max(nbytes / cs.HBM_BYTES_S, ops_s) * 1e3,
                "bound_by": "bytes" if nbytes / cs.HBM_BYTES_S >= ops_s else "operations",
                "root": args.root, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
