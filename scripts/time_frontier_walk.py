#!/usr/bin/env python3
"""Time K2 `frontier_rounds` (the one-shot engine's frontier walk and post
pass) and K15 `frontier_window` (the frontier-live engine's windowed walk,
post pass and witness tables) of one checkout of the PyTorch/CUDA port on
one CUDA card, call by call.

    python3 scripts/time_frontier_walk.py [--root DIR] [--reps N] [--device cuda|cpu]
                                          [--shapes LABEL;...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. Shapes:

- K2 on the bench cell (64 validators, 32,768 events), BASELINE.json
  config #4 (256 validators, 65,536 events) and the width cell (1,024
  validators, 16,384 events), each staged as run_frontier_passes stages it
  (`engine.stage_frontier`, K1 for INV) at the engine's round axis, 64 on
  all three (`engine._adaptive_r_loop`'s floor min(n, 64));
- K15 over the trains of chip_smoke.py's phase 16: the bench cell's 4
  trains of 8,192 (l_cap 4,096, r_cap 128), config #4's 8 trains (l_cap
  from its hottest chain, r_cap 32) and the width cell's 2 (r_cap 32).
  Each train is appended (K14) to a frontier-live state, K15 is called on
  the appended state, and the state then takes the decide, as
  frontier_train_step does.

Every call's result is held torch.equal to the plain version
(`_frontier_rounds_plain`, `_decide_window_plain`) before a time is
printed. One JSON line per call (per train for K15): the steps the walk
computes before its fixed point beside the steps it may take (the plain
walk's history, `chip_smoke.walk_steps`), kernel launches per call by
kernel name and memsets / copies per call (torch.profiler, null where it
records no device event), and medians over --reps calls of the CUDA-event
ms of the whole call behind a spin (the card busy while the host enqueues:
the kernels' time), the device ms of its kernels summed (torch.profiler),
and the host wall ms of the call ending in a synchronize; the plain
version's ms, the bound (`chip_smoke.frontier_rounds_work`,
`chip_smoke.fl_work_window`) and the card's name and power limit. The
grids and trains are kept in --cache (default build/timing_cache), so
that later runs skip the host grid builder.

To compare two versions, run it against both checkouts in one call, in
the order A, B, B, A (README.md shows the command). `--device cpu`
rehearses it on the plain versions (host-clock times, no kernel ms).
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
K2_R_CAP = 64


def load_chip_smoke():
    """chip_smoke.py of this script's checkout, for its cell constants and
    work counts (its own imports of the port happen inside its functions,
    so they resolve to --root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]


def shapes(cs):
    """(label, kernel, grid spec, K15 train settings or None)."""
    return (
        ("K2 bench cell", "K2", cs.BENCH, None),
        ("K2 config #4", "K2", cs.WIDE, None),
        ("K2 width cell", "K2", cs.FL_WIDTH, None),
        ("K15 bench trains", "K15", cs.BENCH,
         dict(train=cs.INC_TRAIN["size"], upd_cap=cs.INC_TRAIN["upd_cap"],
              e_cap=cs.INC_TRAIN["e_cap"], t_cap=cs.INC_TRAIN["t_cap"],
              l_cap=cs.FL_BENCH["l_cap"], r_cap=cs.FL_BENCH["r_cap"])),
        ("K15 config #4 trains", "K15", cs.WIDE,
         dict(train=cs.FL_WIDE["train"], upd_cap=cs.FL_WIDE["upd_cap"],
              e_cap=cs.FL_WIDE_INC["e_cap"], t_cap=cs.FL_WIDE["t_cap"],
              l_margin=cs.FL_WIDE["l_margin"], r_cap=cs.FL_WIDE["r_cap"])),
        ("K15 width trains", "K15", cs.FL_WIDTH,
         dict(train=cs.FL_WIDTH_TRAIN, upd_cap=1 << 24, e_cap=None, t_cap=832, l_margin=32,
              r_cap=32)),
    )


def cached(cache, key, make):
    """make(), kept on disk under --cache by key."""
    path = os.path.join(cache, f"frontier_walk_{key}.pkl".replace("/", "_").replace(" ", "_"))
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    out = make()
    os.makedirs(cache, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return out


def grid_of(spec, cache):
    """synthetic_grid(spec) with its fd updates recorded."""
    from babble_tpu_torch.tpu.grid import synthetic_grid

    key = "_".join(str(spec[k]) for k in sorted(spec))
    return cached(cache, f"grid_{key}", lambda: synthetic_grid(
        spec["n"], spec["e_count"], seed=spec["seed"], zipf_a=spec["zipf_a"],
        byzantine_frac=spec.get("byzantine_frac", 0.0), record_fd_updates=True))


class Timer:
    """CUDA-event times behind a spin on the card and host walls ending in a
    synchronize; the host clock alone on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def events(self, fn) -> float:
        if not self.cuda:
            return self.wall(fn)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def wall(self, fn) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if self.cuda:
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def profile_calls(fn, calls):
    """(device ms per call of the call's kernels, kernel launches per call by
    kernel name, memsets and copies per call) from torch.profiler over
    `calls` calls of fn; (None, None, None) where it records no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, kernels, copies = 0.0, {}, 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        if evt.key.startswith(("Memset", "Memcpy")):
            copies += evt.count
            continue
        name = evt.key.split("(")[0].replace("void ", "").strip()
        kernels[name] = kernels.get(name, 0) + evt.count / calls
        t = getattr(evt, "device_time_total", None)
        us += getattr(evt, "cuda_time_total", 0.0) if t is None else t
    if not kernels:
        return None, None, None
    return us / 1e3 / calls, kernels, copies / calls


def frontier_history(inv, rows_by, fd, la, super_majority, r_cap):
    """The plain walk's history X(0 .. r_cap - 1), composed from pieces
    every checkout since the port began has."""
    from babble_tpu_torch.tpu.frontier import frontier_x0, make_walk_step

    step = make_walk_step(inv, rows_by, fd, la, super_majority)
    x = frontier_x0(rows_by)
    rows = []
    for _ in range(r_cap):
        rows.append(x)
        x = step(x)
    return torch.stack(rows)


def measure(label, kern, want, timer, reps, extra):
    """Time kern() (reps calls of each clock), every result held
    torch.equal to want; one JSON line with extra."""
    checked = [0]

    def check(got):
        got = tuple(got)
        bad = [k for k, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        if bad or len(got) != len(want):
            raise AssertionError(f"{label}, call {checked[0]}: fields {bad} differ from the "
                                 f"plain version")
        checked[0] += 1

    out = [None]

    def call():
        out[0] = kern()

    def timed(clock):
        ms = clock(call)
        check(out[0])
        return ms

    timed(timer.wall)  # the first launch, its module's loading, untimed
    event_ms = [timed(timer.events) for _ in range(reps)]
    wall_ms = [timed(timer.wall) for _ in range(reps)]
    k_ms, launches, copies = profile_calls(call, reps) if timer.cuda else (None, None, None)
    check(out[0])
    line = dict(extra)
    line.update({"launches_per_call": launches, "memsets_and_copies_per_call": copies,
                 "calls_checked": checked[0], "event_ms": statistics.median(event_ms),
                 "kernel_ms": k_ms, "wall_ms": statistics.median(wall_ms)})
    return line


def k2_shape(cs, label, spec, dev, timer, args, card):
    from babble_tpu_torch.tpu import engine, frontier

    g = grid_of(spec, args.cache)
    st = engine.stage_frontier(g, dev)
    inv = frontier.build_inv(st.rows_by, st.la)
    sm = g.super_majority
    k_args = (inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, K2_R_CAP)
    want = tuple(frontier._frontier_rounds_plain(*k_args, la=st.la))
    plain_ms = timer.events(lambda: frontier._frontier_rounds_plain(*k_args, la=st.la))
    hist = frontier_history(inv, st.rows_by, st.fd, st.la, sm, K2_R_CAP)
    nbytes, ops_s = cs.frontier_rounds_work(inv, st, sm, hist)
    bytes_s = nbytes / cs.HBM_BYTES_S
    line = measure(label, lambda: frontier.frontier_rounds(*k_args), want, timer, args.reps, {
        "kernel": "frontier_rounds", "shape": label, "validators": g.n, "events": g.e,
        "steps": cs.walk_steps([hist]), "max_steps": K2_R_CAP - 1, "r_cap": K2_R_CAP})
    line.update({"plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
                 "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                 "reps": args.reps, "root": args.root, "card": card})
    print(json.dumps(line), flush=True)


def k15_shape(cs, label, spec, cfg, dev, timer, args, card):
    from babble_tpu_torch.tpu import frontier_live as fl
    from babble_tpu_torch.tpu import incremental as inc

    g = grid_of(spec, args.cache)
    e_cap = cfg["e_cap"] or g.e
    trains = cached(args.cache, f"trains_{label}_{g.n}_{g.e}", lambda: inc.trains_from_grid(
        g, cfg["train"], cfg["upd_cap"], e_cap, t_cap=cfg["t_cap"]))
    l_cap = cfg.get("l_cap") or cs.least_pow2(int(g.index.max()) + 1 + cfg["l_margin"])
    sm, n = g.super_majority, g.n
    r_cap = cfg["r_cap"]
    r_win = min(fl.R_WIN, r_cap)
    st = fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev)
    packed = n >= 128  # the voting layout the knob's auto takes (packed from 128)
    for k, t in enumerate(trains):
        t = inc.device_put(t, dev)
        fl._append_train(st, t)
        want = tuple(fl._decide_window_plain(st, sm))
        plain_ms = timer.events(lambda: fl._decide_window_plain(st, sm))
        win = fl.WindowResult(*want)
        start = cs.window_start(st, r_win)
        nbytes, alu, _ = cs.fl_work_window(st, win, sm)
        bytes_s, ops_s = nbytes / cs.HBM_BYTES_S, alu / cs.ALU_OPS_S
        line = measure(f"{label}, train {k}", lambda: fl._decide_window(st, sm), want, timer,
                       args.reps, {
                           "kernel": "frontier_window", "shape": label, "train": k,
                           "validators": n, "events": g.e, "r_cap": r_cap, "r_win": r_win,
                           "window_start": start,
                           "steps": cs.walk_steps([win.x_hist[start:start + r_win]], r_win),
                           "max_steps": r_win})
        line.update({"plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
                     "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                     "r_over": bool(win.r_over), "reps": args.reps, "root": args.root,
                     "card": card})
        print(json.dumps(line), flush=True)
        fl._assign(st, fl._decide_from(st, win, sm, n, packed))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="labels separated by ';' (default: all)")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    cs = load_chip_smoke()
    from babble_tpu_torch.tpu import _ext

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = card_name()
        _ext.build_all()
    wanted = {s for s in args.shapes.split(";") if s}
    timer = Timer(dev)
    for label, kernel, spec, cfg in shapes(cs):
        if wanted and label not in wanted:
            continue
        if kernel == "K2":
            k2_shape(cs, label, spec, dev, timer, args, card)
        else:
            k15_shape(cs, label, spec, cfg, dev, timer, args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
