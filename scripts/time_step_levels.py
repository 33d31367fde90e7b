#!/usr/bin/env python3
"""Time the step_levels kernel (K10, the within-batch level scan of the
incremental engine's append path) of one checkout of the PyTorch/CUDA
port on one CUDA card, call by call.

    python3 scripts/time_step_levels.py [--root DIR] [--reps N] [--device cuda|cpu]
                                        [--shapes LABEL,...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels and drives the append path over a grid's
batches (apply_deltas, step_levels, the decide). Before each batch's
step_levels it keeps the fields the call writes; the plain version runs
once on a clone, then every walk of the checkout's `_ext.step_levels`
that can run the shape ("block", "grid" where it takes `form=`, else its
default) runs --reps times on the kept fields, each launch between two
CUDA events behind a spin (the card busy while the host enqueues) and
held torch.equal to the plain version's state, every field. Shapes: the
bench cell's step state (64 validators, wide), the bench grid's generator
at 32, 48 and 96 validators (around the crossover of the two walks), the
switch state (128, packed), BASELINE.json config #4's step state (256,
packed) and config #5's width (1,024 validators, 16,384 events, packed).
Prints one JSON line per shape and walk: the kernel ms per call (mean and
median over the calls, each the median of its reps), the split by launch
at the middle call (device ms of the walk, K11's compare-copy fill and
the grid scratch's memset, from torch.profiler; null where it records
none), the plain version's ms per call, the mean walked levels per
call, the bound
(chip_smoke.inc_work_levels: each input read once, the compares at the
ALU rate), the launch keys counted, and the card's name and power limit.
The grids are kept in --cache (default build/timing_cache), shared with
scripts/time_train_levels.py, so that later runs skip the host grid
builder.

To compare two versions, run it against both checkouts in one call, in
the order A, B, B, A (README.md shows the command). `--device cpu`
rehearses it on the plain versions (wall-clock times).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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
# the fields a level-scan call writes, restored before every timed rep
WRITTEN = ("rounds", "lamport", "witness", "wtable", "w_of_row", "la_w", "fd_w", "idx_w",
           "coin_w", "last_round", "count", "stale")
# the device work of a call, by kernel name: the walks, K11's compare-copy
# fill, and the memset of K10's grid scratch
LAUNCH_NAMES = ("sl_walk", "sl_grid", "tl_init", "tl_walk", "tl_grid", "Memset")


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


def grid_specs(cs):
    """(label, grid spec, packed) of the timed shapes, shared with
    time_train_levels.py."""
    return (
        ("bench state", cs.BENCH, False),
        ("32-validator grid", dict(cs.BENCH, n=32), False),
        ("48-validator grid", dict(cs.BENCH, n=48), False),
        ("96-validator grid", dict(cs.BENCH, n=96), False),
        ("switch state", cs.SWITCH, True),
        ("config #4 state", cs.WIDE, True),
        ("width state", cs.FL_WIDTH, True),
    )


def step_config(cs, label, g):
    """(batch, e_cap, r_cap, r_win, e_win, upd_cap) of a shape's step path,
    as chip_smoke.py drives it."""
    if label == "switch state":
        c = cs.SWITCH_STEP
    elif label == "config #4 state":
        c = dict(cs.WIDE_STEP, upd_cap=cs.WIDE_STEP["e_cap"])
    elif label == "width state":
        return cs.FL_WIDTH_BATCH, g.e, 32, 32, g.e, g.e
    else:
        c = cs.INC_STEP
    return c["batch"], c["e_cap"], c["r_cap"], c["r_win"], c["e_win"], c["upd_cap"]


def cached_grid(spec, cache):
    """synthetic_grid(spec) with fd updates, kept on disk under --cache."""
    key = "_".join(str(spec[k]) for k in sorted(spec))
    path = os.path.join(cache, f"grid_{key}.pkl".replace("/", "_"))
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    from babble_tpu_torch.tpu.grid import synthetic_grid

    g = synthetic_grid(spec["n"], spec["e_count"], seed=spec["seed"], zipf_a=spec["zipf_a"],
                       byzantine_frac=spec.get("byzantine_frac", 0.0), record_fd_updates=True)
    os.makedirs(cache, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(g, f, protocol=pickle.HIGHEST_PROTOCOL)
    return g


def walked_levels(levels) -> int:
    """Levels a call walks: up to the last one that holds an event."""
    rows = torch.nonzero((levels >= 0).any(dim=1))
    return int(rows[-1]) + 1 if rows.numel() else 0


class Timer:
    """CUDA-event times behind a spin on the card, the host clock on the
    CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __call__(self, fn) -> float:
        if not self.cuda:
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


def forms_of(wrapper, cuda):
    """The walks a checkout's wrapper can be asked for: ("block", "grid")
    where it takes `form=`, else its default (None)."""
    if cuda and "form" in inspect.signature(wrapper).parameters:
        return ("block", "grid")
    return (None,)


def profiled_split(fn, calls):
    """Device ms per call of each of LAUNCH_NAMES, from torch.profiler over
    `calls` calls of fn; None where the profiler recorded no device time."""
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
    split = {k: v for k, v in split.items() if v}
    return split or None


def time_calls(cs, label, xs, st, plain, kern, forms, decide, rounds_scan, reps, timer):
    """Drive state st over inputs xs: K9, then for each call the plain
    version once on a clone and kern(st, x, form) `reps` times for each
    walk on st's kept fields, every launch held torch.equal to the plain
    state; at the middle call also the split by launch (profiled_split);
    then the decide. Returns {form: (kernel ms per call, median, launches,
    split)} and (plain ms per call, mean levels, bound ms, bound_by)."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    per_form = {f: [] for f in forms}
    launched = {f: {} for f in forms}
    split = dict.fromkeys(forms)
    plain_ms, levels, nbytes, alu = [], [], 0, 0
    for k, x in enumerate(xs):
        inc._apply_deltas_and_stage(st, x)
        kept = {f: getattr(st, f).clone() for f in WRITTEN}
        want = inc.clone_state(st)
        plain_ms.append(timer(lambda: plain(want, x)))
        for form in forms:
            times = []
            for _ in range(reps):
                for f in WRITTEN:
                    getattr(st, f).copy_(kept[f])
                before = dict(_ext.LAUNCHES)
                times.append(timer(lambda: kern(st, x, form)))
                for name, v in _ext.LAUNCHES.items():
                    if v != before[name]:
                        launched[form][name] = launched[form].get(name, 0) + v - before[name]
                bad = cs.state_diff(st, want)
                if bad:
                    raise AssertionError(f"{label}, call {k}, form {form}: {bad} differ from "
                                         f"the plain version")
            per_form[form].append(statistics.median(times))
            if timer.cuda and k == len(xs) // 2:
                def restored_call():
                    for f in WRITTEN:
                        getattr(st, f).copy_(kept[f])
                    kern(st, x, form)
                split[form] = profiled_split(restored_call, reps)
        work = cs.inc_work_levels(st, x, rounds_scan)
        nbytes += work[0]
        alu += work[1]
        levels.append(walked_levels(x.levels))
        decide(st)
    calls = len(xs)
    bytes_s, ops_s = nbytes / calls / cs.HBM_BYTES_S, alu / calls / cs.ALU_OPS_S
    out = {f: (statistics.mean(t), statistics.median(t), launched[f], split[f])
           for f, t in per_form.items()}
    return out, (statistics.mean(plain_ms), statistics.mean(levels), max(bytes_s, ops_s) * 1e3,
                 "bytes" if bytes_s >= ops_s else "operations")


def setup(description):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="comma-separated labels (default: all)")
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
    wanted = {s for s in args.shapes.split(",") if s}
    return args, cs, dev, card, wanted


def main() -> int:
    args, cs, dev, card, wanted = setup(__doc__.split("\n\n")[0])
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    timer = Timer(dev)
    for label, spec, packed in grid_specs(cs):
        if wanted and label not in wanted:
            continue
        g = cached_grid(spec, args.cache)
        sm, n = g.super_majority, g.n
        batch, e_cap, r_cap, r_win, e_win, upd_cap = step_config(cs, label, g)
        while True:
            try:
                batches = inc.batches_from_grid(g, batch, upd_cap, e_cap)
                break
            except ValueError:  # a burst above the cap
                upd_cap *= 2
        xs = [inc.device_put(b, dev) for b in batches]
        st = inc.init_state(n, e_cap, r_cap, device=dev)

        def kern(st, x, form):
            if not timer.cuda:
                inc._step_levels(st, x, sm, packed=packed)
                return
            _ext.step_levels(
                st.fd, st.rounds, st.lamport, st.witness, st.wtable, st.w_of_row, st.la_w,
                st.fd_w, st.idx_w, st.coin_w, st.rounds_decided, st.last_round, st.count,
                st.stale, x.rows, x.creator, x.index, x.sp_row, x.op_row, x.la_rows, x.coin,
                x.fixed_round, x.levels, sm, packed=packed,
                **({} if form is None else {"form": form}))

        l_lv, w = xs[0].levels.shape
        forms = [f for f in forms_of(_ext.step_levels, timer.cuda)
                 if f is None or _ext.step_levels_form_fits(f, n, w, l_lv, batch, r_cap)]
        out, (plain_ms, levels, bound_ms, bound_by) = time_calls(
            cs, label, xs, st, lambda s, x: inc._step_levels_plain(s, x, sm, packed=packed),
            kern, forms, lambda s: inc._decide_body(s, sm, n, r_win=r_win, e_win=e_win,
                                                    packed=packed),
            True, args.reps, timer)
        chosen = _ext.step_levels_form(n, w, l_lv, batch, r_cap) if hasattr(
            _ext, "step_levels_form") else None
        for form, (ms, med, launched, split) in out.items():
            print(json.dumps({
                "kernel": "step_levels", "shape": label, "validators": n, "packed": packed,
                "form": form, "chosen": form is not None and form == chosen,
                "calls": len(xs), "levels_per_call": levels, "launches": launched,
                "ms": ms, "median_ms": med, "reps": args.reps, "split_ms": split,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "root": args.root,
                "card": card}), flush=True)
        del g, batches, xs, st
    return 0


if __name__ == "__main__":
    sys.exit(main())
