#!/usr/bin/env python3
"""Time a batch's K9 apply_deltas and K10 step_levels (the incremental
engine's append path) of one checkout of the PyTorch/CUDA port on one CUDA
card, call by call.

    python3 scripts/time_step_levels.py [--root DIR] [--reps N] [--device cuda|cpu]
                                        [--shapes LABEL,...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels and drives the append path over a grid's
batches (K9, K10, the decide). Before each batch it keeps the fields K9
and K10 write; K9's and K10's plain versions run once on a clone, then
every variant of the checkout's K9 + K10 runs --reps times on the kept
fields, each between two CUDA events behind a spin (the card busy while
the host enqueues) and held torch.equal to the plain versions' state,
every field: each walk of `_ext.step_levels` that can run the shape
("block", "grid"), with K9 as the walk's phase 0 where the checkout's
wrapper takes K9's arrays (fused), else as its own `apply_deltas` launch
before it (two launches). K9's own launch is also timed alone on the
same kept fields. Shapes: the bench cell's step state (64
validators, wide), the bench grid's generator at 32, 48 and 96
validators (around the crossover of the two walks), the switch state
(128, packed), BASELINE.json config #4's step state (256, packed) and
config #5's width (1,024 validators, 16,384 events, packed). Prints one
JSON line per shape and variant: the ms per batch (mean and median over
the calls, each the median of its reps), the split by launch at the
middle call (device ms of K9's launch, the walks, K11's compare-copy fill
and the grid scratch's memset, from torch.profiler; null where it records
none), the launches per call by key, the plain versions' ms per call, the
mean walked levels per call, the bound (chip_smoke.inc_work_deltas plus
inc_work_levels: each input read once, the compares at the ALU rate),
whether it is the variant the checkout's wrapper chooses, and the card's
name and power limit; then one line for K9's own launch (ms per call,
its bound and its launches over the step path as the checkout runs it)
and one for the step path's wall (`incremental.step` over every batch from
a fresh state, host clock around a synchronize, median of --wall-runs warm
runs, default 3) with the host time of its two bodies in it
(`_step_body`, K9 + K10's wrappers and launches, and `_decide_body`:
host clock around each call, summed over the batches, median over the
runs). `--wall-only` prints the wall line alone, so that many runs of
two checkouts can alternate in one call.
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
# the fields a level-scan call writes (and, first, K9's: fd, la, creator,
# index), restored before every timed rep
WRITTEN = ("fd", "la", "creator", "index", "rounds", "lamport", "witness", "wtable",
           "w_of_row", "la_w", "fd_w", "idx_w", "coin_w", "last_round", "count", "stale")
# the device work of a call, by kernel name: K9's own launch, the walks,
# K11's compare-copy fill, and the memset of K10's grid scratch
LAUNCH_NAMES = ("ad_apply", "sl_walk", "sl_grid", "tl_init", "tl_walk", "tl_grid", "Memset")
STEP_WALL_RUNS = 3
# the step path's bodies whose host time the wall line takes apart
BODIES = ("_step_body", "_decide_body")


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


# the fields a train-level call writes (K9 runs before it, untimed)
LEVEL_WRITTEN = WRITTEN[4:]


def time_calls(cs, label, xs, st, plain, kern, forms, decide, rounds_scan, reps, timer,
               written=WRITTEN, before=None):
    """Drive state st over inputs xs: for each call before(st, x) if given
    (untimed), then the plain version once on a clone and kern(st, x,
    form) `reps` times for each variant in `forms` on st's kept `written`
    fields, every launch held torch.equal to the plain state; at the
    middle call also the split by launch (profiled_split); then the
    decide. Returns {form: (kernel ms per call, median, launches in all,
    split)} and (plain ms per call, mean levels, bound ms, bound_by). The
    bound counts K9's work too where rounds_scan (the step path)."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    per_form = {f: [] for f in forms}
    launched = {f: {} for f in forms}
    split = dict.fromkeys(forms)
    plain_ms, levels, nbytes, alu = [], [], 0, 0
    for k, x in enumerate(xs):
        if before is not None:
            before(st, x)
        kept = {f: getattr(st, f).clone() for f in written}
        want = inc.clone_state(st)
        if rounds_scan:
            work = cs.inc_work_deltas(st, x)
            nbytes += work[0]
            alu += work[1]
        plain_ms.append(timer(lambda: plain(want, x)))
        for form in forms:
            times = []
            for _ in range(reps):
                for f in written:
                    getattr(st, f).copy_(kept[f])
                seen = dict(_ext.LAUNCHES)
                times.append(timer(lambda: kern(st, x, form)))
                for name, v in _ext.LAUNCHES.items():
                    if v != seen[name]:
                        launched[form][name] = launched[form].get(name, 0) + v - seen[name]
                bad = cs.state_diff(st, want)
                if bad:
                    raise AssertionError(f"{label}, call {k}, form {form}: {bad} differ from "
                                         f"the plain version")
            per_form[form].append(statistics.median(times))
            if timer.cuda and k == len(xs) // 2:
                def restored_call():
                    for f in written:
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


def time_apply_deltas(cs, xs, st, advance, reps, timer):
    """K9's own launch over the batches (each rep on the kept fields K9
    writes, held torch.equal to its plain version), then the kept fields
    restored and advance(st, x) (the checkout's K9 + K10 and the decide)
    moving the state on: (ms per call, bound ms)."""
    from babble_tpu_torch.tpu import incremental as inc

    k9_fields = ("fd", "fd_w", "la", "creator", "index")
    times, nbytes = [], 0
    for k, x in enumerate(xs):
        kept = {f: getattr(st, f).clone() for f in k9_fields}
        want = inc.clone_state(st)
        inc._apply_deltas_and_stage_plain(want, x)
        nbytes += cs.inc_work_deltas(st, x)[0]
        reps_ms = []
        for _ in range(reps):
            for f in k9_fields:
                getattr(st, f).copy_(kept[f])
            reps_ms.append(timer(lambda: inc._apply_deltas_and_stage(st, x)))
        bad = cs.state_diff(st, want)
        if bad:
            raise AssertionError(f"apply_deltas, call {k}: {bad} differ from the plain version")
        times.append(statistics.median(reps_ms))
        for f in k9_fields:
            getattr(st, f).copy_(kept[f])
        advance(st, x)
    return statistics.mean(times), nbytes / len(xs) / cs.HBM_BYTES_S * 1e3


def step_wall_ms(xs, fresh, step, timer, runs):
    """The step path (step(st, x) over every batch from a fresh state, one
    synchronize at the end) over `runs` warm runs: the median host-clock
    ms of the whole, {body: median host ms of its calls summed over the
    batches} for BODIES, and the launches of one run by key."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    walls, hosts, launches = [], {b: [] for b in BODIES}, {}
    spent = dict.fromkeys(BODIES, 0.0)
    real = {b: getattr(inc, b) for b in BODIES}

    def clocked(name):
        def body(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return body

    try:
        for b in BODIES:
            setattr(inc, b, clocked(b))
        for r in range(runs + 1):
            st = fresh()
            if timer.cuda:
                torch.cuda.synchronize()
            before = dict(_ext.LAUNCHES)
            spent.update(dict.fromkeys(BODIES, 0.0))
            t0 = time.perf_counter()
            for x in xs:
                step(st, x)
            if timer.cuda:
                torch.cuda.synchronize()
            if r:
                walls.append((time.perf_counter() - t0) * 1e3)
                for b in BODIES:
                    hosts[b].append(spent[b] * 1e3)
            launches = {k: v - before[k] for k, v in _ext.LAUNCHES.items() if v != before[k]}
    finally:
        for b in BODIES:
            setattr(inc, b, real[b])
    return (statistics.median(walls), {b: statistics.median(h) for b, h in hosts.items()},
            launches)


def setup(description):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="comma-separated labels (default: all)")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    ap.add_argument("--wall-runs", type=int, default=STEP_WALL_RUNS)
    ap.add_argument("--wall-only", action="store_true",
                    help="print the step path's wall line alone")
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
    # the checkout's K9 + K10: one launch where its wrapper takes K9's
    # arrays, else K9's own launch before K10's
    fused_api = "upd_row" in inspect.signature(_ext.step_levels).parameters
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
        wall, host_ms, path_launches = step_wall_ms(
            xs, lambda: inc.init_state(n, e_cap, r_cap, device=dev),
            lambda st, x: inc.step(st, x, sm, n, r_win=r_win, e_win=e_win, packed=packed),
            timer, args.wall_runs)
        wall_line = {
            "kernel": "step (path)", "shape": label, "validators": n, "packed": packed,
            "batches": len(xs), "wall_ms": wall, "host_ms": host_ms, "runs": args.wall_runs,
            "launches": path_launches, "root": args.root, "card": card}
        if args.wall_only:
            print(json.dumps(wall_line), flush=True)
            del g, batches, xs
            continue

        def decide(s):
            inc._decide_body(s, sm, n, r_win=r_win, e_win=e_win, packed=packed)

        def step_body(st, x):
            inc._step_body(st, x, sm, n, packed=packed)

        def kern(st, x, form):
            if form is None:
                step_body(st, x)
                return
            levels_args = (
                st.fd, st.rounds, st.lamport, st.witness, st.wtable, st.w_of_row, st.la_w,
                st.fd_w, st.idx_w, st.coin_w, st.rounds_decided, st.last_round, st.count,
                st.stale, x.rows, x.creator, x.index, x.sp_row, x.op_row, x.la_rows, x.coin,
                x.fixed_round, x.levels)
            if fused_api:
                _ext.step_levels(*levels_args, st.la, st.creator, st.index, x.upd_row,
                                 x.upd_col, x.upd_val, sm, packed=packed, form=form)
                return
            _ext.apply_deltas(st.fd, st.fd_w, st.la, st.creator, st.index, st.w_of_row,
                              x.rows, x.creator, x.index, x.la_rows, x.upd_row, x.upd_col,
                              x.upd_val)
            _ext.step_levels(*levels_args, sm, packed=packed, form=form)

        def plain(s, x):
            inc._apply_deltas_and_stage_plain(s, x)
            inc._step_levels_plain(s, x, sm, packed=packed)

        l_lv, w = xs[0].levels.shape
        forms = [f for f in forms_of(_ext.step_levels, timer.cuda)
                 if f is None or _ext.step_levels_form_fits(f, n, w, l_lv, batch, r_cap)]
        out, (plain_ms, levels, bound_ms, bound_by) = time_calls(
            cs, label, xs, inc.init_state(n, e_cap, r_cap, device=dev), plain, kern, forms,
            decide, True, args.reps, timer)
        chosen = _ext.step_levels_form(n, w, l_lv, batch, r_cap)
        for form, (ms, med, launched, split) in out.items():
            print(json.dumps({
                "kernel": "apply_deltas + step_levels", "shape": label, "validators": n,
                "packed": packed, "form": form, "fused": fused_api, "chosen": form == chosen,
                "calls": len(xs), "levels_per_call": levels,
                "launches_per_call": {k: v / (len(xs) * args.reps) for k, v in launched.items()},
                "ms": ms, "median_ms": med, "reps": args.reps, "split_ms": split,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "root": args.root,
                "card": card}), flush=True)

        def advance(st, x):
            step_body(st, x)
            decide(st)

        k9_ms, k9_bound = time_apply_deltas(cs, xs, inc.init_state(n, e_cap, r_cap, device=dev),
                                            advance, args.reps, timer)
        print(json.dumps({
            "kernel": "apply_deltas", "shape": label, "validators": n, "packed": packed,
            "calls": len(xs), "ms": k9_ms, "bound_ms": k9_bound, "bound_by": "bytes",
            "launches_on_the_step_path": path_launches.get("apply_deltas", 0),
            "root": args.root, "card": card}), flush=True)
        print(json.dumps(wall_line), flush=True)
        del g, batches, xs
    return 0


if __name__ == "__main__":
    sys.exit(main())
