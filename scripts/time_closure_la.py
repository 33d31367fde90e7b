#!/usr/bin/env python3
"""Time K6 `closure_la` (the cold path's pointer-doubling lastAncestors
closure) of one checkout of the PyTorch/CUDA port on one CUDA card, call by
call.

    python3 scripts/time_closure_la.py [--root DIR] [--reps N] [--device cuda|cpu]
                                       [--shapes LABEL;...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. Shapes, each staged as run_doubling_passes
stages it (`doubling.stage_doubling`): the catch-up section of
bench_catchup.py (8 validators, 32,760 events), the bench grid (64,
32,768) and BASELINE.json config #4's grid (256, 65,536). The call is
the wrapper the cold path calls (`doubling._closure_la`), every pass to
the fixed point, and its result and pass count are held torch.equal to
the plain version before a time is printed; on the bench grid the pass
caps 1 and 2 (stopped before the fixed point) are held too.

One JSON line per shape: the pass count; kernel launches, memsets and
copies per call (torch.profiler, null where it records no device event);
medians over --reps calls of the CUDA-event ms of the whole call behind a
spin (the card busy while the host enqueues; the call's host reads of its
pass count or changed flags stay inside), the device ms of its kernels
summed (torch.profiler) and the host wall ms of the call ending in a
synchronize; the plain version's ms (one call), the bound
(`chip_smoke.closure_la_work`) and the card's name and power limit. The
grids are kept in --cache (default build/timing_cache).

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


def load_chip_smoke():
    """chip_smoke.py of this script's checkout, for its cell constants and
    work counts (its own imports of the port happen inside its functions,
    so they resolve to --root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(cs):
    """(label, grid kind, grid spec)."""
    return (
        ("catch-up section", "section", cs.CATCHUP),
        ("bench grid", "grid", cs.BENCH),
        ("config #4 grid", "grid", cs.WIDE),
    )


def cached(cache, key, make):
    """make(), kept on disk under --cache by key."""
    path = os.path.join(cache, f"cold_{key}.pkl".replace("/", "_").replace(" ", "_"))
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    out = make()
    os.makedirs(cache, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    return out


def grid_of(kind, spec, dev, cache):
    """The shape's grid: synthetic_grid(spec), or the catch-up section of
    synthetic_deep_grid(spec) cut at half its levels (on `dev`'s frontier
    engine, whose rounds the cut reads)."""
    from babble_tpu_torch.tpu import engine
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

    key = kind + "_" + "_".join(str(spec[k]) for k in sorted(spec))
    if kind == "section":
        def make():
            deep = synthetic_deep_grid(spec["n"], spec["depth"], seed=spec["seed"],
                                       zipf_a=spec["zipf_a"])
            return section_grid(deep, engine.run_frontier_passes(deep, device=dev),
                                deep.num_levels // 2)
        return cached(cache, key, make)
    return cached(cache, key, lambda: synthetic_grid(
        spec["n"], spec["e_count"], seed=spec["seed"], zipf_a=spec["zipf_a"],
        byzantine_frac=spec.get("byzantine_frac", 0.0)))


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
    from babble_tpu_torch.tpu import _ext, doubling

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("time_closure_la: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
        _ext.build_all()
    wanted = [s.strip() for s in args.shapes.split(";") if s.strip()]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def events_ms(fn):
        if not cuda:
            return wall_ms(fn)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def wall_ms(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    for label, kind, spec in shapes(cs):
        if wanted and label not in wanted:
            continue
        g = grid_of(kind, spec, dev, args.cache)
        st = doubling.stage_doubling(g, dev)
        cl_args = (st.creator_d, st.idx_d, st.sp_d, st.op_d, st.rows_by_d, st.l_b, st.block,
                   st.pass_cap)

        def check(a, name):
            got_la, got_p = doubling._closure_la(*a)
            want_la, want_p = doubling._closure_la_plain(*a)
            sync()
            if got_p != want_p or not torch.equal(got_la, want_la):
                raise AssertionError(f"closure_la ({name}) on the {label}: {got_p} passes, "
                                     f"plain {want_p}, or la differs")
            return got_la, got_p

        la_fin, passes = check(cl_args, "to the fixed point")
        traps = []
        if label == "bench grid":
            for cap in cs.CLOSURE_TRAP_CAPS:
                check(cl_args[:-1] + (cap,), f"pass_cap {cap}")
                traps.append(cap)
        kern = lambda: doubling._closure_la(*cl_args)  # noqa: E731
        for _ in range(2):
            kern()
        sync()
        ev = statistics.median(events_ms(kern) for _ in range(args.reps))
        wall = statistics.median(wall_ms(kern) for _ in range(args.reps))
        dev_ms, kernels, copies = (None, None, None)
        if cuda:
            dev_ms, kernels, copies = profile_calls(kern, args.reps)
        plain_ms = wall_ms(lambda: doubling._closure_la_plain(*cl_args))
        nbytes, ops_s = cs.closure_la_work(st, la_fin, passes)
        bound = max(nbytes / cs.HBM_BYTES_S, ops_s) * 1e3
        print(json.dumps({
            "kernel": "closure_la", "shape": label, "validators": g.n, "events": g.e,
            "l": st.l_b, "passes": int(passes), "pass_caps_held": traps,
            "launches": kernels, "memsets_copies": copies, "ms": ev, "kernel_ms": dev_ms,
            "wall_ms": wall, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / cs.HBM_BYTES_S >= ops_s else "operations",
            "reps": args.reps, "root": args.root, "card": card,
        }), flush=True)
        del st, la_fin
    return 0


if __name__ == "__main__":
    sys.exit(main())
