#!/usr/bin/env python3
"""Time the level-scan kernels K5 divide_rounds and K8 lamport_scan of one
checkout of the PyTorch/CUDA port on one CUDA card.

    python3 scripts/time_divide_rounds.py [--root DIR] [--reps N] [--device cuda|cpu]
                                          [--kernels divide_rounds,lamport_scan]
                                          [--shapes LABEL,...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. K5 runs on the level-scan inputs of nine
grids, as `run_passes` stages them (bucketed): the catch-up section of
bench_catchup.py (8 validators, 10,180 levels) and the whole catch-up grid
(65,536 events, 20,359 levels), the bench grid's generator at 16, 24 and 32
validators (around the crossover of the two walks), the bench grid (64),
the switch grid (128), BASELINE.json config #4's grid (256, packed) and
config #5's width grid (1,024, cut to 16,384 events). K8 runs on
`doubling.lamport_inputs` of the catch-up section, the catch-up grid and
the bench grid. Each timed launch runs between two CUDA events behind a
spin (the card busy while the host enqueues), and its outputs are held to
the plain version's (torch.equal) after every launch, before any time is
printed. Where the checkout's `_ext.divide_rounds` takes a `form=`
("block", "grid"), every form that can run the shape is timed; where its
wrappers take a `carry=` ("shared", "device"), the one-block walk and K8
are timed in every carry form, on every shape, whether or not the rule
would give it that form. Prints one JSON line per kernel, shape, form and
carry: the median ms and microseconds a level, the plain version's ms, the
bound (chip_smoke.scan_work and lamport_work: each input read once, the
compares at the ALU rate), the launch keys and the card's name and power
limit. The staged inputs are kept in --cache (default build/timing_cache)
so that later runs skip the host grid builder.

To compare two versions, run it against both checkouts in one call, in
the order A, B, B, A (README.md shows the command). `--device cpu`
rehearses it on the plain versions (wall-clock times).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_CYCLES = 1_000_000
KERNELS = ("divide_rounds", "lamport_scan")


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
    """(label, grid spec, packed, kernels timed on it) of the timed shapes."""
    both = KERNELS
    return (
        ("catch-up section", ("section", cs.CATCHUP), False, both),
        ("catch-up grid", ("deep", cs.CATCHUP), False, both),
        ("16-validator grid", ("grid", dict(cs.BENCH, n=16)), False, ("divide_rounds",)),
        ("24-validator grid", ("grid", dict(cs.BENCH, n=24)), False, ("divide_rounds",)),
        ("32-validator grid", ("grid", dict(cs.BENCH, n=32)), False, ("divide_rounds",)),
        ("bench grid", ("grid", cs.BENCH), False, both),
        ("switch grid", ("grid", cs.SWITCH), False, ("divide_rounds",)),
        ("config #4 grid", ("grid", cs.WIDE), True, ("divide_rounds",)),
        ("width grid", ("grid", cs.FL_WIDTH), False, ("divide_rounds",)),
    )


def staged_inputs(spec, dev, cache_path):
    """The level scan's inputs of one grid as run_passes stages them
    (bucketed), and K8's as seeded_lamport stages them, as CPU tensors:
    (args, lam_args, n, e, levels); cached on disk."""
    if os.path.exists(cache_path):
        return torch.load(cache_path)
    from babble_tpu_torch.tpu import doubling, engine
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

    kind, p = spec
    if kind in ("section", "deep"):
        g = synthetic_deep_grid(p["n"], p["depth"], seed=p["seed"], zipf_a=p["zipf_a"])
        if kind == "section":
            g = section_grid(g, engine.run_frontier_passes(g, device=dev), g.num_levels // 2)
    else:
        g = synthetic_grid(p["n"], p["e_count"], seed=p["seed"], zipf_a=p["zipf_a"],
                           byzantine_frac=p.get("byzantine_frac", 0.0))
    gp, _, scan_r_max = engine.scan_layout(g, True)
    ins = engine.stage_scan(gp, "cpu")
    out = dict(args=tuple(t.contiguous() for t in ins[:13]) + (gp.super_majority, scan_r_max),
               lam_args=tuple(t.contiguous() for t in doubling.lamport_inputs(g, "cpu")),
               n=g.n, e=g.e, levels=g.num_levels)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    torch.save(out, cache_path)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--shapes", default="", help="comma-separated labels (default: all)")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    from babble_tpu_torch.tpu import _ext, doubling, kernels

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("time_divide_rounds: no CUDA device", file=sys.stderr)
            return 1
        card = card_name()
        _ext.build_all()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        """(result, ms) of one call: CUDA events behind a spin, or the host
        clock on the CPU."""
        if not cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])

    def run(kernel, label, st, form, carry, fn, want):
        """Time fn (reps after two warm calls), every call held equal to
        want; one JSON line."""
        times, launched = [], {}
        for k in range(args.reps + 2):
            before = dict(_ext.LAUNCHES)
            got, ms = timed(fn)
            for name, v in _ext.LAUNCHES.items():
                if v != before[name]:
                    launched[name] = launched.get(name, 0) + v - before[name]
            for g_t, w_t in zip(got, want):
                if not torch.equal(g_t, w_t):
                    raise AssertionError(f"{kernel} ({form or 'default'}, {carry or 'default'}) "
                                         f"on the {label}: differs from the plain version")
            if k >= 2:
                times.append(ms)
        return dict(launches=launched, ms=statistics.median(times), min_ms=min(times),
                    us_per_level=statistics.median(times) * 1e3 / max(st["levels"], 1))

    wanted = {s for s in args.shapes.split(",") if s}
    wanted_k = {k for k in args.kernels.split(",") if k}
    forms = getattr(_ext, "WALK_FORMS", None)
    carries = getattr(_ext, "WALK_CARRIES", None)
    for label, spec, packed, on in shapes(cs):
        if wanted and label not in wanted:
            continue
        todo = [k for k in on if k in wanted_k]
        if not todo:
            continue
        key = label.replace(" ", "_").replace("#", "")
        st = staged_inputs(spec, dev, os.path.join(args.cache, f"level_scan_{key}.pt"))
        base = dict(shape=label, validators=st["n"], events=st["e"], levels=st["levels"],
                    root=args.root, card=card)
        if "divide_rounds" in todo:
            a = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in st["args"])
            want, plain_ms = timed(lambda: tuple(kernels._divide_rounds_plain(*a, packed=packed)))
            sync()
            nbytes, ops_s = cs.scan_work(SimpleNamespace(n=st["n"], e=st["e"]), a, want, a[14])[0]
            runs = [(None, None, lambda: tuple(kernels.divide_rounds(*a, packed=packed)))]
            if cuda and forms:
                runs = []
                for f in forms:
                    if not _ext.divide_rounds_form_fits(f, st["n"], a[0].shape[1]):
                        continue
                    for c in (carries if carries and f == "block" else (None,)):
                        kw = dict(form=f, **({"carry": c} if c else {}))
                        runs.append((f, c, (lambda kw=kw: tuple(
                            _ext.divide_rounds(*a, packed=packed, **kw)))))
            for form, carry, fn in runs:
                out = run("divide_rounds", label, st, form, carry, fn, want)
                print(json.dumps(dict(
                    kernel="divide_rounds", **base, level_width=int(a[0].shape[1]),
                    packed=packed, form=form, carry=carry, **out, plain_ms=plain_ms,
                    bound_ms=max(nbytes / cs.HBM_BYTES_S, ops_s) * 1e3,
                    bound_by="bytes" if nbytes / cs.HBM_BYTES_S >= ops_s else "operations")),
                    flush=True)
            del a, want
        if "lamport_scan" in todo:
            la = tuple(t.to(dev) for t in st["lam_args"])
            want, plain_ms = timed(lambda: (doubling._lamport_levels_scan_plain(*la),))
            sync()
            nbytes, ops_s = cs.lamport_work(st["e"], la)
            runs = [(None, lambda: (doubling._lamport_levels_scan(*la),))]
            if cuda:
                runs = [(None, lambda: (_ext.lamport_scan(*la),))]
                if carries:
                    runs = [(c, (lambda c=c: (_ext.lamport_scan(*la, carry=c),)))
                            for c in carries]
            for carry, fn in runs:
                out = run("lamport_scan", label, st, None, carry, fn, want)
                print(json.dumps(dict(
                    kernel="lamport_scan", **base, level_width=int(la[0].shape[1]),
                    carry=carry, **out, plain_ms=plain_ms,
                    bound_ms=max(nbytes / cs.HBM_BYTES_S, ops_s) * 1e3,
                    bound_by="bytes" if nbytes / cs.HBM_BYTES_S >= ops_s else "operations")),
                    flush=True)
            del la, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
