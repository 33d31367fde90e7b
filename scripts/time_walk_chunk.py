#!/usr/bin/env python3
"""Time the walk_chunk kernel (K7, the cold path's frontier walk) of one
checkout of the PyTorch/CUDA port on one CUDA card.

    python3 scripts/time_walk_chunk.py [--root DIR] [--reps N] [--device cuda|cpu]
                                       [--shapes LABEL;...] [--depths] [--forms]
                                       [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels, and for each grid walks the cold path's
frontier with every chunk held to the plain version (torch.equal), and
the largest chunk's traps too (`chip_smoke.walk_chunk_traps`: `steps`
forced to 1, 4 and 5, one chain's la rows reversed), then times the
largest chunk and every chunk of the walk by CUDA events behind a spin
(the card busy while the host enqueues): the catch-up section of
bench_catchup.py (8 validators), the bench grid's generator at 16 and 32
validators (the one-block walk's upper end), at 48, the bench grid (64),
the bench generator at 96 and 128 (the cluster form's tree depths by
width), BASELINE.json config #4's grid (256), the bench generator at 384,
448, 512 and 640 validators (the crossover of the two grid forms; a
cluster of 8 blocks at 512 and 640, about the cluster form's reach)
and config #5's width grid (1,024 validators, 16,384 events: past a
cluster's reach). Prints one JSON line per grid and form: validators,
chunk steps and probes, the tree depth (`_ext.walk_chunk_depth`, where
the checkout has it) and the checkout's plan (`_ext.walk_chunk_plan`:
form, blocks a cluster, chains a block, shared memory a block; null where
it has none), the median kernel ms of the largest chunk and the sum of
every chunk's medians over N runs, the kernel launches per call of the
largest chunk (torch.profiler), the plain version's ms of the largest
chunk (one call), its bound (`chip_smoke.walk_chunk_work`: its searched
steps and their countable rows, from the data), the largest chunk's
working and skipped steps (`chip_smoke.walk_chunk_steps`: a step with
fewer than super_majority countable frontier rows searches nothing) and
each chunk's, in the L2 form the live chains of each search round of the
largest chunk's searched steps (`chip_smoke.walk_chunk_live`: settled
chains leave the rounds), and the card's name and power limit. `--forms` times every
grid form that takes the grid (where the checkout's `_ext.walk_chunk`
takes `form=`), each held like the plan's, one line each; `--depths`
also times each form at every other tree depth up to 4 that fits. The
grids are kept in --cache (default build/timing_cache). To compare two
versions of the kernel, run it against both checkouts in one call, in
the order A, B, B, A. `--device cpu` rehearses it on the plain versions
(wall-clock times).
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

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_CYCLES = 1_000_000


def load_chip_smoke():
    """chip_smoke.py of this script's checkout, for its cell constants and
    traps (its own imports of the port happen inside its functions, so
    they resolve to --root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(cs):
    """(label, grid kind, grid spec)."""
    return (
        ("catch-up section", "section", cs.CATCHUP),
        ("16-validator grid", "grid", dict(cs.BENCH, n=16)),
        ("32-validator grid", "grid", dict(cs.BENCH, n=32)),
        ("48-validator grid", "grid", dict(cs.BENCH, n=48)),
        ("bench grid", "grid", cs.BENCH),
        ("96-validator grid", "grid", dict(cs.BENCH, n=96)),
        ("128-validator grid", "grid", dict(cs.BENCH, n=128)),
        ("config #4 grid", "grid", cs.WIDE),
        ("384-validator grid", "grid", dict(cs.BENCH, n=384)),
        ("448-validator grid", "grid", dict(cs.BENCH, n=448)),
        ("512-validator grid", "grid", dict(cs.BENCH, n=512)),
        ("640-validator grid", "grid", dict(cs.BENCH, n=640)),
        ("width grid", "grid", cs.FL_WIDTH),
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
    synthetic_deep_grid(spec) cut at half its levels."""
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


def launches_per_call(fn, calls):
    """Kernel launches per call of fn by kernel name (torch.profiler); None
    where it records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        if evt.key.startswith(("Memset", "Memcpy")):
            continue
        name = evt.key.split("(")[0].replace("void ", "").strip()
        kernels[name] = kernels.get(name, 0) + evt.count / calls
    return kernels or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="labels separated by ';' (default: all)")
    ap.add_argument("--depths", action="store_true",
                    help="also time each form at every other tree depth")
    ap.add_argument("--forms", action="store_true",
                    help="time every grid form that takes the grid")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    cs = load_chip_smoke()
    from babble_tpu_torch.tpu import _ext, doubling, frontier

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("time_walk_chunk: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[0]
        _ext.build_all()
    wanted = [s.strip() for s in args.shapes.split(";") if s.strip()]
    tree = hasattr(_ext, "walk_chunk_depth")  # the checkout's one-block walk is a tree
    planned = hasattr(_ext, "walk_chunk_plan")  # and its grid form is planned by width
    # and its wrapper takes a form
    named = "form" in inspect.signature(_ext.walk_chunk).parameters

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def time_ms(fn, reps):
        times = []
        for k in range(reps + 2):
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda._sleep(SPIN_CYCLES)
                ev[0].record()
                fn()
                ev[1].record()
                ev[1].synchronize()
                ms = ev[0].elapsed_time(ev[1])
            else:
                t0 = time.perf_counter()
                fn()
                ms = (time.perf_counter() - t0) * 1e3
            if k >= 2:
                times.append(ms)
        return statistics.median(times)

    plain_of = {}  # id(arguments) -> the plain version's result, computed once

    def held(what, a, kern):
        got = kern(*a)
        if id(a) not in plain_of:
            plain_of[id(a)] = (a, doubling._walk_chunk_plain(*a))
        want = plain_of[id(a)][1]
        sync()
        for x, y in zip(got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"walk_chunk ({what}): differs from the plain version")
        return got

    for label, kind, spec in shapes(cs):
        if wanted and label not in wanted:
            continue
        g = grid_of(kind, spec, dev, args.cache)
        st = doubling.stage_doubling(g, dev)
        inv = frontier.build_inv(st.rows_by_d, st.la_d)
        s_np, first_nw, x0 = doubling.walk_seeds(g, st)
        chunks = []

        def walk(*a):
            chunks.append(a)
            return held(f"length {a[10]} on the {label}", a, doubling._walk_chunk)

        doubling._doubling_walk(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), inv, st.rows_by_d,
            st.fd_d, st.la_d, x0, s_np, first_nw, g.super_majority, st.l_b, st.seeded, {},
            walk=walk)
        big = max(chunks, key=lambda a: a[10])
        traps = cs.walk_chunk_traps(big)
        for name, a in traps.items():
            held(f"{name} on the {label}'s largest chunk", a, doubling._walk_chunk)
        # (form, depth) variants: the plan's first, then (--forms) the other
        # grid forms that take the grid, then (--depths) other depths
        forms = [None]
        if named and args.forms and g.n > _ext.WC_BLOCK_MAX:
            plan_form = _ext.walk_chunk_plan(g.n, st.l_b)["form"]
            for f in ("cluster", "l2"):
                try:
                    _ext.walk_chunk_plan(g.n, st.l_b, form=f)
                except ValueError:
                    continue
                if f != plan_form:
                    forms.append(f)
        variants = []
        for form in forms:
            if not (planned or (tree and g.n <= _ext.WC_BLOCK_MAX)):
                variants.append((None, None))
                continue
            if named:
                d0 = _ext.walk_chunk_plan(g.n, st.l_b, form=form)["depth"]
            else:
                d0 = _ext.walk_chunk_depth(g.n)
            variants.append((form, d0))
            if args.depths and (named or _ext.walk_chunk_plan(g.n, st.l_b)["form"] != "l2"):
                def fits(d, form=form):
                    shape = dict(l=st.l_b, depth=d, **({"form": form} if named else {}))
                    try:
                        return _ext.smem_bytes("walk_chunk", g.n, **shape) <= _ext.MAX_SMEM_BYTES
                    except ValueError:  # the named form cannot take that depth
                        return False

                variants += [(form, d) for d in range(1, 5) if d != d0 and fits(d)]
        plain_ms = None
        chunk_steps = [cs.walk_chunk_steps(a) for a in chunks]
        for form, depth in variants:
            def kern(*a, depth=depth, form=form):
                if (depth is None and form is None) or not cuda:
                    return doubling._walk_chunk(*a)
                if form is None:
                    return _ext.walk_chunk(*a, depth=depth)
                return _ext.walk_chunk(*a, depth=depth, form=form)

            if (form, depth) != variants[0]:
                what = f"{form or 'planned'} form, tree depth {depth}"
                for a in chunks:
                    held(f"length {a[10]}, {what}, on the {label}", a, kern)
                for name, a in traps.items():
                    held(f"{name}, {what}, on the {label}", a, kern)
            ms = time_ms(lambda: kern(*big), args.reps)
            all_ms = sum(time_ms(lambda a=a: kern(*a), args.reps) for a in chunks)
            if plain_ms is None:
                plain_ms = time_ms(lambda: doubling._walk_chunk_plain(*big), 1)
                (nbytes, ops_s), steps_big = cs.walk_chunk_work(big, st.l_b, g.n)
                bytes_s = nbytes / cs.HBM_BYTES_S
            plan = None
            if planned:
                p_args = (g.n, st.l_b, depth) + ((form,) if named else ())
                plan = {k: v for k, v in _ext.walk_chunk_plan(*p_args).items()
                        if k in ("form", "k", "chains", "smem")}
            print(json.dumps({
                "grid": label, "validators": g.n, "steps": big[10], "probes": big[11],
                "chunks": [a[10] for a in chunks], "tree_depth": depth,
                "depth_rule": (form, depth) == variants[0] if depth is not None else None,
                "form_named": form, "l": st.l_b, "plan": plan,
                "traps_held": list(traps), "ms": ms, "all_chunks_ms": all_ms,
                "launches": launches_per_call(lambda: kern(*big), 3) if cuda else None,
                "plain_ms": plain_ms, "working_steps": steps_big["working"],
                "skipped_steps": steps_big["skipped"],
                "countable_rows": steps_big["countable"],
                "chunk_steps": [(a[10], s_["working"], s_["skipped"])
                                for a, s_ in zip(chunks, chunk_steps)],
                "live_per_round": (cs.walk_chunk_live(big, depth)
                                   if plan and plan["form"] == "l2" else None),
                "bound_ms": max(bytes_s, ops_s) * 1e3,
                "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                "reps": args.reps, "root": args.root, "card": card}),
                flush=True)
        plain_of.clear()
        del st, inv
    return 0


if __name__ == "__main__":
    sys.exit(main())
