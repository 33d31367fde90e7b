#!/usr/bin/env python3
"""Time B24 `local_walk` (the chains-sharded frontier walk of the device
mesh) of one checkout of the PyTorch/CUDA port on one CUDA card, call by
call.

    python3 scripts/time_shard_walk.py [--root DIR] [--reps N] [--device cuda|cpu]
                                       [--shapes LABEL,...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels, stages each shape's walk on a mesh whose
positions all lie on the device as `sharded_frontier_passes` stages it
(K1 on each position's chains, fd and la replicated, r_cap = l_b + 2, the
engine's own cap) and calls the checkout's `local_walk` on it in its
default form. Every call's histories are held torch.equal to the plain
whole walk, composed here from the checkout's plain pieces
(`_walk_rows_plain`, `_walk_m0_plain`, `_walk_close_plain`, the gathers as
torch.cat), which stops at the walk's fixed point and repeats it to the
last row. Shapes: BASELINE.json config #4 on the 1-D mesh of 8 and on the
2-D (2, 4) mesh, the bench cell on the 1-D mesh, config #5's width
(1,024 validators, 16,384 events: the binary-search form) on the 1-D mesh,
and four small widths: 12 validators (two chains a position) and 300 and
1,100 on the 1-D mesh, 64 on the 2-D (2, 2) mesh.
On the config #4 shapes it first times the three sharded engines
(packed) end to end, as chip_smoke.py's phase 17(b) does: the host wall
of each call ending in a synchronize, the three engines called in turn,
two warm-up rounds, then --reps rounds, each call's last_round, received
and witnesses held to chip_smoke.WIDE_EXPECT.

Prints one JSON line per shape (and per engine): the steps the walk computes before its
fixed point (`chip_smoke.walk_steps`) beside r_cap, the launches per call
by key, and medians over --reps calls of the kernel ms per call (the
device time of the walk's kernels from torch.profiler, summed over the
call's launches; null where it records none), the CUDA-event ms of the
whole call behind a spin (the card busy while the host enqueues), and the
host wall ms of the whole call ending in a synchronize; the CUDA-event ms
of a one-step walk (r_cap 2) and of a walk with nothing to do (X(0) = L
on every chain), each held to the plain whole walk too; the plain whole
walk's ms, the bound of the one-launch walk's working steps
(`chip_smoke.walk_work`), and the card's name and power limit. The grids
are kept in --cache (default build/timing_cache) so that later runs skip
the host grid builder.

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

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIN_CYCLES = 1_000_000
# the walk's kernels by the names torch.profiler records: the per-step
# form's three and the one-launch form's (sw_grid before the walk became
# one template for K2, K15 and B24, walk_grid since)
WALK_KERNELS = ("shard_rows", "shard_m0", "shard_close", "sw_grid", "walk_grid")


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
    """(label, grid spec, mesh (shape, axis names)) of the timed shapes."""
    return (
        ("config #4, 1-D 8", cs.WIDE, cs.MESH_1D),
        ("config #4, 2-D (2, 4)", cs.WIDE, cs.MESH_2D),
        ("bench cell, 1-D 8", cs.BENCH, cs.MESH_1D),
        ("width cell, 1-D 8", cs.MESH_WIDTH, cs.MESH_1D),
        ("12 validators, 1-D 8", dict(n=12, e_count=600, seed=7, zipf_a=1.1), cs.MESH_1D),
        ("64 validators, 2-D (2, 2)", dict(n=64, e_count=2048, seed=3, zipf_a=1.1),
         ((2, 2), ("validators", "rounds"))),
        ("300 validators, 1-D 8", dict(n=300, e_count=6000, seed=5, zipf_a=1.1), cs.MESH_1D),
        ("1,100 validators, 1-D 8", dict(n=1100, e_count=4400, seed=2, zipf_a=1.1),
         cs.MESH_1D),
    )


def cached_grid(spec, cache):
    """synthetic_grid(spec), kept on disk under --cache."""
    key = "_".join(str(spec[k]) for k in sorted(spec))
    path = os.path.join(cache, f"walk_grid_{key}.pkl".replace("/", "_"))
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    from babble_tpu_torch.tpu.grid import synthetic_grid

    g = synthetic_grid(spec["n"], spec["e_count"], seed=spec["seed"], zipf_a=spec["zipf_a"],
                       byzantine_frac=spec.get("byzantine_frac", 0.0))
    os.makedirs(cache, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(g, f, protocol=pickle.HIGHEST_PROTOCOL)
    return g


def stage(sh, mesh, grid):
    """The walk's arguments as sharded_frontier_passes stages them (pass 1a),
    from functions every checkout since the mesh has."""
    from babble_tpu_torch.tpu.device import to_device
    from babble_tpu_torch.tpu.engine import _bucket, pad_grid
    from babble_tpu_torch.tpu.frontier import chain_table
    from babble_tpu_torch.tpu.mesh import replicate, shard

    r_axis, v_axis = sh._mesh_axes(mesh)
    axis = (v_axis, r_axis) if v_axis is not None else r_axis
    grid_p = pad_grid(grid)
    rows_by = chain_table(grid)
    l_b = _bucket(rows_by.shape[1], 64, factor=2)
    n_pad = -(-grid.n // mesh.size) * mesh.size
    rb_pad = np.full((n_pad, l_b), -1, dtype=np.int32)
    rb_pad[: grid.n, : rows_by.shape[1]] = rows_by
    la = to_device(grid_p.last_ancestors, mesh.device)
    fd = to_device(grid_p.first_descendants, mesh.device)
    rb_parts = shard(rb_pad, mesh, (axis, None))
    la_parts, fd_parts = replicate(la, mesh), replicate(fd, mesh)
    inv_parts = sh.sharded_build_inv(mesh, rb_parts, la_parts)
    x0_parts = shard(np.where(rb_pad[:, 0] >= 0, 0, l_b).astype(np.int32), mesh, (axis,))
    return (mesh, axis, grid.super_majority, l_b + 2, l_b, inv_parts, rb_parts, fd_parts,
            la_parts, x0_parts)


def plain_walk(sh, mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts,
               la_parts, x0_parts):
    """The plain whole walk from the checkout's plain pieces, up to the
    first step that moves no chain, whose X fills the remaining rows."""
    from babble_tpu_torch.tpu.frontier import M0_BINSEARCH_MIN_N
    from babble_tpu_torch.tpu.mesh import all_gather, axis_index

    b = rb_parts[0].shape[0]
    n_p = fd_parts[0].shape[1]
    use_binsearch = b * mesh.size >= M0_BINSEARCH_MIN_N
    hist = [x.new_empty((r_cap, b)) for x in x0_parts]
    for h, x in zip(hist, x0_parts):
        h[0] = x
    for r in range(r_cap - 1):
        rows = [sh._walk_rows_plain(rb_parts[p], fd_parts[p], hist[p][r])
                for p in range(mesh.size)]
        fd_w = all_gather([x[0] for x in rows], mesh, axis)
        w_ok = all_gather([x[1] for x in rows], mesh, axis)
        m0 = all_gather([sh._walk_m0_plain(inv_parts[p], fd_w[p], w_ok[p], rb_parts[p],
                                           la_parts[p], super_majority, l, use_binsearch)
                         for p in range(mesh.size)], mesh, axis)
        for p in range(mesh.size):
            c = axis_index(p, mesh, axis) * b
            hist[p][r + 1] = sh._walk_close_plain(inv_parts[p], m0[p], m0[p][c: c + b],
                                                  hist[p][r], n_p, l)
        if all(torch.equal(h[r + 1], h[r]) for h in hist):
            for h in hist:
                h[r + 2:] = h[r + 1]
            break
    return hist


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


def kernel_ms(fn, calls):
    """Device ms per call of the walk's kernels (WALK_KERNELS), from
    torch.profiler over `calls` calls of fn; None where it records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if any(name in evt.key for name in WALK_KERNELS):
            total += us
    return total / 1e3 / calls if total else None


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
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = card_name()
        _ext.build_all()
    wanted = {s for s in args.shapes.split(";") if s}
    timer = Timer(dev)
    for label, spec, (mshape, names) in shapes(cs):
        if wanted and label not in wanted:
            continue
        g = cached_grid(spec, args.cache)
        mesh = DeviceMesh.on(dev, mshape, names)
        if spec is cs.WIDE:
            engine_walls(cs, sh, mesh, g, label, timer, args, card)
        walk_args = stage(sh, mesh, g)
        want = plain_walk(sh, *walk_args)
        plain_ms = timer.wall(lambda: plain_walk(sh, *walk_args))
        got, launched, checked = [None], {}, [0]

        def call():
            before = dict(_ext.LAUNCHES)
            got[0] = sh.local_walk(*walk_args)
            for k, v in _ext.LAUNCHES.items():
                if v != before[k]:
                    launched[k] = v - before[k]

        def check():
            for p, (a, b) in enumerate(zip(got[0], want)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}, call {checked[0]}: position {p}'s "
                                         f"history differs from the plain whole walk")
            checked[0] += 1

        def timed(clock):
            ms = clock(call)
            check()
            return ms

        def side_ms(side_args):
            """Median event ms of local_walk on other arguments, each call's
            histories held to the plain whole walk's."""
            side_want, out, times = plain_walk(sh, *side_args), [None], []
            for _ in range(args.reps + 1):
                times.append(timer.events(lambda: out.__setitem__(0, sh.local_walk(*side_args))))
                if not all(torch.equal(a, b) for a, b in zip(out[0], side_want)):
                    raise AssertionError(f"{label}: a side walk differs from the plain walk")
            return statistics.median(times[1:])

        timed(timer.wall)  # the first launch, its module's loading, untimed
        event_ms = [timed(timer.events) for _ in range(args.reps)]
        wall_ms = [timed(timer.wall) for _ in range(args.reps)]
        k_ms = kernel_ms(call, args.reps) if timer.cuda else None
        check()
        _, axis, sm, r_cap, l, inv_parts, rb_parts, fd_parts, la_parts, x0_parts = walk_args
        one_step_ms = side_ms(walk_args[:3] + (2,) + walk_args[4:])
        idle_ms = side_ms(walk_args[:9] + ([torch.full_like(x, l) for x in x0_parts],))
        nbytes, ops_s = cs.walk_work(mesh, axis, sm, l, inv_parts, rb_parts, fd_parts,
                                     la_parts, want)
        bytes_s = nbytes / cs.HBM_BYTES_S
        print(json.dumps({
            "kernel": "local_walk", "shape": label, "validators": g.n, "events": g.e,
            "positions": mesh.size, "chains_per_position": rb_parts[0].shape[0],
            "steps": cs.walk_steps(want), "r_cap": r_cap, "launches_per_call": launched,
            "calls_checked": checked[0], "kernel_ms": k_ms,
            "event_ms": statistics.median(event_ms), "wall_ms": statistics.median(wall_ms),
            "one_step_ms": one_step_ms, "idle_ms": idle_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations", "reps": args.reps,
            "root": args.root, "card": card}), flush=True)
        del g, walk_args, want
    return 0


ENGINES = ("sharded_frontier_passes", "sharded_run_passes", "sharded_doubling_passes")


def engine_walls(cs, sh, mesh, g, label, timer, args, card):
    """The three sharded engines (packed) on the shape's grid and mesh,
    called in turn: two warm-up rounds, then --reps rounds; one JSON line
    per engine with the median host wall, every call's counts held to
    chip_smoke.WIDE_EXPECT."""
    walls = {name: [] for name in ENGINES}
    for k in range(args.reps + 2):
        for name in ENGINES:
            res = []
            ms = timer.wall(lambda: res.append(getattr(sh, name)(mesh, g, packed=True)))
            r = res[0]
            counts = dict(last_round=r.last_round, received=int((r.received >= 0).sum()),
                          witnesses=int(r.witness.sum()))
            if counts != cs.WIDE_EXPECT:
                raise AssertionError(f"{name} on {label}: {counts}, the reference gives "
                                     f"{cs.WIDE_EXPECT}")
            if k >= 2:
                walls[name].append(ms)
    for name, ms in walls.items():
        print(json.dumps({
            "engine": name, "shape": label, "packed": True,
            "wall_ms": statistics.median(ms), "walls_ms": ms, "reps": args.reps,
            "root": args.root, "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
