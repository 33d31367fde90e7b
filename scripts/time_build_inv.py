#!/usr/bin/env python3
"""Time K1 `build_inv` of one checkout of the PyTorch/CUDA port on one CUDA
card, at the shapes its paths hand it.

    python3 scripts/time_build_inv.py [--root DIR] [--reps N] [--device cuda|cpu]
                                      [--shapes LABEL;...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. Shapes:

- "bench cell": run_frontier_passes' staged chain table and la (64
  validators, 32,768 events, L 1,024);
- "128 validators": the switch cell's grid, synthetic_grid(128, 32768)
  (512 blocks of (chain, tile): the plan's first shape with one segment);
- "config #4": BASELINE.json config #4 (256 validators, 65,536 events);
- "1,024 validators": the width cell, synthetic_grid(1024, 16384) (L 64);
- "catch-up section": the cold path's chain table of bench_catchup.py's
  section (8 validators, 32,760 events; doubling.stage_doubling);
- "mesh shards, config #4, 1-D 8": sharded_build_inv as stage_walk hands
  it config #4's chains on the 1-D mesh of 8, every position on the card
  (the checkout's own form; where it has forms, each named), and
  "mesh shard, config #4, one position": one position's 32 chains alone.

Where the checkout's build_inv takes a segment count, the bench cell, the
128-validator grid, config #4 and the catch-up section are also timed
with each count named (the crossover of _ext.build_inv_plan). Every call's result is held
torch.equal to the plain version before a time is printed. One JSON line
per shape and form: medians over --reps calls of the CUDA-event ms of the
call behind a spin and of the host wall ms ending in a synchronize; from
torch.profiler (one profile per call) each kernel's launches and device ms
per call (the parent's three launches apart), memsets
and copies per call; the port's launch counts of one call; the plain
version's ms; the bound (chip_smoke.build_inv_work); the checkout's plan
where it has one; the card's name and power limit. Grids are kept in
--cache (default build/timing_cache).

To compare two versions, run it against both checkouts in one call, in
the order A, B, B, A (README.md shows the command). `--device cpu`
rehearses it on the plain versions (host-clock times, no kernel ms).
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    """A module of this script's checkout by file; its own imports of the
    port happen inside its functions, so they resolve to --root."""
    path = os.path.join(HERE, name)
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(name))[0],
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(cs, nbytes, ops_s):
    bytes_s = nbytes / cs.HBM_BYTES_S
    return {"bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def k1_shape(cs, tf, label, rows_by, la, timer, reps, card, root, segments=None):
    """K1 on one chain table: the kernel (with `segments` named where
    given) against the plain version."""
    from babble_tpu_torch.tpu import _ext, frontier

    want = frontier._build_inv_plain(rows_by, la)
    plain_ms = timer.events(lambda: frontier._build_inv_plain(rows_by, la))
    if not timer.cuda:
        fn = frontier.build_inv
    elif segments is None:
        fn = _ext.build_inv
    else:
        def fn(r, a):
            return _ext.build_inv(r, a, segments)
    line = tf.measure(label, lambda: (fn(rows_by, la),), tf.equal_check(label, (want,)),
                      timer, reps)
    nbytes, ops_s = cs.build_inv_work(rows_by, la, want)
    n_c, l = rows_by.shape
    plan = (_ext.build_inv_plan(n_c, la.shape[1], l, segments)
            if hasattr(_ext, "build_inv_plan") else None)
    line.update({"kernel": "build_inv", "chains": n_c, "l": l, "coordinates": la.shape[1],
                 "rows": int((rows_by >= 0).sum()), "segments_named": segments, "plan": plan,
                 "plain_ms": plain_ms, **bound(cs, nbytes, ops_s), "reps": reps,
                 "root": root, "card": card})
    print(json.dumps(line), flush=True)


def mesh_shape(cs, tf, tfw, label, dev, timer, reps, card, root, cache):
    """sharded_build_inv on config #4's chains as stage_walk stages them on
    the 1-D mesh of 8 (every form the checkout has), and one position's
    build alone."""
    from babble_tpu_torch.tpu import frontier
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    mesh = DeviceMesh.on(dev, *cs.MESH_1D)
    st = sh.stage_walk(mesh, tfw.grid_of(cs.WIDE, cache))
    la = st.la_parts[0]
    if label.endswith("one position"):
        k1_shape(cs, tf, label, st.rb_parts[0], la, timer, reps, card, root)
        return
    want = tuple(frontier._build_inv_plain(rb, la) for rb in st.rb_parts)
    plain_ms = timer.events(lambda: [frontier._build_inv_plain(rb, la) for rb in st.rb_parts])
    has_forms = "form" in inspect.signature(sh.sharded_build_inv).parameters
    for form in (("grid", "step") if has_forms else (None,)):
        kw = {"form": form} if form else {}
        line = tf.measure(label, lambda: tuple(sh.sharded_build_inv(mesh, st.rb_parts,
                                                                    st.la_parts, **kw)),
                          tf.equal_check(f"{label}, form {form}", want), timer, reps)
        work = [cs.build_inv_work(rb, la, inv) for rb, inv in zip(st.rb_parts, want)]
        nbytes, ops_s = sum(w[0] for w in work), sum(w[1] for w in work)
        # a checkout without forms builds one position at a time
        line.update({"kernel": "build_inv", "form": form or "per position",
                     "positions": mesh.size,
                     "chains": sum(rb.shape[0] for rb in st.rb_parts),
                     "l": st.rb_parts[0].shape[1], "coordinates": la.shape[1],
                     "plain_ms": plain_ms, **bound(cs, nbytes, ops_s), "reps": reps,
                     "root": root, "card": card})
        print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shapes", default="", help="labels separated by ';' (default: all)")
    ap.add_argument("--cache", default=os.path.join(HERE, "build", "timing_cache"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    cs = load_script("chip_smoke.py")
    tfw = load_script(os.path.join("scripts", "time_frontier_walk.py"))
    tf = load_script(os.path.join("scripts", "time_fame.py"))
    twc = load_script(os.path.join("scripts", "time_walk_chunk.py"))
    from babble_tpu_torch.tpu import _ext, doubling, engine

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = tfw.card_name()
        _ext.build_all()
    wanted = {s for s in args.shapes.split(";") if s}
    timer = tfw.Timer(dev)
    segmented = "segments" in inspect.signature(_ext.build_inv).parameters

    def staged(spec):
        st = engine.stage_frontier(tfw.grid_of(spec, args.cache), dev)
        return st.rows_by, st.la

    def catch_up():
        st = doubling.stage_doubling(twc.grid_of("section", cs.CATCHUP, dev, args.cache), dev)
        return st.rows_by_d, st.la_d

    # (label, inputs, segment counts named besides the plan's)
    shapes = (("bench cell", lambda: staged(cs.BENCH), (1, 2)),
              ("128 validators", lambda: staged(cs.SWITCH), (2,)),
              ("config #4", lambda: staged(cs.WIDE), (2,)),
              ("1,024 validators", lambda: staged(cs.FL_WIDTH), ()),
              ("catch-up section", catch_up, (4, 16, 32)))
    for label, make, counts in shapes:
        if wanted and label not in wanted:
            continue
        rows_by, la = make()
        k1_shape(cs, tf, label, rows_by, la, timer, args.reps, card, args.root)
        if segmented and timer.cuda:
            for k in counts:
                k1_shape(cs, tf, f"{label}, segments {k}", rows_by, la, timer, args.reps,
                         card, args.root, segments=k)
    for label in ("mesh shards, config #4, 1-D 8", "mesh shard, config #4, one position"):
        if not wanted or label in wanted:
            mesh_shape(cs, tf, tfw, label, dev, timer, args.reps, card, args.root, args.cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
