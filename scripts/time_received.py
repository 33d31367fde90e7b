#!/usr/bin/env python3
"""Time the received tables and the live engine's pack of one checkout of
the PyTorch/CUDA port on one CUDA card: K4 `round_received`, B23
`fame_tables` (the mesh's post-fame tables) and K12's `dw_events` with
and without the fused pack.

    python3 scripts/time_received.py [--root DIR] [--reps N] [--device cuda|cpu]
                                     [--shapes LABEL;...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. Shapes:

- K4 on the tables of the bench cell (64 validators, 32,768 events; the
  frontier walk's witness table at r_cap 64 and decide_fame's verdicts),
  BASELINE.json config #4 (256 validators, 65,536 events; r_cap 16), the
  width cell (1,024 validators, 16,384 events; r_cap 64: phase 16(d)'s
  run_frontier_passes (1,024)) and chip_smoke.py's coin table (1024, 6,
  3), whose witnesses get decided;
- B23 on the inputs the mesh hands it: config #4 through
  sharded_frontier_passes (packed) and the coin table (1024, 6, 3) through
  sharded_fame, each on the 1-D mesh of 8 and the 2-D (2, 4) mesh, every
  position on the card; and "B23 + B22" on the same inputs, pass 3 as the
  engines run it (the tables, then received over the grid's events or the
  coin table's rows): where the checkout's sharded_received has forms, one
  launch of both and, named, B23 then B22 per position; else B23, then
  B22 per position;
- K12 at the live step shape (phase 10's step state: the bench grid's 512
  batches of 64, e_cap 65,536, r_cap 64, e_win 8,192): its decide without
  the pack and, where the checkout takes one, with it (dw_tables and
  dw_events write it).

Every call's result is held torch.equal to the plain version before a
time is printed (the decide's state and vector to the kernel's own decide
and the plain pack). One JSON line per shape and form: medians over
--reps calls of the CUDA-event ms of the call behind a spin and of the
host wall ms of the call ending in a synchronize; from torch.profiler (one
profile per call) each kernel's launches and device ms per call, memsets
and copies per call; the port's launch counts of one call; the plain
version's ms; the bound (`chip_smoke.received_work` for K4, the mesh
check's count for B23); the card's name and power limit. Grids are kept
in --cache (default build/timing_cache).

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
import statistics
import sys
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K4_R_CAP = 64


def load_script(name):
    """A module of this script's checkout by file; its own imports of the
    port happen inside its functions, so they resolve to --root."""
    path = os.path.join(HERE, name)
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(name))[0],
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tf, label, kern, check, timer, reps):
    """Time kern() (reps calls of each clock), check(result) after every
    call; the line's common fields."""
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
    by_kernel, copies, recorded = (tf.profile_kernels(call, reps) if timer.cuda
                                   else (None, None, 0))
    check(out[0])
    launches = tf.ext_launches(call) if timer.cuda else None
    line = {"shape": label, "event_ms": statistics.median(event_ms),
            "wall_ms": statistics.median(wall_ms), "kernels": by_kernel,
            "memsets_and_copies_per_call": copies, "profiled_calls": recorded,
            "port_launches_per_call": launches, "calls_checked": check.calls}
    if by_kernel is not None:
        line["kernel_ms"] = sum(v[1] for v in by_kernel.values())
        line["launches_per_call"] = sum(v[0] for v in by_kernel.values())
    return line


def bound(cs, nbytes, ops_s):
    bytes_s = nbytes / cs.HBM_BYTES_S
    return {"bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations"}


def grid_recv_args(g, r_cap, dev):
    """K4's arguments on a grid's frontier tables, as run_frontier_passes
    hands them over."""
    from babble_tpu_torch.tpu import engine, frontier, kernels

    st = engine.stage_frontier(g, dev)
    inv = frontier.build_inv(st.rows_by, st.la)
    fr = frontier.frontier_rounds(inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd,
                                  g.super_majority, r_cap)
    fame = kernels.decide_fame(fr.witness_table, st.la, st.fd, st.index, st.coin_bit,
                               fr.last_round, g.super_majority, g.n, r_cap + 2)
    return (fr.witness_table, st.la, st.index, st.creator, fr.rounds, fame.decided,
            fame.famous, fame.rounds_decided, fr.last_round)


def coin_recv_args(cs, spec, dev):
    from babble_tpu_torch.tpu import kernels

    case = cs.coin_round_case(*spec)
    fame = kernels.decide_fame(*cs.coin_fame_args(case, case["coin_bit"], dev))
    return cs.coin_received_args(case, fame, dev)


def k4_shape(cs, tf, label, args, timer, reps, card, root):
    from babble_tpu_torch.tpu import _ext, kernels

    want = kernels._decide_round_received_plain(*args)
    plain_ms = timer.events(lambda: kernels._decide_round_received_plain(*args))
    nbytes, ops_s = cs.received_work(args, want)
    r_max, n = args[0].shape
    # on the CPU the wrapper that dispatches (the plain version)
    fn = _ext.round_received if timer.cuda else kernels.decide_round_received
    line = measure(tf, label, lambda: (fn(*args),), tf.equal_check(label, (want,)), timer,
                   reps)
    line.update({"kernel": "round_received", "validators": n, "rounds": r_max,
                 "events": int(args[2].shape[0]), "received": int((want >= 0).sum()),
                 "plain_ms": plain_ms, **bound(cs, nbytes, ops_s), "reps": reps, "root": root,
                 "card": card})
    print(json.dumps(line), flush=True)


def pass3_inputs(cs, label, dev, cache, tfw):
    """(mesh, B23's inputs (wtable, la, decided, famous, last_round), the
    events (index, creator, rounds) numpy) as the mesh hands them over:
    config #4 through sharded_frontier_passes (packed), or the coin table
    through sharded_fame, every row an event of its table row's round and
    creator."""
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.device import to_device
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    mesh = DeviceMesh.on(dev, *(cs.MESH_1D if "1-D" in label else cs.MESH_2D))
    if "config #4" in label:
        seen = {}
        real_ft, real_sr = sh.fame_tables, sh.sharded_received

        def cap_ft(*a):
            seen.setdefault("fame_tables", a)
            return real_ft(*a)

        def cap_sr(*a, **kw):
            seen.setdefault("sharded_received", a)
            return real_sr(*a, **kw)

        sh.fame_tables, sh.sharded_received = cap_ft, cap_sr
        try:
            sh.sharded_frontier_passes(mesh, tfw.grid_of(cs.WIDE, cache), packed=True)
        finally:
            sh.fame_tables, sh.sharded_received = real_ft, real_sr
        _, index, creator, rounds, fame = seen["sharded_received"][:5]
        # a checkout whose sharded_received takes the tables got them from
        # fame_tables
        if "form" not in inspect.signature(real_sr).parameters:
            fame = seen["fame_tables"]
        return mesh, tuple(fame), (index, creator, rounds)
    case = cs.coin_round_case(*cs.FL_WIDTH_COIN)
    r, n = case["wtable"].shape
    g = SimpleNamespace(n=n, super_majority=case["super_majority"], coin_bit=case["coin_bit"])
    la, fd, index = (to_device(case[k], dev) for k in ("la", "fd", "index"))
    lr = torch.tensor(case["last_round"], dtype=torch.int32, device=dev)
    stage = sh.stage_fame(mesh, g, case["wtable"], la, fd, index, True)
    decided, famous = sh.sharded_fame(mesh, stage, lr, 8, n, case["super_majority"], True)
    rows = np.arange(r * n, dtype=np.int32)
    return (mesh, (stage.wtable, la, decided, famous, lr),
            (case["index"], rows % n, rows // n))


def pass3_shape(cs, tf, label, mesh, fame, events, timer, reps, card, root):
    """Pass 3 on the mesh as the engines run it after the fame loop: B23's
    tables and B22 over the events; where the checkout has forms, each
    named (one launch of both; B23, then B22 per position), else B23 then
    its sharded_received."""
    from babble_tpu_torch.tpu import kernels
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.device import to_device

    want_t = tuple(sh._fame_tables_plain(*fame))
    ev = [to_device(np.asarray(a, dtype=np.int32), mesh.device) for a in events]
    want = want_t + (kernels.received_search(*ev, *want_t[:4]),)
    plain_ms = timer.events(lambda: kernels.received_search(
        *ev, *sh._fame_tables_plain(*fame)[:4]))
    wtable, _, decided, famous, _ = fame
    r, n = wtable.shape
    e = len(events[0])
    n_famous = int((decided & famous & (wtable >= 0)).sum().item())
    start = (ev[2] + 1).clamp(0, r - 1).long()
    stop = torch.where(want[5] >= 0, want[5], want_t[3][start].clamp(max=r) - 1)
    scans = int((stop - ev[2]).clamp(min=0).sum().item())
    # the mesh check's count (chip_smoke.MeshCheck._fame_received)
    nbytes = r * n * 4 + n_famous * n * 4 + r * n * 2 + 4 + r * n * 4 + r * 10 + e * 16
    ops_s = (n_famous * n + r * n + scans) / cs.ALU_OPS_S
    has_forms = "form" in inspect.signature(sh.sharded_received).parameters
    for form in (("grid", "step") if has_forms else (None,)):
        if form:
            def kern():
                tables, received = sh.sharded_received(mesh, *events, fame, form=form)
                return tuple(tables) + (received,)
        else:
            def kern():
                tables = sh.fame_tables(*fame)
                return tuple(tables) + (sh.sharded_received(mesh, *events, tables[:4]),)
        line = tf.measure(label, kern, tf.equal_check(f"{label}, form {form}", want), timer,
                          reps)
        line.update({"kernel": "fame_received" if form == "grid" else
                     "fame_tables + received_search", "form": form or "per position",
                     "validators": n, "rounds": r, "famous": n_famous, "events": e,
                     "received": int((want[5] >= 0).sum()), "plain_ms": plain_ms,
                     **bound(cs, nbytes, ops_s), "reps": reps, "root": root, "card": card})
        print(json.dumps(line), flush=True)


def b23_shape(cs, tf, label, args, timer, reps, card, root):
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import sharded as sh

    want = tuple(sh._fame_tables_plain(*args))
    plain_ms = timer.events(lambda: sh._fame_tables_plain(*args))
    wtable, la, decided, famous, _ = args
    r, n = wtable.shape
    n_famous = int((decided & famous & (wtable >= 0)).sum().item())
    # the mesh check's count (chip_smoke.MeshCheck._fame_tables)
    nbytes = r * n * 4 + n_famous * n * 4 + r * n * 2 + 4 + r * n * 4 + r * 10
    ops_s = (n_famous * n + r * n) / cs.ALU_OPS_S
    fn = _ext.fame_tables if timer.cuda else sh.fame_tables
    line = measure(tf, label, lambda: fn(*args), tf.equal_check(label, want), timer, reps)
    line.update({"kernel": "fame_tables", "validators": n, "rounds": r, "famous": n_famous,
                 "plain_ms": plain_ms, **bound(cs, nbytes, ops_s), "reps": reps, "root": root,
                 "card": card})
    print(json.dumps(line), flush=True)


def dw_shape(cs, tf, tfw, label, dev, timer, reps, card, root, cache):
    """K12 at the live step shape, without the pack and (where the checkout
    takes one) with it: its decide on phase 10's step state."""
    from babble_tpu_torch.tpu import incremental as inc

    cfg = cs.INC_STEP
    g = tfw.grid_of(cs.BENCH, cache)
    st = inc.init_state(g.n, cfg["e_cap"], cfg["r_cap"], device=dev)
    for b in inc.batches_from_grid(g, cfg["batch"], cfg["upd_cap"], cfg["e_cap"]):
        inc.step(st, inc.device_put(b, dev), g.super_majority, g.n, r_win=cfg["r_win"],
                 e_win=cfg["e_win"])
    e_win, r_cap, n = cfg["e_win"], cfg["r_cap"], g.n
    takes_pack = "pack" in inspect.signature(inc._decide_body).parameters
    ref = inc.clone_state(st)
    inc._decide_body(ref, g.super_majority, n, r_win=cfg["r_win"], e_win=e_win)
    want = tuple(ref)
    lo = max(int(st.count) - e_win, 0)
    for pack in ((False, True) if takes_pack else (False,)):
        vec = (torch.empty((inc.pack_size(e_win, r_cap, n),), dtype=torch.int32, device=dev)
               if pack else None)
        kw = {"pack": vec, "pack_lo": lo} if pack else {}
        work = inc.clone_state(st)
        want_vec = inc.pack_results_plain(ref, lo, e_win, r_cap, n) if pack else None

        def kern():
            inc._decide_body(work, g.super_majority, n, r_win=cfg["r_win"], e_win=e_win, **kw)
            return tuple(work) + ((vec,) if pack else ())

        line = measure(tf, label, kern,
                       tf.equal_check(f"{label}, pack {pack}",
                                      want + ((want_vec,) if pack else ())), timer, reps)
        by = line["kernels"] or {}
        line.update({"kernel": "decide_window", "pack": pack,
                     **{f"{k}_ms": by[k][1] if k in by else None
                        for k in ("dw_tables", "dw_events")}, "count": int(st.count),
                     "e_win": e_win, "r_cap": r_cap, "validators": n, "reps": reps,
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
    from babble_tpu_torch.tpu import _ext

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = tfw.card_name()
        _ext.build_all()
    wanted = {s for s in args.shapes.split(";") if s}
    timer = tfw.Timer(dev)
    k4 = (("K4 bench grid", lambda: grid_recv_args(tfw.grid_of(cs.BENCH, args.cache), K4_R_CAP,
                                                    dev)),
          ("K4 config #4", lambda: grid_recv_args(tfw.grid_of(cs.WIDE, args.cache),
                                                   cs.WIDE_R_CAP, dev)),
          ("K4 width cell", lambda: grid_recv_args(tfw.grid_of(cs.FL_WIDTH, args.cache),
                                                    K4_R_CAP, dev)),
          (f"K4 coin case {cs.FL_WIDTH_COIN}", lambda: coin_recv_args(cs, cs.FL_WIDTH_COIN,
                                                                      dev)))
    for label, make in k4:
        if not wanted or label in wanted:
            k4_shape(cs, tf, label, make(), timer, args.reps, card, args.root)
    for label in ("B23 config #4, 1-D 8", "B23 config #4, 2-D (2, 4)",
                  f"B23 coin case {cs.FL_WIDTH_COIN}, 1-D 8",
                  f"B23 coin case {cs.FL_WIDTH_COIN}, 2-D (2, 4)"):
        if not wanted or label in wanted:
            _, fame, _ = pass3_inputs(cs, label, dev, args.cache, tfw)
            b23_shape(cs, tf, label, fame, timer, args.reps, card, args.root)
        p3 = "B23 + B22" + label[3:]
        if not wanted or p3 in wanted:
            mesh, fame, events = pass3_inputs(cs, label, dev, args.cache, tfw)
            pass3_shape(cs, tf, p3, mesh, fame, events, timer, args.reps, card, args.root)
    label = "K12 dw_events, live step state"
    if not wanted or label in wanted:
        dw_shape(cs, tf, tfw, label, dev, timer, args.reps, card, args.root, args.cache)
    return 0


if __name__ == "__main__":
    sys.exit(main())
