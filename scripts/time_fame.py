#!/usr/bin/env python3
"""Time the virtual vote of one checkout of the PyTorch/CUDA port on one
CUDA card: K3 `decide_fame` (both voting-table layouts) call by call, and
B21's whole fame loop on the device mesh (`sharded.sharded_fame`).

    python3 scripts/time_fame.py [--root DIR] [--reps N] [--device cuda|cpu]
                                 [--shapes LABEL;...] [--cache DIR]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script) and builds its kernels. Shapes:

- K3 on the witness table of the bench cell (64 validators, 32,768 events;
  the frontier walk's at r_cap 64, chip_smoke.py's phase 3), BASELINE.json
  config #4 (256 validators, 65,536 events; r_cap 16, phase 13), the width
  cell (1,024 validators, 16,384 events; r_cap 64), and on chip_smoke.py's
  coin tables (8, 20, 52) and (1024, 6, 3), where coin steps and decisions
  happen, and past 1,024 validators on (1056, 5, 7), where the vote keeps
  each column's words in shared memory (the plain version's setup needs
  64 GiB of device memory at 2,048); each in the wide and the packed
  layout;
- B21 on config #4 staged as sharded_frontier_passes stages it (the
  one-launch walk's witness table, `sharded.stage_fame`), on the 1-D mesh
  of 8 and the 2-D (2, 4) mesh, in both layouts, every position on the
  card; the checkout's default form, and the per-step form where the
  checkout can name it (`form="step"`).

Every call's result is held torch.equal to the plain version
(`kernels._decide_fame_plain`; for B21 the per-position loop through the
plain steps `_shard_tally_plain`, `_shard_decide_plain`,
`_shard_active_plain`) before a time is printed. One JSON line per shape,
layout and form: medians over --reps calls of the CUDA-event ms of the
whole call behind a spin (the card busy while the host enqueues) and of
the host wall ms of the call ending in a synchronize (for B21 also the
wall of the loop alone, `sharded._fame_loop`, behind a synchronize on
either side: sharded_fame also shards its input and gathers its output);
from torch.profiler, one profile per call, each kernel's launches and
device ms per call by name (K3: the setup and vote kernels apart),
memsets and copies per call; the port's own launch counts of one call
(`_ext.LAUNCHES`); the plain version's ms; the bound
(`chip_smoke.fame_work` for K3, `chip_smoke.shard_fame_work` for B21);
and the card's name and power limit. Grids are kept in --cache (default
build/timing_cache).

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
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3_R_CAP = 64
B21_CHUNK = 8


def load_script(name):
    """A module of this script's checkout by file (chip_smoke.py for its
    cells, work counts and coin tables; time_frontier_walk.py for its
    timer and grid cache). Their own imports of the port happen inside
    their functions, so they resolve to --root."""
    path = os.path.join(HERE, name)
    spec = importlib.util.spec_from_file_location(os.path.splitext(os.path.basename(name))[0],
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_kernels(fn, calls):
    """({kernel name: [launches, device ms] per call}, memsets and copies per
    call, calls recorded) from torch.profiler, one profile per call of fn
    (a profile that records no device event is left out of the means);
    (None, None, 0) where none records one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels, copies, recorded = {}, 0, 0
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = {}
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) != DeviceType.CUDA:
                continue
            if evt.key.startswith(("Memset", "Memcpy")):
                seen["__copies__"] = seen.get("__copies__", 0) + evt.count
                continue
            name = evt.key.split("(")[0].replace("void ", "").strip()
            t = getattr(evt, "device_time_total", None)
            us = getattr(evt, "cuda_time_total", 0.0) if t is None else t
            k = seen.setdefault(name, [0, 0.0])
            k[0] += evt.count
            k[1] += us / 1e3
        if not [k for k in seen if k != "__copies__"]:
            continue
        recorded += 1
        copies += seen.pop("__copies__", 0)
        for name, (cnt, ms) in seen.items():
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += cnt
            k[1] += ms
    if not recorded:
        return None, None, 0
    return ({k: [c / recorded, ms / recorded] for k, (c, ms) in kernels.items()},
            copies / recorded, recorded)


def ext_launches(call):
    """The port's own launch counts (`_ext.LAUNCHES`) of one call, by key."""
    from babble_tpu_torch.tpu import _ext

    if not torch.cuda.is_available():
        return None
    _ext.reset_launches()
    call()
    torch.cuda.synchronize()
    return {k: v for k, v in _ext.LAUNCHES.items() if v}


def measure(label, kern, check, timer, reps):
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
    by_kernel, copies, recorded = (profile_kernels(call, reps) if timer.cuda
                                   else (None, None, 0))
    check(out[0])
    launches = ext_launches(call) if timer.cuda else None
    check(out[0])
    line = {"shape": label, "event_ms": statistics.median(event_ms),
            "wall_ms": statistics.median(wall_ms), "kernels": by_kernel,
            "memsets_and_copies_per_call": copies, "profiled_calls": recorded,
            "port_launches_per_call": launches, "calls_checked": check.calls}
    if by_kernel is not None:
        line["kernel_ms"] = sum(v[1] for v in by_kernel.values())
        line["launches_per_call"] = sum(v[0] for v in by_kernel.values())
        for part in ("setup", "vote"):
            line[f"{part}_ms"] = sum(v[1] for k, v in by_kernel.items() if part in k)
    return line


def equal_check(label, want):
    calls = [0]

    def check(got):
        got = tuple(got)
        bad = [k for k, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        if bad or len(got) != len(want):
            raise AssertionError(f"{label}, call {calls[0]}: fields {bad} differ from the "
                                 f"plain version")
        calls[0] += 1
        check.calls = calls[0]

    return check


def k3_cases(cs, tfw, dev, cache):
    """(label, fame args) of each K3 shape."""
    from babble_tpu_torch.tpu import engine, frontier

    for label, spec, r_cap in (("K3 bench grid", cs.BENCH, K3_R_CAP),
                               ("K3 config #4", cs.WIDE, cs.WIDE_R_CAP),
                               ("K3 width cell", cs.FL_WIDTH, K3_R_CAP)):
        yield label, lambda spec=spec, r_cap=r_cap: grid_fame_args(
            tfw.grid_of(spec, cache), r_cap, dev, engine, frontier)
    for case in (cs.COIN_CASES[1], cs.FL_WIDTH_COIN, cs.WIDE_VOTE_CASE):
        yield f"K3 coin case {case}", lambda case=case: coin_args(cs, case, dev)


def coin_args(cs, spec, dev):
    case = cs.coin_round_case(*spec)
    return cs.coin_fame_args(case, case["coin_bit"], dev)


def grid_fame_args(g, r_cap, dev, engine, frontier):
    st = engine.stage_frontier(g, dev)
    inv = frontier.build_inv(st.rows_by, st.la)
    fr = frontier.frontier_rounds(inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd,
                                  g.super_majority, r_cap)
    return (fr.witness_table, st.la, st.fd, st.index, st.coin_bit, fr.last_round,
            g.super_majority, g.n, r_cap + 2)


def k3_shape(cs, label, args, dev, timer, reps, card, root):
    from babble_tpu_torch.tpu import kernels

    wtable = args[0]
    n = wtable.shape[1]
    nbytes, ops_s = cs.fame_work(wtable, n)
    bytes_s = nbytes / cs.HBM_BYTES_S
    for packed in (False, True):
        want = tuple(kernels._decide_fame_plain(*args, packed=packed))
        plain_ms = timer.events(lambda: kernels._decide_fame_plain(*args, packed=packed))
        line = measure(label, lambda: kernels.decide_fame(*args, packed=packed),
                       equal_check(f"{label}, packed={packed}", want), timer, reps)
        line.update({"kernel": "decide_fame", "layout": "packed" if packed else "wide",
                     "validators": n, "rounds": wtable.shape[0],
                     "last_round": int(args[5]), "witnesses": int((wtable >= 0).sum()),
                     "decided": int(want[0].sum()), "plain_ms": plain_ms,
                     "bound_ms": max(bytes_s, ops_s) * 1e3,
                     "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                     "reps": reps, "root": root, "card": card})
        print(json.dumps(line), flush=True)


def b21_stage(sh, mesh, g, packed):
    """config #4's fame input staged as sharded_frontier_passes stages it."""
    from babble_tpu_torch.tpu.device import to_device
    from babble_tpu_torch.tpu.engine import pad_grid
    from babble_tpu_torch.tpu.frontier import sp_index_of
    from babble_tpu_torch.tpu.mesh import unshard

    import numpy as np

    grid_p = pad_grid(g)
    pad_e = grid_p.creator.shape[0] - g.e
    index_np = np.concatenate([g.index, np.full(pad_e, -1, np.int32)])
    sp_np = np.concatenate([sp_index_of(g), np.full(pad_e, -1, np.int32)])
    walk = sh.stage_walk(mesh, g, grid_p)
    hist = walk.walk(mesh)
    x_hist = unshard(hist, mesh, (None, walk.axis))
    index = to_device(index_np, mesh.device)
    _, _, wtable, last_round = sh.post(x_hist, to_device(walk.rb_pad, mesh.device),
                                       to_device(grid_p.creator, mesh.device), index,
                                       to_device(sp_np, mesh.device))
    wtable_np = wtable.cpu().numpy()[:, : g.n]
    la, fd = walk.la_parts[0], walk.fd_parts[0]
    return sh.stage_fame(mesh, g, wtable_np, la, fd, index, packed), last_round


class LoopWall:
    """The host wall of each call of the mesh's fame loop alone
    (`sharded._fame_loop`, what the ledger counts as local_fame), behind a
    synchronize on either side, while the context is open."""

    def __init__(self, sh, cuda):
        self.sh, self.cuda, self.ms = sh, cuda, []

    def __enter__(self):
        self.real = self.sh._fame_loop

        def timed(*a, **kw):
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self.sh._fame_loop = timed
        return self

    def __exit__(self, *exc):
        self.sh._fame_loop = self.real

    def median(self):
        return statistics.median(self.ms)


def b21_shape(cs, label, mesh, g, dev, timer, reps, card, root):
    from babble_tpu_torch.tpu import sharded as sh

    takes_form = "form" in inspect.signature(sh.sharded_fame).parameters
    forms = (None, "step") if takes_form else (None,)
    for packed in (True, False):
        stage, lr = b21_stage(sh, mesh, g, packed)

        def loop(form):
            kw = {"form": form} if form else {}
            return sh.sharded_fame(mesh, stage, lr, B21_CHUNK, g.n, g.super_majority, packed,
                                   **kw)

        saved = (sh.shard_tally, sh.shard_decide, sh.shard_active)
        sh.shard_tally, sh.shard_decide, sh.shard_active = (
            sh._shard_tally_plain, sh._shard_decide_plain, sh._shard_active_plain)
        try:
            want = tuple(loop("step" if takes_form else None))
            plain_ms = timer.wall(lambda: loop("step" if takes_form else None))
        finally:
            sh.shard_tally, sh.shard_decide, sh.shard_active = saved
        r_pad = stage.wvalid.shape[0]
        nbytes, ops_s = cs.shard_fame_work(cs.fame_stage_row_bytes(stage), r_pad,
                                           stage.wvalid.shape[1], stage.ss_s.shape[1],
                                           int(lr), sh.mesh_validator_shards(mesh))
        bytes_s = nbytes / cs.HBM_BYTES_S
        for form in forms:
            with LoopWall(sh, timer.cuda) as walls:
                line = measure(label, lambda: loop(form),
                               equal_check(f"{label}, packed={packed}, form {form}", want),
                               timer, reps)
            line.update({"kernel": "local_fame", "layout": "packed" if packed else "wide",
                         "form": form or "default", "validators": g.n, "rounds": r_pad,
                         "last_round": int(lr), "positions": mesh.size,
                         "decided": int(want[0].sum()), "loop_wall_ms": walls.median(),
                         "plain_wall_ms": plain_ms, "bound_ms": max(bytes_s, ops_s) * 1e3,
                         "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                         "reps": reps, "root": root, "card": card})
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
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        card = tfw.card_name()
        _ext.build_all()
    wanted = {s for s in args.shapes.split(";") if s}
    timer = tfw.Timer(dev)
    for label, make in k3_cases(cs, tfw, dev, args.cache):
        if not wanted or label in wanted:
            k3_shape(cs, label, make(), dev, timer, args.reps, card, args.root)
    meshes = {"1-D 8": cs.MESH_1D, "2-D (2, 4)": cs.MESH_2D}
    for mname, shape in meshes.items():
        label = f"B21 config #4, {mname}"
        if wanted and label not in wanted:
            continue
        mesh = DeviceMesh.on(dev, *shape)
        b21_shape(cs, label, mesh, tfw.grid_of(cs.WIDE, args.cache), dev, timer, args.reps,
                  card, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
