#!/usr/bin/env python3
"""Time the catch-up cell's two level-scan engines of one checkout of the
PyTorch/CUDA port on one CUDA card.

    python3 scripts/time_catchup_walls.py [--root DIR] [--runs N] [--split]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds bench_catchup.py's section (chip_smoke.CATCHUP: 8
validators, 32,760 events, 10,180 levels) on the card, and times
`run_passes(sec, bucketed=True, adaptive_r=True)` and
`run_doubling_passes(sec)`: the median host-clock wall of N warm runs,
each ending in a synchronize, after holding both engines' results to
chip_smoke.CATCHUP_EXPECT (last round, round offset, received events).
Each engine is timed twice: as it is (the card idle between runs, as a
late joiner's replay finds it) and with the card kept busy for
BUSY_SPIN_MS just before each run (as in chip_smoke.py, whose earlier
phases keep it busy), with the card's SM clock read before and after.
`--split` also takes run_doubling_passes' wall apart by stage and by
kernel (chip_smoke.cold_path_split) in both settings. Prints one JSON
line per engine and setting, with the card's name and power limit. Host
walls vary between calls: compare checkouts only within one call, in the
order A, B, B, A (README.md shows the command).
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

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the device spin before each run of the "busy" setting, and the H100's
# clock in cycles per millisecond that torch.cuda._sleep counts at
BUSY_SPIN_MS = 20
SPIN_CYCLES_PER_MS = 1_980_000


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--split", action="store_true",
                    help="take run_doubling_passes' wall apart by stage and kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_catchup_walls: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from babble_tpu_torch.tpu import _ext, doubling, engine
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid

    card = smi("name,power.limit")
    _ext.build_all()
    dev = torch.device("cuda")
    p = cs.CATCHUP
    deep = synthetic_deep_grid(p["n"], p["depth"], seed=p["seed"], zipf_a=p["zipf_a"])
    sec = section_grid(deep, engine.run_frontier_passes(deep, device=dev), deep.num_levels // 2)
    engines = (
        ("run_passes", lambda: engine.run_passes(sec, bucketed=True, adaptive_r=True, device=dev)),
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(sec, device=dev)),
    )

    def busy():
        torch.cuda._sleep(BUSY_SPIN_MS * SPIN_CYCLES_PER_MS)
        torch.cuda.synchronize()

    for name, fn in engines:
        res = fn()
        got = dict(last_round=res.last_round, round_offset=res.round_offset,
                   received=int((res.received >= 0).sum()))
        want = {k: cs.CATCHUP_EXPECT[k] for k in got}
        if got != want:
            raise AssertionError(f"{name} on the catch-up section: {got}, expected {want}")
        for setting, before in (("idle", None), ("busy", busy)):
            clock_before = smi("clocks.sm")
            walls = []
            for _ in range(args.runs):
                if before is not None:
                    before()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            line = dict(engine=name, shape="catch-up section", events=sec.e, card_before=setting,
                        median_ms=statistics.median(walls), min_ms=min(walls), runs=args.runs,
                        sm_clock_before=clock_before, sm_clock_after=smi("clocks.sm"))
            if args.split and name == "run_doubling_passes":
                line.update(split=cs.split_line(
                    "split", *cs.cold_path_split(fn, args.runs, before=before)))
            print(json.dumps(dict(line, root=args.root, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
