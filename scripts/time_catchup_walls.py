#!/usr/bin/env python3
"""Time the catch-up cell's two level-scan engines of one checkout of the
PyTorch/CUDA port on one CUDA card.

    python3 scripts/time_catchup_walls.py [--root DIR] [--runs N]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds bench_catchup.py's section (chip_smoke.CATCHUP: 8
validators, 32,760 events, 10,180 levels) on the card, and times
`run_passes(sec, bucketed=True, adaptive_r=True)` and
`run_doubling_passes(sec)`: the median host-clock wall of N warm runs,
each ending in a synchronize, after holding both engines' results to
chip_smoke.CATCHUP_EXPECT (last round, round offset, received events).
Prints one JSON line per engine with the card's name and power limit.
Host walls vary between calls: compare checkouts only within one call,
in the order A, B, B, A (README.md shows the command).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=10)
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

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    _ext.build_all()
    dev = torch.device("cuda")
    p = cs.CATCHUP
    deep = synthetic_deep_grid(p["n"], p["depth"], seed=p["seed"], zipf_a=p["zipf_a"])
    sec = section_grid(deep, engine.run_frontier_passes(deep, device=dev), deep.num_levels // 2)
    engines = (
        ("run_passes", lambda: engine.run_passes(sec, bucketed=True, adaptive_r=True, device=dev)),
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(sec, device=dev)),
    )
    for name, fn in engines:
        res = fn()
        got = dict(last_round=res.last_round, round_offset=res.round_offset,
                   received=int((res.received >= 0).sum()))
        want = {k: cs.CATCHUP_EXPECT[k] for k in got}
        if got != want:
            raise AssertionError(f"{name} on the catch-up section: {got}, expected {want}")
        walls = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(dict(engine=name, shape="catch-up section", events=sec.e,
                              median_ms=statistics.median(walls), min_ms=min(walls),
                              runs=args.runs, root=args.root, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
