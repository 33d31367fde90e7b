#!/usr/bin/env python3
"""Time the walk_chunk kernel (K7, the cold path's frontier walk) of one
checkout of the PyTorch/CUDA port on one CUDA card.

    python3 scripts/time_walk_chunk.py [--root DIR] [--reps N] [--device cuda|cpu]

Imports `babble_tpu_torch` from DIR (default: the checkout that holds this
script), builds its kernels, and for three grids walks the cold path's
frontier with every chunk held to the plain version (torch.equal), then
times the largest chunk by CUDA events behind a spin (the card busy while
the host enqueues): the catch-up section of bench_catchup.py (8
validators), the bench grid (64) and BASELINE.json config #4's grid (256).
Prints one JSON line per grid: validators, chunk steps and probes, the
median kernel ms over N runs, the card's name and power limit. To compare
two versions of the kernel, run it against both checkouts in one call, in
the order A, B, B, A. `--device cpu` rehearses it on the plain versions
(wall-clock times).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SPIN_CYCLES = 1_000_000
GRIDS = (
    ("catch-up section", "deep", dict(n=8, depth=16384, seed=0, zipf_a=1.2)),
    ("bench grid", "grid", dict(n=64, e_count=32768, seed=0, zipf_a=1.1)),
    ("config #4 grid", "grid", dict(n=256, e_count=65536, seed=11, zipf_a=1.05,
                                    byzantine_frac=1.0 / 3.0)),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from babble_tpu_torch.tpu import _ext, doubling, engine, frontier
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    card = "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("time_walk_chunk: no CUDA device", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        _ext.build_all()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def time_ms(fn):
        times = []
        for k in range(args.reps + 2):
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

    for label, kind, spec in GRIDS:
        if kind == "deep":
            deep = synthetic_deep_grid(spec["n"], spec["depth"], seed=spec["seed"],
                                       zipf_a=spec["zipf_a"])
            g = section_grid(deep, engine.run_frontier_passes(deep, device=dev),
                             deep.num_levels // 2)
        else:
            g = synthetic_grid(spec["n"], spec["e_count"], seed=spec["seed"],
                               zipf_a=spec["zipf_a"],
                               byzantine_frac=spec.get("byzantine_frac", 0.0))
        st = doubling.stage_doubling(g, dev)
        inv = frontier.build_inv(st.rows_by_d, st.la_d)
        s_np, first_nw, x0 = doubling.walk_seeds(g, st)
        chunks = []

        def walk(*a):
            got = doubling._walk_chunk(*a)
            want = doubling._walk_chunk_plain(*a)
            sync()
            for x, y in zip(got, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"walk_chunk (length {a[10]}) on the {label}: "
                                         f"differs from the plain version")
            chunks.append(a)
            return got

        doubling._doubling_walk(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), inv, st.rows_by_d,
            st.fd_d, st.la_d, x0, s_np, first_nw, g.super_majority, st.l_b, st.seeded, {},
            walk=walk)
        big = max(chunks, key=lambda a: a[10])
        ms = time_ms(lambda: doubling._walk_chunk(*big))
        print(json.dumps({"grid": label, "validators": g.n, "steps": big[10],
                          "probes": big[11], "chunks": [a[10] for a in chunks],
                          "ms": ms, "reps": args.reps, "root": args.root, "card": card}),
              flush=True)
        del st, inv
    return 0


if __name__ == "__main__":
    sys.exit(main())
