#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (babble_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds every kernel of the round-frontier path from
   babble_tpu_torch/csrc into build/torch_kernels (one nvcc per source, in
   parallel), with the build seconds and each kernel's ptxas report;
3. kernels: each kernel against its plain PyTorch version on the card,
   exact integer equality (torch.equal, tolerance 0), on the bench grid
   (64 validators, 32,768 Zipf-skewed events) and the small fixtures of
   the JAX suite's frontier tests, with CUDA-event times at the bench shapes;
   decide_fame in both layouts, also on random voting tables that reach a
   coin round (shown on the CPU first: flipping the coin bits changes the
   verdicts); K4 round_received, B23 fame_tables and B23 with B22's events
   (fame_received) on the bench grid's tables, the coin cases' and
   received_trap_case's (136 validators, two column tiles, at last_round
   -1, 3 and 6; 1,056 at 4; creators outside [0, n)); K1 build_inv on its
   trap table (build_inv_trap_cases: chains that fall and rise, entries
   at and past L and absent, padded slots, rows past E, e = 0, L = 1,
   ragged tiles, chains of several chunks, the catch-up section's shape
   and the width cell's), in the plan's form and with the chain axis in
   one segment, two and one a chunk;
4. end to end: run_frontier_passes on the card at the bench size, every
   field equal to the port's CPU run, last_round 26 and 28,065 received
   events (the JAX reference's result on this grid), every kernel's launch
   count above zero, and the median wall time over warm runs;
5. grids of the cold path: the catch-up cell of bench_catchup.py (8
   validators, synthetic_deep_grid(8, 16384, seed=0, zipf_a=1.2), 65,536
   events and 20,359 levels, cut at half its levels into a section of
   32,760 events and 10,180 levels) and an unpinned section, whose
   rounds stall (synthetic_deep_grid(8, 2048), pin_cut=False);
6. kernels of the level scan and the cold path against their plain
   versions on the card, torch.equal: divide_rounds and lamport_scan on
   the bench grid and both sections, closure_la (with its pass count; one
   launch a call to the fixed point) on the bench grid, there also at
   pass caps 1 and 2 (stopped before the fixed point), and the catch-up
   section, walk_chunk on every chunk of
   the bench grid's walk (unseeded) and both sections' (seeded; the
   first_nw mask must fire on the unpinned section), and on the catch-up
   section's largest chunk with `steps` forced to 1, 4 and 5, with one
   chain's la rows reversed and with the skip's traps (walk_chunk_traps:
   fewer than super_majority countable rows, unseeded and seeded, steps 1;
   each chunk's working and skipped steps logged), with launches and
   CUDA-event times (walk_chunk: the largest chunk's, and all six chunks'
   on the catch-up section); divide_rounds takes the one-block walk on
   the sections (8 validators) and the grid walk on the bench grid, where
   both walks are held to the plain version and timed (the crossover's
   two sides; again at 128 in phase 15); the one-block walk and
   lamport_scan in every carry form ("shared": the first rows that fit on
   chip, the rest in device memory; "device": every row there) on the
   catch-up section, the whole catch-up grid (65,536 events, more than
   fit on chip) and the trap tables of level_traps(), with each form's
   rows on chip and, on the section and the grid, its times;
7. the bench grid through run_doubling_passes and run_passes(bucketed,
   adaptive_r) on the card: equal to run_frontier_passes field for field,
   closure passes 5 and walk chunks 2, each path's kernels launched, and
   the median wall time over warm runs;
8. the catch-up cell: both engines on the card equal to each other and to
   the port's CPU run, last_round 1,022, round_offset 511, 32,536
   received, closure passes 4, walk chunks 6, 11 passes, each path's
   kernels launched, and events ordered per second replaying the section
   from cold (32,760 / the median wall time), and that wall taken apart by
   stage of the cold path and by kernel (cold_path_split: each stage
   behind a synchronize, the kernels' device time from torch.profiler,
   or from CUDA events around each launch where it records none);
9. the incremental engine's kernels (apply_deltas, step_levels,
   train_levels, decide_window) against their plain versions on the card:
   one state driven through the kernels and a clone through the plain
   versions, every IncState field torch.equal after every call, at the
   live step shape (the bench grid's 512 batches of batches_from_grid(grid,
   64, 8192, 65536), e_win 8192, r_win 64, r_cap 64), the train shape (its
   4 trains of trains_from_grid(grid, 8192, 524288, 32768, t_cap=832),
   e_win 16384) and test_incremental.py's 8-validator grid (batch 32,
   train 256; the unrolled offset d = 8 is a coin step), there also with
   r_win 8 < r_cap 16 (the window slides and freezes) and with two no-op
   batches (the live engine's padding) after its own, with each kernel's
   launches and CUDA-event times at the bench shapes. K10 and K11 walk
   their levels in one block on the fixture (also in the packed layout,
   with step and train_step over it run on their own for the one-block
   walks' launches) and across the card on the bench grid (64 validators:
   their grid walks, "step_levels/grid" and "train_levels/grid");
10. both append paths end to end on the bench grid, inputs on the card
   before timing: step over the 512 batches, multi_step in groups of 16
   (padded with no-op batches as the live engine pads them), train_step
   over the 4 trains and multi_train with K = 2 (e_win 24,576: a decide
   per two trains needs both trains' rows and the undecided tail in its
   window; at 16,384 the stale latch fires, in the JAX reference too,
   which is checked as well); each equal to run_passes
   on the card on rows [:e] of rounds, lamport, witness and received, with
   last_round 26, 28,065 received and no latch set, each path's kernels
   launched, and events appended per second (32,768 / the median wall
   time over 5 warm runs from a fresh state, one synchronize at the end);
11. K13 pack_results (the live engine's one result fetch) against its
   plain version, torch.equal, on the live step state that phase 10's step
   run leaves (n 64, e_cap 65,536, r_cap 64, e_win 8,192) at window starts
   0, count - e_win, past the clamp (e_cap - e_win + 1000) and negative
   (counted from the end, as jax.lax.dynamic_slice counts it), and on the
   8-validator fixture's state, with the launches and CUDA-event times
   (device work behind a spin, and with the host's wrapper in the window);
   then the fused route (the vector K12's last two launches write when the
   decide is handed one) held to K12 then the plain pack, and every state
   field to K12 alone, with no pack_results launch (fused_pack_phase):
   count < e_win, mid-range, = e_cap, stale latched by one block of
   many, fame_lag latched by dw_vote; dw_tables' and dw_events'
   device times with and without the pack (torch.profiler, A, B, B, A);
12. the hashgraph path at full width: the signed events of the bench grid's
   first 24,576 rows (the depth is cut from 32,768 so that the whole
   script stays near ten minutes; 1,140 levels) built once with the port's
   own crypto and hashgraph (HAVE_REAL_CRYPTO is
   printed; without the cryptography package the stub backend signs), then
   fed to a fresh port Hashgraph per run: (a) the host engine
   (run_consensus on the CPU), the reference of every other run; (b)
   run_consensus_device on the card, which must take the cold path (the
   prefix's 1,140 levels pass the crossover); (c)
   run_consensus_live after each sync of 64 events (384 calls) at the
   engine's defaults, then flush_live_engine: the main path of this slice;
   (d) r_cap 16, the pipelined fetch and syncs of 256 (advance takes
   multi_step): rebases, pipelined integrations and multi_step launches
   must all be above zero; (e) a late attach: 12,288 events inserted before
   the first call, whose bootstrap replays them through maybe_cold_replay
   (the doubling crossover set to 512 levels for that run, below the
   prefix's 571: at the reference's 1,024 the ladder's one-shot rung
   would take the call) and attaches from the frontier with fewer kept
   rows, then syncs of 64. Every call of (c)-(e) must stay on the live
   rung: a GridUnsupported from its write-back gates fails the phase, with
   no one-shot rung to take the call over. Each of (b)-(e) must give blocks
   byte-identical
   to (a) and the same round, lamport and round received for every event
   (a) received, and witnesses and fame in every round (a) decided; each
   path's kernels must launch; every call's pack rides its last decide's
   launch, so pack_results launches on its own 0 times in (c) and (d) (the
   attach's bootstrap replay packs too) and once in (e), whose attach from
   the frontier decides nothing (PATH_OWN_PACKS). Printed per run: calls,
   blocks, events received, the dispatch's host time a call and the packs
   by route, the summed host-clock seconds of the consensus calls (no
   synchronize after each call, so the pipelined fetch of (d) overlaps as
   in a node; one after the flush), events
   brought to consensus per second, and the per-layer milliseconds (batch
   build, device span of the step / multi_step / pack launches by CUDA
   events, fetch, integrate, host passes 4-5), and the phase's seconds.

13. the packed voting layout's kernels (K3p decide_fame/packed, K5p
   divide_rounds/packed, K10p step_levels/packed/grid, K12p
   decide_window/packed; K5p, K10p and K12p launch the wide kernels, whose
   counts are the packed layout's integers) and the two kernels repaired
   for 256 validators (walk_chunk, decide_window) against their plain
   versions on the card, torch.equal, on BASELINE.json config #4's grid at
   full width (synthetic_grid(256, 65536, seed=11, zipf_a=1.05,
   byzantine_frac=1/3), 677 levels): K2 frontier_rounds at the engine's
   r_cap 64, held to its plain version and timed; K6 closure_la (one
   launch to its fixed point) with its pass count, held to its plain
   version and timed; K3 in both layouts on its witness table (both
   timed), on test_packed.py's 7- and 33-validator fixtures and on the
   coin cases; K4 and B23 on its witness table's tables;
   K5p on the grid and a pinned section of it; walk_chunk on every chunk
   of its walk; on a state driven through its 1,024 batches of 64 (the
   live engine's defaults but e_win 65,536, phase 14's window; upd_cap the
   least power of two that holds the largest fd burst) apply_deltas and
   K10p after every call and the decide, packed and wide in turn, after
   every 8th (the kernels advance both states in between), and again at
   e_win 8,192, where the stale latch must fire, K10p and the decide every
   8th call, once with r_win 64 and once with r_win 62 < r_cap 64, where
   the window's floor clips below the first undecided round and the
   decide's freeze must hold; launches and CUDA-event times behind a spin;
14. config #4 through run_frontier_passes, run_passes and
   run_doubling_passes in the knob's layout (packed at 256) and with
   packed=False: each pair equal field for field, the engines equal to
   each other, last_round 7, 32,341 received and 1,853 witnesses (the JAX
   reference's result), packed launches above zero and no wide form of a
   layout kernel on a packed path; K3 in both layouts on
   run_frontier_passes' own witness table held to its plain version;
   events/s per engine, and
   run_doubling_passes' wall taken apart as in phase 8; step and
   multi_step (packed) over the same batches equal to run_passes on rows
   [:e] (e_win 65,536: the undecided tail outgrows smaller windows);
15. the hashgraph path at the layout's switch: synthetic_grid(128, 32768,
   seed=0, zipf_a=1.1). First divide_rounds' two walks held to the plain
   version on its level scan and timed; then its 512 batches of 64 at run (c)'s shape
   (upd_cap 16,384, e_win 32,768, r_cap and r_win 64) through apply_deltas,
   K10p and K12p, each held to its plain version after every call, no
   latch and events received at the end: the kernels line's times and
   bounds of K10p and K12p. Then the grid's first 20,480 events (cut from
   32,768 to pay for phase 16) as signed events: (a) the host engine (3 blocks, last
   round 6), (b) run_consensus_device, which must take the frontier rung
   in the packed layout, (c) run_consensus_live after each sync of 64 at
   the engine's defaults but upd_cap 16,384 and e_win 32,768 (the defaults
   are sized for 64 validators), every call on the live rung with the
   engine in the packed layout; blocks byte-identical to (a), with the
   per-layer milliseconds as in phase 12. The kernels line's launches of
   K10p and K12p are run (c)'s.
16. the frontier-live engine (tpu/frontier_live.py: K14 frontier_append,
   K15 frontier_window, then K3 / K3p and K4): (a) bench_incremental.py's
   cell, the bench grid's 4 trains of 8,192 at l_cap 4,096 and r_cap 128
   (INV 64 MiB) through frontier_train_step, K14, K15 and the decide held
   to their plain versions after every train, equal to run_passes on rows
   [:e] (last_round 26, 28,065 received, no latch), and
   frontier_multi_train over pairs of trains, with events appended per
   second (32,768 / the median of 5 warm runs from a fresh state); (b)
   config #4 in trains of 8,192 (l_cap 512, r_cap 32) in both layouts,
   each run held to the plain versions after every train and the wide
   one to the packed, both equal to phase 14's engines (7, 32,341,
   1,853 witnesses, no latch), then train_step (K11p held to its plain
   version after every train) and multi_train in the packed layout equal
   to the wide train_step; (c) bootstrap_frontier_state of the bench grid
   equal to run_frontier_passes; (d) config #5's width, synthetic_grid(1024,
   16384, seed=0, zipf_a=1.1, record_fd_updates=True) (depth cut: it stays
   in round 0), where K5, K10 and K11p take their grid walks, while K3
   and K12 (both layouts) keep the shared memory they take at every width,
   each held to its plain version (K2 too, with its time; the votes also
   on coin_round_case tables at 1,024 validators, where witnesses are
   decided, and K3 on coin_round_case(1056, 5, 7) in both layouts, past
   1,024, where its vote keeps each column's words in shared memory; K4
   on the grid's tables (timed: the kernels line's row at 1,024) and, with
   B23, on both coin cases'; K7 on
   every chunk of the cold path's walk and each trap of its largest chunk
   in its L2 form (every chain's probes counted in tiles), timed beside
   its plain version, with run_doubling_passes (packed) equal to
   run_frontier_passes), and
   frontier_train_step (packed), K14 and K15 held to their
   plain versions after every train (K15's bound printed), equal to
   run_frontier_passes (packed); launches of the grid walks under
   "<key>/grid", counted on runs
   of the entry points a user calls (run_passes, run_doubling_passes, step,
   multi_step, train_step, frontier_train_step) with nothing else in the
   window; (e) K7's cluster form at 8 blocks a cluster (512 threads a
   block, the partial counts summed through distributed shared memory) and
   its L2 form, each named, on the bench grid's generator at 512
   validators: every chunk of the cold path's walk and each trap of its
   largest chunk held torch.equal to the plain version in each form, that
   chunk timed beside its plain version (once) and
   its bound.
17. the device mesh (tpu/mesh.py, tpu/sharded.py, tpu/dispatch.py), every
   position of every mesh on the one card (torch.cuda.device_count() is
   printed; no number measures an interconnect): (a) each mesh kernel
   (B21 as one launch, shard_fame/grid, held to the plain step-by-step
   loop on every position's decided and famous, and its per-step form
   shard_fame/tally, /decide, /active; B23 with B22's events in one
   launch, fame_received, and their per-position form, B23 fame_tables and
   B22 received_search, named; K1 as one launch over every position's
   chains, and one a position, named; B24 as one launch, shard_walk/grid,
   held to the plain
   whole walk on every position's history, and its per-step form
   shard_walk/rows, /m0, /close; K3's setup fame_setup and K2's post
   frontier_post launched on their own) held torch.equal to its plain
   version after every launch, with CUDA-event times behind a spin:
   sharded_frontier_passes on config #4 on the 1-D mesh of 8 and the 2-D
   (2, 4) mesh (packed), sharded_fame with the per-step form named on
   config #4's fame input on both meshes in both layouts, on each coin
   case below and on the width cell's fame input (its decided and famous
   equal to the one-launch loop's), local_walk with the per-step
   form named on config #4's 1-D walk (every step; its history equal to
   the one-launch walk's), sharded_run_passes on the 1-D mesh (wide) and
   on the 2-D mesh (both layouts), the bench cell through
   sharded_frontier_passes on the 1-D mesh, the voting tables of
   coin_round_case(8, 20, 52) (coin steps at d = 8 and 16; both layouts),
   coin_round_case(1024, 6, 3) (packed) and coin_round_case(1056, 5, 7)
   (both layouts; 33 and 34 words, the vote's words in shared memory) on
   the 2-D mesh, equal to decide_fame's verdicts (past the plain versions'
   reach, coin_round_case(6400, 3, 5): K3 packed, one shard_fame/grid
   launch and the per-step kernels on the 1-D mesh equal to one another),
   and sharded_frontier_passes on
   synthetic_grid(1024, 16384, seed=0, zipf_a=1.1) (128 chains per
   position: the plain walk's binary search), equal to
   run_frontier_passes, and that walk on a one-card 1-D mesh of 128
   positions (8 chains each; the walk's address table lies in device
   memory, any number of positions): one launch, each history equal to
   the plain walk's and all of them to the 1-D 8 walk's row for row; (b)
   the three sharded engines on config #4 on
   both meshes and both layouts, each launching its path's kernels
   (run_path; the frontier walk, the fame loop and pass 3 as exactly one
   launch each of shard_walk/grid, shard_fame/grid and fame_received, and
   K1 as one build_inv launch, with none of their per-step or per-position
   kernels, whose launches come from local_walk, sharded_fame,
   sharded_build_inv and sharded_received with that form named) and equal
   to phase 14's engines (7, 32,341,
   1,853 witnesses; fame on the overlap), the median wall of 3 warm runs
   per engine and mesh (packed) (the bench cell's end-to-end run on the
   1-D mesh was cut to pay for phase 16(d)'s K7 chunk past a cluster's
   reach; 17(a) still holds it); (c) phase 15's
   20,480 signed events: run_consensus_device with the 2-D mesh, and
   run_consensus_mesh_queued (queue depth 4) after each sync of 4,096,
   then flush, both byte-identical to the host engine, every call on the
   queued rung and the stager's delta path taken.

The phases take about thirteen minutes on an H100; each phase's seconds
are printed. The next-to-last line is the per-kernel JSON summary; the
last line is {"ok": true, "device": {...}}. The script imports nothing of
JAX and nothing of the babble_tpu package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BENCH = dict(n=64, e_count=32768, seed=0, zipf_a=1.1)
BENCH_LAST_ROUND = 26
BENCH_RECEIVED = 28065
# the small fixtures of tests/test_frontier.py (n, e, seed, zipf, byzantine)
FIXTURES = [
    (4, 64, 1, 0.0, 0.0),
    (8, 256, 2, 0.0, 0.0),
    (8, 512, 3, 1.1, 0.0),
    (16, 1024, 4, 1.1, 0.0),
    (8, 300, 7, 2.0, 0.0),
    (32, 768, 9, 1.1, 0.0),
    (32, 1024, 11, 1.05, 1.0 / 3.0),
    (64, 2048, 13, 1.05, 1.0 / 3.0),
]
# (n, rounds, seed) of coin_round_case tables whose verdicts depend on the
# coin bits, i.e. whose voting reaches d = n with a witness undecided
COIN_CASES = [(4, 12, 9), (8, 20, 52)]
R_CAP = 64
DEVICE = "cuda"
E2E_RUNS = 20

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, non-tensor ALU
# operations/s (the float32 rate; int32 compare/min/add run on the same
# pipes), int8 tensor-core operations/s for 0/1 products
HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
INT8_TC_OPS_S = 1979e12

# the catch-up cell of bench_catchup.py, with the JAX reference's results
CATCHUP = dict(n=8, depth=16384, seed=0, zipf_a=1.2)
CATCHUP_GRID = (65536, 20359)  # events, levels
CATCHUP_SECTION = (32760, 10180)
CATCHUP_EXPECT = dict(last_round=1022, round_offset=511, received=32536,
                      closure_passes=4, walk_chunks=6, passes=11)
BENCH_DOUBLING = dict(closure_passes=5, walk_chunks=2)
UNPINNED = dict(n=8, depth=2048, seed=0, zipf_a=1.2)
UNPINNED_LAST_ROUND = 127
CATCHUP_RUNS = 5
# timed runs of a slow plain version (seconds a call on the catch-up
# section), after the run that checked the kernel against it
SLOW_PLAIN_REPS = 1
# the cold path's stages in tpu/doubling.py, whose walls cold_path_split
# takes apart (each behind a synchronize)
COLD_STAGES = ("stage_doubling", "_closure_la", "build_inv", "walk_seeds", "_doubling_walk",
               "seeded_lamport", "level_lamport", "_fame_received")
# K6's pass caps below the bench grid's fixed point (5 passes), held to the
# plain version with their pass counts
CLOSURE_TRAP_CAPS = (1, 2)

# the incremental engine: the live engine's defaults (babble_tpu/tpu/live.py
# ENGINE_DEFAULTS) for the step path, bench_incremental.py's constants for
# the train path, and the JAX reference's results on the bench grid
INC_STEP = dict(batch=64, upd_cap=8192, e_cap=65536, r_cap=64, r_win=64, e_win=8192)
INC_TRAIN = dict(size=8192, upd_cap=524288, e_cap=32768, t_cap=832, r_cap=64,
                 r_win=32, e_win=16384)
INC_BATCHES = 512
INC_TRAIN_LEVELS = [416, 384, 416, 384]
INC_WITNESSES = 1727
MULTI_STEP_K = 16
MULTI_TRAIN_K = 2
# one decide per two trains must see both trains' rows and the tail still
# undecided before them; at the train path's e_win 16,384 rows below the
# window stay undetermined and the stale latch fires with 23,380 received,
# at 24,576 none does: the JAX reference's results on the CPU, every field
# equal to the port's (tests/test_torch_incremental.py
# ::test_multi_train_window_on_the_bench_grid, marked slow)
MULTI_TRAIN_E_WIN = 24576
MULTI_TRAIN_UNDERSIZED = dict(stale=True, fame_lag=False, received=23380)
INC_RUNS = 5
# about half a millisecond of spinning at the H100's clock
SPIN_CYCLES = 1_000_000
# about five, for launchers whose host work passes half a millisecond
GRID_SPIN_CYCLES = 10_000_000
# test_incremental.py's 8-validator grid, its batch and train sizes
INC_FIXTURE = dict(n=8, e=768, seed=3, zipf_a=1.1, batch=32, train=256, w_cap=16,
                   t_cap=96, r_cap=64, e_win=512)

# BASELINE.json config #4 at its published widths (256 validators, a third
# byzantine, Zipf 1.05) with 65,536 events: at bench_scale.py's 16,384
# (and at 32,768) fame decides nothing. The JAX reference's results on
# the CPU, equal in all three engines and both layouts
WIDE = dict(n=256, e_count=65536, seed=11, zipf_a=1.05, byzantine_frac=1.0 / 3.0)
WIDE_EXPECT = dict(last_round=7, received=32341, witnesses=1853)
WIDE_LEVELS = 677
# the round axis of the frontier walk whose witness table phase 13 votes on
WIDE_R_CAP = 16
# the append state of phases 13-14: the live engine's defaults but e_win;
# upd_cap is the least power of two that holds the grid's largest fd
# burst, found in the run. The append paths hold every row in their
# write-back window: with about 8,200 events a round and fame settling two
# to three rounds behind, the undecided tail of this grid outgrows e_win
# 8,192, 16,384 and 32,768 (the stale latch fires and received stays
# short, on the H100 as in the plain versions: the window semantics are
# the JAX reference's)
WIDE_STEP = dict(batch=64, e_cap=65536, r_cap=64, r_win=64, e_win=65536)
# phase 13 holds the decide to its plain version after every
# WIDE_CHECK_EVERY-th call (packed and wide in turn; the kernel advances
# both states in between), apply_deltas and step_levels after every call
WIDE_CHECK_EVERY = 8
# and again at the live default e_win, where the latch fires on this grid,
# holding step_levels and the decide every WIDE_CHECK_EVERY-th call
WIDE_LATCH_E_WIN = 8192
# and once more at that window with r_win below r_cap: the window's floor
# clips to r_cap - r_win = 2, below the first undecided round, so the
# decide's freeze keeps the settled rounds between them as stored
WIDE_FREEZE_R_WIN = 62
WIDE_RUNS = 3
# test_packed.py's non-lane-aligned and word-crossing fixtures
PACKED_FIXTURES = [(7, 160, 9), (33, 400, 4)]
# the hashgraph path at the packed layout's switch (phase 15): the bench
# grid's generator at 128 validators (790 levels: the frontier rung), and
# the host engine's result on it
SWITCH = dict(n=128, e_count=32768, seed=0, zipf_a=1.1)
# the hashgraph runs take the grid's first SWITCH_DEPTH events (cut from
# 32,768 to pay for phase 16: the host engine alone took 88 s
# there), and the host engine's result on them (the whole grid gives 7
# blocks, last round 10)
SWITCH_DEPTH = 20480
SWITCH_EXPECT = (3, 6)  # blocks, last round
SWITCH_ONESHOT_RUNG = ("frontier", "run_frontier_passes, packed")
# run (c)'s two changes to the engine's defaults, which are sized for 64
# validators: at 128 a batch of 64 carries more fd updates than the
# default upd_cap of 8,192, and the undecided tail (about 3,300 events a
# round) outgrows the default write-back window e_win of 8,192 and 16,384
# (phase 15's kernel check prints the largest burst and drives the
# kernels at both short windows); a live rung refuses such a DAG alike in
# both packages (tests/test_torch_packed.py
# test_live_capacities_refuse_alike_at_128_validators)
SWITCH_LIVE = {"upd_cap": 16384, "e_win": 32768}
SWITCH_SHORT_E_WINS = (8192, 16384)
# phase 15's kernel check at run (c)'s shape: the switch grid's 512 batches
# of 64 through apply_deltas, step_levels/packed and decide_window/packed,
# each held to its plain version after every call (the live engine's r_cap
# 64, r_win 64, e_cap 65,536 with SWITCH_LIVE)
SWITCH_STEP = dict(batch=64, e_cap=65536, r_cap=64, r_win=64, **SWITCH_LIVE)

# phase 16, the frontier-live engine: (a) bench_incremental.py's train
# cell, phase 10's four trains with its l_cap and r_cap (INV 64 MiB), and
# (c) the cold-start bootstrap of the bench grid at the same capacities
FL_BENCH = dict(l_cap=4096, r_cap=128)
FL_RUNS = 5
# (b) config #4 in trains of 8,192: l_cap the least power of two above the
# hottest chain plus a margin, r_cap 32 (at least R_WIN; last_round 7); the
# incremental train paths at the same trains, e_win holding every row as
# phase 14's step does
FL_WIDE = dict(train=8192, upd_cap=1 << 22, t_cap=832, l_margin=64, r_cap=32)
FL_WIDE_INC = dict(e_cap=65536, r_cap=64, r_win=64, e_win=65536)
# (d) BASELINE.json config #5's width (1,024 validators) at a cut depth:
# 16,384 events, a few rounds and nothing received (config #5's depth waits
# for a host grid generator that scales: ROADMAP). The widest launches of
# every kernel run here, held to their plain versions: K3 in both layouts,
# K10 after every batch, the decide after every FL_WIDTH_CHECK_EVERY-th
# (packed and wide in turn); the launch counts come from the entry points'
# own runs (run_passes, step, multi_step, train_step, frontier_train_step)
FL_WIDTH = dict(n=1024, e_count=16384, seed=0, zipf_a=1.1)
# (e) K7's two grid forms where the cluster form takes its widest
# clusters (8 blocks of 512 threads): the bench grid's generator at 512
# validators (the grid scripts/time_walk_chunk.py times)
CLUSTER_WIDE = dict(BENCH, n=512)
FL_WIDTH_BATCH = 64
FL_WIDTH_TRAIN = 8192
FL_WIDTH_CHECK_EVERY = 64
# the grid stays in round 0 at that depth, so the votes (K3 in both layouts,
# K12) are also held on coin_round_case tables at 1,024 validators:
# (n, rounds, seed), strongly-seeing common and the votes split, so that
# witnesses are decided
FL_WIDTH_COIN = (1024, 6, 3)
# the same past 1,024 validators, where the vote keeps each column's words
# in shared memory instead of registers (33 words; 34 on the 2-D mesh's
# packed layout, lane-aligned per validator shard)
WIDE_VOTE_CASE = (1056, 5, 7)
# and past the plain versions' reach (their setup's (N, N, N) count needs
# 64 GiB from 2,048 validators): 200 words, where the vote's ring takes 7
# slots beside the columns' words; held in phase 17(a) kernel to kernel
FAR_VOTE_CASE = (6400, 3, 5)

# the device mesh (phase 17): every position of every mesh on the one card
MESH_1D = ((8,), ("rounds",))
# phase 17(a): the width cell's walk on a one-card mesh of 128 positions
# (8 chains each) in one launch
MESH_WIDE_1D = ((128,), ("rounds",))
MESH_2D = ((2, 4), ("validators", "rounds"))
MESH_RUNS = 3
# voting tables that reach coin steps on a mesh (8 validators, 20 rounds:
# d = 8 and 16), the 1,024-validator tables of phase 16(d), where
# witnesses are decided (a coin step there needs d = 1,024), and phase
# 16(d)'s tables past 1,024 (the vote's words in shared memory), each with
# the layouts held on the 2-D mesh
MESH_COIN_CASES = (((8, 20, 52), (True, False)), (FL_WIDTH_COIN, (True,)),
                   (WIDE_VOTE_CASE, (True, False)))
MESH_WIDTH = dict(n=1024, e_count=16384, seed=0, zipf_a=1.1)
# run (c): phase 15's signed events in syncs of MESH_SYNC (five calls, one
# more than the queue's depth: a full stage, then deltas), the queue depth
MESH_SYNC = 4096
MESH_QUEUE_DEPTH = 4
# the cell whose checked calls give each mesh kernel's times and bound in
# the kernels line (the others' are printed): the kernels line's name ->
# (cell, checked name); B21's per-step kernels from the loops run with that
# form named, its one launch from the engines' own loops
MESH_STEP_CELL = "config #4, 1-D 8, packed, per-step form"
MESH_STEP_CELL_WIDE = "config #4, 1-D 8, wide, per-step form"
# K1 and B22 named per position (the form of positions on distinct cards)
MESH_POSITION_CELL = "config #4 frontier, 1-D 8, packed, per-position form"
MESH_TIMED_CELL = {
    "shard_fame/grid/packed": "config #4 frontier, 1-D 8, packed",
    "shard_fame/grid": "config #4 level scan, 1-D 8, wide",
    "shard_fame/tally/packed": MESH_STEP_CELL,
    "shard_fame/decide/packed": MESH_STEP_CELL,
    "shard_fame/active": MESH_STEP_CELL,
    "fame_received": "config #4 frontier, 1-D 8, packed",
    "build_inv (config #4 mesh)": ("config #4 frontier, 1-D 8, packed", "build_inv"),
    "fame_tables": MESH_POSITION_CELL,
    "received_search": MESH_POSITION_CELL,
    "fame_setup/packed": "config #4 frontier, 1-D 8, packed",
    "shard_walk/rows": "config #4 frontier, 1-D 8, packed",
    "shard_walk/m0": "config #4 frontier, 1-D 8, packed",
    "shard_walk/close": "config #4 frontier, 1-D 8, packed",
    "shard_walk/grid": "config #4 frontier, 1-D 8, packed",
    "frontier_post": "config #4 frontier, 1-D 8, packed",
    "shard_fame/tally": MESH_STEP_CELL_WIDE,
    "shard_fame/decide": MESH_STEP_CELL_WIDE,
    "fame_setup": "config #4 level scan, 1-D 8, wide",
    "fame_setup/packed (1,024)": ("width cell frontier, 1-D 8, packed", "fame_setup/packed"),
}
REPLACES = {
    "build_inv": ("babble_tpu_torch/csrc/build_inv.cu", "babble_tpu/tpu/frontier.py:116"),
    "frontier_rounds": ("babble_tpu_torch/csrc/frontier_walk.cu", "babble_tpu/tpu/frontier.py:299"),
    "decide_fame": ("babble_tpu_torch/csrc/decide_fame.cu", "babble_tpu/tpu/kernels.py:335"),
    "round_received": ("babble_tpu_torch/csrc/round_received.cu", "babble_tpu/tpu/kernels.py:424"),
    # K4 at 1,024 validators (phase 16(d))
    "round_received (1,024)": ("babble_tpu_torch/csrc/round_received.cu",
                               "babble_tpu/tpu/kernels.py:424"),
    "divide_rounds": ("babble_tpu_torch/csrc/divide_rounds.cu", "babble_tpu/tpu/kernels.py:118"),
    "closure_la": ("babble_tpu_torch/csrc/closure_la.cu", "babble_tpu/tpu/doubling.py:172"),
    "walk_chunk": ("babble_tpu_torch/csrc/walk_chunk.cu", "babble_tpu/tpu/doubling.py:296"),
    "lamport_scan": ("babble_tpu_torch/csrc/lamport_scan.cu", "babble_tpu/tpu/doubling.py:443"),
    # K9's own launch, on the train paths (phase 9's train shape); the step
    # paths run it inside step_levels, whose rows count its work
    "apply_deltas": ("babble_tpu_torch/csrc/apply_deltas.cu", "babble_tpu/tpu/incremental.py:213"),
    # K10 and K11: the one-block walk below each one's crossover (the
    # 8-validator fixture, phase 9), the grid walk from there
    "step_levels": ("babble_tpu_torch/csrc/step_levels.cu", "babble_tpu/tpu/incremental.py:243"),
    "train_levels": ("babble_tpu_torch/csrc/train_levels.cu", "babble_tpu/tpu/incremental.py:570"),
    "step_levels/grid": ("babble_tpu_torch/csrc/step_levels.cu",
                         "babble_tpu/tpu/incremental.py:243"),
    "train_levels/grid": ("babble_tpu_torch/csrc/train_levels.cu",
                          "babble_tpu/tpu/incremental.py:570"),
    "decide_window": ("babble_tpu_torch/csrc/decide_window.cu", "babble_tpu/tpu/incremental.py:361"),
    "pack_results": ("babble_tpu_torch/csrc/pack_results.cu", "babble_tpu/tpu/live.py:757"),
    # the packed layout's launches of the four kernels that take it
    "decide_fame/packed": ("babble_tpu_torch/csrc/decide_fame.cu",
                           "babble_tpu/tpu/kernels.py:335"),
    "divide_rounds/packed/grid": ("babble_tpu_torch/csrc/divide_rounds.cu",
                                  "babble_tpu/tpu/kernels.py:118"),
    "step_levels/packed": ("babble_tpu_torch/csrc/step_levels.cu",
                           "babble_tpu/tpu/incremental.py:243"),
    "step_levels/packed/grid": ("babble_tpu_torch/csrc/step_levels.cu",
                                "babble_tpu/tpu/incremental.py:243"),
    "decide_window/packed": ("babble_tpu_torch/csrc/decide_window.cu",
                             "babble_tpu/tpu/incremental.py:361"),
    "train_levels/packed": ("babble_tpu_torch/csrc/train_levels.cu",
                            "babble_tpu/tpu/incremental.py:570"),
    "train_levels/packed/grid": ("babble_tpu_torch/csrc/train_levels.cu",
                                 "babble_tpu/tpu/incremental.py:570"),
    # the frontier-live engine (phase 16)
    "frontier_append": ("babble_tpu_torch/csrc/frontier_append.cu",
                        "babble_tpu/tpu/frontier_live.py:113"),
    "frontier_window": ("babble_tpu_torch/csrc/frontier_walk.cu",
                        "babble_tpu/tpu/frontier_live.py:184"),
    # K2 at config #4 (phase 13) and K2, K15 at 1,024 validators (phase 16(d))
    "frontier_rounds (config #4)": ("babble_tpu_torch/csrc/frontier_walk.cu",
                                    "babble_tpu/tpu/frontier.py:299"),
    # K6 at config #4 (phase 13)
    "closure_la (config #4)": ("babble_tpu_torch/csrc/closure_la.cu",
                               "babble_tpu/tpu/doubling.py:172"),
    # K7's grid forms: the cluster form on the bench grid (phase 6, one
    # block a cluster) and config #4 (phase 13, two), the L2 form (phase
    # 16(d), 1,024 validators: tiles of every chain's probes)
    "walk_chunk (bench grid)": ("babble_tpu_torch/csrc/walk_chunk.cu",
                                "babble_tpu/tpu/doubling.py:296"),
    "walk_chunk (config #4)": ("babble_tpu_torch/csrc/walk_chunk.cu",
                               "babble_tpu/tpu/doubling.py:296"),
    "walk_chunk (1,024)": ("babble_tpu_torch/csrc/walk_chunk.cu",
                           "babble_tpu/tpu/doubling.py:296"),
    "frontier_rounds (1,024)": ("babble_tpu_torch/csrc/frontier_walk.cu",
                                "babble_tpu/tpu/frontier.py:299"),
    "frontier_window (1,024)": ("babble_tpu_torch/csrc/frontier_walk.cu",
                                "babble_tpu/tpu/frontier_live.py:184"),
    # K3 wide at config #4 (phase 13), K3 in both layouts and the level
    # walks' grid forms at 1,024 validators (phase 16(d))
    "decide_fame (config #4)": ("babble_tpu_torch/csrc/decide_fame.cu",
                                "babble_tpu/tpu/kernels.py:335"),
    "decide_fame/packed (1,024)": ("babble_tpu_torch/csrc/decide_fame.cu",
                                   "babble_tpu/tpu/kernels.py:335"),
    "decide_fame (1,024)": ("babble_tpu_torch/csrc/decide_fame.cu",
                            "babble_tpu/tpu/kernels.py:335"),
    "divide_rounds/grid": ("babble_tpu_torch/csrc/divide_rounds.cu",
                           "babble_tpu/tpu/kernels.py:118"),
    "step_levels/packed/grid (1,024)": ("babble_tpu_torch/csrc/step_levels.cu",
                                        "babble_tpu/tpu/incremental.py:243"),
    "train_levels/packed/grid (1,024)": ("babble_tpu_torch/csrc/train_levels.cu",
                                         "babble_tpu/tpu/incremental.py:570"),
    "decide_window/packed (1,024)": ("babble_tpu_torch/csrc/decide_window.cu",
                                     "babble_tpu/tpu/incremental.py:361"),
    "decide_window (1,024)": ("babble_tpu_torch/csrc/decide_window.cu",
                              "babble_tpu/tpu/incremental.py:361"),
    # the device mesh (phase 17)
    "shard_fame/tally": ("babble_tpu_torch/csrc/shard_fame.cu", "babble_tpu/tpu/sharded.py:149"),
    "shard_fame/tally/packed": ("babble_tpu_torch/csrc/shard_fame.cu",
                                "babble_tpu/tpu/sharded.py:149"),
    "shard_fame/decide": ("babble_tpu_torch/csrc/shard_fame.cu", "babble_tpu/tpu/sharded.py:149"),
    "shard_fame/decide/packed": ("babble_tpu_torch/csrc/shard_fame.cu",
                                 "babble_tpu/tpu/sharded.py:149"),
    "shard_fame/active": ("babble_tpu_torch/csrc/shard_fame.cu", "babble_tpu/tpu/sharded.py:149"),
    # B21's whole loop in one cooperative launch (every position on one card)
    "shard_fame/grid": ("babble_tpu_torch/csrc/shard_fame.cu", "babble_tpu/tpu/sharded.py:149"),
    "shard_fame/grid/packed": ("babble_tpu_torch/csrc/shard_fame.cu",
                               "babble_tpu/tpu/sharded.py:149"),
    "received_search": ("babble_tpu_torch/csrc/round_received.cu",
                        "babble_tpu/tpu/sharded.py:302"),
    "fame_tables": ("babble_tpu_torch/csrc/round_received.cu", "babble_tpu/tpu/sharded.py:329"),
    # B22's events in B23's launch, every position on one card (B23's
    # tables: sharded.py:329)
    "fame_received": ("babble_tpu_torch/csrc/round_received.cu",
                      "babble_tpu/tpu/sharded.py:302"),
    # K1 over every position's chains in one launch (config #4's mesh)
    "build_inv (config #4 mesh)": ("babble_tpu_torch/csrc/build_inv.cu",
                                   "babble_tpu/tpu/frontier.py:116"),
    "shard_walk/rows": ("babble_tpu_torch/csrc/frontier_walk.cu",
                        "babble_tpu/tpu/sharded.py:549"),
    "shard_walk/m0": ("babble_tpu_torch/csrc/frontier_walk.cu", "babble_tpu/tpu/sharded.py:549"),
    "shard_walk/close": ("babble_tpu_torch/csrc/frontier_walk.cu",
                         "babble_tpu/tpu/sharded.py:549"),
    # the same walk in one cooperative launch (every position on one card)
    "shard_walk/grid": ("babble_tpu_torch/csrc/frontier_walk.cu",
                        "babble_tpu/tpu/sharded.py:549"),
    # K3's setup and K2's post pass launched on their own by the mesh path
    "fame_setup": ("babble_tpu_torch/csrc/decide_fame.cu", "babble_tpu/tpu/kernels.py:335"),
    "fame_setup/packed": ("babble_tpu_torch/csrc/decide_fame.cu",
                          "babble_tpu/tpu/kernels.py:335"),
    "fame_setup/packed (1,024)": ("babble_tpu_torch/csrc/decide_fame.cu",
                                  "babble_tpu/tpu/kernels.py:335"),
    "frontier_post": ("babble_tpu_torch/csrc/frontier_walk.cu",
                      "babble_tpu/tpu/frontier.py:299"),
}
# the kernels each engine's call must launch
PATH_KERNELS = {
    "run_frontier_passes": ("build_inv", "frontier_rounds", "decide_fame", "round_received"),
    # divide_rounds walks the levels across the grid from
    # _ext.DIVIDE_ROUNDS_GRID_FROM validators (the bench grid and up), in
    # one block below (the catch-up section's 8)
    "run_passes": ("divide_rounds/grid", "decide_fame", "round_received"),
    "run_passes, catch-up section": ("divide_rounds", "decide_fame", "round_received"),
    "run_doubling_passes": ("closure_la", "build_inv", "walk_chunk", "decide_fame",
                            "round_received"),
    "run_doubling_passes, seeded": ("closure_la", "build_inv", "walk_chunk", "lamport_scan",
                                    "decide_fame", "round_received"),
    # the level walks of K10 (K11) take the grid from 64 (48) validators
    # (_ext.STEP_LEVELS_GRID_FROM, TRAIN_LEVELS_GRID_FROM): the bench grid
    # and up; one block on the 8-validator fixture. The step paths run K9
    # as phase 0 of K10's launch (PATH_NO_OWN_K9), the train paths launch
    # it on its own
    "step": ("step_levels/grid", "decide_window"),
    "multi_step": ("step_levels/grid", "decide_window"),
    "train_step": ("apply_deltas", "train_levels/grid", "decide_window"),
    "multi_train": ("apply_deltas", "train_levels/grid", "decide_window"),
    "step, 8-validator fixture": ("step_levels", "decide_window"),
    "train_step, 8-validator fixture": ("apply_deltas", "train_levels", "decide_window"),
    "step, 8-validator fixture, packed": ("step_levels/packed", "decide_window/packed"),
    "train_step, 8-validator fixture, packed": ("apply_deltas", "train_levels/packed",
                                                "decide_window/packed"),
    # the live runs: every call's pack rides its last decide's launch
    # (PATH_OWN_PACKS), the attach from the frontier packs on its own
    "run_consensus_live": ("step_levels/grid", "decide_window"),
    "late attach": ("closure_la", "build_inv", "walk_chunk", "decide_fame",
                    "round_received", "step_levels/grid", "decide_window", "pack_results"),
    # the packed layout: a path whose label ends in ", packed" must launch
    # these and no wide form of the four kernels that take the layout
    "run_frontier_passes, packed": ("build_inv", "frontier_rounds", "decide_fame/packed",
                                    "round_received"),
    "run_passes, packed": ("divide_rounds/packed/grid", "decide_fame/packed",
                           "round_received"),
    "run_doubling_passes, packed": ("closure_la", "build_inv", "walk_chunk",
                                    "decide_fame/packed", "round_received"),
    "step, packed": ("step_levels/packed/grid", "decide_window/packed"),
    "multi_step, packed": ("step_levels/packed/grid", "decide_window/packed"),
    "run_consensus_live, packed": ("step_levels/packed/grid", "decide_window/packed"),
    "train_step, packed": ("apply_deltas", "train_levels/packed/grid", "decide_window/packed"),
    "multi_train, packed": ("apply_deltas", "train_levels/packed/grid",
                            "decide_window/packed"),
    # the frontier-live engine
    "frontier_train_step": ("frontier_append", "frontier_window", "decide_fame",
                            "round_received"),
    "frontier_multi_train": ("frontier_append", "frontier_window", "decide_fame",
                             "round_received"),
    "frontier_train_step, packed": ("frontier_append", "frontier_window",
                                    "decide_fame/packed", "round_received"),
    "bootstrap_frontier_state": ("build_inv", "walk_chunk", "frontier_window",
                                 "decide_fame", "round_received"),
    # at 1,024 validators the level walks take their grid forms
    "run_frontier_passes (1,024), packed": ("build_inv", "frontier_rounds",
                                            "decide_fame/packed", "round_received"),
    "frontier_train_step (1,024), packed": ("frontier_append", "frontier_window",
                                            "decide_fame/packed", "round_received"),
    "run_passes (1,024)": ("divide_rounds/grid", "decide_fame", "round_received"),
    "step (1,024), packed": ("step_levels/packed/grid", "decide_window/packed"),
    "multi_step (1,024)": ("step_levels/grid", "decide_window"),
    # K7's L2 form (past a cluster's reach) on the cold path
    "run_doubling_passes (1,024), packed": ("closure_la", "build_inv", "walk_chunk",
                                            "decide_fame/packed", "round_received"),
    "train_step (1,024), packed": ("apply_deltas", "train_levels/packed/grid",
                                   "decide_window/packed"),
    # the device mesh: passes 2+3 of every sharded engine; on the one card
    # K1, the frontier walk, the fame loop and pass 3 (B23 with B22's
    # events) are one launch each (_ext.shard_walk_form, require_one_card),
    # and their per-position kernels run when a caller names that form
    "sharded_frontier_passes": ("build_inv", "shard_walk/grid", "frontier_post", "fame_setup",
                                "shard_fame/grid", "fame_received"),
    "sharded_frontier_passes, packed": ("build_inv", "shard_walk/grid", "frontier_post",
                                        "fame_setup/packed", "shard_fame/grid/packed",
                                        "fame_received"),
    "local_walk, per-step form": ("shard_walk/rows", "shard_walk/m0", "shard_walk/close"),
    "sharded_build_inv, per-position form": ("build_inv",),
    "sharded_received, per-position form": ("fame_tables", "received_search"),
    "sharded_fame, per-step form": ("shard_fame/tally", "shard_fame/decide",
                                    "shard_fame/active"),
    "sharded_fame, per-step form, packed": ("shard_fame/tally/packed",
                                            "shard_fame/decide/packed", "shard_fame/active"),
    "sharded_run_passes": ("divide_rounds/grid", "fame_setup", "shard_fame/grid",
                           "fame_received"),
    "sharded_run_passes, packed": ("divide_rounds/packed/grid", "fame_setup/packed",
                                   "shard_fame/grid/packed", "fame_received"),
    "sharded_doubling_passes": ("closure_la", "build_inv", "walk_chunk", "fame_setup",
                                "shard_fame/grid", "fame_received"),
    "sharded_doubling_passes, packed": ("closure_la", "build_inv", "walk_chunk",
                                        "fame_setup/packed", "shard_fame/grid/packed",
                                        "fame_received"),
    "sharded_frontier_passes (1,024), packed": ("build_inv", "shard_walk/grid",
                                                "frontier_post", "fame_setup/packed",
                                                "shard_fame/grid/packed",
                                                "fame_received"),
}
# K13's own launches on the live paths: none where every call decides (the
# attach's bootstrap replay packs too), one where the attach comes from the
# frontier with nothing to replay (phase 12 (e))
PATH_OWN_PACKS = {"run_consensus_live": 0, "run_consensus_live, packed": 0, "late attach": 1}
# the step paths, which run K9 as phase 0 of step_levels' launch (both
# walks) and launch no apply_deltas of their own
PATH_NO_OWN_K9 = ("step", "multi_step", "step, 8-validator fixture",
                  "step, 8-validator fixture, packed", "run_consensus_live", "late attach",
                  "step, packed", "multi_step, packed", "run_consensus_live, packed",
                  "step (1,024), packed", "multi_step (1,024)")
# the wide forms of the layout kernels, which a packed path must not launch
WIDE_FORMS = ("decide_fame", "divide_rounds", "step_levels", "train_levels",
              "decide_window", "divide_rounds/grid", "step_levels/grid", "train_levels/grid",
              "shard_fame/tally", "shard_fame/decide", "fame_setup", "shard_fame/grid")
# run_consensus_device's rung on phase 12's DAG (its 1,140 levels pass the
# 1,024-level crossover) and that rung's kernels
HG_ONESHOT_RUNG = ("doubling", "run_doubling_passes")
# the hashgraph path (phase 12): the bench grid's first HG_DEPTH events
# (cut from 32,768 to keep the script near ten minutes with phases 13-15;
# still past the crossover) in syncs, the live engine's defaults for (c),
# r_cap 16 as test_device_backend.py uses it with the pipelined fetch and
# syncs of 256 for (d), a late attach after half the events for (e), with
# the doubling crossover below that prefix's depth (571 levels) so that
# its bootstrap takes the cold path
HG_DEPTH = 24576
HG_SYNC = 64
HG_REBASE = dict(r_cap=16, async_fetch=True, sync=256)
HG_LATE_ATTACH = 12288
HG_CROSSOVER = "512"
HG_CACHE = 1 << 16


def log(*a):
    print(*a, flush=True)


class PhaseClock:
    """Logs each phase's host-clock seconds when the next one starts, and
    the script's total at the end."""

    def __init__(self, log_fn):
        self.log, self.t0 = log_fn, time.perf_counter()
        self.name, self.start = None, self.t0

    def next(self, name):
        now = time.perf_counter()
        if self.name is not None:
            self.log(f"phase {self.name}: {now - self.start:.1f} s")
        self.name, self.start = name, now
        if name is None:
            self.log(f"all phases: {now - self.t0:.1f} s")


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of fn() over reps runs, each between two CUDA
    events, after `warmup` warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spun_ms(fn, reps, warmup=2):
    """Median milliseconds of fn()'s device work over reps runs: the card
    spins before the first event, so the host's wrapper and enqueue time
    overlap the spin and the events time the launches' device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def closure_la_work(cs, la_fin, passes):
    """closure_la's (bytes, seconds of operations) on staged inputs cs (a
    DoublingInputs) from this run's result: the parent tables and the chain
    table read and la written once; the last pass's squaring over the
    closed iterate's set coordinates, each earlier one over la0's, and the
    chain prefix every pass."""
    from babble_tpu_torch.tpu import doubling

    n, l = cs.rows_by_d.shape
    la0 = doubling._closure_init(cs.creator_d, cs.idx_d, cs.sp_d, cs.op_d, n)
    nonneg_fin = int((la_fin >= 0).sum().item())
    nonneg_0 = int((la0 >= 0).sum().item())
    prefix_ops = n * l * n
    return (4 * cs.idx_d.shape[0] * 4 + n * l * 4 + la_fin.numel() * 4,
            (nonneg_fin * n + prefix_ops
             + (int(passes) - 1) * (nonneg_0 * n + prefix_ops)) / ALU_OPS_S)


def walk_chunk_steps(big, xs=None):
    """The steps of one walk_chunk call (`big`: its arguments), from the
    plain version's history (`xs`, computed where not given): `working`,
    those whose frontier still holds a row (X below l somewhere);
    `skipped`, those with fewer than super_majority countable frontier
    rows, whose search every form skips; `countable`, the countable rows of
    each step that searches."""
    from babble_tpu_torch.tpu import doubling

    sm, l, length, steps, use_seeds = big[8:]
    if xs is None:
        xs = doubling._walk_chunk_plain(*big)[1]
    x_before = torch.cat([big[4][None, :], xs[:-1]])
    ok = x_before < l
    if use_seeds:
        ok &= ~((x_before == 0) & (big[6][:, None] == big[7][None, :]))
    n_ok = ok.sum(dim=1)
    searched = [int(v) for v in n_ok.tolist() if v >= sm and steps >= 1]
    return dict(working=int((x_before < l).any(dim=1).sum().item()),
                skipped=length - len(searched), countable=searched)


def walk_chunk_live(big, depth):
    """The live chains of every search round of the L2 form at tree depth
    `depth`, for each step of one walk_chunk call (`big`: its arguments)
    that searches: a chain is live while it has events and has not settled
    (lo >= hi with hi <= l - 1: its hi and m0 can no longer change). The
    search is the plain version's iteration, on the plain history's
    frontiers; the settled set is the same whether or not settled chains
    are counted."""
    from babble_tpu_torch.tpu import doubling

    inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, sm, l, length, steps, use_seeds = big
    xs = doubling._walk_chunk_plain(*big)[1]
    x_before = torch.cat([x0[None, :], xs[:-1]])
    n = x0.numel()
    cc = torch.arange(n, device=x0.device)
    rb = rows_by.clamp(min=0).long()
    clen = (rows_by >= 0).sum(dim=1)
    last = (clen - 1).clamp(min=0)
    out = []
    for k in range(length):
        x = x_before[k]
        ok = x < l
        if use_seeds:
            ok &= ~((x == 0) & (r_abs[k] == first_nw))
        if int(ok.sum()) < sm or steps < 1:
            continue
        fd_w = fd[rb[ok.nonzero().flatten(), x[ok].clamp(0, l - 1).long()]]
        lo, hi = x.clamp(0, l).long(), torch.full((n,), l, device=x.device, dtype=torch.long)
        rounds, done = [], 0
        while done < steps:
            d = min(depth, steps - done)
            rounds.append(int(((clen > 0) & ~((lo >= hi) & (hi <= l - 1))).sum()))
            for _ in range(d):
                mid = torch.clamp((lo + hi) // 2, max=l - 1)
                rows = la[rb[cc, torch.minimum(mid, last)]]
                seen = torch.cat([((rows[c0:c0 + 128, None, :] >= fd_w[None, :, :]).sum(dim=2)
                                   >= sm).sum(dim=1) for c0 in range(0, n, 128)])
                pred = (seen >= sm) & (clen > 0)
                hi = torch.where(pred, torch.minimum(mid, hi), hi)
                lo = torch.where(pred, lo, mid + 1)
            done += d
        out.append(rounds)
    return out


def walk_chunk_work(big, l_c, n_s):
    """((bytes, seconds at the peak rates), walk_chunk_steps) of one
    walk_chunk call (`big`: its arguments) over n_s validators with chain
    length l_c: the steps that search (the others need no compares), each
    reading its countable frontier rows, the probed rows and the closure's
    INV terms (at most every input once), and counting each probe against
    its countable rows at the ALU rate."""
    st = walk_chunk_steps(big)
    steps = big[11]
    searched_bytes = sum(n_ok * n_s * 4 + n_s * steps * n_s * 4 + n_s * n_s * 4
                         for n_ok in st["countable"])
    return ((min(searched_bytes, big[0].numel() * 4 + big[2].numel() * 4
                 + big[3].numel() * 4 + big[1].numel() * 4)
             + big[5].numel() * 4 + big[6].numel() * 4 + big[10] * n_s * 4 + 3 * n_s * 4,
             sum(n_s * steps * n_s * n_ok + n_s * n_s for n_ok in st["countable"]) / ALU_OPS_S),
            st)


def steps_note(st, length):
    """walk_chunk_steps for the log."""
    return (f"{st['working']} working and {st['skipped']} skipped steps of {length}; countable "
            f"rows of the searched steps {st['countable']}")


def walk_chunk_traps(args):
    """walk_chunk's trap calls made from one chunk's _walk_chunk arguments:
    the chunk with `steps` forced to 1, 4 and 5 (searches that end before
    they converge), with the la rows of the longest chain from its
    frontier row on in reverse order (a predicate that is not monotone
    along that chain), and the skip's traps (skip_traps). name ->
    arguments."""
    traps = {f"steps {k}": args[:11] + (k,) + args[12:] for k in (1, 4, 5)}
    rows_by, la, x0 = args[1], args[3], args[4]
    lens = (rows_by >= 0).sum(dim=1)
    c = int(torch.argmax(lens))
    rows = rows_by[c, : int(lens[c])].long()
    rows = rows[min(max(int(x0[c]), 0), max(rows.numel() - 1, 0)):]
    la2 = la.clone()
    la2[rows] = la[rows.flip(0)]
    traps["non-monotone la"] = args[:3] + (la2,) + args[4:]
    traps.update(skip_traps(args))
    return traps


def skip_traps(args):
    """The traps of the skip (a step with fewer than super_majority
    countable frontier rows searches nothing), made from one chunk's
    _walk_chunk arguments: "skip, unsaturated" starts the chunk with X below
    l on super_majority - 1 chains (those of least X) and at l on the rest,
    so its first step is skipped while X is not saturated (unseeded, X then
    saturates); "skip, seeded" adds a chain at X = 0 whose first_nw is the
    first step's round (not countable there, countable after it; its seed
    row holds it at 0) and seeds the first step, alternately below X (X
    held) and above it (X moved to the seed), so the skipped step must
    still apply its seed row and the next step searches; "skip, seeded,
    steps 1" is the latter with one probe a search. name -> arguments."""
    inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, sm, l, length, steps, use_seeds = args
    n = x0.numel()
    order = torch.argsort(x0, stable=True)
    kept = order[: max(min(sm - 1, n - 1), 0)]
    x1 = torch.full_like(x0, l)
    x1[kept] = x0[kept].clamp(max=l - 1)
    star = order[kept.numel()]
    x2 = x1.clone()
    x2[star] = 0
    fnw = first_nw.clone()
    fnw[star] = r_abs[0]
    s2 = torch.full_like(seeds, l)
    s2[:, star] = 0
    held, moved = kept[0::2], kept[1::2]
    s2[0, held] = (x1[held] - 1).clamp(min=0)
    s2[0, moved] = (x1[moved] + 1).clamp(max=l - 1)
    seeded = (inv, rows_by, fd, la, x2, s2, r_abs, fnw, sm, l, length)
    return {"skip, unsaturated": args[:4] + (x1,) + args[5:],
            "skip, seeded": seeded + (steps, True),
            "skip, seeded, steps 1": seeded + (1, True)}


def held_walk(label, g, cs, dev, kern=None):
    """The cold path's walk of grid g (cs: its stage_doubling), every chunk
    held torch.equal to the plain version: (the chunks' _walk_chunk
    arguments, the walk's history, first_nw). `kern` is the chunk function
    held (default the dispatching wrapper, doubling._walk_chunk)."""
    from babble_tpu_torch.tpu import doubling, frontier

    kern = kern or doubling._walk_chunk
    inv_c = frontier.build_inv(cs.rows_by_d, cs.la_d)
    s_np, first_nw, x0 = doubling.walk_seeds(g, cs)
    chunks = []

    def walk(*a):
        got = kern(*a)
        want = doubling._walk_chunk_plain(*a)
        torch.cuda.synchronize()
        require_equal(f"walk_chunk (length {a[10]}) on the {label}", got, want)
        chunks.append(a)
        return got

    hist = doubling._doubling_walk(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), inv_c, cs.rows_by_d,
        cs.fd_d, cs.la_d, x0, s_np, first_nw, g.super_majority, cs.l_b, cs.seeded, {},
        walk=walk)
    return chunks, hist, first_nw


def hold_walk_chunk_traps(label, big, log_fn, kern=None):
    """walk_chunk (`kern`, default the dispatching wrapper) held
    torch.equal to its plain version on each trap of a walk's largest chunk
    (walk_chunk_traps); logs whether each trap changes the chunk's history
    and each trap's working and skipped steps."""
    from babble_tpu_torch.tpu import doubling

    kern = kern or doubling._walk_chunk
    base_xs = kern(*big)[1]
    changed, skipped = {}, {}
    for name, t_args in walk_chunk_traps(big).items():
        got = kern(*t_args)
        want = doubling._walk_chunk_plain(*t_args)
        torch.cuda.synchronize()
        require_equal(f"walk_chunk ({name}) on the {label}'s largest chunk", got, want)
        changed[name] = not torch.equal(got[1], base_xs)
        st = walk_chunk_steps(t_args, want[1])
        skipped[name] = (st["working"], st["skipped"])
    log_fn(f"walk_chunk == plain on the {label}'s largest chunk with each trap (the trap "
           f"changes the chunk's history: {changed}; (working, skipped) steps: {skipped})")


def log_chunk_steps(label, chunks, log_fn):
    """Each chunk's working and skipped steps (walk_chunk_steps), logged."""
    notes = []
    for a in chunks:
        st = walk_chunk_steps(a)
        notes.append(f"{a[10]} steps: {st['working']} working, {st['skipped']} skipped")
    log_fn(f"  walk_chunk on the {label}, each chunk's steps: {'; '.join(notes)}")


def walk_chunk_form(n, l):
    """K7's form at n validators and chain length l, as the wrapper's plan
    takes it (_ext.walk_chunk_plan), for the log."""
    from babble_tpu_torch.tpu import _ext

    p = _ext.walk_chunk_plan(n, l)
    if p["form"] == "tree":
        return f"tree form, depth {p['depth']}"
    if p["form"] == "cluster":
        return (f"cluster form: {p['k']} blocks a cluster, {p['chains']} chains a block, tree "
                f"depth {p['depth']}, {p['smem']} bytes a block")
    return (f"L2 form (every chain's probes counted in tiles), tree depth {p['depth']}, "
            f"{p['smem']} bytes a block")


def profile_device(fn, before=None):
    """Device ms of one fn() call by kernel (and copy) name, from
    torch.profiler (before(), if given, runs first, outside it); None
    where it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if before is not None:
        before()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        name = evt.key.split("(")[0].replace("void ", "").strip()
        out[name] = out.get(name, 0.0) + us / 1e3
    return out or None


def launch_ms(fn, before=None):
    """Device ms of one fn() call by kernel launch key, from a pair of CUDA
    events around each launch of `_ext._launch` (before(), if given, runs
    first, off the clock): the fallback where torch.profiler records no
    device time (it drops events over long windows)."""
    from babble_tpu_torch.tpu import _ext

    pairs = []
    launch = _ext._launch

    def timed(name, device, args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        launch(name, device, args, **kw)
        ev[1].record()
        pairs.append((name, ev))

    if before is not None:
        before()
    _ext._launch = timed
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _ext._launch = launch
    out = {}
    for name, ev in pairs:
        out[name] = out.get(name, 0.0) + ev[0].elapsed_time(ev[1])
    return out or None


def cold_path_split(run, runs, before=None):
    """The cold path's host-clock wall taken apart: run() (a
    run_doubling_passes call) runs + 1 times (the first a warm-up) with
    each of COLD_STAGES wrapped in a synchronize and the host clock, then
    once under torch.profiler (or, where it records nothing, with each
    launch timed by CUDA events: launch_ms); before(), if given, runs ahead
    of each call, off the clock. Returns (median wall ms, {stage: median
    ms, "rest": the wall past the stages}, {kernel, copy or launch key:
    device ms} or None)."""
    from babble_tpu_torch.tpu import doubling

    saved = {name: getattr(doubling, name) for name in COLD_STAGES}
    spent = {}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    walls, stages = [], {k: [] for k in COLD_STAGES + ("rest",)}
    try:
        for name, fn in saved.items():
            setattr(doubling, name, timed(name, fn))
        for k in range(runs + 1):
            if before is not None:
                before()
            spent.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if k:
                walls.append(wall)
                for name in COLD_STAGES:
                    stages[name].append(spent.get(name, 0.0))
                stages["rest"].append(wall - sum(spent.values()))
    finally:
        for name, fn in saved.items():
            setattr(doubling, name, fn)
    device = profile_device(run, before)
    if device is None and torch.cuda.is_available():
        device = launch_ms(run, before)
    return (statistics.median(walls), {k: statistics.median(v) for k, v in stages.items()},
            device)


def split_line(label, wall, stages, device):
    """One log line for cold_path_split's result."""
    parts = ", ".join(f"{k} {v:.2f}" for k, v in stages.items() if v)
    line = f"{label}: wall {wall:.2f} ms (stages synchronized): {parts}"
    if device is None:
        return line + "; device time not recorded"
    total = sum(device.values())
    top = ", ".join(f"{k} {v:.3f}" for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:8])
    return (line + f"; device {total:.2f} ms in all ({top}); device idle {wall - total:.2f} ms "
            f"({(wall - total) / wall * 100:.1f} % of the wall)")


def level_traps():
    """The level scans' trap tables: name -> (the thirteen arrays of the
    level scan (levels, creator, index, self_parent, other_parent, la, fd,
    ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
    ext_op_lamport, fixed_lamport) as int32 numpy arrays, super_majority,
    the r_max values to run). K8 takes (levels, self_parent, other_parent,
    ext_sp_lamport, ext_op_lamport, fixed_lamport) of the same tables.
    tests/test_torch_levelscan.py and test_torch_doubling.py hold the
    port's plain versions to the JAX package on them; phase 6 holds K5 and
    K8 to the plain versions on them in every carry form.
      clamps_and_overrides: a padding lane beside row 0 must not overwrite
        row 0; a round past r_max clamps into the last witness-table row;
        a negative parent round reads no witness row; external parents
        take ext_*; the fixed overrides win;
      same_level_parent: a parent in the same level, or in a later one,
        reads the initial carry (-1), not the value written this level;
      parent_past_e: parent indices at or past E clamp to E - 1;
      lamport_wraps: max + 1 at 2^31 - 1 wraps to -2^31 (an external
        parent and a pin at 2^31 - 1);
      padding_before_real_lane: padding lanes ahead of real ones, a level
        of padding alone between two levels and one after the last."""
    mn, mx = -(2 ** 31), 2 ** 31 - 1

    def case(levels, creator, sp, op, la, fd, esr, eor, fr, esl, eol, fl, sm, r_maxes):
        e = len(creator)
        index = np.zeros(e, dtype=np.int64)
        seen = {}
        for i, c in enumerate(creator):  # each creator's events in row order
            index[i] = seen.get(c, 0)
            seen[c] = index[i] + 1
        arrays = [levels, creator, index, sp, op, la, fd, esr, eor, fr, esl, eol, fl]
        return [np.asarray(a, dtype=np.int32) for a in arrays], sm, r_maxes

    return {
        "clamps_and_overrides": case(
            [[0, -1], [1, -1], [2, -1]], [0, 1, 0], [-1, -1, 0], [-1, 0, 1],
            [[0, -1], [0, 0], [1, 1]], [[0, 2], [1, 1], [2, 2]],
            [-1, 5, -1], [-1, -1, -1], [0, -1, -1], [-1, 40, -1], [mn] * 3,
            [mn, mn, 7], 2, (2, 8)),
        "same_level_parent": case(
            [[0, 1], [2, 3]], [0, 1, 0, 1], [-1, 0, 0, 2], [-1, 3, 1, 1],
            [[0, -1], [-1, 0], [1, 0], [0, 1]], [[0, 5], [5, 0], [1, 5], [5, 1]],
            [-1, -1, -1, -1], [2, -1, -1, -1], [-1] * 4, [10, -1, -1, -1], [3, mn, mn, mn],
            [mn] * 4, 2, (4,)),
        "parent_past_e": case(
            [[3, -1], [0, 1], [2, -1]], [0, 1, 0, 1], [9, -1, 0, -1], [100, 4, mx, -1],
            [[1, 0], [0, 1], [2, 1], [0, 0]], [[0, 3], [3, 0], [1, 3], [0, 0]],
            [-1, 0, -1, 1], [-1, -1, -1, -1], [-1] * 4, [-1, 20, -1, 5], [mn] * 4,
            [mn] * 4, 2, (2, 4)),
        "lamport_wraps": case(
            [[0, -1], [1, 2], [3, -1]], [0, 1, 0, 1], [-1, 0, 0, 2], [-1, -1, -1, 1],
            [[0, -1], [0, 0], [1, 0], [1, 1]], [[0, 9], [0, 0], [1, 9], [9, 1]],
            [0, -1, -1, -1], [-1, 0, 0, -1], [-1] * 4, [mx, -1, -1, -1], [mn, 5, mn, mn],
            [mn, mn, mx, mn], 2, (4,)),
        "padding_before_real_lane": case(
            [[-1, 0, -1], [-1, -1, -1], [2, -1, 1], [-1, 3, -1], [-1, -1, -1]],
            [0, 0, 1, 0], [-1, 0, -1, 1], [-1, 2, -1, 2],
            [[0, -1, -1], [1, 0, -1], [-1, 0, -1], [2, 0, -1]],
            [[0, 3, 3], [1, 3, 3], [3, 0, 3], [2, 3, 3]],
            [-1, -1, -1, -1], [0, -1, 0, -1], [-1] * 4, [4, -1, 6, -1], [mn] * 4,
            [mn] * 4, 3, (4,)),
    }


def coin_round_case(n, r, seed):
    """decide_fame inputs over n validators and r rounds of witnesses, random
    from a numpy seed: witness (round, creator) on event row round * n +
    creator, about a tenth of them absent, lastAncestors mostly above
    firstDescendants, so that strongly-seeing is common but the votes stay
    split for long stretches. Returns numpy arrays and the scalar arguments."""
    rng = np.random.default_rng(seed)
    e = r * n
    wtable = np.arange(e, dtype=np.int32).reshape(r, n)
    absent = rng.random((r, n)) < 0.1
    absent[0] = absent[-1] = False
    wtable[absent] = -1
    return dict(
        wtable=wtable,
        la=rng.integers(2, 10, size=(e, n), dtype=np.int32),
        fd=rng.integers(0, 8, size=(e, n), dtype=np.int32),
        index=rng.integers(0, 10, size=e, dtype=np.int32),
        coin_bit=rng.random(e) < 0.5,
        last_round=r - 1, super_majority=2 * n // 3 + 1, n_participants=n,
        d_cap=r + 2,
    )


def received_trap_case(n, r, seed):
    """K4's and B23's inputs over n validators and r rounds, random from a
    numpy seed, with the edges their masks guard: absent witnesses and
    witness rows past la's last row (clamped), rounds with no famous
    witness (every third) and one with no witness at all, rounds decided
    in part, la entries at MAX_INT32, and events whose creator lies
    outside [0, n) or whose round lies outside [0, r). Returns numpy
    arrays (K4's rounds_decided given; B23 derives its own); last_round is
    the caller's."""
    rng = np.random.default_rng(seed)
    e_la = 2 * n * r
    e = 4 * n * r
    wtable = rng.integers(0, e_la + 8, size=(r, n), dtype=np.int32)
    wtable[rng.random((r, n)) < 0.15] = -1
    wtable[r // 2] = -1
    decided = rng.random((r, n)) < 0.8
    decided[1] = True
    famous = rng.random((r, n)) < 0.5
    famous[::3] = False
    la = rng.integers(0, 40, size=(e_la, n), dtype=np.int32)
    la[rng.random((e_la, n)) < 0.01] = np.iinfo(np.int32).max
    creator = rng.integers(0, n, size=e, dtype=np.int32)
    edge = rng.random(e)
    creator[edge < 0.02] = -2
    creator[(edge >= 0.02) & (edge < 0.04)] = n
    creator[(edge >= 0.04) & (edge < 0.05)] = n + 7
    return dict(
        wtable=wtable, la=la, decided=decided, famous=famous,
        rounds_decided=rng.random(r) < 0.8,
        index=rng.integers(0, 40, size=e, dtype=np.int32), creator=creator,
        rounds=rng.integers(-2, r + 2, size=e, dtype=np.int32),
    )


def build_inv_trap_cases(card=False):
    """K1's edges as (name, rows_by, la) numpy int32 arrays, random from
    numpy seeds: lastAncestors that fall and rise along a chain, entries at
    and past L, absent entries (la < 0), padded slots between real ones and
    an empty chain, rows past la's last row (clamped), no rows at all (e =
    0, which the reference's gather refuses: INV is L everywhere), L = 1, a
    ragged tile of coordinates (37, 70), chains of several chunks split into
    segments, and, with `card`, the catch-up section's shape (8 chains of
    4,608 indices, 32,760 rows: the chain axis split) and the width cell's
    (1,024 chains of 64 indices over 1,024 coordinates)."""
    rng = np.random.default_rng(18)

    def chains(n_c, l, e, fill):
        rows = np.full((n_c, l), -1, dtype=np.int32)
        for c in range(n_c):
            k = int(fill * l)
            rows[c, :k] = rng.integers(0, e, size=k)
        return rows

    cases = []
    rb = chains(6, 16, 40, 1.0)
    cases.append(("falling and rising", rb, rng.integers(0, 16, size=(40, 6), dtype=np.int32)))
    cases.append(("at and past L", rb, rng.integers(12, 40, size=(40, 6), dtype=np.int32)))
    cases.append(("absent entries", rb, rng.integers(-3, 10, size=(40, 6), dtype=np.int32)))
    gaps = chains(5, 24, 60, 0.9)
    gaps[rng.random(gaps.shape) < 0.3] = -1
    gaps[2] = -1
    cases.append(("padded slots between real ones, an empty chain", gaps,
                  rng.integers(-1, 30, size=(60, 5), dtype=np.int32)))
    cases.append(("rows past E", rng.integers(-1, 50, size=(4, 16), dtype=np.int32),
                  rng.integers(-1, 20, size=(30, 4), dtype=np.int32)))
    cases.append(("e = 0", np.full((3, 8), -1, dtype=np.int32), np.zeros((0, 5), np.int32)))
    cases.append(("L = 1", rng.integers(-1, 9, size=(7, 1), dtype=np.int32),
                  rng.integers(-2, 3, size=(9, 7), dtype=np.int32)))
    cases.append(("ragged tiles", chains(37, 64, 500, 0.7),
                  rng.integers(-1, 70, size=(500, 37), dtype=np.int32)))
    cases.append(("ragged second tile", chains(70, 64, 900, 0.8),
                  rng.integers(-1, 70, size=(900, 70), dtype=np.int32)))
    walk = chains(3, 448, 1000, 0.95)
    cases.append(("chains of four chunks", walk,
                  np.sort(rng.integers(-1, 500, size=(1000, 3), dtype=np.int32), axis=0)))
    cases.append(("chains of four chunks, falling", walk,
                  rng.integers(-1, 500, size=(1000, 3), dtype=np.int32)))
    if card:
        e_c, l_c = 32760, 4608
        rows = np.full((8, l_c), -1, dtype=np.int32)
        for c in range(8):
            rows[c, :4095] = np.arange(c, e_c, 8)[:4095]
        la_c = np.sort(rng.integers(-1, 4100, size=(e_c, 8), dtype=np.int32), axis=0)
        cases.append(("catch-up shape (8 chains, L 4,608)", rows, la_c))
        e_w, n_w = 16384, 1024
        rows = np.full((n_w, 64), -1, dtype=np.int32)
        rows[:, :16] = np.arange(n_w * 16, dtype=np.int32).reshape(16, n_w).T
        cases.append(("width shape (1,024 chains, L 64)", rows,
                      rng.integers(-1, 20, size=(e_w, n_w), dtype=np.int32)))
    return cases


def build_inv_work(rows_by, la, inv):
    """K1's (bytes, seconds at the peak integer rate) on these inputs
    (PERF.md's counting rules): the chain table and the la rows it names
    read once, INV written once; an operation per coordinate a row and per
    INV word."""
    rows = int((rows_by >= 0).sum().item())
    n_p = la.shape[1]
    return (rows_by.numel() * 4 + rows * n_p * 4 + inv.numel() * 4,
            (rows * n_p + inv.numel()) / ALU_OPS_S)


def received_trap_args(case, last_round, device):
    """(K4's positional arguments, B23's) for a received_trap_case, on
    device."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lr = torch.tensor(last_round, dtype=torch.int32, device=device)
    k4 = (t(case["wtable"]), t(case["la"]), t(case["index"]), t(case["creator"]),
          t(case["rounds"]), t(case["decided"]), t(case["famous"]),
          t(case["rounds_decided"]), lr)
    b23 = (k4[0], k4[1], k4[5], k4[6], lr)
    return k4, b23


def coin_received_args(case, fame, device):
    """K4's positional arguments for a coin_round_case decided by `fame`
    (decide_fame's result): every row an event of its table row's round
    and creator."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    r, n = case["wtable"].shape
    e = r * n
    return (t(case["wtable"]), t(case["la"]), t(case["index"]),
            t(np.arange(e, dtype=np.int32) % n), t(np.arange(e, dtype=np.int32) // n),
            fame.decided, fame.famous, fame.rounds_decided,
            torch.tensor(case["last_round"], dtype=torch.int32, device=device))


def received_work(k4, recv):
    """K4's (bytes, seconds at the peak integer rate) on these inputs
    (PERF.md's counting rules): the witness table, the fame flags and
    rounds_decided, the famous witnesses' la rows, the events' index,
    creator and rounds read once, received written once; a min per famous
    la entry and a compare per round each event's scan passes (round(e) +
    1 to its reception, or to its horizon)."""
    from babble_tpu_torch.tpu import kernels

    wtable, la, index, creator, rounds, decided, famous, rounds_decided, last_round = k4
    r_max, n = wtable.shape
    e = index.shape[0]
    n_famous = int((decided & famous & (wtable >= 0)).sum().item())
    *_, horizon = kernels._received_tables(wtable, la, decided, famous, rounds_decided,
                                           last_round)
    start = (rounds + 1).clamp(0, r_max - 1).long()
    stop = torch.where(recv >= 0, recv, horizon[start].clamp(max=r_max) - 1)
    scan_ops = int((stop - rounds).clamp(min=0).sum().item())
    return (r_max * n * 4 + n_famous * n * 4 + r_max * n * 2 + r_max + 4 + 3 * e * 4 + e * 4,
            (n_famous * n + scan_ops) / ALU_OPS_S)


def hold_received(label, k4, log_fn):
    """K4 and B23 on K4's tables, each torch.equal to its plain version on
    the card."""
    from babble_tpu_torch.tpu import _ext, kernels, sharded

    want = kernels._decide_round_received_plain(*k4)
    got = _ext.round_received(*k4)
    torch.cuda.synchronize()
    require_equal(f"round_received on {label}", got, want)
    b23 = (k4[0], k4[1], k4[5], k4[6], k4[8])
    got_t = _ext.fame_tables(*b23)
    torch.cuda.synchronize()
    want_t = sharded._fame_tables_plain(*b23)
    require_equal(f"fame_tables on {label}", got_t, want_t)
    # B23 with B22's events over K4's events in one launch
    events = (k4[2], k4[3], k4[4])
    got_f = _ext.fame_received(*b23, *events)
    torch.cuda.synchronize()
    require_equal(f"fame_received on {label}", got_f,
                  tuple(want_t) + (kernels.received_search(*events, *want_t[:4]),))
    r_max, n = k4[0].shape
    plan = _ext.received_tables_plan(n, r_max)
    log_fn(f"  round_received, fame_tables and fame_received == plain on {label} "
           f"({plan['items']} items x {plan['slices']} slices of {plan['wps']} words; "
           f"{int((want >= 0).sum())} of {want.numel()} received)")


# the received tables' traps: two column tiles (the second ragged) at
# three last rounds, and past the width cell with a ragged word
RECEIVED_TRAPS = (((136, 7, 11), (-1, 3, 6)), ((1056, 5, 1056), (4,)))


def hold_received_traps(dev, log_fn):
    for (n, r, seed), last_rounds in RECEIVED_TRAPS:
        case = received_trap_case(n, r, seed)
        for lr in last_rounds:
            k4, _ = received_trap_args(case, lr, dev)
            hold_received(f"received_trap_case({n}, {r}, {seed}), last_round {lr}", k4, log_fn)


def hold_build_inv_traps(dev, log_fn):
    """K1 on its trap table (build_inv_trap_cases, with the catch-up and
    width shapes), in the plan's form and with the chain axis in one
    segment, two and one a chunk: torch.equal to the plain version (with
    no rows, to L everywhere, where the reference's gather refuses)."""
    from babble_tpu_torch.tpu import _ext, frontier

    for name, rows_np, la_np in build_inv_trap_cases(card=True):
        rows_by, la = (torch.from_numpy(a).to(dev) for a in (rows_np, la_np))
        n_c, l = rows_np.shape
        if la_np.shape[0] == 0:
            want = torch.full((n_c, la_np.shape[1], l), l, dtype=torch.int32, device=dev)
        else:
            want = frontier._build_inv_plain(rows_by, la)
        forms = [None] + sorted({1, 2, -(-l // _ext.BI_CHUNK)})
        for segments in forms:
            got = _ext.build_inv(rows_by, la, segments)
            torch.cuda.synchronize()
            require_equal(f"build_inv on the trap '{name}', segments {segments}", got, want)
        plan = _ext.build_inv_plan(n_c, la_np.shape[1], l)
        log_fn(f"  build_inv == plain on the trap '{name}' ({n_c} chains, L {l}, "
               f"{la_np.shape[1]} coordinates; the plan's {plan['segments']} segments of "
               f"{plan['blocks']} blocks, and segments {forms[1:]})")


def coin_case_state(case, device):
    """An IncState holding a coin_round_case's voting tables as registered
    witnesses (round r's witnesses on rows r * n .. r * n + n - 1, each
    row's round its table row), every row occupied and undetermined, for
    the decide alone."""
    from babble_tpu_torch.tpu import incremental as inc

    wt = case["wtable"]
    r, n = wt.shape
    e = r * n
    st = inc.init_state(n, e, r, device=device)
    ok = wt >= 0
    rows = np.where(ok, wt, 0)

    def put(t, a):
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(device))

    put(st.wtable, wt)
    put(st.la_w, case["la"][rows])
    put(st.fd_w, case["fd"][rows])
    put(st.idx_w, np.where(ok, case["index"][rows], np.iinfo(np.int32).max))
    put(st.coin_w, case["coin_bit"][rows])
    put(st.la, case["la"])
    put(st.fd, case["fd"])
    put(st.index, case["index"])
    put(st.creator, np.arange(e, dtype=np.int32) % n)
    put(st.rounds, np.arange(e, dtype=np.int32) // n)
    st.last_round.fill_(case["last_round"])
    st.count.fill_(e)
    return st


def coin_fame_args(case, coin_bit, device):
    """decide_fame's positional arguments for a coin_round_case, on device."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(case["wtable"]), t(case["la"]), t(case["fd"]), t(case["index"]),
            t(coin_bit), torch.tensor(case["last_round"], dtype=torch.int32, device=device),
            case["super_majority"], case["n_participants"], case["d_cap"])


def fused_pack_phase(step_state, batches, sm, n, dev):
    """Phase 11's fused route: the live engine's pack written by K12's last
    launch (decide with `pack`), held torch.equal to K12 then the plain
    pack, and every state field to K12 alone, with no pack_results launch:
    at the live step shape (r_cap 64, e_win 8,192) with count < e_win (the
    first 16 batches), count mid-range (phase 10's step state) and count =
    e_cap (the same rows: every undetermined row below the window latches
    stale); stale latched by one row below the window (one block of 256
    writes the word) and fame_lag latched by dw_vote (every round
    undecided, r_win 8 below last_round). Then dw_tables' and dw_events'
    device times with and without the pack (torch.profiler, A, B, B, A,
    behind a spin)."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    cfg = INC_STEP
    e_cap, e_win, r_cap = cfg["e_cap"], cfg["e_win"], cfg["r_cap"]

    def fused(label, st0, r_win=cfg["r_win"], edit=None, flags=None):
        a = inc.clone_state(st0)
        if edit is not None:
            edit(a)
        b = inc.clone_state(a)
        lo = inc.pack_window_start(max(int(a.count) - e_win, 0), e_cap, e_win)
        vec = torch.empty((inc.pack_size(e_win, r_cap, n),), dtype=torch.int32, device=dev)
        _ext.reset_launches()
        inc._decide_body(a, sm, n, r_win=r_win, e_win=e_win, pack=vec, pack_lo=lo)
        inc._decide_body(b, sm, n, r_win=r_win, e_win=e_win)
        want = inc.pack_results_plain(b, lo, e_win, r_cap, n)
        torch.cuda.synchronize()
        require_equal(f"the fused pack on {label}", vec, want)
        diff = state_diff(a, b)
        if diff or _ext.LAUNCHES["pack_results"]:
            raise AssertionError(f"the fused pack on {label}: fields {diff} differ from K12's "
                                 f"alone; {_ext.LAUNCHES['pack_results']} pack_results launches")
        got_flags = [int(x) for x in vec[-3:].tolist()]
        if flags is not None and got_flags[:2] != flags:
            raise AssertionError(f"the fused pack on {label}: stale, fame_lag {got_flags[:2]}, "
                                 f"expected {flags}")
        log(f"  fused pack == K12 then the plain pack on {label}: count {int(a.count)}, "
            f"window start {lo}, stale/fame_lag/last_round {got_flags}")

    early = inc.init_state(n, e_cap, r_cap, device=dev)
    for b in batches[:16]:
        inc.step(early, b, sm, n, r_win=cfg["r_win"], e_win=e_win)
    fused("the first 16 batches' state (count < e_win)", early, flags=[0, 0])
    fused("phase 10's step state", step_state, flags=[0, 0])
    fused("that state at count = e_cap", step_state,
          edit=lambda st: st.count.fill_(e_cap), flags=[1, 0])

    def miss_row0(st):
        st.received[0] = -1

    fused("that state with row 0 undetermined (one block latches stale)", step_state,
          edit=miss_row0, flags=[1, 0])
    fused("that state with every round undecided at r_win 8 (dw_vote latches fame_lag)",
          step_state, r_win=8, edit=lambda st: st.rounds_decided.zero_(), flags=[0, 1])

    st_t = inc.clone_state(step_state)
    lo = inc.pack_window_start(max(int(st_t.count) - e_win, 0), e_cap, e_win)
    vec = torch.empty((inc.pack_size(e_win, r_cap, n),), dtype=torch.int32, device=dev)
    reps = 20

    def decide(pack):
        def run():
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(reps):
                inc._decide_body(st_t, sm, n, r_win=cfg["r_win"], e_win=e_win,
                                 pack=vec if pack else None, pack_lo=lo)
        return run

    ev = {False: [], True: []}
    for pack in (False, True, True, False):
        got = profile_device(decide(pack))
        if got is None or "dw_events" not in got:
            log("  dw_tables, dw_events: torch.profiler recorded no device time (not measured)")
            return
        ev[pack].append((got["dw_tables"] / reps, got["dw_events"] / reps))
    us = {k: [statistics.mean(x[j] for x in ev[k]) * 1e3 for j in (0, 1)] for k in ev}
    log(f"  K12's last two launches at the live step shape (count {int(st_t.count)}, e_win "
        f"{e_win}, r_cap {r_cap}, n {n}; A, B, B, A): dw_tables {us[False][0]:.2f} us without "
        f"the pack, {us[True][0]:.2f} with it; dw_events {us[False][1]:.2f}, {us[True][1]:.2f} "
        f"(+{sum(us[True]) - sum(us[False]):.2f} us together)")


def max_abs_err(got, want):
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(flat(got), flat(want)))
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


def flat(x):
    """The tensors of a result, nested tuples flattened in order."""
    return tuple(t for y in x for t in flat(y)) if isinstance(x, tuple) else (x,)


def require_equal(what, got, want):
    got_t, want_t = flat(got), flat(want)
    for k, (g, w) in enumerate(zip(got_t, want_t)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: field {k} differs from the plain version")


def require_same_results(what, got, want):
    """PassResults equality: per-event fields in full, the (R, N) tables on
    the real rounds (the adaptive round axis may size them differently;
    their rows are indexed by round - round_offset)."""
    if got.last_round != want.last_round:
        raise AssertionError(f"{what}: last_round {got.last_round} != {want.last_round}")
    if got.round_offset != want.round_offset:
        raise AssertionError(f"{what}: round_offset {got.round_offset} != {want.round_offset}")
    k = want.last_round - want.round_offset + 1
    for field in ("rounds", "witness", "lamport", "received", "witness_table",
                  "fame_decided", "famous", "rounds_decided"):
        g, w = getattr(got, field), getattr(want, field)
        if field in ("witness_table", "fame_decided", "famous", "rounds_decided"):
            g, w = g[:k], w[:k]
        if g.shape != w.shape or g.dtype != w.dtype or not (g == w).all():
            raise AssertionError(f"{what}: {field} differs from the CPU run")


def wall_ms(fn, runs):
    """Median host-clock milliseconds of fn() over `runs` warm runs, each
    ending in a synchronize, after two warm-up runs."""
    walls = []
    for _ in range(runs + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[2:]) * 1e3


def run_path(label, fn):
    """Run one engine call with every launch count set to 0 just before it
    and read just after; fail unless each kernel of the path launched."""
    from babble_tpu_torch.tpu import _ext

    _ext.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    require_path_launches(label, label, launches)
    log(f"  {label}: launches {({k: v for k, v in launches.items() if v})}")
    return res, launches


def require_path_launches(what, path, launches):
    """Fail unless each kernel of PATH_KERNELS[path] launched, on a step
    path (PATH_NO_OWN_K9) unless no apply_deltas did, on a live path unless
    pack_results launched PATH_OWN_PACKS[path] times of its own, and, on a
    packed path, unless no wide form of a layout kernel did."""
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: never launched {missing}")
    if path in PATH_OWN_PACKS and launches["pack_results"] != PATH_OWN_PACKS[path]:
        raise AssertionError(f"{what}: launched pack_results {launches['pack_results']} times "
                             f"of its own, expected {PATH_OWN_PACKS[path]} (the pack rides "
                             f"the last decide's launch)")
    if path in PATH_NO_OWN_K9 and launches["apply_deltas"]:
        raise AssertionError(f"{what}: launched apply_deltas {launches['apply_deltas']} times "
                             f"of its own (the step paths run it inside step_levels)")
    if path.endswith(", packed"):
        wide = [k for k in WIDE_FORMS if launches[k]]
        if wide:
            raise AssertionError(f"{what}: launched the wide layout of {wide}")


def scan_pair_count(levels, sp, op, ext_sp_round, ext_op_round, rounds, wtable):
    """(event, witness) pairs whose strongly-see count the level scan needs:
    each event against the witnesses of its parent round that an earlier
    level placed in the table (CPU tensors, the scan's own outputs)."""
    e = rounds.shape[0]
    r_max = wtable.shape[0]
    lvl = torch.full((e,), -1, dtype=torch.long)
    pos = torch.nonzero(levels >= 0)
    lvl[levels[pos[:, 0], pos[:, 1]].long()] = pos[:, 0]
    sp_r = torch.where(sp >= 0, rounds[sp.clamp(0, e - 1).long()], ext_sp_round)
    op_r = torch.where(op >= 0, rounds[op.clamp(0, e - 1).long()], ext_op_round)
    pr = torch.maximum(sp_r, op_r)
    w = wtable[pr.clamp(0, r_max - 1).long()]
    ok = ((w >= 0) & (pr >= 0)[:, None] & (lvl >= 0)[:, None]
          & (lvl[w.clamp(0, e - 1).long()] < lvl[:, None]))
    return int(ok.sum())


def state_diff(a, b):
    """Names of the IncState fields in which two states differ."""
    return [f for f in a._fields if not torch.equal(getattr(a, f), getattr(b, f))]


class PairedRun:
    """One incremental state driven through the kernels and a clone of it
    through the plain versions, call by call: every IncState field is held
    torch.equal after each checked call, and each checked call's kernel and
    plain times (CUDA events) and the work its data needs are kept by
    kernel name. A checked call named after a launch key must launch that
    key on the card. An unchecked call runs the kernel on both states."""

    def __init__(self, label, state):
        from babble_tpu_torch.tpu import incremental as inc

        self.label = label
        self.k = state
        self.p = inc.clone_state(state)
        self.events = {}
        self.work = {}

    def call(self, name, kern, plain, work=None, check=True, absent=(), pre_work=None):
        """One call; `absent`: launch keys the kernel call must not launch;
        `pre_work`: work counted on the state before the call (added to
        `work`'s)."""
        from babble_tpu_torch.tpu import _ext

        if not check:
            kern(self.k)
            kern(self.p)
            return
        pre = pre_work(self.k) if pre_work is not None else (0, 0, 0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        # the card spins while the host runs the wrapper and enqueues the
        # launch, so the events time the kernel and not the enqueue
        torch.cuda._sleep(SPIN_CYCLES)
        before = _ext.LAUNCHES.get(name)
        before_absent = [_ext.LAUNCHES[a] for a in absent]
        ev[0].record()
        kern(self.k)
        ev[1].record()
        ev[2].record()
        plain(self.p)
        ev[3].record()
        calls = self.events.setdefault(name, [])
        if self.k.la.is_cuda and before is not None and _ext.LAUNCHES[name] == before:
            raise AssertionError(f"{name} on the {self.label}, call {len(calls)}: the kernel "
                                 f"call launched no {name}")
        launched = [a for a, b in zip(absent, before_absent) if _ext.LAUNCHES[a] != b]
        if launched:
            raise AssertionError(f"{name} on the {self.label}, call {len(calls)}: the kernel "
                                 f"call launched {launched} of its own")
        bad = state_diff(self.k, self.p)
        if bad:
            raise AssertionError(f"{name} on the {self.label}, call {len(calls)}: "
                                 f"{bad} differ from the plain version")
        calls.append(ev)
        if work is not None:
            nbytes, alu, tc = (a + b for a, b in zip(work(self.k), pre))
            acc = self.work.setdefault(name, [0, 0, 0])
            acc[0] += nbytes
            acc[1] += alu
            acc[2] += tc

    def times(self, name):
        """(calls, total kernel ms, total plain ms)."""
        torch.cuda.synchronize()
        evs = self.events[name]
        return (len(evs), sum(e[0].elapsed_time(e[1]) for e in evs),
                sum(e[2].elapsed_time(e[3]) for e in evs))


def step_call(run, key, x, super_majority, packed=False, work=True, check=True):
    """K9 + K10 on a PairedRun as the step paths run them (incremental
    _step_levels: on the card one launch of step_levels, the
    walk `key` names, whose phase 0 is K9), held to the plain K9 then the
    plain K10 on the same state; timed and bounded under `key` (K9's work
    counted on the state before the call). The call must launch no
    apply_deltas of its own."""
    from babble_tpu_torch.tpu import incremental as inc

    def plain(st):
        inc._apply_deltas_and_stage_plain(st, x)
        inc._step_levels_plain(st, x, super_majority, packed=packed)

    run.call(key, lambda st: inc._step_levels(st, x, super_majority, packed=packed),
             plain, (lambda st: inc_work_levels(st, x, True)) if work else None, check=check,
             absent=("apply_deltas",),
             pre_work=(lambda st: inc_work_deltas(st, x)) if work else None)


def fame_work(wtable, n):
    """(bytes, seconds at the peak rates) decide_fame needs for a witness
    table: the table, the la and fd rows of the witnesses present, their
    index and coin bit, last_round and the (R, N) outputs; the strongly-see
    compares of adjacent rounds' witness pairs at the ALU rate and the
    tallies as 0/1 products at the int8 tensor-core rate."""
    r_max = wtable.shape[0]
    wvalid = wtable >= 0
    n_wit = int(wvalid.sum().item())
    valid_rounds = int(wvalid.any(dim=1).sum().item())
    n_pairs = int((wvalid[1:].sum(dim=1) * wvalid[:-1].sum(dim=1)).sum().item())
    return (r_max * n * 4 + n_wit * n * 4 * 2 + n_wit * 5 + 4 + r_max * n * 2 + r_max,
            n_pairs * (n + 1) / ALU_OPS_S + valid_rounds * 2 * n ** 3 / INT8_TC_OPS_S)


def fame_stage_row_bytes(stage):
    """Bytes of one global row of a staged fame input (sharded.FameStage):
    its ss_s, votes, wv_s, coin_s and wvalid rows."""
    return sum(t[0].numel() * t.element_size() for t in (
        stage.ss_s, stage.votes, stage.wv_s, stage.coin_s, stage.wvalid))


def shard_fame_work(row_bytes, r_pad, n, n_y, last_round, n_v):
    """(bytes, seconds at the peak rates) of B21's whole fame loop over r_pad
    global rows of row_bytes staged bytes each (n witness columns, n_y
    voters): the rows the vote reads, rows g <= last_round - 2 (no later
    row votes, and the planes of rows g read rows g + d - 2 <= last_round -
    2), and decided and famous written at every row and each of n_v
    validator positions; the tally as the K3 vote's, a popcount a word for
    every (voting row, voter, column, step) of the steps the rows may take
    (i + d <= last_round), at the integer rate."""
    rows = max(min(r_pad, int(last_round) - 1), 0)
    words = -(-n_y // 32)
    steps = sum(max(int(last_round) - g - 1, 0) for g in range(rows))
    return (rows * row_bytes + 2 * r_pad * n * n_v,
            steps * n_y * n * words * 3 / ALU_OPS_S)


def scan_work(g, ins, dr, scan_r_max):
    """((bytes, seconds at the peak rates), pairs, witnesses) of one level
    scan over grid g (ins: its staged inputs, dr: the scan's outputs):
    the used level rows, each event's metadata and la row, the witnesses'
    fd rows and the outputs; the (event, witness) compares at the ALU
    rate."""
    from babble_tpu_torch.tpu.kernels import last_level

    n_s = g.n
    lv_c, _, _, sp_c, op_c, la_c, fd_c, esr_c, eor_c = (
        ins[i].cpu() for i in (0, 1, 2, 3, 4, 5, 6, 7, 8))
    e_b = la_c.shape[0]
    used_level_bytes = (last_level(lv_c) + 1) * lv_c.shape[1] * 4
    n_wit = int(dr[1].sum().item())
    pairs = scan_pair_count(lv_c, sp_c, op_c, esr_c, eor_c, dr[0].cpu(), dr[3].cpu())
    return ((used_level_bytes + g.e * (9 * 4 + n_s * 4) + n_wit * n_s * 4
             + e_b * 9 + scan_r_max * n_s * 4,
             (pairs * n_s + g.e * 4) / ALU_OPS_S), pairs, n_wit)


def lamport_work(e, lam_args):
    """(bytes, seconds at the ALU rate) of one seeded lamport scan of e
    events (lam_args: doubling.lamport_inputs): the used level rows, each
    event's parents, seeds and pin once, the (E,) output; two operations
    an event."""
    from babble_tpu_torch.tpu.kernels import last_level

    levels = lam_args[0].cpu()
    return ((last_level(levels) + 1) * levels.shape[1] * 4 + e * 5 * 4
            + lam_args[1].shape[0] * 4, 2 * e / ALU_OPS_S)


def inc_work_deltas(st, x):
    """(bytes, ALU ops, tensor-core ops) apply_deltas needs for input x:
    each real delta's 12 bytes, its row's slot and one fd cell (and one
    fd_w cell where mirrored); each staged row's la row in and out, its
    identity and own fd cell."""
    e_cap, n = st.la.shape
    ok = (x.upd_row >= 0) & (x.upd_row < e_cap)
    u = int(ok.sum())
    slot = st.w_of_row[x.upd_row.clamp(0, e_cap - 1).long()]
    mirrored = int((ok & (slot >= 0)).sum())
    rows = int(((x.rows >= 0) & (x.rows < e_cap)).sum())
    return u * 20 + mirrored * 4 + rows * (8 * n + 24), u + mirrored + rows, 0


def inc_work_levels(st, x, rounds_scan):
    """(bytes, ALU ops, 0) of one level-scan call, each input read once and
    each output written once: per real lane its level-table entry, batch
    metadata, la row, parents' rounds and lamports and its results; per
    distinct parent round its witness row and the fd_w rows of its
    witnesses (as the call leaves the table), however many lanes compare
    against them; each registration's fd row in and its la_w, fd_w and
    table cells out; the step path also reads every row's round (its
    last_round is a max over all of them). The lane-by-witness compares
    (pairs x n) count as ALU work."""
    e_cap, n = st.la.shape
    r_cap = st.wtable.shape[0]
    pos = x.levels[x.levels >= 0].long()
    lanes = pos.numel()

    def parent_round(r):
        ok = (r >= 0) & (r < e_cap)
        return torch.where(ok, st.rounds[r.clamp(0, e_cap - 1).long()], -1)

    pr = torch.maximum(parent_round(x.sp_row[pos]), parent_round(x.op_row[pos]))
    present = (st.wtable[pr.clamp(0, r_cap - 1).long()] >= 0) & (pr >= 0)[:, None]
    pairs = int(present.sum())
    slabs = pr[pr >= 0].clamp(0, r_cap - 1).unique().long()
    slab_rows = int((st.wtable[slabs] >= 0).sum())
    regs = int(st.witness[x.rows[pos].clamp(0, e_cap - 1).long()].sum())
    nbytes = (lanes * (4 + 29 + 4 * n + 16 + 9) + slabs.numel() * 4 * n
              + slab_rows * 4 * n + regs * (12 * n + 13)
              + (e_cap * 4 if rounds_scan else 0))
    return nbytes, pairs * n + lanes * n, 0


def inc_work_decide(st, r_win, e_win):
    """(bytes, ALU ops, tensor-core ops) of one decide: the window's
    witness rows of la_w and fd_w and its tables, the famous witnesses' la
    rows, the fame tables, the trailing e_win rows (index, creator,
    rounds, received) and the rows below them the stale detector reads;
    the strongly-see compares at ALU rate and, at the int8 tensor-core
    rate, the 0/1 tallies the data needs: for each window round i and
    offset d whose voting round j = i + d lies at or below last_round and
    in the window (no later offset can decide anything), the present
    voters of j x the present witnesses of i x those of j - 1."""
    e_cap, n = st.la.shape
    r_cap = st.wtable.shape[0]
    lr = int(st.last_round)
    undecided = ~st.rounds_decided & (torch.arange(r_cap, device=st.la.device) <= lr)
    idx = torch.nonzero(undecided)
    floor_true = min(int(idx[0]), lr) if idx.numel() else lr
    floor = min(max(floor_true, 0), r_cap - r_win)
    wv = st.wtable[floor : floor + r_win] >= 0
    n_wit = int(wv.sum())
    pairs = int((wv[1:].sum(dim=1) * wv[:-1].sum(dim=1)).sum())
    n_famous = int((st.fame_decided & st.famous & (st.wtable >= 0)).sum())
    lo = min(max(int(st.count) - e_win, 0), e_cap - e_win)
    nbytes = (n_wit * (8 * n + 5) + r_win * n * 4 + n_famous * n * 4 + r_cap * n * 6
              + r_cap + e_win * 16 + lo * 8)
    from babble_tpu_torch.tpu.incremental import D_UNROLL

    per_round = wv.sum(dim=1).tolist()
    top = min(lr - floor, r_win - 1)
    tallies = sum(2 * per_round[i + d] * per_round[i] * per_round[i + d - 1]
                  for i in range(r_win) for d in range(2, 2 + D_UNROLL) if i + d <= top)
    return nbytes, pairs * n, tallies



def build_signed_events(grid, hashgraph_mod, crypto, peers_mod, count=None):
    """The grid's DAG (its first `count` rows, topological order) as
    signed events, built with the port's own crypto
    and hashgraph and inserted into a first Hashgraph as they are made:
    (that hashgraph, peer JSON, event JSON in topological order). Keys
    are derived from the validator position, so a run's hashes repeat."""
    keys = [crypto.derive_key(1 + c) for c in range(grid.n)]
    participants = peers_mod.Peers.from_slice([
        peers_mod.Peer(net_addr="", pub_key_hex="0x" + crypto.pub_key_bytes(k).hex().upper())
        for k in keys
    ])
    plist = participants.to_peer_slice()
    by_pub = {"0x" + crypto.pub_key_bytes(k).hex().upper(): k for k in keys}
    sorted_keys = [by_pub[p.pub_key_hex] for p in plist]
    hg = hashgraph_mod.Hashgraph(participants, hashgraph_mod.InmemStore(participants, HG_CACHE))
    rows = []
    for i in range(grid.e if count is None else count):
        c = int(grid.creator[i])
        sp_row, op_row = int(grid.self_parent[i]), int(grid.other_parent[i])
        sp = rows[sp_row].hex() if sp_row >= 0 else hashgraph_mod.root_self_parent(plist[c].id)
        op = rows[op_row].hex() if op_row >= 0 else ""
        ev = hashgraph_mod.Event(transactions=[f"tx{i}".encode()], parents=[sp, op],
                                 creator=crypto.pub_key_bytes(sorted_keys[c]),
                                 index=int(grid.index[i]))
        ev.sign(sorted_keys[c])
        hg.insert_event(ev, True)
        rows.append(ev)
    return hg, [p.to_json() for p in plist], [ev.to_json() for ev in rows]


def consensus_view(hg):
    """(per-event (round, lamport, round received), per decided round
    {witness: fame}) of a base hashgraph's store."""
    events = {}
    for p in hg.participants.to_peer_slice():
        for h in hg.store.participant_events(p.pub_key_hex, -1):
            ev = hg.store.get_event(h)
            events[h] = (ev.round, ev.lamport_timestamp, ev.round_received)
    rounds = {}
    for r in range(hg.store.last_round() + 1):
        ri = hg.store.get_round(r)
        if ri.witnesses_decided():
            rounds[r] = {w: int(ri.events[w].famous) for w in ri.witnesses()}
    return events, rounds


def require_same_consensus(label, ref, ref_blocks, hg, blocks):
    """Blocks byte for byte; every event the reference received with the
    same round, lamport and round received; every round the reference
    decided with the same witnesses and fame."""
    if [b.marshal() for b in blocks] != [b.marshal() for b in ref_blocks]:
        raise AssertionError(f"{label}: {len(blocks)} blocks differ from the host "
                             f"engine's {len(ref_blocks)}")
    ref_events, ref_rounds = ref
    events, rounds = consensus_view(hg)
    bad = [h for h, f in ref_events.items() if f[2] is not None and events.get(h) != f]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} received events differ, first {bad[0][:18]}")
    bad = [r for r, w in ref_rounds.items() if rounds.get(r) != w]
    if bad:
        raise AssertionError(f"{label}: witnesses or fame differ in rounds {bad[:5]}")


class LayerTimes:
    """Per-layer times of the live rung, taken by wrapping its functions:
    host seconds of the batch build and of the host passes 4-5, and the
    device span (CUDA events on the compute stream) of each step,
    multi_step and pack launch sequence."""

    def __init__(self, live, cuda):
        self.live, self.cuda = live, cuda
        self.host = {"build": 0.0, "passes": 0.0, "dispatch": 0.0}
        self.spans = []
        self.calls = {"step": 0, "multi_step": 0, "_pack_results": 0,
                      "_integrate_oldest": 0}
        self._saved = []

    def _patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        self._saved.append((owner, name, real))
        setattr(owner, name, wrapper(real))

    def _host(self, key):
        def wrap(real):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    self.host[key] += time.perf_counter() - t0
            return timed
        return wrap

    def _device(self, name):
        def wrap(real):
            def timed(*a, **kw):
                self.calls[name] += 1
                if not self.cuda:
                    return real(*a, **kw)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = real(*a, **kw)
                ev[1].record()
                self.spans.append(ev)
                return out
            return timed
        return wrap

    def _count(self, name):
        def wrap(real):
            def counted(*a, **kw):
                self.calls[name] += 1
                return real(*a, **kw)
            return counted
        return wrap

    def __enter__(self):
        eng = self.live.LiveDeviceEngine
        self._patch(eng, "_build_batch", self._host("build"))
        self._patch(eng, "_depth_cut", self._host("build"))
        for name in ("step", "multi_step", "_pack_results"):
            self._patch(self.live, name, self._device(name))
        self._patch(self.live, "_integrate_oldest", self._count("_integrate_oldest"))
        self._patch(self.live, "_dispatch", self._host("dispatch"))
        return self

    def watch(self, hg):
        """Time the host passes 4-5 of this hashgraph."""
        for name in ("process_decided_rounds", "process_sig_pool"):
            setattr(hg, name, self._host("passes")(getattr(hg, name)))

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)

    def device_ms(self):
        if not self.cuda:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def hashgraph_phase(dev, log_fn, spec=BENCH, oneshot=HG_ONESHOT_RUNG, full=True,
                    expect=None, title="phase 12", live_settings=None, depth=None,
                    keep=False):
    """The hashgraph path on `dev` ("cuda", or "cpu" to rehearse on the
    plain versions) over the signed events of synthetic_grid(**spec):
    runs (a)-(c), and with `full` (phase 12) (d) and (e) too. `oneshot` is
    run (b)'s expected rung and its PATH_KERNELS entry; the live runs'
    entry is "run_consensus_live" plus the layout's suffix. `expect`
    (blocks, last_round) gates run (a); `live_settings` changes run (c)'s
    engine defaults; `depth` keeps the grid's first rows only. Returns
    {run: stats} and the launches of run (c); with `keep`, stats["kept"]
    holds the signed events and run (a)'s hashgraph and blocks."""
    from babble_tpu_torch import crypto, hashgraph as hgm, peers as peers_mod
    from babble_tpu_torch.tpu import _ext, engine, live
    from babble_tpu_torch.tpu.grid import synthetic_grid
    from babble_tpu_torch.tpu.packed import resolve_packed

    cuda = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    grid = synthetic_grid(spec["n"], spec["e_count"], seed=spec["seed"],
                          zipf_a=spec["zipf_a"])
    layout = "packed" if resolve_packed(None, grid.n) else "wide"
    live_path = "run_consensus_live" + (", packed" if layout == "packed" else "")
    t0 = time.perf_counter()
    host, peers_json, events = build_signed_events(grid, hgm, crypto, peers_mod, depth)
    log_fn(f"hashgraph path ({title}): {len(events)} signed events of "
           f"synthetic_grid({grid.n}, {grid.e}) built and inserted in "
           f"{time.perf_counter() - t0:.1f} s (HAVE_REAL_CRYPTO {crypto.HAVE_REAL_CRYPTO}); "
           f"voting-table layout {layout}")
    host_blocks = []
    host.commit_callback = host_blocks.append
    t0 = time.perf_counter()
    host.run_consensus()
    host_s = time.perf_counter() - t0
    ref = consensus_view(host)
    n_recv = sum(1 for f in ref[0].values() if f[2] is not None)
    log_fn(f"  (a) host run_consensus: {host_s:.1f} s, {len(host_blocks)} blocks, "
           f"{n_recv} events received, last round {host.store.last_round()}")
    if expect is not None and (len(host_blocks), host.store.last_round()) != expect:
        raise AssertionError(f"(a): {len(host_blocks)} blocks, last round "
                             f"{host.store.last_round()}; expected {expect}")
    stats = {"host": dict(blocks=len(host_blocks), received=n_recv, seconds=host_s)}
    if keep:
        stats["kept"] = dict(peers_json=peers_json, events=events, host=host,
                             host_blocks=host_blocks, ref=ref)

    def fresh(k):
        blocks = []
        hg = hgm.hashgraph_from_events(peers_json, events[:k], cache_size=HG_CACHE,
                                       commit_callback=blocks.append)
        return hg, blocks

    def insert(hg, lo, hi):
        for d in events[lo:hi]:
            hg.insert_event(hgm.Event.from_json(d), True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches_of(label, want):
        sync()
        got = dict(_ext.LAUNCHES)
        require_path_launches(label, want, got)
        return {k: v for k, v in got.items() if v}

    # (b) the one-shot rung
    hg, blocks = fresh(len(events))
    _ext.reset_launches()
    t0 = time.perf_counter()
    engine.run_consensus_device(hg, device=dev)
    sync()
    secs = time.perf_counter() - t0
    cells = [k.split("/") for k in hg.obs.devledger.snapshot() if k.endswith("/integrate")]
    rung = [c[0] for c in cells]
    if rung != [oneshot[0]] or cells[0][2] != layout:
        raise AssertionError(f"(b) run_consensus_device booked the rungs {rung} in the "
                             f"layout {cells[0][2] if cells else None}, not "
                             f"[{oneshot[0]!r}] in the {layout} layout")
    got = launches_of("(b) run_consensus_device", oneshot[1]) if cuda else {}
    require_same_consensus("(b) run_consensus_device", ref, host_blocks, hg, blocks)
    recv = sum(1 for f in consensus_view(hg)[0].values() if f[2] is not None)
    stats["oneshot"] = dict(calls=1, blocks=len(blocks), received=recv, seconds=secs,
                            rung=rung[0], launches=got)
    log_fn(f"  (b) run_consensus_device == host: rung {rung[0]} ({layout}), {secs:.3f} s, "
           f"{len(blocks)} blocks, {recv} received, {recv / secs:.0f} events brought to "
           f"consensus/s; launches {got}")

    def live_run(label, settings, first, step_n, path_kernels, crossover=None):
        """One live run, every call on the live rung; returns its stats."""
        saved = dict(live.ENGINE_DEFAULTS)
        env = os.environ.get("BABBLE_DOUBLING_CROSSOVER")
        live.ENGINE_DEFAULTS.update(settings)
        hg, blocks = fresh(first)
        st = dict(calls=0, seconds=0.0)
        try:
            with LayerTimes(live, cuda) as lt:
                lt.watch(hg)
                _ext.reset_launches()
                pos = first
                while pos < len(events) or st["calls"] == 0:
                    hi = min(pos + step_n, len(events)) if st["calls"] or not first else first
                    insert(hg, pos, hi)
                    pos = hi
                    if crossover is not None:
                        if st["calls"] == 0:
                            os.environ["BABBLE_DOUBLING_CROSSOVER"] = crossover
                        elif env is None:
                            os.environ.pop("BABBLE_DOUBLING_CROSSOVER", None)
                        else:
                            os.environ["BABBLE_DOUBLING_CROSSOVER"] = env
                    t0 = time.perf_counter()
                    live.run_consensus_live(hg, device=dev)
                    st["seconds"] += time.perf_counter() - t0
                    st["calls"] += 1
                    eng = getattr(hg, "_live_device_engine", None)
                    if eng is not None and eng.packed != (layout == "packed"):
                        raise AssertionError(f"{label}: call {st['calls']} ran an engine "
                                             f"outside the {layout} layout")
                    if st["calls"] == 1:
                        st["kept_at_attach"] = len(eng.hashes) if eng is not None else None
                        st["cold_replay"] = any(r.name == "catchup.replay"
                                                for r in hg.obs.flightrec.records())
                t0 = time.perf_counter()
                live.flush_live_engine(hg)
                sync()
                st["seconds"] += time.perf_counter() - t0
                launches = launches_of(label, path_kernels) if cuda else {}
                st["device_ms"] = lt.device_ms()
                st.update(build_ms=lt.host["build"] * 1e3, passes_ms=lt.host["passes"] * 1e3,
                          dispatch_us=lt.host["dispatch"] * 1e6 / max(st["calls"], 1),
                          calls_by_fn=dict(lt.calls))
                eng = getattr(hg, "_live_device_engine", None)
                st["packs"] = dict(eng.packs) if eng is not None else None
        finally:
            live.ENGINE_DEFAULTS.clear()
            live.ENGINE_DEFAULTS.update(saved)
            if env is None:
                os.environ.pop("BABBLE_DOUBLING_CROSSOVER", None)
            else:
                os.environ["BABBLE_DOUBLING_CROSSOVER"] = env
        cells = hg.obs.devledger.snapshot()
        st["fetch_ms"] = cells.get(f"live/dispatch/{layout}/fetch", [0, 0.0])[1] * 1e3
        st["integrate_ms"] = cells.get(f"live/dispatch/{layout}/integrate", [0, 0.0])[1] * 1e3
        eng = getattr(hg, "_live_device_engine", None)
        st["rebases"] = eng.rebases if eng is not None else None
        st["launches"] = launches
        require_same_consensus(label, ref, host_blocks, hg, blocks)
        st["blocks"] = len(blocks)
        st["received"] = sum(1 for f in consensus_view(hg)[0].values() if f[2] is not None)
        log_fn(f"  {label} == host: {st['calls']} calls, {st['blocks']} blocks, "
               f"{st['received']} received in {st['seconds']:.3f} s of consensus calls, "
               f"{st['received'] / st['seconds']:.0f} events brought to consensus/s; "
               f"layers: batch build {st['build_ms']:.1f} ms, device span of the launches "
               f"{st['device_ms']:.1f} ms, fetch {st['fetch_ms']:.1f} ms, integrate "
               f"{st['integrate_ms']:.1f} ms, host passes 4-5 {st['passes_ms']:.1f} ms; "
               f"the dispatch's host time {st['dispatch_us']:.1f} us a call (packs by route "
               f"{st['packs']}); rebases {st['rebases']}, calls {st['calls_by_fn']}; "
               f"launches {launches}")
        return st

    settings = dict(live_settings or {})
    stats["live"] = live_run(f"(c) run_consensus_live, defaults{settings or ''}", settings, 0,
                             HG_SYNC, live_path)
    c_launches = dict(stats["live"]["launches"])
    if not full:
        log_fn(f"hashgraph path: {time.perf_counter() - t_phase:.1f} s for {title}")
        return stats, c_launches
    d = dict(HG_REBASE)
    step_n = d.pop("sync")
    st = live_run(f"(d) run_consensus_live, r_cap {d['r_cap']}, pipelined, syncs of {step_n}",
                  d, 0, step_n, "run_consensus_live")
    if not (st["rebases"] and st["calls_by_fn"]["_integrate_oldest"]
            and st["calls_by_fn"]["multi_step"]):
        raise AssertionError(f"(d): rebases {st['rebases']}, pipelined integrations "
                             f"{st['calls_by_fn']['_integrate_oldest']}, multi_step calls "
                             f"{st['calls_by_fn']['multi_step']}: each must be above 0")
    stats["rebase"] = st
    st = live_run(f"(e) late attach after {HG_LATE_ATTACH} events", {}, HG_LATE_ATTACH,
                  HG_SYNC, "late attach", crossover=HG_CROSSOVER)
    if st["kept_at_attach"] is None or st["kept_at_attach"] >= HG_LATE_ATTACH:
        raise AssertionError(f"(e): kept {st['kept_at_attach']} rows at the attach")
    log_fn(f"  (e) attach kept {st['kept_at_attach']} of {HG_LATE_ATTACH} rows; cold "
           f"replay fired: {st['cold_replay']}")
    stats["attach"] = st
    log_fn(f"hashgraph path: {time.perf_counter() - t_phase:.1f} s for {title}")
    return stats, c_launches
def least_pow2(x):
    """The least power of two >= x (1 for x <= 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def packed_kernel_phase(g, dev, log_fn):
    """Phase 13: the packed kernels and the two repaired ones against their
    plain versions on the card, torch.equal, on the 256-validator grid g
    (WIDE) and small fixtures, with launches and CUDA-event times behind a
    spin. Returns (summary, work, upd_cap, batches on the card)."""
    from babble_tpu_torch.tpu import _ext, doubling, engine, frontier, kernels
    from babble_tpu_torch.tpu import incremental as inc
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_grid

    t_phase = time.perf_counter()
    summary, work = {}, {}
    sm, n = g.super_majority, g.n

    def held(what, kern, plain):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require_equal(what, got, want)
        return got

    def fame_pair(args, packed=True):
        return (lambda: tuple(kernels.decide_fame(*args, packed=packed)),
                lambda: tuple(kernels._decide_fame_plain(*args, packed=packed)))

    # K3 in both layouts: a non-lane-aligned and a word-crossing fixture,
    # the coin cases
    for fx in PACKED_FIXTURES:
        fg = synthetic_grid(fx[0], fx[1], seed=fx[2])
        fst = engine.stage_frontier(fg, dev)
        ffr = frontier.frontier_rounds(
            frontier.build_inv(fst.rows_by, fst.la), fst.rows_by, fst.creator, fst.index,
            fst.sp_index, fst.fd, fg.super_majority, R_CAP)
        args = (ffr.witness_table, fst.la, fst.fd, fst.index, fst.coin_bit, ffr.last_round,
                fg.super_majority, fg.n, R_CAP + 2)
        got = held(f"decide_fame/packed on fixture {fx}", *fame_pair(args))
        require_equal(f"decide_fame packed == wide on fixture {fx}", got,
                      held(f"decide_fame on fixture {fx}", *fame_pair(args, False)))
    for n_c, r, seed in COIN_CASES:
        case = coin_round_case(n_c, r, seed)
        for c in (case["coin_bit"], ~case["coin_bit"]):
            for pk in (True, False):
                held(f"decide_fame (packed={pk}) on coin case n={n_c} rounds={r} seed={seed}",
                     *fame_pair(coin_fame_args(case, c, dev), pk))
    log_fn(f"decide_fame == plain in both layouts on fixtures {PACKED_FIXTURES} (packed == "
           f"wide) and on the coin cases {COIN_CASES}, both coin settings")

    # K2 at the engine's round axis, then K3p on the grid's witness table
    # (the frontier walk's at WIDE_R_CAP)
    st = engine.stage_frontier(g, dev)
    inv = frontier.build_inv(st.rows_by, st.la)
    k2_args = (inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, R_CAP)
    k2, k2_plain = (lambda: tuple(frontier.frontier_rounds(*k2_args)),
                    lambda: tuple(frontier._frontier_rounds_plain(*k2_args, la=st.la)))
    held(f"frontier_rounds on the {n}-validator grid", k2, k2_plain)
    k2_hist = frontier._frontier_history_plain(inv, st.rows_by, st.fd, sm, R_CAP, la=st.la)
    summary["frontier_rounds (config #4)"] = {"max_abs_err": 0, "ms": spun_ms(k2, 10),
                                              "plain_ms": spun_ms(k2_plain, 3, warmup=1)}
    work["frontier_rounds (config #4)"] = frontier_rounds_work(inv, st, sm, k2_hist)
    log_fn(f"frontier_rounds == plain on the {n}-validator grid (r_cap {R_CAP}, "
           f"{walk_steps([k2_hist])} working steps): "
           f"{summary['frontier_rounds (config #4)']['ms']:.4f} ms, plain "
           f"{summary['frontier_rounds (config #4)']['plain_ms']:.2f} ms")
    fr = frontier.frontier_rounds(inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd,
                                  sm, WIDE_R_CAP)
    del inv, k2_args
    if int(fr.last_round) + 2 > WIDE_R_CAP:
        raise AssertionError(f"256 grid: last_round {int(fr.last_round)} overflows r_cap "
                             f"{WIDE_R_CAP}")
    fame_args = (fr.witness_table, st.la, st.fd, st.index, st.coin_bit, fr.last_round, sm, n,
                 WIDE_R_CAP + 2)
    kern, plain = fame_pair(fame_args)
    _ext.reset_launches()
    got = held(f"decide_fame/packed on the {n}-validator grid", kern, plain)
    launched = _ext.LAUNCHES["decide_fame/packed"]
    wide_kern, wide_plain = fame_pair(fame_args, False)
    require_equal(f"decide_fame packed == wide on the {n}-validator grid", got,
                  held(f"decide_fame on the {n}-validator grid", wide_kern, wide_plain))
    k_ms, p_ms = spun_ms(kern, 20), spun_ms(plain, 3, warmup=1)
    w_ms, wp_ms = spun_ms(wide_kern, 20), spun_ms(wide_plain, 3, warmup=1)
    summary["decide_fame/packed"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    summary["decide_fame (config #4)"] = {"max_abs_err": 0, "ms": w_ms, "plain_ms": wp_ms}
    work["decide_fame/packed"] = work["decide_fame (config #4)"] = fame_work(fr.witness_table, n)
    log_fn(f"decide_fame == plain in both layouts, packed == wide, on the {n}-validator "
           f"grid's witness table (r_cap {WIDE_R_CAP}, last_round {int(fr.last_round)}, "
           f"{int((fr.witness_table >= 0).sum())} witnesses): {launched} launch, packed "
           f"{k_ms:.4f} ms (plain {p_ms:.3f}), wide {w_ms:.4f} ms (plain {wp_ms:.3f})")
    fame = kernels.FameResult(*got)
    hold_received(f"the {n}-validator grid's tables (config #4)",
                  (fr.witness_table, st.la, st.index, st.creator, fr.rounds, fame.decided,
                   fame.famous, fame.rounds_decided, fr.last_round), log_fn)

    # K5p on the grid and on a pinned section of it
    res = engine.run_frontier_passes(g, device=dev)
    sec = section_grid(g, res, g.num_levels // 2)
    for label, sg in ((f"{n}-validator grid", g), (f"pinned section of the {n}-validator grid", sec)):
        gp, _, scan_r_max = engine.scan_layout(sg, True)
        ins = engine.stage_scan(gp, dev)
        dr_args = ins[:13] + (gp.super_majority, scan_r_max)
        kern = lambda: tuple(kernels.divide_rounds(*dr_args, packed=True))  # noqa: E731
        plain = lambda: tuple(kernels._divide_rounds_plain(*dr_args, packed=True))  # noqa: E731
        _ext.reset_launches()
        dr = held(f"divide_rounds/packed on the {label}", kern, plain)
        launched = _ext.LAUNCHES["divide_rounds/packed/grid"]
        line = (f"divide_rounds/packed == plain on the {label} ({sg.e} events, "
                f"{sg.num_levels} levels): {launched} launch")
        if sg is g:
            k_ms = spun_ms(kern, 5)
            p_ms = spun_ms(plain, 1, warmup=0)
            summary["divide_rounds/packed/grid"] = {"max_abs_err": 0, "ms": k_ms,
                                                    "plain_ms": p_ms}
            work["divide_rounds/packed/grid"], pairs, _ = scan_work(gp, ins, dr, scan_r_max)
            line += f", {k_ms:.3f} ms, plain {p_ms:.1f} ms; {pairs} (event, witness) pairs"
        log_fn(line)

    # K6 (one launch to the fixed point) on the grid, held to the plain
    # version with its pass count
    cs = doubling.stage_doubling(g, dev)
    cl_args = (cs.creator_d, cs.idx_d, cs.sp_d, cs.op_d, cs.rows_by_d, cs.l_b, cs.block,
               cs.pass_cap)

    def as_pair(out):
        return out[0], torch.tensor(out[1], device=dev)

    kern = lambda: as_pair(doubling._closure_la(*cl_args))  # noqa: E731
    plain = lambda: as_pair(doubling._closure_la_plain(*cl_args))  # noqa: E731
    _ext.reset_launches()
    la_fin, passes = held(f"closure_la on the {n}-validator grid", kern, plain)
    launched = _ext.LAUNCHES["closure_la"]
    k_ms, p_ms = spun_ms(kern, 5), spun_ms(plain, 1, warmup=0)
    summary["closure_la (config #4)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    work["closure_la (config #4)"] = closure_la_work(cs, la_fin, passes)
    log_fn(f"closure_la == plain on the {n}-validator grid (l {cs.l_b}, {int(passes)} passes, "
           f"{launched} launch, {_ext.smem_bytes('closure_la', n)} bytes of shared memory a "
           f"block): {k_ms:.4f} ms, plain {p_ms:.2f} ms")
    del la_fin

    # K7's cluster form (two blocks a cluster at 256 validators) on every
    # chunk of the grid's walk
    chunks, _, _ = held_walk(f"{n}-validator grid", g, cs, dev)
    big = max(chunks, key=lambda a: a[10])
    hold_walk_chunk_traps(f"{n}-validator grid", big, log_fn)
    k_ms = spun_ms(lambda: doubling._walk_chunk(*big), 5)
    p_ms = spun_ms(lambda: doubling._walk_chunk_plain(*big), SLOW_PLAIN_REPS, warmup=0)
    summary["walk_chunk (config #4)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    (nbytes, ops_s), st = walk_chunk_work(big, cs.l_b, n)
    work["walk_chunk (config #4)"] = (nbytes, ops_s)
    log_chunk_steps(f"{n}-validator grid", chunks, log_fn)
    log_fn(f"walk_chunk == plain on every chunk of the {n}-validator grid's walk "
           f"({', '.join(str(a[10]) for a in chunks)} steps, "
           f"{walk_chunk_form(n, cs.l_b)}); largest chunk {big[10]} steps x {big[11]} probes "
           f"{k_ms:.4f} ms, plain {p_ms:.2f} ms, bound "
           f"{max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms ({steps_note(st, big[10])})")
    del cs, chunks

    # K10p and K12p (and the repaired wide K12) on the append state, at
    # phase 14's window and at the live default's, where the latch fires
    cfg = WIDE_STEP
    t0 = time.perf_counter()
    upd_cap = cfg["e_cap"]
    while True:
        try:
            batches = inc.batches_from_grid(g, cfg["batch"], upd_cap, cfg["e_cap"])
            break
        except ValueError:  # a burst above the cap
            upd_cap *= 2
    burst = max_fd_burst(batches, cfg["e_cap"])
    if least_pow2(burst) != upd_cap:
        upd_cap = least_pow2(burst)
        batches = inc.batches_from_grid(g, cfg["batch"], upd_cap, cfg["e_cap"])
    batches_d = [inc.device_put(b, dev) for b in batches]
    torch.cuda.synchronize()
    log_fn(f"{n}-validator append inputs: {len(batches)} batches of {cfg['batch']}, largest fd "
           f"burst {burst}, upd_cap {upd_cap}; {time.perf_counter() - t0:.1f} s to build and "
           f"copy")
    for e_win, every_step, r_win in ((cfg["e_win"], 1, cfg["r_win"]),
                                     (WIDE_LATCH_E_WIN, WIDE_CHECK_EVERY, cfg["r_win"]),
                                     (WIDE_LATCH_E_WIN, WIDE_CHECK_EVERY, WIDE_FREEZE_R_WIN)):
        run = drive_paired(f"{n}-validator step state at e_win {e_win}, r_win {r_win}", g,
                           dict(cfg, r_win=r_win), e_win, batches_d, dev, every_step,
                           WIDE_CHECK_EVERY, log_fn)
        fin = run.k
        received = int((fin.received >= 0).sum())
        latched = bool(fin.stale)
        if latched != (e_win == WIDE_LATCH_E_WIN) or (not latched and received == 0):
            raise AssertionError(f"{n}-validator step state at e_win {e_win}: stale "
                                 f"{latched}, {received} received")
        if r_win < cfg["r_cap"]:
            lr = int(fin.last_round)
            undecided = torch.nonzero(~fin.rounds_decided[: lr + 1].cpu())
            floor_true = int(undecided[0]) if undecided.numel() else lr
            if floor_true <= cfg["r_cap"] - r_win:
                raise AssertionError(f"r_win {r_win}: first undecided round {floor_true}, the "
                                     f"window's floor never clipped below it")
            log_fn(f"  r_win {r_win} < r_cap {cfg['r_cap']}: floor {cfg['r_cap'] - r_win}, "
                   f"first undecided round {floor_true}: the freeze held rounds "
                   f"{cfg['r_cap'] - r_win} .. {floor_true - 1} in the last calls")
    log_fn(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return summary, work, upd_cap, batches_d


def hold_k5_forms(label, g, dev, log_fn):
    """K5's walks that take grid g (the one block where its forms fit, the
    grid) held torch.equal to the plain version on g's level scan as
    run_passes stages it, with their CUDA-event times: the crossover's
    sides at g's width."""
    from babble_tpu_torch.tpu import _ext, engine, kernels

    gp, _, scan_r_max = engine.scan_layout(g, True)
    ins = engine.stage_scan(gp, dev)
    dr_args = ins[:13] + (gp.super_majority, scan_r_max)
    want = tuple(kernels._divide_rounds_plain(*dr_args))
    n_lvl = ins[0].shape[1]
    line = []
    for form in _ext.WALK_FORMS:
        if not _ext.divide_rounds_form_fits(form, g.n, n_lvl):
            continue
        run = lambda: tuple(_ext.divide_rounds(*dr_args, form=form))  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        require_equal(f"divide_rounds ({form} walk) on the {label}", got, want)
        line.append(f"{form} walk {spun_ms(run, 5):.3f} ms")
    log_fn(f"divide_rounds, every walk that fits == plain on the {label} ({g.n} validators, "
           f"{g.num_levels} levels; the wrapper takes the "
           f"{_ext.divide_rounds_form(g.n, n_lvl)} walk): {', '.join(line)}")


def hold_walk_carries(label, dr_args, lam_args, levels, log_fn, want=None, want_lam=None):
    """K5's one-block walk and K8 held torch.equal to their plain versions
    in every carry form (_ext.WALK_CARRIES: "shared", the first rows that
    fit on chip and the rest in device memory, as level_walk_plan places
    them; "device", every row in device memory) on one level table
    (dr_args: K5's fifteen arguments, lam_args: K8's six); with `levels`
    (the table's levels holding an event), each form's CUDA-event time and
    microseconds a level."""
    from babble_tpu_torch.tpu import _ext, doubling, kernels

    if want is None:
        want = tuple(kernels._divide_rounds_plain(*dr_args))
    if want_lam is None:
        want_lam = doubling._lamport_levels_scan_plain(*lam_args)
    e, n = dr_args[5].shape
    n_lvl = dr_args[0].shape[1]
    line = []
    for carry in _ext.WALK_CARRIES:
        k5 = lambda: tuple(_ext.divide_rounds(*dr_args, form="block", carry=carry))  # noqa: E731
        k8 = lambda: _ext.lamport_scan(*lam_args, carry=carry)  # noqa: E731
        got5, got8 = k5(), k8()
        torch.cuda.synchronize()
        require_equal(f"divide_rounds (one-block walk, {carry} carry) on the {label}", got5, want)
        require_equal(f"lamport_scan ({carry} carry) on the {label}", got8, want_lam)
        rp = _ext.level_walk_plan("divide_rounds", e, n, n_lvl, dr_args[14], carry)["rounds"]
        lp = _ext.level_walk_plan("lamport_scan", lam_args[1].shape[0], 1,
                                  lam_args[0].shape[1], carry=carry)["lamport"]
        item = (f"{carry}: K5 {rp['chip']} of {e} rounds rows on chip, window {rp['win']}, "
                f"K8 {lp['chip']} rows on chip")
        if levels:
            k5_ms, k8_ms = cuda_ms(k5, 5), cuda_ms(k8, 5)
            item += (f", K5 {k5_ms:.4f} ms ({k5_ms * 1e3 / levels:.3f} us a level), "
                     f"K8 {k8_ms:.4f} ms ({k8_ms * 1e3 / levels:.3f} us a level)")
        line.append(item)
    log_fn(f"divide_rounds (one-block walk) and lamport_scan == plain on the {label} in "
           f"every carry form: {'; '.join(line)}")


def max_fd_burst(batches, e_cap):
    """The most fd updates one batch carries."""
    return max(int((b.upd_row < e_cap).sum()) for b in batches)


def drive_paired(label, g, cfg, e_win, batches_d, dev, every_step, every_decide, log_fn):
    """A PairedRun from a fresh state of shape cfg through batches_d:
    step_levels/packed/grid (K10p's grid walk: 128 validators and up, with
    K9 as its phase 0, held to the plain K9 then the plain K10: step_call)
    after every every_step-th call and the decide after every
    every_decide-th held to their plain versions (the decide packed and
    wide in turn when every_decide > 1, packed only when it is 1); the
    kernels advance both states in between. Logs the final state, the
    launches and the per-call times; returns the run."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import incremental as inc

    sm, n = g.super_majority, g.n
    r_win = cfg["r_win"]
    run = PairedRun(label, inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev))
    _ext.reset_launches()
    for k, b in enumerate(batches_d):
        step_call(run, "step_levels/packed/grid", b, sm, packed=True,
                  check=k % every_step == every_step - 1)
        packed = every_decide == 1 or (k // every_decide) % 2 == 0
        run.call("decide_window/packed" if packed else "decide_window",
                 lambda st: inc._decide_body(st, sm, n, r_win=r_win, e_win=e_win, packed=packed),
                 lambda st: inc._decide_body_plain(st, sm, n, r_win, e_win, packed=packed),
                 lambda st: inc_work_decide(st, r_win, e_win),
                 check=k % every_decide == every_decide - 1)
    launches = {k: v for k, v in _ext.LAUNCHES.items() if v}
    fin = run.k
    layouts = "packed" if every_decide == 1 else "packed and wide in turn"
    log_fn(f"apply_deltas + step_levels/packed/grid in one launch (every {every_step}) and "
           f"decide_window, "
           f"{layouts} (every {every_decide}) == plain on the {label} ({len(batches_d)} "
           f"batches, r_win {r_win}): last_round {int(fin.last_round)}, "
           f"{int((fin.received >= 0).sum())} received, stale {bool(fin.stale)}, fame_lag "
           f"{bool(fin.fame_lag)}; launches on both states {launches}")
    for name in ("step_levels/packed/grid", "decide_window/packed", "decide_window"):
        if name not in run.events:
            continue
        calls, k_ms, p_ms = run.times(name)
        _, work = run_summary(run, (name,))
        nbytes, ops_s = work[name]
        bound = max(nbytes / HBM_BYTES_S, ops_s) * 1e3
        log_fn(f"  {name}: {calls} checked calls, kernel {k_ms / calls:.4f} ms per call, "
               f"plain {p_ms / calls:.2f} ms per call, bound {bound:.6f} ms")
    return run


def run_summary(run, names):
    """(summary, work) entries of the kernels line from a PairedRun: the
    per-call means of its checked calls."""
    summary, work = {}, {}
    for name in names:
        calls, k_ms, p_ms = run.times(name)
        nbytes, alu, tc = run.work[name]
        summary[name] = {"max_abs_err": 0, "ms": k_ms / calls, "plain_ms": p_ms / calls}
        work[name] = (nbytes / calls, (alu / ALU_OPS_S + tc / INT8_TC_OPS_S) / calls)
    return summary, work


def switch_kernel_phase(dev, log_fn):
    """Phase 15's kernel check: K9, K10p and K12p at the shape of run (c)
    (SWITCH_STEP) on the switch grid, every call held to the plain
    versions. Returns (summary, work) of the two packed kernels."""
    from babble_tpu_torch.tpu import incremental as inc
    from babble_tpu_torch.tpu.grid import synthetic_grid

    t0 = time.perf_counter()
    cfg = SWITCH_STEP
    g = synthetic_grid(SWITCH["n"], SWITCH["e_count"], seed=SWITCH["seed"],
                       zipf_a=SWITCH["zipf_a"], record_fd_updates=True)
    hold_k5_forms("switch grid", g, dev, log_fn)
    batches = inc.batches_from_grid(g, cfg["batch"], cfg["upd_cap"], cfg["e_cap"])
    burst = max_fd_burst(batches, cfg["e_cap"])
    batches_d = [inc.device_put(b, dev) for b in batches]
    log_fn(f"{g.n}-validator append inputs: {len(batches_d)} batches of {cfg['batch']}, "
           f"largest fd burst {burst} (the live default upd_cap is 8,192), upd_cap "
           f"{cfg['upd_cap']}")
    run = drive_paired(f"{g.n}-validator live shape, e_win {cfg['e_win']}", g, cfg,
                       cfg["e_win"], batches_d, dev, 1, 1, log_fn)
    fin = run.k
    if bool(fin.stale) or bool(fin.fame_lag) or int((fin.received >= 0).sum()) == 0:
        raise AssertionError(f"{g.n}-validator live shape: stale {bool(fin.stale)}, fame_lag "
                             f"{bool(fin.fame_lag)}, {int((fin.received >= 0).sum())} received")
    summary = run_summary(run, ("step_levels/packed/grid", "decide_window/packed"))
    # the kernels alone through step at the live default's windows
    for e_win in SWITCH_SHORT_E_WINS:
        st = inc.init_state(g.n, cfg["e_cap"], cfg["r_cap"], device=dev)
        for b in batches_d:
            inc.step(st, b, g.super_majority, g.n, r_win=cfg["r_win"], e_win=e_win,
                     packed=True)
        log_fn(f"  step at e_win {e_win} on the same batches: stale {bool(st.stale)}, "
               f"fame_lag {bool(st.fame_lag)}, {int((st.received >= 0).sum())} received")
    log_fn(f"phase 15 kernel check: {time.perf_counter() - t0:.1f} s")
    return summary


def wide_engine_phase(g, dev, log_fn, upd_cap, batches_d):
    """Phase 14: config #4's grid g through the three one-shot engines in
    the knob's layout (packed) and the wide one, and through step and
    multi_step; returns each packed path's launches and the engines'
    result."""
    from babble_tpu_torch.tpu import doubling, engine
    from babble_tpu_torch.tpu import incremental as inc

    t_phase = time.perf_counter()
    n = g.n
    engines = {
        "run_frontier_passes": lambda **kw: engine.run_frontier_passes(g, device=dev, **kw),
        "run_passes": lambda **kw: engine.run_passes(
            g, bucketed=True, adaptive_r=True, device=dev, **kw),
        "run_doubling_passes": lambda **kw: doubling.run_doubling_passes(g, device=dev, **kw),
    }
    results, launches = {}, {}
    for name, fn in engines.items():
        packed, launches[name] = run_path(f"{name}, packed", fn)
        wide, launches[f"{name}, wide"] = run_path(name, lambda: fn(packed=False))
        require_same_results(f"{name}: packed == wide", packed, wide)
        results[name] = packed
    ref = results["run_frontier_passes"]
    for name in ("run_passes", "run_doubling_passes"):
        require_same_results(f"{name} == run_frontier_passes", results[name], ref)
    got = dict(last_round=ref.last_round, received=int((ref.received >= 0).sum()),
               witnesses=int(ref.witness.sum()))
    if got != WIDE_EXPECT:
        raise AssertionError(f"256 grid: {got}, the reference gives {WIDE_EXPECT}")
    log_fn(f"config #4 grid: the three engines agree in both layouts field for field: {got}")
    # K3 in both layouts on the frontier engine's own witness table
    from babble_tpu_torch.tpu import kernels

    fst = engine.stage_frontier(g, dev)
    wt = torch.from_numpy(np.ascontiguousarray(ref.witness_table, dtype=np.int32)).to(dev)
    fame_args = (wt, fst.la, fst.fd, fst.index, fst.coin_bit,
                 torch.tensor(ref.last_round, dtype=torch.int32, device=dev), g.super_majority,
                 n, wt.shape[0] + 2)
    for pk in (True, False):
        got_f = tuple(kernels.decide_fame(*fame_args, packed=pk))
        want_f = tuple(kernels._decide_fame_plain(*fame_args, packed=pk))
        torch.cuda.synchronize()
        require_equal(f"decide_fame (packed={pk}) on run_frontier_passes' witness table", got_f,
                      want_f)
    log_fn(f"decide_fame == plain in both layouts on run_frontier_passes' witness table "
           f"({wt.shape[0]} rounds)")
    del fst
    for name, fn in engines.items():
        ms = wall_ms(fn, WIDE_RUNS)
        log_fn(f"e2e {name} (packed) on the {n}-validator grid: median {ms:.3f} ms over {WIDE_RUNS} "
               f"warm runs, {g.e / ms * 1e3:.0f} events/s")
    log_fn(split_line(f"  run_doubling_passes (packed) on the {n}-validator grid, split",
                      *cold_path_split(engines["run_doubling_passes"], WIDE_RUNS)))

    cfg = WIDE_STEP
    sm, n, e = g.super_majority, g.n, g.e
    empty = inc.device_put(inc.empty_batch(n, cfg["batch"], upd_cap, cfg["e_cap"]), dev)
    groups = []
    for i in range(0, len(batches_d), MULTI_STEP_K):
        group = batches_d[i : i + MULTI_STEP_K]
        group = group + [empty] * (MULTI_STEP_K - len(group))
        groups.append(inc.Batch(*[torch.stack(f) for f in zip(*group)]))
    e_win = cfg["e_win"]
    paths = {
        "step, packed": lambda st: [inc.step(st, b, sm, n, r_win=cfg["r_win"], e_win=e_win,
                                             packed=True)
                                    for b in batches_d],
        "multi_step, packed": lambda st: [inc.multi_step(
            st, gr, sm, n, r_win=cfg["r_win"], e_win=e_win, packed=True)
            for gr in groups],
    }
    for label, drive in paths.items():
        st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, launches[label] = run_path(label, lambda: drive(st))
        wall = time.perf_counter() - t0
        for f in ("rounds", "lamport", "witness", "received"):
            if not (getattr(st, f)[:e].cpu().numpy() == getattr(ref, f)).all():
                raise AssertionError(f"{label}: {f} differs from run_passes on the card")
        if bool(st.stale) or bool(st.fame_lag):
            raise AssertionError(f"{label}: stale {bool(st.stale)}, fame_lag "
                                 f"{bool(st.fame_lag)}")
        log_fn(f"{label} over the {n}-validator grid's {len(batches_d)} batches (r_win "
               f"{cfg['r_win']}, e_win {e_win}) == run_passes on rows [:e], no latch: "
               f"{wall * 1e3:.1f} ms (first run), {e / wall:.0f} events appended/s")
    log_fn(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches, ref


def fr_diff(a, b, fields=None):
    """Names of the fields (all by default) in which two states differ."""
    return [f for f in (fields or a._fields) if not torch.equal(getattr(a, f), getattr(b, f))]


class PlainFame:
    """Inside the block frontier_live's decide votes and receives with the
    plain versions of K3 / K3p and K4 (the yardstick on the card)."""

    def __enter__(self):
        from babble_tpu_torch.tpu import frontier_live as fl, kernels

        self.saved = (fl.decide_fame, fl.decide_round_received)
        fl.decide_fame = kernels._decide_fame_plain
        fl.decide_round_received = kernels._decide_round_received_plain
        return self

    def __exit__(self, *exc):
        from babble_tpu_torch.tpu import frontier_live as fl

        fl.decide_fame, fl.decide_round_received = self.saved


def fl_work_append(st, t):
    """(bytes, ALU ops, 0) K14 needs for train t on state st (after the
    append): each train row's inputs read once, each real row's staging
    written once, and every dirty chain's (N, L) planes read and written
    once; a compare per (row, coordinate)."""
    e_cap, n = st.la.shape
    l = st.rows_by.shape[1]
    kb = t.rows.shape[0]
    real = int((t.rows >= 0).sum())
    dirty = int(st.dirty.sum())
    return (kb * (n + 7) * 4 + real * (n + 5) * 4 + real * 8 + 2 * dirty * n * l * 4,
            kb * n + dirty * n * l, 0)


def window_start(st, r_win):
    """The first history row K15's window rewrites on state st, as the
    plain version finds it."""
    l = st.rows_by.shape[1]
    r_cap = st.x_hist.shape[0]
    first_sent = (st.x_hist < l).sum(dim=0)
    floor = int(torch.where(st.dirty, first_sent, torch.full_like(first_sent, r_cap)).min())
    return max(min(max(floor, 0), r_cap - r_win) - 1, 0)


def fl_work_window(st, win, super_majority):
    """(bytes, ALU ops, 0) K15 needs, from the plain version's window win on
    state st, over the walk's working steps (walk_steps on the window's
    rows): the INV row of every frontier row a step reads (N values for
    each distinct (chain, index)), for every chain the INV values at each
    (coordinate, index) a step probes (the frontier rows' values, the
    coordinates' live m0), the history read and written, the rows'
    metadata in and rounds / witness out, the witness rows of la in and the
    tables out; two operations a probe, the closure's compares and the post
    pass's per-row round counts."""
    from babble_tpu_torch.tpu import frontier_live as fl
    from babble_tpu_torch.tpu.frontier import (M0_BINSEARCH_MIN_N, _m0_binsearch,
                                               _m0_einsum_sort)
    from babble_tpu_torch.tpu.grid import MAX_INT32

    e_cap, n = st.la.shape
    l = st.rows_by.shape[1]
    r_cap = st.x_hist.shape[0]
    r_win = min(fl.R_WIN, r_cap)
    start = window_start(st, r_win)
    rows = win.x_hist[start:start + r_win]
    steps = walk_steps([rows], r_win)
    cc = torch.arange(n, device=rows.device)
    staged = torch.zeros((n, l), dtype=torch.bool, device=rows.device)
    probed = torch.zeros_like(staged)
    chain_len = (st.rows_by >= 0).sum(dim=1, dtype=torch.int32)
    rb = st.rows_by.clamp(0, e_cap - 1)
    probes = 0
    for r in range(steps):
        x = rows[r]
        w_ok = x < l
        xc = x.clamp(0, l - 1).long()
        fdw = st.inv[cc[None, :], cc[:, None], xc[:, None]]  # (w, p)
        fd_w = torch.where(w_ok[:, None] & (fdw < l), fdw, torch.full_like(fdw, MAX_INT32))
        staged[cc[w_ok], xc[w_ok]] = True
        if n >= M0_BINSEARCH_MIN_N:
            m0 = _m0_binsearch(fd_w, w_ok, rb, chain_len, st.la, super_majority, l)
        else:
            m0 = _m0_einsum_sort(fd_w, w_ok, st.inv, super_majority, l)
        vals = fd_w[w_ok]
        ok = vals < MAX_INT32
        probed[cc.expand_as(vals)[ok], vals[ok].long()] = True
        cm = m0 < l
        probed[cc[cm], m0[cm].long()] = True
        probes += n * vals.shape[0] * n
    n_wit = int((win.wtable >= 0).sum())
    return (int(staged.sum()) * n * 4 + n * int(probed.sum()) * 4 + 2 * r_cap * n * 4 + n
            + e_cap * 9 + e_cap * 5 + n_wit * n * 4 + r_cap * n * (4 * 3 + 1)
            + 2 * r_cap * n * n * 4,
            2 * probes + steps * n * n * 2 + e_cap * r_cap, 0)


class FlPaired:
    """A frontier-live state driven train by train through the kernels,
    each kernel held torch.equal to its plain version on the same input
    (K14 on a clone of the state, K15 on the appended state, the decide's
    K3 / K3p and K4 over the window's tables against the plain fame and
    received), with CUDA-event times and the work of each checked call."""

    def __init__(self, st, sm, n, packed):
        self.st, self.sm, self.n, self.packed = st, sm, n, packed
        self.events, self.work = {}, {}

    def _timed(self, name, kern, plain, work=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        # K14's wrapper checks some twenty tensors and makes five calls into
        # the library: a longer spin keeps the host's side out of the events
        torch.cuda._sleep(4 * SPIN_CYCLES)
        ev[0].record()
        got = kern()
        ev[1].record()
        ev[2].record()
        want = plain()
        ev[3].record()
        self.events.setdefault(name, []).append(ev)
        if work is not None:
            acc = self.work.setdefault(name, [0, 0, 0])
            for i, w in enumerate(work(want)):
                acc[i] += w
        return got, want

    def train(self, t, label):
        from babble_tpu_torch.tpu import frontier_live as fl

        st, sm = self.st, self.sm
        clone = fl.clone_frontier_state(st)
        self._timed("frontier_append", lambda: fl._append_train(st, t),
                    lambda: fl._append_train_plain(clone, t),
                    lambda _: fl_work_append(st, t))
        bad = fr_diff(st, clone)
        if bad:
            raise AssertionError(f"frontier_append on the {label}: {bad} differ from the plain version")
        win, want = self._timed("frontier_window", lambda: fl._decide_window(st, sm),
                                lambda: fl._decide_window_plain(st, sm),
                                lambda w: fl_work_window(st, w, sm))
        bad = [f for f in win._fields if not torch.equal(getattr(win, f), getattr(want, f))]
        if bad:
            raise AssertionError(f"frontier_window on the {label}: {bad} differ from the plain version")
        got = fl._decide_from(st, win, sm, self.n, self.packed)
        with PlainFame():
            ref = fl._decide_from(st, want, sm, self.n, self.packed)
        bad = fr_diff(got, ref)
        if bad:
            raise AssertionError(f"the decide on the {label}: {bad} differ from the plain fame "
                                 f"and received")
        fl._assign(st, got)

    def summary(self, name):
        """(calls, kernel ms per call, plain ms per call, (bytes, seconds at
        the peak rates) per call)."""
        torch.cuda.synchronize()
        evs = self.events[name]
        calls = len(evs)
        nbytes, alu, _ = self.work[name]
        return (calls, sum(e[0].elapsed_time(e[1]) for e in evs) / calls,
                sum(e[2].elapsed_time(e[3]) for e in evs) / calls,
                (nbytes / calls, alu / ALU_OPS_S / calls))


def require_rows(label, st, ref, e):
    """Rows [:e] of rounds, witness, lamport and received equal a one-shot
    PassResults, and the same last_round."""
    for f in ("rounds", "witness", "lamport", "received"):
        if not (getattr(st, f)[:e].cpu().numpy() == getattr(ref, f)).all():
            raise AssertionError(f"{label}: {f} differs from the one-shot engines")
    if int(st.last_round) != ref.last_round:
        raise AssertionError(f"{label}: last_round {int(st.last_round)} != {ref.last_round}")


def latches(st):
    return dict(l_over=bool(st.l_over), r_over=bool(st.r_over),
                frozen_violation=bool(st.frozen_violation))


def fl_bench_phase(bench, trains, res, dev, log_fn):
    """Phase 16 (a) and (c): the bench cell's four trains through
    frontier_train_step, K14 and K15 held to their plain versions after
    every train; frontier_multi_train over groups of MULTI_TRAIN_K stacked
    trains (a decide per group: its R_WIN rounds cover what two trains
    add, not four); events appended per second; the bootstrap. Returns
    (summary, work, launches)."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import frontier_live as fl
    from babble_tpu_torch.tpu import incremental as inc

    t_phase = time.perf_counter()
    sm, n, e = bench.super_majority, bench.n, bench.e
    e_cap, l_cap, r_cap = INC_TRAIN["e_cap"], FL_BENCH["l_cap"], FL_BENCH["r_cap"]
    trains_d = [inc.device_put(t, dev) for t in trains]
    groups = [inc.device_put(inc.stack_trains(trains[i : i + MULTI_TRAIN_K]), dev)
              for i in range(0, len(trains), MULTI_TRAIN_K)]
    want = dict(last_round=BENCH_LAST_ROUND, received=BENCH_RECEIVED,
                l_over=False, r_over=False, frozen_violation=False)

    def final(label, st):
        require_rows(label, st, res, e)
        got = dict(last_round=int(st.last_round), received=int((st.received[:e] >= 0).sum()),
                   **latches(st))
        if got != want:
            raise AssertionError(f"{label}: {got}, the reference gives {want}")
        return got

    # the first launches of K14 and K15 load their code on the card: one
    # throwaway train keeps that out of the timed calls
    fl.frontier_train_step(fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev),
                           trains_d[0], sm, n)
    run = FlPaired(fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev), sm, n, False)
    _ext.reset_launches()
    for k, t in enumerate(trains_d):
        run.train(t, f"bench cell, train {k}")
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    require_path_launches("frontier_train_step on the bench cell", "frontier_train_step",
                          launches)
    got = final("frontier_train_step", run.st)
    log_fn(f"frontier_train_step over the bench cell's {len(trains_d)} trains (l_cap {l_cap}, "
           f"r_cap {r_cap}, INV {run.st.inv.numel() * 4 >> 20} MiB): frontier_append, "
           f"frontier_window and the decide == plain after every train; == run_frontier_passes "
           f"on rows [:e]: {got}; launches {({k: v for k, v in launches.items() if v})}")
    summary, work, launches_all = {}, {}, launches
    launches = {}
    for name in ("frontier_append", "frontier_window"):
        calls, k_ms, p_ms, w = run.summary(name)
        summary[name] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
        work[name] = w
        launches[name] = launches_all[name]
        log_fn(f"  {name}: {calls} checked calls, kernel {k_ms:.4f} ms per call, plain "
               f"{p_ms:.2f} ms per call; work {w[0]:.0f} bytes per call")
    st = fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev)
    run_path("frontier_multi_train", lambda: [fl.frontier_multi_train(st, gr, sm, n)
                                              for gr in groups])
    bad = fr_diff(st, run.st, ("rounds", "witness", "lamport", "received", "wtable",
                               "fame_decided", "famous", "rounds_decided", "last_round",
                               "inv", "rows_by", "la", "count"))
    if bad:
        raise AssertionError(f"frontier_multi_train: {bad} differ from the per-train steps")
    final("frontier_multi_train", st)
    for label, drive in (
        ("frontier_train_step", lambda st: [fl.frontier_train_step(st, t, sm, n)
                                            for t in trains_d]),
        ("frontier_multi_train", lambda st: [fl.frontier_multi_train(st, gr, sm, n)
                                             for gr in groups]),
    ):
        walls = []
        for _ in range(FL_RUNS + 2):
            st = fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive(st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        final(label, st)
        wall = statistics.median(walls[2:])
        log_fn(f"e2e {label} on the bench cell: median {wall * 1e3:.3f} ms over {FL_RUNS} warm "
               f"runs from a fresh state, {e / wall:.0f} events appended/s")

    # (c) the cold-start bootstrap of the same grid
    _ext.reset_launches()
    t0 = time.perf_counter()
    bst = fl.bootstrap_frontier_state(bench, e_cap, l_cap, r_cap, n, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b_launches = dict(_ext.LAUNCHES)
    require_path_launches("bootstrap_frontier_state", "bootstrap_frontier_state", b_launches)
    got = final("bootstrap_frontier_state", bst)
    if int(bst.count) != e:
        raise AssertionError(f"bootstrap_frontier_state: count {int(bst.count)} != {e}")
    log_fn(f"bootstrap_frontier_state on the bench grid == run_frontier_passes: {got}, "
           f"{secs:.3f} s (first call); launches {({k: v for k, v in b_launches.items() if v})}")
    log_fn(f"phase 16 (a), (c): {time.perf_counter() - t_phase:.1f} s")
    return summary, work, launches


def fl_wide_phase(g, ref, dev, log_fn):
    """Phase 16 (b): config #4 in trains of 8,192 through frontier_train_step
    in both layouts (K14, K15 and the decide held to their plain versions
    after every train in each; wide equal to packed after every train),
    equal to phase 14's one-shot result; then train_step (K11p held to its
    plain version after every train) and multi_train in the packed layout,
    equal to the wide train_step. Returns (summary, work, launches) of
    train_levels/packed."""
    from babble_tpu_torch.tpu import _ext
    from babble_tpu_torch.tpu import frontier_live as fl
    from babble_tpu_torch.tpu import incremental as inc

    t_phase = time.perf_counter()
    sm, n, e = g.super_majority, g.n, g.e
    cfg = FL_WIDE
    t0 = time.perf_counter()
    trains = inc.trains_from_grid(g, cfg["train"], cfg["upd_cap"], FL_WIDE_INC["e_cap"],
                                  t_cap=cfg["t_cap"])
    trains_d = [inc.device_put(t, dev) for t in trains]
    torch.cuda.synchronize()
    l_cap = least_pow2(int(g.index.max()) + 1 + cfg["l_margin"])
    r_cap = cfg["r_cap"]
    log_fn(f"{n}-validator trains: {len(trains)} of {cfg['train']} (levels "
           f"{[t.levels.shape[0] for t in trains]}), hottest chain "
           f"{int(g.index.max()) + 1} events, l_cap {l_cap}; "
           f"{time.perf_counter() - t0:.1f} s to build and copy")
    e_cap = FL_WIDE_INC["e_cap"]
    run = FlPaired(fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev), sm, n, True)
    snaps = []
    _ext.reset_launches()
    for k, t in enumerate(trains_d):
        run.train(t, f"{n}-validator grid, train {k}")
        snaps.append(fl.clone_frontier_state(run.st))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    require_path_launches(f"frontier_train_step, packed, {n} validators",
                          "frontier_train_step, packed", launches)
    # the wide layout, its K14, K15 and decide (K3 wide) held to their plain
    # versions after every train too
    wide = FlPaired(fl.init_frontier_state(n, e_cap, l_cap, r_cap, device=dev), sm, n, False)
    for k, t in enumerate(trains_d):
        wide.train(t, f"{n}-validator grid, wide, train {k}")
        bad = fr_diff(wide.st, snaps[k])
        if bad:
            raise AssertionError(f"frontier_train_step at {n} validators, train {k}: the wide "
                                 f"layout's {bad} differ from the packed")
    del snaps
    require_rows(f"frontier-live at {n} validators", run.st, ref, e)
    got = dict(last_round=int(run.st.last_round), received=int((run.st.received >= 0).sum()),
               witnesses=int(run.st.witness.sum()), **latches(run.st))
    if got != dict(WIDE_EXPECT, l_over=False, r_over=False, frozen_violation=False):
        raise AssertionError(f"frontier-live at {n} validators: {got}")
    log_fn(f"frontier_train_step over config #4's {len(trains_d)} trains (l_cap {l_cap}, r_cap "
           f"{r_cap}): both layouts == plain after every train, wide == packed, both == the one-shot "
           f"engines: {got}; launches {({k: v for k, v in launches.items() if v})}")
    for name in ("frontier_append", "frontier_window"):
        calls, k_ms, p_ms, _ = run.summary(name)
        log_fn(f"  {name} at {n} validators: {calls} checked calls, kernel {k_ms:.4f} ms per "
               f"call, plain {p_ms:.2f} ms per call")

    # the incremental train paths on the same trains, packed against wide
    ic = FL_WIDE_INC
    prun = PairedRun(f"{n}-validator train shape", inc.init_state(n, ic["e_cap"], ic["r_cap"],
                                                                   device=dev))
    _ext.reset_launches()
    for t in trains_d:
        prun.call("apply_deltas", lambda st: inc._apply_deltas_and_stage(st, t), None,
                  check=False)
        prun.call("train_levels/packed/grid",
                  lambda st: inc._train_levels(st, t, sm, packed=True),
                  lambda st: inc._train_levels_plain(st, t, sm, packed=True),
                  lambda st: inc_work_levels(st, t, False))
        prun.call("decide_window/packed",
                  lambda st: inc._decide_body(st, sm, n, r_win=ic["r_win"], e_win=ic["e_win"],
                                              packed=True), None, check=False)
    wide_st = inc.init_state(n, ic["e_cap"], ic["r_cap"], device=dev)
    _, w_launches = run_path("train_step", lambda: [inc.train_step(
        wide_st, t, sm, n, r_win=ic["r_win"], e_win=ic["e_win"]) for t in trains_d])
    bad = state_diff(prun.k, wide_st)
    if bad:
        raise AssertionError(f"train_step, packed at {n} validators: {bad} differ from the wide")
    pk_st = inc.init_state(n, ic["e_cap"], ic["r_cap"], device=dev)
    _, p_launches = run_path("train_step, packed", lambda: [inc.train_step(
        pk_st, t, sm, n, r_win=ic["r_win"], e_win=ic["e_win"], packed=True) for t in trains_d])
    groups = [inc.device_put(inc.stack_trains(trains[i : i + MULTI_TRAIN_K]), dev)
              for i in range(0, len(trains), MULTI_TRAIN_K)]
    mt_st = inc.init_state(n, ic["e_cap"], ic["r_cap"], device=dev)
    run_path("multi_train, packed", lambda: [inc.multi_train(
        mt_st, gr, sm, n, r_win=ic["r_win"], e_win=ic["e_win"], packed=True) for gr in groups])
    for label, st in (("train_step, packed", pk_st), ("multi_train, packed", mt_st)):
        bad = state_diff(st, wide_st)
        if bad:
            raise AssertionError(f"{label} at {n} validators: {bad} differ from train_step")
    require_rows(f"train_step at {n} validators", wide_st, ref, e)
    res = dict(last_round=int(wide_st.last_round), received=int((wide_st.received >= 0).sum()),
               stale=bool(wide_st.stale), fame_lag=bool(wide_st.fame_lag))
    if res != dict(last_round=WIDE_EXPECT["last_round"], received=WIDE_EXPECT["received"],
                   stale=False, fame_lag=False):
        raise AssertionError(f"train_step at {n} validators: {res}")
    log_fn(f"train_step and multi_train (packed) over the same trains == train_step (wide) == "
           f"the one-shot engines on rows [:e], K11p == plain after every train: {res}")
    calls, k_ms, p_ms = prun.times("train_levels/packed/grid")
    nbytes, alu, tc = prun.work["train_levels/packed/grid"]
    summary = {"train_levels/packed/grid": {"max_abs_err": 0, "ms": k_ms / calls,
                                       "plain_ms": p_ms / calls}}
    work = {"train_levels/packed/grid": (nbytes / calls, alu / ALU_OPS_S / calls)}
    log_fn(f"  train_levels/packed at {n} validators: {calls} checked calls, kernel "
           f"{k_ms / calls:.3f} ms per train, plain {p_ms / calls:.1f} ms per train")
    log_fn(f"phase 16 (b): {time.perf_counter() - t_phase:.1f} s")
    return summary, work, {"train_levels/packed/grid": p_launches["train_levels/packed/grid"]}


def cluster_walk_phase(dev, log_fn):
    """Phase 16 (e): K7 at CLUSTER_WIDE's width in both grid forms, the
    cluster form where a cluster takes 4 or 8 blocks and the L2 form: every
    chunk of the cold path's walk held torch.equal to the plain version in
    each, the largest chunk with each trap too, and timed beside its plain
    version (once) and its bound."""
    from babble_tpu_torch.tpu import _ext, doubling
    from babble_tpu_torch.tpu.grid import synthetic_grid

    t_phase = time.perf_counter()
    g = synthetic_grid(CLUSTER_WIDE["n"], CLUSTER_WIDE["e_count"], seed=CLUSTER_WIDE["seed"],
                       zipf_a=CLUSTER_WIDE["zipf_a"])
    n = g.n
    cs = doubling.stage_doubling(g, dev)
    plan = _ext.walk_chunk_plan(n, cs.l_b, form="cluster")
    if plan["k"] < 4:
        raise AssertionError(f"walk_chunk at {n} validators: a cluster of {plan['k']}, not 4 or 8")
    label = f"{n}-validator grid"
    p_ms = None
    for form in ("cluster", "l2"):
        def kern(*a, form=form):
            if a[1].device.type == "cpu":  # a rehearsal: the plain version
                return doubling._walk_chunk(*a)
            return _ext.walk_chunk(*a, form=form)

        chunks, _, _ = held_walk(f"{label} ({form} form)", g, cs, dev, kern=kern)
        big = max(chunks, key=lambda a: a[10])
        hold_walk_chunk_traps(f"{label} ({form} form)", big, log_fn, kern=kern)
        k_ms = spun_ms(lambda: kern(*big), 5)
        if p_ms is None:
            p_ms = spun_ms(lambda: doubling._walk_chunk_plain(*big), SLOW_PLAIN_REPS, warmup=0)
            (nbytes, ops_s), st = walk_chunk_work(big, cs.l_b, n)
            log_chunk_steps(label, chunks, log_fn)
        desc = _ext.walk_chunk_plan(n, cs.l_b, form=form)
        log_fn(f"walk_chunk ({form} form: k {desc['k']}, chains {desc['chains']}, depth "
               f"{desc['depth']}, {desc['smem']} bytes a block; the plan's form "
               f"{_ext.walk_chunk_plan(n, cs.l_b)['form']}) == plain on every chunk of the "
               f"{label}'s walk ({len(chunks)} chunks); largest chunk {big[10]} steps x "
               f"{big[11]} probes {k_ms:.4f} ms, plain {p_ms:.1f} ms, bound "
               f"{max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms ({steps_note(st, big[10])})")
    log_fn(f"phase 16 (e): {time.perf_counter() - t_phase:.1f} s")


def fl_width_phase(dev, log_fn):
    """Phase 16 (d): config #5's width, 1,024 validators, where the level
    walks (K5, K10, K11) take their grid walks: each held torch.equal to
    its plain version (K3 in both layouts on the frontier walk's witness
    table, on coin case tables at 1,024 and past it, K5 on the level scan, K10 and the decide on the
    append state, K11p on the trains, K14 and K15 after every train of
    frontier-live), and every entry point whose path holds one of those
    forms run on its own (run_path) against run_frontier_passes (packed):
    its launches are the counts of the kernels line. Returns (summary,
    work, launches) of those forms."""
    from babble_tpu_torch.tpu import _ext, doubling, engine, frontier, kernels
    from babble_tpu_torch.tpu import frontier_live as fl
    from babble_tpu_torch.tpu import incremental as inc
    from babble_tpu_torch.tpu.grid import synthetic_grid

    t_phase = time.perf_counter()
    g = synthetic_grid(FL_WIDTH["n"], FL_WIDTH["e_count"], seed=FL_WIDTH["seed"],
                       zipf_a=FL_WIDTH["zipf_a"], record_fd_updates=True)
    sm, n, e = g.super_majority, g.n, g.e
    log_fn(f"{n}-validator grid: {e} events, {g.num_levels} levels, hottest chain "
           f"{int(g.index.max()) + 1} events; {time.perf_counter() - t_phase:.1f} s to generate")
    # K3's setup and K12's launches, and the level walks' grid forms, take
    # the same shared memory at every width; K3's vote its ring (no staging
    # form)
    walks = {"divide_rounds": _ext.divide_rounds_form(n, n),
             "step_levels": _ext.step_levels_form(n, FL_WIDTH_BATCH, inc.L_MAX,
                                                  FL_WIDTH_BATCH, 32),
             "train_levels": _ext.train_levels_form(n, FL_WIDTH_TRAIN, 64, 32)}
    k3 = _ext.block_smem("decide_fame", n, packed=True)
    if (set(walks.values()) != {"grid"}
            or _ext.block_smem("decide_window", n) != _ext.block_smem("decide_window", 256)
            or k3["setup"] != _ext.block_smem("decide_fame", 256)["setup"]
            or max(k3.values()) > _ext.MAX_SMEM_BYTES):
        raise AssertionError(f"at {n} validators: walks {walks}, decide_window's blocks "
                             f"{_ext.block_smem('decide_window', n)}, decide_fame's {k3}")
    summary, work, launches = {}, {}, {}

    def held(what, kern, plain):
        """kern() against plain() with CUDA-event times of both calls:
        (result, kernel ms, plain ms)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        got = kern()
        ev[1].record()
        ev[2].record()
        want = plain()
        ev[3].record()
        torch.cuda.synchronize()
        require_equal(what, got, want)
        return got, ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])

    # the one-shot frontier engine, packed
    res, l_launches = run_path("run_frontier_passes (1,024), packed",
                               lambda: engine.run_frontier_passes(g, device=dev, packed=True))
    r_fame = res.witness_table.shape[0]
    st = engine.stage_frontier(g, dev)
    inv = frontier.build_inv(st.rows_by, st.la)
    k2_args = (inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, r_fame)
    fr, k_ms, p_ms = held(f"frontier_rounds at {n} validators",
                          lambda: tuple(frontier.frontier_rounds(*k2_args)),
                          lambda: tuple(frontier._frontier_rounds_plain(*k2_args, la=st.la)))
    fr = frontier.FrontierResult(*fr)
    k2_hist = frontier._frontier_history_plain(inv, st.rows_by, st.fd, sm, r_fame, la=st.la)
    summary["frontier_rounds (1,024)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    work["frontier_rounds (1,024)"] = frontier_rounds_work(inv, st, sm, k2_hist)
    launches["frontier_rounds (1,024)"] = l_launches["frontier_rounds"]
    log_fn(f"frontier_rounds == plain at {n} validators (r_cap {r_fame}, "
           f"{walk_steps([k2_hist])} working steps): {k_ms:.4f} ms, plain {p_ms:.1f} ms")
    del inv, k2_args
    fame_args = (fr.witness_table, st.la, st.fd, st.index, st.coin_bit, fr.last_round, sm, n,
                 r_fame + 2)
    for pk, key in ((True, "decide_fame/packed (1,024)"), (False, "decide_fame (1,024)")):
        fame, k_ms, p_ms = held(f"decide_fame (packed={pk}) at {n} validators",
                                lambda: tuple(kernels.decide_fame(*fame_args, packed=pk)),
                                lambda: tuple(kernels._decide_fame_plain(*fame_args, packed=pk)))
        summary[key] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
        work[key] = fame_work(fr.witness_table, n)
        log_fn(f"  {key} == plain on the {n}-validator grid's witness table (r {r_fame}): "
               f"{k_ms:.3f} ms, plain {p_ms:.1f} ms")
    launches["decide_fame/packed (1,024)"] = l_launches["decide_fame/packed"]
    # K4 on the same tables: its time, in every form, and its launches on
    # run_frontier_passes (1,024) above
    fame = kernels.FameResult(*fame)
    recv_args = (fr.witness_table, st.la, st.index, st.creator, fr.rounds, fame.decided,
                 fame.famous, fame.rounds_decided, fr.last_round)
    recv, k_ms, p_ms = held(f"round_received at {n} validators",
                            lambda: kernels.decide_round_received(*recv_args),
                            lambda: kernels._decide_round_received_plain(*recv_args))
    hold_received(f"the {n}-validator grid's tables", recv_args, log_fn)
    k_ms = spun_ms(lambda: kernels.decide_round_received(*recv_args), 20)
    summary["round_received (1,024)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    work["round_received (1,024)"] = received_work(recv_args, recv)
    launches["round_received (1,024)"] = l_launches["round_received"]
    log_fn(f"  round_received == plain on the {n}-validator grid's tables (r {r_fame}, "
           f"{int((recv >= 0).sum())} received): {k_ms:.4f} ms, plain {p_ms:.1f} ms")
    log_fn(f"run_frontier_passes (packed) at {n} validators: last_round {res.last_round}, "
           f"{int((res.received >= 0).sum())} received")
    del st, fr

    # the votes where witnesses get decided: random tables, both layouts
    case = coin_round_case(*FL_WIDTH_COIN)
    c_args = coin_fame_args(case, case["coin_bit"], dev)
    _, kw_ms, pw_ms = held(f"decide_fame on coin case {FL_WIDTH_COIN}",
                           lambda: tuple(kernels.decide_fame(*c_args)),
                           lambda: tuple(kernels._decide_fame_plain(*c_args)))
    fame, k_ms, p_ms = held(f"decide_fame/packed on coin case {FL_WIDTH_COIN}",
                            lambda: tuple(kernels.decide_fame(*c_args, packed=True)),
                            lambda: tuple(kernels._decide_fame_plain(*c_args, packed=True)))
    hold_received(f"coin case {FL_WIDTH_COIN}",
                  coin_received_args(case, kernels.FameResult(*fame), dev), log_fn)
    cst = coin_case_state(case, dev)

    def decide_plain(st, sm_, n_, r_win, e_win, pk):
        inc._decide_body_plain(st, sm_, n_, r_win, e_win, packed=pk)
        return tuple(st)

    for pk in (True, False):
        ref_st = inc.clone_state(cst)
        got_st = inc.clone_state(cst)
        r = cst.wtable.shape[0]
        _, dk_ms, dp_ms = held(
            f"decide_window{'/packed' if pk else ''} on coin case {FL_WIDTH_COIN}",
            lambda: tuple(inc._decide_body(got_st, case["super_majority"], n, r_win=r,
                                           e_win=r * n, packed=pk)),
            lambda: decide_plain(ref_st, case["super_majority"], n, r, r * n, pk))
        log_fn(f"  decide_window{'/packed' if pk else ''} == plain on the coin case's "
               f"state: {int(got_st.fame_decided.sum())} witnesses decided, "
               f"{int((got_st.received >= 0).sum())} received; {dk_ms:.3f} ms, plain "
               f"{dp_ms:.1f} ms")
    decided = int(fame[0].sum())
    if not decided or not int(got_st.fame_decided.sum()):
        raise AssertionError(f"coin case {FL_WIDTH_COIN}: no witness decided")
    log_fn(f"decide_fame == plain in both layouts on coin case {FL_WIDTH_COIN} (wide "
           f"{kw_ms:.3f} ms, plain {pw_ms:.1f} ms; {decided} witnesses "
           f"decided): {k_ms:.3f} ms, plain {p_ms:.1f} ms")
    # past 1,024 validators the vote keeps each column's words in shared
    # memory, and its ring takes the slots that fit beside them
    del cst, ref_st, got_st
    w_case = coin_round_case(*WIDE_VOTE_CASE)
    w_args = coin_fame_args(w_case, w_case["coin_bit"], dev)
    plan = _ext.fame_vote_plan(-(-WIDE_VOTE_CASE[0] // 32))
    for pk in (False, True):
        w_fame, k_ms, p_ms = held(f"decide_fame (packed={pk}) on coin case {WIDE_VOTE_CASE}",
                                  lambda: tuple(kernels.decide_fame(*w_args, packed=pk)),
                                  lambda: tuple(kernels._decide_fame_plain(*w_args,
                                                                           packed=pk)))
        log_fn(f"  decide_fame{'/packed' if pk else ''} == plain on coin case "
               f"{WIDE_VOTE_CASE} ({plan['words']} words in {plan['columns']} memory, a ring "
               f"of {plan['stages']} slots, {plan['smem']} bytes a block): {k_ms:.3f} ms, "
               f"plain {p_ms:.1f} ms; {int(w_fame[0].sum())} witnesses decided")
    if not int(w_fame[0].sum()) or plan["columns"] != "shared":
        raise AssertionError(f"coin case {WIDE_VOTE_CASE}: no witness decided, or the vote's "
                             f"words in {plan['columns']} memory")
    hold_received(f"coin case {WIDE_VOTE_CASE}",
                  coin_received_args(w_case, kernels.FameResult(*w_fame), dev), log_fn)
    del w_case, w_args

    # K5's grid walk on the level scan
    gp, _, scan_r_max = engine.scan_layout(g, True)
    ins = engine.stage_scan(gp, dev)
    dr_args = ins[:13] + (gp.super_majority, scan_r_max)
    n_lvl = ins[0].shape[1]
    dr, k_ms, p_ms = held(f"divide_rounds/grid at {n} validators",
                          lambda: tuple(kernels.divide_rounds(*dr_args)),
                          lambda: tuple(kernels._divide_rounds_plain(*dr_args)))
    res_s, s_launches = run_path("run_passes (1,024)", lambda: engine.run_passes(
        g, bucketed=True, device=dev, packed=False))
    require_same_results(f"run_passes (wide) == run_frontier_passes (packed) at {n} "
                         f"validators", res_s, res)
    launches["divide_rounds/grid"] = s_launches["divide_rounds/grid"]
    launches["decide_fame (1,024)"] = s_launches["decide_fame"]
    summary["divide_rounds/grid"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    work["divide_rounds/grid"], pairs, _ = scan_work(gp, ins, dr, scan_r_max)
    log_fn(f"divide_rounds/grid == plain at {n} validators ({g.num_levels} levels of width "
           f"{n_lvl}): {k_ms:.3f} ms, plain {p_ms:.1f} ms; {pairs} (event, witness) pairs")
    del ins, dr

    # K7 past a cluster's reach (its L2 form) on the cold path: every chunk
    # of the walk held to the plain version, the largest timed (its plain
    # version once), and run_doubling_passes run on its own
    cs = doubling.stage_doubling(g, dev)
    form = walk_chunk_form(n, cs.l_b)
    if _ext.walk_chunk_plan(n, cs.l_b)["form"] != "l2":
        raise AssertionError(f"walk_chunk at {n} validators: {form}, not the L2 form")
    chunks, _, _ = held_walk(f"{n}-validator grid", g, cs, dev)
    big = max(chunks, key=lambda a: a[10])
    hold_walk_chunk_traps(f"{n}-validator grid", big, log_fn)
    log_chunk_steps(f"{n}-validator grid", chunks, log_fn)
    k_ms = spun_ms(lambda: doubling._walk_chunk(*big), 5)
    p_ms = spun_ms(lambda: doubling._walk_chunk_plain(*big), SLOW_PLAIN_REPS, warmup=0)
    summary["walk_chunk (1,024)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    (nbytes, ops_s), st = walk_chunk_work(big, cs.l_b, n)
    work["walk_chunk (1,024)"] = (nbytes, ops_s)
    del cs, chunks
    res_d, d_launches = run_path("run_doubling_passes (1,024), packed",
                                 lambda: doubling.run_doubling_passes(g, device=dev, packed=True))
    require_same_results(f"run_doubling_passes == run_frontier_passes at {n} validators",
                         res_d, res)
    launches["walk_chunk (1,024)"] = d_launches["walk_chunk"]
    log_fn(f"walk_chunk == plain on every chunk of the {n}-validator grid's walk ({form}); "
           f"largest chunk {big[10]} steps x {big[11]} probes {k_ms:.4f} ms, plain "
           f"{p_ms:.1f} ms, bound {max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms "
           f"({steps_note(st, big[10])}); run_doubling_passes (packed) == run_frontier_passes")
    del big, res_d

    # K10 and the decide (K12, both layouts) on the append state
    r_cap = max(32, least_pow2(res.last_round + 3))
    cfg = dict(batch=FL_WIDTH_BATCH, e_cap=e, r_cap=r_cap, r_win=r_cap)
    upd_cap = e
    while True:
        try:
            batches = inc.batches_from_grid(g, cfg["batch"], upd_cap, e)
            break
        except ValueError:  # a burst above the cap
            upd_cap *= 2
    batches_d = [inc.device_put(b, dev) for b in batches]
    srun = drive_paired(f"{n}-validator step state", g, cfg, e, batches_d, dev, 1,
                        FL_WIDTH_CHECK_EVERY, log_fn)
    for name, key in (("step_levels/packed/grid", "step_levels/packed/grid (1,024)"),
                      ("decide_window/packed", "decide_window/packed (1,024)"),
                      ("decide_window", "decide_window (1,024)")):
        calls, k_ms, p_ms = srun.times(name)
        nbytes, alu, tc = srun.work[name]
        summary[key] = {"max_abs_err": 0, "ms": k_ms / calls, "plain_ms": p_ms / calls}
        work[key] = (nbytes / calls, (alu / ALU_OPS_S + tc / INT8_TC_OPS_S) / calls)
    del srun

    def inc_path(label, drive):
        """A fresh state driven through an entry point on its own; its rows
        equal the one-shot engines'. Returns the path's launches."""
        st = inc.init_state(n, e, r_cap, device=dev)
        _, got = run_path(label, lambda: drive(st))
        for f in ("rounds", "lamport", "witness", "received"):
            if not (getattr(st, f)[:e].cpu().numpy() == getattr(res, f)).all():
                raise AssertionError(f"{label}: {f} differs from run_frontier_passes")
        if bool(st.stale) or bool(st.fame_lag):
            raise AssertionError(f"{label}: stale {bool(st.stale)}, fame_lag {bool(st.fame_lag)}")
        return got

    empty = inc.device_put(inc.empty_batch(n, cfg["batch"], upd_cap, e), dev)
    groups = []
    for i in range(0, len(batches_d), MULTI_STEP_K):
        group = batches_d[i : i + MULTI_STEP_K]
        group = group + [empty] * (MULTI_STEP_K - len(group))
        groups.append(inc.Batch(*[torch.stack(f) for f in zip(*group)]))
    got = inc_path("step (1,024), packed", lambda st: [
        inc.step(st, b, sm, n, r_win=r_cap, e_win=e, packed=True) for b in batches_d])
    launches["step_levels/packed/grid (1,024)"] = got["step_levels/packed/grid"]
    launches["decide_window/packed (1,024)"] = got["decide_window/packed"]
    got = inc_path("multi_step (1,024)", lambda st: [
        inc.multi_step(st, gr, sm, n, r_win=r_cap, e_win=e, packed=False) for gr in groups])
    launches["decide_window (1,024)"] = got["decide_window"]
    log_fn(f"step (packed) over the {n}-validator grid's {len(batches_d)} batches and "
           f"multi_step (wide) over groups of {MULTI_STEP_K} == run_frontier_passes on rows "
           f"[:e], no latch")
    del batches_d, groups

    # K11p's grid walk on the trains
    trains = inc.trains_from_grid(g, FL_WIDTH_TRAIN, 1 << 24, e, t_cap=832)
    trains_d = [inc.device_put(t, dev) for t in trains]
    trun = PairedRun(f"{n}-validator train state", inc.init_state(n, e, r_cap, device=dev))
    for t in trains_d:
        trun.call("apply_deltas", lambda st: inc._apply_deltas_and_stage(st, t), None,
                  check=False)
        trun.call("train_levels/packed/grid",
                  lambda st: inc._train_levels(st, t, sm, packed=True),
                  lambda st: inc._train_levels_plain(st, t, sm, packed=True),
                  lambda st: inc_work_levels(st, t, False))
        trun.call("decide_window/packed",
                  lambda st: inc._decide_body(st, sm, n, r_win=r_cap, e_win=e, packed=True),
                  None, check=False)
    got = inc_path("train_step (1,024), packed", lambda st: [
        inc.train_step(st, t, sm, n, r_win=r_cap, e_win=e, packed=True) for t in trains_d])
    launches["train_levels/packed/grid (1,024)"] = got["train_levels/packed/grid"]
    calls, k_ms, p_ms = trun.times("train_levels/packed/grid")
    nbytes, alu, tc = trun.work["train_levels/packed/grid"]
    summary["train_levels/packed/grid (1,024)"] = {"max_abs_err": 0, "ms": k_ms / calls,
                                                  "plain_ms": p_ms / calls}
    work["train_levels/packed/grid (1,024)"] = (nbytes / calls, alu / ALU_OPS_S / calls)
    log_fn(f"apply_deltas, train_levels/packed/grid (== plain after every train) and the packed "
           f"decide over the {n}-validator grid's {len(trains)} trains: kernel "
           f"{k_ms / calls:.3f} ms per train, plain {p_ms / calls:.1f} ms per train; last_round "
           f"{int(trun.k.last_round)}, stale {bool(trun.k.stale)}")

    # frontier-live (packed) end to end
    l_cap = least_pow2(int(g.index.max()) + 1 + 32)
    f_r_cap = max(fl.R_WIN, r_cap)
    paired = FlPaired(fl.init_frontier_state(n, e, l_cap, f_r_cap, device=dev), sm, n, True)
    for k, t in enumerate(trains_d):
        paired.train(t, f"{n}-validator grid's train {k}")
    fst = fl.init_frontier_state(n, e, l_cap, f_r_cap, device=dev)
    t0 = time.perf_counter()
    _, f_launches = run_path("frontier_train_step (1,024), packed", lambda: [
        fl.frontier_train_step(fst, t, sm, n, packed=True) for t in trains_d])
    secs = time.perf_counter() - t0
    bad = fr_diff(fst, paired.st)
    if bad:
        raise AssertionError(f"frontier-live at {n} validators: {bad} differ between the path "
                             f"and the paired run")
    require_rows(f"frontier-live at {n} validators", fst, res, e)
    if any(latches(fst).values()):
        raise AssertionError(f"frontier-live at {n} validators: latched {latches(fst)}")
    times = {k: paired.summary(k)[1:3] for k in ("frontier_append", "frontier_window")}
    calls, k_ms, p_ms, (nbytes, ops_s) = paired.summary("frontier_window")
    summary["frontier_window (1,024)"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    work["frontier_window (1,024)"] = (nbytes, ops_s)
    launches["frontier_window (1,024)"] = f_launches["frontier_window"]
    log_fn(f"  frontier_window at {n} validators: {calls} checked calls, kernel {k_ms:.4f} ms "
           f"per call, plain {p_ms:.1f} ms, bound "
           f"{max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms "
           f"({'bytes' if nbytes / HBM_BYTES_S >= ops_s else 'operations'})")
    log_fn(f"frontier_train_step (packed) over the {n}-validator grid's {len(trains)} trains "
           f"(l_cap {l_cap}) == run_frontier_passes (packed) on rows [:e], no latch, K14, K15 "
           f"and the decide == plain after every train (kernel, plain ms per train: "
           f"{ {k: (round(a, 3), round(b, 1)) for k, (a, b) in times.items()} }): "
           f"{secs:.2f} s (first run)")
    log_fn(f"phase 16 (d): {time.perf_counter() - t_phase:.1f} s")
    return summary, work, launches


def walk_rows_work(b, n_p, ok):
    """(bytes, seconds at the ALU rate) of one position's shard_walk/rows
    step: X and the chain-table entries, the ok frontier rows' fd rows in,
    the (B, N_p) rows and w_ok out."""
    return b * 8 + ok * n_p * 4 + b * n_p * 4 + b, 0.0


def walk_m0_work(inv, n_w, ok):
    """One position's shard_walk/m0 step over n_w gathered frontier rows, ok
    of them live: the rows and w_ok in, one INV value per (chain, live row,
    coordinate) probed (at most the slice), m0 out."""
    b, n_p, _ = inv.shape
    probes = b * ok * n_p
    return (n_w * n_p * 4 + n_w + min(inv.numel() * 4, probes * 4) + b * 4,
            2 * probes / ALU_OPS_S)


def walk_close_work(b, n_p, live):
    """One position's shard_walk/close step: one INV value per (chain,
    coordinate whose m0 is live), the coordinates' m0, X in and out."""
    return b * live * 4 + n_p * 4 + b * 12, b * n_p * 2 / ALU_OPS_S


def walk_steps(hist, n_steps=None):
    """Steps the one-launch walk computes on a history (a list of (rows, B)
    tensors, row r the frontier X(r)): up to and including the first step
    that moves no chain, else n_steps (default rows - 1, the last row's)."""
    rows = hist[0].shape[0]
    for r in range(rows - 1):
        if all(torch.equal(h[r + 1], h[r]) for h in hist):
            return r + 1
    return rows - 1 if n_steps is None else n_steps


def walk_work(mesh, axis, super_majority, l, inv_parts, rb_parts, fd_parts, la_parts, hist):
    """(bytes, seconds at the ALU rate) of the one-launch walk over its
    working steps (walk_steps), each input read once and each output
    written once: X(0) in and every history row out; each chain-table entry
    a working step's frontier takes; the fd row of every event that is ever
    a live frontier row; for every chain, the INV values at each
    (coordinate, index) any step probes (the live rows' fd values in phase
    A, the coordinates' live m0 in the closure). Operations: phase A's
    selection (two per probe) and the closure. m0 from the plain pieces on
    the history's X(r)."""
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.frontier import M0_BINSEARCH_MIN_N
    from babble_tpu_torch.tpu.grid import MAX_INT32
    from babble_tpu_torch.tpu.mesh import all_gather

    b, n_p, _ = inv_parts[0].shape
    n_w = b * mesh.size
    r_cap = hist[0].shape[0]
    use_binsearch = n_w >= M0_BINSEARCH_MIN_N
    fd = fd_parts[0]
    probed = torch.zeros((n_p, l), dtype=torch.bool, device=fd.device)
    events = torch.zeros(fd.shape[0], dtype=torch.bool, device=fd.device)
    coords = torch.arange(n_p, device=fd.device)
    entries, probes = 0, 0
    steps = walk_steps(hist)
    for r in range(steps):
        rows = [sh._walk_rows_plain(rb_parts[p], fd_parts[p], hist[p][r])
                for p in range(mesh.size)]
        fd_w = all_gather([x[0] for x in rows], mesh, axis)
        w_ok = all_gather([x[1] for x in rows], mesh, axis)
        m0 = all_gather([sh._walk_m0_plain(inv_parts[p], fd_w[p], w_ok[p], rb_parts[p],
                                           la_parts[p], super_majority, l, use_binsearch)
                         for p in range(mesh.size)], mesh, axis)[0]
        for p in range(mesh.size):
            x = hist[p][r]
            live = x < l
            if r:
                live &= x != hist[p][r - 1]
            c = live.nonzero().squeeze(1)
            entries += c.numel()
            events[rb_parts[p][c, x[c].long()].clamp(min=0).long()] = True
        vals = fd_w[0][w_ok[0]]
        ok = vals < MAX_INT32
        probed[coords.expand_as(vals)[ok], vals[ok].clamp(0, l - 1).long()] = True
        cm = m0[:n_p] < l
        probed[coords[cm], m0[:n_p][cm].long()] = True
        probes += n_w * vals.shape[0] * n_p
    nbytes = (n_w * 4 + r_cap * n_w * 4 + entries * 4 + int(events.sum()) * n_p * 4
              + n_w * int(probed.sum()) * 4)
    return nbytes, (2 * probes + steps * n_w * n_p * 2) / ALU_OPS_S


def frontier_rounds_work(inv, st, super_majority, hist):
    """(bytes, seconds at the ALU rate) K2 needs on staged inputs st (its
    INV inv) from the plain walk's history hist (r_cap, N): the walk's
    working steps as walk_work counts them at one position, then the post
    pass: each event's creator, index and sp_index in, its round and
    witness flag out (a compare per history row up to the fixed point),
    the witness table and last_round out."""
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    r_cap, n = hist.shape
    l = st.rows_by.shape[1]
    e = st.creator.shape[0]
    one = DeviceMesh.on(inv.device, (1,), ("rounds",))
    nbytes, ops_s = walk_work(one, "rounds", super_majority, l, [inv], [st.rows_by], [st.fd],
                              [st.la], [hist])
    return (nbytes + e * 12 + e * 5 + r_cap * n * 4 + 4,
            ops_s + 2 * e * (walk_steps([hist]) + 1) / ALU_OPS_S)


class MeshCheck:
    """Every mesh kernel wrapper of tpu/sharded.py patched, while the
    context is open, to launch its kernel and run its plain version on the
    same inputs (in-place kernels against clones), torch.equal after every
    launch, with CUDA-event times behind a spin and the work each call's
    data needs, by cell (`self.cell`) and kernel name (the packed layout's
    launches under "<name>/packed")."""

    NAMES = ("shard_tally", "shard_decide", "shard_active", "fame_grid", "fame_tables",
             "local_received", "fame_received", "build_inv", "walk_rows", "walk_m0",
             "walk_close", "walk_grid", "post", "fame_setup")

    def __init__(self, log_fn):
        self.log = log_fn
        self.cell = None
        self.events, self.work, self.calls, self.steps = {}, {}, {}, {}

    def __enter__(self):
        from babble_tpu_torch.tpu import sharded as sh

        self.sh = sh
        self.real = {k: getattr(sh, k) for k in self.NAMES}
        for k in self.NAMES:
            setattr(sh, k, getattr(self, "_" + k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.sh, k, fn)

    def _timed(self, name, kern, plain, work, spin=SPIN_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(spin)
        ev[0].record()
        got = kern()
        ev[1].record()
        ev[2].record()
        want = plain()
        ev[3].record()
        key = (self.cell, name)
        calls = self.events.setdefault(key, [])
        require_equal(f"{name} on the {self.cell}, call {len(calls)}", got, want)
        calls.append(ev)
        nbytes, secs = work(got)
        acc = self.work.setdefault(key, [0, 0.0])
        acc[0] += nbytes
        acc[1] += secs
        return got

    def summary(self, cell, name):
        """(calls, kernel ms per call, plain ms per call, (bytes, seconds at
        the peak rates) per call)."""
        torch.cuda.synchronize()
        evs = self.events[(cell, name)]
        calls = len(evs)
        nbytes, secs = self.work[(cell, name)]
        return (calls, sum(e[0].elapsed_time(e[1]) for e in evs) / calls,
                sum(e[2].elapsed_time(e[3]) for e in evs) / calls,
                (nbytes / calls, secs / calls))

    def names(self, cell):
        return sorted(n for c, n in self.events if c == cell)

    # the wrappers

    def _shard_tally(self, ss_s, votes, i_rows, last_round, d, packed):
        sh = self.sh
        b, ny, nw = ss_s.shape
        nx = votes.shape[1] if packed else votes.shape[2]

        def work(_):
            b_ok = int(((i_rows + d) <= last_round).sum().item())
            es = 4 if packed else 1
            nbytes = (b_ok * (ny * nw + nw * nx) * es + b * ny * (nx + 1) * 4 + b * 4 + 4)
            if packed:  # AND + popcount + add per word pair
                return nbytes, b_ok * ny * nx * nw * 3 / ALU_OPS_S
            return nbytes, 2 * b_ok * ny * nx * nw / INT8_TC_OPS_S

        return self._timed(
            "shard_fame/tally" + ("/packed" if packed else ""),
            lambda: self.real["shard_tally"](ss_s, votes, i_rows, last_round, d, packed),
            lambda: sh._shard_tally_plain(ss_s, votes, i_rows, last_round, d, packed), work)

    def _shard_decide(self, yays, total, i_rows, last_round, wvalid, decided, famous, wv_s,
                      coin_s, votes, v_off, d, n_participants, super_majority, packed):
        sh = self.sh
        dc, fc, vc = decided.clone(), famous.clone(), votes.clone()
        b, ny, nx = yays.shape
        v_bytes = votes.numel() * votes.element_size()

        def kern():
            self.real["shard_decide"](yays, total, i_rows, last_round, wvalid, decided, famous,
                                      wv_s, coin_s, votes, v_off, d, n_participants,
                                      super_majority, packed)
            return decided, famous, votes

        def plain():
            sh._shard_decide_plain(yays, total, i_rows, last_round, wvalid, dc, fc, wv_s,
                                   coin_s, vc, v_off, d, n_participants, super_majority, packed)
            return dc, fc, vc

        return self._timed(
            "shard_fame/decide" + ("/packed" if packed else ""), kern, plain,
            lambda _: (b * ny * (nx + 1) * 4 + b * nx * 5 + b * ny * 2 + v_bytes + b * 4 + 4,
                       b * ny * nx * 6 / ALU_OPS_S))

    def _fame_grid(self, mesh, axis, v_axis, chunk, n_participants, super_majority, d_bound,
                   packed, last_round, i_rows, wvalid, votes, decided, famous, ss_s, wv_s,
                   coin_s):
        """B21 in one launch against the plain step-by-step loop on clones of
        every table the loop writes: decided and famous of every position."""
        sh = self.sh
        mut = [[t.clone() for t in parts] for parts in (votes, decided, famous, ss_s, wv_s,
                                                         coin_s)]

        def kern():
            self.real["fame_grid"](mesh, axis, v_axis, chunk, n_participants, super_majority,
                                   d_bound, packed, last_round, i_rows, wvalid, votes, decided,
                                   famous, ss_s, wv_s, coin_s)
            return tuple(decided) + tuple(famous)

        def plain():
            v, dc, fc, ss, wv, cn = mut
            sh._step_fame(mesh, axis, v_axis, chunk, n_participants, super_majority, d_bound,
                          packed, last_round, i_rows, wvalid, v, dc, fc, ss, wv, cn, plain=True)
            return tuple(dc) + tuple(fc)

        def work(_):
            ops = sh.grid_operands(mesh, axis, v_axis, ss_s, votes, wv_s, coin_s, wvalid)
            ss_o, votes_o, wv_o, coin_o, wvalid_o, n_v = ops
            row = (sum(t[0].numel() * t.element_size() for t in ss_o[:n_v] + votes_o[:n_v])
                   + sum(t[0].numel() * t.element_size() for t in (wv_o[0], coin_o[0],
                                                                    wvalid_o[0])))
            r_pad = len(ss_o) // n_v * ss_o[0].shape[0]
            return shard_fame_work(row, r_pad, wvalid_o[0].shape[1], ss_o[0].shape[1],
                                   int(last_round[0]), n_v)

        # the launcher's host work (the address table's pinned copy, the
        # shards' checks, the scratch) takes longer than SPIN_CYCLES: spin
        # long enough that the events time the device work alone
        self._timed("shard_fame/grid" + ("/packed" if packed else ""), kern, plain, work,
                    spin=GRID_SPIN_CYCLES)

    def _shard_active(self, wvalid, decided, i_rows, last_round, d0):
        b, nx = wvalid.shape
        return self._timed(
            "shard_fame/active",
            lambda: self.real["shard_active"](wvalid, decided, i_rows, last_round, d0),
            lambda: self.sh._shard_active_plain(wvalid, decided, i_rows, last_round, d0),
            lambda _: (b * nx * 2 + b * 4 + 8, b * nx * 3 / ALU_OPS_S))

    def _fame_tables(self, wtable, la, decided, famous, last_round):
        r, n = wtable.shape

        def work(_):
            n_famous = int((decided & famous & (wtable >= 0)).sum().item())
            return (r * n * 4 + n_famous * n * 4 + r * n * 2 + 4 + r * n * 4 + r * 10,
                    (n_famous * n + r * n) / ALU_OPS_S)

        return self._timed(
            "fame_tables",
            lambda: tuple(self.real["fame_tables"](wtable, la, decided, famous, last_round)),
            lambda: tuple(self.sh._fame_tables_plain(wtable, la, decided, famous, last_round)),
            work)

    def _local_received(self, index, creator, rounds, min_la, famous_count, i_ok, horizon):
        from babble_tpu_torch.tpu.kernels import received_search

        e = index.shape[0]
        r, n = min_la.shape

        def work(recv):
            # the rounds each event's scan passes: round(e) + 1 to its
            # reception, or to its horizon when nothing is received
            start = (rounds + 1).clamp(0, r - 1).long()
            stop = torch.where(recv >= 0, recv, horizon[start].clamp(max=r) - 1)
            scans = int((stop - rounds).clamp(min=0).sum().item())
            return (e * 16 + r * n * 4 + r * 9, scans / ALU_OPS_S)

        return self._timed(
            "received_search",
            lambda: self.real["local_received"](index, creator, rounds, min_la, famous_count,
                                                i_ok, horizon),
            lambda: received_search(index, creator, rounds, min_la, famous_count, i_ok,
                                    horizon), work)

    def _fame_received(self, wtable, la, decided, famous, last_round, index, creator, rounds):
        from babble_tpu_torch.tpu.kernels import received_search

        sh = self.sh
        r, n = wtable.shape
        e = index.shape[0]

        def plain():
            tables = sh._fame_tables_plain(wtable, la, decided, famous, last_round)
            return tables, received_search(index, creator, rounds, *tables[:4])

        def work(got):
            # B23's tables, then each event's scan as B22's
            tables, recv = got
            n_famous = int((decided & famous & (wtable >= 0)).sum().item())
            start = (rounds + 1).clamp(0, r - 1).long()
            stop = torch.where(recv >= 0, recv, tables[3][start].clamp(max=r) - 1)
            scans = int((stop - rounds).clamp(min=0).sum().item())
            return (r * n * 4 + n_famous * n * 4 + r * n * 2 + 4 + r * n * 4 + r * 10
                    + e * 16, (n_famous * n + r * n + scans) / ALU_OPS_S)

        def kern():
            tables, recv = self.real["fame_received"](wtable, la, decided, famous, last_round,
                                                      index, creator, rounds)
            return tuple(tables), recv

        return self._timed("fame_received", kern, plain, work)

    def _build_inv(self, rows_by, la):
        from babble_tpu_torch.tpu.frontier import _build_inv_plain

        return self._timed("build_inv", lambda: self.real["build_inv"](rows_by, la),
                           lambda: _build_inv_plain(rows_by, la),
                           lambda got: build_inv_work(rows_by, la, got))

    def _walk_rows(self, rows_by, fd, x_cur):
        b, l = rows_by.shape
        n_p = fd.shape[1]

        def work(got):
            return walk_rows_work(b, n_p, int(got[1].sum().item()))

        return self._timed(
            "shard_walk/rows", lambda: tuple(self.real["walk_rows"](rows_by, fd, x_cur)),
            lambda: tuple(self.sh._walk_rows_plain(rows_by, fd, x_cur)), work)

    def _walk_m0(self, inv, fd_w, w_ok, rows_by, la, super_majority, l, use_binsearch):
        def work(_):
            return walk_m0_work(inv, fd_w.shape[0], int(w_ok.sum().item()))

        return self._timed(
            "shard_walk/m0",
            lambda: self.real["walk_m0"](inv, fd_w, w_ok, rows_by, la, super_majority, l,
                                         use_binsearch),
            lambda: self.sh._walk_m0_plain(inv, fd_w, w_ok, rows_by, la, super_majority, l,
                                           use_binsearch), work)

    def _walk_close(self, inv, m0_all, c_off, x_cur, x_next):
        b, n_p, l = inv.shape
        want = x_next.clone()

        def kern():
            self.real["walk_close"](inv, m0_all, c_off, x_cur, x_next)
            return x_next

        def plain():
            want.copy_(self.sh._walk_close_plain(inv, m0_all, m0_all[c_off: c_off + b], x_cur,
                                                 n_p, l))
            return want

        def work(_):
            return walk_close_work(b, n_p, int((m0_all[:n_p] < l).sum().item()))

        return self._timed("shard_walk/close", kern, plain, work)

    def _walk_grid(self, mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts,
                   la_parts, x0_parts):
        args = (mesh, axis, super_majority, r_cap, l, inv_parts, rb_parts, fd_parts, la_parts,
                x0_parts)

        def work(got):
            return walk_work(mesh, axis, super_majority, l, inv_parts, rb_parts, fd_parts,
                             la_parts, list(got))

        got = self._timed("shard_walk/grid", lambda: tuple(self.real["walk_grid"](*args)),
                          lambda: tuple(self.sh._local_walk_plain(*args)), work)
        self.steps.setdefault((self.cell, "shard_walk/grid"), []).append(
            (walk_steps(list(got)), r_cap))
        return list(got)

    def _post(self, x_hist, rows_by, creator, index, sp_index):
        from babble_tpu_torch.tpu.frontier import frontier_post

        r_cap, n = x_hist.shape
        e = creator.shape[0]
        return self._timed(
            "frontier_post",
            lambda: tuple(self.real["post"](x_hist, rows_by, creator, index, sp_index)),
            lambda: tuple(frontier_post(x_hist, rows_by, creator, index, sp_index)),
            lambda _: (3 * r_cap * n * 4 + e * 12 + e * 5 + 4, e * r_cap * 2 / ALU_OPS_S))

    def _fame_setup(self, wtable, la, fd, index, coin_bit, super_majority, packed):
        from babble_tpu_torch.tpu import _ext

        r, n = wtable.shape
        name = "fame_setup" + ("/packed" if packed else "")

        def plain():
            ss, votes0 = self.sh._fame_setup_plain(wtable, la, fd, index, super_majority,
                                                   packed)
            return ss, votes0, wtable >= 0, coin_bit[wtable.clamp(0, coin_bit.shape[0] - 1)
                                                     .long()]

        def work(got):
            wv = wtable >= 0
            n_wit = int(wv.sum().item())
            n_pairs = int((wv[1:].sum(dim=1) * wv[:-1].sum(dim=1)).sum().item())
            out = sum(t.numel() * t.element_size() for t in got[:2])
            return (r * n * 4 + n_wit * (2 * n * 4 + 4) + out,
                    (n_pairs * (n + 1) + r * n * n) / ALU_OPS_S)

        return self._timed(
            name, lambda: tuple(self.real["fame_setup"](wtable, la, fd, index, coin_bit,
                                                        super_majority, packed)),
            plain, work)


# B24's per-step launch keys (the form for positions on distinct cards)
STEP_WALK_KEYS = ("shard_walk/rows", "shard_walk/m0", "shard_walk/close")


def require_one_walk_launch(what, launches):
    """Fail unless a sharded_frontier_passes call on the one card walked in
    exactly one launch of the one-launch walk and none of the per-step
    kernels."""
    step = {k: launches[k] for k in STEP_WALK_KEYS if launches[k]}
    if launches["shard_walk/grid"] != 1 or step:
        raise AssertionError(f"{what}: shard_walk/grid x{launches['shard_walk/grid']}, "
                             f"per-step {step}; expected one launch of the one-launch walk")


# B21's per-step launch keys (the form for positions on distinct cards)
STEP_FAME_KEYS = ("shard_fame/tally", "shard_fame/decide", "shard_fame/active",
                  "shard_fame/tally/packed", "shard_fame/decide/packed")


def require_one_fame_launch(what, launches):
    """Fail unless a sharded engine's call on the one card ran its fame loop
    in exactly one launch of shard_fame/grid (either layout) and launched
    none of B21's per-step kernels."""
    step = {k: launches[k] for k in STEP_FAME_KEYS if launches[k]}
    one = launches["shard_fame/grid"] + launches["shard_fame/grid/packed"]
    if one != 1 or step:
        raise AssertionError(f"{what}: shard_fame/grid x{one}, per-step {step}; expected one "
                             f"launch of the one-launch fame loop")


def require_one_card(what, path, launches):
    """Fail unless a sharded engine's call on the one card ran pass 3 as
    one fame_received launch, with no fame_tables or received_search
    launch, and a sharded_frontier_passes call built INV in one build_inv
    launch (the per-position forms: one a position)."""
    per_pos = {k: launches[k] for k in ("fame_tables", "received_search") if launches[k]}
    if launches["fame_received"] != 1 or per_pos:
        raise AssertionError(f"{what}: fame_received x{launches['fame_received']}, "
                             f"per-position {per_pos}; expected one fame_received launch")
    if path.startswith("sharded_frontier_passes") and launches["build_inv"] != 1:
        raise AssertionError(f"{what}: build_inv x{launches['build_inv']}, expected one launch "
                             f"over every position's chains")


def fame_input(g, ref, dev):
    """(wtable (numpy), la, fd, index, last_round) of grid g as the mesh's
    fame input takes them: the witness table of the one-shot engine's
    results `ref`, the grid's tables on the card."""
    from babble_tpu_torch.tpu.device import to_device

    return (np.asarray(ref.witness_table, dtype=np.int32),
            to_device(g.last_ancestors, dev), to_device(g.first_descendants, dev),
            to_device(g.index, dev),
            torch.tensor(ref.last_round, dtype=torch.int32, device=dev))


def hold_step_fame(checks, mesh, stage, last_round, n, super_majority, packed, want, log_fn):
    """B21's per-step kernels, named explicitly, on a staged fame input:
    each launch against its plain version (checks is open), decided and
    famous against the one-launch loop's `want`."""
    from babble_tpu_torch.tpu import sharded as sh

    step = sh.sharded_fame(mesh, stage, last_round, 8, n, super_majority, packed, form="step")
    require_equal(f"{checks.cell}: the per-step loop against the one-launch loop", step,
                  tuple(want))
    log_fn(f"  {checks.cell}, sharded_fame(form='step'): "
           f"{len(checks.events[(checks.cell, 'shard_fame/active')])} active reads, each B21 "
           f"launch == plain; decided and famous == the one-launch loop's "
           f"({int(want[0].sum())} decided)")


def walk_note(checks, cell):
    """The steps each checked one-launch walk of a cell computed, beside
    r_cap, for its log line."""
    steps = checks.steps.get((cell, "shard_walk/grid"))
    if not steps:
        return ""
    return "; one-launch walk " + ", ".join(f"{s} of r_cap {r} steps" for s, r in steps)


def same_as(label, got, want, tables="overlap"):
    """PassResults equality: rounds, witness, lamport, received and
    last_round in full; fame tables on their overlap (the mesh's round
    axis is the walk's r_cap, the one-shot engine's adaptive), famous where
    decided."""
    for f in ("rounds", "witness", "lamport", "received"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if g.shape != w.shape or not (g == w).all():
            raise AssertionError(f"{label}: {f} differs from the one-shot engine")
    if got.last_round != want.last_round:
        raise AssertionError(f"{label}: last_round {got.last_round} != {want.last_round}")
    r = min(got.fame_decided.shape[0], want.fame_decided.shape[0])
    gd, wd = got.fame_decided[:r], want.fame_decided[:r]
    if not (gd == wd).all() or not ((got.famous[:r] & gd) == (want.famous[:r] & wd)).all():
        raise AssertionError(f"{label}: the fame tables differ on their overlap")


def mesh_phase(wide, wide_ref, bench, hg_kept, dev, log_fn):
    """Phase 17, the device mesh on the one card: (a) every mesh kernel
    against its plain version after every launch (MeshCheck) on config #4
    (1-D 8 and 2-D (2, 4), both layouts), the coin tables, and the width
    cell's walk in the binary-search form; (b) the three sharded engines on
    config #4 on both meshes and layouts, equal to phase 14's one-shot
    engines, with their launches and walls; (c) the hashgraph seam on
    phase 15's signed events:
    run_consensus_device with a 2-D mesh, and run_consensus_mesh_queued in
    syncs, blocks byte-identical to the host engine. B21 and B24 run as one
    launch each, and their per-step forms where named. Returns (summary,
    work, launches) of the mesh kernels."""
    from types import SimpleNamespace

    from babble_tpu_torch import hashgraph as hgm
    from babble_tpu_torch.tpu import _ext, engine
    from babble_tpu_torch.tpu import sharded as sh
    from babble_tpu_torch.tpu.device import to_device
    from babble_tpu_torch.tpu.dispatch import run_consensus_mesh_queued
    from babble_tpu_torch.tpu.grid import GridUnsupported, synthetic_grid
    from babble_tpu_torch.tpu.mesh import DeviceMesh

    t_phase = time.perf_counter()
    log_fn(f"mesh: every position on {torch.cuda.get_device_name(0)} "
           f"(torch.cuda.device_count() {torch.cuda.device_count()}); no number here "
           f"measures an interconnect")
    m1 = DeviceMesh.on(dev, *MESH_1D)
    m2 = DeviceMesh.on(dev, *MESH_2D)
    meshes = {"1-D 8": m1, "2-D (2, 4)": m2}
    engines = {
        "sharded_frontier_passes": lambda m, g, **kw: sh.sharded_frontier_passes(m, g, **kw),
        "sharded_run_passes": lambda m, g, **kw: sh.sharded_run_passes(m, g, **kw),
        "sharded_doubling_passes": lambda m, g, **kw: sh.sharded_doubling_passes(m, g, **kw),
    }
    checks = MeshCheck(log_fn)

    # (a) the kernels, each against its plain version after every launch;
    # one unchecked run of each layout first keeps the kernels' first
    # launches (their modules' loading) out of the checked calls' times
    t0 = time.perf_counter()
    sh.sharded_frontier_passes(m1, wide, packed=True)
    sh.sharded_run_passes(m1, wide, packed=False)
    with checks:
        for cell, fn in (
            ("config #4 frontier, 1-D 8, packed",
             lambda: sh.sharded_frontier_passes(m1, wide, packed=True)),
            ("config #4 frontier, 2-D (2, 4), packed",
             lambda: sh.sharded_frontier_passes(m2, wide, packed=True)),
            ("config #4 level scan, 1-D 8, wide",
             lambda: sh.sharded_run_passes(m1, wide, packed=False)),
            ("config #4 level scan, 2-D (2, 4), packed",
             lambda: sh.sharded_run_passes(m2, wide, packed=True)),
            ("config #4 level scan, 2-D (2, 4), wide",
             lambda: sh.sharded_run_passes(m2, wide, packed=False)),
        ):
            checks.cell = cell
            res = fn()
            same_as(cell, res, wide_ref)
            log_fn(f"  {cell}: every mesh kernel == plain after each launch, results == "
                   f"phase 14's; checked {checks.names(cell)}{walk_note(checks, cell)}")
        # B21's per-step kernels, named explicitly, on config #4's fame input
        # on both meshes and in both layouts: each launch against its plain
        # version, decided and famous against the one-launch loop's
        fame_in = fame_input(wide, wide_ref, dev)
        for mname, m in meshes.items():
            for pk in (True, False):
                checks.cell = f"config #4, {mname}, {'packed' if pk else 'wide'}, per-step form"
                stage = sh.stage_fame(m, wide, *fame_in[:4], pk)
                one = sh.sharded_fame(m, stage, fame_in[4], 8, wide.n, wide.super_majority, pk)
                hold_step_fame(checks, m, stage, fame_in[4], wide.n, wide.super_majority, pk,
                               one, log_fn)
        # the per-step kernels, named explicitly, on config #4's 1-D walk:
        # each launch against its plain version, the history against the
        # one-launch walk's
        checks.cell = "config #4 frontier, 1-D 8, packed"
        walk_stage = sh.stage_walk(m1, wide)
        step_hist = walk_stage.walk(m1, form="step")
        grid_hist = walk_stage.walk(m1)
        require_equal("the per-step walk against the one-launch walk, config #4, 1-D 8",
                      tuple(step_hist), tuple(grid_hist))
        log_fn(f"  {checks.cell}, local_walk(form='step'): "
               f"{len(checks.events[(checks.cell, 'shard_walk/m0')])} m0 launches, each == "
               f"plain; its history == the one-launch walk's")
        # K1 and pass 3 per position, named explicitly (the form of
        # positions on distinct cards): each launch against its plain
        # version, INV against the one launch's, the tables and received
        # against fame_received's
        checks.cell = MESH_POSITION_CELL
        require_equal("the per-position K1 against the one launch, config #4, 1-D 8",
                      tuple(sh.sharded_build_inv(m1, walk_stage.rb_parts, walk_stage.la_parts,
                                                 form="step")),
                      tuple(walk_stage.inv_parts))
        r_stage = sh.stage_fame(m1, wide, *fame_in[:4], True)
        recv_fame = (r_stage.wtable, fame_in[1], *sh.sharded_fame(
            m1, r_stage, fame_in[4], 8, wide.n, wide.super_majority, True), fame_in[4])
        pass3 = {f: sh.sharded_received(m1, wide.index, wide.creator, wide_ref.rounds, recv_fame,
                                        form=f) for f in ("grid", "step")}
        require_equal("the per-position pass 3 against fame_received, config #4, 1-D 8",
                      pass3["step"], pass3["grid"])
        log_fn(f"  {checks.cell}: sharded_build_inv(form='step') x{m1.size} and "
               f"sharded_received(form='step') (fame_tables, received_search x{m1.size}), "
               f"each == plain; == the one-launch forms "
               f"({int((pass3['grid'][1] >= 0).sum())} received)")
        b_ref = engine.run_frontier_passes(bench, device=dev)
        checks.cell = "bench cell frontier, 1-D 8, wide"
        same_as(checks.cell, sh.sharded_frontier_passes(m1, bench), b_ref)
        log_fn(f"  {checks.cell}: every mesh kernel == plain after each launch, results == "
               f"run_frontier_passes{walk_note(checks, checks.cell)}")
        for (n, r, seed), layouts in MESH_COIN_CASES:
            case = coin_round_case(n, r, seed)
            g = SimpleNamespace(n=n, super_majority=case["super_majority"],
                                coin_bit=case["coin_bit"])
            la, fd, index = (to_device(case[k], dev) for k in ("la", "fd", "index"))
            lr = torch.tensor(case["last_round"], dtype=torch.int32, device=dev)
            for pk in layouts:
                checks.cell = f"coin case {(n, r, seed)}, 2-D (2, 4), " + (
                    "packed" if pk else "wide")
                stage = sh.stage_fame(m2, g, case["wtable"], la, fd, index, pk)
                decided, famous = sh.sharded_fame(m2, stage, lr, 8, n,
                                                  case["super_majority"], pk)
                sh.fame_tables(stage.wtable, la, decided, famous, lr)
                want = kernels_decide(case, dev, pk)
                r_rows = case["wtable"].shape[0]
                if not (torch.equal(decided[:r_rows], want[0])
                        and torch.equal(famous[:r_rows] & decided[:r_rows], want[1] & want[0])):
                    raise AssertionError(f"{checks.cell}: the mesh's fame differs from "
                                         f"decide_fame's")
                log_fn(f"  {checks.cell}: {int(decided.sum())} witnesses decided in one "
                       f"shard_fame/grid launch, == plain (voting to d = {r - 1}, coin steps "
                       f"at d % {n} == 0); == decide_fame's verdicts")
                hold_step_fame(checks, m2, stage, lr, n, case["super_majority"], pk,
                               (decided, famous), log_fn)
        wg = synthetic_grid(MESH_WIDTH["n"], MESH_WIDTH["e_count"], seed=MESH_WIDTH["seed"],
                            zipf_a=MESH_WIDTH["zipf_a"])
        w_ref = engine.run_frontier_passes(wg, device=dev, packed=True)
        checks.cell = "width cell frontier, 1-D 8, packed"
        w_res = sh.sharded_frontier_passes(m1, wg, packed=True)
        # B21's per-step kernels at this width (32 words) on its fame input
        checks.cell = "width cell, 1-D 8, packed, per-step form"
        w_in = fame_input(wg, w_ref, dev)
        w_fame = sh.stage_fame(m1, wg, *w_in[:4], True)
        hold_step_fame(checks, m1, w_fame, w_in[4], wg.n, wg.super_majority, True,
                       sh.sharded_fame(m1, w_fame, w_in[4], 8, wg.n, wg.super_majority, True),
                       log_fn)
        del w_fame
        checks.cell = "width cell frontier, 1-D 8, packed"
        # the per-step kernels at this width too (128 chains a position,
        # m0's widest shared-memory layout), the history against the one
        # launch's
        w_stage = sh.stage_walk(m1, wg)
        w_hist = w_stage.walk(m1)
        require_equal("the per-step walk against the one-launch walk, width cell, 1-D 8",
                      tuple(w_stage.walk(m1, form="step")), tuple(w_hist))
        # the same walk on a one-card mesh of 128 positions (8 chains each):
        # one launch, each position's history == the plain walk's, and the
        # histories == the 1-D 8 walk's row for row
        m_wide = DeviceMesh.on(dev, *MESH_WIDE_1D)
        checks.cell = f"width cell walk, 1-D {m_wide.size}"
        s_wide = sh.stage_walk(m_wide, wg)
        _ext.reset_launches()
        h_wide = s_wide.walk(m_wide)
        require_one_walk_launch(checks.cell, dict(_ext.LAUNCHES))
        require_equal(f"the {checks.cell} walk against the 1-D 8 walk, row for row",
                      torch.cat(h_wide, dim=1), torch.cat(w_hist, dim=1))
        log_fn(f"  {checks.cell}: {len(h_wide)} positions of {h_wide[0].shape[1]} chains, one "
               f"shard_walk/grid launch == plain; == the 1-D 8 walk row for row"
               f"{walk_note(checks, checks.cell)}")
        checks.cell = "width cell frontier, 1-D 8, packed"
    same_as(checks.cell, w_res, w_ref)
    log_fn(f"  {checks.cell}: {wg.n} validators, {wg.e} events, 128 chains per position "
           f"(the plain walk in the binary-search form): == run_frontier_passes, "
           f"last_round {w_res.last_round}; checked {checks.names(checks.cell)}"
           f"{walk_note(checks, checks.cell)}")
    # past the plain versions' reach: K3 (packed), shard_fame/grid and
    # B21's per-step kernels on the 1-D mesh, held to one another
    n_f = FAR_VOTE_CASE[0]
    f_case = coin_round_case(*FAR_VOTE_CASE)
    f_sm = f_case["super_majority"]
    f_k3 = kernels_decide(f_case, dev, True)
    g = SimpleNamespace(n=n_f, super_majority=f_sm, coin_bit=f_case["coin_bit"])
    la, fd, index = (to_device(f_case[k], dev) for k in ("la", "fd", "index"))
    lr = torch.tensor(f_case["last_round"], dtype=torch.int32, device=dev)
    stage = sh.stage_fame(m1, g, f_case["wtable"], la, fd, index, True)
    _ext.reset_launches()
    one = sh.sharded_fame(m1, stage, lr, 8, n_f, f_sm, True)
    one_launches = _ext.LAUNCHES["shard_fame/grid/packed"]
    require_equal(f"coin case {FAR_VOTE_CASE}, 1-D 8: the per-step loop against the one "
                  f"launch", sh.sharded_fame(m1, stage, lr, 8, n_f, f_sm, True, form="step"),
                  one)
    r_rows = f_case["wtable"].shape[0]
    if (one_launches != 1 or not int(f_k3[0].sum())
            or not torch.equal(one[0][:r_rows], f_k3[0])
            or not torch.equal(one[1][:r_rows] & one[0][:r_rows], f_k3[1] & f_k3[0])):
        raise AssertionError(f"coin case {FAR_VOTE_CASE}: shard_fame/grid x{one_launches}, "
                             f"or its fame differs from decide_fame's, or nothing is decided")
    plan = _ext.fame_vote_plan(-(-n_f // 32))
    log_fn(f"  coin case {FAR_VOTE_CASE}, 1-D 8, packed ({plan['words']} words, a ring of "
           f"{plan['stages']} slots): decide_fame == one shard_fame/grid launch == the "
           f"per-step kernels, {int(f_k3[0].sum())} witnesses decided")
    del f_case, f_k3, la, fd, index, stage, one
    log_fn(f"phase 17 (a): {time.perf_counter() - t0:.1f} s")

    # (b) end to end: config #4, both meshes, both layouts, the three engines
    t0 = time.perf_counter()
    launches, paths = {}, {}
    for mname, m in meshes.items():
        for ename, fn in engines.items():
            for pk in (True, False):
                label = ename + (", packed" if pk else "")
                res, got = run_path(label, lambda: fn(m, wide, packed=pk))
                same_as(f"{label} on {mname}", res, wide_ref)
                require_one_fame_launch(f"{label} on {mname}", got)
                require_one_card(f"{label} on {mname}", label, got)
                if ename == "sharded_frontier_passes":
                    require_one_walk_launch(f"{label} on {mname}", got)
                counts = dict(last_round=res.last_round,
                              received=int((res.received >= 0).sum()),
                              witnesses=int(res.witness.sum()))
                if counts != WIDE_EXPECT:
                    raise AssertionError(f"{label} on {mname}: {counts}, the reference "
                                         f"gives {WIDE_EXPECT}")
                paths[(mname, label)] = got
        for ename, fn in engines.items():
            ms = wall_ms(lambda: fn(m, wide), MESH_RUNS)
            log_fn(f"e2e {ename} (packed) on the {mname} mesh, config #4: median {ms:.1f} ms "
                   f"over {MESH_RUNS} warm runs, {wide.e / ms * 1e3:.0f} events/s; card: one "
                   f"{torch.cuda.get_device_name(0)}")
    log_fn(f"config #4 through the three sharded engines on both meshes in both layouts == "
           f"phase 14's engines: {WIDE_EXPECT}")
    for name in ("shard_fame/grid/packed", "fame_received", "fame_setup/packed",
                 "shard_walk/grid", "frontier_post"):
        launches[name] = paths[("1-D 8", "sharded_frontier_passes, packed")][name]
    launches["build_inv (config #4 mesh)"] = (
        paths[("1-D 8", "sharded_frontier_passes, packed")]["build_inv"])
    # K1's and pass 3's per-position paths: each named (the layout of
    # positions on distinct cards), config #4 on the 1-D mesh
    _, step_launches = run_path(
        "sharded_build_inv, per-position form",
        lambda: sh.sharded_build_inv(m1, walk_stage.rb_parts, walk_stage.la_parts, form="step"))
    if step_launches["build_inv"] != m1.size:
        raise AssertionError(f"sharded_build_inv(form='step'): build_inv "
                             f"x{step_launches['build_inv']}, expected {m1.size}")
    _, step_launches = run_path(
        "sharded_received, per-position form",
        lambda: sh.sharded_received(m1, wide.index, wide.creator, wide_ref.rounds, recv_fame,
                                    form="step"))
    for name in ("fame_tables", "received_search"):
        launches[name] = step_launches[name]
    # B21's per-step kernels' path: sharded_fame with that form named (the
    # layout of positions on distinct cards), config #4 on the 1-D mesh
    for pk, suffix in ((True, "/packed"), (False, "")):
        stage = sh.stage_fame(m1, wide, *fame_in[:4], pk)
        _, step_launches = run_path(
            "sharded_fame, per-step form" + (", packed" if pk else ""),
            lambda: sh.sharded_fame(m1, stage, fame_in[4], 8, wide.n, wide.super_majority, pk,
                                    form="step"))
        for name in ("shard_fame/tally", "shard_fame/decide"):
            launches[name + suffix] = step_launches[name + suffix]
        if pk:
            launches["shard_fame/active"] = step_launches["shard_fame/active"]
    # the per-step kernels' path: local_walk with that form named (the
    # layout of positions on distinct cards), config #4 on the 1-D mesh
    _, step_launches = run_path("local_walk, per-step form",
                                lambda: walk_stage.walk(m1, form="step"))
    for name in STEP_WALK_KEYS:
        launches[name] = step_launches[name]
    for name in ("shard_fame/grid", "fame_setup"):
        launches[name] = paths[("1-D 8", "sharded_run_passes")][name]
    w_run, w_launches = run_path("sharded_frontier_passes (1,024), packed",
                                 lambda: sh.sharded_frontier_passes(m1, wg, packed=True))
    same_as("sharded_frontier_passes (1,024)", w_run, w_ref)
    require_one_walk_launch("sharded_frontier_passes (1,024)", w_launches)
    require_one_fame_launch("sharded_frontier_passes (1,024)", w_launches)
    require_one_card("sharded_frontier_passes (1,024)", "sharded_frontier_passes", w_launches)
    launches["fame_setup/packed (1,024)"] = w_launches["fame_setup/packed"]
    log_fn(f"phase 17 (b): {time.perf_counter() - t0:.1f} s")

    # (c) the hashgraph seam on phase 15's signed events
    t0 = time.perf_counter()
    k = hg_kept

    def fresh(count):
        blocks = []
        hg = hgm.hashgraph_from_events(k["peers_json"], k["events"][:count],
                                       cache_size=HG_CACHE, commit_callback=blocks.append)
        return hg, blocks

    hg, blocks = fresh(len(k["events"]))
    _ext.reset_launches()
    t1 = time.perf_counter()
    engine.run_consensus_device(hg, mesh=m2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    got = dict(_ext.LAUNCHES)
    require_path_launches("run_consensus_device on the 2-D mesh",
                          "sharded_frontier_passes, packed", got)
    require_same_consensus("run_consensus_device on the 2-D mesh", k["ref"],
                           k["host_blocks"], hg, blocks)
    cells = [c for c in hg.obs.devledger.snapshot() if c.endswith("/integrate")]
    log_fn(f"  run_consensus_device(hg, mesh=2-D (2, 4)) == host: 1 call, {len(blocks)} "
           f"blocks, {secs:.2f} s; ledger {cells}")

    hg, blocks = fresh(0)
    events = k["events"]
    calls, secs = 0, 0.0
    _ext.reset_launches()
    for lo in range(0, len(events), MESH_SYNC):
        for d in events[lo: lo + MESH_SYNC]:
            hg.insert_event(hgm.Event.from_json(d), True)
        t1 = time.perf_counter()
        try:
            run_consensus_mesh_queued(hg, m2, queue_depth=MESH_QUEUE_DEPTH)
        except GridUnsupported as err:
            raise AssertionError(f"run_consensus_mesh_queued left its rung at call "
                                 f"{calls + 1}: {err}") from err
        secs += time.perf_counter() - t1
        calls += 1
    q = hg._mesh_dispatch_queue
    t1 = time.perf_counter()
    q.flush()
    torch.cuda.synchronize()
    secs += time.perf_counter() - t1
    require_same_consensus("run_consensus_mesh_queued", k["ref"], k["host_blocks"], hg, blocks)
    if q.stager.delta_stages == 0:
        raise AssertionError("run_consensus_mesh_queued: the stager never took the delta path")
    got = {kk: v for kk, v in _ext.LAUNCHES.items() if v}
    log_fn(f"  run_consensus_mesh_queued (queue depth {MESH_QUEUE_DEPTH}, syncs of "
           f"{MESH_SYNC}) then flush == host: {calls} calls, {q.dispatches} dispatches, "
           f"{q.integrations} integrations, {len(blocks)} blocks, {secs:.2f} s of calls; "
           f"stager: {q.stager.full_restages} full, {q.stager.delta_stages} delta; "
           f"launches {got}")
    log_fn(f"phase 17 (c): {time.perf_counter() - t0:.1f} s")

    summary, work = {}, {}
    for name, where in MESH_TIMED_CELL.items():
        cell, checked = where if isinstance(where, tuple) else (where, name)
        calls_n, k_ms, p_ms, (nbytes, secs_ops) = checks.summary(cell, checked)
        summary[name] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
        work[name] = (nbytes, secs_ops)
    for cell in sorted({c for c, _ in checks.events}):
        for name in checks.names(cell):
            calls_n, k_ms, p_ms, (nbytes, secs_ops) = checks.summary(cell, name)
            bound = max(nbytes / HBM_BYTES_S, secs_ops) * 1e3
            log_fn(f"  {cell}: {name} x{calls_n}: {k_ms:.4f} ms per launch (plain "
                   f"{p_ms:.3f}), bound {bound:.6f} ms")
    # the wide tally as one batched 0/1 product at the shape of its timed
    # cell (config #4's level scan, 1-D 8: 85 rounds per position), a
    # yardstick the port never calls
    b_rows = -(-wide.r_max // MESH_1D[0][0])
    a = (torch.rand((b_rows, wide.n, wide.n), device=dev) < 0.5).float()
    bm = (torch.rand((b_rows, wide.n, wide.n), device=dev) < 0.5).float()
    log_fn(f"tally yardstick: one torch.bmm of ({b_rows}, {wide.n}, {wide.n}) 0/1 float32 "
           f"matrices {cuda_ms(lambda: torch.bmm(a, bm), 20):.4f} ms (never called by the "
           f"port)")
    log_fn(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return summary, work, launches


def kernels_decide(case, dev, packed):
    """decide_fame's (decided, famous) on a coin case, on the card."""
    from babble_tpu_torch.tpu import kernels

    fame = kernels.decide_fame(*coin_fame_args(case, case["coin_bit"], dev), packed=packed)
    return fame.decided, fame.famous


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from babble_tpu_torch.tpu import _ext, doubling, engine, frontier, kernels
    from babble_tpu_torch.tpu.grid import section_grid, synthetic_deep_grid, synthetic_grid

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False  # the bmm yardstick stays exact

    phase_clock = PhaseClock(log)
    phase_clock.next("1")
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    phase_clock.next("2")
    # 2. build
    t0 = time.perf_counter()
    paths = _ext.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernel libraries")
    for name, path in paths.items():
        report = path.with_suffix(".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase_clock.next("3")
    # 3. each kernel against its plain version
    def pipeline_inputs(grid, st, r_cap):
        inv = frontier.build_inv(st.rows_by, st.la)
        fr = frontier.frontier_rounds(
            inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd,
            grid.super_majority, r_cap,
        )
        fame = kernels.decide_fame(
            fr.witness_table, st.la, st.fd, st.index, st.coin_bit,
            fr.last_round, grid.super_majority, grid.n, r_cap + 2,
        )
        return inv, fr, fame

    def calls(grid, st, r_cap):
        """(name, kernel call, plain call) over the same card inputs."""
        inv, fr, fame = pipeline_inputs(grid, st, r_cap)
        sm, n = grid.super_majority, grid.n
        fame_args = (fr.witness_table, st.la, st.fd, st.index, st.coin_bit,
                     fr.last_round, sm, n, r_cap + 2)
        recv_args = (fr.witness_table, st.la, st.index, st.creator, fr.rounds,
                     fame.decided, fame.famous, fame.rounds_decided, fr.last_round)
        return [
            ("build_inv",
             lambda: frontier.build_inv(st.rows_by, st.la),
             lambda: frontier._build_inv_plain(st.rows_by, st.la)),
            ("frontier_rounds",
             lambda: tuple(frontier.frontier_rounds(
                 inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, r_cap)),
             lambda: tuple(frontier._frontier_rounds_plain(
                 inv, st.rows_by, st.creator, st.index, st.sp_index, st.fd, sm, r_cap,
                 la=st.la))),
            ("decide_fame",
             lambda: tuple(kernels.decide_fame(*fame_args)),
             lambda: tuple(kernels._decide_fame_plain(*fame_args))),
            ("decide_fame/packed",
             lambda: tuple(kernels.decide_fame(*fame_args, packed=True)),
             lambda: tuple(kernels._decide_fame_plain(*fame_args, packed=True))),
            ("round_received",
             lambda: kernels.decide_round_received(*recv_args),
             lambda: kernels._decide_round_received_plain(*recv_args)),
        ], (inv, fr, fame)

    for fx in FIXTURES:
        n, e, seed, zipf, byz = fx
        grid = synthetic_grid(n, e, seed=seed, zipf_a=zipf, byzantine_frac=byz)
        st = engine.stage_frontier(grid, dev)
        triples, _ = calls(grid, st, R_CAP)
        for name, kern, plain in triples:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            require_equal(f"{name} on fixture {fx}", got, want)
        require_same_results(
            f"run_frontier_passes on fixture {fx}",
            engine.run_frontier_passes(grid, device=dev),
            engine.run_frontier_passes(grid, device="cpu"),
        )
        log(f"kernels == plain and e2e == cpu on fixture n={n} e={e} seed={seed} zipf={zipf} byz={byz:.3f}")

    for n, r, seed in COIN_CASES:
        case = coin_round_case(n, r, seed)
        coin = case["coin_bit"]
        verdicts = [kernels.decide_fame(*coin_fame_args(case, c, "cpu")) for c in (coin, ~coin)]
        if all(torch.equal(a, b) for a, b in zip(*verdicts)):
            raise AssertionError(f"coin case n={n} rounds={r} seed={seed}: the coin bits "
                                 "decide nothing, so no coin round is reached")
        for c in (coin, ~coin):
            args = coin_fame_args(case, c, dev)
            for pk in (False, True):
                got = tuple(kernels.decide_fame(*args, packed=pk))
                want = tuple(kernels._decide_fame_plain(*args, packed=pk))
                torch.cuda.synchronize()
                require_equal(f"decide_fame (packed={pk}) on coin case n={n} rounds={r} "
                              f"seed={seed}", got, want)
        hold_received(f"coin case ({n}, {r}, {seed})",
                      coin_received_args(case, kernels.FameResult(*want), dev), log)
        log(f"decide_fame == plain in both layouts on coin case n={n} rounds={r} seed={seed}, "
            f"both coin settings: coin round reached (flipping the coin bits changes the "
            f"verdicts)")

    t0 = time.perf_counter()
    bench = synthetic_grid(BENCH["n"], BENCH["e_count"], seed=BENCH["seed"],
                           zipf_a=BENCH["zipf_a"], record_fd_updates=True)
    log(f"bench grid: {bench.n} validators, {bench.e} events, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    st = engine.stage_frontier(bench, dev)
    triples, (inv, fr, fame) = calls(bench, st, R_CAP)
    summary = {}
    for name, kern, plain in triples:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require_equal(f"{name} on the bench grid", got, want)
        summary[name] = {"max_abs_err": max_abs_err(got, want)}
        # device time behind a spin that covers the wrapper's host work; the
        # wall (events around the whole call, no spin) beside it in the log
        summary[name]["ms"] = spun_ms(kern, 20)
        summary[name]["plain_ms"] = cuda_ms(plain, 5)
        log(f"  {name} on the bench grid: {summary[name]['ms']:.4f} ms of device time, "
            f"{cuda_ms(kern, 20):.4f} ms of wall")
    log(f"kernels == plain on the bench grid (decide_fame in both layouts: the wide "
        f"{summary['decide_fame']['ms']:.4f} ms, the packed "
        f"{summary.pop('decide_fame/packed')['ms']:.4f})")
    bench_recv_args = (fr.witness_table, st.la, st.index, st.creator, fr.rounds, fame.decided,
                       fame.famous, fame.rounds_decided, fr.last_round)
    hold_received("the bench grid", bench_recv_args, log)
    hold_received_traps(dev, log)
    hold_build_inv_traps(dev, log)

    # the K3 tally as one batched 0/1 product, a yardstick the port never calls
    r_max, n = fr.witness_table.shape
    a = (torch.rand((r_max, n, n), device=dev) < 0.5).float()
    b = (torch.rand((r_max, n, n), device=dev) < 0.5).float()
    tally_bmm_ms = cuda_ms(lambda: torch.bmm(a, b), 20)

    # work bounds from this run's data (see PERF.md for the counting rules):
    # only the la rows the chain table names, the walk steps whose frontier
    # still holds a witness, and the la/fd rows of the witnesses present
    # (all of them for K3, the famous ones for K4)
    n, l = st.rows_by.shape
    real_rows = int((st.rows_by >= 0).sum().item())
    valid_rounds = int((fr.witness_table >= 0).any(dim=1).sum().item())
    wvalid = fr.witness_table >= 0
    n_wit = int(wvalid.sum().item())
    n_pairs = int((wvalid[1:].sum(dim=1) * wvalid[:-1].sum(dim=1)).sum().item())
    n_famous = int((fame.decided & fame.famous & wvalid).sum().item())
    # K2's working steps, from the plain walk's history
    k2_hist = frontier._frontier_history_plain(inv, st.rows_by, st.fd, bench.super_majority,
                                               R_CAP, la=st.la)
    work = {
        "build_inv": build_inv_work(st.rows_by, st.la, inv),
        "frontier_rounds": frontier_rounds_work(inv, st, bench.super_majority, k2_hist),
        "decide_fame": fame_work(fr.witness_table, n),
        "round_received": received_work(
            bench_recv_args, kernels._decide_round_received_plain(*bench_recv_args)),
    }
    log(f"bound inputs: {real_rows} chain rows, {valid_rounds} rounds with witnesses, "
        f"{n_wit} witnesses, {n_famous} famous; K2's walk {walk_steps([k2_hist])} working "
        f"steps of {R_CAP - 1}")

    phase_clock.next("4")
    # 4. end to end
    t0 = time.perf_counter()
    cpu = engine.run_frontier_passes(bench, device="cpu")
    log(f"cpu reference run (plain versions): {time.perf_counter() - t0:.1f} s")
    _ext.reset_launches()
    res = engine.run_frontier_passes(bench, device=dev)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    require_same_results("end to end", res, cpu)
    if res.witness_table.shape != cpu.witness_table.shape:
        raise AssertionError("end to end: the round axes differ")
    n_received = int((res.received >= 0).sum())
    if res.last_round != BENCH_LAST_ROUND or n_received != BENCH_RECEIVED:
        raise AssertionError(
            f"end to end: last_round {res.last_round}, {n_received} received; "
            f"the reference gives {BENCH_LAST_ROUND} and {BENCH_RECEIVED}"
        )
    missing = [k for k in PATH_KERNELS["run_frontier_passes"] if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    log(f"end to end == cpu run; launches on the main path: {launches}")

    walls = []
    for _ in range(E2E_RUNS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_frontier_passes(bench, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls[2:])
    log(f"e2e run_frontier_passes: median {wall * 1e3:.3f} ms over {E2E_RUNS} warm runs, "
        f"{bench.e / wall:.0f} events/s, last_round {res.last_round}, "
        f"{n_received} received, card: {smi}")
    # the device share of that call: build_inv + the pipeline on staged tensors
    def device_pipeline():
        inv_d = frontier.build_inv(st.rows_by, st.la)
        return frontier.frontier_pipeline(
            inv_d, st.rows_by, st.creator, st.index, st.sp_index, st.la, st.fd,
            st.lamport, st.coin_bit, bench.super_majority, bench.n, R_CAP,
        )
    pipe_ms = cuda_ms(device_pipeline, E2E_RUNS)
    stage_walls = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        engine.stage_frontier(bench, dev)
        torch.cuda.synchronize()
        stage_walls.append(time.perf_counter() - t0)
    log(f"host staging + host-to-device copies (stage_frontier): median "
        f"{statistics.median(stage_walls) * 1e3:.3f} ms over {E2E_RUNS} runs")
    log(f"device pipeline (build_inv + frontier_pipeline, r_cap {R_CAP}, staged "
        f"inputs): median {pipe_ms:.3f} ms")
    log(f"tally yardstick: one torch.bmm of ({r_max}, {n}, {n}) 0/1 float32 "
        f"matrices {tally_bmm_ms:.4f} ms (never called by the port)")

    phase_clock.next("5")
    # 5. grids of the cold path
    t0 = time.perf_counter()
    deep = synthetic_deep_grid(CATCHUP["n"], CATCHUP["depth"], seed=CATCHUP["seed"],
                               zipf_a=CATCHUP["zipf_a"])
    if (deep.e, deep.num_levels) != CATCHUP_GRID:
        raise AssertionError(f"catch-up grid: {deep.e} events, {deep.num_levels} levels; "
                             f"expected {CATCHUP_GRID}")
    sec = section_grid(deep, engine.run_frontier_passes(deep, device=dev), deep.num_levels // 2)
    if (sec.e, sec.num_levels) != CATCHUP_SECTION:
        raise AssertionError(f"catch-up section: {sec.e} events, {sec.num_levels} levels; "
                             f"expected {CATCHUP_SECTION}")
    ug = synthetic_deep_grid(UNPINNED["n"], UNPINNED["depth"], seed=UNPINNED["seed"],
                             zipf_a=UNPINNED["zipf_a"])
    usec = section_grid(ug, engine.run_passes(ug, device=dev), ug.num_levels // 2,
                        pin_cut=False)
    log(f"catch-up grid: {deep.e} events, {deep.num_levels} levels; section "
        f"{sec.e} events, {sec.num_levels} levels; unpinned section {usec.e} events, "
        f"{usec.num_levels} levels; {time.perf_counter() - t0:.1f} s to build")

    phase_clock.next("6")
    # 6. the level scan's and the cold path's kernels against their plain
    #    versions, on the bench grid and both sections; timed on the bench
    #    grid and the catch-up section
    def compare(name, label, kern, plain, timed):
        _ext.reset_launches()
        got = kern()
        torch.cuda.synchronize()
        n_launch = _ext.LAUNCHES[name]
        want = plain()
        torch.cuda.synchronize()
        require_equal(f"{name} on the {label}", got, want)
        line = f"{name} == plain on the {label}: {n_launch} launches"
        if timed:
            k_ms = cuda_ms(kern, 10)
            p_ms = cuda_ms(plain, SLOW_PLAIN_REPS, warmup=0)
            line += f", {k_ms:.4f} ms, plain {p_ms:.3f} ms"
            if label == "catch-up section":
                summary[name] = {"max_abs_err": max_abs_err(got, want), "ms": k_ms,
                                 "plain_ms": p_ms}
        log(line)
        return got

    def as_tensors(out):
        return tuple(torch.tensor(x, device=dev) if isinstance(x, int) else x for x in out)

    cold = [("bench grid", bench), ("catch-up section", sec), ("unpinned section", usec)]
    for label, g in cold:
        timed = label != "unpinned section"
        gp, _, scan_r_max = engine.scan_layout(g, True)
        ins = engine.stage_scan(gp, dev)
        dr_args = ins[:13] + (gp.super_majority, scan_r_max)
        dr_key = "divide_rounds" + (
            "/grid" if _ext.divide_rounds_form(g.n, ins[0].shape[1]) == "grid" else "")
        dr = compare(dr_key, label,
                     lambda: tuple(kernels.divide_rounds(*dr_args)),
                     lambda: tuple(kernels._divide_rounds_plain(*dr_args)), timed)
        if label == "bench grid":
            (nbytes, ops_s), pairs, _ = scan_work(g, ins, dr, scan_r_max)
            log(f"  {dr_key} bound on the {label}: "
                f"{max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms ({pairs} scan pairs)")
            hold_k5_forms(label, g, dev, log)
        lam_args = doubling.lamport_inputs(g, dev)
        lam = compare("lamport_scan", label,
                      lambda: doubling._lamport_levels_scan(*lam_args),
                      lambda: doubling._lamport_levels_scan_plain(*lam_args), timed)
        if label == "catch-up section":
            # both carry forms of the one-block walk and K8 (the rule's
            # and the device memory's) on the section
            hold_walk_carries(label, dr_args, lam_args, g.num_levels, log, want=dr,
                              want_lam=lam)
        cs = doubling.stage_doubling(g, dev)
        cl_args = (cs.creator_d, cs.idx_d, cs.sp_d, cs.op_d, cs.rows_by_d, cs.l_b,
                   cs.block, cs.pass_cap)
        if label != "unpinned section":
            cl = compare("closure_la", label,
                         lambda: as_tensors(doubling._closure_la(*cl_args)),
                         lambda: as_tensors(doubling._closure_la_plain(*cl_args)), timed)
        if label == "bench grid":
            # pass caps that stop the closure before its fixed point
            for cap in CLOSURE_TRAP_CAPS:
                t_args = cl_args[:-1] + (cap,)
                got = as_tensors(doubling._closure_la(*t_args))
                require_equal(f"closure_la (pass_cap {cap}) on the {label}", got,
                              as_tensors(doubling._closure_la_plain(*t_args)))
                if int(got[1]) != cap:
                    raise AssertionError(f"closure_la (pass_cap {cap}): {int(got[1])} passes")
            log(f"closure_la == plain on the {label} at pass_cap {CLOSURE_TRAP_CAPS} "
                f"(of {int(cl[1])} passes to the fixed point)")
        # every chunk of the walk, kernel against plain; the largest is timed
        chunks, hist, first_nw = held_walk(label, g, cs, dev)
        fired = sum(1 for c in range(g.n)
                    if 0 <= first_nw[c] < hist.shape[0] and hist[first_nw[c], c] == 0)
        if label == "unpinned section" and fired == 0:
            raise AssertionError("unpinned section: the first_nw mask never fired")
        big = max(chunks, key=lambda a: a[10])
        compare("walk_chunk", f"{label} (largest chunk, {big[10]} steps)",
                lambda: doubling._walk_chunk(*big), lambda: doubling._walk_chunk_plain(*big),
                False)
        if timed:
            k_ms = cuda_ms(lambda: doubling._walk_chunk(*big), 10)
            p_ms = cuda_ms(lambda: doubling._walk_chunk_plain(*big), SLOW_PLAIN_REPS, warmup=0)
            # the kernels line's ms is the largest chunk's; the walk
            # launches every chunk once
            all_ms = sum(cuda_ms(lambda a=a: doubling._walk_chunk(*a), 10) for a in chunks)
            log(f"  walk_chunk on the {label}: {big[10]} steps x {big[11]} probes, "
                f"{k_ms:.4f} ms, plain {p_ms:.3f} ms; all {len(chunks)} chunks "
                f"({sum(a[10] for a in chunks)} steps) {all_ms:.4f} ms")
        log_chunk_steps(label, chunks, log)
        log(f"walk_chunk == plain on every chunk of the {label} "
            f"({', '.join(str(a[10]) for a in chunks)} steps, seeded {cs.seeded}, "
            f"{walk_chunk_form(g.n, cs.l_b)}); first_nw mask fired on {fired} of {g.n} chains")
        if label == "unpinned section":
            continue
        # the largest chunk's traps: searches cut short, a non-monotone la
        hold_walk_chunk_traps(label, big, log)
        if label == "bench grid":
            # K7's cluster form (one block a cluster at 64 validators), device
            # work behind a spin
            summary["walk_chunk (bench grid)"] = {
                "max_abs_err": 0, "ms": spun_ms(lambda: doubling._walk_chunk(*big), 10),
                "plain_ms": p_ms}
            (nbytes, ops_s), st = walk_chunk_work(big, cs.l_b, g.n)
            work["walk_chunk (bench grid)"] = (nbytes, ops_s)
            log(f"  walk_chunk on the {label}, largest chunk behind a spin: "
                f"{summary['walk_chunk (bench grid)']['ms']:.4f} ms; bound "
                f"{max(nbytes / HBM_BYTES_S, ops_s) * 1e3:.6f} ms ({steps_note(st, big[10])})")
            continue
        summary["walk_chunk"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}

        # work bounds at the catch-up section's shapes, from this run's data
        def cpu(x):
            return x.cpu()

        n_s = g.n
        work["divide_rounds"], pairs, n_wit = scan_work(g, ins, dr, scan_r_max)
        work["lamport_scan"] = lamport_work(g.e, lam_args)
        la_fin, passes = cl
        l_c = cs.l_b
        work["closure_la"] = closure_la_work(cs, la_fin, passes)
        work["walk_chunk"], st = walk_chunk_work(big, l_c, n_s)
        log(f"  bound inputs (catch-up section): {pairs} scan (event, witness) pairs, "
            f"{n_wit} witnesses, closure {int(passes)} passes, walk "
            f"{steps_note(st, big[10])}")

    # the whole catch-up grid (65,536 events: K5's and K8's carries keep
    # the rows past what fits on chip in device memory) and the level
    # scans' trap tables, K5's one-block walk and K8 in every carry form
    gp, _, scan_r_max = engine.scan_layout(deep, True)
    ins = engine.stage_scan(gp, dev)
    hold_walk_carries("catch-up grid", ins[:13] + (gp.super_majority, scan_r_max),
                      doubling.lamport_inputs(deep, dev), deep.num_levels, log)
    for name, (arrays, super_majority, r_maxes) in level_traps().items():
        t_args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        lam_t = tuple(t_args[i] for i in (0, 3, 4, 10, 11, 12))
        for r_max in r_maxes:
            hold_walk_carries(f"trap table {name} (r_max {r_max})",
                              t_args + (super_majority, r_max), lam_t, 0, log)

    phase_clock.next("7")
    # 7. the bench grid through the level scan and the cold path
    bstats = {}
    dbl_b, dbl_b_launches = run_path("run_doubling_passes", lambda: doubling.run_doubling_passes(
        bench, stats=bstats, device=dev))
    require_same_results("run_doubling_passes on the bench grid", dbl_b, res)
    launches["walk_chunk (bench grid)"] = dbl_b_launches["walk_chunk"]
    scan_b, _ = run_path("run_passes", lambda: engine.run_passes(
        bench, bucketed=True, adaptive_r=True, device=dev))
    require_same_results("run_passes on the bench grid", scan_b, res)
    got = {k: bstats[k] for k in BENCH_DOUBLING}
    if got != BENCH_DOUBLING:
        raise AssertionError(f"bench grid doubling stats {got}, expected {BENCH_DOUBLING}")
    for label, fn in (
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(bench, device=dev)),
        ("run_passes(bucketed, adaptive_r)", lambda: engine.run_passes(
            bench, bucketed=True, adaptive_r=True, device=dev)),
    ):
        ms = wall_ms(fn, E2E_RUNS)
        log(f"e2e {label} on the bench grid: median {ms:.3f} ms over {E2E_RUNS} warm runs, "
            f"{bench.e / ms * 1e3:.0f} events/s, card: {smi}")
    log(f"bench grid: the three engines agree field for field; last_round "
        f"{dbl_b.last_round}, {int((dbl_b.received >= 0).sum())} received, "
        f"closure passes {bstats['closure_passes']}, walk chunks {bstats['walk_chunks']}")

    phase_clock.next("8")
    # 8. the catch-up cell
    t0 = time.perf_counter()
    cpu_stats = {}
    cpu_d = doubling.run_doubling_passes(sec, stats=cpu_stats, device="cpu")
    cpu_s = engine.run_passes(sec, bucketed=True, adaptive_r=True, device="cpu")
    log(f"catch-up section on the CPU (plain versions): {time.perf_counter() - t0:.1f} s")
    sstats = {}
    dbl_s, launches_d = run_path("run_doubling_passes, seeded", lambda: doubling.run_doubling_passes(
        sec, stats=sstats, device=dev))
    scan_s, launches_s = run_path("run_passes, catch-up section", lambda: engine.run_passes(
        sec, bucketed=True, adaptive_r=True, device=dev))
    require_same_results("catch-up run_doubling_passes == CPU", dbl_s, cpu_d)
    require_same_results("catch-up run_passes == CPU", scan_s, cpu_s)
    require_same_results("catch-up run_doubling_passes == run_passes", dbl_s, scan_s)
    if sstats != cpu_stats:
        raise AssertionError(f"catch-up stats {sstats} != CPU {cpu_stats}")
    got = dict(last_round=dbl_s.last_round, round_offset=dbl_s.round_offset,
               received=int((dbl_s.received >= 0).sum()),
               closure_passes=sstats["closure_passes"], walk_chunks=sstats["walk_chunks"],
               passes=sstats["passes"])
    if got != CATCHUP_EXPECT:
        raise AssertionError(f"catch-up cell: {got}, the reference gives {CATCHUP_EXPECT}")
    log(f"catch-up cell: both engines == each other == CPU run; {got}")
    for label, fn in (
        ("run_doubling_passes", lambda: doubling.run_doubling_passes(sec, device=dev)),
        ("run_passes(bucketed, adaptive_r)", lambda: engine.run_passes(
            sec, bucketed=True, adaptive_r=True, device=dev)),
    ):
        ms = wall_ms(fn, CATCHUP_RUNS)
        log(f"e2e catch-up {label}: median {ms:.3f} ms over {CATCHUP_RUNS} warm runs, "
            f"{sec.e / ms * 1e3:.0f} events ordered/s replaying the section from cold, "
            f"card: {smi}")
    log(split_line("  catch-up run_doubling_passes, split",
                   *cold_path_split(lambda: doubling.run_doubling_passes(sec, device=dev),
                                    CATCHUP_RUNS)))
    launches["divide_rounds"] = launches_s["divide_rounds"]
    for k in ("closure_la", "walk_chunk", "lamport_scan"):
        launches[k] = launches_d[k]

    phase_clock.next("9")
    # 9. the incremental engine's kernels against their plain versions
    from babble_tpu_torch.tpu import incremental as inc

    sm, n = bench.super_majority, bench.n
    t0 = time.perf_counter()
    batches = inc.batches_from_grid(bench, INC_STEP["batch"], INC_STEP["upd_cap"],
                                    INC_STEP["e_cap"])
    trains = inc.trains_from_grid(bench, INC_TRAIN["size"], INC_TRAIN["upd_cap"],
                                  INC_TRAIN["e_cap"], t_cap=INC_TRAIN["t_cap"])
    if len(batches) != INC_BATCHES or [t.levels.shape[0] for t in trains] != INC_TRAIN_LEVELS:
        raise AssertionError(f"builders: {len(batches)} batches, train levels "
                             f"{[t.levels.shape[0] for t in trains]}; expected "
                             f"{INC_BATCHES} and {INC_TRAIN_LEVELS}")
    max_burst = max(int((b.upd_row < INC_STEP["e_cap"]).sum()) for b in batches)
    max_train_burst = max(int((t.upd_row < INC_TRAIN["e_cap"]).sum()) for t in trains)
    batches_d = [inc.device_put(b, dev) for b in batches]
    trains_d = [inc.device_put(t, dev) for t in trains]
    torch.cuda.synchronize()
    log(f"incremental inputs: {len(batches)} batches (largest fd burst {max_burst} of "
        f"{INC_STEP['upd_cap']}), {len(trains)} trains (levels "
        f"{[t.levels.shape[0] for t in trains]}, largest burst {max_train_burst} of "
        f"{INC_TRAIN['upd_cap']}); {time.perf_counter() - t0:.1f} s to build and copy")

    # K10's (K11's) launch key at each shape: the one-block walk on the
    # 8-validator fixture, the grid walk on the bench grid (64 validators:
    # _ext.STEP_LEVELS_GRID_FROM, TRAIN_LEVELS_GRID_FROM); PairedRun checks
    # that each checked call launched the key it is timed under
    def step_calls(run, x, r_win, e_win, work, key, packed=False):
        step_call(run, key, x, sm_of[0], packed=packed, work=work)
        decide_calls(run, r_win, e_win, work, packed)

    def train_calls(run, x, r_win, e_win, work, key, packed=False):
        run.call("apply_deltas", lambda st: inc._apply_deltas_and_stage(st, x),
                 lambda st: inc._apply_deltas_and_stage_plain(st, x),
                 (lambda st: inc_work_deltas(st, x)) if work else None)
        run.call(key, lambda st: inc._train_levels(st, x, sm_of[0], packed=packed),
                 lambda st: inc._train_levels_plain(st, x, sm_of[0], packed=packed),
                 (lambda st: inc_work_levels(st, x, False)) if work else None)
        decide_calls(run, r_win, e_win, work, packed)

    def decide_calls(run, r_win, e_win, work, packed=False):
        run.call("decide_window/packed" if packed else "decide_window",
                 lambda st: inc._decide_body(st, sm_of[0], n_of[0], r_win=r_win, e_win=e_win,
                                             packed=packed),
                 lambda st: inc._decide_body_plain(st, sm_of[0], n_of[0], r_win, e_win,
                                                   packed=packed),
                 (lambda st: inc_work_decide(st, r_win, e_win)) if work else None)

    # the 8-validator fixture: the coin step lies in the unroll; with r_win 8
    # below r_cap 16 the window slides and freezes
    fx = INC_FIXTURE
    fgrid = synthetic_grid(fx["n"], fx["e"], seed=fx["seed"], zipf_a=fx["zipf_a"],
                           record_fd_updates=True)
    sm_of, n_of = [fgrid.super_majority], [fgrid.n]
    fb = [inc.device_put(b, dev) for b in inc.batches_from_grid(fgrid, fx["batch"], 8192, fx["e"])]
    # two no-op batches (the live engine's multi_step padding) at the end
    fb += [inc.device_put(inc.empty_batch(fgrid.n, fx["batch"], 8192, fx["e"]), dev)] * 2
    ft = [inc.device_put(t, dev) for t in inc.trains_from_grid(
        fgrid, fx["train"], 8192, fx["e"], w_cap=fx["w_cap"], t_cap=fx["t_cap"])]
    # (in both layouts at r_cap 64: the kernels line's one-block rows of K10
    # and K11, with the launches of step and train_step over the fixture;
    # the r_cap 16 run goes first, so that no timed call holds a kernel's
    # first launch in the process, which loads its module)
    fixture_runs, fixture_launches = {}, {}
    for r_cap, r_win, packed in ((16, 8, False), (fx["r_cap"], 32, False),
                                 (fx["r_cap"], 32, True)):
        sfx = "/packed" if packed else ""
        timed = r_cap == fx["r_cap"]
        run = PairedRun(f"8-validator grid, r_cap {r_cap}, r_win {r_win}"
                        + (", packed" if packed else ""),
                        inc.init_state(fgrid.n, fx["e"], r_cap, device=dev))
        for b in fb:
            step_calls(run, b, r_win, fx["e_win"], timed, "step_levels" + sfx, packed)
        trun = PairedRun(run.label + ", trains",
                         inc.init_state(fgrid.n, fx["e"], r_cap, device=dev))
        for t in ft:
            train_calls(trun, t, r_win, fx["e_win"], timed, "train_levels" + sfx, packed)
        log(f"apply_deltas + step_levels{sfx} (one launch), apply_deltas, train_levels{sfx}, "
            f"decide_window{sfx} == plain after every call on the {run.label}: {len(fb)} "
            f"batches, {len(ft)} trains, "
            f"last_round {int(run.k.last_round)}, stale {bool(run.k.stale)}")
        if not timed:
            continue
        fixture_runs[packed] = (run, trun)
        # the entry points over the same inputs, each run on its own: equal to
        # the paired runs' kernel states
        path_sfx = ", packed" if packed else ""
        for path, xs, fn, want in (
                (f"step, 8-validator fixture{path_sfx}", fb, inc.step, run.k),
                (f"train_step, 8-validator fixture{path_sfx}", ft, inc.train_step, trun.k)):
            st = inc.init_state(fgrid.n, fx["e"], r_cap, device=dev)
            _, got = run_path(path, lambda: [fn(st, x, sm_of[0], n_of[0], r_win=r_win,
                                                e_win=fx["e_win"], packed=packed) for x in xs])
            bad = state_diff(st, want)
            if bad:
                raise AssertionError(f"{path}: {bad} differ from the paired run's kernel state")
            fixture_launches[path] = got
    fixture_state = fixture_runs[False][0].k
    for name, run in (("step_levels", fixture_runs[False][0]),
                      ("train_levels", fixture_runs[False][1]),
                      ("step_levels/packed", fixture_runs[True][0]),
                      ("train_levels/packed", fixture_runs[True][1])):
        calls, k_ms, p_ms = run.times(name)
        nbytes, alu, tc = run.work[name]
        summary[name] = {"max_abs_err": 0, "ms": k_ms / calls, "plain_ms": p_ms / calls}
        work[name] = (nbytes / calls, alu / ALU_OPS_S / calls)
        log(f"  {name} (one block) on the 8-validator fixture: {calls} calls, kernel "
            f"{k_ms / calls:.4f} ms per call, plain {p_ms / calls:.2f} ms per call")
    launches["step_levels"] = fixture_launches["step, 8-validator fixture"]["step_levels"]
    launches["train_levels"] = fixture_launches["train_step, 8-validator fixture"]["train_levels"]
    launches["step_levels/packed"] = (
        fixture_launches["step, 8-validator fixture, packed"]["step_levels/packed"])
    launches["train_levels/packed"] = (
        fixture_launches["train_step, 8-validator fixture, packed"]["train_levels/packed"])

    sm_of, n_of = [sm], [n]
    t0 = time.perf_counter()
    # the grid walks' first launches (module loads) before the timed runs
    inc.step(inc.init_state(n, INC_STEP["e_cap"], INC_STEP["r_cap"], device=dev), batches_d[0],
             sm, n, r_win=INC_STEP["r_win"], e_win=INC_STEP["e_win"])
    inc.train_step(inc.init_state(n, INC_TRAIN["e_cap"], INC_TRAIN["r_cap"], device=dev),
                   trains_d[0], sm, n, r_win=INC_TRAIN["r_win"], e_win=INC_TRAIN["e_win"])
    srun = PairedRun("live step shape", inc.init_state(
        n, INC_STEP["e_cap"], INC_STEP["r_cap"], device=dev))
    for b in batches_d:
        step_calls(srun, b, INC_STEP["r_win"], INC_STEP["e_win"], True, "step_levels/grid")
    trun = PairedRun("train shape", inc.init_state(
        n, INC_TRAIN["e_cap"], INC_TRAIN["r_cap"], device=dev))
    for t in trains_d:
        train_calls(trun, t, INC_TRAIN["r_win"], INC_TRAIN["e_win"], True, "train_levels/grid")
    log(f"apply_deltas + step_levels/grid (one launch), apply_deltas, train_levels/grid, "
        f"decide_window == plain after every call at the live step shape ({len(batches_d)} "
        f"batches) and the train shape "
        f"({len(trains_d)} trains): {time.perf_counter() - t0:.1f} s")
    inc_summary = {}
    # K9 has its own launch on the train paths only (the step paths run
    # it as step_levels' phase 0): its row of the kernels line is the
    # train shape's
    for label, run, names in (
            ("live step shape", srun, ("step_levels/grid", "decide_window")),
            ("train shape", trun, ("apply_deltas", "train_levels/grid", "decide_window"))):
        for name in names:
            calls, k_ms, p_ms = run.times(name)
            nbytes, alu, tc = run.work[name]
            log(f"  {name} at the {label}: {calls} calls, kernel {k_ms:.3f} ms in all "
                f"({k_ms / calls:.4f} ms per call), plain {p_ms:.1f} ms in all; work "
                f"{nbytes} bytes, {alu} ALU and {tc} tensor-core operations in all")
            if label == "live step shape" or name != "decide_window":
                inc_summary[name] = (calls, k_ms, p_ms, nbytes, alu, tc)

    phase_clock.next("10")
    # 10. both append paths end to end
    e = bench.e
    scan_ref = engine.run_passes(bench, device=dev)

    def check_path(label, st):
        got = {f: getattr(st, f)[:e].cpu().numpy() for f in ("rounds", "lamport", "witness", "received")}
        for f, g in got.items():
            if not (g == getattr(scan_ref, f)).all():
                raise AssertionError(f"{label}: {f} differs from run_passes on the card")
        n_received = int((got["received"] >= 0).sum())
        res = dict(last_round=int(st.last_round), received=n_received,
                   witnesses=int(got["witness"].sum()), stale=bool(st.stale),
                   fame_lag=bool(st.fame_lag))
        want = dict(last_round=BENCH_LAST_ROUND, received=BENCH_RECEIVED,
                    witnesses=INC_WITNESSES, stale=False, fame_lag=False)
        if res != want:
            raise AssertionError(f"{label}: {res}, the reference gives {want}")
        return res

    empty = inc.device_put(inc.empty_batch(n, INC_STEP["batch"], INC_STEP["upd_cap"],
                                           INC_STEP["e_cap"]), dev)
    step_groups = []
    for i in range(0, len(batches_d), MULTI_STEP_K):
        group = batches_d[i : i + MULTI_STEP_K]
        k = 4 if len(group) <= 4 else MULTI_STEP_K
        group = group + [empty] * (k - len(group))
        step_groups.append(inc.Batch(*[torch.stack(f) for f in zip(*group)]))
    train_groups = [inc.device_put(inc.stack_trains(trains[i : i + MULTI_TRAIN_K]), dev)
                    for i in range(0, len(trains), MULTI_TRAIN_K)]
    torch.cuda.synchronize()
    st_cfg, tr_cfg = INC_STEP, INC_TRAIN
    append_paths = {
        "step": (st_cfg, lambda st: [inc.step(st, b, sm, n, r_win=st_cfg["r_win"],
                                              e_win=st_cfg["e_win"]) for b in batches_d]),
        "multi_step": (st_cfg, lambda st: [inc.multi_step(
            st, g, sm, n, r_win=st_cfg["r_win"], e_win=st_cfg["e_win"]) for g in step_groups]),
        "train_step": (tr_cfg, lambda st: [inc.train_step(
            st, t, sm, n, r_win=tr_cfg["r_win"], e_win=tr_cfg["e_win"]) for t in trains_d]),
        "multi_train": (tr_cfg, lambda st: [inc.multi_train(
            st, g, sm, n, r_win=tr_cfg["r_win"], e_win=MULTI_TRAIN_E_WIN)
            for g in train_groups]),
    }
    inc_launches = {}
    for label, (cfg, drive) in append_paths.items():
        st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
        torch.cuda.synchronize()
        _, path_launches = run_path(label, lambda: drive(st))
        res = check_path(label, st)
        inc_launches[label] = path_launches
        walls = []
        for _ in range(INC_RUNS + 2):
            st = inc.init_state(n, cfg["e_cap"], cfg["r_cap"], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drive(st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check_path(label, st)
        if label == "step":
            step_state = st
        wall = statistics.median(walls[2:])
        log(f"e2e {label} on the bench grid: median {wall * 1e3:.3f} ms over {INC_RUNS} warm "
            f"runs, {e / wall:.0f} events appended/s; {res}; card: {smi}")
    st = inc.init_state(n, tr_cfg["e_cap"], tr_cfg["r_cap"], device=dev)
    for g in train_groups:
        inc.multi_train(st, g, sm, n, r_win=tr_cfg["r_win"], e_win=tr_cfg["e_win"])
    got = dict(stale=bool(st.stale), fame_lag=bool(st.fame_lag),
               received=int((st.received >= 0).sum()))
    if got != MULTI_TRAIN_UNDERSIZED:
        raise AssertionError(f"multi_train at e_win {tr_cfg['e_win']}: {got}, the reference "
                             f"gives {MULTI_TRAIN_UNDERSIZED}")
    log(f"multi_train at e_win {tr_cfg['e_win']} (undersized for a decide per "
        f"{MULTI_TRAIN_K} trains): {got}, as the reference")
    launches["apply_deltas"] = inc_launches["train_step"]["apply_deltas"]
    launches["step_levels/grid"] = inc_launches["step"]["step_levels/grid"]
    launches["decide_window"] = inc_launches["step"]["decide_window"]
    launches["train_levels/grid"] = inc_launches["train_step"]["train_levels/grid"]
    for name, (calls, k_ms, p_ms, nbytes, alu, tc) in inc_summary.items():
        summary[name] = {"max_abs_err": 0, "ms": k_ms / calls, "plain_ms": p_ms / calls}
        work[name] = (nbytes / calls, (alu / ALU_OPS_S + tc / INT8_TC_OPS_S) / calls)

    phase_clock.next("11")
    # 11. K13 pack_results against its plain version
    from babble_tpu_torch.tpu import live

    e_cap_s, e_win_s, r_cap_s = INC_STEP["e_cap"], INC_STEP["e_win"], INC_STEP["r_cap"]
    count = int(step_state.count)
    lo_live = max(count - e_win_s, 0)
    pack_cases = [("live step state", step_state, e_win_s, r_cap_s, n, lo)
                  for lo in (0, lo_live, e_cap_s - e_win_s + 1000, -100)]
    pack_cases.append(("8-validator fixture", fixture_state, fx["e_win"], fx["r_cap"],
                       fgrid.n, max(int(fixture_state.count) - fx["e_win"], 0)))
    _ext.reset_launches()
    for label, st_, ew, rc, nn, lo in pack_cases:
        got = live._pack_results(st_, lo, ew, rc, nn)
        want = live._pack_results_plain(st_, lo, ew, rc, nn)
        torch.cuda.synchronize()
        require_equal(f"pack_results on the {label} at lo {lo}", got, want)
        log(f"pack_results == plain on the {label} (e_win {ew}, r_cap {rc}, n {nn}) at lo "
            f"{lo}: {got.numel()} words, window start "
            f"{live.pack_window_start(lo, st_.rounds.shape[0], ew)}")
    def kern():
        return live._pack_results(step_state, lo_live, e_win_s, r_cap_s, n)

    def plain():
        return live._pack_results_plain(step_state, lo_live, e_win_s, r_cap_s, n)

    k_ms, p_ms = spun_ms(kern, 50), spun_ms(plain, 20)
    k_host_ms, p_host_ms = cuda_ms(kern, 50), cuda_ms(plain, 20)
    log(f"  pack_results at the live step shape (lo {lo_live}): {k_ms * 1e3:.2f} us, plain "
        f"{p_ms * 1e3:.2f} us of device work (CUDA events behind a spin); with the host's "
        f"wrapper and enqueue in the window {k_host_ms * 1e3:.2f} us, plain "
        f"{p_host_ms * 1e3:.2f} us; {_ext.LAUNCHES['pack_results']} launches in this phase")
    summary["pack_results"] = {"max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms}
    # each source element read once (three int32 row fields and the bool
    # witness over the window, the int32 table and two bool tables, the
    # three scalars), each output word written once
    work["pack_results"] = (e_win_s * 13 + r_cap_s * n * 6 + 6
                            + (4 * e_win_s + 3 * r_cap_s * n + 3) * 4, 0.0)
    fused_pack_phase(step_state, batches_d, sm, n, dev)

    phase_clock.next("12")
    # 12. the hashgraph path at full width
    hg_stats, _ = hashgraph_phase(DEVICE, log, depth=HG_DEPTH)
    # K13's own launches: the late attach's (run (e)); every other call's
    # pack rides its last decide's launch
    launches["pack_results"] = hg_stats["attach"]["launches"].get("pack_results", 0)

    phase_clock.next("13-15")
    # 13-15. the packed layout: config #4's grid, then the hashgraph path at
    # the layout's switch
    t0 = time.perf_counter()
    wide = synthetic_grid(WIDE["n"], WIDE["e_count"], seed=WIDE["seed"],
                          zipf_a=WIDE["zipf_a"], byzantine_frac=WIDE["byzantine_frac"],
                          record_fd_updates=True)
    if wide.num_levels != WIDE_LEVELS:
        raise AssertionError(f"config #4 grid: {wide.num_levels} levels, expected {WIDE_LEVELS}")
    log(f"config #4 grid: {wide.n} validators, {wide.e} events, {wide.num_levels} levels; "
        f"{time.perf_counter() - t0:.1f} s to generate")
    p_summary, p_work, upd_cap, wide_batches = packed_kernel_phase(wide, dev, log)
    summary.update(p_summary)
    work.update(p_work)
    wide_launches, wide_ref = wide_engine_phase(wide, dev, log, upd_cap, wide_batches)
    del wide_batches
    launches["decide_fame/packed"] = wide_launches["run_frontier_passes"]["decide_fame/packed"]
    launches["decide_fame (config #4)"] = (
        wide_launches["run_frontier_passes, wide"]["decide_fame"])
    launches["frontier_rounds (config #4)"] = (
        wide_launches["run_frontier_passes"]["frontier_rounds"])
    launches["closure_la (config #4)"] = wide_launches["run_doubling_passes"]["closure_la"]
    launches["walk_chunk (config #4)"] = wide_launches["run_doubling_passes"]["walk_chunk"]
    launches["divide_rounds/packed/grid"] = (
        wide_launches["run_passes"]["divide_rounds/packed/grid"])
    # K10p and K12p at run (c)'s shape: the kernels line's times and bounds
    s_summary, s_work = switch_kernel_phase(dev, log)
    summary.update(s_summary)
    work.update(s_work)
    switch_stats, switch_launches = hashgraph_phase(
        DEVICE, log, spec=SWITCH, oneshot=SWITCH_ONESHOT_RUNG, full=False, expect=SWITCH_EXPECT,
        title="phase 15", live_settings=SWITCH_LIVE, depth=SWITCH_DEPTH, keep=True)
    launches["step_levels/packed/grid"] = switch_launches["step_levels/packed/grid"]
    launches["decide_window/packed"] = switch_launches["decide_window/packed"]

    phase_clock.next("16")
    # 16. the frontier-live engine: (a), (c) the bench cell and the
    # bootstrap, (b) config #4 in trains, (d) config #5's width; (e) K7's
    # widest clusters and its L2 form at 512 validators
    for part, args in ((fl_bench_phase, (bench, trains, scan_ref)),
                       (fl_wide_phase, (wide, wide_ref)), (fl_width_phase, ())):
        f_summary, f_work, f_launches = part(*args, dev, log)
        summary.update(f_summary)
        work.update(f_work)
        launches.update(f_launches)
    # (e) K7's cluster form at 8 blocks a cluster, and its L2 form
    cluster_walk_phase(dev, log)

    phase_clock.next("17")
    # 17. the device mesh, every position on the one card
    m_summary, m_work, m_launches = mesh_phase(wide, wide_ref, bench, switch_stats.pop("kept"),
                                               dev, log)
    summary.update(m_summary)
    work.update(m_work)
    launches.update(m_launches)
    del wide

    phase_clock.next(None)
    out = []
    for name, (source, replaces) in REPLACES.items():
        nbytes, ops_s = work[name]
        bytes_s = nbytes / HBM_BYTES_S
        s = summary[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": max(bytes_s, ops_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": None,
        })
    log(f"card (nvidia-smi name, power limit): {smi}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
