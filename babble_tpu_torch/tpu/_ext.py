"""Build, load and launch the port's CUDA kernels.

Each source under `babble_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface, at first
use, into `build/torch_kernels/` at the repository root (one `nvcc` per
source, all started together). The libraries are loaded with ctypes.
Nothing here runs at import: the CPU tests import every module, and a
host without a card never reaches the build.

Every launch function checks device, dtype, shape and contiguity of its
tensors, allocates its outputs and scratch with `torch.empty`, launches
on PyTorch's current stream, raises if the C entry point returns a CUDA
error, and only then adds one to its kernel's count in `LAUNCHES`. The
kernels that take the voting-table layout (`PACKED_KERNELS`) count a
launch in the packed layout under "<name>/packed" and a wide one under
"<name>", so a run can show which form ran: the two layouts give equal
integers by design.

build_inv (K1) is one launch that writes each INV word once, with no
atomic: a block per chain, tile of coordinates and segment of the chain's
indices, a running maximum down each column and a search of it for each
value; few chains split the chain axis into segments, each of which
publishes its maxima and reads every segment's, in one cooperative launch
(`build_inv_plan`), and its shared memory is the same at every L.

decide_fame (K3, both layouts) is a setup launch, whose blocks tile the
(voter, witness) pairs with the compare-count tile decide_window's setup
takes (`FS_SETUP_SMEM`), and a vote launch (csrc/fame_vote.cuh: a warp
per witness column, the strongly-see planes fetched ahead into a ring,
`fame_vote_plan`): the same shared memory at every width up to 1,024
validators, where the column's words leave registers for shared memory and
the ring takes fewer slots beside them, down to two at FV_MAX_WORDS words
(19,296 validators), past which it raises (no staging form).

The three level walks (divide_rounds, step_levels, train_levels) walk
narrow levels in one block and wider ones in a cooperative launch across
the card whose blocks take the same shared memory at every width
(`divide_rounds_form`, `step_levels_form`, `train_levels_form` choose by
width; the grid walk counts under "<key>/grid" and raises where the card
cannot hold its blocks at once); decide_window's launches use the same
shared memory at every width.

divide_rounds' one-block walk and lamport_scan are the staged level walk
of csrc/common.cuh: a prep launch packs the level table into records, a
producer warp bulk-copies them into a ring in shared memory ahead of the
consumer warps, and the walk's carry lies in shared memory for as many of
its first rows as fit beside the ring (and K5's witness-table window) and
in device memory past them. `level_walk_plan` is the one place that sizes
it (the carry form "shared", or "device" where a caller names it: every
row in device memory); both forms give equal integers by design.

The cold path's closure (closure_la) runs every pass in one cooperative
launch to its fixed point (`closure_la_plan` shapes it), and its walk
(walk_chunk) takes, up to WC_BLOCK_MAX validators, one block that runs
each chain's binary search as a speculative tree (`walk_chunk_depth`
picks the depth by width), after a prep launch; above, a cooperative
launch of thread-block clusters that hold the step's frontier table in
shared memory, and from WC_L2_FROM validators a cooperative launch that
counts every chain's probes of a search round together against the
table of countable rows, tile by tile (`walk_chunk_plan` chooses). Every
form skips the search of a step with fewer than super_majority countable
frontier rows.

Every frontier walk on one card is one cooperative launch of the same
kernel template (csrc/frontier_walk.cu walk_grid), which stops at the
walk's fixed point: K2 `frontier_rounds` and K15 `frontier_window` at one
position, and the mesh's walk (B24) where every position of the mesh lies
on one device ("shard_walk/grid", `shard_walk`, any number of positions).
Where positions lie on distinct cards B24 takes three launches per step
and position ("shard_walk/rows", "/m0", "/close"); `shard_walk_form`
chooses by layout alone. B21's fame loop follows the same rule: one
cooperative launch for every position ("shard_fame/grid", K3's vote on
tables gathered from the shards), or three launches per step and position
("shard_fame/tally", "/decide", "/active"); `shard_fame_form` also takes
the per-step form past the vote's 32 * FV_MAX_WORDS voters.

K4 `round_received` and B23 `fame_tables` launch one design of the
received tables (csrc/round_received.cu rt_grid; `received_tables_plan`
shapes it): blocks of (round, tile of columns, slice of the famous
witnesses), the slices' minima met in a thread-block cluster's shared
memory, the horizon scanned by the round that takes a ticket's last
number; K4's events follow a grid barrier in the same cooperative
launch, and where every position of the mesh lies on one card B22's
events ride B23's launch the same way (`fame_received`); their ticket and
barrier live on per-card words zeroed once (`sync_words`), which the
launches leave as they found them. K12 `decide_window` writes K13's vector in its last two
launches when handed one (`pack`): the live engine's results then need
no pack_results launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> (source file, C entry point, argument kinds:
# p = device pointer, i = int; every entry point ends in (device, stream))
KERNELS: Dict[str, Tuple[str, str, str]] = {
    "build_inv": ("build_inv.cu", "babble_build_inv", "pppp" "iiiiiiii"),
    "frontier_rounds": (
        "frontier_walk.cu", "babble_frontier_rounds", "pppppppppppp" "iiiiii",
    ),
    "decide_fame": ("decide_fame.cu", "babble_decide_fame", "ppppppppppppp" "iiiiii"),
    "round_received": (
        "round_received.cu", "babble_round_received", "pppppppppppppp" "iiiiii",
    ),
    "divide_rounds": (
        "divide_rounds.cu", "babble_divide_rounds", "pppppppppppppppppppp" "iiiiii"
        "iiiiiiiiiii",
    ),
    "closure_la": (
        "closure_la.cu", "babble_closure_la", "ppppppppp" "iiii" "iiiiiii",
    ),
    "walk_chunk": (
        "walk_chunk.cu", "babble_walk_chunk", "ppppppppppp" "iiiiiiiii" "iiiiiii",
    ),
    "lamport_scan": (
        "lamport_scan.cu", "babble_lamport_scan", "ppppppppp" "iii" "iiiiii",
    ),
    "apply_deltas": (
        "apply_deltas.cu", "babble_apply_deltas", "ppppppppppppp" "iiiii",
    ),
    "step_levels": (
        "step_levels.cu", "babble_step_levels", "pppppppppppppppppppppppp" "pppppp"
        "iiiiiiii",
    ),
    "train_levels": (
        "train_levels.cu", "babble_train_levels",
        "ppppppppppppppppppppppppppp" "iiiiiii",
    ),
    "decide_window": (
        "decide_window.cu", "babble_decide_window",
        "ppppppppppppppppppppppppppp" "iiiiiiiii",
    ),
    "pack_results": (
        "pack_results.cu", "babble_pack_results", "ppppppppppp" "iiiii",
    ),
    "frontier_append": (
        "frontier_append.cu", "babble_frontier_append", "ppppppppppppppppppp" "iiii",
    ),
    "frontier_window": (
        "frontier_walk.cu", "babble_frontier_window", "ppppppppppppppppppppp" "iiiiii",
    ),
    # the device mesh (tpu/sharded.py): B21's three launches, B22, B23,
    # B24's three per-step launches and its one-launch walk, and two
    # launches of K3 / K2 on their own
    "shard_fame/tally": ("shard_fame.cu", "babble_shard_fame_tally", "pppppp" "iiiiii"),
    "shard_fame/decide": (
        "shard_fame.cu", "babble_shard_fame_decide", "pppppppppp" "iiiiiiiii",
    ),
    "shard_fame/active": ("shard_fame.cu", "babble_shard_fame_active", "ppppp" "iii"),
    # B21's whole fame loop in one cooperative launch (every position on one
    # device)
    "shard_fame/grid": ("shard_fame.cu", "babble_shard_fame_grid", "pppppp" "iiiiiiiii"),
    "received_search": ("round_received.cu", "babble_received_search", "pppppppp" "iii"),
    "fame_tables": ("round_received.cu", "babble_fame_tables", "ppppppppppp" "iiiii"),
    # B23 and B22 in one launch where every position lies on one device
    "fame_received": ("round_received.cu", "babble_fame_received", "ppppppppppppppp" "iiiiii"),
    "shard_walk/rows": ("frontier_walk.cu", "babble_shard_walk_rows", "ppppp" "iiii"),
    "shard_walk/m0": ("frontier_walk.cu", "babble_shard_walk_m0", "pppp" "iiiii"),
    "shard_walk/close": ("frontier_walk.cu", "babble_shard_walk_close", "pppp" "iiii"),
    # B24 in one cooperative launch where every position lies on one device
    "shard_walk/grid": ("frontier_walk.cu", "babble_shard_walk", "ppp" "iiiiiii"),
    "fame_setup": ("decide_fame.cu", "babble_fame_setup", "pppppp" "iiiii"),
    "frontier_post": ("frontier_walk.cu", "babble_frontier_post", "ppppppppp" "iiii"),
}

# the kernels that take the voting-table layout (tpu/packed.py)
PACKED_KERNELS = ("decide_fame", "divide_rounds", "step_levels", "train_levels",
                  "decide_window", "shard_fame/tally", "shard_fame/decide", "fame_setup",
                  "shard_fame/grid")

# the level walks' cooperative grid form, in both layouts
GRID_FORMS = ("divide_rounds", "divide_rounds/packed", "step_levels", "step_levels/packed",
              "train_levels", "train_levels/packed")

# largest dynamic shared memory one block may use on an H100
MAX_SMEM_BYTES = 232448

# launches of each kernel's C entry point since the last reset: the packed
# layout's under "<name>/packed", a level walk's grid form under
# "<key>/grid"
LAUNCHES: Dict[str, int] = dict.fromkeys(
    list(KERNELS) + [f"{k}/packed" for k in PACKED_KERNELS]
    + [f"{k}/grid" for k in GRID_FORMS], 0)

# the staged level walk of divide_rounds' one-block form and lamport_scan
# (csrc/common.cuh, level_walk_plan): the ring's slots, the bytes of
# records one slot holds (at least one level, at most WALK_CHUNK_MAX), the
# rounds of K5's witness-table window (a power of two), the least threads
# of a walking block (its spare warps set up and write back the carry) and
# the most consumer warps; the carry forms a caller may name
WALK_STAGES = 4
WALK_STAGE_BYTES = 4096
WALK_CHUNK_MAX = 16
WALK_WINDOW = 4
WALK_MIN_THREADS = 256
WALK_MAX_WARPS = 31
WALK_CARRIES = ("shared", "device")

# the two walks of each level scan: one block below its *_GRID_FROM
# validators (where its rows fit one block's shared memory), a cooperative
# launch across the card from there (divide_rounds_form, step_levels_form,
# train_levels_form). Each crossover is measured on an H100 on the bench
# generator's grids of 32,768 events (PERF.md): K5 with
# scripts/time_divide_rounds.py (the staged block walk takes 1.34 us a
# level at 16 validators and 1.66 at 24, the grid walk 5.9-6.4 at every
# width; at 32 lanes the block walk has no form, and a general one took
# 10.4 us a level); K10 with scripts/time_step_levels.py (batches of 64:
# the block walk 0.0575 ms a batch at 48 validators and 0.0610 at 64, the
# grid walk 0.0622 and 0.0544); K11 with scripts/time_train_levels.py
# (trains of 8,192: the block walk 2.96 ms a train at 32, 3.63 at 48, the
# grid walk 4.78 and 3.57)
WALK_FORMS = ("block", "grid")
DIVIDE_ROUNDS_GRID_FROM = 32
STEP_LEVELS_GRID_FROM = 64
TRAIN_LEVELS_GRID_FROM = 48

# the per-block shared memory of the launches whose blocks tile their
# work, the same at every width: rings of stages of rows of 36 int32 words
# (common.cuh babble_count_tile_words): the level walks' grid form (8
# lanes + 32 witnesses, 4 stages: common.cuh babble_level_item_smem);
# dw_setup's and K3's setup's 64 rows + 64 witnesses, 3 stages; dw_vote's
# 64 rows + 32 columns, 2 stages
LEVEL_GRID_SMEM = 4 * (8 + 32) * 36 * 4
DW_SETUP_SMEM = 3 * (64 + 64) * 36 * 4
DW_VOTE_SMEM = 2 * (64 + 32) * 36 * 4
# K3's setup (decide_fame.cu fame_setup_pairs): dw_setup's tile
FS_SETUP_SMEM = DW_SETUP_SMEM

# the virtual vote's blocks (csrc/fame_vote.cuh): FV_COLS witness columns,
# a warp each, beside one producer warp; a ring of up to FV_STAGES items;
# the column's words in registers up to FV_REG_WORDS (1,024 validators),
# past it two buffers of them in shared memory and a ring of what fits
# beside them in MAX_SMEM_BYTES, at least two items: FV_MAX_WORDS (603
# words, 19,296 validators) is the widest vote
FV_COLS = 16
FV_STAGES = 8
FV_REG_WORDS = 32

# the received tables of K4 and B23 (csrc/round_received.cu rt_grid,
# received_tables_plan): a block's threads (four warps, each every fourth
# witness), the columns of a tile (a lane each), the witnesses' bit words a
# block stages at once, the most blocks a cluster (a portable one), the
# blocks the plan aims at (eight an SM of the H100's 132) and the widest
# grid it plans; the shared memory of one block (static: the chunk's flags,
# each warp's occupied words and the la rows, two buffers of the warps' and
# the block's minima, the slice's count and verdicts, the ticket's flag,
# the horizon scan's warp minima)
RT_THREADS = 128
RT_COLS = 32
RT_CHUNK = 32
RT_MAX_SLICES = 8
RT_TARGET_BLOCKS = 8 * 132
RT_MAX_WIDTH = 65536
RT_SMEM = (RT_CHUNK * 4 + RT_THREADS // 32 * 4 + RT_CHUNK * 32 * 4
           + 2 * (RT_THREADS + RT_COLS + 3) * 4 + 4 + RT_THREADS // 32 * 4)

# K1 build_inv (csrc/build_inv.cu, build_inv_plan): a block's threads, the
# chain indices it stages at once, the coordinates of a tile (a lane each);
# below BI_SPLIT_PER_SM blocks of (chain, tile) an SM the chain axis splits
# into segments, up to BI_BLOCKS_PER_SM blocks an SM (each block's launch
# bounds), in one cooperative launch; the shared memory of one block
# (static: the chunk's column-major maxima at a stride of BI_CHUNK + 1, its
# rows, the warps' slice maxima, each column's carry, top and final maximum)
BI_THREADS = 256
BI_CHUNK = 128
BI_COLS = 32
BI_SPLIT_PER_SM = 2
BI_BLOCKS_PER_SM = 4
H100_SMS = 132
BI_SMEM = (BI_COLS * (BI_CHUNK + 1) + BI_CHUNK + BI_THREADS + 3 * BI_COLS) * 4

_LIBS: Dict[str, ctypes.CDLL] = {}
# words that outlast a launch, zeroed once per card: the received tables'
# ticket and grid barrier; the ticket's last taker sets it back to 0 and
# the barrier's word comes back as it was, so no launch sets them first
_SYNC: Dict[torch.device, torch.Tensor] = {}


def sync_words(dev: torch.device) -> torch.Tensor:
    """`dev`'s two sync words."""
    words = _SYNC.get(dev)
    if words is None:
        words = _SYNC[dev] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return words


# K1's segmented form: per card, the segments' tagged maxima (zeroed once
# when allocated, grown as needed) and the epoch of the last call (a word
# of another call's epoch is never read as this one's)
_BI_WORDS: Dict[torch.device, torch.Tensor] = {}
_BI_EPOCH: Dict[torch.device, int] = {}


def _bi_words(dev: torch.device, words: int) -> Tuple[torch.Tensor, int]:
    """`dev`'s segment words (at least `words` of them) and a new epoch."""
    buf = _BI_WORDS.get(dev)
    epoch = _BI_EPOCH.get(dev, 0) + 1
    if buf is None or buf.numel() < words or epoch >= 1 << 30:
        buf = _BI_WORDS[dev] = torch.zeros((max(words, 1024),), dtype=torch.int64, device=dev)
        epoch = 1
    _BI_EPOCH[dev] = epoch
    return buf, epoch


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's standard prefix
    if default.exists():
        return str(default)
    raise RuntimeError("babble_tpu_torch: nvcc not found (set CUDA_HOME)")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / source):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale kernel library in parallel; return their paths.
    Raises RuntimeError with nvcc's output if any build fails. Writes each
    build's ptxas report (registers, shared memory, spills) beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(src) for name, (src, _, _) in KERNELS.items()}
    procs = {}
    for src in sorted({src for src, _, _ in KERNELS.values()}):
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failures = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        for kname, (_, fn, kinds) in KERNELS.items():
            if kname in _LIBS:
                continue
            cdll = ctypes.CDLL(str(paths[kname]))
            f = getattr(cdll, fn)
            f.argtypes = [
                ctypes.c_void_p if k == "p" else ctypes.c_int for k in kinds
            ] + [ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
            cdll.babble_cuda_error_string.argtypes = [ctypes.c_int]
            cdll.babble_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[kname] = cdll
        lib = _LIBS[name]
    return lib


def check_tensor(what: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Sequence[int], device: torch.device) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of exactly
    `shape` on `device`."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def _fv_stages(words: int) -> int:
    """The vote's ring slots (csrc/fame_vote.cuh fv_stages), 0 where fewer
    than two fit."""
    if words <= FV_REG_WORDS:
        return FV_STAGES
    ldw = words | 1
    fixed = 16 * FV_STAGES + 16 + 8 * FV_COLS * words
    slots = (MAX_SMEM_BYTES - fixed) // (4 * 32 * (ldw + 1))
    return 0 if slots < 2 else min(slots, FV_STAGES)


FV_MAX_WORDS = max(w for w in range(FV_REG_WORDS, 1024) if _fv_stages(w) >= 2)


def fame_vote_plan(words: int) -> Dict[str, int]:
    """The vote's tables and ring for voters in `words` bit words
    (csrc/fame_vote.cuh fv_tables, fv_smem_bytes): the row stride ldw
    (odd), n_pad voter rows, the voter rows of one ring item and the items
    of one step, the ring's slots, where the column's words live
    ("registers" or "shared"), and one block's shared memory in bytes."""
    if not 1 <= words <= FV_MAX_WORDS:
        raise ValueError(f"the vote holds 1 to {FV_MAX_WORDS} words of voters, not {words}")
    ldw = words | 1
    group = min(max(1, 32 // ldw), words)
    rows = 32 * group
    stages = _fv_stages(words)
    cols = 8 * FV_COLS * words if words > FV_REG_WORDS else 0
    return {"words": words, "ldw": ldw, "n_pad": 32 * words, "rows_item": rows,
            "items": -(-words // group), "stages": stages,
            "columns": "registers" if words <= FV_REG_WORDS else "shared",
            "smem": 16 * FV_STAGES + 16 + cols + 4 * stages * rows * (ldw + 1)}


def block_smem(name: str, n: int, packed: bool = False, **shape) -> Dict[str, int]:
    """Dynamic shared memory of one block of each launch `name` makes with
    n validators, as its C entry point sizes it, by launch. `shape` carries
    the other sizes the level kernels take (divide_rounds: n_lvl;
    step_levels: w, l_lv, b, r_cap; train_levels: kb, w, r_cap)."""
    words = (n + 31) // 32
    if name == "decide_fame":
        # both layouts: the setup's pair tile, the vote's ring
        return {"setup": FS_SETUP_SMEM, "vote": fame_vote_plan(words)["smem"]}
    if name == "decide_window":
        return {"setup": DW_SETUP_SMEM, "vote": DW_VOTE_SMEM}
    if name == "build_inv":
        # static, the same at every width and every L
        return {"walk": BI_SMEM}
    if name in ("round_received", "fame_tables", "fame_received"):
        # static, the same at every width
        return {"tables": RT_SMEM}
    if name == "closure_la":
        # closure_la.cu: the squaring's tile of target codes (n rows of
        # tile + 1 words) beside the prefix's two reductions
        return {"pass": closure_la_plan(n, 64)["smem"]}
    if name == "walk_chunk":
        # walk_chunk.cu, by walk_chunk_plan (shape: l, the chain length,
        # default 1, depth and form): the tree form's probed rows and
        # verdicts, the cluster form's table slice, rows_by rows and probe
        # rows, the L2 form's count tile
        return {"walk": walk_chunk_plan(n, shape.get("l", 1), shape.get("depth"),
                                        shape.get("form"))["smem"]}
    if name in WALK_SMEM:
        if walk_form(name, n, **shape) == "grid":
            return {"grid": LEVEL_GRID_SMEM}
        return {"walk": WALK_SMEM[name](n, **shape)}
    raise KeyError(name)


# the one-block walk's shared memory of each level scan, in bytes, as its
# C entry point sizes it
WALK_SMEM = {
    # dr_staged: the least its rounds walk takes (the ring of records and the
    # witness word; the window and the carry's rows take what is left)
    "divide_rounds": lambda n, n_lvl: _round_walk_base(n, n_lvl),
    # sl_walk: seven per-lane words, the level table, seven per-row words,
    # the lanes' la rows, and the witness-valid bytes
    "step_levels": lambda n, w, l_lv, b, r_cap: (7 * w + l_lv * w + 7 * b + w * n) * 4
    + r_cap * n,
    # tl_walk: two carries, nine per-lane words, the lanes' la rows, the
    # witness carry and the witness-valid bytes
    "train_levels": lambda n, kb, w, r_cap: (2 * kb + 9 * w + w * n) * 4 + kb + r_cap * n,
}


def walk_form_fits(name: str, form: str, n: int, **shape) -> bool:
    """Whether level scan `name`'s walk `form` can run n validators at the
    other sizes `shape` (divide_rounds: n_lvl; step_levels: w, l_lv, b,
    r_cap; train_levels: kb, w, r_cap): the grid walk always (its blocks'
    shared memory is fixed), the one-block walk where its rows fit one
    block's shared memory."""
    if form not in WALK_FORMS:
        raise ValueError(f"{name}: no form {form!r}")
    return form == "grid" or WALK_SMEM[name](n, **shape) <= MAX_SMEM_BYTES


def walk_form(name: str, n: int, **shape) -> str:
    """The walk level scan `name` launches for n validators (the one place
    it is chosen): the one-block walk below its *_GRID_FROM validators,
    where a barrier across the card would cost more than a level's work,
    and where it fits; the grid walk otherwise."""
    grid_from = {"divide_rounds": DIVIDE_ROUNDS_GRID_FROM, "step_levels": STEP_LEVELS_GRID_FROM,
                 "train_levels": TRAIN_LEVELS_GRID_FROM}[name]
    if n < grid_from and walk_form_fits(name, "block", n, **shape):
        return "block"
    return "grid"


def divide_rounds_form_fits(form: str, n: int, n_lvl: int) -> bool:
    return walk_form_fits("divide_rounds", form, n, n_lvl=n_lvl)


def divide_rounds_form(n: int, n_lvl: int) -> str:
    return walk_form("divide_rounds", n, n_lvl=n_lvl)


def step_levels_form_fits(form: str, n: int, w: int, l_lv: int, b: int, r_cap: int) -> bool:
    return walk_form_fits("step_levels", form, n, w=w, l_lv=l_lv, b=b, r_cap=r_cap)


def step_levels_form(n: int, w: int, l_lv: int, b: int, r_cap: int) -> str:
    return walk_form("step_levels", n, w=w, l_lv=l_lv, b=b, r_cap=r_cap)


def train_levels_form_fits(form: str, n: int, kb: int, w: int, r_cap: int) -> bool:
    return walk_form_fits("train_levels", form, n, kb=kb, w=w, r_cap=r_cap)


def train_levels_form(n: int, kb: int, w: int, r_cap: int) -> str:
    return walk_form("train_levels", n, kb=kb, w=w, r_cap=r_cap)


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def dr_record_words(n: int) -> int:
    """csrc/divide_rounds.cu dr_record_words: the int32 words of a record
    of K5's rounds walk (two header quads, the la row and the fd row, each
    row padded to a multiple of 4)."""
    return 8 + 2 * ((n + 3) // 4 * 4)


def _walk_chunk(level_bytes: int) -> int:
    """Levels a ring slot holds: WALK_STAGE_BYTES of records, at least one
    level, at most WALK_CHUNK_MAX."""
    return max(1, min(WALK_CHUNK_MAX, WALK_STAGE_BYTES // max(level_bytes, 1)))


def _ring_bytes(chunk: int, level_words: int, staged: bool = True) -> int:
    """common.cuh babble_ring_bytes: the mbarriers and the ring's slots."""
    return 16 * WALK_STAGES + (4 * WALK_STAGES * chunk * level_words if staged else 0)


def _round_walk_groups(n: int, n_lvl: int) -> Optional[Tuple[int, int]]:
    """(threads per level lane, consumer warps) of K5's rounds walk, in
    one of its two forms (csrc/divide_rounds.cu dr_round_walk): one warp
    holds the whole level where n <= 8 and its lanes' groups fit in it
    with at most four witnesses a thread; else a warp per lane (a thread
    per witness) up to 32 validators and WALK_MAX_WARPS lanes. None: the
    one-block walk does not take the shape (the grid walk does)."""
    lanes = _pow2(max(n_lvl, 1))
    if n <= 8 and lanes <= 32 and 4 * (32 // lanes) >= n:
        return 32 // lanes, 1
    if n <= 32 and n_lvl <= WALK_MAX_WARPS:
        return 32, max(n_lvl, 1)
    return None


def _round_walk_base(n: int, n_lvl: int) -> int:
    """Bytes K5's rounds walk needs before its window and carry: the ring
    of records (always in shared memory) and the witness lanes' word;
    past MAX_SMEM_BYTES where the one-block walk does not take the
    shape."""
    if _round_walk_groups(n, n_lvl) is None:
        return MAX_SMEM_BYTES + 1
    level_words = n_lvl * dr_record_words(n)
    return _ring_bytes(_walk_chunk(4 * level_words), level_words) + 4


def level_walk_plan(name: str, e: int, n: int, n_lvl: int, r_max: int = 1,
                    carry: Optional[str] = None) -> Dict:
    """The one rule that lays out the staged level walk of `name`
    ("divide_rounds", its one-block form, or "lamport_scan") over E events,
    n validators, levels of n_lvl lanes and (K5) r_max witness-table rows,
    as the C entry points take it. Each walk's records stream through a
    ring of WALK_STAGES slots in shared memory (K8's lamport walk reads
    them in place in device memory where one slot cannot hold a level; K5's
    rounds walk needs its ring, and walk_form_fits says where it fits). In
    the "shared" carry form (the default) K5's rounds walk keeps a window of
    the WALK_WINDOW latest witness-table rounds where it fits, and each walk
    keeps the first `chip` = min(E, what is left of MAX_SMEM_BYTES // 4)
    rows of its carry in shared memory, the rows past them in device
    memory; "device" keeps every row in device memory and no window. Both
    give equal integers. Returns {"carry", "lamport": {...}, "rounds":
    {...} (K5), "smem", "threads"}."""
    carry = carry or "shared"
    if carry not in WALK_CARRIES:
        raise ValueError(f"{name}: no carry form {carry!r}; {WALK_CARRIES}")
    on_chip = carry == "shared"
    lam_words = 4 * n_lvl
    lam_chunk = _walk_chunk(4 * lam_words)
    lam_staged = _ring_bytes(lam_chunk, lam_words) <= MAX_SMEM_BYTES
    lam_base = _ring_bytes(lam_chunk, lam_words, lam_staged)
    lam_chip = min(e, (MAX_SMEM_BYTES - lam_base) // 4) if on_chip else 0
    lam = dict(warps=min(WALK_MAX_WARPS, max(1, -(-n_lvl // 32))), chunk=lam_chunk,
               staged=lam_staged, chip=lam_chip, bytes=lam_base + 4 * lam_chip)
    plan = dict(carry=carry, lamport=lam)
    warps = lam["warps"]
    smem = lam["bytes"]
    if name == "divide_rounds":
        groups = _round_walk_groups(n, n_lvl)
        if groups is None:
            raise ValueError(f"divide_rounds: the one-block walk takes no {n} validators "
                             f"at level width {n_lvl}")
        group, r_warps = groups
        lda = (n + 3) // 4 * 4
        base = _round_walk_base(n, n_lvl)
        window = 4 * (WALK_WINDOW * (n * lda + 1 + (n + 31) // 32) + (r_max + 31) // 32)
        win = WALK_WINDOW if on_chip and base + window <= MAX_SMEM_BYTES else 0
        used = base + (window if win else 0)
        chip = min(e, max(0, MAX_SMEM_BYTES - used) // 4) if on_chip else 0
        plan["rounds"] = dict(group=group, warps=r_warps,
                              chunk=_walk_chunk(4 * n_lvl * dr_record_words(n)), win=win,
                              chip=chip, bytes=used + 4 * chip)
        warps = max(warps, r_warps)
        smem = max(smem, plan["rounds"]["bytes"])
    elif name != "lamport_scan":
        raise KeyError(name)
    plan["smem"] = smem
    plan["threads"] = max(WALK_MIN_THREADS, 32 * (1 + warps))
    return plan


def _check_walk_form(name: str, form: Optional[str], n: int, **shape) -> str:
    """The walk a call of `name` takes (`form`, or walk_form's); ValueError
    before anything is launched where that walk cannot hold the call."""
    if form is None:
        form = walk_form(name, n, **shape)
    if not walk_form_fits(name, form, n, **shape):
        raise ValueError(f"{name}: the one-block walk cannot hold {n} validators at "
                         f"{shape} in one block's shared memory")
    return form


def smem_bytes(name: str, n: int, packed: bool = False, **shape) -> int:
    """Dynamic shared memory of the largest block `name` launches with n
    validators (block_smem's largest)."""
    return max(block_smem(name, n, packed=packed, **shape).values())


def max_width(name: str, packed: bool = False) -> int:
    """The largest validator count whose blocks of `name` fit one block's
    shared memory (walk_chunk), up to 65,536."""
    n = 1
    while smem_bytes(name, n + 1, packed=packed) <= MAX_SMEM_BYTES:
        n += 1
        if n >= 1 << 16:
            break
    return n


def check_smem(name: str, n: int, packed: bool = False, **shape) -> None:
    """ValueError unless `name`'s blocks fit one block's shared memory
    (walk_chunk)."""
    need = smem_bytes(name, n, packed=packed, **shape)
    if need > MAX_SMEM_BYTES:
        layout = "packed" if packed else "wide"
        limit = "" if shape else (
            f"; it holds at most {max_width(name, packed=packed)}")
        raise ValueError(
            f"{name} ({layout}): {n} validators need {need} bytes of one "
            f"block's shared memory, above the card's {MAX_SMEM_BYTES}{limit}"
        )


def _launch(name: str, device: torch.device, args: Sequence,
            packed: bool = False, grid: bool = False) -> None:
    """Launch `name`'s C entry point on args (a None pointer passes NULL)
    and count it under its key: "/packed" for the packed layout, "/grid"
    for the grid walk."""
    lib = _lib(name)
    _, fn, kinds = KERNELS[name]
    if len(args) != len(kinds):
        raise TypeError(f"{fn}: {len(args)} arguments, expected {len(kinds)}")
    c_args = [
        (0 if a is None else a.data_ptr()) if k == "p" else int(a)
        for a, k in zip(args, kinds)
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*c_args, device.index or 0, stream)
    if rc != 0:
        msg = lib.babble_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
    LAUNCHES[name + ("/packed" if packed else "") + ("/grid" if grid else "")] += 1


def build_inv_plan(n_c: int, n_p: int, l: int, segments: Optional[int] = None,
                   sms: int = H100_SMS) -> Dict[str, int]:
    """K1's launch (csrc/build_inv.cu) for n_c chains of l indices and n_p
    coordinates on a card of `sms` SMs, the one rule that shapes it: a
    block per (chain, tile of BI_COLS coordinates, segment of the chain's
    indices), a segment whole chunks of BI_CHUNK indices. One segment a
    chain from BI_SPLIT_PER_SM (chain, tile) blocks an SM; below, as many as
    bring the blocks near BI_BLOCKS_PER_SM an SM (the cooperative launch's
    reach), at most one a chunk (`segments` names a count instead, within
    that reach: timing, the crossover). Returns tiles, segments, seg_len (a
    segment's indices), blocks and smem (bytes a block)."""
    if n_c < 1 or n_p < 1 or l < 1:
        raise ValueError(f"build_inv: needs chains, coordinates and indices, not "
                         f"({n_c}, {n_p}, {l})")
    tiles = -(-n_p // BI_COLS)
    base = n_c * tiles
    chunks = -(-l // BI_CHUNK)
    reach = max(1, BI_BLOCKS_PER_SM * sms // base)
    if segments is None:
        segments = 1 if base >= BI_SPLIT_PER_SM * sms else reach
    per = -(-chunks // max(1, min(segments, reach, chunks)))
    segments = -(-chunks // per)
    return {"tiles": tiles, "segments": segments, "seg_len": per * BI_CHUNK,
            "blocks": base * segments, "smem": BI_SMEM}


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def build_inv(rows_by: torch.Tensor, la: torch.Tensor,
              segments: Optional[int] = None) -> torch.Tensor:
    """K1: INV (N_c, N_p, L) int32 from rows_by (N_c, L) and la (E, N_p),
    one launch as build_inv_plan shapes it (`segments` as it takes them)."""
    dev = rows_by.device
    n_c, l = rows_by.shape
    e, n_p = la.shape
    check_tensor("rows_by", rows_by, torch.int32, (n_c, l), dev)
    check_tensor("la", la, torch.int32, (e, n_p), dev)
    inv = torch.empty((n_c, n_p, l), dtype=torch.int32, device=dev)
    if inv.numel() == 0:
        return inv
    plan = build_inv_plan(n_c, n_p, l, segments, sm_count(dev))
    words, epoch = None, 0
    if plan["segments"] > 1:
        words, epoch = _bi_words(dev, plan["blocks"] * BI_COLS)
    _launch("build_inv", dev, (rows_by, la, inv, words, n_c, l, n_p, e, plan["tiles"],
                               plan["segments"], plan["seg_len"], epoch))
    return inv


def walk_scratch_words(n_w: int, n_p: int, n_steps: int, last_row: bool = False) -> int:
    """Int32 words of the one-launch frontier walk's scratch
    (csrc/frontier_walk.cu walk_grid): the barrier count, moved (n_steps),
    n_live (n_steps + 1) and a key word, t (n_w, n_w), m0 (n_w), the
    staged frontier rows (n_w, n_p) and, for K15, the walk's last row
    (n_w)."""
    return 3 + 2 * n_steps + n_w * n_w + n_w + n_w * n_p + (n_w if last_row else 0)


def frontier_rounds(inv, rows_by, creator, index, sp_index, fd,
                    super_majority: int, r_cap: int):
    """K2: the r_cap-step frontier walk, one cooperative launch that stops
    at its fixed point, and its post pass. Returns (rounds (E,) int32,
    witness (E,) bool, wtable (r_cap, N) int32, last_round () int32)."""
    dev = inv.device
    n, l = rows_by.shape
    e = creator.shape[0]
    e_fd = fd.shape[0]
    check_tensor("inv", inv, torch.int32, (n, n, l), dev)
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    for what, t in (("creator", creator), ("index", index), ("sp_index", sp_index)):
        check_tensor(what, t, torch.int32, (e,), dev)
    check_tensor("fd", fd, torch.int32, (e_fd, n), dev)
    if r_cap < 1 or e_fd < 1:
        raise ValueError("frontier_rounds: needs r_cap >= 1 and a non-empty fd")
    x_hist = torch.empty((r_cap, n), dtype=torch.int32, device=dev)
    scratch = torch.empty((walk_scratch_words(n, n, r_cap - 1),), dtype=torch.int32,
                          device=dev)
    rounds = torch.empty((e,), dtype=torch.int32, device=dev)
    witness = torch.empty((e,), dtype=torch.uint8, device=dev)
    wtable = torch.empty((r_cap, n), dtype=torch.int32, device=dev)
    last_round = torch.empty((), dtype=torch.int32, device=dev)
    _launch("frontier_rounds", dev, (
        inv, rows_by, creator, index, sp_index, fd, x_hist, scratch, rounds,
        witness, wtable, last_round, n, l, e, e_fd, super_majority, r_cap,
    ))
    return rounds, witness.view(torch.bool), wtable, last_round


def decide_fame(wtable, la, fd, index, coin_bit, last_round,
                super_majority: int, n_participants: int, d_cap: int,
                packed: bool = False):
    """K3 (K3p with `packed`): virtual voting, one launch pair in both
    layouts (equal integers; `packed` names the count's key). Returns
    (decided (R, N) bool, famous (R, N) bool, rounds_decided (R,) bool).
    The setup takes the same shared memory at every width, the vote the
    same up to 1,024 validators and then less than MAX_SMEM_BYTES up to
    32 * FV_MAX_WORDS validators (ValueError above)."""
    dev = wtable.device
    r_max, n = wtable.shape
    e = la.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e, n), dev)
    check_tensor("fd", fd, torch.int32, (e, n), dev)
    check_tensor("index", index, torch.int32, (e,), dev)
    check_tensor("coin_bit", coin_bit, torch.bool, (e,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if e < 1 or n_participants < 1 or not 1 <= r_max <= 65535:
        raise ValueError("decide_fame: needs events, n_participants >= 1 and 1 to 65,535 "
                         "rounds")
    words = (n + 31) // 32
    if words > FV_MAX_WORDS:
        raise ValueError(f"decide_fame: {n} validators; the vote holds at most "
                         f"{32 * FV_MAX_WORDS}")
    plan = fame_vote_plan(words)
    # the vote's tables: ss words at row stride ldw, the rows' aux words, the
    # d = 1 votes as (R, N_x, W) words, and each round's flags and ticket
    ss = torch.empty((r_max, plan["n_pad"], plan["ldw"]), dtype=torch.int32, device=dev)
    aux = torch.empty((r_max, plan["n_pad"]), dtype=torch.int32, device=dev)
    vt0 = torch.empty((r_max, n, words), dtype=torch.int32, device=dev)
    flags = torch.empty((r_max, 2), dtype=torch.int32, device=dev)
    decided = torch.empty((r_max, n), dtype=torch.uint8, device=dev)
    famous = torch.empty((r_max, n), dtype=torch.uint8, device=dev)
    rounds_decided = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    _launch("decide_fame", dev, (
        wtable, la, fd, index, coin_bit.view(torch.uint8), last_round, ss, aux, vt0, flags,
        decided, famous, rounds_decided, r_max, n, e, super_majority, n_participants, d_cap,
    ), packed=packed)
    return (decided.view(torch.bool), famous.view(torch.bool),
            rounds_decided.view(torch.bool))


def received_tables_plan(n: int, r_max: int) -> Dict:
    """The received tables' work (csrc/round_received.cu rt_grid) for n
    validators and r_max rounds, the one rule that shapes it: items of
    (round, tile of RT_COLS columns), each taken by a cluster of
    `slices` blocks (a power of two, at most RT_MAX_SLICES), slice s
    walking the witnesses' bit words [s * wps, min((s + 1) * wps,
    words)); slices double while the items times slices stay below
    RT_TARGET_BLOCKS and every slice keeps a word. The launch takes a
    cluster an item, or, with K4's events after a grid barrier, as many
    clusters as the card holds at once striding over the items: any item
    count is placeable."""
    if not 1 <= n <= RT_MAX_WIDTH:
        raise ValueError(f"the received tables hold 1 to {RT_MAX_WIDTH} validators, not {n}")
    if r_max < 1:
        raise ValueError(f"the received tables need a round, not r_max {r_max}")
    words = -(-n // 32)
    tiles = -(-n // RT_COLS)
    items = r_max * tiles
    slices = 1
    while (slices * 2 <= min(RT_MAX_SLICES, words) and items * slices < RT_TARGET_BLOCKS
           and (2 * slices - 1) * -(-words // (2 * slices)) < words):
        slices *= 2
    return {"words": words, "tiles": tiles, "items": items, "slices": slices,
            "wps": -(-words // slices), "cols": RT_COLS, "threads": RT_THREADS,
            "smem": RT_SMEM}


def round_received(wtable, la, index, creator, rounds, decided, famous,
                   rounds_decided, last_round) -> torch.Tensor:
    """K4: round-received per event, (E,) int32, -1 while undetermined.
    One cooperative launch: the tables as received_tables_plan shapes
    them, a grid barrier, then the events."""
    dev = wtable.device
    r_max, n = wtable.shape
    e_la = la.shape[0]
    e = index.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e_la, n), dev)
    for what, t in (("index", index), ("creator", creator), ("rounds", rounds)):
        check_tensor(what, t, torch.int32, (e,), dev)
    check_tensor("decided", decided, torch.bool, (r_max, n), dev)
    check_tensor("famous", famous, torch.bool, (r_max, n), dev)
    check_tensor("rounds_decided", rounds_decided, torch.bool, (r_max,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if e_la < 1:
        raise ValueError("round_received: la has no rows")
    plan = received_tables_plan(n, r_max)
    min_la = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    famous_count = torch.empty((r_max,), dtype=torch.int32, device=dev)
    i_ok = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    received = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch("round_received", dev, (
        wtable, la, index, creator, rounds, decided.view(torch.uint8),
        famous.view(torch.uint8), rounds_decided.view(torch.uint8), last_round,
        min_la, famous_count, i_ok, received, sync_words(dev), r_max, n, e, e_la,
        plan["slices"], plan["wps"],
    ))
    return received


def divide_rounds(levels, creator, index, self_parent, other_parent, la, fd,
                  ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
                  ext_op_lamport, fixed_lamport, super_majority: int,
                  r_max: int, packed: bool = False, form: Optional[str] = None,
                  carry: Optional[str] = None):
    """K5: the level scan. Returns (rounds (E,) int32, witness (E,) bool,
    lamport (E,) int32, wtable (r_max, N) int32). `index` is not read (the
    reference's signature carries it). The packed layout's counts are the
    same integers, so `packed` launches the same kernel and counts it as
    divide_rounds/packed. The walk is divide_rounds_form's unless `form`
    names one ("block" or "grid"); the one-block walk's carry is
    level_walk_plan's unless `carry` names a form ("shared" or "device";
    scripts/time_divide_rounds.py times each). The grid walk counts under
    "<key>/grid", keeps its carry in device memory (a `carry` for it is
    refused), and raises where the card cannot hold its blocks at once."""
    dev = la.device
    l_lv, n_lvl = levels.shape
    e, n = la.shape
    check_tensor("levels", levels, torch.int32, (l_lv, n_lvl), dev)
    check_tensor("la", la, torch.int32, (e, n), dev)
    check_tensor("fd", fd, torch.int32, (e, n), dev)
    for what, t in (("creator", creator), ("index", index),
                    ("self_parent", self_parent), ("other_parent", other_parent),
                    ("ext_sp_round", ext_sp_round), ("ext_op_round", ext_op_round),
                    ("fixed_round", fixed_round), ("ext_sp_lamport", ext_sp_lamport),
                    ("ext_op_lamport", ext_op_lamport),
                    ("fixed_lamport", fixed_lamport)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e < 1 or r_max < 1:
        raise ValueError("divide_rounds: needs events and r_max >= 1")
    form = _check_walk_form("divide_rounds", form, n, n_lvl=n_lvl)
    if form == "grid" and carry is not None:
        raise ValueError("divide_rounds: the grid walk keeps its carry in device memory")
    scratch = rtable = ltable = None
    plan_ints = (0,) * 11
    if form == "grid":
        # the grid walk's per-lane c_seen, parent round, self-parent round
        # and lamport, and its barrier count
        scratch = torch.empty((4 * n_lvl + 1,), dtype=torch.int32, device=dev)
    else:
        plan = level_walk_plan("divide_rounds", e, n, n_lvl, r_max, carry)
        rp, lp = plan["rounds"], plan["lamport"]
        # the two walks' packed level tables
        rtable = torch.empty((l_lv * n_lvl * dr_record_words(n),), dtype=torch.int32,
                             device=dev)
        ltable = torch.empty((l_lv * n_lvl * 4,), dtype=torch.int32, device=dev)
        plan_ints = (rp["group"], rp["warps"], lp["warps"], rp["chunk"], lp["chunk"],
                     WALK_STAGES, int(lp["staged"]), rp["win"], rp["chip"], lp["chip"],
                     plan["threads"])
    rounds = torch.empty((e,), dtype=torch.int32, device=dev)
    witness = torch.empty((e,), dtype=torch.uint8, device=dev)
    lamport = torch.empty((e,), dtype=torch.int32, device=dev)
    wtable = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    last_level = torch.empty((), dtype=torch.int32, device=dev)
    _launch("divide_rounds", dev, (
        levels, creator, self_parent, other_parent, la, fd, ext_sp_round,
        ext_op_round, fixed_round, ext_sp_lamport, ext_op_lamport,
        fixed_lamport, rounds, witness, lamport, wtable, last_level, scratch,
        rtable, ltable, l_lv, n_lvl, e, n, super_majority, r_max, *plan_ints,
    ), packed=packed, grid=form == "grid")
    return rounds, witness.view(torch.bool), lamport, wtable


def closure_la(creator, index, sp, op, rows_by, l: int, pass_cap: int):
    """K6: lastAncestors (E, N) int32 by pointer doubling, and the pass
    count. One cooperative launch runs every pass to the fixed point or
    pass_cap (`closure_la_plan` shapes it); the host reads the pass count
    once, after it."""
    dev = rows_by.device
    e = creator.shape[0]
    n = rows_by.shape[0]
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    for what, t in (("creator", creator), ("index", index), ("sp", sp), ("op", op)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e < 1 or l < 1 or pass_cap < 1:
        raise ValueError("closure_la: needs events, l >= 1 and pass_cap >= 1")
    if n * l + 2 * e >= 1 << 31:
        raise ValueError(f"closure_la: {n} chains of {l} slots and {e} rows pass int32 codes")
    check_smem("closure_la", n)
    plan = closure_la_plan(n, l)
    ld = plan["ld"]
    # the vectors (rows of ld words, padding -1): the chain prefix P's n * l
    # slots, then the two iterates; the segments' maxima, the constant
    # tables (TS, the slots' rows, the loose rows' sources, ident) and the
    # counters, zeroed by the launch (the grid barrier, the pass count, a
    # changed flag a pass, each chain's top slot)
    store = torch.empty((n * l + 2 * e, ld), dtype=torch.int32, device=dev)
    tot = torch.empty((n * plan["groups"] * ld,), dtype=torch.int32, device=dev)
    tables = torch.empty((2 * n * l + e + n,), dtype=torch.int32, device=dev)
    counters = torch.empty((2 + pass_cap + n,), dtype=torch.int32, device=dev)
    _launch("closure_la", dev, (
        creator, index, sp, op, rows_by, store, tot, tables, counters,
        e, n, l, pass_cap, *(plan[k] for k in CLOSURE_PLAN_KEYS),
    ))
    passes = int(counters[1].item())
    row0 = n * l + (passes & 1) * e
    la = store[row0:row0 + e]
    return (la if ld == n else la[:, :n].contiguous()), passes


# closure_la.cu: threads of a block, rows a squaring thread takes, and the
# most slots a prefix thread takes; the plan's keys in the order the C
# entry point takes them
CL_THREADS = 256
CL_ROWS = 4
CL_K_MAX = 16
CLOSURE_PLAN_KEYS = ("ld", "ql", "k", "groups", "ql4", "tile", "smem")


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def closure_la_plan(n: int, l: int) -> Dict[str, int]:
    """K6's launch shape at n validators and l chain slots
    (csrc/closure_la.cu ClPlan): rows of ld = n rounded up to 4 words; the
    prefix's blocks take ql coordinate lanes by CL_THREADS / ql slot lanes,
    k slots a thread (a segment of (CL_THREADS / ql) * k slots, about 16
    segments a chain: `groups`); the squaring's blocks take ql4 lanes of 4
    coordinates by CL_THREADS / ql4 row groups of CL_ROWS rows (a tile);
    smem is a block's shared memory in bytes."""
    ld = (n + 3) // 4 * 4
    ql = min(CL_THREADS, _pow2_ceil(ld))
    sl = CL_THREADS // ql
    k = max(1, min(CL_K_MAX, l // (sl * 16)))
    groups = -(-l // (sl * k))
    ql4 = min(64, _pow2_ceil(ld // 4))
    tile = CL_THREADS // ql4 * CL_ROWS
    smem = (2 * CL_THREADS + n + 2 * tile + n * (tile + 1)) * 4
    return dict(ld=ld, ql=ql, k=k, groups=groups, ql4=ql4, tile=tile, smem=smem)


# walk_chunk.cu's three forms (walk_chunk_plan chooses): the one-block
# walk (walk_chunk_tree, a warp per chain) up to WC_BLOCK_MAX validators;
# from there, below WC_L2_FROM and while a cluster holds the step's
# frontier table, the cluster form (walk_chunk_cluster: clusters of up to
# WC_CLUSTER_MAX blocks that split the table by witness columns;
# WC_GRID_THREADS threads a block, WC_GRID_THREADS_WIDE in clusters of 4 or
# 8, whose blocks count more probe rows a column: 10.2 -> 7.0 ms a chunk at
# 512 validators on the H100, while at 96 the larger block lost 0.44 ->
# 0.47; chains per block sized for the blocks the card holds at once in
# such clusters, _wc_resident_blocks; WC_SLOT_CHUNK probe rows a thread
# counts at once); from WC_L2_FROM, or past a cluster's reach, the L2 form
# (walk_chunk_tiles: every chain's probes of a search round counted
# together against the step's table of countable rows, in WC_TILE x
# WC_TILE tiles over a cooperative grid, WC_TILE_THREADS threads and the
# count tile's WC_TILE_SMEM bytes a block at every width) up to
# WC_MAX_WIDTH validators (the widest max_width scans). WC_L2_FROM: on the
# H100 (time_walk_chunk.py --forms --depths, the best depth of each form)
# the L2 form took 0.719 ms a chunk at 512 validators against the cluster
# form's 1.093, 0.890 against 1.505 at 640; the cluster form 0.576 against
# 0.756 at 256 and 0.803 against 0.948 at 448 (at 384 the L2 form won,
# 0.480 against 0.589). The speculative
# tree's depth: the depth walk_chunk_depth takes up to each width, from
# time_walk_chunk.py --depths on the H100 (WC_TREE_DEPTHS for the tree and
# cluster forms, WC_TILE_DEPTHS for the L2 form), and the largest the
# kernels take (a round's verdicts fit a 64-bit mask)
WC_BLOCK_MAX = 32
WC_MAX_WIDTH = 65536
WC_L2_FROM = 512
WC_TREE_DEPTHS = ((8, 4), (16, 3), (32, 1), (48, 4), (64, 3), (128, 2), (448, 1), (512, 2),
                  (WC_MAX_WIDTH, 1))
WC_TILE_DEPTHS = ((512, 2), (WC_MAX_WIDTH, 1))
WC_TREE_DEPTH_MAX = 6
WC_GRID_THREADS = 256
WC_GRID_THREADS_WIDE = 512
WC_CLUSTER_MAX = 8
WC_SLOT_CHUNK = 4
WC_TILE = 64
WC_TILE_THREADS = 256
# common.cuh babble_count_tile_words<64, 64, 3>() int32 words
WC_TILE_SMEM = 3 * (WC_TILE + WC_TILE) * 36 * 4
# the grid forms' barrier count and three step counters at the scratch's end
WC_COUNTERS = 4
# walk_chunk_plan's forms, by their code in csrc/walk_chunk.cu (WC_FORM_*)
WC_FORMS = ("tree", "cluster", "l2")


def walk_chunk_depth(n: int, form: Optional[str] = None) -> int:
    """The speculative tree's depth at n validators: the entry for the least
    width at or above n of WC_TILE_DEPTHS (form "l2") or WC_TREE_DEPTHS
    (the tree and cluster forms)."""
    for width, depth in (WC_TILE_DEPTHS if form == "l2" else WC_TREE_DEPTHS):
        if n <= width:
            return depth
    raise ValueError(f"walk_chunk: the walk takes at most {WC_MAX_WIDTH} validators")


def _walk_np(n: int) -> int:
    """walk_chunk_tree's NP: the power of two at or above n, at least 4 (its
    tables' and staged rows' width in words)."""
    return max(4, _pow2_ceil(n))


def walk_chunk_tree_smem(n: int, depth: int) -> int:
    """walk_chunk.cu walk_chunk_tree's shared memory, in bytes: each
    chain's probed rows of a round (2^d - 1 rows of NP words) and its
    closure terms by leaf (2^d x n words, rounded up to 4)."""
    nodes = (1 << depth) - 1
    return n * (nodes * _walk_np(n) + ((nodes + 1) * n + 3) // 4 * 4) * 4


def _wc_resident_blocks(k: int) -> int:
    """The blocks of over 114 KB of shared memory an H100 holds at once in
    clusters of k, which the cluster form's chains a block are sized for
    (132 for k <= 2, 120 for 4 and 8: 30 and 15 clusters,
    cudaOccupancyMaxActiveClusters on the card; the launcher's grid is
    what the card reports)."""
    return 132 if k <= 2 else 120


def _wc_cluster_smem(n: int, l: int, cw: int, chains: int, slots: int) -> int:
    """walk_chunk.cu walk_chunk_cluster's shared memory, in bytes: the
    table slice's mbarrier (16 bytes), then int32 words: the slice (n x
    cw), its countable flags (cw), the chains' rows_by rows (chains x l,
    rounded up to 4, so that the probe rows start on 16 bytes), the probe
    rows (slots x ld4), their counts (slots x cw), the verdict sums (2 x
    slots, two rounds in rotation), and each chain's lo, hi and length
    (3 x chains)."""
    ld4 = (n + 3) // 4 * 4
    return 16 + 4 * (n * cw + cw + (chains * l + 3) // 4 * 4 + slots * (ld4 + cw + 2)
                     + 3 * chains)


def _wc_cluster_plan(n: int, l: int, depth: int) -> Optional[Dict]:
    """The cluster form's plan (walk_chunk_plan), None where no cluster of
    up to WC_CLUSTER_MAX blocks holds the table."""
    nodes = (1 << depth) - 1
    ld4 = (n + 3) // 4 * 4
    k = 1
    while k <= WC_CLUSTER_MAX:
        cw = ((ld4 + k - 1) // k + 3) // 4 * 4
        if _wc_cluster_smem(n, l, cw, 1, -(-nodes // WC_SLOT_CHUNK) * WC_SLOT_CHUNK) \
                <= MAX_SMEM_BYTES:
            for g in range(-(-n * k // _wc_resident_blocks(k)), 0, -1):
                slots = -(-g * nodes // WC_SLOT_CHUNK) * WC_SLOT_CHUNK
                smem = _wc_cluster_smem(n, l, cw, g, slots)
                if smem <= MAX_SMEM_BYTES:
                    return dict(form="cluster", k=k, cw=cw, chains=g, nodes=nodes, slots=slots,
                                threads=WC_GRID_THREADS if k <= 2 else WC_GRID_THREADS_WIDE,
                                smem=smem, depth=depth)
        k *= 2
    return None


def walk_chunk_plan(n: int, l: int = 1, depth: Optional[int] = None,
                    form: Optional[str] = None) -> Dict:
    """K7's form at n validators and chain length l, which walk_chunk hands
    the launcher as it is: "tree" up to WC_BLOCK_MAX; below WC_L2_FROM the
    least cluster of k blocks (1, 2, 4, 8) whose blocks hold the frontier
    table's slice of cw witness columns (a multiple of 4), with `chains`
    chains a block at once (n * k / _wc_resident_blocks(k), fewer where
    shared memory runs short), `nodes` = 2^depth - 1 probes a chain a round,
    `slots` probe rows (rounded up to WC_SLOT_CHUNK) and `threads` a block;
    from WC_L2_FROM, or past a cluster's reach, "l2": tiles of `chains`
    probe rows x `slots` table slots (WC_TILE each), the table's rows of cw
    = ld4 words, WC_TILE_THREADS threads and WC_TILE_SMEM bytes a block.
    smem: one block's dynamic shared memory in bytes. `form` names a form
    (ValueError where it cannot take n validators); `depth` a tree depth
    (else walk_chunk_depth's for the form). ValueError past WC_MAX_WIDTH."""
    if not 1 <= n <= WC_MAX_WIDTH:
        raise ValueError(f"walk_chunk: {n} validators, outside the 1 to {WC_MAX_WIDTH} it takes")
    if form is not None and form not in WC_FORMS:
        raise ValueError(f"walk_chunk: no form {form!r} (one of {WC_FORMS})")
    if depth is not None and not 1 <= depth <= WC_TREE_DEPTH_MAX:
        raise ValueError(f"walk_chunk: tree depth {depth} outside 1..{WC_TREE_DEPTH_MAX}")
    if n <= WC_BLOCK_MAX:
        if form not in (None, "tree"):
            raise ValueError(f"walk_chunk: the {form} form takes more than {WC_BLOCK_MAX} "
                             f"validators")
        depth = depth or walk_chunk_depth(n)
        return dict(form="tree", k=1, cw=0, chains=n, nodes=(1 << depth) - 1, slots=0,
                    threads=32 * n, smem=walk_chunk_tree_smem(n, depth), depth=depth)
    if form == "tree":
        raise ValueError(f"walk_chunk: the tree form takes at most {WC_BLOCK_MAX} validators")
    if form == "cluster" or (form is None and n < WC_L2_FROM):
        plan = _wc_cluster_plan(n, l, depth or walk_chunk_depth(n))
        if plan is not None:
            return plan
        if form == "cluster":
            raise ValueError(f"walk_chunk: no cluster holds the table of {n} validators "
                             f"(chain length {l})")
    depth = depth or walk_chunk_depth(n, "l2")
    return dict(form="l2", k=1, cw=(n + 3) // 4 * 4, chains=WC_TILE, nodes=(1 << depth) - 1,
                slots=WC_TILE, threads=WC_TILE_THREADS, smem=WC_TILE_SMEM, depth=depth)


def walk_chunk_scratch_words(plan: Dict, n: int, l: int) -> int:
    """The int32 words of walk_chunk's device scratch in `plan`'s form: the
    tree form's chain-order tables la_by and fd_by ((N, l, NP) each) and the
    chain lengths; the cluster form's table and flags (k * cw columns), the
    frontier, m0 and the chain lengths; the L2 form's table (N slots of cw
    words), lo and hi (two rounds each), the verdict sums (three rounds of
    N * nodes), the frontier, m0 and the chain lengths; the grid forms'
    barrier count and step counters (WC_COUNTERS) last."""
    if plan["form"] == "tree":
        return 2 * n * l * _walk_np(n) + n
    if plan["form"] == "cluster":
        cols = plan["k"] * plan["cw"]
        return n * cols + cols + 3 * n + WC_COUNTERS
    return n * plan["cw"] + 4 * n + 3 * n * plan["nodes"] + 3 * n + WC_COUNTERS


def walk_chunk(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
               super_majority: int, l: int, length: int, steps: int,
               use_seeds: bool, depth: Optional[int] = None, form: Optional[str] = None):
    """K7: `length` frontier steps from x0 in one launch, in
    walk_chunk_plan's form (the tree form after a prep launch that lays
    out the chain-order tables); `depth` overrides walk_chunk_depth's tree
    depth and `form` the plan's form. Returns (x_last (N,) int32, xs
    (length, N) int32)."""
    dev = rows_by.device
    n = rows_by.shape[0]
    plan = walk_chunk_plan(n, l, depth, form)
    check_smem("walk_chunk", n, l=l, depth=plan["depth"], form=plan["form"])
    e_fd, e_la = fd.shape[0], la.shape[0]
    check_tensor("inv", inv, torch.int32, (n, n, l), dev)
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    check_tensor("fd", fd, torch.int32, (e_fd, n), dev)
    check_tensor("la", la, torch.int32, (e_la, n), dev)
    check_tensor("x0", x0, torch.int32, (n,), dev)
    check_tensor("seeds", seeds, torch.int32, (length, n), dev)
    check_tensor("r_abs", r_abs, torch.int32, (length,), dev)
    check_tensor("first_nw", first_nw, torch.int32, (n,), dev)
    if length < 1 or l < 1 or e_fd < 1 or e_la < 1:
        raise ValueError("walk_chunk: needs length >= 1, l >= 1 and events")
    x_last = torch.empty((n,), dtype=torch.int32, device=dev)
    xs = torch.empty((length, n), dtype=torch.int32, device=dev)
    scratch = torch.empty((walk_chunk_scratch_words(plan, n, l),), dtype=torch.int32,
                          device=dev)
    _launch("walk_chunk", dev, (
        inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last, xs,
        scratch, n, l, e_fd, e_la, super_majority, length, steps,
        int(use_seeds), plan["depth"], WC_FORMS.index(plan["form"]), plan["k"], plan["cw"],
        plan["chains"], plan["slots"], plan["threads"], plan["smem"],
    ))
    return x_last, xs


def lamport_scan(levels, sp, op, esp, eop, fpin, carry: Optional[str] = None):
    """K8: (E,) int32 lamports by the seeded level recurrence; the carry
    is level_walk_plan's unless `carry` names a form ("shared" or
    "device")."""
    dev = sp.device
    l_lv, n_lvl = levels.shape
    e = sp.shape[0]
    check_tensor("levels", levels, torch.int32, (l_lv, n_lvl), dev)
    for what, t in (("sp", sp), ("op", op), ("esp", esp), ("eop", eop),
                    ("fpin", fpin)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e < 1:
        raise ValueError("lamport_scan: needs events")
    plan = level_walk_plan("lamport_scan", e, 1, n_lvl, carry=carry)
    lp = plan["lamport"]
    lam = torch.empty((e,), dtype=torch.int32, device=dev)
    last_level = torch.empty((), dtype=torch.int32, device=dev)
    table = torch.empty((l_lv * n_lvl * 4,), dtype=torch.int32, device=dev)
    _launch("lamport_scan", dev, (
        levels, sp, op, esp, eop, fpin, lam, last_level, table, l_lv, n_lvl, e,
        lp["warps"], lp["chunk"], WALK_STAGES, int(lp["staged"]), lp["chip"],
        plan["threads"],
    ))
    return lam


def _check_state_scalars(dev, **scalars) -> None:
    for what, (t, dtype) in scalars.items():
        check_tensor(what, t, dtype, (), dev)


def _check_deltas(dev, e_cap, n, la, s_creator, s_index, upd_row, upd_col, upd_val) -> int:
    """K9's own arrays (the state's la, creator and index, the batch's fd
    deltas), beside the state and batch arrays K10 shares with it: U."""
    u = upd_row.shape[0]
    check_tensor("la", la, torch.int32, (e_cap, n), dev)
    check_tensor("s_creator", s_creator, torch.int32, (e_cap,), dev)
    check_tensor("s_index", s_index, torch.int32, (e_cap,), dev)
    for what, t in (("upd_row", upd_row), ("upd_col", upd_col), ("upd_val", upd_val)):
        check_tensor(what, t, torch.int32, (u,), dev)
    return u


def apply_deltas(fd, fd_w, la, creator, index, w_of_row, rows, b_creator,
                 b_index, la_rows, upd_row, upd_col, upd_val) -> None:
    """K9 in a launch of its own, in place: min-scatter the (U,) fd deltas
    into fd (E_cap, N) and, through the pre-batch w_of_row, into fd_w
    (R_cap, N, N); stage the (B,) new rows' la, creator, index and own fd
    cell. The step paths run it as step_levels' phase 0 instead."""
    dev = fd.device
    e_cap, n = fd.shape
    r_cap = fd_w.shape[0]
    b = rows.shape[0]
    check_tensor("fd", fd, torch.int32, (e_cap, n), dev)
    check_tensor("fd_w", fd_w, torch.int32, (r_cap, n, n), dev)
    check_tensor("w_of_row", w_of_row, torch.int32, (e_cap,), dev)
    for what, t in (("rows", rows), ("b_creator", b_creator), ("b_index", b_index)):
        check_tensor(what, t, torch.int32, (b,), dev)
    check_tensor("la_rows", la_rows, torch.int32, (b, n), dev)
    u = _check_deltas(dev, e_cap, n, la, creator, index, upd_row, upd_col, upd_val)
    _launch("apply_deltas", dev, (
        fd, fd_w, la, creator, index, w_of_row, rows, b_creator, b_index,
        la_rows, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, u,
    ))


def _check_level_state(dev, fd, rounds, lamport, witness, wtable, w_of_row,
                       la_w, fd_w, idx_w, coin_w, rounds_decided, last_round,
                       count, stale):
    e_cap, n = fd.shape
    r_cap = wtable.shape[0]
    check_tensor("fd", fd, torch.int32, (e_cap, n), dev)
    for what, t in (("rounds", rounds), ("lamport", lamport), ("w_of_row", w_of_row)):
        check_tensor(what, t, torch.int32, (e_cap,), dev)
    check_tensor("witness", witness, torch.bool, (e_cap,), dev)
    check_tensor("wtable", wtable, torch.int32, (r_cap, n), dev)
    check_tensor("la_w", la_w, torch.int32, (r_cap, n, n), dev)
    check_tensor("fd_w", fd_w, torch.int32, (r_cap, n, n), dev)
    check_tensor("idx_w", idx_w, torch.int32, (r_cap, n), dev)
    check_tensor("coin_w", coin_w, torch.bool, (r_cap, n), dev)
    check_tensor("rounds_decided", rounds_decided, torch.bool, (r_cap,), dev)
    _check_state_scalars(dev, last_round=(last_round, torch.int32),
                         count=(count, torch.int32), stale=(stale, torch.bool))
    return e_cap, n, r_cap


def step_levels(fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w,
                idx_w, coin_w, rounds_decided, last_round, count, stale,
                rows, creator, index, sp_row, op_row, la_rows, coin,
                fixed_round, levels, la, s_creator, s_index, upd_row, upd_col,
                upd_val, super_majority: int, packed: bool = False,
                form: Optional[str] = None) -> None:
    """K9 then K10 in one launch, in place. Phase 0 is K9: the batch's
    (upd_row, upd_col, upd_val) fd deltas min-scattered into fd and
    mirrored into fd_w, the new rows staged into the state's (la,
    s_creator, s_index). Then K10: the batch's (L, W) level table walked
    in order, witness registration, then last_round, count and the
    latches. The packed layout's verdicts are the same, so `packed`
    launches the same kernel and counts it as step_levels/packed. The walk
    is step_levels_form's unless `form` names one ("block" or "grid";
    scripts/time_step_levels.py times both); the grid walk counts under
    "<key>/grid", and raises where the card cannot hold its blocks at
    once. Both walks take K9 as phase 0 (scripts/time_step_levels.py found
    the one launch no slower than K9's own launch before K10 at 32 and 48
    validators, the one-block walk's side of the crossover)."""
    dev = fd.device
    e_cap, n, r_cap = _check_level_state(
        dev, fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w,
        idx_w, coin_w, rounds_decided, last_round, count, stale)
    b = rows.shape[0]
    l_lv, w = levels.shape
    for what, t in (("rows", rows), ("creator", creator), ("index", index),
                    ("sp_row", sp_row), ("op_row", op_row),
                    ("fixed_round", fixed_round)):
        check_tensor(what, t, torch.int32, (b,), dev)
    check_tensor("la_rows", la_rows, torch.int32, (b, n), dev)
    check_tensor("coin", coin, torch.bool, (b,), dev)
    check_tensor("levels", levels, torch.int32, (l_lv, w), dev)
    u = _check_deltas(dev, e_cap, n, la, s_creator, s_index, upd_row, upd_col, upd_val)
    if b < 1 or w < 1:
        raise ValueError("step_levels: needs a non-empty batch and level width")
    form = _check_walk_form("step_levels", form, n, w=w, l_lv=l_lv, b=b, r_cap=r_cap)
    # the grid walk's per-lane c_seen, parent round, self-parent round and
    # lamport, then its barrier count, last-block ticket and round max
    scratch = (torch.empty((4 * w + 3,), dtype=torch.int32, device=dev)
               if form == "grid" else None)
    _launch("step_levels", dev, (
        fd, rounds, lamport, witness.view(torch.uint8), wtable, w_of_row,
        la_w, fd_w, idx_w, coin_w.view(torch.uint8),
        rounds_decided.view(torch.uint8), last_round, count,
        stale.view(torch.uint8), rows, creator, index, sp_row, op_row,
        la_rows, coin.view(torch.uint8), fixed_round, levels, scratch, la, s_creator,
        s_index, upd_row, upd_col, upd_val, e_cap, n, r_cap, b, l_lv, w, super_majority, u,
    ), packed=packed, grid=form == "grid")


def train_levels_scratch_words(kb: int, w: int, r_cap: int, n: int) -> int:
    """Int32 words of train_levels' grid-walk scratch (train_levels.cu
    tl_grid): per lane c_seen, parent round, self-parent round and lamport,
    eight counter words, the rounds and lamport carries (kb each), then the
    witness carry (kb bytes) and the witness-valid copy (r_cap x n bytes)."""
    return 4 * w + 8 + 2 * kb + (kb + r_cap * n + 3) // 4


def train_levels(fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w,
                 idx_w, coin_w, rounds_decided, last_round, count, stale,
                 rows, creator, index, sp_row, op_row, sp_pos, op_pos,
                 la_rows, coin, fixed_round, levels, super_majority: int,
                 packed: bool = False, form: Optional[str] = None) -> None:
    """K11, in place: a train's (T, W) level scan on train-local carries and
    a clamped compare copy of fd_w (scratch), then the bulk registration,
    the write-back and the latches. The packed layout's counts are the same
    integers, so `packed` launches the same kernel and counts it as
    train_levels/packed. The walk is train_levels_form's unless `form`
    names one ("block": the carries in one block's shared memory, or
    "grid": in a scratch; scripts/time_train_levels.py times both); the
    grid walk counts under "<key>/grid", and raises where the card cannot
    hold its blocks at once."""
    dev = fd.device
    e_cap, n, r_cap = _check_level_state(
        dev, fd, rounds, lamport, witness, wtable, w_of_row, la_w, fd_w,
        idx_w, coin_w, rounds_decided, last_round, count, stale)
    kb = rows.shape[0]
    t_lv, w = levels.shape
    for what, t in (("rows", rows), ("creator", creator), ("index", index),
                    ("sp_row", sp_row), ("op_row", op_row), ("sp_pos", sp_pos),
                    ("op_pos", op_pos), ("fixed_round", fixed_round)):
        check_tensor(what, t, torch.int32, (kb,), dev)
    check_tensor("la_rows", la_rows, torch.int32, (kb, n), dev)
    check_tensor("coin", coin, torch.bool, (kb,), dev)
    check_tensor("levels", levels, torch.int32, (t_lv, w), dev)
    if kb < 1 or w < 1:
        raise ValueError("train_levels: needs a non-empty train and level width")
    if e_cap >= 1 << 24:
        raise ValueError("train_levels: event capacity exceeds the 2^24 compare range")
    form = _check_walk_form("train_levels", form, n, kb=kb, w=w, r_cap=r_cap)
    scratch = (torch.empty((train_levels_scratch_words(kb, w, r_cap, n),), dtype=torch.int32,
                           device=dev) if form == "grid" else None)
    fd_cmp = torch.empty((r_cap, n, n), dtype=torch.int32, device=dev)
    _launch("train_levels", dev, (
        fd, rounds, lamport, witness.view(torch.uint8), wtable, w_of_row,
        la_w, fd_w, idx_w, coin_w.view(torch.uint8),
        rounds_decided.view(torch.uint8), last_round, count,
        stale.view(torch.uint8), rows, creator, index, sp_row, op_row, sp_pos,
        op_pos, la_rows, coin.view(torch.uint8), fixed_round, levels, fd_cmp,
        scratch, e_cap, n, r_cap, kb, t_lv, w, super_majority,
    ), packed=packed, grid=form == "grid")


def decide_window(wtable, la_w, fd_w, idx_w, coin_w, fame_decided, famous,
                  rounds_decided, last_round, count, index, creator, rounds,
                  received, stale, fame_lag, super_majority: int,
                  n_participants: int, r_win: int, e_win: int,
                  d_unroll: int, packed: bool = False, lamport=None, witness=None,
                  pack=None, pack_lo: int = 0) -> None:
    """K12, in place: fame over the r_win-round window from the first
    undecided round (freeze mask below it), round received over the
    trailing e_win rows, the stale detector and the fame_lag latch. Its
    tallies are bit words in both layouts, so `packed` launches the same
    kernel and counts it as decide_window/packed. Its launches' shared
    memory is the same at every width (no staging form).

    With `pack` (int32, K13's 4 * e_win + 3 * R_cap * N + 3 words) its
    last two launches also write pack_results' vector of the state they
    leave (rows from the decide's window start, which must be `pack_lo`,
    the host's start clamped as pack_window_start clamps it: the last
    launch traps where the state's count places it elsewhere), reading
    `lamport` and `witness` too; no pack_results launch is counted."""
    dev = wtable.device
    r_cap, n = wtable.shape
    e_cap = index.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_cap, n), dev)
    check_tensor("la_w", la_w, torch.int32, (r_cap, n, n), dev)
    check_tensor("fd_w", fd_w, torch.int32, (r_cap, n, n), dev)
    check_tensor("idx_w", idx_w, torch.int32, (r_cap, n), dev)
    for what, t in (("coin_w", coin_w), ("fame_decided", fame_decided),
                    ("famous", famous)):
        check_tensor(what, t, torch.bool, (r_cap, n), dev)
    check_tensor("rounds_decided", rounds_decided, torch.bool, (r_cap,), dev)
    for what, t in (("index", index), ("creator", creator), ("rounds", rounds),
                    ("received", received)):
        check_tensor(what, t, torch.int32, (e_cap,), dev)
    _check_state_scalars(dev, last_round=(last_round, torch.int32),
                         count=(count, torch.int32), stale=(stale, torch.bool),
                         fame_lag=(fame_lag, torch.bool))
    if not (1 <= r_win <= r_cap and 1 <= e_win <= e_cap) or n_participants < 1:
        raise ValueError("decide_window: windows must fit the capacities")
    if pack is not None:
        check_tensor("lamport", lamport, torch.int32, (e_cap,), dev)
        check_tensor("witness", witness, torch.bool, (e_cap,), dev)
        check_tensor("pack", pack, torch.int32, (4 * e_win + 3 * r_cap * n + 3,), dev)
        if not 0 <= pack_lo <= e_cap - e_win:
            raise ValueError(f"decide_window: pack_lo {pack_lo} must lie in "
                             f"[0, {e_cap - e_win}]")
    words = (n + 31) // 32
    scal = torch.empty((2,), dtype=torch.int32, device=dev)
    ss_bits = torch.empty((r_win, n, words), dtype=torch.int32, device=dev)
    # the vote words of the offsets in turn, and per window round the
    # vote's column blocks not done, with a witness, and finished
    vt0 = torch.empty((r_win, n, words), dtype=torch.int32, device=dev)
    vt1 = torch.empty((r_win, n, words), dtype=torch.int32, device=dev)
    rcnt = torch.empty((3 * r_win,), dtype=torch.int32, device=dev)
    min_la = torch.empty((r_cap, n), dtype=torch.int32, device=dev)
    famous_count = torch.empty((r_cap,), dtype=torch.int32, device=dev)
    i_ok = torch.empty((r_cap,), dtype=torch.uint8, device=dev)
    _launch("decide_window", dev, (
        wtable, la_w, fd_w, idx_w, coin_w.view(torch.uint8),
        fame_decided.view(torch.uint8), famous.view(torch.uint8),
        rounds_decided.view(torch.uint8), last_round, count, index, creator,
        rounds, received, stale.view(torch.uint8), fame_lag.view(torch.uint8),
        scal, ss_bits, vt0, vt1, rcnt, min_la, famous_count, i_ok,
        lamport if pack is not None else None,
        witness.view(torch.uint8) if pack is not None else None, pack,
        e_cap, n, r_cap, r_win, e_win, super_majority,
        n_participants, d_unroll, pack_lo,
    ), packed=packed)


def pack_results(rounds, lamport, witness, received, wtable, fame_decided,
                 famous, stale, fame_lag, last_round, lo: int, e_win: int
                 ) -> torch.Tensor:
    """K13: a fresh int32 vector of 4 * e_win + 3 * R_cap * N + 3 words —
    the (E_cap,) row fields over [lo', lo' + e_win) with lo' = lo (plus
    E_cap when negative) clamped to [0, E_cap - e_win], the three
    (R_cap, N) tables row-major, then
    stale, fame_lag and last_round (0-d tensors, read on the device)."""
    dev = rounds.device
    e_cap = rounds.shape[0]
    r_cap, n = wtable.shape
    for what, t in (("rounds", rounds), ("lamport", lamport), ("received", received)):
        check_tensor(what, t, torch.int32, (e_cap,), dev)
    check_tensor("witness", witness, torch.bool, (e_cap,), dev)
    check_tensor("wtable", wtable, torch.int32, (r_cap, n), dev)
    for what, t in (("fame_decided", fame_decided), ("famous", famous)):
        check_tensor(what, t, torch.bool, (r_cap, n), dev)
    _check_state_scalars(dev, stale=(stale, torch.bool), fame_lag=(fame_lag, torch.bool),
                         last_round=(last_round, torch.int32))
    if not 1 <= e_win <= e_cap:
        raise ValueError(f"pack_results: e_win {e_win} must lie in [1, {e_cap}]")
    out = torch.empty((4 * e_win + 3 * r_cap * n + 3,), dtype=torch.int32, device=dev)
    _launch("pack_results", dev, (
        rounds, lamport, witness.view(torch.uint8), received, wtable,
        fame_decided.view(torch.uint8), famous.view(torch.uint8),
        stale.view(torch.uint8), fame_lag.view(torch.uint8), last_round, out,
        lo, e_cap, e_win, r_cap, n,
    ))
    return out


def frontier_append(la, creator, index, lamport, coin, rows_by, inv, dirty, count,
                    l_over, t_rows, t_creator, t_index, t_lamport, t_coin, t_sp_row,
                    t_sp_pos, t_la_rows) -> None:
    """K14, in place: a train's INV scatter-min and the dirty planes'
    re-closure, the rows' staging, rows_by, dirty, count and l_over."""
    dev = la.device
    e_cap, n = la.shape
    l = rows_by.shape[1]
    kb = t_rows.shape[0]
    check_tensor("la", la, torch.int32, (e_cap, n), dev)
    for what, t in (("creator", creator), ("index", index), ("lamport", lamport)):
        check_tensor(what, t, torch.int32, (e_cap,), dev)
    check_tensor("coin", coin, torch.bool, (e_cap,), dev)
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    check_tensor("inv", inv, torch.int32, (n, n, l), dev)
    check_tensor("dirty", dirty, torch.bool, (n,), dev)
    _check_state_scalars(dev, count=(count, torch.int32), l_over=(l_over, torch.bool))
    for what, t in (("t_rows", t_rows), ("t_creator", t_creator), ("t_index", t_index),
                    ("t_lamport", t_lamport), ("t_sp_row", t_sp_row),
                    ("t_sp_pos", t_sp_pos)):
        check_tensor(what, t, torch.int32, (kb,), dev)
    check_tensor("t_coin", t_coin, torch.bool, (kb,), dev)
    check_tensor("t_la_rows", t_la_rows, torch.int32, (kb, n), dev)
    if kb < 1 or l < 1:
        raise ValueError("frontier_append: needs a non-empty train and index axis")
    last_pos = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch("frontier_append", dev, (
        la, creator, index, lamport, coin.view(torch.uint8), rows_by, inv,
        dirty.view(torch.uint8), count, l_over.view(torch.uint8), last_pos, t_rows,
        t_creator, t_index, t_lamport, t_coin.view(torch.uint8), t_sp_row, t_sp_pos,
        t_la_rows, e_cap, n, l, kb,
    ))


def frontier_window(inv, rows_by, x_hist, dirty, creator, index, coin, la, r_over,
                    super_majority: int, r_win: int):
    """K15: the frontier-live decide's windowed walk (one cooperative
    launch that stops at its fixed point), post pass and witness tables.
    Returns (x_hist, r_over, rounds, witness, wtable, last_round, la_w,
    idx_w, coin_w, fd_w, wtable_c), fresh tensors: x_hist with the window's
    rows rewritten, r_over the input's latched by the window."""
    dev = inv.device
    n, l = rows_by.shape
    r_cap = x_hist.shape[0]
    e_cap = la.shape[0]
    check_tensor("inv", inv, torch.int32, (n, n, l), dev)
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    check_tensor("x_hist", x_hist, torch.int32, (r_cap, n), dev)
    check_tensor("dirty", dirty, torch.bool, (n,), dev)
    for what, t in (("creator", creator), ("index", index)):
        check_tensor(what, t, torch.int32, (e_cap,), dev)
    check_tensor("coin", coin, torch.bool, (e_cap,), dev)
    check_tensor("la", la, torch.int32, (e_cap, n), dev)
    _check_state_scalars(dev, r_over=(r_over, torch.bool))
    if not 1 <= r_win <= r_cap or e_cap < 1 or l < 1:
        raise ValueError("frontier_window: needs 1 <= r_win <= r_cap, rows and an index axis")
    i32 = dict(dtype=torch.int32, device=dev)
    x_out = torch.empty((r_cap, n), **i32)
    scratch = torch.empty((walk_scratch_words(n, n, r_win, last_row=True),), **i32)
    r_over_out = torch.empty_like(r_over)
    rounds = torch.empty((e_cap,), **i32)
    witness = torch.empty((e_cap,), dtype=torch.uint8, device=dev)
    wtable = torch.empty((r_cap, n), **i32)
    last_round = torch.empty((), **i32)
    la_w = torch.empty((r_cap, n, n), **i32)
    idx_w = torch.empty((r_cap, n), **i32)
    coin_w = torch.empty((r_cap, n), dtype=torch.uint8, device=dev)
    fd_w = torch.empty((r_cap, n, n), **i32)
    wtable_c = torch.empty((r_cap, n), **i32)
    _launch("frontier_window", dev, (
        inv, rows_by, x_hist, dirty.view(torch.uint8), creator, index,
        coin.view(torch.uint8), la, r_over.view(torch.uint8), x_out, scratch,
        r_over_out.view(torch.uint8), rounds, witness, wtable, last_round, la_w, idx_w,
        coin_w, fd_w, wtable_c, n, l, e_cap, r_cap, r_win, super_majority,
    ))
    return (x_out, r_over_out, rounds, witness.view(torch.bool), wtable, last_round,
            la_w, idx_w, coin_w.view(torch.bool), fd_w, wtable_c)


# ---------------------------------------------------------------------------
# the device mesh (tpu/sharded.py): one position's shard per launch
# ---------------------------------------------------------------------------


def fame_setup(wtable, la, fd, index, super_majority: int, packed: bool = False):
    """K3's setup alone (babble_fame_setup): (ss, votes0). Wide: two (R, N,
    N) bool tensors; packed: ss (R, N, W) and votes0 (R, N_x, W) int32
    words."""
    dev = wtable.device
    r_max, n = wtable.shape
    e = la.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e, n), dev)
    check_tensor("fd", fd, torch.int32, (e, n), dev)
    check_tensor("index", index, torch.int32, (e,), dev)
    if e < 1 or r_max < 1:
        raise ValueError("fame_setup: needs events and rounds")
    words = (n + 31) // 32
    if packed:
        ss = torch.empty((r_max, n, words), dtype=torch.int32, device=dev)
        votes = torch.empty((r_max, n, words), dtype=torch.int32, device=dev)
    else:
        ss = torch.empty((r_max, n, n), dtype=torch.uint8, device=dev)
        votes = torch.empty((r_max, n, n), dtype=torch.uint8, device=dev)
    _launch("fame_setup", dev, (
        wtable, la, fd, index, ss, votes, r_max, n, e, super_majority, int(packed),
    ), packed=packed)
    if packed:
        return ss, votes
    return ss.view(torch.bool), votes.view(torch.bool)


def shard_fame_tally(ss_s, votes, i_rows, last_round, d: int, packed: bool):
    """B21 (a): (yays (B, N_y, N_x), total (B, N_y)) int32 of one voting step
    on a position's shard. Wide: ss_s (B, N_y, N_w) bool, votes (B, N_w,
    N_x) bool; packed: ss_s (B, N_y, W_l), votes (B, N_x, W_l) int32 words."""
    dev = ss_s.device
    b, ny, nw = ss_s.shape
    nx = votes.shape[1] if packed else votes.shape[2]
    dtype = torch.int32 if packed else torch.bool
    check_tensor("ss_s", ss_s, dtype, (b, ny, nw), dev)
    check_tensor("votes", votes, dtype, (b, nx, nw) if packed else (b, nw, nx), dev)
    check_tensor("i_rows", i_rows, torch.int32, (b,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if b < 1 or ny < 1 or nx < 1 or ny > 65535:
        raise ValueError(f"shard_fame/tally: unsupported shard shape {(b, ny, nw, nx)}")
    yays = torch.empty((b, ny, nx), dtype=torch.int32, device=dev)
    total = torch.empty((b, ny), dtype=torch.int32, device=dev)
    if not packed:
        ss_s, votes = ss_s.view(torch.uint8), votes.view(torch.uint8)
    _launch("shard_fame/tally", dev, (
        ss_s, votes, i_rows, last_round, yays, total, b, ny, nw, nx, d, int(packed),
    ), packed=packed)
    return yays, total


def shard_fame_decide(yays, total, i_rows, last_round, wvalid, decided, famous, wv_s,
                      coin_s, votes, v_off: int, d: int, n_participants: int,
                      super_majority: int, packed: bool) -> None:
    """B21 (b), in place: decided, famous and the shard's slice of the next
    votes (rows, or words, [v_off, v_off + the shard's extent))."""
    dev = yays.device
    b, ny, nx = yays.shape
    v_len = votes.shape[2] if packed else votes.shape[1]
    check_tensor("yays", yays, torch.int32, (b, ny, nx), dev)
    check_tensor("total", total, torch.int32, (b, ny), dev)
    check_tensor("i_rows", i_rows, torch.int32, (b,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    for what, t in (("wvalid", wvalid), ("decided", decided), ("famous", famous)):
        check_tensor(what, t, torch.bool, (b, nx), dev)
    for what, t in (("wv_s", wv_s), ("coin_s", coin_s)):
        check_tensor(what, t, torch.bool, (b, ny), dev)
    if packed:
        check_tensor("votes", votes, torch.int32, (b, nx, v_len), dev)
        if ny % 32 or (v_off + v_len) * 32 > ny:
            raise ValueError("shard_fame/decide: packed voters must fill whole words")
    else:
        check_tensor("votes", votes, torch.bool, (b, v_len, nx), dev)
        if v_off + v_len > ny:
            raise ValueError("shard_fame/decide: the vote slice passes the voters")
    if n_participants < 1:
        raise ValueError("shard_fame/decide: needs n_participants >= 1")
    _launch("shard_fame/decide", dev, (
        yays, total, i_rows, last_round, wvalid.view(torch.uint8),
        decided.view(torch.uint8), famous.view(torch.uint8), wv_s.view(torch.uint8),
        coin_s.view(torch.uint8), votes if packed else votes.view(torch.uint8),
        b, ny, nx, v_off, v_len, d, n_participants, super_majority, int(packed),
    ), packed=packed)


def shard_fame_active(wvalid, decided, i_rows, last_round, d0: int) -> torch.Tensor:
    """B21 (c): a (1,) int32 flag, 1 where a valid undecided witness of the
    shard has a voting round i + d0 <= last_round left."""
    dev = wvalid.device
    b, nx = wvalid.shape
    check_tensor("wvalid", wvalid, torch.bool, (b, nx), dev)
    check_tensor("decided", decided, torch.bool, (b, nx), dev)
    check_tensor("i_rows", i_rows, torch.int32, (b,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    _launch("shard_fame/active", dev, (
        wvalid.view(torch.uint8), decided.view(torch.uint8), i_rows, last_round, flag,
        b, nx, d0,
    ))
    return flag


def shard_fame_grid(ss_parts, votes_parts, wv_parts, coin_parts, wvalid_parts,
                    decided_parts, famous_parts, n_v: int, last_round, n_participants: int,
                    super_majority: int, packed: bool) -> None:
    """B21's whole fame loop in one launch (shard_fame/grid), every position
    on one device, in place on decided_parts and famous_parts. The lists
    hold each position's shards in (rounds index, validator index) order,
    n_v validator positions to a rounds index: ss_s (B, N_y, W_l) words or
    (B, N_y, N_w) bool; votes (B, N_x, W_l) words or (B, N_w, N_x) bool;
    wv_s, coin_s (B, N_y) bool; wvalid, decided, famous (B, N_x) bool. The
    addresses reach the launch as a (7, n_pos) table copied to the device,
    one copy a call. ValueError past 32 * FV_MAX_WORDS voters
    (shard_fame_form then names the per-step form)."""
    parts = (ss_parts, votes_parts, wv_parts, coin_parts, wvalid_parts, decided_parts,
             famous_parts)
    n_pos = len(ss_parts)
    if n_pos < 1 or n_v < 1 or n_pos % n_v or any(len(p) != n_pos for p in parts):
        raise ValueError("shard_fame/grid: one shard of each table per position, n_v "
                         "validator positions to a rounds index")
    dev = ss_parts[0].device
    b, ny, nw_l = ss_parts[0].shape
    n_x = wvalid_parts[0].shape[1]
    dtype = torch.int32 if packed else torch.bool
    if ny != (32 if packed else 1) * n_v * nw_l:
        raise ValueError(f"shard_fame/grid: {ny} voter rows against {n_v} shards of {nw_l} "
                         f"witness {'words' if packed else 'columns'}")
    words = n_v * nw_l if packed else -(-(n_v * nw_l) // 32)
    if not 1 <= words <= FV_MAX_WORDS:
        raise ValueError(f"shard_fame/grid: {ny} voters; the vote holds at most "
                         f"{32 * FV_MAX_WORDS}")
    for k in range(n_pos):
        check_tensor(f"ss_s[{k}]", ss_parts[k], dtype, (b, ny, nw_l), dev)
        check_tensor(f"votes[{k}]", votes_parts[k], dtype,
                     (b, n_x, nw_l) if packed else (b, nw_l, n_x), dev)
        for what, t in (("wv_s", wv_parts[k]), ("coin_s", coin_parts[k])):
            check_tensor(f"{what}[{k}]", t, torch.bool, (b, ny), dev)
        for what, t in (("wvalid", wvalid_parts[k]), ("decided", decided_parts[k]),
                        ("famous", famous_parts[k])):
            check_tensor(f"{what}[{k}]", t, torch.bool, (b, n_x), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if n_participants < 1:
        raise ValueError("shard_fame/grid: needs n_participants >= 1")
    plan = fame_vote_plan(words)
    r_pad = (n_pos // n_v) * b
    ss_k = torch.empty((r_pad, plan["n_pad"], plan["ldw"]), dtype=torch.int32, device=dev)
    aux_k = torch.empty((r_pad, plan["n_pad"]), dtype=torch.int32, device=dev)
    vt = torch.empty((r_pad, n_x, words), dtype=torch.int32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    addrs = torch.tensor([t.data_ptr() for group in parts for t in group], dtype=torch.int64)
    ptrs = addrs.pin_memory().to(dev, non_blocking=True)
    _launch("shard_fame/grid", dev, (
        ptrs, ss_k, aux_k, vt, bar, last_round, n_pos, n_v, b, ny, nw_l, n_x, int(packed),
        n_participants, super_majority,
    ), packed=packed)


def fame_tables(wtable, la, decided, famous, last_round):
    """B23: (min_la (R, N) int32, famous_count (R,) int32, i_ok (R,) bool,
    horizon (R,) int32, rounds_decided (R,) bool), in one launch of K4's
    tables (received_tables_plan)."""
    dev = wtable.device
    r_max, n = wtable.shape
    e_la = la.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e_la, n), dev)
    check_tensor("decided", decided, torch.bool, (r_max, n), dev)
    check_tensor("famous", famous, torch.bool, (r_max, n), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if e_la < 1 or r_max < 1:
        raise ValueError("fame_tables: needs la rows and rounds")
    plan = received_tables_plan(n, r_max)
    min_la = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    famous_count = torch.empty((r_max,), dtype=torch.int32, device=dev)
    i_ok = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    horizon = torch.empty((r_max,), dtype=torch.int32, device=dev)
    rounds_decided = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    _launch("fame_tables", dev, (
        wtable, la, decided.view(torch.uint8), famous.view(torch.uint8), last_round,
        min_la, famous_count, i_ok, horizon, rounds_decided, sync_words(dev), r_max,
        n, e_la, plan["slices"], plan["wps"],
    ))
    return (min_la, famous_count, i_ok.view(torch.bool), horizon,
            rounds_decided.view(torch.bool))


def fame_received(wtable, la, decided, famous, last_round, index, creator, rounds):
    """B23 and B22 in one launch (every position of the mesh on one card):
    fame_tables' five tables, then received (E,) int32 over the unsharded
    event axis (index, creator, rounds (E,) int32), in its order."""
    dev = wtable.device
    r_max, n = wtable.shape
    e_la = la.shape[0]
    e = index.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e_la, n), dev)
    check_tensor("decided", decided, torch.bool, (r_max, n), dev)
    check_tensor("famous", famous, torch.bool, (r_max, n), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    for what, t in (("index", index), ("creator", creator), ("rounds", rounds)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e_la < 1 or r_max < 1:
        raise ValueError("fame_received: needs la rows and rounds")
    plan = received_tables_plan(n, r_max)
    min_la = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    famous_count = torch.empty((r_max,), dtype=torch.int32, device=dev)
    i_ok = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    horizon = torch.empty((r_max,), dtype=torch.int32, device=dev)
    rounds_decided = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    received = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch("fame_received", dev, (
        wtable, la, decided.view(torch.uint8), famous.view(torch.uint8), last_round, index,
        creator, rounds, min_la, famous_count, i_ok, horizon, rounds_decided, received,
        sync_words(dev), r_max, n, e, e_la, plan["slices"], plan["wps"],
    ))
    return (min_la, famous_count, i_ok.view(torch.bool), horizon,
            rounds_decided.view(torch.bool), received)


def received_search(index, creator, rounds, min_la, famous_count, i_ok, horizon):
    """B22: received (E_s,) int32 of one event shard."""
    dev = index.device
    e = index.shape[0]
    r_max, n = min_la.shape
    for what, t in (("index", index), ("creator", creator), ("rounds", rounds)):
        check_tensor(what, t, torch.int32, (e,), dev)
    check_tensor("min_la", min_la, torch.int32, (r_max, n), dev)
    check_tensor("famous_count", famous_count, torch.int32, (r_max,), dev)
    check_tensor("i_ok", i_ok, torch.bool, (r_max,), dev)
    check_tensor("horizon", horizon, torch.int32, (r_max,), dev)
    received = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch("received_search", dev, (
        index, creator, rounds, min_la, famous_count, i_ok.view(torch.uint8), horizon,
        received, r_max, n, e,
    ))
    return received


def shard_walk_rows(rows_by, fd, x_cur):
    """B24 (a): the local chains' frontier rows (B, N_p) int32 (MAX where
    X = L) and w_ok (B,) bool."""
    dev = rows_by.device
    b, l = rows_by.shape
    e_fd, n_p = fd.shape
    check_tensor("rows_by", rows_by, torch.int32, (b, l), dev)
    check_tensor("fd", fd, torch.int32, (e_fd, n_p), dev)
    check_tensor("x_cur", x_cur, torch.int32, (b,), dev)
    if e_fd < 1 or l < 1:
        raise ValueError("shard_walk/rows: needs fd rows and an index axis")
    fd_w = torch.empty((b, n_p), dtype=torch.int32, device=dev)
    w_ok = torch.empty((b,), dtype=torch.uint8, device=dev)
    _launch("shard_walk/rows", dev, (rows_by, fd, x_cur, fd_w, w_ok, b, n_p, l, e_fd))
    return fd_w, w_ok.view(torch.bool)


def shard_walk_m0(inv, fd_w, w_ok, super_majority: int) -> torch.Tensor:
    """B24 (b): m0 (B,) int32 of the local chains from the gathered
    frontier rows fd_w (N_w, N_p) and w_ok (N_w,)."""
    dev = inv.device
    b, n_p, l = inv.shape
    n_w = fd_w.shape[0]
    check_tensor("inv", inv, torch.int32, (b, n_p, l), dev)
    check_tensor("fd_w", fd_w, torch.int32, (n_w, n_p), dev)
    check_tensor("w_ok", w_ok, torch.bool, (n_w,), dev)
    if (n_w + 8 * n_p) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"shard_walk/m0: {n_w} frontier rows of {n_p} coordinates pass "
                         f"one block's shared memory")
    m0 = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("shard_walk/m0", dev, (inv, fd_w, w_ok.view(torch.uint8), m0, b, n_w, n_p, l,
                                   super_majority))
    return m0


def shard_walk_close(inv, m0_all, x_cur, x_next, c_off: int) -> None:
    """B24 (c), into x_next: the closure of the local chains over the
    gathered m0 (its first N_p entries are the coordinates)."""
    dev = inv.device
    b, n_p, l = inv.shape
    n_all = m0_all.shape[0]
    check_tensor("inv", inv, torch.int32, (b, n_p, l), dev)
    check_tensor("m0_all", m0_all, torch.int32, (n_all,), dev)
    check_tensor("x_cur", x_cur, torch.int32, (b,), dev)
    check_tensor("x_next", x_next, torch.int32, (b,), dev)
    if n_all < n_p or c_off + b > n_all:
        raise ValueError("shard_walk/close: the gathered m0 does not cover the chains")
    _launch("shard_walk/close", dev, (inv, m0_all, x_cur, x_next, b, n_p, l, c_off))


# B24's two forms on a mesh (sharded.local_walk): the whole walk in one
# cooperative launch ("grid", shard_walk) where every position lies on one
# device, whatever their number, the three per-step kernels ("step") where
# positions lie on distinct cards
SHARD_WALK_FORMS = ("step", "grid")


def shard_walk_form(devices: Sequence) -> str:
    """The form of B24 for a mesh whose positions lie on `devices` (the one
    place it is chosen, by layout alone): "grid" where they all lie on one
    device, "step" where they lie on distinct cards."""
    def card(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return "grid" if len({card(d) for d in devices}) == 1 else "step"


def shard_fame_form(devices: Sequence, n_voters: int) -> str:
    """The form of B21 for a mesh whose positions lie on `devices`, voting
    with n_voters voters: shard_walk_form's, except that the one launch
    ("grid") takes at most 32 * FV_MAX_WORDS voters and the per-step form
    ("step") any number."""
    form = shard_walk_form(devices)
    return "step" if form == "grid" and -(-n_voters // 32) > FV_MAX_WORDS else form


def shard_walk(inv_parts, rb_parts, fd, x0_parts, super_majority: int,
               r_cap: int) -> List[torch.Tensor]:
    """B24 in one launch: x_hist (r_cap, B) int32 of every position, whose
    INV slices (B, N_p, L), chain tables (B, L) and X(0) (B,) are given in
    gather order, all on one device with the replicated fd (E, N_p). The
    walk stops at its fixed point and repeats it to row r_cap - 1. The
    positions' addresses reach the launch as a (4, n_pos) table copied to
    the device, one copy a call."""
    n_pos = len(inv_parts)
    if n_pos < 1 or not len(rb_parts) == len(x0_parts) == n_pos:
        raise ValueError("shard_walk/grid: one INV slice, chain table and X(0) per position")
    dev = fd.device
    b, n_p, l = inv_parts[0].shape
    e_fd = fd.shape[0]
    check_tensor("fd", fd, torch.int32, (e_fd, n_p), dev)
    for k in range(n_pos):
        check_tensor(f"inv[{k}]", inv_parts[k], torch.int32, (b, n_p, l), dev)
        check_tensor(f"rows_by[{k}]", rb_parts[k], torch.int32, (b, l), dev)
        check_tensor(f"x0[{k}]", x0_parts[k], torch.int32, (b,), dev)
    n_w = n_pos * b
    if e_fd < 1 or l < 1 or b < 1 or r_cap < 1 or n_p > n_w:
        raise ValueError("shard_walk/grid: needs fd rows, an index axis, chains for every "
                         "coordinate and a history")
    hist = [torch.empty((r_cap, b), dtype=torch.int32, device=dev) for _ in range(n_pos)]
    addrs = torch.tensor([t.data_ptr() for parts in (inv_parts, rb_parts, x0_parts, hist)
                          for t in parts], dtype=torch.int64)
    ptrs = addrs.pin_memory().to(dev, non_blocking=True)
    scratch = torch.empty((walk_scratch_words(n_w, n_p, r_cap - 1),), dtype=torch.int32,
                          device=dev)
    _launch("shard_walk/grid", dev, (ptrs, fd, scratch, n_pos, b, n_p, l, e_fd, r_cap,
                                     super_majority))
    return hist


def frontier_post(x_hist, rows_by, creator, index, sp_index):
    """K2's post pass alone: (rounds (E,) int32, witness (E,) bool, wtable
    (r_cap, N) int32, last_round () int32) from a frontier history."""
    dev = x_hist.device
    r_cap, n = x_hist.shape
    l = rows_by.shape[1]
    e = creator.shape[0]
    check_tensor("x_hist", x_hist, torch.int32, (r_cap, n), dev)
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    for what, t in (("creator", creator), ("index", index), ("sp_index", sp_index)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if r_cap < 1 or n < 1 or l < 1:
        raise ValueError("frontier_post: needs a history and chains")
    rounds = torch.empty((e,), dtype=torch.int32, device=dev)
    witness = torch.empty((e,), dtype=torch.uint8, device=dev)
    wtable = torch.empty((r_cap, n), dtype=torch.int32, device=dev)
    last_round = torch.empty((), dtype=torch.int32, device=dev)
    _launch("frontier_post", dev, (
        x_hist, rows_by, creator, index, sp_index, rounds, witness, wtable, last_round,
        n, l, e, r_cap,
    ))
    return rounds, witness.view(torch.bool), wtable, last_round
