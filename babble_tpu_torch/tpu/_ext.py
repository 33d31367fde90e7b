"""Build, load and launch the port's CUDA kernels.

Each source under `babble_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface, at first
use, into `build/torch_kernels/` at the repository root (one `nvcc` per
source, all started together). The libraries are loaded with ctypes.
Nothing here runs at import: the CPU tests import every module, and a
host without a card never reaches the build.

Every launch function checks device, dtype, shape and contiguity of its
tensors, allocates its outputs and scratch with `torch.empty`, launches on
PyTorch's current stream, raises if the C entry point returns a CUDA
error, and only then adds one to its kernel's count in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

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
    "build_inv": ("build_inv.cu", "babble_build_inv", "ppp" "iiii"),
    "frontier_rounds": (
        "frontier_walk.cu", "babble_frontier_rounds", "pppppppppppp" "iiiiii",
    ),
    "decide_fame": ("decide_fame.cu", "babble_decide_fame", "ppppppppppp" "iiiiii"),
    "round_received": (
        "round_received.cu", "babble_round_received", "pppppppppppppp" "iiii",
    ),
    "divide_rounds": (
        "divide_rounds.cu", "babble_divide_rounds", "ppppppppppppppppp" "iiiiii",
    ),
    "closure_la": (
        "closure_la.cu", "babble_closure_la_pass", "pppppppppp" "iiii",
    ),
    "walk_chunk": (
        "walk_chunk.cu", "babble_walk_chunk", "pppppppppp" "iiiiiiii",
    ),
    "lamport_scan": (
        "lamport_scan.cu", "babble_lamport_scan", "pppppppp" "iii",
    ),
}

# largest dynamic shared memory one block may use on an H100
MAX_SMEM_BYTES = 232448

# launches of each kernel's C entry point since the last reset
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_LIBS: Dict[str, ctypes.CDLL] = {}


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
    for f in (CSRC / "common.cuh", CSRC / source):
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
    for name, (src, _, _) in KERNELS.items():
        out = paths[name]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{KERNELS[name][0]} (rc {proc.returncode}):\n{log}")
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


def _launch(name: str, device: torch.device, args: Sequence) -> None:
    lib = _lib(name)
    _, fn, kinds = KERNELS[name]
    if len(args) != len(kinds):
        raise TypeError(f"{fn}: {len(args)} arguments, expected {len(kinds)}")
    c_args = [
        a.data_ptr() if k == "p" else int(a) for a, k in zip(args, kinds)
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*c_args, device.index or 0, stream)
    if rc != 0:
        msg = lib.babble_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def build_inv(rows_by: torch.Tensor, la: torch.Tensor) -> torch.Tensor:
    """K1: INV (N_c, N_p, L) int32 from rows_by (N_c, L) and la (E, N_p)."""
    dev = rows_by.device
    n_c, l = rows_by.shape
    e, n_p = la.shape
    check_tensor("rows_by", rows_by, torch.int32, (n_c, l), dev)
    check_tensor("la", la, torch.int32, (e, n_p), dev)
    inv = torch.empty((n_c, n_p, l), dtype=torch.int32, device=dev)
    _launch("build_inv", dev, (rows_by, la, inv, n_c, l, n_p, e))
    return inv


def frontier_rounds(inv, rows_by, creator, index, sp_index, fd,
                    super_majority: int, r_cap: int):
    """K2: the r_cap-step frontier walk and its post pass. Returns
    (rounds (E,) int32, witness (E,) bool, wtable (r_cap, N) int32,
    last_round () int32)."""
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
    m0 = torch.empty((n,), dtype=torch.int32, device=dev)
    rounds = torch.empty((e,), dtype=torch.int32, device=dev)
    witness = torch.empty((e,), dtype=torch.uint8, device=dev)
    wtable = torch.empty((r_cap, n), dtype=torch.int32, device=dev)
    last_round = torch.empty((), dtype=torch.int32, device=dev)
    _launch("frontier_rounds", dev, (
        inv, rows_by, creator, index, sp_index, fd, x_hist, m0, rounds,
        witness, wtable, last_round, n, l, e, e_fd, super_majority, r_cap,
    ))
    return rounds, witness.view(torch.bool), wtable, last_round


def decide_fame(wtable, la, fd, index, coin_bit, last_round,
                super_majority: int, n_participants: int, d_cap: int):
    """K3: virtual voting. Returns (decided (R, N) bool, famous (R, N)
    bool, rounds_decided (R,) bool)."""
    dev = wtable.device
    r_max, n = wtable.shape
    e = la.shape[0]
    check_tensor("wtable", wtable, torch.int32, (r_max, n), dev)
    check_tensor("la", la, torch.int32, (e, n), dev)
    check_tensor("fd", fd, torch.int32, (e, n), dev)
    check_tensor("index", index, torch.int32, (e,), dev)
    check_tensor("coin_bit", coin_bit, torch.bool, (e,), dev)
    check_tensor("last_round", last_round, torch.int32, (), dev)
    if e < 1 or n_participants < 1:
        raise ValueError("decide_fame: needs events and n_participants >= 1")
    ss = torch.empty((r_max, n, n), dtype=torch.uint8, device=dev)
    votes = torch.empty((r_max, 2, n, n), dtype=torch.uint8, device=dev)
    decided = torch.empty((r_max, n), dtype=torch.uint8, device=dev)
    famous = torch.empty((r_max, n), dtype=torch.uint8, device=dev)
    rounds_decided = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    _launch("decide_fame", dev, (
        wtable, la, fd, index, coin_bit.view(torch.uint8), last_round, ss,
        votes, decided, famous, rounds_decided, r_max, n, e, super_majority,
        n_participants, d_cap,
    ))
    return (decided.view(torch.bool), famous.view(torch.bool),
            rounds_decided.view(torch.bool))


def round_received(wtable, la, index, creator, rounds, decided, famous,
                   rounds_decided, last_round) -> torch.Tensor:
    """K4: round-received per event, (E,) int32, -1 while undetermined."""
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
    min_la = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    famous_count = torch.empty((r_max,), dtype=torch.int32, device=dev)
    i_ok = torch.empty((r_max,), dtype=torch.uint8, device=dev)
    horizon = torch.empty((r_max,), dtype=torch.int32, device=dev)
    received = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch("round_received", dev, (
        wtable, la, index, creator, rounds, decided.view(torch.uint8),
        famous.view(torch.uint8), rounds_decided.view(torch.uint8), last_round,
        min_la, famous_count, i_ok, horizon, received, r_max, n, e, e_la,
    ))
    return received


def divide_rounds(levels, creator, index, self_parent, other_parent, la, fd,
                  ext_sp_round, ext_op_round, fixed_round, ext_sp_lamport,
                  ext_op_lamport, fixed_lamport, super_majority: int,
                  r_max: int):
    """K5: the level scan. Returns (rounds (E,) int32, witness (E,) bool,
    lamport (E,) int32, wtable (r_max, N) int32). `index` is not read (the
    reference's signature carries it)."""
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
    warps = min(max(n_lvl, 1), 32)
    if (3 * n_lvl + warps * 2 * n) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"divide_rounds: {n} validators exceed one block's shared memory")
    rounds = torch.empty((e,), dtype=torch.int32, device=dev)
    witness = torch.empty((e,), dtype=torch.uint8, device=dev)
    lamport = torch.empty((e,), dtype=torch.int32, device=dev)
    wtable = torch.empty((r_max, n), dtype=torch.int32, device=dev)
    last_level = torch.empty((), dtype=torch.int32, device=dev)
    _launch("divide_rounds", dev, (
        levels, creator, self_parent, other_parent, la, fd, ext_sp_round,
        ext_op_round, fixed_round, ext_sp_lamport, ext_op_lamport,
        fixed_lamport, rounds, witness, lamport, wtable, last_level,
        l_lv, n_lvl, e, n, super_majority, r_max,
    ))
    return rounds, witness.view(torch.bool), lamport, wtable


def closure_la(creator, index, sp, op, rows_by, l: int, pass_cap: int):
    """K6: lastAncestors (E, N) int32 by pointer doubling, and the pass
    count. One launch per pass; the host reads the changed flag after each
    (one device-to-host copy per pass, at most pass_cap)."""
    dev = rows_by.device
    e = creator.shape[0]
    n = rows_by.shape[0]
    check_tensor("rows_by", rows_by, torch.int32, (n, l), dev)
    for what, t in (("creator", creator), ("index", index), ("sp", sp), ("op", op)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e < 1 or l < 1 or pass_cap < 1:
        raise ValueError("closure_la: needs events, l >= 1 and pass_cap >= 1")
    la = torch.empty((e, n), dtype=torch.int32, device=dev)
    la_next = torch.empty_like(la)
    pre = torch.empty_like(la)
    lat = torch.empty((n, n, l), dtype=torch.int32, device=dev)
    flag = torch.empty((), dtype=torch.int32, device=dev)
    passes, changed = 0, True
    while changed and passes < pass_cap:
        _launch("closure_la", dev, (
            creator, index, sp, op, rows_by, la, lat, pre, la_next, flag,
            e, n, l, int(passes == 0),
        ))
        passes += 1
        changed = bool(flag.item())
        la, la_next = la_next, la
    return la, passes


def walk_chunk(inv, rows_by, fd, la, x0, seeds, r_abs, first_nw,
               super_majority: int, l: int, length: int, steps: int,
               use_seeds: bool):
    """K7: `length` frontier steps from x0 in one launch. Returns
    (x_last (N,) int32, xs (length, N) int32)."""
    dev = rows_by.device
    n = rows_by.shape[0]
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
    if (4 * n + n * (n + 1) + min(n, 32) * n) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"walk_chunk: {n} validators exceed one block's shared memory")
    x_last = torch.empty((n,), dtype=torch.int32, device=dev)
    xs = torch.empty((length, n), dtype=torch.int32, device=dev)
    _launch("walk_chunk", dev, (
        inv, rows_by, fd, la, x0, seeds, r_abs, first_nw, x_last, xs,
        n, l, e_fd, e_la, super_majority, length, steps, int(use_seeds),
    ))
    return x_last, xs


def lamport_scan(levels, sp, op, esp, eop, fpin):
    """K8: (E,) int32 lamports by the seeded level recurrence."""
    dev = sp.device
    l_lv, n_lvl = levels.shape
    e = sp.shape[0]
    check_tensor("levels", levels, torch.int32, (l_lv, n_lvl), dev)
    for what, t in (("sp", sp), ("op", op), ("esp", esp), ("eop", eop),
                    ("fpin", fpin)):
        check_tensor(what, t, torch.int32, (e,), dev)
    if e < 1:
        raise ValueError("lamport_scan: needs events")
    if n_lvl * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"lamport_scan: level width {n_lvl} exceeds shared memory")
    lam = torch.empty((e,), dtype=torch.int32, device=dev)
    last_level = torch.empty((), dtype=torch.int32, device=dev)
    _launch("lamport_scan", dev, (
        levels, sp, op, esp, eop, fpin, lam, last_level, l_lv, n_lvl, e,
    ))
    return lam
