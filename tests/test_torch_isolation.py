"""The port stands alone: importing every babble_tpu_torch module loads
neither jax nor anything of the babble_tpu package, chip_smoke.py imports
neither, and the entry point refuses to run on the CPU unless asked."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import babble_tpu_torch
from babble_tpu_torch.tpu import synthetic_grid
from babble_tpu_torch.tpu import engine as port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def is_forbidden(name: str) -> bool:
    """jax, or the babble_tpu package itself (babble_tpu_torch shares the
    prefix and is allowed)."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "babble_tpu")


def test_port_modules_import_no_jax_and_no_reference():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(
            babble_tpu_torch.__path__, prefix="babble_tpu_torch."
        )
    )
    assert "babble_tpu_torch.tpu.engine" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {['babble_tpu_torch'] + modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert "babble_tpu_torch.tpu.kernels" in loaded
    assert [m for m in loaded if is_forbidden(m)] == []


def test_chip_smoke_imports_no_jax_and_no_reference():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "babble_tpu_torch.tpu" in names
    assert [n for n in names if is_forbidden(n)] == []


def test_default_device_is_cuda_and_refuses_a_host_without_it(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = synthetic_grid(4, 64, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.run_frontier_passes(grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_engine.run_frontier_passes(grid, device="cuda")
    res = port_engine.run_frontier_passes(grid, device="cpu")
    assert res.last_round >= 1
