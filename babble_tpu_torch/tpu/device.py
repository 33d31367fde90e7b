"""Device policy for the port: where its entry points run.

The port's entry points run on the CUDA card unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version. A
missing card is an error, never a silent move to the CPU: a number taken
on the CPU must not pass for a device measurement.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` by default. Raises RuntimeError when CUDA is absent and the
    caller did not pass "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: pass 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "babble_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels"
        )
    return dev


def to_device(a, device: torch.device) -> torch.Tensor:
    """A numpy array as a contiguous tensor on `device` (a copy)."""
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
