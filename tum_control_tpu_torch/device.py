"""The port's device rule: everything runs on `cuda` unless the caller names
a device (the CPU tests pass `device="cpu"`). Without a CUDA device and
without an explicit device, the entry points and constructors raise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else cuda; raises when cuda is asked for implicitly
    and there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless device='cpu' is passed"
        )
    return torch.device("cuda")
