"""The port's device rule: everything runs on `cuda` unless the caller names
a device (the CPU tests pass `device="cpu"`). Without a CUDA device and
without an explicit device, the entry points and constructors raise."""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """`values` (a tuple of ints) as an int64 tensor on `device`, built once
    and reused. A tensor made from host data inside a closed-loop step is a
    host-to-device copy, which synchronizes the stream on CUDA at every
    call."""
    return torch.tensor(values, dtype=torch.long, device=device)
