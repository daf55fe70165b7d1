"""State estimation emulation: per-state moving-average filter (batched port
of tum_control_tpu/sim/estimator.py).

Each of the 8 MPC-state components keeps a ring buffer of the last 15
measurements and outputs the mean over its own window [1,1,4,2,2,3,4,2],
truncated while the buffer is still filling.

The window sizes and the buffer's slot ages are device constants, built once
per device (device.py::device_constant): a tensor made from host data at
every step would synchronize the stream on CUDA once per closed-loop step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.device import device_constant, resolve_device

BUF = 15
WINDOW_SIZES = np.array([1, 1, 4, 2, 2, 3, 4, 2])


class EstimatorState(NamedTuple):
    buf: torch.Tensor    # (B, nx, BUF) ring buffer, the last slot is the newest
    count: torch.Tensor  # (B,) int32 number of samples seen so far


def init_estimator(batch: int, nx: int = 8, dtype=None, device=None) -> EstimatorState:
    """Empty buffers on `device` (device.resolve_device: cuda unless the
    caller names a device)."""
    device = resolve_device(device)
    return EstimatorState(
        buf=torch.zeros((batch, nx, BUF), dtype=dtype, device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def estimate(state: EstimatorState, x, window_sizes=WINDOW_SIZES):
    """Push measurements x (B, nx), return (filtered_x (B, nx), new_state)."""
    buf = torch.cat([state.buf[:, :, 1:], x[:, :, None]], dim=2)  # newest last
    count = torch.clamp(state.count + 1, max=BUF)
    w = device_constant(tuple(int(v) for v in window_sizes), x.device)
    ages = device_constant(tuple(range(BUF)), x.device)
    eff = torch.minimum(w[None, :], count[:, None])                # (B, nx)
    take = ages[None, None, :] >= (BUF - eff[:, :, None])
    filtered = torch.sum(torch.where(take, buf, torch.zeros_like(buf)), dim=2) / eff.to(buf.dtype)
    return filtered, EstimatorState(buf=buf, count=count)
