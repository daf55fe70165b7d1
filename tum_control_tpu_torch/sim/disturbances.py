"""Fault-injection disturbance streams (port of
tum_control_tpu/sim/disturbances.py).

  * 'uniform'  — uniform inside the axis-aligned ellipsoid with semi-axes =
    the magnitudes (radius ~ U^(1/n), direction ~ normalized gaussian),
  * 'gaussian' — independent N(0, sigma_j) per component,
  * 'absolute' — the constant upper bound.

Draws come from a `torch.Generator`, which gives other numbers than
`jax.random` for the same seed; parity runs feed recorded draws through the
playback inputs of `ClosedLoopSim.run_from(..., playback=(w_d, w_s))`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device

TYPE_NONE, TYPE_UNIFORM, TYPE_GAUSSIAN, TYPE_ABSOLUTE = 0, 1, 2, 3

_TYPE_BY_NAME = {
    "none": TYPE_NONE,
    "uniform": TYPE_UNIFORM,
    "gaussian": TYPE_GAUSSIAN,
    "absolute": TYPE_ABSOLUTE,
}


class DisturbanceConfig(NamedTuple):
    kind: int                  # TYPE_*
    magnitudes: torch.Tensor   # (n,) per-component bound / std


def disturbance_config(type_name: str, magnitudes, enabled: bool = True,
                       dtype=None, device=None) -> DisturbanceConfig:
    """The stream's kind and magnitudes on `device` (device.resolve_device:
    cuda unless the caller names a device)."""
    device = resolve_device(device)
    kind = _TYPE_BY_NAME[type_name] if enabled else TYPE_NONE
    return DisturbanceConfig(
        kind=kind,
        magnitudes=torch.as_tensor(np.asarray(magnitudes), dtype=dtype, device=device),
    )


def draw_disturbance(cfg: DisturbanceConfig, generator: torch.Generator, batch: int):
    """(batch, n) disturbance vectors drawn from `generator`."""
    mag = cfg.magnitudes
    n = mag.shape[0]
    kw = dict(generator=generator, dtype=mag.dtype, device=mag.device)
    if cfg.kind == TYPE_NONE:
        return torch.zeros((batch, n), dtype=mag.dtype, device=mag.device)
    if cfg.kind == TYPE_UNIFORM:
        r = torch.rand((batch, 1), **kw) ** (1.0 / n)
        x = torch.randn((batch, n), **kw)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True) * r
        return mag * x
    if cfg.kind == TYPE_GAUSSIAN:
        return mag * torch.randn((batch, n), **kw)
    return mag.expand(batch, n).clone()  # absolute



def load_playback(logs_path: str, log_file: str, n_steps: int, dtype=torch.float32,
                  device=None):
    """Load a recorded disturbance realization from a previous run's
    full_logs.npz for replay (the arrays `sim_disturbance_derivatives` and
    `sim_disturbance_state_estimation`; a relative `log_file` is taken under
    `logs_path`). Returns (w_deriv, w_se), (n_steps, 7) tensors on `device`
    (device.resolve_device), zero-padded where the recording is shorter;
    `ClosedLoopSim.run_from` takes them with a batch axis in front."""
    import os

    device = resolve_device(device)
    path = log_file if os.path.isabs(log_file) else os.path.join(logs_path, log_file)
    data = np.load(path)
    out = []
    for name in ("sim_disturbance_derivatives", "sim_disturbance_state_estimation"):
        w = np.asarray(data[name])[:n_steps]
        if w.shape[0] < n_steps:
            w = np.concatenate([w, np.zeros((n_steps - w.shape[0], w.shape[1]), w.dtype)])
        out.append(torch.as_tensor(w[:, :7], dtype=dtype, device=device))
    return tuple(out)
