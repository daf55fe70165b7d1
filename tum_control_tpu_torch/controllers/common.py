"""Shared controller pieces: gg-limit interpolation and acceleration
constraint shapes (port of tum_control_tpu/controllers/common.py).

`interp` reproduces `jnp.interp`: right-continuous segment choice through
`searchsorted(side="right")`, end values held outside the table. Its
forward-mode tangent is the active segment's slope in range and 0 where
the lookup clamps, as JAX's AD of `jnp.interp` gives.
"""
from __future__ import annotations

import math

import numpy as np
import torch

N_H = {0: 2, 1: 2, 2: 1}  # number of nonlinear constraint rows per shape


def interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` for a 1-D increasing table, any shape of x."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    dx0 = torch.abs(dx) <= np.spacing(torch.finfo(xp.dtype).eps)
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class GGTables:
    """Velocity-indexed gg limits, held as tensors on one device/dtype."""

    def __init__(self, vel, ax_max, ax_min, ay_max, device=None, dtype=None):
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        self.vel = as_t(vel)
        self.ax_max = as_t(ax_max)
        self.ay_max = as_t(ay_max)
        self.ax_min = as_t(ax_min)  # unused by the controllers (kept for evaluation)

    def ay_lim(self, v):
        return interp(v, self.vel, self.ay_max)

    def ax_lim(self, v):
        return interp(v, self.vel, self.ax_max)


def acc_constraints(vel_abs, a_lon, a_lat, gg: GGTables, acc_min: float, shape: int):
    """Normalized acceleration constraint rows h, stacked on a new last axis
    (nh rows); bounds from `acc_bounds(shape)`."""
    ay_max = gg.ay_lim(vel_abs)
    ax_max = torch.where(a_lon < 0, torch.full_like(a_lon, -acc_min), gg.ax_lim(vel_abs))
    if shape == 0:
        return torch.stack([a_lon / ax_max, a_lat / ay_max], dim=-1)
    if shape == 1:
        return torch.stack(
            [a_lon / ax_max + a_lat / ay_max, a_lon / ax_max - a_lat / ay_max], dim=-1
        )
    return ((a_lon / ax_max) ** 2 + (a_lat / ay_max) ** 2)[..., None]


def acc_bounds(shape: int):
    """(lh, uh) per constraint row for the given shape."""
    if shape in (0, 1):
        return np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    return np.array([0.0]), np.array([1.0])


def wrap_2pi(yaw):
    """Wrap to [0, 2pi) (floor-mod like `jnp.mod`; never `torch.fmod`)."""
    return torch.remainder(yaw, 2.0 * math.pi)
