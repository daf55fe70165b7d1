"""Shared controller pieces: gg-limit interpolation and acceleration
constraint shapes (port of tum_control_tpu/controllers/common.py).

`interp` reproduces `jnp.interp`: right-continuous segment choice through
`searchsorted(side="right")`, end values held outside the table. Its
forward-mode tangent is the active segment's slope in range and 0 where
the lookup clamps, as JAX's AD of `jnp.interp` gives; `interp_slope` is
that tangent written out, for the analytic `acc_constraints_jac` (SNMPC).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device

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
    """Velocity-indexed gg limits, held as tensors on one device/dtype (cuda
    unless a device is named, device.py)."""

    def __init__(self, vel, ax_max, ax_min, ay_max, device=None, dtype=None):
        device = resolve_device(device)
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


def interp_slope(x, xp, fp):
    """d/dx of `interp(x, xp, fp)` as JAX's AD of `jnp.interp` gives it: the
    slope of the segment `searchsorted(side="right")` picks (clipped to
    [1, n-1]) in range, 0 where the lookup clamps."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    df = (fp[i] - fp[i - 1]) / (xp[i] - xp[i - 1])
    return torch.where((x < xp[0]) | (x > xp[-1]), torch.zeros_like(df), df)


def acc_constraints_jac(x8, gg: GGTables, acc_min: float, shape: int):
    """Value and Jacobian of the gg rows as a function of the 8-state
    [., ., ., vlong, vlat, yawrate, ., a_lon]: h = acc_constraints(|v|, a_lon,
    vlong * yawrate) with |v| = sqrt(vlong^2 + vlat^2).

    x8 (..., 8) -> (h (..., nh), dh (..., nh, 8)). The values are
    `acc_constraints`' (the same operations); the derivatives follow
    forward-mode AD's convention: `interp_slope`, and the derivative of the
    branch `where` takes (0 for the constant braking limit)."""
    vlong, vlat, yawrate, a_lon = x8[..., 3], x8[..., 4], x8[..., 5], x8[..., 7]
    v = torch.sqrt(vlong**2 + vlat**2)
    dv3, dv4 = vlong / v, vlat / v
    ay_m = gg.ay_lim(v)
    day = interp_slope(v, gg.vel, gg.ay_max)
    ax_i = gg.ax_lim(v)
    dax_i = interp_slope(v, gg.vel, gg.ax_max)
    neg = a_lon < 0
    ax_m = torch.where(neg, torch.full_like(ax_i, -acc_min), ax_i)
    dax_m = torch.where(neg, torch.zeros_like(dax_i), dax_i)

    a_lat = vlong * yawrate
    rlon = a_lon / ax_m
    rlat = a_lat / ay_m
    t_lon = -a_lon * dax_m / ax_m**2           # d rlon / d x
    dlon = (t_lon * dv3, t_lon * dv4, torch.zeros_like(v), 1.0 / ax_m)
    t_lat = -a_lat * day / ay_m**2             # d rlat / d x
    dlat = (yawrate / ay_m + t_lat * dv3, t_lat * dv4, vlong / ay_m, torch.zeros_like(v))

    def row(d3, d4, d5, d7):
        z = torch.zeros_like(v)
        return torch.stack([z, z, z, d3, d4, d5, z, d7], dim=-1)

    if shape == 0:
        h = torch.stack([rlon, rlat], dim=-1)
        dh = torch.stack([row(*dlon), row(*dlat)], dim=-2)
    elif shape == 1:
        h = torch.stack([rlon + rlat, rlon - rlat], dim=-1)
        dh = torch.stack([row(*(a + b for a, b in zip(dlon, dlat))),
                          row(*(a - b for a, b in zip(dlon, dlat)))], dim=-2)
    else:
        h = (rlon**2 + rlat**2)[..., None]
        dh = row(*(2 * (rlon * a + rlat * b) for a, b in zip(dlon, dlat)))[..., None, :]
    return h, dh


def acc_bounds(shape: int):
    """(lh, uh) per constraint row for the given shape."""
    if shape in (0, 1):
        return np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    return np.array([0.0]), np.array([1.0])


def wrap_2pi(yaw):
    """Wrap to [0, 2pi) (floor-mod like `jnp.mod`; never `torch.fmod`)."""
    return torch.remainder(yaw, 2.0 * math.pi)
