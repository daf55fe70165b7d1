"""RL observation, batched port of tum_control_tpu/learn/observation.py.

obs = min-max-normalized [lat_dev, vel_dev,
                          n_points future reference velocities,
                          n_points smoothed future reference yaw rates]

Parity notes, as in the JAX package:
  * yaw rate = diff(unwrap(ref_yaw)) / Ts with Ts the *simulator* period
    (0.02 s), although window points are Ts_MPC (0.08 s) apart: the rates
    come out 4x too large, and the trained policies bake that in; kept;
  * `unwrap` follows numpy's (period 2 pi, discontinuity pi), written out
    here since torch has none;
  * a `smooth_N`-point moving average ('valid' convolution) smooths the rates;
  * sample indices are a static linspace over the available points;
  * normalization bounds: lat [-3, 3] m, vel dev [-5, 5] m/s, v [0, 39] m/s,
    yaw rate [-3.2, 3.2] rad/s; no clipping.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ObservationConfig(NamedTuple):
    n_points: int = 10      # obs_n_anticipation_points
    Ts: float = 0.02        # divisor for yaw-rate differencing (sim Ts)
    smooth_N: int = 10

    @property
    def n_observations(self) -> int:
        return 2 + 2 * self.n_points


def unwrap(p, period: float = 2.0 * math.pi):
    """numpy/jnp `unwrap` along the last axis, discontinuity period / 2."""
    interval = period / 2
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(dd.abs() < interval, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(ph_correct, dim=-1)], dim=-1)


class ObservationBuilder:
    """`make_observation` with its constants (sample indices, kernel and
    normalization bounds) made once on one device and dtype, so a step
    copies nothing from the host. `n_window` is the window's N+1 points."""

    def __init__(self, cfg: ObservationConfig, n_window: int, device, dtype):
        self.cfg = cfg
        n_rate = n_window - 1 - cfg.smooth_N + 1           # yaw rates after 'valid' smoothing
        idx = lambda n: torch.as_tensor(np.linspace(0, n - 1, cfg.n_points).astype(int),
                                        device=device)
        self.iv, self.iy = idx(n_window), idx(n_rate)
        self.kern = torch.full((cfg.smooth_N,), 1.0 / cfg.smooth_N, dtype=dtype, device=device)
        lo = np.concatenate([[-3.0, -5.0], np.full(cfg.n_points, 0.0),
                             np.full(cfg.n_points, -3.2)])
        hi = np.concatenate([[3.0, 5.0], np.full(cfg.n_points, 39.0),
                             np.full(cfg.n_points, 3.2)])
        self.lo = torch.as_tensor(lo, dtype=dtype, device=device)
        self.span = torch.as_tensor(hi - lo, dtype=dtype, device=device)

    def __call__(self, lat_dev, vel_dev, ref_window):
        cfg = self.cfg
        yaw_rate = torch.diff(unwrap(ref_window.yaw), dim=-1) / cfg.Ts
        yaw_rate = torch.matmul(yaw_rate.unfold(-1, cfg.smooth_N, 1), self.kern)  # 'valid'
        raw = torch.cat([lat_dev[:, None], vel_dev[:, None], ref_window.v[:, self.iv],
                         yaw_rate[:, self.iy]], dim=1)
        return (raw - self.lo) / self.span


def make_observation(cfg: ObservationConfig, lat_dev, vel_dev, ref_window):
    """(B, n_obs) observations from the deviations (B,) and an (N+1)-point
    reference window (RefWindow of (B, N+1, ...) tensors)."""
    v = ref_window.v
    return ObservationBuilder(cfg, v.shape[-1], v.device, v.dtype)(lat_dev, vel_dev, ref_window)
