"""Planner emulator: extract + resample the upcoming reference window.

Batched port of tum_control_tpu/track/planner.py::planner_emulator:

  1. nearest reference point to each pose (argmin of squared distances,
     first index on ties),
  2. the time walk: the number of segments past the nearest point whose
     summed traversal time first exceeds Tp, counted as two masked
     comparisons over the prefix sums `cum_time` (capped at MAX_WINDOW),
  3. linear resampling of that window to `n_out` points; yaw is
     interpolated circularly per segment.

Every scenario may drive a lap of its own (the JAX package's planner under
`vmap` over a stack of laps): the lap's tensors then carry the batch axis.

The JAX package gathers the window endpoints with a bf16 one-hot matmul, a
workaround for slow gathers on the TPU; a plain gather is exact here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tum_control_tpu_torch.track.trajectory import RefTrajectory

# Maximum number of raw trajectory points a Tp-window can span.
MAX_WINDOW = 512


class RefWindow(NamedTuple):
    """Resampled reference windows handed to the controller."""

    pos: torch.Tensor  # (B, n_out, 2)
    yaw: torch.Tensor  # (B, n_out)
    v: torch.Tensor    # (B, n_out)


def _circular_lerp(y0, y1, frac, period=2.0 * math.pi):
    """Interpolate angles along the shortest arc, result in [0, period)."""
    d = torch.remainder(y1 - y0 + 0.5 * period, period) - 0.5 * period
    return torch.remainder(y0 + frac * d, period)


def planner_emulator(traj: RefTrajectory, pose_xy, Tp: float, n_out: int) -> tuple:
    """Return (closest_point_index (B,), RefWindow with n_out points).

    `pose_xy`: (B, 2) current vehicle positions. `n_out` = N + 1 nodes.
    `traj` is one lap for every scenario, or one lap per scenario (tensors
    (B, ...) and a (B,) `n_valid`, track/trajectory.py::select_laps); all
    index arithmetic is then modulo each scenario's own lap length.
    """
    if traj.pos.dim() == 3:
        rows = torch.arange(pose_xy.shape[0], device=pose_xy.device)[:, None]
        take = lambda a, i: a[rows, i]
        lap = lambda a: a
        M = traj.n_valid[:, None]
    else:
        take = lambda a, i: a[i]
        lap = lambda a: a[None]
        M = traj.n_valid
    dx = lap(traj.pos[..., 0]) - pose_xy[:, 0:1]
    dy = lap(traj.pos[..., 1]) - pose_xy[:, 1:2]
    d2 = dx * dx + dy * dy                       # (B, Mpad)
    c = torch.argmin(d2, dim=1)                  # (B,)

    # time walk: walkcum(K) = P[c+1+K] - P[c+1] before the lap wrap,
    # P[M] - P[c+1] + P[K-(M-c-1)] after it; n_app = first K with
    # walkcum(K) > Tp = 1 + #{K >= 1 : walkcum(K) <= Tp}
    P = traj.cum_time
    idx = torch.arange(P.shape[-1], device=P.device)[None, :]
    cc = c[:, None]
    target = take(P, cc + 1) + Tp
    mask_u = (idx >= cc + 2) & (idx <= M) & (idx <= cc + MAX_WINDOW)
    count_u = torch.sum(mask_u & (lap(P) <= target), dim=1)
    mask_w = (idx >= 1) & (idx <= MAX_WINDOW - 1 + cc + 1 - M)
    count_w = torch.sum(mask_w & (lap(P) <= target - take(P, M)), dim=1)
    n_pts = 2 + count_u + count_w                # nearest point + n_app segments

    # resample to n_out points over fractional window indices [0, n_pts-1]
    # (the grid i / (n_out-1) of jnp.linspace, true division as it does)
    dt = d2.dtype
    steps = torch.full((n_out,), n_out - 1, dtype=dt, device=d2.device)
    base = torch.arange(n_out, dtype=dt, device=d2.device) / steps
    last = (n_pts - 1)[:, None]
    q = base[None, :] * last.to(dt)              # (B, n_out)
    i0 = torch.minimum(torch.clamp(torch.floor(q).long(), min=0), last)
    i1 = torch.minimum(i0 + 1, last)
    frac = q - i0.to(dt)
    g0 = torch.remainder(cc + i0, M)
    g1 = torch.remainder(cc + i1, M)
    w0, w1 = 1.0 - frac, frac
    pos = take(traj.pos, g0) * w0[..., None] + take(traj.pos, g1) * w1[..., None]
    v = take(traj.v, g0) * w0 + take(traj.v, g1) * w1
    yaw = _circular_lerp(take(traj.yaw, g0), take(traj.yaw, g1), frac)
    return c, RefWindow(pos=pos, yaw=yaw, v=v)
