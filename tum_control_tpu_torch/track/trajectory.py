"""Reference-trajectory / track loading (port of
tum_control_tpu/track/trajectory.py).

The per-point segment traversal time and its prefix sums are computed once
in float64 numpy and then cast to the working dtype:

    seg_time[j] = ||p[j] - p[j-1 mod M]|| / ref_v[j],  cum_time = [0, cumsum(seg_time)]

Several laps stack into one padded RefTrajectory (`stack_trajectories`);
`select_laps` gathers one lap per scenario from it, for the closed loops
whose scenarios drive different laps (the RL env, the BO objective).
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.device import resolve_device


class RefTrajectory(NamedTuple):
    """One lap, or one padded lap per stack entry or scenario: then every
    tensor carries a leading (L, ...) or (B, ...) axis and `n_valid` is an
    int64 tensor of the real lengths."""

    pos: torch.Tensor       # (M, 2) pos_x, pos_y
    yaw: torch.Tensor       # (M,)   ref_yaw (wrapped to [0, 2pi))
    v: torch.Tensor         # (M,)   ref_v
    acc: torch.Tensor       # (M,)   ref_acc
    seg_time: torch.Tensor  # (M,)   traversal time of segment ending at j
    cum_time: torch.Tensor  # (M+1,) prefix sums: cum_time[i] = sum(seg_time[:i])
    n_valid: object         # int: number of real points (<= M when padded)

    @property
    def n_points(self) -> int:
        """Array length."""
        return self.pos.shape[-2]


def stack_trajectories(trajs) -> RefTrajectory:
    """Pad laps to a common length and stack them along a leading axis.

    Padded slots get far-away positions (never the nearest point), huge
    segment times and prefix sums (never inside a planner window); `n_valid`
    (L,) keeps each real length, which the planner's modular index
    arithmetic uses."""
    M = max(int(t.n_valid) for t in trajs)

    def pad(a, fill, target=M):
        extra = target - a.shape[0]
        if extra == 0:
            return a
        return torch.cat([a, a.new_full((extra,) + a.shape[1:], fill)])

    fills = dict(pos=1e7, yaw=0.0, v=1.0, acc=0.0, seg_time=1e7, cum_time=1e14)
    fields = {
        k: torch.stack([pad(getattr(t, k), fill, M + 1 if k == "cum_time" else M)
                        for t in trajs])
        for k, fill in fills.items()
    }
    n_valid = torch.tensor([int(t.n_valid) for t in trajs], device=trajs[0].pos.device)
    return RefTrajectory(n_valid=n_valid, **fields)


def select_laps(stacked: RefTrajectory, lap) -> RefTrajectory:
    """One lap of a stack per scenario: `lap` (B,) lap indices -> a
    RefTrajectory of (B, ...) tensors with a (B,) `n_valid`."""
    return RefTrajectory(*(a[lap] for a in stacked))


class Track(NamedTuple):
    center: np.ndarray  # (K, 2)
    inner: np.ndarray   # (K, 2)
    outer: np.ndarray   # (K, 2)


def postprocess_yaw(yaw):
    """Wrap yaw to [0, 2*pi)."""
    return np.mod(yaw, 2.0 * np.pi)


def load_ref_trajectory(path: str, dtype=None, device=None) -> RefTrajectory:
    """Load a reftraj_*.json into a RefTrajectory of tensors on `device`
    (device.resolve_device: cuda unless the caller names a device)."""
    device = resolve_device(device)
    with open(path, "r") as fh:
        raw = json.load(fh)
    pos = np.stack([np.asarray(raw["pos_x"]), np.asarray(raw["pos_y"])], axis=1)
    v = np.asarray(raw["ref_v"], dtype=np.float64)
    yaw = np.asarray(raw["ref_yaw"], dtype=np.float64)
    acc = np.asarray(raw.get("ref_acc", np.zeros_like(v)), dtype=np.float64)
    seg = np.linalg.norm(pos - np.roll(pos, 1, axis=0), axis=1) / v
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return RefTrajectory(
        pos=t(pos), yaw=t(yaw), v=t(v), acc=t(acc), seg_time=t(seg), cum_time=t(cum),
        n_valid=int(pos.shape[0]),
    )


def load_track(path: str) -> Track:
    """Load a track_*.json (host-side numpy; only used for plotting/eval)."""
    with open(path, "r") as fh:
        raw = json.load(fh)
    return Track(
        center=np.stack([raw["X"], raw["Y"]], axis=1),
        inner=np.stack([raw["X_i"], raw["Y_i"]], axis=1),
        outer=np.stack([raw["X_o"], raw["Y_o"]], axis=1),
    )


def initial_state(path: str, idx_ref_start: int):
    """Initial MPC (8,) and plant (7,) numpy states from a trajectory point:
    pose from the start index, vlong = ref_v, vlat = yawrate = delta_f = a = 0."""
    with open(path, "r") as fh:
        raw = json.load(fh)
    px = float(raw["pos_x"][idx_ref_start])
    py = float(raw["pos_y"][idx_ref_start])
    yaw = float(postprocess_yaw(np.float64(raw["ref_yaw"][idx_ref_start])))
    v = float(raw["ref_v"][idx_ref_start])
    x0_mpc = np.array([px, py, yaw, v, 0.0, 0.0, 0.0, 0.0])
    x0_sim = np.array([px, py, yaw, v, 0.0, 0.0, 0.0])
    return x0_mpc, x0_sim


def resolve_trajectory_paths(trajectory_path: str, ref_traj_file: str, track_file: str):
    """(reference-trajectory path, track path) inside `trajectory_path`."""
    return (os.path.join(trajectory_path, ref_traj_file),
            os.path.join(trajectory_path, track_file))
