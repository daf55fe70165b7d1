"""Batched BO objective: closed-loop tracking performance per weight set,
port of tum_control_tpu/learn/bo/objective.py.

Every (candidate, segment) pair is one scenario of a batched closed loop on
its own lap (track/trajectory.py::select_laps), in chunks of `chunk`
scenarios; each rollout runs a fixed number of steps with done / crash
latches (sim/closed_loop.py::select_carry freezes a finished scenario).

Objectives (maximized, BO_WMPC/objective_function.py:178-185):
    f0 = -max |lat_dev|,  f1 = -RMS(vel_dev)
Infeasible (crash) when lat_dev > max_lat_dev or the normalized combined
acceleration exceeds max_a_comb -> objectives NaN. A segment run ends when
the planner's nearest-point index reaches the segment's end index.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.learn.env import weight_mods as params_to_mods
from tum_control_tpu_torch.sim.closed_loop import ClosedLoopSim, select_carry
from tum_control_tpu_torch.track.planner import planner_emulator
from tum_control_tpu_torch.track.trajectory import RefTrajectory, select_laps

__all__ = ["SegmentBatch", "make_segment_batch", "params_to_mods", "ObjectiveEvaluator"]


class SegmentBatch(NamedTuple):
    """Segment descriptors, one row per segment."""

    track: torch.Tensor  # (S,) int64 lap index into the stacked trajectory
    start: torch.Tensor  # (S,) int64
    end: torch.Tensor    # (S,) int64


def make_segment_batch(segments: list, track_names: list, device) -> SegmentBatch:
    name_to_id = {n: i for i, n in enumerate(track_names)}
    t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return SegmentBatch(track=t([name_to_id[s["trajectory"]] for s in segments]),
                        start=t([s["start"] for s in segments]),
                        end=t([s["end"] for s in segments]))


class ObjectiveEvaluator:
    def __init__(self, sim: ClosedLoopSim, stacked_traj: RefTrajectory, max_steps: int = 1500,
                 max_lat_dev: float = 2.0, max_a_comb: float = 1.02, chunk: int = 128):
        self.sim = sim
        self.stacked = stacked_traj
        self.max_steps = max_steps
        self.max_lat_dev = max_lat_dev
        self.max_a_comb = max_a_comb
        self.chunk = chunk  # scenarios per batched closed loop
        eng = sim.controller.engine
        self.device, self.dtype = eng.W.device, eng.W.dtype

    # ------------------------------------------------------------------
    def _a_comb(self, x_sim, a_lon):
        """Normalized combined acceleration (B,)."""
        gg, acc_min = self.sim.controller.gg, self.sim.controller.vp.acc_min
        v = x_sim[:, 3]
        alat_n = v * x_sim[:, 5] / gg.ay_lim(v)
        pos = a_lon > 0
        alon_lim = torch.where(pos, gg.ax_lim(v), torch.full_like(v, acc_min))
        alon_n = torch.where(pos, a_lon / alon_lim, torch.abs(a_lon) / alon_lim)
        return torch.sqrt(alon_n**2 + alat_n**2)

    def run_chunk(self, p, track, start, end):
        """One batched rollout of (candidate p (b, 7), segment (track, start,
        end) (b,)) pairs -> (f (b, 2), feasible (b,))."""
        sim = self.sim
        traj = select_laps(self.stacked, track)
        mods = params_to_mods(sim.controller.engine, p)
        rows = torch.arange(track.shape[0], device=self.device)
        px = traj.pos[rows, start]
        yaw0 = torch.remainder(traj.yaw[rows, start], 2 * math.pi)
        v0 = traj.v[rows, start]
        x0m = torch.cat([px, yaw0[:, None], v0[:, None], px.new_zeros((px.shape[0], 4))], dim=1)
        carry = sim.init_carry(x0m, x0m[:, :7], key=0)

        b = track.shape[0]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        crash = torch.zeros_like(done)
        max_lat = x0m.new_zeros((b,))
        sum_vel2 = x0m.new_zeros((b,))
        n = torch.zeros((b,), dtype=torch.int32, device=self.device)
        zero = torch.zeros_like(carry.x_sim)
        for _ in range(self.max_steps):
            new_carry, log = sim.step(carry, zero, zero, traj=traj, mods=mods)
            c_idx, _ = planner_emulator(traj, new_carry.pose, sim.Tp, 2)
            a_comb = self._a_comb(new_carry.x_sim, log.MPC_SimX[:, 7])
            crashed_now = (log.lat_dev > self.max_lat_dev) | (a_comb > self.max_a_comb)
            active = ~(done | crash)
            max_lat = torch.where(active, torch.maximum(max_lat, torch.abs(log.lat_dev)), max_lat)
            sum_vel2 = torch.where(active, sum_vel2 + log.vel_dev**2, sum_vel2)
            n = torch.where(active, n + 1, n)
            carry = select_carry(active, new_carry, carry)
            done = done | (active & (c_idx == end))
            crash = crash | (active & crashed_now)
        rms_vel = torch.sqrt(sum_vel2 / torch.clamp(n, min=1))
        feasible = ~crash
        f = torch.stack([-max_lat, -rms_vel], dim=1)
        return torch.where(feasible[:, None], f, torch.full_like(f, math.nan)), feasible

    # ------------------------------------------------------------------
    def evaluate(self, params, seg: SegmentBatch):
        """params (C, 7) x segments (S,) -> (objs (C, 2), feasible (C,)).

        The group objective is the mean over its segments, and a candidate
        is infeasible if ANY segment crashes (objective_function.py:158-172).
        """
        params = torch.as_tensor(np.asarray(params) if not torch.is_tensor(params) else params,
                                 dtype=self.dtype, device=self.device)
        C, S = params.shape[0], seg.track.shape[0]
        p_flat = params.repeat_interleave(S, dim=0)
        tr, st, en = seg.track.repeat(C), seg.start.repeat(C), seg.end.repeat(C)
        fs, feass = [], []
        for lo in range(0, C * S, self.chunk):
            hi = min(lo + self.chunk, C * S)
            f_c, feas_c = self.run_chunk(p_flat[lo:hi], tr[lo:hi], st[lo:hi], en[lo:hi])
            fs.append(f_c)
            feass.append(feas_c)
        f = torch.cat(fs).reshape(C, S, 2)
        feasible = torch.cat(feass).reshape(C, S).all(dim=1)
        objs = torch.mean(f, dim=1)  # NaN propagates from crashed segments
        return torch.where(feasible[:, None], objs, torch.full_like(objs, math.nan)), feasible
