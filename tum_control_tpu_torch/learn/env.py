"""Safe-RL WMPC environment, batched port of tum_control_tpu/learn/env.py.

One env step = apply the chosen Pareto weight set and run `n_mpc_steps`
(= 20) closed-loop MPC steps (planner -> solve -> plant -> estimator), then
reward the Gaussian-bell product of the RMS lateral / velocity deviations,
end the episode on a crash (|lat_dev| > max_lat_dev) or at its length, and
reset to a random restart index on a random training lap.

The JAX package writes one env and maps it over the batch; here every
method takes all `n_envs` envs at once: each env drives its own lap of the
stacked trajectory (track/trajectory.py::select_laps), and its weight set
reaches its solves as per-scenario `QPMods`. The env runs without
disturbances (zero playback inputs), as the JAX env does.

`reset` draws (lap, restart index) per env from the env's generator and
hands them to the deterministic `reset_from`; `step` draws the same pair
for every env and resets those whose episode ended (an auto-reset), unless
the caller passes the draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.learn.observation import ObservationBuilder, ObservationConfig
from tum_control_tpu_torch.ops.rti import QPMods
from tum_control_tpu_torch.sim.closed_loop import ClosedLoopSim, SimCarry, select_carry
from tum_control_tpu_torch.track.planner import planner_emulator
from tum_control_tpu_torch.track.trajectory import RefTrajectory, select_laps


class RLEnvConfig(NamedTuple):
    n_mpc_steps: int = 20
    max_lat_dev: float = 2.0
    episode_length: int = 128
    rew_sigmas: tuple = (0.1, 0.5)
    rew_lims_lat: tuple = (0.0, 0.4)
    rew_lims_vel: tuple = (0.0, 1.0)
    restart_indices: tuple = (0, 100, 200, 400, 500, 700, 800)


class EnvState(NamedTuple):
    carry: SimCarry          # the closed loop of every env, (n_envs, ...)
    t: torch.Tensor          # (n_envs,) int32 env steps in the episode
    track: torch.Tensor      # (n_envs,) int64 lap index into the stack
    key: torch.Generator     # source of the reset draws


def weight_mods(engine, p) -> QPMods:
    """Per-scenario QP mods from parameter rows p (B, 7) = [q_xy, q_yaw,
    q_vel, r_jerk, r_steer, L1, L2]: W = [q_xy, q_xy, q_yaw, q_vel, r_jerk,
    r_steer] (no 0.01 factor, as WMPC swaps it), We = W[:4], L1 / L2 on
    the soft rows (hard rows keep their penalties)."""
    W = torch.stack([p[:, 0], p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4]], dim=1)
    soft_c, soft_u = engine.con_z1 > 0, engine.u_z1 > 0
    L1, L2 = p[:, 5, None, None], p[:, 6, None, None]
    return QPMods(
        W=W,
        We=W[:, :4],
        con_z1=torch.where(soft_c, L1, engine.con_z1),
        con_z2=torch.where(soft_c, L2, engine.con_z2),
        u_z1=torch.where(soft_u, L1, engine.u_z1),
        u_z2=torch.where(soft_u, L2, engine.u_z2),
    )


class RLEnv:
    """Batched env over a ClosedLoopSim and a stack of laps."""

    def __init__(self, sim: ClosedLoopSim, stacked_traj: RefTrajectory, param_table: np.ndarray,
                 obs_cfg: ObservationConfig, cfg: RLEnvConfig = RLEnvConfig()):
        eng = sim.controller.engine
        self.device, self.dtype = eng.W.device, eng.W.dtype
        self.sim = sim
        self.stacked = stacked_traj
        self.n_tracks = stacked_traj.pos.shape[0]
        self.table = torch.as_tensor(np.asarray(param_table), dtype=self.dtype, device=self.device)
        self.n_actions = int(self.table.shape[0])
        self.obs_cfg = obs_cfg
        self.cfg = cfg
        self.n_observations = obs_cfg.n_observations
        self.observe = ObservationBuilder(obs_cfg, sim.N + 1, self.device, self.dtype)
        self.restarts = torch.tensor(cfg.restart_indices, device=self.device)

    # ------------------------------------------------------------------
    def _mods(self, action) -> QPMods:
        return weight_mods(self.sim.controller.engine, self.table[action])

    def _observe(self, carry: SimCarry, traj):
        _, window = planner_emulator(traj, carry.pose, self.sim.Tp, self.sim.N + 1)
        x = carry.x_sim
        dx = window.pos[:, 0, 0] - x[:, 0]
        dy = window.pos[:, 0, 1] - x[:, 1]
        lat_dev = torch.sin(-x[:, 2]) * dx + torch.cos(-x[:, 2]) * dy
        return self.observe(lat_dev, x[:, 3] - window.v[:, 0], window)

    def draw_reset(self, key: torch.Generator, n_envs: int):
        """(lap (n,), restart index (n,)) drawn uniformly."""
        track = torch.randint(0, self.n_tracks, (n_envs,), generator=key, device=self.device)
        pick = torch.randint(0, len(self.restarts), (n_envs,), generator=key, device=self.device)
        return track, self.restarts[pick]

    # ------------------------------------------------------------------
    def reset(self, n_envs: int, key: torch.Generator) -> tuple:
        """(EnvState, obs (n_envs, n_obs)): a random restart index on a random
        training lap per env; `key` (on the env's device) stays the state's
        generator."""
        return self.reset_from(*self.draw_reset(key, n_envs), key)

    def reset_from(self, track, ridx, key: torch.Generator) -> tuple:
        """(EnvState, obs) of envs starting at restart index ridx (n,) of lap
        track (n,): on the reference pose at the reference speed, the other
        states zero, a cold controller."""
        traj = select_laps(self.stacked, track)
        rows = torch.arange(track.shape[0], device=self.device)
        p = traj.pos[rows, ridx]
        yaw0 = torch.remainder(traj.yaw[rows, ridx], 2 * math.pi)
        v0 = traj.v[rows, ridx]
        x0m = torch.cat([p, yaw0[:, None], v0[:, None], p.new_zeros((p.shape[0], 4))], dim=1)
        carry = self.sim.init_carry(x0m, x0m[:, :7], key=key)
        t = torch.zeros(track.shape, dtype=torch.int32, device=self.device)
        return EnvState(carry=carry, t=t, track=track, key=key), self._observe(carry, traj)

    # ------------------------------------------------------------------
    def step(self, es: EnvState, action, reset_draws=None) -> tuple:
        """(EnvState', obs, reward, done) for actions (n_envs,). An env whose
        episode ended starts again from `reset_draws` (lap, restart index),
        drawn from `es.key` unless given; its obs is the fresh one."""
        cfg = self.cfg
        traj = select_laps(self.stacked, es.track)
        mods = self._mods(action)
        carry = es.carry
        zero = torch.zeros_like(carry.x_sim)
        lats, vels = [], []
        for _ in range(cfg.n_mpc_steps):
            carry, log = self.sim.step(carry, zero, zero, traj=traj, mods=mods)
            lats.append(log.lat_dev)
            vels.append(log.vel_dev)
        lats, vels = torch.stack(lats, dim=1), torch.stack(vels, dim=1)

        rms = lambda x: torch.sqrt(torch.mean(x**2, dim=1))
        (l0, l1), (v0, v1) = cfg.rew_lims_lat, cfg.rew_lims_vel
        m_lat = torch.clamp((rms(lats) - l0) / (l1 - l0), 0.0, 1.0)
        m_vel = torch.clamp((rms(vels) - v0) / (v1 - v0), 0.0, 1.0)
        s_lat, s_vel = cfg.rew_sigmas
        reward = torch.exp(-(m_lat**2 / (2.0 * s_lat) + m_vel**2 / (2.0 * s_vel)))

        crashed = torch.amax(torch.abs(lats), dim=1) > cfg.max_lat_dev
        t = es.t + 1
        done = crashed | (t >= cfg.episode_length)

        if reset_draws is None:
            reset_draws = self.draw_reset(es.key, done.shape[0])
        fresh, obs_fresh = self.reset_from(*reset_draws, es.key)
        es_new = EnvState(
            carry=select_carry(done, fresh.carry, carry),
            t=torch.where(done, fresh.t, t),
            track=torch.where(done, fresh.track, es.track),
            key=es.key,
        )
        obs = torch.where(done[:, None], obs_fresh, self._observe(carry, traj))
        return es_new, obs, reward, done
