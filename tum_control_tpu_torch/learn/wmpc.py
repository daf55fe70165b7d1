"""Weights-varying MPC (WMPC): a PPO policy periodically rewrites the
controller's cost weights inside the closed loop; batched port of
tum_control_tpu/learn/wmpc.py.

Every `update_period` (= 20) solves, build the observation from the current
deviations and the reference preview, predict a discrete action (a row of
the Pareto parameter table F.csv) and swap in that row's weights:

    Q = diag(p0, p0, p1, p2), R = diag(p3, p4), Qe = Q, L1 = p5, L2 = p6

As in the JAX package (and the reference it replicates), the swapped-in W
has NO 0.01 factor, unlike the build-time weights: the trained policies and
the Pareto tables bake this in.

The wrapper carries (step counter, observation stack, action, current
weights) per scenario in the closed loop's `extra` state. The observation
and the policy are evaluated at every step and the swaps are `torch.where`
selects, so a step never waits for the device to decide.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.learn.observation import ObservationBuilder, ObservationConfig
from tum_control_tpu_torch.learn.policy import MLPPolicy
from tum_control_tpu_torch.ops.rti import QPMods
from tum_control_tpu_torch.utils.trace import span


class WMPCExtra(NamedTuple):
    steps: torch.Tensor   # (B,) int32 steps since the last weight update
    obs: torch.Tensor     # (B, n_obs * n_stack) stacked observation
    action: torch.Tensor  # (B,) int32 last selected parameter set
    W: torch.Tensor       # (B, 6) current stage weight diagonal
    We: torch.Tensor      # (B, 4) current terminal weight diagonal
    L1: torch.Tensor      # (B,) current linear slack penalty
    L2: torch.Tensor      # (B,) current quadratic slack penalty
    base: Any = None      # the base controller's own extra (R2NMPC corrections)


class WMPCController:
    """Wraps a base controller (nominal, SNMPC or R2NMPC) with the
    weight-varying logic."""

    def __init__(self, base, policy: MLPPolicy, param_table: np.ndarray,
                 obs_cfg: ObservationConfig, update_period: int = 20, n_stack: int = 1):
        eng = base.engine
        self.base = base
        self.vp = base.vp   # the prediction model's vehicle, as the base controllers expose it
        self.policy = policy
        self.param_table = torch.as_tensor(np.asarray(param_table), dtype=eng.W.dtype,
                                           device=eng.W.device)   # (n_actions, 7)
        self.obs_cfg = obs_cfg
        self.observe = ObservationBuilder(obs_cfg, base.N + 1, eng.W.device, eng.W.dtype)
        self.period = update_period
        self.n_stack = n_stack
        # soft rows take the current L1/L2; hard rows (z1 = 0) keep their z2
        self.soft_c = eng.con_z1 > 0
        self.soft_u = eng.u_z1 > 0

    # -- delegated API --------------------------------------------------
    def init_state(self, x0):
        return self.base.init_state(x0)

    def init_extra(self, x0) -> WMPCExtra:
        """The build-time weights and penalties, action 0, for the
        scenarios of x0 (B, 8)."""
        eng, B = self.base.engine, x0.shape[0]
        init_base = getattr(self.base, "init_extra", None)
        full = lambda v: torch.full((B,), float(v), dtype=eng.W.dtype, device=eng.W.device)
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=eng.W.device)
        return WMPCExtra(
            steps=zeros_i,
            obs=eng.W.new_zeros((B, self.obs_cfg.n_observations * self.n_stack)),
            action=zeros_i.clone(),
            W=eng.W.repeat(B, 1),
            We=eng.We.repeat(B, 1),
            L1=full(self.base.cfg.L1_pen),
            L2=full(self.base.cfg.L2_pen),
            base=None if init_base is None else init_base(x0),
        )

    def _mods(self, extra: WMPCExtra) -> QPMods:
        eng = self.base.engine
        L1, L2 = extra.L1[:, None, None], extra.L2[:, None, None]
        return QPMods(
            W=extra.W,
            We=extra.We,
            con_z1=torch.where(self.soft_c, L1, eng.con_z1),
            con_z2=torch.where(self.soft_c, L2, eng.con_z2),
            u_z1=torch.where(self.soft_u, L1, eng.u_z1),
            u_z2=torch.where(self.soft_u, L2, eng.u_z2),
        )

    def solve_with_extra(self, state, extra: WMPCExtra, x0, ref_window, mods: QPMods = None):
        """One solve of the base controller under the current weights, then
        the weight-update check, the span `tc.wmpc.policy` (utils/trace.py).
        Returns (ControllerOutput, new state, new WMPCExtra)."""
        # A base with its own extra (R2NMPC's tightening) composes: these
        # weight mods merge with its bound mods. Fields the caller sets in
        # `mods` take precedence over the policy's own.
        own = self._mods(extra)
        if mods is not None:
            own = own._replace(**{k: v for k, v in mods._asdict().items() if v is not None})
        if hasattr(self.base, "solve_with_extra"):
            out, new_state, new_base = self.base.solve_with_extra(
                state, extra.base, x0, ref_window, mods=own)
        else:
            out, new_state = self.base.solve(state, x0, ref_window, mods=own)
            new_base = None

        # --- weight update check (the tail of the reference's solve) ---
        with span("tc.wmpc.policy"):
            update = extra.steps >= self.period                       # (B,)
            yaw = x0[:, 2]
            dx = ref_window.pos[:, 0, 0] - x0[:, 0]
            dy = ref_window.pos[:, 0, 1] - x0[:, 1]
            lat_dev = torch.sin(-yaw) * dx + torch.cos(-yaw) * dy
            vel_dev = x0[:, 3] - ref_window.v[:, 0]
            obs_new = self.observe(lat_dev, vel_dev, ref_window)
            n_obs = self.obs_cfg.n_observations
            stacked = (torch.cat([extra.obs[:, n_obs:], obs_new], dim=1) if self.n_stack > 1
                       else obs_new)
            obs = torch.where(update[:, None], stacked, extra.obs)
            action = torch.where(update, self.policy.predict(obs).to(torch.int32), extra.action)
            p = self.param_table[action]                              # (B, 7)
            # no 0.01 factor (the reference's update_cost_function_weights)
            We_new = torch.stack([p[:, 0], p[:, 0], p[:, 1], p[:, 2]], dim=1)
            W_new = torch.cat([We_new, p[:, 3:5]], dim=1)
            new_extra = WMPCExtra(
                steps=torch.where(update, 1, extra.steps + 1).to(torch.int32),
                obs=obs,
                action=action,
                W=torch.where(update[:, None], W_new, extra.W),
                We=torch.where(update[:, None], We_new, extra.We),
                L1=torch.where(update, p[:, 5], extra.L1),
                L2=torch.where(update, p[:, 6], extra.L2),
                base=new_base,
            )
        return out, new_state, new_extra


def load_param_table(path: str) -> np.ndarray:
    """Pareto parameter sets, one 7-vector per line (F.csv format)."""
    return np.loadtxt(path, delimiter=",")
