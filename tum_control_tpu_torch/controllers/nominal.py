"""Nominal NMPC controller (batched port of
tum_control_tpu/controllers/nominal.py).

  * 8-state single-track prediction model, RK4 3 substeps x Ts_MPC shooting,
    linearized by K1 (ops/kernels/linearize.py),
  * NONLINEAR_LS cost on y = [posx, posy, yaw in [0,2pi), vlong, jerk,
    steering_rate] with W = 0.01 blkdiag(Q, R), We = 0.01 Q; or the
    EXTERNAL cost: the same weights on the residual [ego-frame longitudinal
    and lateral deviation, yaw - yaw_ref, vlong - v_ref, jerk,
    steering_rate], with Levenberg-Marquardt damping 0.1,
  * the combined-acceleration constraint rows + a soft delta_f state bound
    + the steering-rate input bound with L1/L2 slack penalties; node 0 has
    no delta_f bound and a hard (z1 = 0, z2 = HARD_Z2) input row.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.controllers.common import (
    GGTables, N_H, acc_bounds, acc_constraints, wrap_2pi,
)
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout
from tum_control_tpu_torch.ops.rti import BIG, OCPFunctions, RTIEngine, RTIState
from tum_control_tpu_torch.params import TireParams, VehicleParams

HARD_Z2 = 1e7  # quadratic penalty standing in for a hard constraint row

N_SHOOTING_SUBSTEPS = 3  # acados sim_method_num_steps


class ControllerOutput(NamedTuple):
    u0: torch.Tensor      # (B, 2) [jerk, steering_rate]
    pred_X: torch.Tensor  # (B, N+1, 8) predicted state trajectories
    stats: torch.Tensor   # (B, 5) [cost, time_tot (0), sqp_iter, qp_iter, status]


class NominalNMPC:
    """Batched nominal NMPC; `state` is an RTIState of (B, ...) tensors. Its
    tensors live on `device` (cuda unless named, device.py)."""

    nx = 8
    nu = 2

    def __init__(self, mpc_cfg: MPCConfig, N: int, dt: float, vp: VehicleParams,
                 tp: TireParams, gg: GGTables, device=None, dtype=torch.float32):
        self.cfg = mpc_cfg
        self.N, self.dt = N, dt
        self.vp, self.tp, self.gg = vp, tp, gg
        shape = mpc_cfg.combined_acc_limits
        nh = N_H[shape]
        self.nh = nh
        device = resolve_device(device)

        def y_stage(x, u):
            return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), x[..., 3:4], u], dim=-1)

        def y_term(x):
            return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), x[..., 3:4]], dim=-1)

        def lonlat(x, yr):
            """Ego-frame [longitudinal, lateral, yaw, velocity] deviations."""
            yaw = wrap_2pi(x[..., 2])
            c, s = torch.cos(-yaw), torch.sin(-yaw)
            dx, dy = yr[..., 0] - x[..., 0], yr[..., 1] - x[..., 1]
            return torch.stack([c * dx - s * dy, s * dx + c * dy, yaw - yr[..., 2],
                                x[..., 3] - yr[..., 3]], dim=-1)

        def resid_lonlat(x, u, yr):
            return torch.cat([lonlat(x, yr), u], dim=-1)

        cost = mpc_cfg.costfunction_type.upper()
        if cost not in ("NONLINEAR_LS", "EXTERNAL"):
            raise ValueError(f"unknown cost function type '{mpc_cfg.costfunction_type}'")
        external = cost == "EXTERNAL"

        def con_stage(x):
            h = acc_constraints(x[..., 3], x[..., 7], x[..., 3] * x[..., 5], gg, vp.acc_min, shape)
            return torch.cat([h, x[..., 6:7]], dim=-1)  # [h rows..., delta_f]

        W = 0.01 * np.concatenate([np.diag(mpc_cfg.Q()), np.diag(mpc_cfg.R())])
        We = 0.01 * np.diag(mpc_cfg.Q())
        lh, uh = acc_bounds(shape)
        L1, L2 = mpc_cfg.L1_pen, mpc_cfg.L2_pen
        # state-constraint rows: [h..., delta_f] per node; none on delta_f at node 0
        con_lb = np.tile(np.concatenate([lh, [vp.delta_f_min]]), (N + 1, 1))
        con_ub = np.tile(np.concatenate([uh, [vp.delta_f_max]]), (N + 1, 1))
        con_lb[0, nh] = -BIG
        con_ub[0, nh] = BIG
        con_z1 = np.full_like(con_lb, L1)
        con_z2 = np.full_like(con_lb, L2)
        # input rows: [jerk (unbounded), steering_rate]; hard at node 0
        u_lb = np.tile([-BIG, vp.delta_f_dot_min], (N, 1))
        u_ub = np.tile([BIG, vp.delta_f_dot_max], (N, 1))
        u_z1 = np.full_like(u_lb, L1)
        u_z2 = np.full_like(u_lb, L2)
        u_z1[0, :] = 0.0
        u_z2[0, :] = HARD_Z2

        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        funcs = OCPFunctions(
            y_stage=y_stage,
            y_term=y_term,
            con_stage=con_stage,
            lin_rollout=LinearizeRollout(vp, tp, dt, N_SHOOTING_SUBSTEPS, self.nx),
            y_select=(0, 1, 2, 3),
            y_select_term=(0, 1, 2, 3),
            resid_stage=resid_lonlat if external else None,
            resid_term=lonlat if external else None,
        )
        self.engine = RTIEngine(
            funcs=funcs, N=N, nx=self.nx, nu=self.nu, W=t(W), We=t(We),
            con_lb=t(con_lb), con_ub=t(con_ub), con_z1=t(con_z1), con_z2=t(con_z2),
            u_lb=t(u_lb), u_ub=t(u_ub), u_z1=t(u_z1), u_z2=t(u_z2),
            newton_iters=mpc_cfg.qp_iters, lm_reg=0.1 if external else 0.0,
            sqp_iters=mpc_cfg.sqp_iters,
        )

    # ------------------------------------------------------------------
    def init_state(self, x0) -> RTIState:
        return self.engine.init_state(x0)

    def make_yref(self, ref_window):
        """(B, N, 6) stage refs + (B, 4) terminal refs from an (N+1)-point
        window; the u-references are zero."""
        N = self.N
        pos, yaw, v = ref_window.pos, ref_window.yaw, ref_window.v
        zeros = torch.zeros(pos.shape[:1] + (N, self.nu), dtype=pos.dtype, device=pos.device)
        stage = torch.cat([pos[:, :N], yaw[:, :N, None], v[:, :N, None], zeros], dim=2)
        term = torch.cat([pos[:, N], yaw[:, N, None], v[:, N, None]], dim=1)
        return stage, term

    def solve(self, state: RTIState, x0, ref_window, mods=None):
        """One RTI step; `mods` an optional QPMods. Returns
        (ControllerOutput, new RTIState)."""
        yref, yref_e = self.make_yref(ref_window)
        u0, new_state, st = self.engine.solve(state, x0, yref, yref_e, mods)
        return self._output(u0, new_state, st), new_state

    def _output(self, u0, new_state: RTIState, st) -> ControllerOutput:
        """The engine's result as a ControllerOutput: the node-0 steering-rate
        bound is hard, so the returned control is clipped to it."""
        u0 = torch.stack(
            [u0[:, 0], torch.clamp(u0[:, 1], self.vp.delta_f_dot_min, self.vp.delta_f_dot_max)],
            dim=1,
        )
        dt = st.cost.dtype
        stats = torch.stack(
            [st.cost, torch.zeros_like(st.cost), st.sqp_iter.to(dt), st.qp_iter.to(dt),
             st.status.to(dt)],
            dim=1,
        )
        return ControllerOutput(u0=u0, pred_X=new_state.X, stats=stats)
