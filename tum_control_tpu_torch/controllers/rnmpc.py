"""Reduced Robustified NMPC (R2NMPC): ellipsoidal uncertainty sets with
zero-order constraint tightening; batched port of
tum_control_tpu/controllers/rnmpc.py.

The OCP is the nominal NMPC's. Robustness enters as per-stage back-offs on
the steering bound and the acceleration constraints, computed outside the
QP from the propagated state covariance:

    Sigma_{k+1} = A_k Sigma_k A_k' + B W_disc B'
    backoff_h   = sqrt(grad_h' Sigma_k grad_h)
    backoff_df  = sqrt(Sigma_k[6, 6])

with A_k the K1 sensitivities of the last solve (`RTIEngine.solve_full`'s
A_lin), gradients at the new solution, stages >= UPH reusing the last
correction. The corrections are carried in the closed loop's `extra` state
and tighten the bounds of the *next* solve (a one-step delay); they refresh
only in scenarios whose solve succeeded (status 0).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.controllers.common import GGTables, acc_constraints
from tum_control_tpu_torch.controllers.nominal import NominalNMPC
from tum_control_tpu_torch.ops.rti import QPMods, RTIState, jacobian_fwd
from tum_control_tpu_torch.params import TireParams, VehicleParams
from tum_control_tpu_torch.utils.trace import span


class RobustExtra(NamedTuple):
    corr_steer: torch.Tensor  # (B, N+1) steering-bound back-off per node
    corr_acc: torch.Tensor    # (B, N+1, nh) acceleration-constraint back-off


class ReducedRobustNMPC(NominalNMPC):
    """Nominal NMPC + carried constraint-tightening state (RobustExtra)."""

    def __init__(self, mpc_cfg: MPCConfig, N: int, dt: float, vp: VehicleParams,
                 tp: TireParams, gg: GGTables, device=None, dtype=torch.float32):
        super().__init__(mpc_cfg, N, dt, vp, tp, gg, device=device, dtype=dtype)
        self.uph = mpc_cfg.uncertainty_propagation_horizon
        if not 1 <= self.uph <= N:
            raise ValueError(f"uncertainty_propagation_horizon must lie in 1..N={N}, "
                             f"got {self.uph}")
        stds = np.asarray(mpc_cfg.stds)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.engine.W.device)
        # disturbance ellipsoid on [yaw, vlong, vlat, yawrate]
        self.W_disc = t(dt * np.diag(stds[2:6]) ** 2)
        # initial covariance (coeff_Sigma = 0.5, tiny floor elsewhere)
        self.Sigma0 = t((0.5 * np.diag([1e-5, 1e-5, stds[2], stds[3], stds[4], stds[5],
                                        1e-5, 1e-5])) ** 2)
        Bsel = np.zeros((8, 4))
        Bsel[2, 0] = Bsel[3, 1] = Bsel[4, 2] = Bsel[5, 3] = 1.0
        self.Bsel = t(Bsel)
        self.BWB = self.Bsel @ self.W_disc @ self.Bsel.T
        # steering rows are tightened at nodes 1..N-1 only: the reference never
        # touches the terminal node's lbx_e/ubx_e or the h-bounds at node 0
        mask = np.zeros(N + 1)
        mask[1:N] = 1.0
        self.node_mask = t(mask)
        shape = mpc_cfg.combined_acc_limits

        def h_fn(x):
            return acc_constraints(x[..., 3], x[..., 7], x[..., 3] * x[..., 5], gg, vp.acc_min,
                                   shape)

        self._h_fn = h_fn

    # ------------------------------------------------------------------
    def init_extra(self, x0) -> RobustExtra:
        """Zero corrections for the scenarios of x0 (B, 8)."""
        B = x0.shape[0]
        return RobustExtra(
            corr_steer=x0.new_zeros((B, self.N + 1)),
            corr_acc=x0.new_zeros((B, self.N + 1, self.nh)),
        )

    def _mods_from_extra(self, extra: RobustExtra, mods: QPMods = None) -> QPMods:
        """Bound-tightening QPMods, (B, N+1, nc) bounds; merges with the
        caller's `mods` (WMPC's weight fields, disjoint from these), whose
        own con_lb / con_ub it replaces, as the JAX package does."""
        eng = self.engine
        steer = self.node_mask * extra.corr_steer                     # (B, N+1)
        zeros_h = torch.zeros_like(extra.corr_acc)
        con_lb = eng.con_lb + torch.cat([zeros_h, steer[..., None]], dim=-1)
        con_ub = eng.con_ub + torch.cat([-self.node_mask[:, None] * extra.corr_acc,
                                         -steer[..., None]], dim=-1)
        return (QPMods() if mods is None else mods)._replace(con_lb=con_lb, con_ub=con_ub)

    def _propagate(self, A_lin, X_new, extra: RobustExtra) -> RobustExtra:
        """Covariance recurrence over stages 0..UPH-1 -> new corrections;
        A_lin (B, N, 8, 8), X_new (B, N+1, 8). Stage 0's correction is never
        used (the reference computes none there), unless UPH = 1 makes it
        the one every stage reuses."""
        uph, N = self.uph, self.N
        B = X_new.shape[0]
        k0 = 1 if uph > 1 else 0
        _, grad_h = jacobian_fwd(self._h_fn, X_new[:, k0:uph])        # (B, uph-k0, nh, 8)
        Sigma = self.Sigma0.expand(B, 8, 8)
        cs, ca = [], []
        for k in range(uph):
            if k >= k0:
                g = grad_h[:, k - k0]
                quad = torch.sum(torch.matmul(g, Sigma) * g, dim=-1)  # grad' Sigma grad per row
                ca.append(torch.sqrt(torch.clamp(quad, min=0.0)))
                cs.append(torch.sqrt(torch.clamp(Sigma[:, 6, 6], min=0.0)))
            if k < uph - 1:
                Ak = A_lin[:, k]
                Sigma = torch.matmul(torch.matmul(Ak, Sigma), Ak.transpose(1, 2)) + self.BWB
        cs, ca = torch.stack(cs, dim=1), torch.stack(ca, dim=1)       # (B, uph-k0[, nh])
        tail = N + 1 - uph
        corr_steer = torch.cat([X_new.new_zeros((B, 1)), cs[:, 1 - k0:],
                                cs[:, -1:].expand(B, tail)], dim=1)
        corr_acc = torch.cat([X_new.new_zeros((B, 1, self.nh)), ca[:, 1 - k0:],
                              ca[:, -1:].expand(B, tail, self.nh)], dim=1)
        return RobustExtra(corr_steer=corr_steer, corr_acc=corr_acc)

    # ------------------------------------------------------------------
    def solve_with_extra(self, state: RTIState, extra: RobustExtra, x0, ref_window,
                         mods: QPMods = None):
        """One RTI under the carried tightening. Returns (ControllerOutput,
        new RTIState, new RobustExtra). The new corrections are the span
        `tc.rnmpc.tighten` (utils/trace.py)."""
        yref, yref_e = self.make_yref(ref_window)
        mods = self._mods_from_extra(extra, mods)
        u0, new_state, st, A_lin = self.engine.solve_full(state, x0, yref, yref_e, mods)
        with span("tc.rnmpc.tighten"):
            new_extra = self._propagate(A_lin, new_state.X, extra)
            ok = st.status == 0
            new_extra = RobustExtra(*(
                torch.where(ok.view((-1,) + (1,) * (n.dim() - 1)), n, o)
                for n, o in zip(new_extra, extra)))
        return self._output(u0, new_state, st), new_state, new_extra
