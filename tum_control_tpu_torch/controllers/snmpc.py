"""Stochastic NMPC (SNMPC): PCE-based chance constraints with an uncertainty
propagation horizon (UPH); batched port of
tum_control_tpu/controllers/snmpc.py.

  * stacked state of (n_samples + 1) copies of the 8-state model; the
    initial state is fanned from the measured state with std-scaled
    Hammersley normal samples on the uncertain components (pce.py),
  * discrete shooting dynamics: one RK4 step per copy over Ts_MPC; nodes
    k >= UPH freeze the samples and propagate only the nominal copy; below
    the UPH the nominal next state is the PCE mean of the propagated samples,
  * cost on the nominal copy only, with vel_abs = sqrt(vlong^2 + vlat^2),
  * chance constraints as deterministic surrogates mean + kappa * sigma of
    the per-sample gg values through the PCE regression matrix,
    kappa = sqrt((1 - gamma) / gamma); nodes k >= UPH use the nominal h.

The JAX package's stage index k (its `stop[k]` flag) becomes a static
slice of the node axis at the UPH. Two QP assemblies, as there:

  * structured (the default, the main path): `build_qp` + `expand_dx` from
    the block-sparse pieces of `lin_structured` — K1 at one RK4 substep on
    UPH x (n_samples + 1) + (N - UPH) elements per scenario (88 at the
    shipped N = 38, UPH = 5, 10 samples), the UPH head recurrence in plain
    torch, and K6 (ops/kernels/condense.py::condense_from) for the nominal
    tail; the dense (N+1, 88, nz) Gamma is never formed. The engine also
    gets the JAX package's `lin_condense`, `con_jac` and `y_jac` hooks (the
    dense Gamma from those pieces, the analytic constraint and output
    Jacobians); build_qp takes precedence over them, and
    tools/snmpc_dissect.py times them one by one;
  * dense (`structured=False`): the generic engine path over the 88-state
    stack (`dyn_jac`, condensing, forward-mode AD of the cost and
    constraints) — the oracle the structured path is tested against, on
    the CPU (K2 refuses a state wider than 16 on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from tum_control_tpu_torch.config import MPCConfig
from tum_control_tpu_torch.controllers import pce
from tum_control_tpu_torch.controllers.common import (
    GGTables, N_H, acc_bounds, acc_constraints, acc_constraints_jac, wrap_2pi,
)
from tum_control_tpu_torch.controllers.nominal import HARD_Z2, ControllerOutput
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.ops.kernels.condense import condense_from
from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout
from tum_control_tpu_torch.ops.rti import BIG, OCPFunctions, RTIEngine, RTIState, qp_rows
from tum_control_tpu_torch.ops.soft_qp import CondensedQP, mtv
from tum_control_tpu_torch.params import TireParams, VehicleParams


class StochasticNMPC:
    """Batched SNMPC; `state` is an RTIState over the stacked state
    (B, N+1, 8 (n_samples + 1)). Its tensors live on `device` (cuda unless
    named, device.py)."""

    nu = 2

    def __init__(self, mpc_cfg: MPCConfig, N: int, dt: float, vp: VehicleParams,
                 tp: TireParams, gg: GGTables, structured: bool = True, device=None,
                 dtype=torch.float32):
        device = resolve_device(device)
        self.cfg = mpc_cfg
        self.N, self.dt = N, dt
        self.vp, self.tp, self.gg = vp, tp, gg
        shape = mpc_cfg.combined_acc_limits
        nh = N_H[shape]
        self.nh = nh
        nu = self.nu
        nz = N * nu

        self.n_samples = ns = mpc_cfg.n_samples
        ns1 = ns + 1
        self.nx = nx = 8 * ns1
        self.stds = np.asarray(mpc_cfg.stds)
        n_vars = int(np.count_nonzero(self.stds))
        self.w_samples, A_np = pce.regression_matrix(ns, n_vars, mpc_cfg.expansion_degree)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.fan_offsets = t(pce.fan_offsets(self.w_samples, self.stds))   # (ns1, 8)
        A = t(A_np)           # (L, ns) PCE regression matrix
        A0 = A[0]             # PCE mean weights over the samples
        kappa = float(np.sqrt((1.0 - mpc_cfg.gamma) / mpc_cfg.gamma))
        uph = mpc_cfg.uncertainty_propagation_horizon
        ue = max(0, min(uph, N))           # live shooting nodes 0 .. ue-1
        c_split = max(0, min(uph, N + 1))  # nodes whose constraint is the surrogate
        self.uph_eff = ue

        # per-copy RK4 step and its fused sensitivity (K1 at one substep)
        lin_roll8 = LinearizeRollout(vp, tp, dt, 1)
        step8 = lin_roll8.step
        self.lin_roll8 = lin_roll8
        eye8 = torch.eye(8, dtype=dtype, device=device)

        def nodes(live, frozen, axis):
            """Nodes < UPH from `live`, the rest from `frozen` (node axis `axis`)."""
            return torch.cat([live.narrow(axis, 0, ue),
                              frozen.narrow(axis, ue, frozen.shape[axis] - ue)], dim=axis)

        def dyn_step(x, u):
            """The stacked discrete dynamics, x (..., N, nx), u (..., N, nu) ->
            next states; the engine linearizes them through dyn_jac or
            lin_structured, which reproduce its F."""
            xs = x.unflatten(-1, (ns1, 8))
            nxt = step8(xs, u[..., None, :].expand(*xs.shape[:-1], nu))
            mean_next = torch.matmul(A0, nxt[..., 1:, :])
            live = torch.cat([mean_next[..., None, :], nxt[..., 1:, :]], dim=-2)
            frozen = torch.cat([nxt[..., :1, :], xs[..., 1:, :]], dim=-2)
            return nodes(live, frozen, -3).flatten(-2)

        def dyn_jac(x, u):
            """Stacked-state linearization (B, N, nx), (B, N, nu) -> F, A, B
            assembled from per-copy 8x10 Jacobians: each sample's block
            depends only on itself; below the UPH the nominal row mixes the
            samples' blocks through the PCE mean weights."""
            Bt = x.shape[0]
            xs = x.unflatten(-1, (ns1, 8))                     # (B, N, ns1, 8)
            XU = torch.cat([xs, u[:, :, None, :].expand(Bt, N, ns1, nu)], dim=-1)
            F_all, J_all = lin_roll8(XU.reshape(Bt, N * ns1, 8 + nu).contiguous())
            F_all = F_all.reshape(Bt, N, ns1, 8)
            J_all = J_all.reshape(Bt, N, ns1, 8, 8 + nu)
            A_blk, B_blk = J_all[..., :8], J_all[..., 8:]

            mean_next = torch.matmul(A0, F_all[:, :, 1:])
            F = nodes(torch.cat([mean_next[:, :, None], F_all[:, :, 1:]], dim=2),
                      torch.cat([F_all[:, :, :1], xs[:, :, 1:]], dim=2), 1).flatten(-2)

            A_eff = nodes(torch.cat([torch.zeros_like(A_blk[:, :, :1]), A_blk[:, :, 1:]], dim=2),
                          torch.cat([A_blk[:, :, :1],
                                     eye8.expand_as(A_blk[:, :, 1:])], dim=2), 1)
            diag_sel = torch.eye(ns1, dtype=x.dtype, device=x.device)[:, None, :, None]
            A4 = diag_sel * A_eff[:, :, :, :, None, :]          # (B, N, ns1, 8, ns1, 8)
            coupling = A0[:, None, None] * A_blk[:, :, 1:]      # (B, N, ns, 8, 8)
            coupling = nodes(coupling, torch.zeros_like(coupling), 1)
            A4[:, :, 0, :, 1:, :] = coupling.permute(0, 1, 3, 2, 4)
            B_nom = nodes(torch.einsum("s,bnsij->bnij", A0, B_blk[:, :, 1:]), B_blk[:, :, 0], 1)
            B_smp = nodes(B_blk[:, :, 1:], torch.zeros_like(B_blk[:, :, 1:]), 1)
            Bm = torch.cat([B_nom[:, :, None], B_smp], dim=2).reshape(Bt, N, nx, nu)
            return F, A4.reshape(Bt, N, nx, nx), Bm

        def lin_structured(X, U, d0):
            """Structure-exploiting linearize + condense; X (B, N+1, nx),
            U (B, N, nu), d0 (B, nx). Two phases:

              stages < UPH: per-copy (8,8)@(8,nz) propagation, the nominal
                row recombined as the PCE mean of the sample blocks
                (plain torch, UPH stages);
              stages >= UPH: only the nominal block evolves, through K6
                from the head's carry; sample Gammas stay constant and
                sample e's accumulate the trajectory defects.

            Returns e_full (B, N+1, ns1, 8), Gam_nom (B, N+1, 8, nz),
            G_head (B, ue+1, ns1, 8, nz), G_frozen (B, ns, 8, nz)."""
            Bt = X.shape[0]
            Xs = X[:, :-1].unflatten(-1, (ns1, 8))
            Xn = X[:, 1:].unflatten(-1, (ns1, 8))
            # K1 only where sensitivities are consumed: all copies on the
            # head stages, the nominal copy alone on the frozen tail, in the
            # JAX package's (stage, copy) row order
            XU_head = torch.cat([Xs[:, :ue], U[:, :ue, None, :].expand(Bt, ue, ns1, nu)],
                                dim=-1).reshape(Bt, ue * ns1, 8 + nu)
            XU_tail = torch.cat([Xs[:, ue:, 0], U[:, ue:]], dim=-1)
            F_flat, J_flat = lin_roll8(torch.cat([XU_head, XU_tail], dim=1))
            F_head = F_flat[:, :ue * ns1].reshape(Bt, ue, ns1, 8)
            J_head = J_flat[:, :ue * ns1].reshape(Bt, ue, ns1, 8, 8 + nu)
            A_blk, B_blk = J_head[..., :8], J_head[..., 8:]
            F_tailn, J_tailn = F_flat[:, ue * ns1:], J_flat[:, ue * ns1:]

            # head defects: the nominal next state is the PCE mean of the samples
            mean_next = torch.matmul(A0, F_head[:, :, 1:])
            xi = torch.cat([(mean_next - Xn[:, :ue, 0])[:, :, None],
                            F_head[:, :, 1:] - Xn[:, :ue, 1:]], dim=2)   # (B, ue, ns1, 8)
            xi_tailn = F_tailn - Xn[:, ue:, 0]                           # (B, N-ue, 8)
            xi_tails = Xs[:, ue:, 1:] - Xn[:, ue:, 1:]                   # (B, N-ue, ns, 8)

            e = d0.reshape(Bt, ns1, 8)
            G = torch.zeros((Bt, ns1, 8, nz), dtype=X.dtype, device=X.device)
            e_head, G_head = [e], [G]
            for k in range(ue):
                Pe = torch.matmul(A_blk[:, k], e[..., None])[..., 0]
                PG = torch.matmul(A_blk[:, k], G)
                PG[..., k * nu:(k + 1) * nu] += B_blk[:, k]
                e = torch.cat([(torch.matmul(A0, Pe[:, 1:]) + xi[:, k, 0])[:, None],
                               Pe[:, 1:] + xi[:, k, 1:]], dim=1)
                G = torch.cat([torch.einsum("s,bsiz->biz", A0, PG[:, 1:])[:, None], PG[:, 1:]],
                              dim=1)
                e_head.append(e)
                G_head.append(G)
            e_head, G_head = torch.stack(e_head, dim=1), torch.stack(G_head, dim=1)
            e_c, G_c = e, G

            if N > ue:
                e_nom2, G_nom2 = condense_from(
                    J_tailn[..., :8].contiguous(), J_tailn[..., 8:].contiguous(),
                    xi_tailn.contiguous(), e_c[:, 0].contiguous(), G_c[:, 0].contiguous(), ue * nu,
                )                                                        # (B, N-ue+1, 8 / 8,nz)
                e_smp2 = e_c[:, None, 1:] + torch.cat(
                    [torch.zeros_like(xi_tails[:, :1]), torch.cumsum(xi_tails, dim=1)], dim=1)
                e_tail2 = torch.cat([e_nom2[:, :, None], e_smp2], dim=2)
                e_full = torch.cat([e_head[:, :-1], e_tail2], dim=1)
                Gam_nom = torch.cat([G_head[:, :-1, 0], G_nom2], dim=1)
            else:
                e_full, Gam_nom = e_head, G_head[:, :, 0]
            return e_full, Gam_nom, G_head, G_c[:, 1:]

        def lin_condense(X, U, d0):
            """The dense condensing (B, N+1, nx), (B, N+1, nx, nz) assembled
            from the structured pieces: the samples' Gammas of the head
            stages, then their frozen block at every later node."""
            Bt = X.shape[0]
            e_full, Gam_nom, G_head, G_frozen = lin_structured(X, U, d0)
            H = G_head.shape[1]
            G_smp = torch.cat([G_head[:, :, 1:],
                               G_frozen[:, None].expand(Bt, N + 1 - H, ns, 8, nz)], dim=1)
            G_full = torch.cat([Gam_nom[:, :, None], G_smp], dim=2)
            return e_full.reshape(Bt, N + 1, nx), G_full.reshape(Bt, N + 1, nx, nz)

        self.dyn_step = dyn_step
        self._lin_structured = lin_structured

        def h_of(x8):
            vel_abs = torch.sqrt(x8[..., 3] ** 2 + x8[..., 4] ** 2)
            return acc_constraints(vel_abs, x8[..., 7], x8[..., 3] * x8[..., 5], gg, vp.acc_min,
                                   shape)

        def h_jac(x8):
            return acc_constraints_jac(x8, gg, vp.acc_min, shape)

        def surrogate(h_smp):
            """Per-sample h (..., ns, nh) -> PCE coefficients (..., L, nh),
            sigma (..., nh) and the chance-constraint value mean + kappa sigma."""
            coeff = torch.matmul(A, h_smp)
            sd = torch.sqrt(torch.sum(coeff[..., 1:, :] ** 2, dim=-2) + 1e-30)
            return coeff, sd, coeff[..., 0, :] + sd * kappa

        def sample_weights(coeff, sd):
            """d h_cc / d h_j per sample: A[0, j] + kappa sum_l coeff_l A[l, j] / sigma,
            (..., ns, nh)."""
            return A0[:, None] + kappa * torch.einsum(
                "...lr,lj->...jr", coeff[..., 1:, :], A[1:]) / sd[..., None, :]

        def build_qp_structured(X, U, x0, yref, yref_e, merged):
            """The whole QP from the structured sensitivities: cost rows from
            the nominal block (the vel_abs row is c3 row3 + c4 row4),
            chance-constraint rows from the samples below the UPH and from
            the nominal block at the frozen nodes, identity input rows."""
            W, We, con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2 = merged
            Bt = X.shape[0]
            e_full, Gam_nom, G_head, G_frozen = lin_structured(X, U, x0 - X[:, 0])
            xs = X.unflatten(-1, (ns1, 8))                      # (B, N+1, ns1, 8)
            e_nom = e_full[:, :, 0]                             # (B, N+1, 8)

            # --- cost rows (nominal copy only) ---
            xn = xs[:, :-1, 0]
            v_abs = torch.sqrt(xn[..., 3] ** 2 + xn[..., 4] ** 2 + 1e-30)
            c3, c4 = xn[..., 3] / v_abs, xn[..., 4] / v_abs
            r_x = torch.stack([
                xn[..., 0] - yref[..., 0] + e_nom[:, :N, 0],
                xn[..., 1] - yref[..., 1] + e_nom[:, :N, 1],
                wrap_2pi(xn[..., 2]) - yref[..., 2] + e_nom[:, :N, 2],
                v_abs - yref[..., 3] + c3 * e_nom[:, :N, 3] + c4 * e_nom[:, :N, 4],
            ], dim=-1)                                          # (B, N, 4)
            r_u = U - yref[..., 4:]
            Mf = torch.cat([
                Gam_nom[:, :N, 0:3],
                (c3[..., None] * Gam_nom[:, :N, 3] + c4[..., None] * Gam_nom[:, :N, 4])[:, :, None],
            ], dim=2)                                           # (B, N, 4, nz)
            xT = xs[:, N, 0]
            vT = torch.sqrt(xT[:, 3] ** 2 + xT[:, 4] ** 2 + 1e-30)
            cT3, cT4 = xT[:, 3] / vT, xT[:, 4] / vT
            re0 = torch.stack([
                xT[:, 0] - yref_e[:, 0] + e_nom[:, N, 0],
                xT[:, 1] - yref_e[:, 1] + e_nom[:, N, 1],
                wrap_2pi(xT[:, 2]) - yref_e[:, 2] + e_nom[:, N, 2],
                vT - yref_e[:, 3] + cT3 * e_nom[:, N, 3] + cT4 * e_nom[:, N, 4],
            ], dim=-1)                                          # (B, 4)
            Me = torch.cat([
                Gam_nom[:, N, 0:3],
                (cT3[:, None] * Gam_nom[:, N, 3] + cT4[:, None] * Gam_nom[:, N, 4])[:, None],
            ], dim=1)                                           # (B, 4, nz)
            Wx, Wu = W[..., :4], W[..., 4:]   # (ny,) static, or (B, ny) from QPMods
            Mf2 = Mf.reshape(Bt, N * 4, nz)
            wtsx = torch.tile(Wx, (N,))
            H0 = (torch.matmul((Mf2 * wtsx[..., None]).transpose(1, 2), Mf2)
                  + torch.matmul((Me * We[..., None]).transpose(1, 2), Me)
                  + torch.diag_embed(torch.tile(Wu, (N,))))
            g0 = (mtv(Mf2, wtsx * r_x.reshape(Bt, -1)) + (Wu.unsqueeze(-2) * r_u).reshape(Bt, -1)
                  + mtv(Me, We * re0))

            # --- constraint rows ---
            G_parts, c_parts = [], []
            if c_split > 0:
                h_all, dh_all = h_jac(xs[:, :c_split])          # (B,c,ns1,nh), (B,c,ns1,nh,8)
                coeff, sd, h_cc = surrogate(h_all[:, :, 1:])
                Js = sample_weights(coeff, sd)[..., None] * dh_all[:, :, 1:]  # (B,c,ns,nh,8)
                G_parts.append(torch.einsum("bksir,bksrz->bkiz", Js, G_head[:, :c_split, 1:]))
                c_parts.append(h_cc + torch.einsum("bksir,bksr->bki", Js, e_full[:, :c_split, 1:]))
            if c_split <= N:
                h_froz, dh_nom = h_jac(xs[:, c_split:, 0])      # (B,K,nh), (B,K,nh,8)
                G_parts.append(torch.matmul(dh_nom, Gam_nom[:, c_split:]))
                c_parts.append(h_froz + torch.matmul(dh_nom, e_nom[:, c_split:, :, None])[..., 0])
            G_h, c_h = torch.cat(G_parts, dim=1), torch.cat(c_parts, dim=1)
            G_c = torch.cat([G_h, Gam_nom[:, :, 6:7]], dim=2)   # (B, N+1, nc, nz)
            c0_c = torch.cat([c_h, (xs[:, :, 0, 6] + e_nom[:, :, 6])[..., None]], dim=2)

            qp = CondensedQP(
                H0=H0, g0=g0, G=G_c.reshape(Bt, -1, nz).contiguous(),
                c0=torch.cat([c0_c.reshape(Bt, -1), U.reshape(Bt, -1)], dim=1),
                lb=qp_rows(con_lb, u_lb, Bt), ub=qp_rows(con_ub, u_ub, Bt),
                z1=qp_rows(con_z1, u_z1, Bt), z2=qp_rows(con_z2, u_z2, Bt),
            )
            return qp, (e_full, Gam_nom, G_head, G_frozen)

        def expand_dx(aux, w):
            """dX = e + Gamma w from the structured pieces (B, N+1, nx); the
            sample blocks beyond the UPH share one constant sensitivity."""
            e_full, Gam_nom, G_head, G_frozen = aux
            H = G_head.shape[1]
            wv = w[:, None, :, None]
            dx_nom = e_full[:, :, 0] + torch.matmul(Gam_nom, wv)[..., 0]
            dx_head = e_full[:, :H, 1:] + torch.matmul(G_head[:, :, 1:], w[:, None, None, :, None])[..., 0]
            dx_froz = e_full[:, H:, 1:] + torch.matmul(G_frozen, wv)[..., 0][:, None]
            dx_smp = torch.cat([dx_head, dx_froz], dim=1)
            return torch.cat([dx_nom[:, :, None], dx_smp], dim=2).reshape(w.shape[0], N + 1, nx)

        def y_stage(x, u):
            vel_abs = torch.sqrt(x[..., 3:4] ** 2 + x[..., 4:5] ** 2)
            return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), vel_abs, u], dim=-1)

        def y_term(x):
            vel_abs = torch.sqrt(x[..., 3:4] ** 2 + x[..., 4:5] ** 2)
            return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), vel_abs], dim=-1)

        def con_stage(x):
            """x (..., N+1, nx) -> (..., N+1, nh + 1): the chance-constraint
            surrogate below the UPH, the nominal h beyond; the delta_f row on
            the nominal copy."""
            xs = x.unflatten(-1, (ns1, 8))
            h_all = h_of(xs)                                    # (..., N+1, ns1, nh)
            h_cc = surrogate(h_all[..., 1:, :])[2]
            h = torch.cat([h_cc[..., :c_split, :], h_all[..., c_split:, 0, :]], dim=-2)
            return torch.cat([h, xs[..., 0, 6:7]], dim=-1)

        def con_jac(x):
            """con_stage's value and its analytic Jacobian over the stacked
            state, x (..., N+1, nx) -> ((..., N+1, nh + 1), (..., N+1, nh + 1,
            nx)): below the UPH d h_cc / d x_j is sample j's weight times its
            own h-Jacobian (sample_weights), beyond it the nominal copy's
            h-Jacobian; the delta_f row is the nominal copy's unit row."""
            xs = x.unflatten(-1, (ns1, 8))
            h_all, dh_all = h_jac(xs)                  # (..., N+1, ns1, nh), (..., nh, 8)
            coeff, sd, h_cc = surrogate(h_all[..., 1:, :])
            J_cc = torch.cat([torch.zeros_like(dh_all[..., :1, :, :]),
                              sample_weights(coeff, sd)[..., None] * dh_all[..., 1:, :, :]],
                             dim=-3)
            J_nom = torch.cat([dh_all[..., :1, :, :], torch.zeros_like(dh_all[..., 1:, :, :])],
                              dim=-3)
            C_h = torch.cat([h_cc[..., :c_split, :], h_all[..., c_split:, 0, :]], dim=-2)
            J_h = torch.cat([J_cc[..., :c_split, :, :, :], J_nom[..., c_split:, :, :, :]], dim=-4)
            J_df = torch.zeros(x.shape[:-1] + (1, nx), dtype=x.dtype, device=x.device)
            J_df[..., 0, 6] = 1.0
            return (torch.cat([C_h, xs[..., 0, 6:7]], dim=-1),
                    torch.cat([J_h.transpose(-3, -2).flatten(-2), J_df], dim=-2))

        def y_jac(x, u):
            """y_stage's value and its analytic Jacobians, x (..., N, nx),
            u (..., N, nu) -> Y (..., N, 4 + nu), Jx (..., N, 4 + nu, nx),
            Ju (..., N, 4 + nu, nu): y reads the nominal copy's position,
            yaw and speed, and u."""
            vel_abs = torch.sqrt(x[..., 3] ** 2 + x[..., 4] ** 2 + 1e-30)
            Y = torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), vel_abs[..., None], u], dim=-1)
            Jx = torch.zeros(x.shape[:-1] + (4 + nu, nx), dtype=x.dtype, device=x.device)
            for i in range(3):
                Jx[..., i, i] = 1.0
            Jx[..., 3, 3] = x[..., 3] / vel_abs
            Jx[..., 3, 4] = x[..., 4] / vel_abs
            Ju = torch.zeros(x.shape[:-1] + (4 + nu, nu), dtype=x.dtype, device=x.device)
            Ju[..., 4, 0] = 1.0
            Ju[..., 5, 1] = 1.0
            return Y, Jx, Ju

        W = 0.01 * np.concatenate([np.diag(mpc_cfg.Q()), np.diag(mpc_cfg.R())])
        We = 0.01 * np.diag(mpc_cfg.Q())
        lh, uh = acc_bounds(shape)
        L1, L2 = mpc_cfg.L1_pen, mpc_cfg.L2_pen
        con_lb = np.tile(np.concatenate([lh, [vp.delta_f_min]]), (N + 1, 1))
        con_ub = np.tile(np.concatenate([uh, [vp.delta_f_max]]), (N + 1, 1))
        con_lb[0, nh] = -BIG
        con_ub[0, nh] = BIG
        con_z1 = np.full_like(con_lb, L1)
        con_z2 = np.full_like(con_lb, L2)
        u_lb = np.tile([-BIG, vp.delta_f_dot_min], (N, 1))
        u_ub = np.tile([BIG, vp.delta_f_dot_max], (N, 1))
        u_z1 = np.full_like(u_lb, L1)
        u_z2 = np.full_like(u_lb, L2)
        u_z1[0, :] = 0.0
        u_z2[0, :] = HARD_Z2

        hooks = dict(build_qp=build_qp_structured, expand_dx=expand_dx, lin_condense=lin_condense,
                     con_jac=con_jac, y_jac=y_jac) if structured else {}
        self.engine = RTIEngine(
            funcs=OCPFunctions(y_stage=y_stage, y_term=y_term, con_stage=con_stage,
                               dyn_jac=dyn_jac, **hooks),
            N=N, nx=nx, nu=nu, W=t(W), We=t(We),
            con_lb=t(con_lb), con_ub=t(con_ub), con_z1=t(con_z1), con_z2=t(con_z2),
            u_lb=t(u_lb), u_ub=t(u_ub), u_z1=t(u_z1), u_z2=t(u_z2),
            newton_iters=mpc_cfg.qp_iters, sqp_iters=mpc_cfg.sqp_iters,
        )

    # ------------------------------------------------------------------
    def _fan(self, x0):
        """x0 (B, 8) -> the stacked initial state (B, nx)."""
        return pce.fan_initial_state(x0, self.fan_offsets).flatten(-2)

    def init_state(self, x0) -> RTIState:
        return self.engine.init_state(self._fan(x0))

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
        """One RTI step from the measured x0 (B, 8). Returns
        (ControllerOutput with the nominal block's prediction, new RTIState)."""
        yref, yref_e = self.make_yref(ref_window)
        u0, new_state, st = self.engine.solve(state, self._fan(x0), yref, yref_e, mods)
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
        return ControllerOutput(u0=u0, pred_X=new_state.X[..., :8], stats=stats), new_state
