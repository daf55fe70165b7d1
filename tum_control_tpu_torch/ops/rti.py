"""SQP-RTI engine: one real-time iteration = linearize -> condense -> soft QP
(batched port of tum_control_tpu/ops/rti.py).

One `solve_full` per control step, for B scenarios at once:
  1. linearize the shooting dynamics at the stored iterate (X, U) with the
     controller's fused rollout + sensitivity function (K1),
  2. condense the state deviations onto w = vec(dU) (K2),
  3. assemble the Gauss-Newton QP through the selection-structured cost
     (`y_select`) and the state-constraint rows,
  4. solve it with the interior-point method and one Newton polish
     (ops/ipm.py: K3, K4, K5), update the iterate with the linear QP step,
  5. reset a scenario whose result is non-finite, exploded or whose relative
     KKT residual exceeds `kkt_fail_rel` (acados status 3), per scenario.

This slice ports the engine paths the nominal NONLINEAR_LS controller
takes; the other `OCPFunctions` hooks of the JAX package raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tum_control_tpu_torch.ops.ipm import IPMWarm, init_warm, solve_soft_qp_ipm
from tum_control_tpu_torch.ops.kernels.condense import condense
from tum_control_tpu_torch.ops.soft_qp import CondensedQP, mtv

BIG = 1e12  # stands in for +/- inf bounds (inf would produce inf*0 NaNs)


class OCPFunctions(NamedTuple):
    """Controller-supplied batched problem functions (x (..., nx), u (..., nu)).

    y_stage  : (x, u) -> (..., ny)   nonlinear-LS stage output
    y_term   : (x) -> (..., ny_e)    nonlinear-LS terminal output
    con_stage: (x) -> (..., nc)      state-only nonlinear constraints
    lin_rollout: XU (B, N, nx+nu) -> (F (B, N, nx), J (B, N, nx, nx+nu))
    y_select / y_select_term: state indices of the leading y rows, when
        y = [x[sel] (unit Jacobian), u]
    """

    y_stage: Callable
    y_term: Callable
    con_stage: Callable
    lin_rollout: Callable
    y_select: tuple
    y_select_term: tuple


class RTIState(NamedTuple):
    """Warm-start memory carried between RTI calls."""

    X: torch.Tensor  # (B, N+1, nx) primal state trajectories
    U: torch.Tensor  # (B, N, nu) primal control trajectories
    warm: IPMWarm    # interior-point dual/slack warm start, (B, nc) each


class SolverStats(NamedTuple):
    cost: torch.Tensor      # (B,) nonlinear cost incl. slack penalties
    kkt_res: torch.Tensor   # (B,) inf-norm KKT residual of the QP solve
    sqp_iter: torch.Tensor  # (B,) int32 SQP iterations per control step
    qp_iter: torch.Tensor   # (B,) int32 IPM iterations that updated the iterate
    status: torch.Tensor    # (B,) int32 0 ok | 3 NaN/exploded (acados NAN_SOL)
    gap: torch.Tensor       # (B,) final IPM complementarity gap (normalized)


def jacobian_fwd(f, x):
    """Values and Jacobian of a per-row function f: (..., n) -> (..., m):
    returns ((..., m), (..., m, n)). One forward-mode pass over the rows
    repeated n times, row copy j carrying the unit tangent e_j."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    xr = x[..., None, :].expand(*x.shape[:-1], n, n).contiguous()
    y, dy = torch.func.jvp(f, (xr,), (eye.expand_as(xr).contiguous(),))
    return y[..., 0, :], dy.transpose(-1, -2)


class RTIEngine:
    """Static problem description + batched solve_full()."""

    def __init__(self, funcs: OCPFunctions, N: int, nx: int, nu: int, W, We,
                 con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2,
                 newton_iters: int = 15, sqp_iters: int = 1, kkt_fail_rel: float = 1e4):
        self.funcs = funcs
        self.N, self.nx, self.nu = N, nx, nu
        self.nz = N * nu
        self.W, self.We = W, We
        self.con_lb, self.con_ub, self.con_z1, self.con_z2 = con_lb, con_ub, con_z1, con_z2
        self.u_lb, self.u_ub, self.u_z1, self.u_z2 = u_lb, u_ub, u_z1, u_z2
        self.newton_iters = newton_iters
        self.sqp_iters = sqp_iters
        self.kkt_fail_rel = kkt_fail_rel
        self.nc_total = (N + 1) * con_lb.shape[1] + N * nu
        # QP row data: general (state-constraint) rows first, input rows last
        self.row_lb = torch.cat([con_lb.reshape(-1), u_lb.reshape(-1)])
        self.row_ub = torch.cat([con_ub.reshape(-1), u_ub.reshape(-1)])
        self.row_z1 = torch.cat([con_z1.reshape(-1), u_z1.reshape(-1)])
        self.row_z2 = torch.cat([con_z2.reshape(-1), u_z2.reshape(-1)])

    # ------------------------------------------------------------------
    def init_state(self, x0) -> RTIState:
        """acados-style cold start: all states at x0 (B, nx), controls zero."""
        B = x0.shape[0]
        X = x0[:, None, :].expand(B, self.N + 1, self.nx).clone()
        U = torch.zeros((B, self.N, self.nu), dtype=x0.dtype, device=x0.device)
        return RTIState(X=X, U=U, warm=init_warm(B, self.nc_total, x0.dtype, x0.device))

    def _linearize(self, state: RTIState):
        nx = self.nx
        XU = torch.cat([state.X[:, :-1], state.U], dim=2)
        F, J = self.funcs.lin_rollout(XU)
        return J[..., :nx].contiguous(), J[..., nx:].contiguous(), F - state.X[:, 1:]

    def _build_qp(self, state: RTIState, x0, yref, yref_e):
        N, nx, nz = self.N, self.nx, self.nz
        B = x0.shape[0]
        A, Bm, xi = self._linearize(state)
        e, Gam = condense(A, Bm, xi.contiguous(), (x0 - state.X[:, 0]).contiguous())

        # --- Gauss-Newton cost, selection-structured: y = [x[sel], u] ---
        sel = list(self.funcs.y_select)
        sel_e = list(self.funcs.y_select_term)
        ns = len(sel)
        Y = self.funcs.y_stage(state.X[:, :-1], state.U)            # (B, N, ny)
        r_x = Y[..., :ns] - yref[..., :ns] + e[:, :N][..., sel]     # (B, N, ns)
        r_u = Y[..., ns:] - yref[..., ns:]                          # (B, N, nu)
        Wx, Wu = self.W[:ns], self.W[ns:]
        Mf4 = Gam[:, :N][:, :, sel, :].reshape(B, N * ns, nz)
        wtsx = Wx.repeat(N)
        re0 = self.funcs.y_term(state.X[:, N]) - yref_e + e[:, N][:, sel_e]
        Me = Gam[:, N][:, sel_e, :]                                 # (B, ny_e, nz)
        H0 = (
            torch.matmul((Mf4 * wtsx[:, None]).transpose(1, 2), Mf4)
            + torch.matmul((Me * self.We[:, None]).transpose(1, 2), Me)
            + torch.diag(Wu.repeat(N))
        )
        g0 = (
            mtv(Mf4, wtsx * r_x.reshape(B, -1))
            + (Wu * r_u).reshape(B, -1)
            + mtv(Me, self.We * re0)
        )

        # --- constraint rows: value + Jacobian of con_stage at every node ---
        C, Jc = jacobian_fwd(self.funcs.con_stage, state.X)        # (B,N+1,nc), (B,N+1,nc,nx)
        c0_c = C + torch.sum(Jc * e[:, :, None, :], dim=-1)
        G = torch.matmul(Jc, Gam).reshape(B, -1, nz)
        c0 = torch.cat([c0_c.reshape(B, -1), state.U.reshape(B, -1)], dim=1)
        rows = lambda t: t.expand(B, -1).contiguous()
        qp = CondensedQP(H0=H0, g0=g0, G=G.contiguous(), c0=c0, lb=rows(self.row_lb),
                         ub=rows(self.row_ub), z1=rows(self.row_z1), z2=rows(self.row_z2))
        return qp, e, Gam, A

    # ------------------------------------------------------------------
    def nonlinear_cost(self, state: RTIState, yref, yref_e):
        """acados `get_cost()` analog: LS cost + slack penalties, (B,)."""
        N = self.N
        r = self.funcs.y_stage(state.X[:, :-1], state.U) - yref
        cost = 0.5 * torch.sum(r * r * self.W, dim=(1, 2))
        re = self.funcs.y_term(state.X[:, N]) - yref_e
        cost = cost + 0.5 * torch.sum(re * re * self.We, dim=1)
        C = self.funcs.con_stage(state.X)
        du = torch.clamp(C - self.con_ub, min=0.0)
        dl = torch.clamp(self.con_lb - C, min=0.0)
        cost = cost + torch.sum(self.con_z1 * (du + dl) + 0.5 * self.con_z2 * (du**2 + dl**2),
                                dim=(1, 2))
        duu = torch.clamp(state.U - self.u_ub, min=0.0)
        dul = torch.clamp(self.u_lb - state.U, min=0.0)
        return cost + torch.sum(self.u_z1 * (duu + dul) + 0.5 * self.u_z2 * (duu**2 + dul**2),
                                dim=(1, 2))

    # ------------------------------------------------------------------
    def solve(self, state: RTIState, x0, yref, yref_e, mods=None):
        """One RTI. Returns (u0 (B, nu), new_state, stats)."""
        u0, new_state, stats, _ = self.solve_full(state, x0, yref, yref_e, mods)
        return u0, new_state, stats

    def solve_full(self, state: RTIState, x0, yref, yref_e, mods=None):
        """One RTI returning also the dynamics sensitivities A (B, N, nx, nx).

        A scenario whose result fails the health check keeps its previous
        iterate and gets status 3; the caller re-initializes it."""
        if mods is not None:
            raise NotImplementedError("QPMods (WMPC / R2NMPC) wait for their slice of the port")
        B = x0.shape[0]
        it_state = state
        qp_iter_max = torch.zeros((B,), dtype=torch.int32, device=x0.device)
        gap_last = torch.zeros((B,), dtype=x0.dtype, device=x0.device)
        for _ in range(self.sqp_iters):
            qp, e, Gam, A_lin = self._build_qp(it_state, x0, yref, yref_e)
            w, kkt, warm_out, ipm_stats = solve_soft_qp_ipm(
                qp, n_iters=self.newton_iters, n_polish=1, warm=it_state.warm, want_stats=True
            )
            qp_iter_max = torch.maximum(qp_iter_max, ipm_stats.iters)
            gap_last = ipm_stats.gap
            dX = e + torch.matmul(Gam, w[:, None, :, None])[..., 0]
            it_state = RTIState(X=it_state.X + dX, U=it_state.U + w.reshape(B, self.N, self.nu),
                                warm=warm_out)
        X_new, U_new = it_state.X, it_state.U

        qp_scale = 1.0 + torch.amax(torch.abs(qp.g0), dim=1)
        good = (
            torch.isfinite(X_new).all(dim=(1, 2))
            & torch.isfinite(U_new).all(dim=(1, 2))
            & (torch.amax(torch.abs(X_new), dim=(1, 2)) < 1e7)
            & (torch.amax(torch.abs(U_new), dim=(1, 2)) < 1e4)
            & (kkt / qp_scale < self.kkt_fail_rel)
        )
        bad = ~good
        keep = lambda new, old: torch.where(bad.view((B,) + (1,) * (new.dim() - 1)), old, new)
        new_state = RTIState(
            X=keep(X_new, state.X),
            U=keep(U_new, state.U),
            warm=IPMWarm(*(keep(n, o) for n, o in zip(it_state.warm, state.warm))),
        )
        stats = SolverStats(
            cost=self.nonlinear_cost(new_state, yref, yref_e),
            kkt_res=kkt,
            sqp_iter=torch.full((B,), self.sqp_iters, dtype=torch.int32, device=x0.device),
            qp_iter=qp_iter_max,
            status=torch.where(bad, 3, 0).to(torch.int32),
            gap=gap_last,
        )
        return new_state.U[:, 0], new_state, stats, A_lin
