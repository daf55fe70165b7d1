"""SQP-RTI engine: one real-time iteration = linearize -> condense -> soft QP
(batched port of tum_control_tpu/ops/rti.py).

One `solve_full` per control step, for B scenarios at once:
  1. linearize the shooting dynamics at the stored iterate (X, U): the
     controller's fused rollout + sensitivity function (K1), else its
     `dyn_jac`, else forward-mode AD of its one-stage `dyn_step` (vmapped
     over every stage of every scenario: how a user's own OCP reaches the
     engine),
  2. condense the state deviations onto w = vec(dU) (K2),
  3. assemble the Gauss-Newton QP: from the Jacobians of the reference-
     dependent residuals `resid_stage` / `resid_term` (the EXTERNAL cost,
     by forward-mode AD; they take precedence over `y_select`), through the
     selection-structured cost (`y_select`), or by forward-mode AD of
     `y_stage`; add `lm_reg` I (Levenberg-Marquardt damping) to H0; the
     state-constraint rows through forward-mode AD of `con_stage`,
  4. solve it with the interior-point method and one Newton polish
     (ops/ipm.py: K3, K4, K5), update the iterate with the linear QP step,
  5. reset a scenario whose result is non-finite, exploded or whose relative
     KKT residual exceeds `kkt_fail_rel` (acados status 3), per scenario.

A controller may replace steps 1-3 by `build_qp` + `expand_dx` (SNMPC's
structured path: K1 + K6), or parts of them by `lin_condense` (steps 1-2),
`y_jac` (the cost's output Jacobians) and `con_jac` (the constraint rows'
Jacobian); build_qp takes precedence over the three. A solve may override
the engine's weights, bounds and slack penalties per scenario through
`QPMods` (WMPC's weight swaps, R2NMPC's bound tightening).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tum_control_tpu_torch.device import device_constant
from tum_control_tpu_torch.ops.ipm import IPMWarm, init_warm, solve_soft_qp_ipm
from tum_control_tpu_torch.ops.kernels.condense import condense
from tum_control_tpu_torch.ops.soft_qp import CondensedQP, mtv
from tum_control_tpu_torch.utils.trace import span

BIG = 1e12  # stands in for +/- inf bounds (inf would produce inf*0 NaNs)


class OCPFunctions(NamedTuple):
    """Controller-supplied batched problem functions.

    A stage function takes x (..., K, nx) with the node axis second to last
    (K = N nodes 0..N-1 for y_stage / dyn_jac, N+1 for con_stage) and u (..., N, nu); it may depend on the node
    index only through the position on that axis (SNMPC's uncertainty
    horizon is a static slice of it). Leading axes are batch axes.

    y_stage  : (x, u) -> (..., N, ny)     nonlinear-LS stage output
    y_term   : (x (..., nx)) -> (..., ny_e)  nonlinear-LS terminal output
    con_stage: (x) -> (..., N+1, nc)      state-only nonlinear constraints
    lin_rollout: XU (B, N, nx+nu) -> (F (B, N, nx), J (B, N, nx, nx+nu))
    dyn_jac  : (x, u) -> (F, A (..., N, nx, nx), B (..., N, nx, nu))
    y_select / y_select_term: state indices of the leading y rows, when
        y = [x[sel] (unit Jacobian), u]
    resid_stage: (x, u, yref (..., N, ny)) -> (..., N, ny) residual of a
        reference-dependent cost (the EXTERNAL cost's ego-frame lon/lat
        deviations), in place of y_stage(x, u) - yref
    resid_term: (x (..., nx), yref_e (..., ny_e)) -> (..., ny_e)
    lin_condense: (X (B, N+1, nx), U (B, N, nu), d0 (B, nx)) -> (e (B, N+1, nx),
        Gam (B, N+1, nx, nz)), in place of linearizing and condensing (A_lin
        is then zeros)
    y_jac    : (x, u) -> (Y (..., N, ny), Jx (..., N, ny, nx), Ju (..., N, ny, nu)),
        y_stage's value and Jacobians, in place of forward-mode AD (after
        y_select, before it when the cost is EXTERNAL)
    con_jac  : (x (..., N+1, nx)) -> (C (..., N+1, nc), Jc (..., N+1, nc, nx)),
        con_stage's value and Jacobian
    build_qp : (X, U, x0, yref, yref_e, merged) -> (CondensedQP, aux), the
        whole QP assembly; `merged` is `RTIEngine._merged(mods)`, the
        (W, We, con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2) of
        this solve, each unbatched (static) or batched (a QPMods field)
    expand_dx: (aux, w (B, nz)) -> dX (B, N+1, nx); required with build_qp
    dyn_step : (k, x (nx,), u (nu,)) -> x_next (nx,), the shooting step of
        one stage, unbatched (k the stage index, a 0-d integer tensor): the
        JAX package's required `dyn_step`, optional here and linearized by
        `torch.func.jacfwd` when neither lin_rollout nor dyn_jac is given
    """

    y_stage: Callable
    y_term: Callable
    con_stage: Callable
    lin_rollout: Callable = None
    dyn_jac: Callable = None
    y_select: tuple = None
    y_select_term: tuple = None
    resid_stage: Callable = None
    resid_term: Callable = None
    lin_condense: Callable = None
    y_jac: Callable = None
    con_jac: Callable = None
    build_qp: Callable = None
    expand_dx: Callable = None
    dyn_step: Callable = None


class QPMods(NamedTuple):
    """Per-solve, per-scenario overrides of the engine's static QP data
    (WMPC: cost weights and slack penalties; R2NMPC: constraint-bound
    tightening). A `None` field falls back to the engine's static tensor."""

    W: torch.Tensor = None       # (B, ny)
    We: torch.Tensor = None      # (B, ny_e)
    con_lb: torch.Tensor = None  # (B, N+1, nc)
    con_ub: torch.Tensor = None  # (B, N+1, nc)
    con_z1: torch.Tensor = None  # (B, N+1, nc)
    con_z2: torch.Tensor = None  # (B, N+1, nc)
    u_lb: torch.Tensor = None    # (B, N, nu)
    u_ub: torch.Tensor = None    # (B, N, nu)
    u_z1: torch.Tensor = None    # (B, N, nu)
    u_z2: torch.Tensor = None    # (B, N, nu)


def qp_rows(con, u, B):
    """One (B, nc_total) QP row field: the general rows' (N+1, nc) values
    first, the input rows' (N, nu) last; either part may be unbatched."""
    return torch.cat([con.flatten(-2).expand(B, -1), u.flatten(-2).expand(B, -1)], dim=1)


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
    returns ((..., m), (..., m, n)). One forward-mode pass over n copies of
    x stacked on a new leading axis, copy j carrying the unit tangent e_j;
    the leading axis leaves f's node axis (second to last) in place."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device).view(n, *([1] * (x.dim() - 1)), n)
    xr = x.expand(n, *x.shape).contiguous()
    y, dy = torch.func.jvp(f, (xr,), (eye.expand_as(xr).contiguous(),))
    return y[0], torch.movedim(dy, 0, -1)


class RTIEngine:
    """Static problem description + batched solve_full()."""

    def __init__(self, funcs: OCPFunctions, N: int, nx: int, nu: int, W, We,
                 con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2,
                 newton_iters: int = 15, lm_reg: float = 0.0, sqp_iters: int = 1,
                 kkt_fail_rel: float = 1e4):
        if (funcs.build_qp is None) != (funcs.expand_dx is None):
            raise ValueError("OCPFunctions.build_qp and expand_dx must be provided together")
        self.funcs = funcs
        self.N, self.nx, self.nu = N, nx, nu
        self.nz = N * nu
        self.W, self.We = W, We
        self.con_lb, self.con_ub, self.con_z1, self.con_z2 = con_lb, con_ub, con_z1, con_z2
        self.u_lb, self.u_ub, self.u_z1, self.u_z2 = u_lb, u_ub, u_z1, u_z2
        self.newton_iters = newton_iters
        self.lm_reg = lm_reg
        self.sqp_iters = sqp_iters
        self.kkt_fail_rel = kkt_fail_rel
        self.nc_total = (N + 1) * con_lb.shape[1] + N * nu
        # E_k = d(vec dU)/d(du_k): (N, nu, nz) selector
        self.E = torch.eye(self.nz, dtype=W.dtype, device=W.device).reshape(N, nu, self.nz)

    # ------------------------------------------------------------------
    def init_state(self, x0) -> RTIState:
        """acados-style cold start: all states at x0 (B, nx), controls zero."""
        B = x0.shape[0]
        X = x0[:, None, :].expand(B, self.N + 1, self.nx).clone()
        U = torch.zeros((B, self.N, self.nu), dtype=x0.dtype, device=x0.device)
        return RTIState(X=X, U=U, warm=init_warm(B, self.nc_total, x0.dtype, x0.device))

    def _linearize(self, state: RTIState):
        f, nx = self.funcs, self.nx
        if f.lin_rollout is not None:
            XU = torch.cat([state.X[:, :-1], state.U], dim=2)
            F, J = f.lin_rollout(XU)
            return J[..., :nx].contiguous(), J[..., nx:].contiguous(), F - state.X[:, 1:]
        if f.dyn_jac is not None:
            F, A, Bm = f.dyn_jac(state.X[:, :-1], state.U)
            return A, Bm, F - state.X[:, 1:]
        if f.dyn_step is None:
            raise ValueError("OCPFunctions needs lin_rollout, dyn_jac or dyn_step")
        B, N = state.U.shape[:2]

        def step_xu(k, xu):
            x_next = f.dyn_step(k, xu[:nx], xu[nx:])
            return x_next, x_next

        # stage k of scenario b is row b N + k
        XU = torch.cat([state.X[:, :-1], state.U], dim=2).reshape(B * N, -1)
        ks = torch.arange(N, device=XU.device).repeat(B)
        J, F = torch.func.vmap(torch.func.jacfwd(step_xu, argnums=1, has_aux=True))(ks, XU)
        # under vmap, jacfwd's tangents through a 0-d element of a float32 row
        # (x[0] ** 2, say) come out float64: the Jacobian takes the rows' type
        J, F = J.to(XU.dtype).reshape(B, N, nx, -1), F.reshape(B, N, nx)
        return J[..., :nx].contiguous(), J[..., nx:].contiguous(), F - state.X[:, 1:]

    def _zero_A(self, x):
        """The A_lin of a path that never forms the stage sensitivities: zeros
        of shape (B, N, nx, nx), as a broadcast view (no memory)."""
        return x.new_zeros(()).expand(x.shape[0], self.N, self.nx, self.nx)

    def _merged(self, mods: QPMods = None):
        """This solve's (W, We, con_lb, con_ub, con_z1, con_z2, u_lb, u_ub,
        u_z1, u_z2): each field of `mods` where it is set (batched), else the
        engine's static tensor (unbatched). Consumers broadcast both."""
        static = (self.W, self.We, self.con_lb, self.con_ub, self.con_z1, self.con_z2,
                  self.u_lb, self.u_ub, self.u_z1, self.u_z2)
        if mods is None:
            return static
        return tuple(s if m is None else m for m, s in zip(mods, static))

    @staticmethod
    def _gn_assemble(r0, M, re0, Me, W, We):
        """Condensed Gauss-Newton blocks from stage residuals (B, N, ny) and
        Jacobians (B, N, ny, nz): H0 = M' W M + Me' We Me, g0 = M' W r + Me' We re;
        W (ny,) or (B, ny), We (ny_e,) or (B, ny_e)."""
        B, N, ny, nz = M.shape
        Mf = M.reshape(B, N * ny, nz)
        wts = torch.tile(W, (N,))
        H0 = (torch.matmul((Mf * wts[..., None]).transpose(1, 2), Mf)
              + torch.matmul((Me * We[..., None]).transpose(1, 2), Me))
        g0 = mtv(Mf, wts * r0.reshape(B, -1)) + mtv(Me, We * re0)
        return H0, g0

    def _build_qp(self, state: RTIState, x0, yref, yref_e, mods: QPMods = None):
        """(qp, e, Gam, A_lin); on the build_qp path e holds its aux and Gam is None.
        Spans: `tc.rti.linearize`, `tc.rti.condense` (a `lin_condense` hook:
        this span alone) and `tc.rti.assemble`, or `tc.rti.build_qp`."""
        f = self.funcs
        merged = self._merged(mods)
        if f.build_qp is not None:
            with span("tc.rti.build_qp"):
                qp, aux = f.build_qp(state.X, state.U, x0, yref, yref_e, merged)
            return qp, aux, None, self._zero_A(x0)
        d0 = x0 - state.X[:, 0]
        if f.lin_condense is not None:
            with span("tc.rti.condense"):
                e, Gam = f.lin_condense(state.X, state.U, d0)
            A = self._zero_A(x0)
        else:
            with span("tc.rti.linearize"):
                A, Bm, xi = self._linearize(state)
            with span("tc.rti.condense"):
                e, Gam = condense(A, Bm, xi.contiguous(), d0.contiguous())
        with span("tc.rti.assemble"):
            return self._assemble(state, x0, yref, yref_e, merged, e, Gam), e, Gam, A

    def _assemble(self, state: RTIState, x0, yref, yref_e, merged, e, Gam) -> CondensedQP:
        """The Gauss-Newton QP (cost, then the constraint rows) from the
        condensed dynamics e, Gam."""
        f = self.funcs
        N, nx, nz = self.N, self.nx, self.nz
        B = x0.shape[0]
        W, We, con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2 = merged
        if f.y_select is not None and f.resid_stage is None:
            # --- Gauss-Newton cost, selection-structured: y = [x[sel], u] ---
            # index tensors built once (a Python list index is a host sync)
            sel = device_constant(tuple(f.y_select), x0.device)
            sel_e = device_constant(tuple(f.y_select_term), x0.device)
            ns = len(f.y_select)
            Y = f.y_stage(state.X[:, :-1], state.U)                   # (B, N, ny)
            r_x = Y[..., :ns] - yref[..., :ns] + e[:, :N][..., sel]     # (B, N, ns)
            r_u = Y[..., ns:] - yref[..., ns:]                          # (B, N, nu)
            Wx, Wu = W[..., :ns], W[..., ns:]
            Mf4 = Gam[:, :N][:, :, sel, :].reshape(B, N * ns, nz)
            wtsx = torch.tile(Wx, (N,))
            re0 = f.y_term(state.X[:, N]) - yref_e + e[:, N][:, sel_e]
            Me = Gam[:, N][:, sel_e, :]                                 # (B, ny_e, nz)
            H0 = (
                torch.matmul((Mf4 * wtsx[..., None]).transpose(1, 2), Mf4)
                + torch.matmul((Me * We[..., None]).transpose(1, 2), Me)
                + torch.diag_embed(torch.tile(Wu, (N,)))
            )
            g0 = (
                mtv(Mf4, wtsx * r_x.reshape(B, -1))
                + (Wu.unsqueeze(-2) * r_u).reshape(B, -1)
                + mtv(Me, We * re0)
            )
        elif f.y_jac is not None and f.resid_stage is None:
            # --- Gauss-Newton cost from the analytic output Jacobians ---
            Y, Jyx, Jyu = f.y_jac(state.X[:, :-1], state.U)
            r0 = Y - yref + torch.matmul(Jyx, e[:, :N, :, None])[..., 0]
            M = torch.matmul(Jyx, Gam[:, :N]) + torch.matmul(Jyu, self.E)
            re, Jre = jacobian_fwd(lambda x: f.y_term(x) - yref_e, state.X[:, N])
            re0 = re + torch.matmul(Jre, e[:, N, :, None])[..., 0]
            H0, g0 = self._gn_assemble(r0, M, re0, torch.matmul(Jre, Gam[:, N]), W, We)
        else:
            # --- Gauss-Newton cost from the residual Jacobians: the
            # EXTERNAL cost's resid_stage / resid_term, else y - yref ---
            if f.resid_stage is not None:
                resid = lambda xu: f.resid_stage(xu[..., :nx], xu[..., nx:], yref)
                resid_e = lambda x: f.resid_term(x, yref_e)
            else:
                resid = lambda xu: f.y_stage(xu[..., :nx], xu[..., nx:]) - yref
                resid_e = lambda x: f.y_term(x) - yref_e
            XU = torch.cat([state.X[:, :-1], state.U], dim=2)
            R, Jr = jacobian_fwd(resid, XU)
            Jrx, Jru = Jr[..., :nx], Jr[..., nx:]
            r0 = R + torch.matmul(Jrx, e[:, :N, :, None])[..., 0]
            M = torch.matmul(Jrx, Gam[:, :N]) + torch.matmul(Jru, self.E)  # (B, N, ny, nz)
            re, Jre = jacobian_fwd(resid_e, state.X[:, N])
            re0 = re + torch.matmul(Jre, e[:, N, :, None])[..., 0]
            Me = torch.matmul(Jre, Gam[:, N])
            H0, g0 = self._gn_assemble(r0, M, re0, Me, W, We)

        if self.lm_reg:
            # Levenberg-Marquardt damping in the condensed variables
            H0 = H0 + self.lm_reg * torch.eye(nz, dtype=H0.dtype, device=H0.device)

        # --- constraint rows: value + Jacobian of con_stage at every node ---
        if f.con_jac is not None:
            C, Jc = f.con_jac(state.X)
        else:
            C, Jc = jacobian_fwd(f.con_stage, state.X)                # (B,N+1,nc), (B,N+1,nc,nx)
        c0_c = C + torch.sum(Jc * e[:, :, None, :], dim=-1)
        G = torch.matmul(Jc, Gam).reshape(B, -1, nz)
        c0 = torch.cat([c0_c.reshape(B, -1), state.U.reshape(B, -1)], dim=1)
        return CondensedQP(H0=H0, g0=g0, G=G.contiguous(), c0=c0, lb=qp_rows(con_lb, u_lb, B),
                           ub=qp_rows(con_ub, u_ub, B), z1=qp_rows(con_z1, u_z1, B),
                           z2=qp_rows(con_z2, u_z2, B))

    # ------------------------------------------------------------------
    def nonlinear_cost(self, state: RTIState, yref, yref_e, mods: QPMods = None):
        """acados `get_cost()` analog: LS cost + slack penalties, (B,)."""
        W, We, con_lb, con_ub, con_z1, con_z2, u_lb, u_ub, u_z1, u_z2 = self._merged(mods)
        f, N = self.funcs, self.N
        if f.resid_stage is not None:
            r = f.resid_stage(state.X[:, :-1], state.U, yref)
            re = f.resid_term(state.X[:, N], yref_e)
        else:
            r = f.y_stage(state.X[:, :-1], state.U) - yref
            re = f.y_term(state.X[:, N]) - yref_e
        cost = 0.5 * torch.sum(r * r * W.unsqueeze(-2), dim=(1, 2))
        cost = cost + 0.5 * torch.sum(re * re * We, dim=1)
        C = self.funcs.con_stage(state.X)
        du = torch.clamp(C - con_ub, min=0.0)
        dl = torch.clamp(con_lb - C, min=0.0)
        cost = cost + torch.sum(con_z1 * (du + dl) + 0.5 * con_z2 * (du**2 + dl**2), dim=(1, 2))
        duu = torch.clamp(state.U - u_ub, min=0.0)
        dul = torch.clamp(u_lb - state.U, min=0.0)
        return cost + torch.sum(u_z1 * (duu + dul) + 0.5 * u_z2 * (duu**2 + dul**2), dim=(1, 2))

    # ------------------------------------------------------------------
    def solve(self, state: RTIState, x0, yref, yref_e, mods=None):
        """One RTI. Returns (u0 (B, nu), new_state, stats)."""
        u0, new_state, stats, _ = self.solve_full(state, x0, yref, yref_e, mods)
        return u0, new_state, stats

    def solve_full(self, state: RTIState, x0, yref, yref_e, mods: QPMods = None):
        """One RTI returning also the dynamics sensitivities A (B, N, nx, nx)
        of this solve's linearization (R2NMPC's covariance propagation).

        A scenario whose result fails the health check keeps its previous
        iterate and gets status 3; the caller re-initializes it."""
        B = x0.shape[0]
        it_state = state
        qp_iter_max = torch.zeros((B,), dtype=torch.int32, device=x0.device)
        gap_last = torch.zeros((B,), dtype=x0.dtype, device=x0.device)
        for _ in range(self.sqp_iters):
            qp, e, Gam, A_lin = self._build_qp(it_state, x0, yref, yref_e, mods)
            w, kkt, warm_out, ipm_stats = solve_soft_qp_ipm(
                qp, n_iters=self.newton_iters, n_polish=1, warm=it_state.warm, n_id=self.nz,
                want_stats=True,
            )
            qp_iter_max = torch.maximum(qp_iter_max, ipm_stats.iters)
            gap_last = ipm_stats.gap
            if self.funcs.build_qp is not None:
                dX = self.funcs.expand_dx(e, w)  # e holds build_qp's aux here
            else:
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
            cost=self.nonlinear_cost(new_state, yref, yref_e, mods),
            kkt_res=kkt,
            sqp_iter=torch.full((B,), self.sqp_iters, dtype=torch.int32, device=x0.device),
            qp_iter=qp_iter_max,
            status=torch.where(bad, 3, 0).to(torch.int32),
            gap=gap_last,
        )
        return new_state.U[:, 0], new_state, stats, A_lin
