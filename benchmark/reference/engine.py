"""SQP-RTI step of the reference (see __init__): linearize the shooting
dynamics by forward-mode AD, condense the state deviations onto the input
deviations w, assemble the Gauss-Newton QP from the residual Jacobians and
the constraint rows, solve it with the interior-point method and one
Newton polish, and apply the per-scenario health check (status 3)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark.reference.qp import QP, mtv, solve_ipm

KKT_FAIL_REL = 1e4


class Problem(NamedTuple):
    """The OCP of a controller. Its weights, bounds and penalties are the
    same for every scenario, or carry a leading batch axis (B, ...) where a
    controller's carried state sets them per scenario (the port's QPMods)."""

    N: int
    nx: int
    nu: int
    lin: Callable        # (X (B,N,nx), U (B,N,nu)) -> F (B,N,nx), A (B,N,nx,nx), Bm (B,N,nx,nu)
    y_stage: Callable    # (x, u) -> (..., N, ny)
    y_term: Callable     # x (..., nx) -> (..., ny_e)
    con_stage: Callable  # x (..., N+1, nx) -> (..., N+1, nc)
    W: torch.Tensor      # (ny,) or (B, ny)
    We: torch.Tensor     # (ny_e,) or (B, ny_e)
    con_lb: torch.Tensor  # (N+1, nc) or (B, N+1, nc), as the three below
    con_ub: torch.Tensor
    con_z1: torch.Tensor
    con_z2: torch.Tensor
    u_lb: torch.Tensor   # (N, nu) or (B, N, nu), as the three below
    u_ub: torch.Tensor
    u_z1: torch.Tensor
    u_z2: torch.Tensor
    qp_iters: int
    sqp_iters: int


def jacobian_fwd(f, x):
    """Values and Jacobian of a row function f: (..., n) -> (..., m), one
    forward-mode pass over n stacked copies of x."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device).view(n, *([1] * (x.dim() - 1)), n)
    xr = x.expand(n, *x.shape).contiguous()
    y, dy = torch.func.jvp(f, (xr,), (eye.expand_as(xr).contiguous(),))
    return y[0], torch.movedim(dy, 0, -1)


def linearize(step, XU, nx: int):
    """F = step(x, u) and J = dF/d(x, u) for every (scenario, stage) row."""
    def shifted(v):
        xu = XU + v
        return step(xu[..., :nx], xu[..., nx:])

    J = torch.func.jacfwd(shifted)(torch.zeros_like(XU[0, 0]))
    return step(XU[..., :nx], XU[..., nx:]), J


def condense(A, Bm, xi, d0):
    """e (B,N+1,nx), Gam (B,N+1,nx,nz) of the state deviations."""
    Bt, N, nx, nu = Bm.shape
    e = d0
    gam = torch.zeros((Bt, nx, N * nu), dtype=A.dtype, device=A.device)
    es, gams = [e], [gam]
    for t in range(N):
        e = torch.matmul(A[:, t], e[..., None])[..., 0] + xi[:, t]
        gam = torch.matmul(A[:, t], gam)
        gam[:, :, t * nu:(t + 1) * nu] += Bm[:, t]
        es.append(e)
        gams.append(gam)
    return torch.stack(es, dim=1), torch.stack(gams, dim=1)


def qp_rows(con, u, B):
    return torch.cat([con.flatten(-2).expand(B, -1), u.flatten(-2).expand(B, -1)], dim=1)


def build_qp(p: Problem, X, U, x0, yref, yref_e):
    N, nx, nu = p.N, p.nx, p.nu
    nz = N * nu
    B = x0.shape[0]
    F, A, Bm = p.lin(X[:, :-1], U)
    e, Gam = condense(A, Bm, F - X[:, 1:], x0 - X[:, 0])
    E = torch.eye(nz, dtype=X.dtype, device=X.device).reshape(N, nu, nz)
    XU = torch.cat([X[:, :-1], U], dim=2)
    R, Jr = jacobian_fwd(lambda xu: p.y_stage(xu[..., :nx], xu[..., nx:]) - yref, XU)
    Jrx, Jru = Jr[..., :nx], Jr[..., nx:]
    r0 = R + torch.matmul(Jrx, e[:, :N, :, None])[..., 0]
    M = torch.matmul(Jrx, Gam[:, :N]) + torch.matmul(Jru, E)
    re, Jre = jacobian_fwd(lambda x: p.y_term(x) - yref_e, X[:, N])
    re0 = re + torch.matmul(Jre, e[:, N, :, None])[..., 0]
    Me = torch.matmul(Jre, Gam[:, N])
    ny = M.shape[2]
    Mf = M.reshape(B, N * ny, nz)
    wts = torch.tile(p.W, (N,))
    H0 = (torch.matmul((Mf * wts[..., None]).transpose(1, 2), Mf)
          + torch.matmul((Me * p.We[..., None]).transpose(1, 2), Me))
    g0 = mtv(Mf, wts * r0.reshape(B, -1)) + mtv(Me, p.We * re0)
    C, Jc = jacobian_fwd(p.con_stage, X)
    c0_c = C + torch.sum(Jc * e[:, :, None, :], dim=-1)
    G = torch.matmul(Jc, Gam).reshape(B, -1, nz)
    c0 = torch.cat([c0_c.reshape(B, -1), U.reshape(B, -1)], dim=1)
    qp = QP(H0=H0, g0=g0, G=G.contiguous(), c0=c0, lb=qp_rows(p.con_lb, p.u_lb, B),
            ub=qp_rows(p.con_ub, p.u_ub, B), z1=qp_rows(p.con_z1, p.u_z1, B),
            z2=qp_rows(p.con_z2, p.u_z2, B))
    return qp, e, Gam, A


def rti(p: Problem, X, U, warm, x0, yref, yref_e):
    """One real-time iteration. Returns (X, U, warm, status, A) of the new
    iterate, with A (B, N, nx, nx) the dynamics' linearization of the last
    SQP iteration (R2NMPC's covariance recurrence); a scenario that fails
    the health check keeps its old iterate and gets status 3."""
    B = x0.shape[0]
    Xi, Ui, wi = X, U, warm
    for _ in range(p.sqp_iters):
        qp, e, Gam, A = build_qp(p, Xi, Ui, x0, yref, yref_e)
        w, kkt, wi = solve_ipm(qp, wi, p.qp_iters, n_polish=1)
        Xi = Xi + e + torch.matmul(Gam, w[:, None, :, None])[..., 0]
        Ui = Ui + w.reshape(B, p.N, p.nu)
    qp_scale = 1.0 + torch.amax(torch.abs(qp.g0), dim=1)
    good = (torch.isfinite(Xi).all(dim=(1, 2)) & torch.isfinite(Ui).all(dim=(1, 2))
            & (torch.amax(torch.abs(Xi), dim=(1, 2)) < 1e7)
            & (torch.amax(torch.abs(Ui), dim=(1, 2)) < 1e4)
            & (kkt / qp_scale < KKT_FAIL_REL))
    keep = lambda new, old: torch.where(~good.view((B,) + (1,) * (new.dim() - 1)), old, new)
    return (keep(Xi, X), keep(Ui, U), tuple(keep(n, o) for n, o in zip(wi, warm)),
            torch.where(good, 0, 3).to(torch.int32), A)
