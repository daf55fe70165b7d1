"""Soft-constrained condensed QPs and the semismooth-Newton polish
(batched port of tum_control_tpu/ops/soft_qp.py).

Every inequality of the reference OCPs is L1+L2-softened, so the QP is the
strictly convex piecewise-quadratic program

    min_w  0.5 w'H0 w + g0'w + sum_i psi_i(G_i w + c0_i),
    psi_i(v) = z1_i max(0, v - ub_i) + 0.5 z2_i max(0, v - ub_i)^2 + (same for lb_i - v).

The constraint system is the ncg general rows `G` followed by `n_id`
identity rows over w, which are handled analytically, never stored: the
RTI engine's QPs end with the nz condensed input-box rows (`n_id = nz`,
which every caller in the engine passes); `n_id = 0`, the default as in
the JAX package, means general rows only.

On the card the polish factors with K3 and solves with K5
(ops/kernels/chol.py) whatever `n_id` is, as the JAX package routes its
polish through `chol_factor_packed` / `chol_apply_packed`.

The residual and gradient mat-vecs must be exact float32 (the TPU's bf16
passes there caused a multi-metre closed-loop weave); on the card a float32
`torch.matmul` is exact float32 as long as TF32 stays off, which the port
never enables.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tum_control_tpu_torch.ops.kernels.chol import chol_solve, cholesky

N_BRACKET = 9     # bracket points 2^0 .. 2^8 of the exact line search
N_BISECT = 45


class CondensedQP(NamedTuple):
    """Batched soft QP data; c0/lb/ub/z1/z2 cover the general rows first,
    the n_id identity rows last (n_id is passed to the functions)."""

    H0: torch.Tensor   # (B, nz, nz) positive-definite base Hessian
    g0: torch.Tensor   # (B, nz)
    G: torch.Tensor    # (B, ncg, nz) general constraint rows
    c0: torch.Tensor   # (B, ncg + n_id) constraint values at w = 0
    lb: torch.Tensor   # (B, ncg + n_id)
    ub: torch.Tensor   # (B, ncg + n_id)
    z1: torch.Tensor   # (B, ncg + n_id) linear slack penalty
    z2: torch.Tensor   # (B, ncg + n_id) quadratic slack penalty


def mv(A, x):
    """Batched A @ x: (B, m, n), (B, n) -> (B, m)."""
    return torch.matmul(A, x[..., None])[..., 0]


def mtv(A, y):
    """Batched A' @ y: (B, m, n), (B, m) -> (B, n)."""
    return torch.matmul(y[..., None, :], A)[..., 0, :]


def con_mul(qp: CondensedQP, w, n_id: int = 0):
    """Full constraint-Jacobian product [G; I] w (the identity block when
    n_id > 0)."""
    Gw = mv(qp.G, w)
    return torch.cat([Gw, w], dim=-1) if n_id else Gw


def con_tmul(qp: CondensedQP, y, n_id: int = 0):
    """Transpose product [G; I]' y."""
    ncg = qp.G.shape[-2]
    Gty = mtv(qp.G, y[..., :ncg])
    return Gty + y[..., ncg:] if n_id else Gty


def con_normal(qp: CondensedQP, d, n_id: int = 0):
    """[G; I]' diag(d) [G; I] without forming the identity block."""
    ncg = qp.G.shape[-2]
    H = torch.matmul(qp.G.transpose(-1, -2) * d[..., None, :ncg], qp.G)
    return H + torch.diag_embed(d[..., ncg:]) if n_id else H


def _slack_gamma(v, lb, ub, z1, z2):
    """d psi / d v: the slack penalties' gradient at constraint values v."""
    du = v - ub
    dl = lb - v
    zero = torch.zeros_like(v)
    return torch.where(du > 0, z1 + z2 * du, zero) - torch.where(dl > 0, z1 + z2 * dl, zero)


def _penalty(qp: CondensedQP, v):
    """sum_i psi_i(v_i) per scenario, (B,)."""
    du = v - qp.ub
    dl = qp.lb - v
    zero = torch.zeros_like(v)
    pu = torch.where(du > 0, qp.z1 * du + 0.5 * qp.z2 * du * du, zero)
    plo = torch.where(dl > 0, qp.z1 * dl + 0.5 * qp.z2 * dl * dl, zero)
    return torch.sum(pu + plo, dim=-1)


def objective(qp: CondensedQP, w, n_id: int = 0):
    """The soft QP's objective at w (B, nz), (B,)."""
    return (0.5 * torch.sum(w * mv(qp.H0, w), dim=-1) + torch.sum(qp.g0 * w, dim=-1)
            + _penalty(qp, con_mul(qp, w, n_id) + qp.c0))


def solve_soft_qp(qp: CondensedQP, n_iters: int = 15, reg: float = 1e-9, n_id: int = 0):
    """Semismooth-Newton solve from w = 0; returns (w*, kkt residual inf-norm)."""
    return newton_polish(qp, torch.zeros_like(qp.g0), n_iters=n_iters, reg=reg, n_id=n_id)


def newton_polish(qp: CondensedQP, w0, n_iters: int = 15, reg: float = 1e-9, n_id: int = 0):
    """Semismooth Newton with an exact (bracket + bisection) line search from
    w0 (B, nz); returns (w (B, nz), kkt residual inf-norm (B,))."""
    nz = qp.H0.shape[-1]
    eye = torch.eye(nz, dtype=qp.H0.dtype, device=qp.H0.device)
    ks = 2.0 ** torch.arange(N_BRACKET, dtype=qp.H0.dtype, device=qp.H0.device)
    bounds = (qp.lb, qp.ub, qp.z1, qp.z2)
    bounds_k = tuple(t[:, None, :] for t in bounds)  # broadcast over line-search points
    w = w0
    for _ in range(n_iters):
        v = con_mul(qp, w, n_id) + qp.c0
        du = v - qp.ub
        dl = qp.lb - v
        d = torch.where((du > 0) | (dl > 0), qp.z2, torch.zeros_like(v))
        hwg = mv(qp.H0, w) + qp.g0
        grad = hwg + con_tmul(qp, _slack_gamma(v, *bounds), n_id)
        H = qp.H0 + con_normal(qp, d, n_id) + reg * eye
        p = -chol_solve(cholesky(H), grad)

        # phi(alpha) = objective(w + alpha p) is convex piecewise quadratic:
        # phi' is nondecreasing piecewise linear; find its root
        s = con_mul(qp, p, n_id)
        q1 = torch.sum(hwg * p, dim=-1)
        q2 = torch.sum(p * mv(qp.H0, p), dim=-1)

        def dphi(alpha):  # alpha (B, K) -> (B, K)
            va = v[:, None, :] + alpha[..., None] * s[:, None, :]
            pen = _slack_gamma(va, *bounds_k)
            return q1[:, None] + q2[:, None] * alpha + torch.sum(pen * s[:, None, :], dim=-1)

        pos = dphi(ks.expand(w.shape[0], N_BRACKET)) >= 0
        first = torch.argmax(pos.to(torch.int32), dim=1)
        hi = torch.where(pos.any(dim=1), ks[first], ks[-1])
        lo = torch.zeros_like(hi)
        for _ in range(N_BISECT):
            mid = 0.5 * (lo + hi)
            up = dphi(mid[:, None])[:, 0] > 0
            lo, hi = torch.where(up, lo, mid), torch.where(up, mid, hi)
        alpha = 0.5 * (lo + hi)
        # guard NaN directions (singular H despite reg), per scenario: keep w
        w_new = w + alpha[:, None] * p
        w = torch.where(torch.all(torch.isfinite(w_new), dim=1, keepdim=True), w_new, w)

    v = con_mul(qp, w, n_id) + qp.c0
    gamma = _slack_gamma(v, *bounds)
    kkt = torch.amax(torch.abs(mv(qp.H0, w) + qp.g0 + con_tmul(qp, gamma, n_id)), dim=-1)
    return w, kkt
