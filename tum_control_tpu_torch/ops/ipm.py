"""Primal-dual interior-point method for soft-constrained condensed QPs
(batched port of tum_control_tpu/ops/ipm.py).

The constraint rows are the QP's ncg general rows followed by `n_id`
identity rows over w (ops/soft_qp.py): the RTI engine's QPs end with their
nz input-box rows and pass `n_id = nz`; `n_id = 0` (the default, as in the
JAX package) means general rows only.

Per iteration, with n_id = nz, as the JAX package's fused TPU pipeline:
  1. the normal matrix H = H0 + [G; I]' diag(sigma) [G; I] + 1e-11 I
     (`torch.matmul`, the XLA matmul outside Pallas in the JAX package),
  2. its Cholesky factor (K3, ops/kernels/chol.py),
  3. the stationarity residual rw = H0 w + g0 + [G; I]'(lam_u - lam_l),
  4. one fused Mehrotra iteration (K4, ops/kernels/ipm_iter.py),
then one semismooth-Newton polish (ops/soft_qp.py; K3 + K5).

With n_id = 0 steps 1-3 are the same without the identity block, and step
4 is the plain iteration (`iteration_ref`): the JAX package sends only
n_id = nz to its fused kernel (ops/ipm.py's `fast` rule) and runs every
other layout through its per-scenario reference. So on the card an
n_id = 0 solve launches K3 every iteration and K3 + K5 in the polish, and
never K4.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.ops.kernels.chol import cholesky
from tum_control_tpu_torch.ops.kernels.ipm_iter import (  # noqa: F401 (the JAX names)
    BIG_THRESH, HARD_THRESH, fused_iteration, iteration_ref, masks_of, sigma_of,
)
from tum_control_tpu_torch.ops.soft_qp import CondensedQP, con_normal, mtv, mv, newton_polish

WARM_MIN = 1e-3
WARM_MAX = 1e5


class IPMWarm(NamedTuple):
    """Dual/slack warm start carried across RTI steps, (B, nc) each; clipped
    into [WARM_MIN, WARM_MAX] on reuse."""

    su: torch.Tensor
    sl: torch.Tensor
    lam_u: torch.Tensor
    lam_l: torch.Tensor
    mu_u: torch.Tensor
    mu_l: torch.Tensor


class IPMStats(NamedTuple):
    iters: torch.Tensor  # (B,) int32 iterations that updated the iterate
    gap: torch.Tensor    # (B,) final complementarity gap / active-row count


def init_warm(batch: int, nc: int, dtype=None, device=None) -> IPMWarm:
    """All-ones warm start on `device` (device.resolve_device: cuda unless
    the caller names a device)."""
    device = resolve_device(device)
    ones = torch.ones((batch, nc), dtype=dtype, device=device)
    return IPMWarm(*(ones.clone() for _ in range(6)))


def _iterations(qp: CondensedQP, nt, carry, n_iters: int, gamma_ftb: float, n_id: int):
    """n_iters x {sigma -> H -> K3 -> rw -> K4 (n_id = nz) or the plain
    iteration (n_id = 0)}; returns (carry, unconverged (B, n_iters))."""
    H0, g0, G, c0, lb, ub, z1, z2 = qp
    ncg = G.shape[1]
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    eye = torch.eye(H0.shape[-1], dtype=H0.dtype, device=H0.device)
    sig = sigma_of(*carry[2:10], z1, z2, act_u, act_l, s_u, s_l)

    uncs = []
    for _ in range(n_iters):
        L = cholesky(H0 + con_normal(qp, sig, n_id) + 1e-11 * eye)
        lam_d = carry[6] - carry[7]
        rw = mv(H0, carry[0]) + g0 + mtv(G, lam_d[:, :ncg])
        if n_id:
            rw = rw + lam_d[:, ncg:]
            carry, sig, unc = fused_iteration(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb)
        else:
            carry, sig, unc = iteration_ref(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb,
                                            n_id=0)
        uncs.append(unc)
    return carry, torch.stack(uncs, dim=1)


def solve_soft_qp_ipm(qp: CondensedQP, n_iters: int = 30, n_polish: int = 2,
                      gamma_ftb: float = 0.99, sigma: float = 0.2, warm: IPMWarm = None,
                      n_id: int = 0, want_stats: bool = False):
    """Solve the batched soft QP. Returns (w, kkt_res) -- or (w, kkt_res,
    warm_out) when a warm start is supplied; `want_stats=True` appends an
    IPMStats. `n_id` (0 or nz) marks the last n_id rows as identity rows
    over w. `sigma` is the JAX signature's and, as there, unused: the
    centring parameter is Mehrotra's, computed each iteration."""
    H0, g0, G, c0, lb, ub, z1, z2 = qp
    B, nz = g0.shape
    nc = c0.shape[1]
    if n_id not in (0, nz) or nc != G.shape[1] + n_id:
        raise ValueError(f"solve_soft_qp_ipm: {nc} rows are not {G.shape[1]} general rows and "
                         f"n_id = {n_id} identity rows (0 or nz = {nz})")
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    ones = torch.ones_like(c0)
    zero = torch.zeros_like(c0)

    v0 = c0  # at w = 0
    if warm is None:
        su = torch.where(s_u, ones, zero)
        sl = torch.where(s_l, ones, zero)
        pu = torch.where(act_u, torch.clamp(ub + su - v0, min=1.0), ones)
        pl = torch.where(act_l, torch.clamp(v0 + sl - lb, min=1.0), ones)
        lam_u = torch.where(act_u, ones, zero)
        lam_l = torch.where(act_l, ones, zero)
        mu_u = torch.where(s_u, ones, zero)
        mu_l = torch.where(s_l, ones, zero)
    else:
        clipw = lambda x: torch.clamp(x, WARM_MIN, WARM_MAX)
        su = torch.where(s_u, clipw(warm.su), zero)
        sl = torch.where(s_l, clipw(warm.sl), zero)
        pu = torch.where(act_u, torch.clamp(ub + su - v0, min=WARM_MIN), ones)
        pl = torch.where(act_l, torch.clamp(v0 + sl - lb, min=WARM_MIN), ones)
        lam_u = torch.where(act_u, clipw(warm.lam_u), zero)
        lam_l = torch.where(act_l, clipw(warm.lam_l), zero)
        mu_u = torch.where(s_u, clipw(warm.mu_u), zero)
        mu_l = torch.where(s_l, clipw(warm.mu_l), zero)
    w = torch.zeros_like(g0)
    count = act_u.sum(1) + act_l.sum(1) + s_u.sum(1) + s_l.sum(1)
    nt = torch.clamp(count.to(c0.dtype), min=1.0)

    carry = (w, torch.zeros_like(c0), su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l)
    carry, uncs = _iterations(qp, nt, carry, n_iters, gamma_ftb, n_id)

    # exact finish: semismooth-Newton steps from the IPM point
    w, kkt = newton_polish(qp, carry[0], n_iters=n_polish, n_id=n_id)
    if want_stats:
        _, _, su_f, sl_f, pu_f, pl_f, lu_f, ll_f, mu_f, ml_f = carry
        gap_f = torch.sum(
            torch.where(act_u, lu_f * pu_f, zero) + torch.where(act_l, ll_f * pl_f, zero)
            + torch.where(s_u, mu_f * su_f, zero) + torch.where(s_l, ml_f * sl_f, zero),
            dim=1,
        ) / nt
        stats = IPMStats(iters=uncs.to(torch.int32).sum(1, dtype=torch.int32), gap=gap_f)
    if warm is None:
        return (w, kkt, stats) if want_stats else (w, kkt)
    warm_out = IPMWarm(su=carry[2], sl=carry[3], lam_u=carry[6], lam_l=carry[7],
                       mu_u=carry[8], mu_l=carry[9])
    return (w, kkt, warm_out, stats) if want_stats else (w, kkt, warm_out)
