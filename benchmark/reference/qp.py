"""Soft-constrained condensed QP of the reference: the primal-dual
interior-point iterations (Mehrotra) and the semismooth-Newton polish, for
QPs of ncg general rows followed by nz identity rows over w (see __init__).

The factor is torch.linalg.cholesky_ex's and the solve L L' x = b
torch.cholesky_solve's; the port's plain versions compute the same
functions with loops."""
from __future__ import annotations

from typing import NamedTuple

import torch

WARM_MIN, WARM_MAX = 1e-3, 1e5
BIG_THRESH, HARD_THRESH = 1e10, 1e6
N_BRACKET, N_BISECT = 9, 45


class QP(NamedTuple):
    H0: torch.Tensor   # (B, nz, nz)
    g0: torch.Tensor   # (B, nz)
    G: torch.Tensor    # (B, ncg, nz)
    c0: torch.Tensor   # (B, ncg + nz)
    lb: torch.Tensor
    ub: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor


def mv(A, x):
    return torch.matmul(A, x[..., None])[..., 0]


def mtv(A, y):
    return torch.matmul(y[..., None, :], A)[..., 0, :]


def chol(H):
    """The factor; a matrix that is not positive definite gives NaN, as the
    port's loops do, instead of raising."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)


def chol_solve(L, b):
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def con_mul(G, w):
    return torch.cat([mv(G, w), w], dim=-1)


def con_tmul(G, y):
    ncg = G.shape[-2]
    return mtv(G, y[..., :ncg]) + y[..., ncg:]


def con_normal(G, d):
    ncg = G.shape[-2]
    return (torch.matmul(G.transpose(-1, -2) * d[..., None, :ncg], G)
            + torch.diag_embed(d[..., ncg:]))


def masks_of(lb, ub, z2):
    act_u = ub < BIG_THRESH
    act_l = lb > -BIG_THRESH
    soft = z2 < HARD_THRESH
    return act_u, act_l, act_u & soft, act_l & soft


def _barrier(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l):
    one, zero = torch.ones_like(su), torch.zeros_like(su)
    su_s = torch.where(s_u, su, one)
    sl_s = torch.where(s_l, sl, one)
    rs_u = z1 + z2 * su - lam_u - mu_u
    rs_l = z1 + z2 * sl - lam_l - mu_l
    b_u = z2 + mu_u / su_s
    b_l = z2 + mu_l / sl_s
    ipb_u = torch.where(s_u, lam_u / (pu * b_u), zero)
    ipb_l = torch.where(s_l, lam_l / (pl * b_l), zero)
    D_u, D_l = 1.0 + ipb_u, 1.0 + ipb_l
    sig_u = torch.where(act_u, lam_u / (pu * D_u), zero)
    sig_l = torch.where(act_l, lam_l / (pl * D_l), zero)
    return su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u, ipb_l, D_u, D_l, sig_u, sig_l


def _iteration(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb):
    """One Mehrotra iteration from the factor L of the normal matrix and the
    stationarity residual rw; carry = (w, Gw, su, sl, pu, pl, lam_u, lam_l,
    mu_u, mu_l)."""
    w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l = carry
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    zero = torch.zeros_like(c0)
    inf = torch.full_like(c0, float("inf"))

    def total_gap(lu, pu_, ll, pl_, mu, su_, ml, sl_):
        return torch.sum(torch.where(act_u, lu * pu_, zero) + torch.where(act_l, ll * pl_, zero)
                         + torch.where(s_u, mu * su_, zero) + torch.where(s_l, ml * sl_, zero),
                         dim=1)

    v = Gw + c0
    r_pu = torch.where(act_u, v + pu - su - ub, zero)
    r_pl = torch.where(act_l, pl - v - sl + lb, zero)
    gap = total_gap(lam_u, pu, lam_l, pl, mu_u, su, mu_l, sl)
    su_s, sl_s, rs_u, rs_l, b_u, b_l, ipb_u, ipb_l, D_u, D_l, sig_u, sig_l = _barrier(
        su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l, s_u, s_l)

    def directions(tau):
        t = tau[:, None]
        a_u = torch.where(s_u, -rs_u + t / su_s - mu_u, zero)
        a_l = torch.where(s_l, -rs_l + t / sl_s - mu_l, zero)
        chat_u = torch.where(act_u, (t / pu - lam_u + lam_u * r_pu / pu - ipb_u * a_u) / D_u, zero)
        chat_l = torch.where(act_l, (t / pl - lam_l + lam_l * r_pl / pl - ipb_l * a_l) / D_l, zero)
        dw = -chol_solve(L, rw + con_tmul(G, chat_u - chat_l))
        Gdw = con_mul(G, dw)
        dlam_u = torch.where(act_u, chat_u + sig_u * Gdw, zero)
        dlam_l = torch.where(act_l, chat_l - sig_l * Gdw, zero)
        dsu = torch.where(s_u, (dlam_u + a_u) / b_u, zero)
        dsl = torch.where(s_l, (dlam_l + a_l) / b_l, zero)
        dmu_u = torch.where(s_u, (t - mu_u * su - mu_u * dsu) / su_s, zero)
        dmu_l = torch.where(s_l, (t - mu_l * sl - mu_l * dsl) / sl_s, zero)
        dpu = torch.where(act_u, dsu - Gdw - r_pu, zero)
        dpl = torch.where(act_l, dsl + Gdw - r_pl, zero)
        step = None
        for x, dx, m in ((lam_u, dlam_u, act_u), (lam_l, dlam_l, act_l), (mu_u, dmu_u, s_u),
                         (mu_l, dmu_l, s_l), (pu, dpu, act_u), (pl, dpl, act_l),
                         (su, dsu, s_u), (sl, dsl, s_l)):
            neg = dx < 0
            r = torch.amin(torch.where(m & neg, -x / torch.where(neg, dx, -torch.ones_like(dx)),
                                       inf), dim=1)
            step = r if step is None else torch.minimum(step, r)
        alpha = torch.minimum(gamma_ftb * step, torch.ones_like(step))
        return (dw, Gdw, dsu, dsl, dpu, dpl, dlam_u, dlam_l, dmu_u, dmu_l), alpha

    d_aff, alpha_aff = directions(torch.zeros_like(gap))
    _, _, dsu_a, dsl_a, dpu_a, dpl_a, dlu_a, dll_a, dmu_a, dml_a = d_aff
    aa = alpha_aff[:, None]
    gap_aff = total_gap(lam_u + aa * dlu_a, pu + aa * dpu_a, lam_l + aa * dll_a, pl + aa * dpl_a,
                        mu_u + aa * dmu_a, su + aa * dsu_a, mu_l + aa * dml_a, sl + aa * dsl_a)
    sig_c = torch.clamp((gap_aff / torch.clamp(gap, min=1e-30)) ** 3, 1e-4, 0.99)
    (dw, Gdw, dsu, dsl, dpu, dpl, dlam_u, dlam_l, dmu_u, dmu_l), alpha = directions(
        sig_c * gap / nt)

    unconverged = gap > 1e-11 * nt
    okr = (unconverged & torch.all(torch.isfinite(dw), dim=1) & torch.isfinite(alpha))[:, None]
    al = alpha[:, None]
    upd = lambda x, dx, m: torch.where(okr & m, x + al * dx, x)
    w = torch.where(okr, w + al * dw, w)
    Gw = torch.where(okr, Gw + al * Gdw, Gw)
    su, sl = upd(su, dsu, s_u), upd(sl, dsl, s_l)
    pu, pl = upd(pu, dpu, act_u), upd(pl, dpl, act_l)
    lam_u, lam_l = upd(lam_u, dlam_u, act_u), upd(lam_l, dlam_l, act_l)
    mu_u, mu_l = upd(mu_u, dmu_u, s_u), upd(mu_l, dmu_l, s_l)
    *_, sn_u, sn_l = _barrier(su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l, z1, z2, act_u, act_l,
                              s_u, s_l)
    return (w, Gw, su, sl, pu, pl, lam_u, lam_l, mu_u, mu_l), sn_u + sn_l, unconverged


def _slack_gamma(v, lb, ub, z1, z2):
    du, dl = v - ub, lb - v
    zero = torch.zeros_like(v)
    return torch.where(du > 0, z1 + z2 * du, zero) - torch.where(dl > 0, z1 + z2 * dl, zero)


def newton_polish(qp: QP, w0, n_iters: int, reg: float = 1e-9):
    """Semismooth Newton from w0 with the exact (bracket + bisection) line
    search; returns (w, kkt residual inf-norm)."""
    nz = qp.H0.shape[-1]
    eye = torch.eye(nz, dtype=qp.H0.dtype, device=qp.H0.device)
    ks = 2.0 ** torch.arange(N_BRACKET, dtype=qp.H0.dtype, device=qp.H0.device)
    bounds = (qp.lb, qp.ub, qp.z1, qp.z2)
    bounds_k = tuple(t[:, None, :] for t in bounds)
    w = w0
    for _ in range(n_iters):
        v = con_mul(qp.G, w) + qp.c0
        d = torch.where((v - qp.ub > 0) | (qp.lb - v > 0), qp.z2, torch.zeros_like(v))
        hwg = mv(qp.H0, w) + qp.g0
        grad = hwg + con_tmul(qp.G, _slack_gamma(v, *bounds))
        p = -chol_solve(chol(qp.H0 + con_normal(qp.G, d) + reg * eye), grad)
        s = con_mul(qp.G, p)
        q1 = torch.sum(hwg * p, dim=-1)
        q2 = torch.sum(p * mv(qp.H0, p), dim=-1)

        def dphi(alpha):
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
        w_new = w + (0.5 * (lo + hi))[:, None] * p
        w = torch.where(torch.all(torch.isfinite(w_new), dim=1, keepdim=True), w_new, w)
    v = con_mul(qp.G, w) + qp.c0
    kkt = torch.amax(torch.abs(mv(qp.H0, w) + qp.g0 + con_tmul(qp.G, _slack_gamma(v, *bounds))),
                     dim=-1)
    return w, kkt


def solve_ipm(qp: QP, warm: tuple, n_iters: int, n_polish: int = 1, gamma_ftb: float = 0.99):
    """The warm-started IPM and its polish; returns (w, kkt, warm_out) with
    warm = (su, sl, lam_u, lam_l, mu_u, mu_l), (B, nc) each."""
    H0, g0, G, c0, lb, ub, z1, z2 = qp
    act_u, act_l, s_u, s_l = masks_of(lb, ub, z2)
    ones, zero = torch.ones_like(c0), torch.zeros_like(c0)
    clipw = lambda x: torch.clamp(x, WARM_MIN, WARM_MAX)
    w_su, w_sl, w_lu, w_ll, w_mu, w_ml = warm
    su = torch.where(s_u, clipw(w_su), zero)
    sl = torch.where(s_l, clipw(w_sl), zero)
    pu = torch.where(act_u, torch.clamp(ub + su - c0, min=WARM_MIN), ones)
    pl = torch.where(act_l, torch.clamp(c0 + sl - lb, min=WARM_MIN), ones)
    carry = (torch.zeros_like(g0), torch.zeros_like(c0), su, sl, pu, pl,
             torch.where(act_u, clipw(w_lu), zero), torch.where(act_l, clipw(w_ll), zero),
             torch.where(s_u, clipw(w_mu), zero), torch.where(s_l, clipw(w_ml), zero))
    count = act_u.sum(1) + act_l.sum(1) + s_u.sum(1) + s_l.sum(1)
    nt = torch.clamp(count.to(c0.dtype), min=1.0)
    eye = torch.eye(H0.shape[-1], dtype=H0.dtype, device=H0.device)
    *_, sig_u, sig_l = _barrier(*carry[2:10], z1, z2, act_u, act_l, s_u, s_l)
    sig = sig_u + sig_l
    ncg = G.shape[1]
    for _ in range(n_iters):
        L = chol(H0 + con_normal(G, sig) + 1e-11 * eye)
        lam_d = carry[6] - carry[7]
        rw = mv(H0, carry[0]) + g0 + mtv(G, lam_d[:, :ncg]) + lam_d[:, ncg:]
        carry, sig, _ = _iteration(L, G, rw, c0, lb, ub, z1, z2, nt, carry, gamma_ftb)
    w, kkt = newton_polish(qp, carry[0], n_polish)
    return w, kkt, (carry[2], carry[3], carry[6], carry[7], carry[8], carry[9])
