"""The two controllers of the reference as `engine.Problem`s (see __init__):
the nominal NMPC (8 states, RK4 of 3 substeps over Ts_MPC) and the
stochastic NMPC in its dense formulation (n_samples + 1 stacked copies of
the 8-state model, one RK4 substep, PCE chance-constraint surrogates below
the uncertainty propagation horizon); `controller` finds either, or a
later controller's file with its hooks of carried state."""
from __future__ import annotations

import importlib.util
import itertools
import math
import os
from types import SimpleNamespace

import numpy as np
import torch
from scipy.special import ndtri

from benchmark.reference.engine import Problem, linearize
from benchmark.reference.model import GG, N_H, acc_bounds, acc_constraints, pred_ode, rk4, wrap_2pi

BIG = 1e12
HARD_Z2 = 1e7
N_SHOOTING_SUBSTEPS = 3
_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def _static(mpc: dict, vp, N: int, t):
    """Weights, bounds and slack penalties shared by both controllers."""
    shape = mpc["combined_acc_limits"]
    nh = N_H[shape]
    Q = [mpc["q_lon"] / mpc["s_lon"] ** 2, mpc["q_lat"] / mpc["s_lat"] ** 2,
         mpc["q_yaw"] / mpc["s_yaw"] ** 2, mpc["q_vel"] / mpc["s_vel"] ** 2]
    R = [mpc["r_jerk"] / mpc["s_jerk"] ** 2,
         mpc["r_steering_rate"] / mpc["s_steering_rate"] ** 2]
    lh, uh = acc_bounds(shape)
    con_lb = np.tile(np.concatenate([lh, [vp.delta_f_min]]), (N + 1, 1))
    con_ub = np.tile(np.concatenate([uh, [vp.delta_f_max]]), (N + 1, 1))
    con_lb[0, nh], con_ub[0, nh] = -BIG, BIG
    u_lb = np.tile([-BIG, vp.delta_f_dot_min], (N, 1))
    u_ub = np.tile([BIG, vp.delta_f_dot_max], (N, 1))
    u_z1 = np.full_like(u_lb, mpc["L1_pen"])
    u_z2 = np.full_like(u_lb, mpc["L2_pen"])
    u_z1[0, :], u_z2[0, :] = 0.0, HARD_Z2
    return dict(W=t(0.01 * np.array(Q + R)), We=t(0.01 * np.array(Q)), con_lb=t(con_lb),
                con_ub=t(con_ub), con_z1=t(np.full_like(con_lb, mpc["L1_pen"])),
                con_z2=t(np.full_like(con_lb, mpc["L2_pen"])), u_lb=t(u_lb), u_ub=t(u_ub),
                u_z1=t(u_z1), u_z2=t(u_z2), qp_iters=int(mpc["qp_iters"]),
                sqp_iters=int(mpc["sqp_iters"]))


def nominal(mpc: dict, vp, tp, gg: GG, N: int, dt: float, dtype, device):
    shape = mpc["combined_acc_limits"]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    step = lambda x, u: rk4(lambda xx, uu: pred_ode(xx, uu, vp, tp), x, u, dt,
                            N_SHOOTING_SUBSTEPS)

    def lin(X, U):
        F, J = linearize(step, torch.cat([X, U], dim=-1), 8)
        return F, J[..., :8], J[..., 8:]

    def y_stage(x, u):
        return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), x[..., 3:4], u], dim=-1)

    def y_term(x):
        return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), x[..., 3:4]], dim=-1)

    def con_stage(x):
        h = acc_constraints(x[..., 3], x[..., 7], x[..., 3] * x[..., 5], gg, vp.acc_min, shape)
        return torch.cat([h, x[..., 6:7]], dim=-1)

    return Problem(N=N, nx=8, nu=2, lin=lin, y_stage=y_stage, y_term=y_term,
                   con_stage=con_stage, **_static(mpc, vp, N, t)), None


# --- polynomial chaos expansion (controllers/pce.py) ---

def _hermite_norm(x, n):
    if n == 0:
        return np.ones_like(np.asarray(x, dtype=float))
    if n == 1:
        return np.asarray(x, dtype=float)
    hm2, hm1 = np.ones_like(np.asarray(x, dtype=float)), np.asarray(x, dtype=float)
    for k in range(2, n + 1):
        hm2, hm1 = hm1, x * hm1 - (k - 1) * hm2
    return hm1 / math.sqrt(math.factorial(n))


def _van_der_corput(i, base):
    q, denom = 0.0, 1.0
    while i > 0:
        denom *= base
        i, rem = divmod(i, base)
        q += rem / denom
    return q


def pce_regression(n_samples: int, n_vars: int, degree: int):
    """(w (n_vars, n_samples) Hammersley normal samples, A (L, n_samples) = pinv(Phi))."""
    alphas = np.array(list(itertools.product(range(degree + 1), repeat=n_vars)))
    alphas = alphas[alphas.sum(axis=1) <= degree]
    alphas = alphas[np.argsort(alphas.sum(axis=1))[::-1]][::-1]
    u = np.zeros((n_vars, n_samples))
    for i in range(n_samples):
        u[0, i] = (i + 0.5) / n_samples
        for j in range(1, n_vars):
            u[j, i] = _van_der_corput(i + 1, _PRIMES[j - 1])
    w = ndtri(np.clip(u, 1e-12, 1 - 1e-12))
    Phi = np.ones((n_samples, alphas.shape[0]))
    for ell in range(alphas.shape[0]):
        for j in range(n_vars):
            Phi[:, ell] *= _hermite_norm(w[j], int(alphas[ell, j]))
    return w, np.linalg.pinv(Phi)


def snmpc(mpc: dict, vp, tp, gg: GG, N: int, dt: float, dtype, device):
    """Returns (Problem over the stacked state, fan offsets (ns + 1, 8))."""
    shape = mpc["combined_acc_limits"]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ns = int(mpc["n_samples"])
    ns1, nu = ns + 1, 2
    nx = 8 * ns1
    stds = np.asarray(mpc["stds"], dtype=float)
    active = np.nonzero(stds)[0]
    w_s, A_np = pce_regression(ns, len(active), int(mpc["expansion_degree"]))
    off = np.zeros((ns1, 8))
    off[1:, active] = (stds[active][:, None] * w_s).T
    A, A0 = t(A_np), t(A_np)[0]
    kappa = float(np.sqrt((1.0 - mpc["gamma"]) / mpc["gamma"]))
    uph = int(mpc["uncertainty_propagation_horizon"])
    ue, c_split = max(0, min(uph, N)), max(0, min(uph, N + 1))
    eye8 = torch.eye(8, dtype=dtype, device=device)
    step8 = lambda x, u: rk4(lambda xx, uu: pred_ode(xx, uu, vp, tp), x, u, dt, 1)

    def nodes(live, frozen, axis):
        return torch.cat([live.narrow(axis, 0, ue),
                          frozen.narrow(axis, ue, frozen.shape[axis] - ue)], dim=axis)

    def lin(x, u):
        """The stacked dynamics' values and Jacobians from per-copy 8 x 10
        Jacobians; below the horizon the nominal row is the PCE mean of the
        samples, beyond it the samples stay frozen."""
        Bt = x.shape[0]
        xs = x.unflatten(-1, (ns1, 8))
        XU = torch.cat([xs, u[:, :, None, :].expand(Bt, N, ns1, nu)], dim=-1)
        F_all, J_all = linearize(step8, XU.reshape(Bt, N * ns1, 8 + nu), 8)
        F_all = F_all.reshape(Bt, N, ns1, 8)
        J_all = J_all.reshape(Bt, N, ns1, 8, 8 + nu)
        A_blk, B_blk = J_all[..., :8], J_all[..., 8:]
        mean_next = torch.matmul(A0, F_all[:, :, 1:])
        F = nodes(torch.cat([mean_next[:, :, None], F_all[:, :, 1:]], dim=2),
                  torch.cat([F_all[:, :, :1], xs[:, :, 1:]], dim=2), 1).flatten(-2)
        A_eff = nodes(torch.cat([torch.zeros_like(A_blk[:, :, :1]), A_blk[:, :, 1:]], dim=2),
                      torch.cat([A_blk[:, :, :1], eye8.expand_as(A_blk[:, :, 1:])], dim=2), 1)
        diag_sel = torch.eye(ns1, dtype=x.dtype, device=x.device)[:, None, :, None]
        A4 = diag_sel * A_eff[:, :, :, :, None, :]
        coupling = A0[:, None, None] * A_blk[:, :, 1:]
        coupling = nodes(coupling, torch.zeros_like(coupling), 1)
        A4[:, :, 0, :, 1:, :] = coupling.permute(0, 1, 3, 2, 4)
        B_nom = nodes(torch.einsum("s,bnsij->bnij", A0, B_blk[:, :, 1:]), B_blk[:, :, 0], 1)
        B_smp = nodes(B_blk[:, :, 1:], torch.zeros_like(B_blk[:, :, 1:]), 1)
        Bm = torch.cat([B_nom[:, :, None], B_smp], dim=2).reshape(Bt, N, nx, nu)
        return F, A4.reshape(Bt, N, nx, nx), Bm

    def h_of(x8):
        vel_abs = torch.sqrt(x8[..., 3] ** 2 + x8[..., 4] ** 2)
        return acc_constraints(vel_abs, x8[..., 7], x8[..., 3] * x8[..., 5], gg, vp.acc_min,
                               shape)

    def y_stage(x, u):
        vel_abs = torch.sqrt(x[..., 3:4] ** 2 + x[..., 4:5] ** 2)
        return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), vel_abs, u], dim=-1)

    def y_term(x):
        vel_abs = torch.sqrt(x[..., 3:4] ** 2 + x[..., 4:5] ** 2)
        return torch.cat([x[..., 0:2], wrap_2pi(x[..., 2:3]), vel_abs], dim=-1)

    def con_stage(x):
        xs = x.unflatten(-1, (ns1, 8))
        h_all = h_of(xs)
        coeff = torch.matmul(A, h_all[..., 1:, :])
        sd = torch.sqrt(torch.sum(coeff[..., 1:, :] ** 2, dim=-2) + 1e-30)
        h_cc = coeff[..., 0, :] + sd * kappa
        h = torch.cat([h_cc[..., :c_split, :], h_all[..., c_split:, 0, :]], dim=-2)
        return torch.cat([h, xs[..., 0, 6:7]], dim=-1)

    prob = Problem(N=N, nx=nx, nu=nu, lin=lin, y_stage=y_stage, y_term=y_term,
                   con_stage=con_stage, **_static(mpc, vp, N, t))
    return prob, t(off)


HOOKS = ("init", "problem", "advance")


def controller(name: str, root: str) -> SimpleNamespace:
    """Controller `name` of the reference: `build(mpc, vp, tp, gg, N, dt,
    dtype, device)` -> (Problem, fan offsets or None), a function of this
    module or of a file benchmark/reference/controller_<name>.py of the
    checkout `root` (a later controller comes as a file of its own), and
    that file's hooks of the controller's carried state (None where it
    defines none):

      init(x0) -> extra         the carried state of the scenarios x0 (B, 8)
      problem(p, extra) -> Problem   the Problem of this step, its weights,
                                bounds and penalties per scenario (B, ...)
      advance(extra, x0, window, X, U, A, status) -> extra   the carried
                                state after the step's solve: x0 the
                                estimate (B, 8), window the planner's, X, U,
                                A and status `engine.rti`'s

    `extra` is a tuple of tensors in the order of the port's carried
    NamedTuple's fields, a nested one in its place (compare.extra_tensors)."""
    if name in ("nominal", "snmpc"):
        return SimpleNamespace(build=globals()[name], **dict.fromkeys(HOOKS))
    path = os.path.join(root, "benchmark", "reference", f"controller_{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_controller_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return SimpleNamespace(build=mod.build, **{h: getattr(mod, h, None) for h in HOOKS})
