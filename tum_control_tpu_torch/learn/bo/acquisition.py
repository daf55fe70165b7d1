"""Feasibility-weighted expected-hypervolume-improvement acquisition, port
of tum_control_tpu/learn/bo/acquisition.py:

  * 2-objective EHVI by Monte Carlo over joint GP posterior samples, the
    hypervolume improvement of each sample computed exactly against the
    current Pareto front (2-D strip sweep),
  * weighted by eps p_feas + (1 - eps) 2 sqrt(p_feas (1 - p_feas)) from the
    feasibility GP,
  * candidates by a scrambled Sobol screen, an Adam polish of the best 4q
    clipped to [0, 1], and a distinct-q selection with its fallbacks.

The MC normals are common random numbers: every evaluation of one
acquisition at m points uses the same draws (a generator reseeded from the
acquisition's seed), so the polish ascends a deterministic function. A
caller may inject the draws (`draws`).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import qmc

from tum_control_tpu_torch.learn.adam import adam_init, adam_update
from tum_control_tpu_torch.learn.bo.gp import GPData, gp_posterior, gp_sample


def pareto_mask(Y: np.ndarray) -> np.ndarray:
    """Non-dominated mask for maximization, (n, m) objectives."""
    n = Y.shape[0]
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dom = np.all(Y >= Y[i], axis=1) & np.any(Y > Y[i], axis=1)
        if np.any(dom & mask):
            mask[i] = False
    return mask


def hypervolume_2d(front: np.ndarray, ref: np.ndarray) -> float:
    """Exact dominated hypervolume for 2 objectives (maximization)."""
    pts = front[np.all(front > ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    pts = pts[np.argsort(-pts[:, 0])]
    hv, y_prev = 0.0, ref[1]
    for x, y in pts:
        if y > y_prev:
            hv += (x - ref[0]) * (y - y_prev)
            y_prev = y
    return float(hv)


def _hvi_candidate(f_cand, front_sorted, ref):
    """Hypervolume improvement of candidate points f_cand (..., 2) over a
    front (k, 2) sorted by descending f0; differentiable in f_cand. Strip i
    spans [max(fx[i+1], ref0), fx[i]], where the front's level is the
    running max of f1 over the points with larger f0."""
    one = ref.new_ones(1)
    fx = torch.cat([one * torch.inf, front_sorted[:, 0], ref[0:1]])
    fy = torch.cat([ref[1:2], torch.cummax(front_sorted[:, 1], dim=0).values])
    x_hi = torch.minimum(fx[:-1], f_cand[..., 0:1])
    x_lo = torch.maximum(fx[1:], ref[0])
    width = torch.clamp(x_hi - x_lo, min=0.0)
    height = torch.clamp(f_cand[..., 1:2] - torch.maximum(fy, ref[1]), min=0.0)
    return torch.sum(width * height, dim=-1)


class EHVIAcquisition:
    """Feasibility-weighted MC-EHVI, a differentiable acq(X (m, d)) -> (m,)."""

    def __init__(self, gps, feas_gp: GPData, front, ref, eps: float, seed: int,
                 n_mc: int = 64, draws=None):
        self.gp0, self.gp1 = gps
        self.feas = feas_gp
        self.front, self.ref = front, ref
        self.eps, self.seed, self.n_mc = eps, seed, n_mc
        self.draws = draws

    def normals(self, m: int):
        """The (2, n_mc, m) MC normals of an evaluation at m points."""
        if self.draws is not None:
            return self.draws(m)
        X = self.feas.X
        gen = torch.Generator(device=X.device)
        gen.manual_seed(self.seed)
        return torch.randn((2, self.n_mc, m), generator=gen, dtype=X.dtype, device=X.device)

    def __call__(self, X):
        eps = self.normals(X.shape[0])
        f = torch.stack([gp_sample(self.gp0, X, eps[0]), gp_sample(self.gp1, X, eps[1])], dim=-1)
        ehvi = _hvi_candidate(f, self.front, self.ref).mean(dim=0)   # (m,)
        mu_f, sd_f = gp_posterior(self.feas, X)
        p_feas = torch.special.ndtr(mu_f / (sd_f + 1e-9))
        # exploration on the probability scale: sqrt(p (1-p)) peaks at the
        # feasibility boundary and stays bounded far from the data
        sigma_p = 2.0 * torch.sqrt(p_feas * (1.0 - p_feas))
        return ehvi * (self.eps * p_feas + (1.0 - self.eps) * sigma_p)


class FeasibilityAcquisition:
    """Probability of feasibility plus an exploration bonus, for an empty
    Pareto front."""

    def __init__(self, feas_gp: GPData):
        self.feas = feas_gp

    def __call__(self, X):
        mu, sd = gp_posterior(self.feas, X)
        return torch.special.ndtr(mu / (sd + 1e-9)) + 0.5 * sd


def make_acquisition(gps, feas_gp: GPData, front: np.ndarray, ref: np.ndarray, eps: float,
                     seed: int, n_mc: int = 64, draws=None) -> EHVIAcquisition:
    """The EHVI acquisition on the feasibility GP's device and dtype."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=feas_gp.X.dtype, device=feas_gp.X.device)
    front = front[np.argsort(-front[:, 0])]
    return EHVIAcquisition(gps, feas_gp, t(front), t(ref), eps, seed, n_mc, draws)


def make_feasibility_acquisition(feas_gp: GPData) -> FeasibilityAcquisition:
    return FeasibilityAcquisition(feas_gp)


def optimize_acquisition(acq, d: int, q: int, seed: int, n_raw: int = 512, n_polish: int = 60,
                         lr: float = 0.02, device=None, dtype=None) -> np.ndarray:
    """q candidates (q, d) in [0, 1]^d: the best 4q of a scrambled Sobol
    screen of n_raw points (Sobol seed `seed`), each polished by `n_polish`
    Adam steps on the acquisition, clipped to [0, 1] (a step that leaves a
    non-finite point keeps the point before it); then the highest values at
    least 0.02 apart. Falls back to the screen's winners when no polished
    point is finite, to fresh Sobol points when none of those is, and
    repeats the best when fewer than q are distinct. On `device` / `dtype`
    (default: the acquisition's GP data)."""
    X_ref = acq.feas.X
    device = X_ref.device if device is None else device
    dtype = X_ref.dtype if dtype is None else dtype
    sob = qmc.Sobol(d, scramble=True, seed=int(seed))
    X0 = torch.as_tensor(sob.random(n_raw), dtype=dtype, device=device)
    with torch.no_grad():
        vals0 = acq(X0)
    top = torch.argsort(-vals0, stable=True)[: 4 * q]
    X = X0[top]
    screen_vals = vals0[top].cpu().numpy()

    state = adam_init([X])
    for _ in range(n_polish):
        Z = X.detach().requires_grad_()
        (g,) = torch.autograd.grad(-torch.sum(acq(Z)), Z)
        (upd,), state = adam_update([g], state, lr)
        X_new = torch.clamp(X + upd, 0.0, 1.0)
        X = torch.where(torch.isfinite(X_new), X_new, X)

    with torch.no_grad():
        vals = acq(X).cpu().numpy()
    X_np = X.cpu().numpy()
    finite = np.all(np.isfinite(X_np), axis=1) & np.isfinite(vals)
    if not finite.any():
        X_np, vals = X0[top].cpu().numpy(), screen_vals
        finite = np.all(np.isfinite(X_np), axis=1) & np.isfinite(vals)
    if not finite.any():
        return sob.random(q)
    order = [i for i in np.argsort(-vals) if finite[i]]
    chosen = []
    for i in order:
        x = X_np[i]
        if all(np.linalg.norm(x - c) > 0.02 for c in chosen):
            chosen.append(x)
        if len(chosen) == q:
            break
    while len(chosen) < q:
        chosen.append(X_np[order[0]])
    return np.stack(chosen)
