"""Exact Gaussian-process surrogates, port of tum_control_tpu/learn/bo/gp.py.

RBF-ARD kernel over the normalized 7-d parameter space, standardized
targets, Gaussian likelihood, hyperparameters fit by Adam on the exact
marginal log-likelihood with mild log-normal hyperpriors. The feasibility
model is a GP regression on +-1 labels squashed through a probit, as in the
JAX package.

The math runs on the device and in the dtype of the data it is given (the
BO optimizer's), with no move. A failed Cholesky factorization gives NaNs,
as `jnp.linalg.cholesky` does: `torch.linalg.cholesky_ex` reports it in
`info` instead of raising, and the NaNs select the same branches (a skipped
fit step, independent posterior samples).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tum_control_tpu_torch.learn.adam import AdamState, adam_init, adam_update


class GPParams(NamedTuple):
    log_lengthscales: torch.Tensor  # (d,)
    log_outputscale: torch.Tensor   # ()
    log_noise: torch.Tensor         # ()


class GPData(NamedTuple):
    X: torch.Tensor       # (n, d) train inputs (normalized to [0,1]^d)
    y: torch.Tensor       # (n,) standardized targets
    y_mean: torch.Tensor
    y_std: torch.Tensor
    params: GPParams
    L: torch.Tensor       # (n, n) cholesky of K + sigma^2 I
    alpha: torch.Tensor   # (n,) K^-1 y


def _kernel(params: GPParams, X1, X2):
    ls = torch.exp(params.log_lengthscales)
    d = (X1[:, None, :] - X2[None, :, :]) / ls
    return torch.exp(params.log_outputscale) * torch.exp(-0.5 * torch.sum(d * d, dim=-1))


def _K_train(params: GPParams, X):
    # relative jitter: in float32 an absolute 1e-6 floor underflows against a
    # large outputscale
    n = X.shape[0]
    jit = torch.exp(params.log_noise) + 1e-6 + 1e-5 * torch.exp(params.log_outputscale)
    return _kernel(params, X, X) + jit * torch.eye(n, dtype=X.dtype, device=X.device)


def cholesky(K):
    """Lower Cholesky factor of K, NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info[..., None, None] == 0, L, torch.full_like(L, math.nan))


def cho_solve(L, b):
    """x with L L^T x = b, b (n,) or (n, k)."""
    col = b.dim() == 1
    b = b[:, None] if col else b
    z = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)
    return x[:, 0] if col else x


def _mll(params: GPParams, X, y):
    n = X.shape[0]
    L = cholesky(_K_train(params, X))
    alpha = cho_solve(L, y)
    mll = (-0.5 * torch.dot(y, alpha) - torch.sum(torch.log(torch.diagonal(L)))
           - 0.5 * n * math.log(2 * math.pi))
    prior = (
        -0.5 * torch.sum((params.log_lengthscales - math.log(0.5)) ** 2) / 0.75**2
        - 0.5 * params.log_outputscale**2 / 1.0
        - 0.5 * (params.log_noise + 4.0) ** 2 / 2.0**2
    )
    return mll + prior


def fit_gp(X, y, n_steps: int = 300, lr: float = 0.05, init: GPParams = None) -> GPData:
    """Fit the hyperparameters (Adam on -MLL; a step whose loss or gradient
    is not finite is skipped, optimizer state included) and precompute the
    posterior factorization. `init` warm-starts the hyperparameters, e.g.
    from the previous BO iteration's fit."""
    y_mean, y_std = y.mean(), y.std(correction=0) + 1e-8
    ys = (y - y_mean) / y_std
    if init is None:
        init = GPParams(
            log_lengthscales=torch.full((X.shape[1],), -0.5, dtype=X.dtype, device=X.device),
            log_outputscale=X.new_zeros(()),
            log_noise=X.new_full((), -4.0),
        )
    params = list(init)
    state = adam_init(params)
    for _ in range(n_steps):
        p = [t.detach().requires_grad_() for t in params]
        loss = -_mll(GPParams(*p), X, ys)
        grads = torch.autograd.grad(loss, p)
        upd, new_state = adam_update(grads, state, lr)
        ok = torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()
        keep = lambda new, old: [torch.where(ok, a, b) for a, b in zip(new, old)]
        params = keep([a.detach() + u for a, u in zip(params, upd)], params)
        state = AdamState(count=torch.where(ok, new_state.count, state.count),
                          mu=keep(new_state.mu, state.mu), nu=keep(new_state.nu, state.nu))
    params = GPParams(*params)
    L = cholesky(_K_train(params, X))
    return GPData(X=X, y=ys, y_mean=y_mean, y_std=y_std, params=params, L=L,
                  alpha=cho_solve(L, ys))


def gp_posterior(gp: GPData, Xq):
    """(mean (m,), std (m,)) in the original target scale."""
    Kq = _kernel(gp.params, Xq, gp.X)
    mean_s = Kq @ gp.alpha
    v = torch.linalg.solve_triangular(gp.L, Kq.T, upper=False)
    var_s = torch.clamp(torch.exp(gp.params.log_outputscale) - torch.sum(v * v, dim=0),
                        min=1e-12)
    return mean_s * gp.y_std + gp.y_mean, torch.sqrt(var_s) * gp.y_std


def gp_sample(gp: GPData, Xq, eps):
    """Joint posterior samples (n_samples, m) at Xq (m, d) from standard
    normals eps (n_samples, m). Where the jittered joint covariance has no
    Cholesky factor, independent per-point samples (exact marginals, no
    cross-correlation)."""
    Kq = _kernel(gp.params, Xq, gp.X)
    mean_s = Kq @ gp.alpha
    v = torch.linalg.solve_triangular(gp.L, Kq.T, upper=False)
    scale = torch.exp(gp.params.log_outputscale)
    eye = torch.eye(Xq.shape[0], dtype=Xq.dtype, device=Xq.device)
    cov = _kernel(gp.params, Xq, Xq) - v.T @ v + (1e-9 + 1e-5 * scale) * eye
    Lq = cholesky(cov)
    sd_marg = torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-12))
    joint = mean_s[None, :] + eps @ Lq.T
    indep = mean_s[None, :] + eps * sd_marg[None, :]
    samp = torch.where(torch.isfinite(Lq).all(), joint, indep)
    return samp * gp.y_std + gp.y_mean
