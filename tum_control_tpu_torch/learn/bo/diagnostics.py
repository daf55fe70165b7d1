"""BO surrogate diagnostics: per-dimension GP posterior slice plots.

Parity with the reference's interactive surrogate visualizer
(Learning_To_Adapt/SafeRL_WMPC/helpers.py:111-232: `visualize_surrogate`
renders the GP over chosen parameter dims). Headless equivalent: for each
of the 7 parameter dimensions, a 1-D slice through the incumbent best point
showing each objective GP's posterior mean +- 2 sigma and the feasibility
model's probability, with the training points projected on. Port of
tum_control_tpu/learn/bo/diagnostics.py: the GP fits run on the optimizer's
device and dtype; the figure needs matplotlib.
"""
from __future__ import annotations

import numpy as np
import torch

from tum_control_tpu_torch.eval.plots import pyplot
from tum_control_tpu_torch.learn.bo.gp import fit_gp, gp_posterior

PARAM_NAMES = ["q_xy", "q_yaw", "q_vel", "r_jerk", "r_steer", "L1", "L2"]
OBJ_NAMES = ["-max|lat_dev|", "-RMS vel_dev"]


def surrogate_slice_plot(bo, group: int, path: str, n_grid: int = 101):
    """Fit the group's objective + feasibility GPs from `bo.trials` and save
    a (2 objectives + feasibility) x 7-dims slice figure to `path`."""
    plt = pyplot()
    from scipy.stats import norm

    X, Y, F = bo._train_data(group)
    feas = ~np.isnan(Y[:, 0])
    if feas.sum() < 3:
        raise ValueError(f"group {group}: only {feas.sum()} feasible trials")
    t = lambda a: torch.as_tensor(a, dtype=bo.dtype, device=bo.device)
    gps = [fit_gp(t(X[feas]), t(Y[feas, j])) for j in range(2)]
    feas_gp = fit_gp(t(X), t(F))
    posterior = lambda gp, Xq: (v.cpu().numpy() for v in gp_posterior(gp, t(Xq)))

    # incumbent: best feasible hypervolume-ish point = max sum of normalized objectives
    Yf = Y[feas]
    score = (Yf - Yf.min(0)) / (np.ptp(Yf, 0) + 1e-9)
    x_star = X[feas][np.argmax(score.sum(1))]

    d = X.shape[1]
    fig, axs = plt.subplots(3, d, figsize=(3.0 * d, 8), sharex="col")
    ts = np.linspace(0.0, 1.0, n_grid)
    for j in range(d):
        Xq = np.tile(x_star, (n_grid, 1))
        Xq[:, j] = ts
        xs_phys = bo.lo[j] + ts * (bo.hi[j] - bo.lo[j])
        for o in range(2):
            mu, sd = posterior(gps[o], Xq)
            ax = axs[o, j]
            ax.plot(xs_phys, mu, "b-")
            ax.fill_between(xs_phys, mu - 2 * sd, mu + 2 * sd, alpha=0.25)
            ax.plot(
                bo.lo[j] + X[feas][:, j] * (bo.hi[j] - bo.lo[j]),
                Y[feas, o], "k.", ms=3, alpha=0.4,
            )
            if o == 0:
                ax.set_title(PARAM_NAMES[j] if j < len(PARAM_NAMES) else f"p{j}")
            if j == 0:
                ax.set_ylabel(OBJ_NAMES[o])
        mu_f, sd_f = posterior(feas_gp, Xq)
        p_feas = norm.cdf(mu_f / np.sqrt(1.0 + sd_f**2))
        ax = axs[2, j]
        ax.plot(xs_phys, p_feas, "g-")
        ax.set_ylim(-0.05, 1.05)
        if j == 0:
            ax.set_ylabel("P(feasible)")
        ax.set_xlabel(PARAM_NAMES[j] if j < len(PARAM_NAMES) else f"p{j}")
    fig.suptitle(
        f"GP surrogate slices through incumbent, segment group {group} "
        f"({int(feas.sum())}/{len(X)} feasible trials)"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
