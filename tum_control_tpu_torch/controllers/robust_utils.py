"""Full-ZoRo augmented model: the state covariance inside the ODE state,
with continuous-time Lyapunov dynamics (batched port of
tum_control_tpu/controllers/robust_utils.py).

The augmented state is [x (8), vec_sym(Sigma) (36)] and

    Sigma_dot = D Sigma + Sigma D' + B W B'

with D = df/dx at the nominal state (per scenario, by `torch.func.jacfwd`),
B the selector injecting disturbances on [yaw, vlong, vlat, yawrate], and a
stop flag freezing Sigma beyond the uncertainty propagation horizon. The
reduced controller (rnmpc.py) is the production path; like the JAX
package's module, this one is not wired into a controller.

Batch-first: augmented states are (B, 44), inputs (B, 2). The packed
layout is the upper triangle by rows, vec = [M[0,0:], M[1,1:], ...,
M[nx-1,nx-1]].
"""
from __future__ import annotations

import numpy as np
import torch

from tum_control_tpu_torch.models.integrators import rk4_multistep

NX = 8
NSIG = NX * (NX + 1) // 2

# disturbance enters [yaw, vlong, vlat, yawrate]
B_SEL = np.zeros((NX, 4))
B_SEL[2, 0] = B_SEL[3, 1] = B_SEL[4, 2] = B_SEL[5, 3] = 1.0

# (row, col) of each packed element
_ROWS, _COLS = np.triu_indices(NX)


def vec2sym_mat(vec):
    """(..., NSIG) packed upper triangle by rows -> (..., NX, NX) symmetric."""
    mat = vec.new_zeros(vec.shape[:-1] + (NX, NX))
    mat[..., _ROWS, _COLS] = vec
    mat[..., _COLS, _ROWS] = vec
    return mat


def sym_mat2vec(mat):
    """(..., NX, NX) symmetric -> (..., NSIG) packed upper triangle by rows."""
    return mat[..., _ROWS, _COLS]


def aug_ode(f_nominal, x_aug, u, W_dist, stop_flag=0.0):
    """Augmented dynamics [x_dot, vec(Sigma_dot)] of (B, 44) states.

    f_nominal : (x (..., 8), u (..., 2)) -> x_dot (..., 8), the nominal
                prediction ODE (any leading batch shape)
    W_dist    : (4, 4) disturbance covariance on [yaw, vlong, vlat, yawrate]
    stop_flag : 1.0 freezes Sigma (a float, or a (B,) tensor per scenario)
    """
    x, sig_vec = x_aug[:, :NX], x_aug[:, NX:]
    x_dot = f_nominal(x, u)
    # D per scenario: the Jacobian with respect to one offset added to every
    # row (rows do not interact), as ops/kernels/linearize.py::linearize_ref;
    # batched rows keep functorch's tangents in x's dtype, where vmap over
    # single rows would make 0-d intermediates and float64 tangents
    D = torch.func.jacfwd(lambda v: f_nominal(x + v, u))(torch.zeros_like(x[0]))
    Sigma = vec2sym_mat(sig_vec)
    Bs = torch.as_tensor(B_SEL, dtype=x.dtype, device=x.device)
    W = torch.as_tensor(W_dist, dtype=x.dtype, device=x.device)
    Sigma_dot = D @ Sigma + Sigma @ D.transpose(-1, -2) + Bs @ W @ Bs.T
    stop = torch.as_tensor(stop_flag, dtype=x.dtype, device=x.device)
    Sigma_dot = torch.where((stop == 1.0).reshape(-1, 1, 1), torch.zeros_like(Sigma_dot),
                            Sigma_dot)
    return torch.cat([x_dot, sym_mat2vec(Sigma_dot)], dim=-1)


def make_aug_step(f_nominal, W_dist, dt: float, substeps: int = 3):
    """RK4 discrete step of the augmented model; returns
    (x_aug (B, 44), u (B, 2), stop_flag) -> x_aug_next."""

    def step(x_aug, u, stop_flag=0.0):
        f = lambda xa, uu: aug_ode(f_nominal, xa, uu, W_dist, stop_flag)
        return rk4_multistep(f, x_aug, u, dt, substeps)

    return step


def aug_initial_state(x0, Sigma0):
    """[x0, vec_sym(Sigma0)]: (B, 8), (B, 8, 8) -> (B, 44)."""
    return torch.cat([x0, sym_mat2vec(Sigma0)], dim=-1)
