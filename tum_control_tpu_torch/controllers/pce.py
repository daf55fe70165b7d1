"""Polynomial chaos expansion (PCE) machinery for SNMPC (port of
tum_control_tpu/controllers/pce.py).

Host-side numpy precomputation: every quantity is a constant per
configuration, computed once when the controller is built.

  * probabilists' Hermite polynomials normalized by sqrt(n!),
  * multi-indices alpha with |alpha| <= degree, ascending total degree,
  * L = (n_vars + d)! / (n_vars! d!) basis terms,
  * regression matrix A = pinv(Phi) over the Hammersley set (i/n first
    axis, van der Corput in prime bases after it) mapped through the
    standard-normal inverse CDF.

`fan_initial_state` is the one batched torch function: it spreads each
scenario's measured state into the stacked sample fan, by the constant
offsets of `fan_offsets`.
"""
from __future__ import annotations

import itertools
import math
import warnings

import numpy as np
import torch
from scipy.special import ndtri  # inverse standard normal CDF

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]


def hermite_norm(x, n):
    """Normalized probabilists' Hermite polynomial He_n(x)/sqrt(n!)."""
    if n == 0:
        return np.ones_like(np.asarray(x, dtype=float))
    if n == 1:
        return np.asarray(x, dtype=float)
    hm2 = np.ones_like(np.asarray(x, dtype=float))
    hm1 = np.asarray(x, dtype=float)
    for k in range(2, n + 1):   # unnormalized recurrence, normalized at the end
        hm2, hm1 = hm1, x * hm1 - (k - 1) * hm2
    return hm1 / math.sqrt(math.factorial(n))


def alpha_indices(n_vars: int, degree: int) -> np.ndarray:
    """Multi-indices with total degree <= degree, ascending total degree."""
    alphas = np.array(list(itertools.product(range(degree + 1), repeat=n_vars)))
    alphas = alphas[alphas.sum(axis=1) <= degree]
    # the same order as the reference's double reversal of a stable sort
    return alphas[np.argsort(alphas.sum(axis=1))[::-1]][::-1]


def n_poly_terms(n_vars: int, degree: int) -> int:
    return math.factorial(n_vars + degree) // (math.factorial(n_vars) * math.factorial(degree))


def _van_der_corput(i: int, base: int) -> float:
    q, denom = 0.0, 1.0
    while i > 0:
        denom *= base
        i, rem = divmod(i, base)
        q += rem / denom
    return q


def hammersley_normal_samples(n_samples: int, n_vars: int) -> np.ndarray:
    """(n_vars, n_samples) standard-normal low-discrepancy samples."""
    u = np.zeros((n_vars, n_samples))
    for i in range(n_samples):
        u[0, i] = (i + 0.5) / n_samples
        for j in range(1, n_vars):
            u[j, i] = _van_der_corput(i + 1, _PRIMES[j - 1])
    return ndtri(np.clip(u, 1e-12, 1 - 1e-12))


def pce_basis(samples: np.ndarray, alphas: np.ndarray) -> np.ndarray:
    """Phi (n_samples, L): the product Hermite basis at each sample."""
    n_vars, n_samples = samples.shape
    Phi = np.ones((n_samples, alphas.shape[0]))
    for ell in range(alphas.shape[0]):
        for j in range(n_vars):
            Phi[:, ell] *= hermite_norm(samples[j], int(alphas[ell, j]))
    return Phi


def regression_matrix(n_samples: int, n_vars: int, degree: int):
    """(w_samples (n_vars, n_samples), A (L, n_samples)): the least-squares
    PCE fit (Eq. 8 of arXiv:2310.18753) through the pseudo-inverse, which is
    the minimum-norm fit when the basis outnumbers the samples."""
    alphas = alpha_indices(n_vars, degree)
    L = alphas.shape[0]
    if n_samples < L:
        warnings.warn(
            f"PCE regression is underdetermined: {n_samples} samples for "
            f"{L} basis terms (n_vars={n_vars}, degree={degree}); using the "
            "minimum-norm least-squares fit. Increase n_samples (>= L) or "
            "reduce the expansion degree / active stds for a proper fit."
        )
    w = hammersley_normal_samples(n_samples, n_vars)
    return w, np.linalg.pinv(pce_basis(w, alphas))


def fan_offsets(w_samples: np.ndarray, stds) -> np.ndarray:
    """(n_samples + 1, nx) offsets of the sample fan from the measured state:
    row 0 (the nominal copy) zero, rows 1.. stds * w on the nonzero-std
    components."""
    stds = np.asarray(stds)
    active = np.nonzero(stds)[0]
    off = np.zeros((w_samples.shape[1] + 1, stds.shape[0]))
    off[1:, active] = (stds[active][:, None] * w_samples).T
    return off


def fan_initial_state(x0, offsets: torch.Tensor) -> torch.Tensor:
    """x0 (B, nx) -> (B, n_samples + 1, nx): x0 plus the `fan_offsets`,
    given as a tensor on x0's device and dtype."""
    return x0[:, None, :] + offsets
