"""BO postprocessing: Pareto extraction + point-cloud reduction -> F.csv,
port of tum_control_tpu/learn/bo/postprocess.py.

Per segment group extract the Pareto-optimal trials, reduce the cloud to a
representative set (the per-objective best points + the points nearest to
k-means centroids) and export the parameter sets as the WMPC action catalog
CSV, which both packages' `load_param_table` read. The JAX package clusters
with scikit-learn's KMeans; the port keeps its own k-means (k-means++
seeding, Lloyd iterations, the best of 10 seeded restarts) in numpy.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from tum_control_tpu_torch.learn.bo.acquisition import pareto_mask


def extract_pareto(trials, group: int, max_lat: float = None):
    """(params (k, 7), objectives (k, 2)) of the group's Pareto-optimal
    trials. `max_lat` drops trials with f0 < -max_lat before the Pareto
    mask, so a safe point dominated only by an excluded risky one stays."""
    ok = lambda t: bool(np.asarray(t.feasible).reshape(-1)[group])
    X = np.asarray([t.params for t in trials if ok(t)])
    Y = np.asarray([t.objectives[group] for t in trials if ok(t)])
    if len(X) and max_lat is not None:
        m = Y[:, 0] >= -max_lat  # f0 = -max|lat_dev|
        X, Y = X[m], Y[m]
    if len(X) == 0:
        return X.reshape(0, 7), Y.reshape(0, 2)
    m = pareto_mask(Y)
    return X[m], Y[m]


def kmeans(Y: np.ndarray, k: int, n_init: int = 10, seed: int = 0, max_iter: int = 300):
    """Centroids (k, m) of the best (least within-cluster sum of squares) of
    `n_init` k-means runs, each seeded by k-means++ from one generator."""
    rng = np.random.default_rng(seed)
    best, best_inertia = None, np.inf
    for _ in range(n_init):
        C = Y[[rng.integers(len(Y))]]
        for _ in range(1, k):
            d2 = np.min(((Y[:, None] - C[None]) ** 2).sum(-1), axis=1)
            C = np.vstack([C, Y[rng.choice(len(Y), p=d2 / d2.sum() if d2.sum() > 0 else None)]])
        for _ in range(max_iter):
            lab = np.argmin(((Y[:, None] - C[None]) ** 2).sum(-1), axis=1)
            C_new = np.stack([Y[lab == j].mean(0) if np.any(lab == j) else C[j] for j in range(k)])
            if np.allclose(C_new, C):
                break
            C = C_new
        inertia = float(np.min(((Y[:, None] - C[None]) ** 2).sum(-1), axis=1).sum())
        if inertia < best_inertia:
            best, best_inertia = C, inertia
    return best


def reduce_points(X: np.ndarray, Y: np.ndarray, n_clusters: int):
    """Keep the per-objective best points + the points nearest to the
    k-means centroids."""
    if len(X) <= n_clusters:
        return X, Y
    keep = set(int(np.argmax(Y[:, j])) for j in range(Y.shape[1]))
    for c in kmeans(Y, n_clusters):
        keep.add(int(np.argmin(np.linalg.norm(Y - c, axis=1))))
    idx = sorted(keep)
    return X[idx], Y[idx]


def export_parameter_sets(trials, path: str, n_per_group: int = 13,
                          per_group_files: bool = False, max_lat: float = None) -> np.ndarray:
    """Combined per-group reduced Pareto sets -> CSV rows of 7 parameters
    (with per_group_files also <stem>_0.csv / <stem>_1.csv). A trial
    Pareto-optimal in both groups appears once."""
    rows: List[np.ndarray] = []
    stem, ext = os.path.splitext(path)
    for group in (0, 1):
        X, Y = extract_pareto(trials, group, max_lat=max_lat)
        if len(X) == 0:
            continue
        Xr, _ = reduce_points(X, Y, n_per_group)
        rows.extend(Xr)
        if per_group_files:
            np.savetxt(f"{stem}_{group}{ext}", np.asarray(Xr), delimiter=",", fmt="%.4g")
    seen, uniq = set(), []
    for r in rows:
        key = tuple(np.round(np.asarray(r, dtype=float), 12))
        if key not in seen:
            seen.add(key)
            uniq.append(r)
    table = np.asarray(uniq)
    np.savetxt(path, table, delimiter=",", fmt="%.4g")
    return table
