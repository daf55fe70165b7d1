"""Multi-objective BO of the NMPC cost weights, port of
tum_control_tpu/learn/bo/optimizer.py.

Alternates between two track-segment groups (high / low curvature): per
iteration it fits GP surrogates of both objectives and a feasibility GP on
the group's trials, optimizes the feasibility-weighted MC-EHVI for a batch
of q candidates and evaluates them on every group (ObjectiveEvaluator).
Trials persist to the reference's CSV layout (bayesian_optimization.py:
464-508), which both packages read.

The GP and acquisition math runs on the optimizer's `device` (cuda unless
named) in its `dtype`; every random draw (Sobol seeds, the fixed-size
subsamples, the MC seed) comes from one numpy generator seeded by `seed`.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional

import numpy as np
import torch
from scipy.stats import qmc

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.bo.acquisition import (
    hypervolume_2d, make_acquisition, make_feasibility_acquisition, optimize_acquisition,
    pareto_mask,
)
from tum_control_tpu_torch.learn.bo.gp import fit_gp

SEED_RANGE = 2**31 - 1


@dataclasses.dataclass
class BOConfig:
    n_initial: int = 50
    n_bayesian_optimization: int = 400
    batch_size: int = 5
    epsilon: float = 0.8
    n_mc: int = 64
    reference_points: tuple = ((-0.5, -0.75), (-0.4, -0.90))
    bounds_lo: tuple = (1.0, 0.0, 1.0, 0.0, 20.0, 500.0, 500.0)
    bounds_hi: tuple = (30.0, 5.0, 30.0, 6.0, 400.0, 2000.0, 2000.0)


@dataclasses.dataclass
class Trial:
    params: np.ndarray       # (7,) in physical units
    objectives: np.ndarray   # (2, 2): per segment group
    feasible: np.ndarray     # (2,) bool per segment group
    group: int               # which group this trial was selected for


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class BayesianOptimizer:
    # fixed GP training-set sizes (subsample above, resample below), and a
    # fixed front size, as the JAX package keeps them
    M_FEAS = 1024
    M_OBJ = 512
    M_FRONT = 64

    def __init__(self, evaluators, cfg: BOConfig = BOConfig(), seed: int = 0, device=None,
                 dtype=torch.float64):
        """evaluators: one callable per segment group, params (C, 7) ->
        (objs (C, 2), feasible (C,)), e.g. ObjectiveEvaluator.evaluate on
        that group's SegmentBatch."""
        self.evaluators = evaluators
        self.cfg = cfg
        self.trials: List[Trial] = []
        self.rng = np.random.default_rng(seed)
        self.device, self.dtype = resolve_device(device), dtype
        self.d = len(cfg.bounds_lo)
        self.lo = np.asarray(cfg.bounds_lo)
        self.hi = np.asarray(cfg.bounds_hi)
        self._gp_warm = {}

    # ------------------------------------------------------------------
    def _denorm(self, Xn):
        return self.lo + Xn * (self.hi - self.lo)

    def _norm(self, X):
        return (X - self.lo) / (self.hi - self.lo)

    def _seed(self) -> int:
        return int(self.rng.integers(0, SEED_RANGE))

    def _evaluate(self, Xn: np.ndarray, group: int):
        params = self._denorm(Xn)
        objs_all = np.full((len(params), 2, 2), np.nan)
        feas_all = np.ones((len(params), max(len(self.evaluators), 2)), dtype=bool)
        for g, ev in enumerate(self.evaluators):
            objs, feas = ev(params)
            objs_all[:, g, :] = _np(objs)
            feas_all[:, g] = _np(feas)
        for i in range(len(params)):
            self.trials.append(Trial(params=np.asarray(params[i]), objectives=objs_all[i],
                                     feasible=feas_all[i], group=group))

    # ------------------------------------------------------------------
    def generate_initial_data(self, n: Optional[int] = None):
        sob = qmc.Sobol(self.d, scramble=True, seed=self._seed())
        with warnings.catch_warnings():
            # n_initial = 50 is no power of 2 (bo_config.yaml:11)
            warnings.filterwarnings("ignore", message=".*balance properties of Sobol.*")
            pts = sob.random(n or self.cfg.n_initial)
        self._evaluate(pts, group=0)

    def _train_data(self, group: int):
        X, Y, F = [], [], []
        for t in self.trials:
            X.append(self._norm(t.params))
            ok = bool(np.asarray(t.feasible)[group])
            F.append(1.0 if ok else -1.0)
            Y.append(t.objectives[group] if ok else [np.nan, np.nan])
        return np.asarray(X), np.asarray(Y), np.asarray(F)

    def _fixed_size(self, X, y, M):
        n = len(X)
        if n >= M:
            idx = self.rng.choice(n, size=M, replace=False)
        else:
            idx = np.concatenate([np.arange(n), self.rng.choice(n, size=M - n)])
        return X[idx], y[idx]

    def _fit(self, tag, X, y):
        """A GP fit, warm-started (60 steps) from the same tag's last fit."""
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        prev = self._gp_warm.get(tag)
        gp = fit_gp(t(X), t(y), n_steps=300 if prev is None else 60,
                    init=None if prev is None else prev.params)
        self._gp_warm[tag] = gp
        return gp

    def step(self, iteration: int):
        """One BO iteration on the alternating segment group. With no
        feasible trial yet the acquisition is pure feasibility seeking."""
        group = iteration % len(self.evaluators)
        X, Y, F = self._train_data(group)
        feas = ~np.isnan(Y[:, 0])
        feas_gp = self._fit(("feas", group), *self._fixed_size(X, F, self.M_FEAS))
        if feas.sum() < 1:
            acq = make_feasibility_acquisition(feas_gp)
        else:
            Xo, Yo = self._fixed_size(X[feas], Y[feas], self.M_OBJ)
            gps = [self._fit(("obj", group, j), Xo, Yo[:, j]) for j in range(2)]
            front = Y[feas][pareto_mask(Y[feas])]
            if len(front) > self.M_FRONT:  # thinned evenly along the sorted front
                order = np.argsort(-front[:, 0])
                front = front[order][np.linspace(0, len(front) - 1, self.M_FRONT).astype(int)]
            elif len(front) < self.M_FRONT:  # duplicates add no hypervolume
                front = front[np.concatenate([np.arange(len(front)),
                                              np.zeros(self.M_FRONT - len(front), dtype=int)])]
            ref = np.asarray(self.cfg.reference_points[group])
            acq = make_acquisition(gps, feas_gp, front, ref, self.cfg.epsilon, self._seed(),
                                   n_mc=self.cfg.n_mc)
        cand = optimize_acquisition(acq, self.d, self.cfg.batch_size, self._seed())
        self._evaluate(cand, group)

    # ------------------------------------------------------------------
    def hypervolume(self, group: int) -> float:
        _, Y, _ = self._train_data(group)
        Yf = Y[~np.isnan(Y[:, 0])]
        if len(Yf) == 0:
            return 0.0
        return hypervolume_2d(Yf[pareto_mask(Yf)], np.asarray(self.cfg.reference_points[group]))

    # ------------------------------------------------------------------
    def store_trials(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for t in self.trials:
                f = np.asarray(t.feasible).astype(int).reshape(-1)
                row = list(t.params) + list(t.objectives.reshape(-1)) + [int(f[0]), int(f[-1]),
                                                                         t.group]
                fh.write(",".join(str(v) for v in row) + "\n")

    def load_trials(self, path: str):
        skipped = 0
        with open(path) as fh:
            for line in fh:
                vals = line.strip().split(",")
                params = np.asarray([float(v) for v in vals[:7]])
                if not np.all(np.isfinite(params)):
                    skipped += 1
                    continue
                self.trials.append(Trial(
                    params=params,
                    objectives=np.asarray([float(v) for v in vals[7:11]]).reshape(2, 2),
                    feasible=np.asarray([bool(int(vals[11])), bool(int(vals[12]))]),
                    group=int(vals[13]),
                ))
        if skipped:
            print(f"load_trials: skipped {skipped} non-finite-parameter rows")
