"""The port's Bayesian optimisation of the cost weights against the JAX
package on the CPU in float64: segmentation, the GP (kernel, marginal
likelihood and its gradient, a 50-step fit, the posterior, joint samples on
injected normals and the independent-sample branch), the Pareto mask,
hypervolume and the feasibility-weighted MC-EHVI on fixed draws, the
closed-loop objective (2 candidates x 2 segments, 30 steps, with the NaN
pattern of an infeasible candidate), the postprocessing and its CSV, the
optimizer's step on a stub objective, and the BO entry module.

The JAX package's random draws cannot be reproduced in torch: the tests
compute JAX's normals from its keys and inject them. Tolerances: 1e-12
relative for single evaluations, 1e-9 for the 50-step fit and the EHVI
gradient, 1e-9 for the 30-step closed-loop objectives (measured: <= 1e-13).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.learn.bo import acquisition as jacq, gp as jgp, postprocess as jpost
from tum_control_tpu.learn.bo.objective import (
    ObjectiveEvaluator as JObjectiveEvaluator, make_segment_batch as j_make_segment_batch,
)
from tum_control_tpu.learn.bo.optimizer import BayesianOptimizer as JBayesianOptimizer
from tum_control_tpu.learn.bo.segmentation import get_train_segments as j_get_train_segments
from tum_control_tpu.learn.bo.segmentation import hysteresis as j_hysteresis
from tum_control_tpu.learn.wmpc import load_param_table as j_load_param_table
from tum_control_tpu.track.trajectory import (
    load_ref_trajectory as j_load, stack_trajectories as j_stack,
)
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH, MPCConfig, SimConfig
from tum_control_tpu_torch.learn.bo import acquisition, gp, postprocess
from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator, make_segment_batch
from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig, Trial
from tum_control_tpu_torch.learn.bo.segmentation import get_train_segments, hysteresis
from tum_control_tpu_torch.learn.wmpc import load_param_table
from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, rtol, what=""):
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.nanmax(np.abs(b))) if np.isfinite(b).any() else 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale, err_msg=what)


def _data(seed, n=20, d=7):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 0.5 * X[:, 2] + 0.05 * rng.normal(size=n)
    return X, y


def _params(rng, d=7):
    return (rng.normal(-0.5, 0.3, d), rng.normal(0.2, 0.3), rng.normal(-3.0, 0.5))


def test_segmentation_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 2e-3, 500)
    np.testing.assert_array_equal(hysteresis(x, 2e-5, 1e-3), j_hysteresis(x, 2e-5, 1e-3))
    tracks = ("modena", "monteblanco")
    assert get_train_segments(tracks=tracks) == j_get_train_segments(tracks=tracks)
    assert [len(g) for g in get_train_segments(tracks=tracks)] == [10, 10]


def test_gp_kernel_mll_and_gradient_match_jax():
    X, y = _data(0)
    ls, os_, nz = _params(np.random.default_rng(1))
    pj = jgp.GPParams(jnp.asarray(ls), jnp.asarray(os_), jnp.asarray(nz))
    pt = gp.GPParams(_t(ls).requires_grad_(), _t(os_).requires_grad_(), _t(nz).requires_grad_())
    _close(gp._kernel(pt, _t(X[:5]), _t(X)), jgp._kernel(pj, jnp.asarray(X[:5]), jnp.asarray(X)),
           1e-12, "kernel")
    _close(gp._K_train(pt, _t(X)), jgp._K_train(pj, jnp.asarray(X)), 1e-12, "K_train")
    m_j, g_j = jax.value_and_grad(jgp._mll)(pj, jnp.asarray(X), jnp.asarray(y))
    m_t = gp._mll(pt, _t(X), _t(y))
    g_t = torch.autograd.grad(m_t, list(pt))
    _close(m_t, m_j, 1e-12, "mll")
    for a, b, name in zip(g_t, g_j, pj._fields):
        _close(a, b, 1e-10, name)


def test_gp_fit_posterior_and_samples_match_jax():
    X, y = _data(2)
    Xq = np.random.default_rng(3).uniform(0, 1, (6, 7))
    gj = jgp._fit_gp(jnp.asarray(X), jnp.asarray(y), 50, 0.05)
    gt = gp.fit_gp(_t(X), _t(y), n_steps=50, lr=0.05)
    for f in gj.params._fields:
        _close(getattr(gt.params, f), getattr(gj.params, f), 1e-9, f)
    for f in ("y", "y_mean", "y_std", "L", "alpha"):
        _close(getattr(gt, f), getattr(gj, f), 1e-9, f)
    for a, b in zip(gp.gp_posterior(gt, _t(Xq)), jgp.gp_posterior(gj, jnp.asarray(Xq))):
        _close(a, b, 1e-9, "posterior")
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (16, 6)))
    _close(gp.gp_sample(gt, _t(Xq), _t(eps)), jgp.gp_sample(gj, jnp.asarray(Xq), key, 16), 1e-9,
           "joint samples")
    # a factor that is not the training covariance's makes the posterior
    # covariance indefinite: both fall back to independent samples
    bad_j = gj._replace(L=0.01 * jnp.eye(len(X)))
    bad_t = gt._replace(L=0.01 * torch.eye(len(X), dtype=T64))
    s_j = jgp.gp_sample(bad_j, jnp.asarray(Xq), key, 16)
    s_t = gp.gp_sample(bad_t, _t(Xq), _t(eps))
    Kq = gp._kernel(bad_t.params, _t(Xq), bad_t.X)
    v = torch.linalg.solve_triangular(bad_t.L, Kq.T, upper=False)
    cov = gp._kernel(bad_t.params, _t(Xq), _t(Xq)) - v.T @ v
    assert not bool(torch.isfinite(gp.cholesky(cov)).all())
    assert np.all(np.isfinite(_np(s_t)))
    _close(s_t, s_j, 1e-9, "independent samples")


def test_gp_fit_skips_non_finite_steps():
    """With a NaN target every step's loss is NaN: both packages keep the
    initial hyperparameters, the port also its optimizer count."""
    X, y = _data(5)
    y[3] = np.nan
    gj = jgp._fit_gp(jnp.asarray(X), jnp.asarray(y), 20, 0.05)
    gt = gp.fit_gp(_t(X), _t(y), n_steps=20)
    for f in gj.params._fields:
        _close(getattr(gt.params, f), getattr(gj.params, f), 0.0, f)
    np.testing.assert_array_equal(_np(gt.params.log_lengthscales), np.full(7, -0.5))


def test_pareto_mask_and_hypervolume_match_jax():
    rng = np.random.default_rng(6)
    Y = -rng.uniform(0, 1, (60, 2))
    Y[10] = Y[11]   # a duplicate
    np.testing.assert_array_equal(acquisition.pareto_mask(Y), jacq.pareto_mask(Y))
    front = Y[acquisition.pareto_mask(Y)]
    ref = np.array([-0.9, -0.95])
    assert acquisition.hypervolume_2d(front, ref) == jacq.hypervolume_2d(front, ref) > 0
    f_c = -rng.uniform(0, 1, (9, 2))
    fs = front[np.argsort(-front[:, 0])]
    hv_j = jax.vmap(lambda p: jacq._hvi_candidate(p, jnp.asarray(fs), jnp.asarray(ref)))(
        jnp.asarray(f_c))
    _close(acquisition._hvi_candidate(_t(f_c), _t(fs), _t(ref)), hv_j, 1e-14, "hvi")


def test_ehvi_on_fixed_draws_matches_jax():
    """The feasibility-weighted MC-EHVI and its gradient at 8 points, with
    the MC normals JAX draws from its keys injected into the port."""
    X, y = _data(7, n=24)
    y1 = np.cos(2 * X[:, 3]) - X[:, 4]
    feas = np.where(X[:, 0] + X[:, 5] < 1.1, 1.0, -1.0)
    fits = [(jgp._fit_gp(jnp.asarray(X), jnp.asarray(v), 30, 0.05),
             gp.fit_gp(_t(X), _t(v), n_steps=30)) for v in (y, y1, feas)]
    (gj0, gt0), (gj1, gt1), (gjf, gtf) = fits
    front = np.stack([np.sort(y)[-6:], np.sort(y1)[:6]], axis=1)
    front = front[np.argsort(-front[:, 0])]
    ref = np.array([y.min() - 0.5, y1.min() - 0.5])
    keys = jax.random.split(jax.random.PRNGKey(8), 2)
    ap = jacq.AcqP(gj0, gj1, gjf, jnp.asarray(front), jnp.asarray(ref), keys, jnp.asarray(0.8))
    n_mc = 32
    draws = lambda m: _t(np.stack([np.asarray(jax.random.normal(k, (n_mc, m))) for k in keys]))
    acq = acquisition.make_acquisition([gt0, gt1], gtf, front, ref, 0.8, seed=0, n_mc=n_mc,
                                       draws=draws)
    Xq = np.random.default_rng(9).uniform(0, 1, (8, 7))
    v_j, g_j = jax.value_and_grad(lambda Z: jnp.sum(jacq._acq_value_ehvi(ap, Z, n_mc)))(
        jnp.asarray(Xq))
    Z = _t(Xq).requires_grad_()
    v_t = acq(Z)
    (g_t,) = torch.autograd.grad(v_t.sum(), Z)
    _close(v_t, jacq._acq_value_ehvi(ap, jnp.asarray(Xq), n_mc), 1e-9, "ehvi")
    assert float(v_t.sum()) > 0 and abs(float(v_t.sum()) - float(v_j)) < 1e-9
    _close(g_t, g_j, 1e-9, "ehvi gradient")
    feas_t = acquisition.make_feasibility_acquisition(gtf)(_t(Xq))
    _close(feas_t, jacq._acq_value_feas(gjf, jnp.asarray(Xq)), 1e-9, "feasibility acquisition")
    # the default draws are common random numbers: one acquisition, one value
    acq0 = acquisition.make_acquisition([gt0, gt1], gtf, front, ref, 0.8, seed=5, n_mc=n_mc)
    torch.testing.assert_close(acq0(_t(Xq)), acq0(_t(Xq)), rtol=0, atol=0)


def test_optimize_acquisition_selects_distinct_finite_candidates():
    X, y = _data(10, n=24)
    g = gp.fit_gp(_t(X), _t(y), n_steps=30)
    acq = acquisition.make_feasibility_acquisition(g)
    cand = acquisition.optimize_acquisition(acq, 7, 5, seed=11, n_raw=64, n_polish=10)
    assert cand.shape == (5, 7) and np.all(np.isfinite(cand))
    assert np.all((cand >= 0) & (cand <= 1))
    d = np.linalg.norm(cand[:, None] - cand[None], axis=-1) + np.eye(5)
    assert d.min() > 0.02
    again = acquisition.optimize_acquisition(acq, 7, 5, seed=11, n_raw=64, n_polish=10)
    np.testing.assert_array_equal(cand, again)


def test_objective_matches_jax():
    """2 candidates (one that crashes within 30 steps) x 2 segments (one
    that ends within them) on the two laps."""
    tracks = ["modena", "monteblanco"]
    path = lambda t: os.path.join(DEFAULT_TRAJECTORY_PATH, f"reftraj_{t}_edgar.json")
    segs = [dict(trajectory="modena", start=45, end=236),
            dict(trajectory="monteblanco", start=600, end=608)]
    P = np.array([[10, 2, 10, 2, 200, 1000, 1000], [30, 0, 30, 0, 20, 500, 500]], float)
    jsim, *_ = j_build_simulation(JSim(sim_mode=0), JMPC())
    jev = JObjectiveEvaluator(jsim, j_stack([j_load(path(t)) for t in tracks]), max_steps=30)
    f_j, feas_j = jev.evaluate(jnp.asarray(P), j_make_segment_batch(segs, tracks))
    tsim, *_ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu", dtype=T64)
    tstack = stack_trajectories([load_ref_trajectory(path(t), dtype=T64, device="cpu")
                                 for t in tracks])
    tev = ObjectiveEvaluator(tsim, tstack, max_steps=30)
    f_t, feas_t = tev.evaluate(P, make_segment_batch(segs, tracks, "cpu"))
    np.testing.assert_array_equal(_np(feas_t), _np(feas_j))
    assert _np(feas_t).tolist() == [True, False]
    np.testing.assert_array_equal(np.isnan(_np(f_t)), np.isnan(_np(f_j)))
    _close(np.nan_to_num(_np(f_t)), np.nan_to_num(_np(f_j)), 1e-9, "objectives")


def _trials(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(Trial(params=rng.uniform(0.5, 5.0, 7), objectives=rng.uniform(-1, 0, (2, 2)),
                         feasible=np.array([i % 3 != 0, i % 4 != 0]), group=i % 2))
    return out


def test_postprocess_matches_jax_and_csv_reads_in_both(tmp_path):
    trials = _trials(0)
    for g in (0, 1):
        for a, b in zip(postprocess.extract_pareto(trials, g, max_lat=0.9),
                        jpost.extract_pareto(trials, g, max_lat=0.9)):
            np.testing.assert_array_equal(a, b)
    # well-separated clusters: the port's k-means and scikit-learn's keep
    # the same points
    rng = np.random.default_rng(1)
    centers = np.array([[-0.1, -0.9], [-0.4, -0.5], [-0.8, -0.2], [-0.6, -0.7]])
    Y = np.concatenate([c + rng.normal(0, 0.01, (8, 2)) for c in centers])
    X = rng.uniform(0, 1, (len(Y), 7))
    for a, b in zip(postprocess.reduce_points(X, Y, 4), jpost.reduce_points(X, Y, 4)):
        np.testing.assert_array_equal(a, b)
    out = tmp_path / "F_port.csv"
    table = postprocess.export_parameter_sets(trials, str(out), n_per_group=3,
                                              per_group_files=True)
    assert (tmp_path / "F_port_0.csv").exists() and (tmp_path / "F_port_1.csv").exists()
    np.testing.assert_array_equal(load_param_table(str(out)), j_load_param_table(str(out)))
    assert load_param_table(str(out)).shape == (len(table), 7)
    np.testing.assert_allclose(load_param_table(str(out)), table, rtol=1e-3)


def _stub_evaluators():
    """A synthetic two-group objective (~30 % feasible under Sobol
    sampling), as the JAX package's BO test uses."""
    lo, hi = np.asarray(BOConfig().bounds_lo), np.asarray(BOConfig().bounds_hi)
    center = lo + 0.4 * (hi - lo)

    def make(shift):
        def ev(params):
            z = (np.asarray(params) - center) / (hi - lo)
            feas = np.linalg.norm(z, axis=1) < 0.78
            objs = np.stack([-np.abs(z[:, 0] + shift) - 0.3, -np.abs(z[:, 1]) - 0.4], axis=1)
            return torch.tensor(np.where(feas[:, None], objs, np.nan)), torch.tensor(feas)
        return ev

    return [make(0.0), make(0.1)]


def test_optimizer_step_with_stub_objective(tmp_path):
    """Initial Sobol data, then one step per group (the second with no
    feasible trial in the group: the feasibility-seeking acquisition); the
    fixed training-set sizes are cut to 64 / 32 here to keep the CPU fits
    short. Trials persist in the CSV layout both packages read."""
    cfg = BOConfig(n_initial=12, batch_size=3, n_mc=8)
    evs = _stub_evaluators()
    infeasible = lambda p: (torch.full((len(p), 2), float("nan"), dtype=T64),
                            torch.zeros(len(p), dtype=torch.bool))
    bo = BayesianOptimizer([evs[0], infeasible], cfg, seed=0, device="cpu")
    bo.M_FEAS, bo.M_OBJ = 64, 32
    bo.generate_initial_data()
    assert len(bo.trials) == 12
    assert any(bool(t.feasible[0]) for t in bo.trials)
    hv0 = bo.hypervolume(0)
    bo.step(0)
    bo.step(1)
    assert len(bo.trials) == 12 + 2 * 3
    P = np.stack([t.params for t in bo.trials])
    assert np.all(np.isfinite(P)) and np.all((P >= bo.lo - 1e-9) & (P <= bo.hi + 1e-9))
    assert [t.group for t in bo.trials[12:]] == [0, 0, 0, 1, 1, 1]
    assert bo.hypervolume(0) >= hv0 and bo.hypervolume(1) == 0.0
    path = str(tmp_path / "trials.csv")
    bo.store_trials(path)
    again = BayesianOptimizer(_stub_evaluators(), cfg, device="cpu")
    again.load_trials(path)
    jbo = JBayesianOptimizer(_stub_evaluators(), cfg)
    jbo.load_trials(path)
    for a, b, c in zip(bo.trials, again.trials, jbo.trials):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.objectives, c.objectives)
        np.testing.assert_array_equal(a.feasible, c.feasible)


def test_bo_entry_module_smoke(tmp_path, monkeypatch):
    """`python -m tum_control_tpu_torch.bo_optimize --smoke --device cpu`
    to its end: the trials CSV and the `--export` table, read by both
    packages. On the CPU the smoke's 120-step rollouts and 1024 / 512-point
    GP fits take ~6 minutes, so this run cuts them to 10 steps and 64 / 32
    points; the sizes themselves are the chip run's (chip_smoke.py bo)."""
    from tum_control_tpu_torch import bo_optimize

    real = bo_optimize.ObjectiveEvaluator
    monkeypatch.setattr(bo_optimize, "ObjectiveEvaluator",
                        lambda *a, **k: real(*a, **{**k, "max_steps": 10}))
    monkeypatch.setattr(BayesianOptimizer, "M_FEAS", 64)
    monkeypatch.setattr(BayesianOptimizer, "M_OBJ", 32)
    out, export = tmp_path / "trials.csv", tmp_path / "F.csv"
    bo_optimize.main(["--smoke", "--device", "cpu", "--out", str(out), "--export", str(export)])
    rows = np.loadtxt(str(out), delimiter=",")
    assert rows.shape == (4 + 2 * 2, 14)
    table = load_param_table(str(export))
    np.testing.assert_array_equal(table, j_load_param_table(str(export)))
    assert table.ndim == 2 and table.shape[1] == 7
