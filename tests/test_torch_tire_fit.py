"""The port's tire fits (tum_control_tpu_torch/tools/fit_tires_closedloop.py,
fit_tires_es.py) against the JAX tools on the CPU in float64, and one tire
set per scenario against single runs.

The ACC24 goldens are not in the repository: a module fixture writes a
synthetic pair with the port (nominal and SNMPC at UPH 15, 16 steps from
the first corner, lap point 215, shifted 0.4 m to the left of the line,
with pacejka_params_2023fit.yaml on plant and controller) under a temporary
directory. The shift makes the goldens' |dev_lat| tenths of a metre: near
the line (hundredths) the ratio terms' cotangents, ~(ratio - 1) / mean
|dev_lat|, exceed 1 at once and the sanitizer scales every window. The JAX tools set
TUM_DIFFERENTIABLE=1 before importing their package, so they run unchanged
in child processes (tests/_torch_tire_fit_jax.py), started by the fixture
and read by the last tests, while this process runs the port. Their
compiles take ~30 s each on this CPU.

Tolerances: the closed-loop loss terms at theta0 (2 chunks x 8 steps, skip
3) within 1e-9 of JAX's, relative (the same float64 operations in another
order); the ES generation at pop 3 (fitness and ratios of every member)
within 1e-8, relative; P tire sets as one batch against P single runs
within 1e-10 of each output's max (the same arithmetic, batched). The port's
gradient is held to central differences of its own float64 loss along two
random directions, eps 1e-3, within 1e-5 of |g| (at a window where the
test shows that the sanitizer did not clip).
The JAX gradient of the fit (its main at --steps 1) compiles the reverse
sweep for minutes: that comparison (TOL_JAX_GRAD) is in the slow tier
(`-m slow`).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.eval.logger import assemble_logs, save_logs
from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import sim_ode
from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.params import TireParams, VehicleParams
from tum_control_tpu_torch.tools import fit_tires_closedloop, fit_tires_es, tire_fit

F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_tire_fit_jax.py")
CORNER, SHIFT, GOLDEN_STEPS = 215, 0.4, 16
FIT_TIRES = "EDGAR/pacejka_params_2023fit.yaml"
CL_ARGV = ["--n-chunks", "2", "--chunk-len", "8", "--skip", "3", "--steps", "1"]
ES_ARGV = ["--pop", "3", "--gens", "1"]
TOL_TERMS, TOL_ES, TOL_POP, TOL_FD = 1e-9, 1e-8, 1e-10, 1e-5
# the first gradient against JAX's, per component over max |g|: both float64
# through the same 2 x 8 closed-loop steps, whose rounding the loop's
# sensitivity amplifies (as test_torch_diffmode.py's gradient against JAX's)
TOL_JAX_GRAD = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxRun:
    """A JAX tool running in a child process; `result()` waits for it."""

    def __init__(self, tmp, name, spec):
        self.out = os.path.join(tmp, f"{name}.out.json")
        spec_path = os.path.join(tmp, f"{name}.spec.json")
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
        with open(spec_path, "w") as fh:
            json.dump(dict(spec, tmp=os.path.join(tmp, name)), fh)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen([sys.executable, HELPER, spec_path, self.out], env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result(self):
        log, _ = self.proc.communicate(timeout=600)
        assert self.proc.returncode == 0, log
        with open(self.out) as fh:
            return json.load(fh)


def _write_golden(path, mpc_cfg):
    """tire_fit.write_golden's log from lap point CORNER, SHIFT to the left."""
    T = GOLDEN_STEPS * 0.02
    sim_cfg = SimConfig(sim_mode=0, T=T, tire_params_file_MPC=FIT_TIRES,
                        tire_params_file_simulator=FIT_TIRES)
    sim, _, _, traj, _ = build_simulation(sim_cfg, mpc_cfg, device="cpu", dtype=F64)
    xm, xs = (x[CORNER:CORNER + 1].clone() for x in batched_scenarios(traj, traj.n_points))
    yaw = xm[0, 2]
    left = torch.stack([-torch.sin(yaw), torch.cos(yaw)]) * SHIFT
    xm[0, :2] += left
    xs[0, :2] += left
    _, log = sim.run(xm, xs, GOLDEN_STEPS)
    save_logs(assemble_logs(log, xm, xs, T, scenario=0), path)


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tire_fit"))
    torch.set_num_threads(1)
    paths = {}
    for name, cfg in (("nominal", MPCConfig()), ("snmpc", MPCConfig(**tire_fit.SNMPC))):
        paths[name] = os.path.join(tmp, name, "full_logs.npz")
        _write_golden(paths[name], cfg)
    spec = dict(golden=paths["nominal"], golden_snmpc=paths["snmpc"])
    jax_runs = {"es": _JaxRun(tmp, "es", dict(spec, tool="fit_tires_es", argv=ES_ARGV)),
                "cl": _JaxRun(tmp, "cl", dict(spec, tool="fit_tires_closedloop", argv=CL_ARGV,
                                              forward_only=True))}
    yield dict(tmp=tmp, argv=["--golden", paths["nominal"], "--golden-snmpc", paths["snmpc"],
                              "--device", "cpu"], jax=jax_runs)
    for run in jax_runs.values():
        run.proc.kill()
        run.proc.communicate()


def _out(goldens, name):
    return ["--out", os.path.join(goldens["tmp"], f"{name}.yaml"),
            "--log", os.path.join(goldens["tmp"], f"{name}.txt")]


def _problem(goldens, argv):
    args = fit_tires_closedloop.parse_args(goldens["argv"] + argv)
    return fit_tires_closedloop.FitProblem(args, torch.device("cpu"), F64)


# ---- the sanitizer ---------------------------------------------------------

def _cc_bwd(g):
    """The JAX tool's `_cc_bwd` on one chunk's float leaves (its body)."""
    gs, gt = g
    leaves = jax.tree_util.tree_leaves(gs)
    n2 = sum(jnp.sum(jnp.square(leaf)) for leaf in leaves)
    n2 = jnp.where(jnp.isfinite(n2), n2, jnp.inf)
    scale = jnp.minimum(1.0, 1.0 / jnp.sqrt(jnp.maximum(n2, 1e-30)))
    scale = jnp.where(jnp.isfinite(scale), scale, 0.0)
    clean = lambda leaf: jnp.nan_to_num(leaf, posinf=0.0, neginf=0.0) * scale
    gt = jnp.clip(jnp.nan_to_num(gt, posinf=0.0, neginf=0.0), -1e3, 1e3)
    return jax.tree.map(clean, gs), gt


@pytest.mark.parametrize("case", ["norm_above_one", "norm_below_one", "nonfinite"])
def test_sanitizer_is_the_jax_backward(case):
    """SanitizeCotangent's backward equals `_cc_bwd` vmapped over the chunks
    (the JAX tool's rollout is vmapped; theta's cotangent is unbatched)."""
    rng = np.random.default_rng(5)
    scale = {"norm_above_one": 3.0, "norm_below_one": 0.01, "nonfinite": 1.0}[case]
    gs = [rng.normal(0, scale, s) for s in ((3, 4), (3, 2, 5), (3,))]
    gt = rng.normal(0, 2e3, 8)
    if case == "nonfinite":
        gs[0][0, 1], gs[1][1, 0, 2], gs[2][2] = np.nan, np.inf, -np.inf
        gt[[1, 4]] = np.nan, -np.inf
    leaves = [torch.zeros(g.shape, dtype=F64, requires_grad=True) for g in gs]
    theta = torch.zeros(8, dtype=F64, requires_grad=True)
    stats = {"min_scale": torch.ones((), dtype=F64), "max_g_theta": torch.zeros((), dtype=F64)}
    outs = fit_tires_closedloop.SanitizeCotangent.apply(stats, theta, *leaves)
    got = torch.autograd.grad(outs, [theta, *leaves], [torch.tensor(gt)] + [torch.tensor(g)
                                                                           for g in gs])
    want_s, want_t = jax.vmap(_cc_bwd, in_axes=((0, None),), out_axes=(0, None))((gs, gt))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_t), rtol=1e-15, atol=0)
    for g, w in zip(got[1:], want_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, atol=1e-300)
    clipped = float(stats["min_scale"]) < 1.0
    assert clipped == (case != "norm_below_one")


# ---- one tire set per scenario -----------------------------------------------

def _sets(P, seed=0):
    rng = np.random.default_rng(seed)
    tp0 = tire_fit.shipped_tires()
    return np.exp(np.log(np.array(tp0[:8])) + rng.normal(0, 0.05, (P, 8))), tp0.mu


def test_population_batch_equals_single_runs():
    """P tire sets as one batch (per-scenario (P,) tires in the plant's RK4,
    the nominal and the SNMPC closed loop at UPH 15) equal P runs of one
    set each."""
    P = 3
    vals, mu = _sets(P)
    vp = VehicleParams()
    tpB = TireParams(*torch.tensor(vals.T).unbind(0), mu=mu)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(0, 0.1, (P, 7)) + [0, 0, 0.3, 12, 0, 0, 0])
    u = torch.tensor(rng.normal(0, 0.5, (P, 2)))
    f = lambda tp: (lambda xx, uu: sim_ode(xx, uu, vp, tp))
    xB = rk4_multistep(f(tpB), x, u, 0.02, 4)
    for p in range(P):
        x1 = rk4_multistep(f(TireParams(*vals[p], mu=mu)), x[p:p + 1], u[p:p + 1], 0.02, 4)
        torch.testing.assert_close(xB[p:p + 1], x1, rtol=0, atol=TOL_POP * float(x1.abs().max()))
    for cfg in (MPCConfig(), MPCConfig(**tire_fit.SNMPC)):
        sim, x0m, x0s, _, _ = build_simulation(SimConfig(sim_mode=0), cfg, device="cpu",
                                               dtype=F64, tire_params=tpB)
        _, logB = sim.run(x0m[None].expand(P, -1), x0s[None].expand(P, -1), 3)
        for p in range(P):
            sim.set_tires(TireParams(*vals[p], mu=mu))
            _, log1 = sim.run(x0m[None], x0s[None], 3)
            for name in ("simU", "CiLX", "lat_dev"):
                a, b = getattr(logB, name)[p:p + 1], getattr(log1, name)
                torch.testing.assert_close(a, b, rtol=0, atol=TOL_POP * float(b.abs().max()),
                                           msg=f"{cfg.controller} {name} member {p}")


def test_set_tires_reads_no_tire_value(monkeypatch):
    """K1's parameter block and tire table from tire tensors take no value
    back to the host (on the card that waits for it): no tensor is turned
    into a Python number while the wrapper is built or its tires replaced."""
    vals, mu = _sets(4)
    vp = VehicleParams()
    tp = TireParams(*torch.tensor(vals.T).unbind(0), mu=mu)
    read = []
    for name in ("__float__", "item", "tolist", "__bool__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name: read.append(_n) or _r(self, *a))
    lin = LinearizeRollout(vp, tp, 0.08, 3)
    lin.set_tires(TireParams(*(v * 1.01 for v in tp[:8]), mu=mu))
    assert read == [], read
    monkeypatch.undo()
    assert lin.table.shape == (4, 12)
    np.testing.assert_allclose(lin.table[:, :8].numpy(), vals * 1.01, rtol=1e-15)
    assert all(np.isnan(list(lin.prm)[14:22]))


# ---- the closed-loop fit -------------------------------------------------------

def test_gradient_matches_central_differences(goldens):
    """The fit's float64 gradient through the checkpointed, sanitized loop
    equals central differences of its loss, at a window where the sanitizer
    scaled no cotangent (its smallest scale is 1) and clamped no theta
    component."""
    prob = _problem(goldens, ["--n-chunks", "1", "--chunk-len", "3", "--skip", "1"])
    theta0 = prob.theta0
    loss, aux, g = prob.value_and_grad(theta0)
    assert float(prob.stats["min_scale"]) == 1.0
    assert float(prob.stats["max_g_theta"]) < 1e3
    assert float(aux[4]) == 1.0 and float(aux[5]) == 1.0
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    rng = np.random.default_rng(2)
    eps = 1e-3
    with torch.no_grad():
        for _ in range(2):
            d = torch.tensor(rng.normal(0, 1, 8))
            d /= torch.linalg.norm(d)
            fd = (prob.loss(theta0 + eps * d)[0] - prob.loss(theta0 - eps * d)[0]) / (2 * eps)
            assert abs(float(fd) - float(g @ d)) <= TOL_FD * float(torch.linalg.norm(g)), \
                (float(fd), float(g @ d))


def test_closed_loop_terms_match_jax(goldens):
    """The loss and its terms at theta0 (both ratios, traces, solver-ok) equal
    the JAX tool's forward (its main at --steps 1, gradient replaced by 0)."""
    prob = _problem(goldens, CL_ARGV)
    with torch.no_grad():
        loss, aux = prob.loss(prob.theta0)
    got = [float(loss)] + [float(a) for a in aux]
    want = goldens["jax"]["cl"].result()["calls"][0][:7]
    for name, a, b in zip(["loss", "rn", "rs", "tn", "ts", "okn", "oks"], got, want):
        assert abs(a - b) <= TOL_TERMS * abs(b), (name, a, b)


def test_closed_loop_main_writes_its_files(goldens, capsys):
    """Two iterations of the entry point: the JAX tool's lines, the log and
    the YAML under the given paths, theta moved by Adam from theta0."""
    argv = goldens["argv"] + _out(goldens, "cl") + ["--n-chunks", "1", "--chunk-len", "2",
                                                   "--skip", "1", "--steps", "2"]
    res = fit_tires_closedloop.main(argv, dtype=F64)
    out = capsys.readouterr().out
    assert out.count("it ") == 2 and "best gate (max |ratio-1|)" in out
    assert len(res["iterations"]) == 2 and all(np.isfinite(r["loss"]) for r in res["iterations"])
    with open(os.path.join(goldens["tmp"], "cl.txt")) as fh:
        assert fh.read().count("it ") == 2
    vals = tire_fit.read_tire_values(res["out"])
    assert np.isfinite(vals).all()


# ---- the evolution strategy ----------------------------------------------------

def test_es_generation_matches_jax(goldens):
    """One generation at pop 3: every member's fitness and ratios (and the
    maxima and solver-ok) equal the JAX tool's eval_pop, the candidates
    drawn from the same numpy generator; the best member and the YAML
    follow."""
    res = fit_tires_es.main(goldens["argv"] + _out(goldens, "es") + ES_ARGV, dtype=F64)
    gen = res["generations"][0]
    jx = goldens["jax"]["es"].result()
    want = dict(zip(["fit", "rn", "rs", "xn", "xs", "okn", "oks"],
                    (np.asarray(a) for a in jx["calls"][0])))
    for name, w in want.items():
        np.testing.assert_allclose(gen[name], w, rtol=TOL_ES, atol=0, err_msg=name)
    assert gen["best"] == int(np.argmin(want["fit"]))
    assert f"best_fit {gen['fit'][gen['best']]:.5f}" in jx["stdout"]
    assert tire_fit.read_tire_values(res["out"]).shape == (8,)


@pytest.mark.parametrize("tool", ["fit_tires_closedloop", "fit_tires_es"])
def test_missing_golden_is_named(tool, tmp_path):
    mod = {"fit_tires_closedloop": fit_tires_closedloop, "fit_tires_es": fit_tires_es}[tool]
    missing = str(tmp_path / "none" / "full_logs.npz")
    with pytest.raises(FileNotFoundError, match=missing):
        mod.main(["--golden", missing, "--device", "cpu", "--out", str(tmp_path / "o.yaml"),
                  "--log", str(tmp_path / "o.txt")], dtype=F64)


@pytest.mark.slow
def test_closed_loop_gradient_matches_jax(goldens, tmp_path):
    """The first gradient of the fit against the JAX tool's (its main at
    --steps 1, jax.value_and_grad through the checkpointed scan; minutes of
    compile)."""
    spec = dict(golden=goldens["argv"][1], golden_snmpc=goldens["argv"][3],
                tool="fit_tires_closedloop", argv=CL_ARGV)
    run = _JaxRun(str(tmp_path), "grad", spec)
    prob = _problem(goldens, CL_ARGV)
    loss, aux, g = prob.value_and_grad(prob.theta0)
    want = np.asarray(run.result()["calls"][0][7])
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=TOL_JAX_GRAD * np.abs(want).max())
