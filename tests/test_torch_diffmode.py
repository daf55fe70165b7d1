"""Reverse mode through the port's closed loop (ops/diffmode.py) on the CPU
in float64: the kernel wrappers' backward, and autograd through the closed
loop with the tire parameters as tensors (theta, the 8 log-multipliers on
the shipped Pacejka values of tools/fit_tires_closedloop.py, tires in
plant and controller).

On the card each wrapper launches its kernel inside
`kernel_with_plain_vjp`, whose backward is the VJP of the plain version at
the saved inputs. Here there is no card, so `_fake_kernels` sends every
wrapper down that branch with a stand-in "kernel": the plain version run
without autograd from what the kernel receives (K1: its packed parameter
block, and its tire table for tensor-valued tires), counted as a launch. Gradients through that route equal the plain
route's to 1e-10 of max |g| (TOL_ROUTE: the same float64 operations,
recomputed).

The loss is mean |lat_dev| over 3 steps of the nominal loop at B = 2,
starting at lap point HOLD_LAP_POINT, the first corner: on the opening
straight the tire forces, and so the gradient, sit near the solver's
roundoff. Central differences at eps = 1e-3 agree with the autograd
gradient to ~1e-7 of max |g| (measured); their truncation error and the
loop's roundoff (~1e-13 in the loss, / eps) stay well below TOL_FD = 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import (
    DEFAULT_CONFIG_PATH, MPCConfig, SimConfig, load_tire_params, load_vehicle_params,
)
from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
from tum_control_tpu_torch.ops.kernels import build, chol, condense, ipm_iter, linearize
from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout, kernel_params
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.params import TireParams, scaled_tire_params

F64 = torch.float64
HOLD_LAP_POINT = 215
B, STEPS = 2, 3
EPS_FD, TOL_FD = 1e-3, 1e-5
TOL_ROUTE = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp0():
    return load_tire_params(DEFAULT_CONFIG_PATH, SimConfig().tire_params_file_MPC)


def _vp():
    return load_vehicle_params(DEFAULT_CONFIG_PATH, SimConfig().veh_params_file_MPC)


def _loss(tp):
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu",
                                          dtype=F64, tire_params=tp)
    xm, xs = batched_scenarios(traj, traj.n_points)
    p = HOLD_LAP_POINT
    _, log = sim.run(xm[p:p + B], xs[p:p + B], STEPS)
    assert (log.simSolverDebug[..., 4] == 0).all()
    return log.lat_dev.abs().mean()


def _counted(counter, fn):
    def run(*a):
        build.LAUNCHES[counter] += 1
        with torch.no_grad():
            return fn(*a)
    return run


def _fake_kernels(monkeypatch):
    """Every wrapper takes its CUDA branch on CPU tensors; each stand-in
    kernel is the plain version without autograd."""
    monkeypatch.setattr(build, "use_kernel", lambda *t: True)
    for mod, name, plain, counter in (
            (condense, "condense_cuda", condense.condense_ref, "condense"),
            (condense, "condense_from_cuda", condense.condense_from_ref, "condense_from"),
            (condense, "condense_mxu_cuda", condense.condense_mxu_ref, "condense_mxu"),
            (chol, "cholesky_cuda", chol.cholesky_ref, "cholesky"),
            (chol, "chol_solve_cuda", chol.chol_solve_ref, "chol_solve"),
            (chol, "cholesky_unblocked_cuda", chol.cholesky_unblocked_ref, "cholesky_unblocked"),
            (chol, "chol_solve_unblocked_cuda", chol.chol_solve_unblocked_ref,
             "chol_solve_unblocked"),
            (ipm_iter, "fused_iteration_cuda", ipm_iter.iteration_ref, "ipm_iteration")):
        monkeypatch.setattr(mod, name, _counted(counter, plain))
    vp, mu = _vp(), _tp0().mu

    def lin(XU, prm, n_sub, nx, tires=None):  # the tires and step size the kernel receives
        tp = TireParams(*(list(prm)[14:22] if tires is None else tires[0, :8]), mu=mu)
        step = linearize.make_step(vp, tp, list(prm)[26] * n_sub, n_sub)
        return linearize.linearize_ref(XU, step, nx)

    monkeypatch.setattr(linearize, "linearize_cuda", _counted("linearize", lin))
    build.reset_launches()


def test_closed_loop_gradient_through_the_kernel_route(monkeypatch):
    """The tire gradient with every kernel of the nominal path (K1-K5) in the
    forward and its plain VJP in the backward equals the plain route's."""
    theta = torch.zeros(8, dtype=F64, requires_grad=True)
    (g_plain,) = torch.autograd.grad(_loss(scaled_tire_params(_tp0(), theta)), theta)
    _fake_kernels(monkeypatch)
    (g,) = torch.autograd.grad(_loss(scaled_tire_params(_tp0(), theta)), theta)
    for name in ("linearize", "condense", "cholesky", "chol_solve", "ipm_iteration"):
        assert build.LAUNCHES[name] > 0, name
    scale = float(g_plain.abs().max())
    assert float((g - g_plain).abs().max()) <= TOL_ROUTE * scale, (g, g_plain)


def _spd(rng, b, n):
    A = rng.standard_normal((b, n, n + 4))
    return torch.tensor(A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n))


def _wrapper_case(name, rng):
    """(wrapper, inputs) of one kernel wrapper at a small shape."""
    bt, n, nx, nu = 3, 6, 8, 2
    r = lambda *s: torch.tensor(rng.standard_normal(s))
    L = torch.linalg.cholesky(_spd(rng, bt, 12))
    cases = {
        "condense": (condense.condense, (0.3 * r(bt, n, nx, nx), r(bt, n, nx, nu), r(bt, n, nx),
                                         r(bt, nx))),
        "condense_from": (lambda *a: condense.condense_from(*a, 4),
                          (0.3 * r(bt, n, nx, nx), r(bt, n, nx, nu), r(bt, n, nx), r(bt, nx),
                           r(bt, nx, 2 * n * nu))),
        "condense_mxu": (condense.condense_mxu, (0.3 * r(bt, n, nx, nx), r(bt, n, nx, nu),
                                                 r(bt, n, nx), r(bt, nx))),
        "cholesky": (chol.cholesky, (_spd(rng, bt, 12),)),
        "chol_solve": (chol.chol_solve, (L, r(bt, 12))),
        "cholesky_unblocked": (chol.cholesky_unblocked, (_spd(rng, bt, 12),)),
        "chol_solve_unblocked": (chol.chol_solve_unblocked, (L, r(bt, 12))),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["condense", "condense_from", "condense_mxu", "cholesky",
                                  "chol_solve", "cholesky_unblocked", "chol_solve_unblocked"])
def test_kernel_backward_is_the_plain_vjp(monkeypatch, name):
    """Each wrapper's kernel branch launches once and back-propagates the
    plain version's gradient in every input (a random cotangent)."""
    rng = np.random.default_rng(3)
    fn, ins = _wrapper_case(name, rng)
    ins = [t.requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = [torch.tensor(rng.standard_normal(tuple(o.shape))) for o in outs]
    want = torch.autograd.grad(outs, ins, cot)
    _fake_kernels(monkeypatch)
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    got = torch.autograd.grad(outs, ins, cot)
    assert build.LAUNCHES[name] == 1
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_ROUTE * float(w.abs().max()))


def test_non_float_outputs_carry_no_gradient():
    """A mask output (K4's `unconverged`) is marked non-differentiable; the
    float outputs differentiate through the plain version."""
    x = torch.tensor([1.0, -2.0, 3.0], dtype=F64, requires_grad=True)
    plain = lambda v: (v * v, v > 0)
    y, mask = kernel_with_plain_vjp(lambda v: tuple(t.detach() for t in plain(v)), plain, x)
    assert not mask.requires_grad and mask.tolist() == [True, False, True]
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.tolist() == [2.0, -4.0, 6.0]


def test_kernel_params_take_tire_values():
    """K1 takes the values of tire tensors under autograd without reading
    them on the host: its parameter block holds NaN in their slots (and in
    the constants derived from them), its one-row tire table the values and
    those constants, equal to the block of the same floats; every other
    slot is that block's, bit for bit."""
    vp, tp0 = _vp(), _tp0()
    theta = torch.zeros(8, dtype=F64, requires_grad=True)
    tt = scaled_tire_params(tp0, theta)
    a = list(kernel_params(vp, tt, 0.08, 3))
    b = list(kernel_params(vp, TireParams(*(float(v.detach()) for v in tt[:8]), mu=tp0.mu),
                           0.08, 3))
    tire_slots = list(range(14, 22)) + [12, 13, 24, 25]  # table order: Bf..Er, Fmax, 1 / Fmax
    assert len(a) == len(b) == 29
    assert all(np.isnan(a[i]) for i in tire_slots)
    assert [a[i] for i in range(29) if i not in tire_slots] == \
        [b[i] for i in range(29) if i not in tire_slots]
    lin = LinearizeRollout(vp, tt, 0.08, 3)
    assert lin.tires == tuple(tt[:8]) and lin.table.shape == (1, 12)
    np.testing.assert_allclose(lin.table[0].numpy(), [b[i] for i in tire_slots], rtol=1e-15)


def test_gradient_matches_finite_differences():
    theta = torch.zeros(8, dtype=F64, requires_grad=True)
    tp0 = _tp0()
    loss = _loss(scaled_tire_params(tp0, theta))
    (g,) = torch.autograd.grad(loss, theta)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    scale = float(g.abs().max())
    for i in (1, 5):  # Cf, Cr: the cornering stiffness shape factors
        e = torch.zeros(8, dtype=F64)
        e[i] = EPS_FD
        with torch.no_grad():
            fd = float(_loss(scaled_tire_params(tp0, e)) - _loss(scaled_tire_params(tp0, -e))) \
                / (2 * EPS_FD)
        assert abs(fd - float(g[i])) <= TOL_FD * scale, (i, fd, float(g[i]))


def test_tensor_tires_equal_float_tires():
    """The same tire values as 0-d tensors that require grad, in plant and
    controller, give the float-valued loop's loss (1e-12)."""
    tp0 = _tp0()
    tt = TireParams(*(torch.tensor(v, dtype=F64, requires_grad=True) for v in tp0[:8]),
                    mu=tp0.mu)
    a, b = float(_loss(tt).detach()), float(_loss(tp0))
    assert abs(a - b) <= 1e-12 * abs(b), (a, b)


JAX_GRAD = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from tum_control_tpu import config as cm
    from tum_control_tpu.api import build_simulation
    from tum_control_tpu.config import MPCConfig, SimConfig, load_gg_table, load_tire_params
    from tum_control_tpu.config import load_vehicle_params
    from tum_control_tpu.controllers.common import GGTables
    from tum_control_tpu.controllers.nominal import NominalNMPC
    from tum_control_tpu.ops.diffmode import DIFFERENTIABLE
    from tum_control_tpu.params import TireParams
    from tum_control_tpu.parallel.mesh import batched_scenarios
    from tum_control_tpu.sim.closed_loop import ClosedLoopSim
    assert DIFFERENTIABLE
    p, b, n = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    cfg = SimConfig(sim_mode=0)
    sim0, _, _, traj, _ = build_simulation(cfg, MPCConfig())
    vp = load_vehicle_params(cm.DEFAULT_CONFIG_PATH, cfg.veh_params_file_MPC)
    gg = GGTables(*load_gg_table(cm.DEFAULT_CONFIG_PATH, MPCConfig().lookuptable_gg_limits))
    tp0 = load_tire_params(cm.DEFAULT_CONFIG_PATH, cfg.tire_params_file_MPC)
    base = jnp.log(jnp.array(list(tp0)[:8]))
    xm, xs = batched_scenarios(traj, traj.n_points)
    xm, xs = xm[p:p + b], xs[p:p + b]

    def loss(theta):
        v = jnp.exp(base + theta)
        tp = TireParams(*v, mu=tp0.mu)
        ctrl = NominalNMPC(MPCConfig(), cfg.N, cfg.Ts_MPC, vp, tp, gg)
        sim = ClosedLoopSim(controller=ctrl, traj=traj, sim_mode=0, Ts=sim0.Ts, Tp=sim0.Tp,
                            N=sim0.N, vp_sim=sim0.vp_sim, tp_sim=tp,
                            dist_deriv=sim0.dist_deriv, dist_se=sim0.dist_se)
        _, log = jax.vmap(lambda a, c: sim.run(a, c, n))(xm, xs)
        return jnp.mean(jnp.abs(log.lat_dev))

    g = jax.jit(jax.grad(loss))(jnp.zeros(8))
    print("GRAD", " ".join(float(x).hex() for x in np.asarray(g)))
""")


@pytest.mark.slow
def test_gradient_matches_jax_grad():
    """jax.grad of the same loss in the JAX package's differentiable mode
    (a subprocess: JAX's flag is read at import; compiling JAX's gradient
    through the loop takes minutes, so this test is not in tier 1): the
    two gradients agree to 1e-6 of max |g| (the forward loops agree to
    ~1e-14 over a few steps; reverse mode through 30 IPM iterations
    amplifies that)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(TUM_DIFFERENTIABLE="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", JAX_GRAD, str(HOLD_LAP_POINT), str(B),
                          str(STEPS)], capture_output=True, text=True, env=env, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("GRAD ")]
    gj = np.array([float.fromhex(x) for x in line.split()[1:]])
    theta = torch.zeros(8, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_loss(scaled_tire_params(_tp0(), theta)), theta)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=1e-6 * np.abs(gj).max())
