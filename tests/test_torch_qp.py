"""Parity of the port's soft-QP pieces, interior-point solver and RTI engine
with the JAX package, on the CPU in float64.

The IPM runs a fixed number of Mehrotra iterations and the polish a fixed
bisection count, so both packages take the same path through the same
arithmetic; results agree to ~1e-9 relative (the normal matrices reach
cond ~1e8 through the hard rows' 1e7 penalty), hence rtol 1e-7.
"""
import numpy as np
import pytest
import torch

import jax

from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.ops import ipm as jipm
from tum_control_tpu.ops import soft_qp as jqp
from tum_control_tpu.ops.rti import RTIState as JRTIState
from tum_control_tpu_torch import convert
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.ops import ipm as tipm
from tum_control_tpu_torch.ops import soft_qp as tqp
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track.planner import planner_emulator

from test_ipm_fused import _random_problem

T = lambda a: torch.tensor(np.asarray(a))
RTOL, ATOL = 1e-7, 1e-9


def _qp(B, nz, ncg, seed):
    return jqp.CondensedQP(*(np.asarray(f, np.float64) for f in _random_problem(B, nz, ncg, seed)))


def _assert_close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def test_con_products_and_polish():
    B, nz, ncg = 6, 10, 7
    qj = _qp(B, nz, ncg, seed=20)
    qt = tqp.CondensedQP(*map(T, qj))
    rng = np.random.default_rng(21)
    w = rng.standard_normal((B, nz))
    y = rng.standard_normal((B, ncg + nz))
    _assert_close(tqp.con_mul(qt, T(w), nz), jax.vmap(lambda q, a: jqp.con_mul(q, a, nz))(qj, w))
    _assert_close(tqp.con_tmul(qt, T(y), nz), jax.vmap(lambda q, a: jqp.con_tmul(q, a, nz))(qj, y))
    _assert_close(tqp.con_normal(qt, T(np.abs(y)), nz),
                  jax.vmap(lambda q, a: jqp.con_normal(q, a, nz))(qj, np.abs(y)))
    # two semismooth steps from a random point: a third can flip a row's
    # active side on the ~1e-9 direction differences (cond ~1e7 factors)
    # and then legitimately land elsewhere
    w_t, kkt_t = tqp.newton_polish(qt, T(w), n_iters=2, n_id=nz)
    w_j, kkt_j = jax.vmap(lambda q, a: jqp.newton_polish(q, a, n_iters=2, n_id=nz))(qj, w)
    _assert_close(w_t, w_j, atol=1e-7, msg="w")
    # the line search can land a row exactly on its bound, where the KKT
    # residual jumps by z1: compare it at the port's own point
    kkt_at_t = jax.vmap(lambda q, a: jqp.newton_polish(q, a, n_iters=0, n_id=nz)[1])(
        qj, w_t.numpy())
    _assert_close(kkt_t, kkt_at_t, atol=1e-9, msg="kkt")


@pytest.mark.parametrize("warm", [False, True])
def test_solve_soft_qp_ipm(warm):
    B, nz, ncg = 8, 10, 7
    qj = _qp(B, nz, ncg, seed=22)
    qt = tqp.CondensedQP(*map(T, qj))
    kw = dict(n_iters=4, n_polish=1, want_stats=True)
    if warm:
        # warm values spanning the clip range [1e-3, 1e5] and beyond
        rng = np.random.default_rng(23)
        wv = [10.0 ** rng.uniform(-5, 6, (B, ncg + nz)) for _ in range(6)]
        out_j = jax.vmap(lambda q, *w: jipm.solve_soft_qp_ipm(
            q, warm=jipm.IPMWarm(*w), n_id=nz, **kw))(qj, *wv)
        out_t = tipm.solve_soft_qp_ipm(qt, warm=tipm.IPMWarm(*map(T, wv)), n_id=nz, **kw)
        for name, a, b in zip(tipm.IPMWarm._fields, out_t[2], out_j[2]):
            _assert_close(a, b, msg=name)
    else:
        out_j = jax.vmap(lambda q: jipm.solve_soft_qp_ipm(q, n_id=nz, **kw))(qj)
        out_t = tipm.solve_soft_qp_ipm(qt, n_id=nz, **kw)
    _assert_close(out_t[0], out_j[0], msg="w")
    _assert_close(out_t[1], out_j[1], atol=1e-7, msg="kkt")
    np.testing.assert_array_equal(out_t[-1].iters.numpy(), np.asarray(out_j[-1].iters))
    _assert_close(out_t[-1].gap, out_j[-1].gap, msg="gap")


def _engine_case(B=3, bad=None):
    """One RTI solve from the cold start at curvature-consistent states,
    with the controls perturbed; `bad` = index of a scenario whose iterate
    is poisoned with NaN (the status-3 guard)."""
    jctrl = j_build_controller(JMPC(), JSim())
    sim, _, _, traj, _ = build_simulation(SimConfig(), MPCConfig(), device="cpu",
                                          dtype=torch.float64)
    tctrl = sim.controller
    x0, _ = batched_scenarios(traj, B, dtype=torch.float64)
    rng = np.random.default_rng(24)
    st = tctrl.init_state(x0)
    U = rng.normal(0, 0.3, st.U.shape)
    X = st.X.numpy().copy()
    if bad is not None:
        X[bad, 5, 4] = np.nan
    warm = {k: 10.0 ** rng.uniform(-2, 2, st.warm.su.shape) for k in tipm.IPMWarm._fields}
    state_np = dict(X=X, U=U, warm=warm)
    _, win = planner_emulator(traj, x0[:, :2], 3.04, 39)
    yref, yref_e = tctrl.make_yref(win)
    x0m = x0.numpy() + rng.normal(0, 0.05, x0.shape)

    t_out = tctrl.engine.solve_full(convert.rti_state(state_np, device="cpu", dtype=torch.float64),
                                    T(x0m), yref, yref_e)
    jstate = JRTIState(X=X, U=U, warm=jipm.IPMWarm(*(warm[k] for k in tipm.IPMWarm._fields)))
    j_out = jax.jit(jax.vmap(jctrl.engine.solve_full))(jstate, x0m, yref.numpy(), yref_e.numpy())
    return t_out, j_out


def test_rti_solve_full_matches():
    (u0, st, stats, A), (u0j, stj, statsj, Aj) = _engine_case()
    _assert_close(A, Aj, rtol=1e-12, atol=1e-12, msg="A_lin")
    _assert_close(u0, u0j, msg="u0")
    _assert_close(st.X, stj.X, msg="X")
    _assert_close(st.U, stj.U, msg="U")
    for name, a, b in zip(tipm.IPMWarm._fields, st.warm, stj.warm):
        _assert_close(a, b, rtol=1e-6, atol=1e-8, msg=name)
    for f in ("cost", "kkt_res", "gap"):
        _assert_close(getattr(stats, f), getattr(statsj, f), atol=1e-6, msg=f)
    for f in ("sqp_iter", "qp_iter", "status"):
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(statsj, f)))
    assert (stats.status == 0).all()


def test_rti_status3_guard_per_scenario():
    """A NaN iterate fails only its own scenario: status 3 there, its
    previous iterate kept, the other scenarios solved as usual."""
    (u0, st, stats, _), (u0j, stj, statsj, _) = _engine_case(bad=1)
    np.testing.assert_array_equal(stats.status.numpy(), [0, 3, 0])
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(statsj.status))
    ok = [0, 2]
    _assert_close(st.X[ok], np.asarray(stj.X)[ok], msg="X")
    _assert_close(u0[ok], np.asarray(u0j)[ok], msg="u0")
    assert torch.isnan(st.X[1, 5, 4]) and np.isnan(np.asarray(stj.X)[1, 5, 4])
    np.testing.assert_array_equal(st.U[1].numpy(), np.asarray(stj.U)[1])
