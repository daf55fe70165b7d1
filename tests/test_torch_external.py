"""The port's EXTERNAL cost (ego-frame lon/lat residuals, Levenberg-Marquardt
damping) and the SQP mode (sqp_iters 2), options no other port test drives,
against the JAX package on the CPU in float64.

Closed loops: 40 steps of Monteblanco at batch 2 from two curvature-
consistent starts. The two packages run the same operations in float64, so
states, inputs and deviations are held to 1e-8 (measured: <= 3e-14), the
cost to 1e-8 relative, and iteration counts and statuses must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.ops.ipm import init_warm as j_init_warm
from tum_control_tpu.ops.rti import RTIState as JRTIState
from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.ops.ipm import init_warm
from tum_control_tpu_torch.ops.rti import RTIState
from tum_control_tpu_torch.parallel.mesh import batched_scenarios


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-8
FIELDS = ("MPC_SimX", "CiLX", "simU", "simREF", "lat_dev", "vel_dev")
# the options of this file; tests/test_torch_options.py holds the other
# option cases (combined_acc_limits 0 and 1) with `check_option_closed_loop`,
# in a file of its own so that the test workers share the compile time
OPTIONS = {
    "external": dict(costfunction_type="EXTERNAL"),
    "sqp_iters_2": dict(sqp_iters=2),
}


def _sims(mpc_kw):
    jsim, _, _, jtraj, _ = j_build_simulation(JSim(sim_mode=0), JMPC(**mpc_kw))
    tsim, _, _, ttraj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(**mpc_kw),
                                            device="cpu", dtype=torch.float64)
    return jsim, jtraj, tsim, ttraj


def check_option_closed_loop(mpc_kw):
    n = 40
    jsim, jtraj, tsim, ttraj = _sims(mpc_kw)
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    _, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=torch.float64)
    _, log_t = tsim.run(x0m, x0s, n)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(log_t, f).numpy(), np.asarray(getattr(log_j, f)),
                                   rtol=0, atol=ATOL, err_msg=f)
    dbg_t, dbg_j = log_t.simSolverDebug.numpy(), np.asarray(log_j.simSolverDebug)
    np.testing.assert_array_equal(dbg_t[..., 2:], dbg_j[..., 2:])  # sqp/qp iters, status
    np.testing.assert_allclose(dbg_t[..., 0], dbg_j[..., 0], rtol=1e-8)  # cost
    assert (dbg_t[..., 4] == 0).all()
    assert (dbg_t[..., 2] == mpc_kw.get("sqp_iters", 1)).all()


@pytest.mark.parametrize("option", list(OPTIONS))
def test_nominal_option_closed_loop_matches_jax(option):
    check_option_closed_loop(OPTIONS[option])


def test_external_qp_and_cost_match_jax():
    """One EXTERNAL QP assembly at a perturbed iterate: H0 (with the 0.1 I
    Levenberg-Marquardt term) and g0 against the JAX engine's `_build_qp`,
    the residual-form nonlinear cost against its `nonlinear_cost`; and the
    damping is exactly 0.1 I (the port's engine without it differs by that)."""
    jsim, jtraj, tsim, ttraj = _sims(OPTIONS["external"])
    jeng, teng = jsim.controller.engine, tsim.controller.engine
    rng = np.random.default_rng(3)
    x0m, _ = batched_scenarios(ttraj, 2, dtype=torch.float64)
    N = teng.N
    X = x0m.numpy()[:, None, :] + rng.normal(0, 1, (2, N + 1, 8)) * [0.5, 0.5, 0.05, 1, 0.1,
                                                                      0.05, 0.02, 0.5]
    U = rng.normal(0, 1, (2, N, 2)) * [1.0, 0.1]
    x0 = X[:, 0] + rng.normal(0, 0.01, (2, 8))
    yref = np.concatenate([X[:, :N, :4] + rng.normal(0, 0.3, (2, N, 4)), np.zeros((2, N, 2))],
                          axis=2)
    yref_e = X[:, N, :4] + rng.normal(0, 0.3, (2, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    state = RTIState(X=t(X), U=t(U), warm=init_warm(2, teng.nc_total, torch.float64, "cpu"))
    qp_t = teng._build_qp(state, t(x0), t(yref), t(yref_e))[0]
    cost_t = teng.nonlinear_cost(state, t(yref), t(yref_e))
    for b in range(2):
        js = JRTIState(X=jnp.asarray(X[b]), U=jnp.asarray(U[b]),
                       warm=j_init_warm(jeng.nc_total, dtype=jnp.float64))
        qp_j = jeng._build_qp(js, jnp.asarray(x0[b]), jnp.asarray(yref[b]),
                              jnp.asarray(yref_e[b]))[0]
        for f in ("H0", "g0", "G", "c0"):
            ref = np.asarray(getattr(qp_j, f))
            np.testing.assert_allclose(getattr(qp_t, f)[b].numpy(), ref, rtol=0,
                                       atol=1e-10 * max(1.0, np.abs(ref).max()), err_msg=f)
        c_j = float(jeng.nonlinear_cost(js, jnp.asarray(yref[b]), jnp.asarray(yref_e[b])))
        np.testing.assert_allclose(float(cost_t[b]), c_j, rtol=1e-12)
    teng.lm_reg = 0.0
    H0_plain = teng._build_qp(state, t(x0), t(yref), t(yref_e))[0].H0
    np.testing.assert_allclose((qp_t.H0 - H0_plain).numpy(),
                               np.broadcast_to(0.1 * np.eye(teng.nz), (2, teng.nz, teng.nz)),
                               rtol=0, atol=1e-12)
