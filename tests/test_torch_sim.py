"""The port's closed-loop simulator against the JAX package on the CPU in
float64: sim_mode 1, disturbance playback from a carry the JAX package
produced, and the per-scenario re-initialization after a failed solve.
Tolerances as in tests/test_torch_closed_loop.py (atol 1e-4 on states,
identical solver statuses).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu.config import SimConfig as JSim
from tum_control_tpu_torch import convert
from tum_control_tpu_torch.ops.ipm import IPMWarm
from tum_control_tpu_torch.parallel.mesh import batched_scenarios

from test_torch_closed_loop import _builds, _compare_logs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mode1_closed_loop_matches_jax():
    """sim_mode 1: the plant is the MPC's node-1 prediction, steps of 0.08 s."""
    n = 20
    jsim, jtraj, tsim, ttraj = _builds(sim_mode=1, T=n * 0.08)
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    _, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=torch.float64)
    _, log_t = tsim.run(x0m, x0s, n)
    _compare_logs(log_t, log_j)


def test_disturbed_playback_from_jax_carry():
    """Start the port from a carry the JAX package produced (convert.py)
    after a disturbed settle, then replay one recorded disturbance
    realization through both (derivative disturbances + measurement noise)."""
    kw = dict(sim_mode=0, simulate_disturbances=True, simulate_state_estimation=True,
              disturbance_playback=True)
    jsim, jtraj, tsim, ttraj = _builds(**kw)
    rng = np.random.default_rng(30)
    n0, n = 8, 12
    mag_d = np.asarray(JSim().w_derivatives)
    mag_s = np.asarray(JSim().w_state_estimation)
    w_d = rng.uniform(-1, 1, (2, n0 + n, 7)) * mag_d
    w_s = rng.normal(0, 1, (2, n0 + n, 7)) * mag_s
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    carry_j, _ = jax.jit(jax.vmap(lambda a, b, d, s: jsim.run(a, b, n0, playback=(d, s))))(
        x0m_j, x0s_j, w_d[:, :n0], w_s[:, :n0])
    _, log_j = jax.jit(jax.vmap(lambda c, d, s: jsim.run_from(c, n, playback=(d, s))))(
        carry_j, w_d[:, n0:], w_s[:, n0:])

    cs = carry_j.ctrl_state
    carry_t = convert.sim_carry(dict(
        ctrl_state=dict(X=np.asarray(cs.X), U=np.asarray(cs.U),
                        warm={k: np.asarray(getattr(cs.warm, k)) for k in IPMWarm._fields}),
        x_sim=np.asarray(carry_j.x_sim), x_dist=np.asarray(carry_j.x_dist),
        x_est=np.asarray(carry_j.x_est), est_buf=np.asarray(carry_j.est_state.buf),
        est_count=np.asarray(carry_j.est_state.count), pose=np.asarray(carry_j.pose),
    ), device="cpu", dtype=torch.float64)
    _, log_t = tsim.run_from(carry_t, n, playback=(torch.tensor(w_d[:, n0:]),
                                                   torch.tensor(w_s[:, n0:])))
    _compare_logs(log_t, log_j)
    np.testing.assert_array_equal(log_t.dist_se.numpy(), w_s[:, n0:])


def test_reinit_after_failed_solve():
    """A scenario whose iterate is poisoned fails once (status 3), is
    re-initialized at its estimate and then solves again; the other
    scenario never notices."""
    _, _, tsim, ttraj = _builds(sim_mode=0)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=torch.float64)
    carry = tsim.init_carry(x0m, x0s)
    X = carry.ctrl_state.X.clone()
    X[1, 3, 4] = float("nan")
    carry = carry._replace(ctrl_state=carry.ctrl_state._replace(X=X))
    ref_carry, ref_log = tsim.run(x0m[:1], x0s[:1], 3)
    carry, log = tsim.run_from(carry, 3)
    np.testing.assert_array_equal(log.simSolverDebug[:, :, 4].numpy(), [[0, 0, 0], [3, 0, 0]])
    assert torch.isfinite(carry.ctrl_state.X).all()
    np.testing.assert_allclose(log.simU[0].numpy(), ref_log.simU[0].numpy(), rtol=0, atol=1e-9)
