"""The port's R2NMPC against the JAX package on the CPU in float64: the
covariance recurrence and the bound tightening on seeded inputs, the
one-step-delayed tightening with its refresh-on-success rule, and a 40-step
closed loop step by step.

Tolerances: `_propagate` and `_mods_from_extra` are the same operations in
another order (1e-12). The 40-step closed loop stays within float64
roundoff of the JAX run (the SNMPC loop's 2.5e-14, `test_torch_snmpc.py`), so states, inputs
and the carried corrections are held to 1e-8 with identical solver statuses
and iteration counts (`test_torch_closed_loop._compare_logs`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu import config as jcfg
from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.controllers.rnmpc import RobustExtra as JRobustExtra
from tum_control_tpu.ops.rti import QPMods as JQPMods
from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu_torch import config as tcfg
from tum_control_tpu_torch import convert
from tum_control_tpu_torch.api import build_controller, build_simulation
from tum_control_tpu_torch.controllers.nominal import NominalNMPC
from tum_control_tpu_torch.controllers.rnmpc import RobustExtra
from tum_control_tpu_torch.ops.rti import QPMods
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track.planner import RefWindow

from test_torch_closed_loop import _compare_logs

F64 = torch.float64
T = lambda a: torch.tensor(np.asarray(a))


def _close(got, ref, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


def _controllers(uph=5):
    j = j_build_controller(jcfg.MPCConfig(controller="rnmpc",
                                          uncertainty_propagation_horizon=uph), jcfg.SimConfig())
    t = build_controller(tcfg.MPCConfig(controller="rnmpc", uncertainty_propagation_horizon=uph),
                         tcfg.SimConfig(), device="cpu", dtype=F64)
    return j, t


@pytest.mark.parametrize("uph", [5, 1])
def test_propagate_and_mods_from_extra_match_jax(uph):
    """Seeded stable A_lin, curvature-consistent states with braking and
    accelerating nodes, random carried corrections: new corrections and
    the tightened bounds equal JAX's; caller mods keep their other fields."""
    jctrl, tctrl = _controllers(uph)
    N, nh = tctrl.N, tctrl.nh
    rng = np.random.default_rng(50)
    B = 3
    A = 0.97 * np.eye(8) + rng.normal(0, 0.05, (B, N, 8, 8))
    X = rng.normal(0, 1, (B, N + 1, 8)) * [20, 20, 1, 3, 0.3, 0.1, 0.05, 3]
    X[..., 3] += 22.0
    corr = (np.abs(rng.normal(0, 0.01, (B, N + 1))), np.abs(rng.normal(0, 0.05, (B, N + 1, nh))))
    ex_j = JRobustExtra(*(jnp.asarray(c) for c in corr))
    ex_t = RobustExtra(*(T(c) for c in corr))

    new_j = jax.vmap(jctrl._propagate)(jnp.asarray(A), jnp.asarray(X), ex_j)
    new_t = tctrl._propagate(T(A), T(X), ex_t)
    for f in RobustExtra._fields:
        _close(getattr(new_t, f), getattr(new_j, f), 1e-12, f)
    assert float(new_t.corr_steer[:, 1].min()) > 0 and float(new_t.corr_acc[:, 1:].min()) > 0
    assert (new_t.corr_steer[:, 0] == 0).all() and (new_t.corr_acc[:, 0] == 0).all()
    last = uph - 1 if uph > 1 else 1   # the node whose correction the tail reuses
    assert (new_t.corr_steer[:, uph:] == new_t.corr_steer[:, last:last + 1]).all()

    W = rng.uniform(0.5, 2.0, (B, 6))
    mods_j = jax.vmap(lambda e, w: jctrl._mods_from_extra(e, JQPMods(W=w)))(ex_j, jnp.asarray(W))
    mods_t = tctrl._mods_from_extra(ex_t, QPMods(W=T(W)))
    _close(mods_t.con_lb, mods_j.con_lb, 1e-12, "con_lb")
    _close(mods_t.con_ub, mods_j.con_ub, 1e-12, "con_ub")
    assert torch.equal(mods_t.W, T(W)) and mods_t.u_lb is None
    base_ub = tctrl.engine.con_ub
    assert (mods_t.con_ub[:, 1:N, nh] < base_ub[1:N, nh]).all()
    assert (mods_t.con_ub[:, [0, N]] == base_ub[[0, N]]).all()   # nodes 0 and N untouched


def _window(N, B, v=20.0):
    n = N + 1
    t = np.arange(n) * 0.08
    pos = np.broadcast_to(np.stack([v * t, np.zeros(n)], 1), (B, n, 2))
    return RefWindow(pos=T(pos.copy()), yaw=T(np.zeros((B, n))), v=T(np.full((B, n), v)))


def test_one_step_delayed_tightening_and_refresh_on_success():
    """tests/test_controllers.py's R2 tightening semantics, batched: the first
    solve runs with zero corrections (it equals the nominal solve) and hands
    nonzero ones to the next; node 0 is never tightened and nodes >= UPH
    share the last correction; the covariance grows along the horizon. A
    scenario whose solve fails (status 3, forced by a non-finite state)
    keeps its corrections while the other refreshes."""
    _, tctrl = _controllers()
    N, uph, nh = tctrl.N, tctrl.uph, tctrl.nh
    x0 = T([[0.0, 0.0, 0.0, 20.0, 0.0, 0.0, 0.0, 0.0],
            [0.5, 0.1, 0.02, 21.0, 0.1, 0.01, 0.0, 0.3]])
    win = _window(N, 2)
    st = tctrl.init_state(x0)
    extra0 = tctrl.init_extra(x0)
    assert float(extra0.corr_steer.abs().max()) == 0.0
    out1, st1, extra1 = tctrl.solve_with_extra(st, extra0, x0, win)
    out_n, _ = NominalNMPC.solve(tctrl, st, x0, win)
    _close(out1.u0, out_n.u0.numpy(), 0.0, "first solve = nominal solve")
    assert (out1.stats[:, 4] == 0).all()
    assert (extra1.corr_steer[:, 1] > 0).all()
    assert float(extra1.corr_acc[:, 1:].abs().max()) > 0
    assert (extra1.corr_steer[:, 0] == 0).all()
    assert (extra1.corr_steer[:, uph:] == extra1.corr_steer[:, uph:uph + 1]).all()
    assert (torch.diff(extra1.corr_steer[:, 1:uph], dim=1) >= -1e-12).all()
    mods = tctrl._mods_from_extra(extra1)
    base_ub = tctrl.engine.con_ub
    assert (mods.con_ub[:, 1:-1, nh] < base_ub[1:-1, nh]).all()
    assert (mods.con_ub[:, [0, -1], nh] == base_ub[[0, -1], nh]).all()

    # carried corrections that no solve would produce (3x), so a refresh shows
    carried = RobustExtra(*(3.0 * c for c in extra1))
    x0_bad = x0.clone()
    x0_bad[1, 3] = float("nan")
    out2, _, extra2 = tctrl.solve_with_extra(st1, carried, x0_bad, win)
    assert out2.stats[:, 4].tolist() == [0.0, 3.0]
    for f in RobustExtra._fields:
        assert torch.equal(getattr(extra2, f)[1], getattr(carried, f)[1]), f
        assert torch.isfinite(getattr(extra2, f)[0]).all(), f
        assert not torch.equal(getattr(extra2, f)[0, 1:], getattr(carried, f)[0, 1:]), f


def test_rnmpc_closed_loop_40_steps_matches_jax():
    """Monteblanco, sim_mode 0, batch 2 from batched_scenarios, 40 steps
    through api.build_simulation and ClosedLoopSim.run, step by step; the
    final carried corrections through convert.robust_extra."""
    n = 40
    jsim, _, _, jtraj, _ = j_build_simulation(jcfg.SimConfig(sim_mode=0, T=n * 0.02),
                                              jcfg.MPCConfig(controller="rnmpc"))
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    carry_j, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    tsim, _, _, ttraj, _ = build_simulation(tcfg.SimConfig(sim_mode=0),
                                            tcfg.MPCConfig(controller="rnmpc"), device="cpu",
                                            dtype=F64)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=F64)
    carry_t, log_t = tsim.run(x0m, x0s, n)
    _compare_logs(log_t, log_j, atol=1e-8)
    assert (log_t.simSolverDebug[..., 4] == 0).all()
    assert float(log_t.lat_dev.abs().max()) < 0.5
    ex_j = convert.robust_extra({f: np.asarray(getattr(carry_j.extra, f))
                                 for f in RobustExtra._fields}, device="cpu", dtype=F64)
    for f in RobustExtra._fields:
        _close(getattr(carry_t.extra, f), getattr(ex_j, f).numpy(), 1e-8, f)
    assert float(carry_t.extra.corr_steer.max()) > 0
