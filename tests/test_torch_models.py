"""Parity of the PyTorch port's parameters, configs, vehicle model, RK4 and
gg-limit helpers with the JAX package, on the CPU in float64.

Inputs are drawn from seeded numpy generators and handed to both packages.
Tolerances: the two evaluate the same formulas in the same order, so values
agree to a few float64 ulps of their magnitude (forces reach ~3e4 N, hence
rtol 1e-12 with a small atol).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu import config as jcfg
from tum_control_tpu.controllers import common as jcommon
from tum_control_tpu.models import integrators as jint
from tum_control_tpu.models import vehicle_stm as jveh
from tum_control_tpu_torch import config as tcfg
from tum_control_tpu_torch.controllers import common as tcommon
from tum_control_tpu_torch.models import integrators as tint
from tum_control_tpu_torch.models import vehicle_stm as tveh

CFG = tcfg.DEFAULT_CONFIG_PATH
RTOL, ATOL = 1e-12, 1e-9


def _params():
    sim = tcfg.SimConfig()
    vp = tcfg.load_vehicle_params(CFG, sim.veh_params_file_MPC)
    tp = tcfg.load_tire_params(CFG, sim.tire_params_file_MPC)
    return vp, tp


def _states(regime, n=16, seed=0):
    """(n, 8) prediction-model states and (n, 2) inputs for a speed regime."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([
        rng.uniform(-50, 50, n), rng.uniform(-50, 50, n), rng.uniform(-7, 7, n),
        rng.uniform(2, 40, n), rng.normal(0, 0.5, n), rng.normal(0, 0.3, n),
        rng.normal(0, 0.2, n), rng.normal(0, 2, n),
    ])
    u = rng.normal(0, 1, (n, 2))
    if regime == "standstill":
        # below VLONG_EPS (and exactly 0): the guard forces zero slip angles
        x[:, 3] = rng.uniform(-1e-3, 1e-3, n)
        x[::4, 3] = 0.0
        x[::4, 4] = 0.0
    elif regime == "zero_slip":
        # exactly zero slip angles: vlat = yawrate = delta_f = 0
        x[:, 4:7] = 0.0
    return x, u


def test_params_and_configs_match():
    sim_j, sim_t = jcfg.SimConfig(), tcfg.SimConfig()
    for f in ("veh_params_file_MPC", "tire_params_file_MPC", "veh_params_file_simulator",
              "tire_params_file_simulator"):
        load = "load_vehicle_params" if f.startswith("veh") else "load_tire_params"
        pj = getattr(jcfg, load)(jcfg.DEFAULT_CONFIG_PATH, getattr(sim_j, f))
        pt = getattr(tcfg, load)(CFG, getattr(sim_t, f))
        assert pj._asdict() == pt._asdict(), f
    assert (sim_j.N, sim_j.Nsim, sim_j.Ts_sim_step) == (sim_t.N, sim_t.Nsim, sim_t.Ts_sim_step)
    assert tcfg.DEFAULT_TRAJECTORY_PATH == jcfg.DEFAULT_TRAJECTORY_PATH
    for name in ("sim_main_params.yaml", "MPC_params.yaml"):
        path = f"{CFG}/EDGAR/{name}"
        loader = "load_sim_config" if name.startswith("sim") else "load_mpc_config"
        cj = getattr(jcfg, loader)(path)
        ct = getattr(tcfg, loader)(path)
        assert {k: getattr(cj, k) for k in ct.__dataclass_fields__} == ct.__dict__
    mj, mt = jcfg.MPCConfig(), tcfg.MPCConfig()
    np.testing.assert_array_equal(mj.Q(), mt.Q())
    np.testing.assert_array_equal(mj.R(), mt.R())
    for a, b in zip(jcfg.load_gg_table(CFG, mj.lookuptable_gg_limits),
                    tcfg.load_gg_table(CFG, mt.lookuptable_gg_limits)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("regime", ["moving", "standstill", "zero_slip"])
def test_pred_ode_values_and_jacobian(regime):
    vp, tp = _params()
    x, u = _states(regime)
    fj = jax.vmap(lambda a, b: jveh.pred_ode(a, b, vp, tp))
    Jj = jax.vmap(jax.jacfwd(lambda a, b: jveh.pred_ode(a, b, vp, tp), argnums=(0, 1)))
    ft = lambda a, b: tveh.pred_ode(a, b, vp, tp)
    xt, ut = torch.tensor(x), torch.tensor(u)
    np.testing.assert_allclose(ft(xt, ut).numpy(), fj(x, u), rtol=RTOL, atol=ATOL)
    Jx, Ju = torch.func.vmap(torch.func.jacfwd(ft, argnums=(0, 1)))(xt, ut)
    Jxj, Juj = Jj(x, u)
    assert torch.isfinite(Jx).all() and torch.isfinite(Ju).all()
    np.testing.assert_allclose(Jx.numpy(), Jxj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Ju.numpy(), Juj, rtol=RTOL, atol=ATOL)


def test_sim_ode_disturbed_and_lateral_forces():
    vp, tp = _params()
    x, u = _states("moving", seed=1)
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.5, (x.shape[0], 7))
    xs, us = x[:, :7], u
    got = tveh.sim_ode_disturbed(torch.tensor(xs), torch.tensor(us), torch.tensor(w), vp, tp)
    ref = jax.vmap(lambda a, b, c: jveh.sim_ode_disturbed(a, b, c, vp, tp))(xs, us, w)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    args = [x[:, 3], x[:, 4], x[:, 5], x[:, 6], x[:, 7]]
    got = tveh.lateral_forces(*map(torch.tensor, args), vp, tp)
    ref = jveh.lateral_forces(*args, vp, tp)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.broadcast_to(torch.as_tensor(g).numpy(), x[:, 3].shape),
                                   np.broadcast_to(r, x[:, 3].shape), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_steps,dt", [(3, 0.08), (4, 0.02)])
def test_rk4_multistep(n_steps, dt):
    vp, tp = _params()
    x, u = _states("moving", seed=3)
    ref = jax.vmap(lambda a, b: jint.rk4_multistep(
        lambda xx, uu: jveh.pred_ode(xx, uu, vp, tp), a, b, dt, n_steps))(x, u)
    got = tint.rk4_multistep(lambda xx, uu: tveh.pred_ode(xx, uu, vp, tp),
                             torch.tensor(x), torch.tensor(u), dt, n_steps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [0, 1, 2])
def test_gg_interp_and_acc_constraints(shape):
    """searchsorted-based interp = jnp.interp, in range, at the knots and
    clamped outside, for values and forward-mode slopes."""
    vel, ax_max, ax_min, ay_max = tcfg.load_gg_table(CFG, "EDGAR/ggv.csv")
    ggj = jcommon.GGTables(vel, ax_max, ax_min, ay_max)
    ggt = tcommon.GGTables(vel, ax_max, ax_min, ay_max, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.uniform(vel[0] - 5, vel[-1] + 5, 40), vel[:5], [vel[-1]]])
    a_lon = rng.normal(0, 3, v.shape)
    a_lat = rng.normal(0, 4, v.shape)
    vt = torch.tensor(v)
    np.testing.assert_allclose(ggt.ay_lim(vt).numpy(), ggj.ay_lim(v), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ggt.ax_lim(vt).numpy(), ggj.ax_lim(v), rtol=RTOL, atol=ATOL)
    slope_t = torch.func.jvp(ggt.ay_lim, (vt,), (torch.ones_like(vt),))[1]
    slope_j = jax.jvp(ggj.ay_lim, (jnp.asarray(v),), (jnp.ones_like(v),))[1]
    np.testing.assert_allclose(slope_t.numpy(), slope_j, rtol=RTOL, atol=ATOL)
    got = tcommon.acc_constraints(vt, torch.tensor(a_lon), torch.tensor(a_lat), ggt, -3.5, shape)
    ref = jax.vmap(lambda a, b, c: jcommon.acc_constraints(a, b, c, ggj, -3.5, shape))(
        v, a_lon, a_lat)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    for a, b in zip(tcommon.acc_bounds(shape), jcommon.acc_bounds(shape)):
        np.testing.assert_array_equal(a, b)


def test_wrap_2pi_floor_mod():
    """Negative angles wrap into [0, 2pi) as jnp.mod does (fmod would not)."""
    y = np.array([-7.0, -np.pi, -1e-9, 0.0, 1.0, 2 * np.pi, 13.0])
    got = tcommon.wrap_2pi(torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcommon.wrap_2pi(y)), rtol=0, atol=1e-15)
    assert (got >= 0).all() and (got < 2 * np.pi).all()
