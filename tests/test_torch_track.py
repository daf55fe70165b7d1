"""Parity of the PyTorch port's trajectory loading, planner emulator, state
estimator, scenario batches and disturbance draws with the JAX package, on
the CPU in float64.

Trajectory data, planner windows and estimator means are sums of a few
float64 terms in the same order in both packages: they agree to ~1e-12
relative (positions are O(100 m), hence atol 1e-9).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu.sim import estimator as jest
from tum_control_tpu.track import planner as jplan
from tum_control_tpu.track import trajectory as jtraj
from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH as TRAJ
from tum_control_tpu_torch.parallel.mesh import batched_scenarios as t_batched
from tum_control_tpu_torch.sim import disturbances as tdist
from tum_control_tpu_torch.sim import estimator as test_
from tum_control_tpu_torch.track import planner as tplan
from tum_control_tpu_torch.track import trajectory as ttraj

RTOL, ATOL = 1e-12, 1e-9
TRACKS = ["monteblanco", "modena"]


def _load(track):
    path = os.path.join(TRAJ, f"reftraj_{track}_edgar.json")
    return path, jtraj.load_ref_trajectory(path), ttraj.load_ref_trajectory(path, torch.float64, device="cpu")


@pytest.mark.parametrize("track", TRACKS)
def test_load_ref_trajectory_and_initial_state(track):
    path, tj, tt = _load(track)
    for f in ("pos", "yaw", "v", "acc", "seg_time", "cum_time"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(tj, f)), f)
    assert tt.n_valid == int(tj.n_valid) == tt.n_points
    for a, b in zip(ttraj.initial_state(path, 17), jtraj.initial_state(path, 17)):
        np.testing.assert_array_equal(a, b)
    trk = os.path.join(TRAJ, f"track_{track}.json")
    for a, b in zip(ttraj.load_track(trk), jtraj.load_track(trk)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("track", TRACKS)
def test_planner_windows(track):
    """Poses along the lap (near points, between points, across the lap
    seam, exactly on a point) give the same nearest index and window."""
    _, tj, tt = _load(track)
    rng = np.random.default_rng(5)
    M = tt.n_valid
    pos = tt.pos.numpy()
    idx = np.concatenate([rng.integers(0, M, 20), [0, 1, M - 2, M - 1]])
    pose = pos[idx] + rng.normal(0, 1.5, (idx.size, 2))
    pose[-1] = pos[M - 1]  # exactly on a point
    N1 = 39
    c_t, win_t = tplan.planner_emulator(tt, torch.tensor(pose), 3.04, N1)
    c_j, win_j = jax.vmap(lambda p: jplan.planner_emulator(tj, p, 3.04, N1))(pose)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    for f in ("pos", "yaw", "v"):
        np.testing.assert_allclose(getattr(win_t, f).numpy(), np.asarray(getattr(win_j, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_planner_argmin_first_index_on_ties():
    """Two equidistant trajectory points: both pick the lower index."""
    _, tj, tt = _load("monteblanco")
    mid = 0.5 * (tt.pos[10] + tt.pos[11])
    c_t, _ = tplan.planner_emulator(tt, mid[None], 3.04, 39)
    c_j, _ = jplan.planner_emulator(tj, jnp.asarray(mid.numpy()), 3.04, 39)
    assert int(c_t[0]) == int(c_j)


def test_estimator_ring_buffer():
    rng = np.random.default_rng(6)
    xs = rng.normal(0, 1, (20, 3, 8))  # 20 pushes of 3 scenarios
    st_t = test_.init_estimator(3, 8, torch.float64, device="cpu")
    st_j = jax.vmap(lambda _: jest.init_estimator(8, jnp.float64))(jnp.arange(3))
    step_j = jax.vmap(jest.estimate)
    for x in xs:
        f_t, st_t = test_.estimate(st_t, torch.tensor(x))
        f_j, st_j = step_j(st_j, x)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=RTOL, atol=1e-14)
        np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_j.count))
    np.testing.assert_array_equal(st_t.buf.numpy(), np.asarray(st_j.buf))


def test_estimator_builds_its_constants_once(monkeypatch):
    """`estimate` makes no tensor from host data per call (on CUDA that copy
    synchronizes the stream every closed-loop step): its window sizes and
    slot ages are built at the first call on a device and reused
    (device.py::device_constant). Each fill level 1..16 still matches JAX's
    `estimate`."""
    from tum_control_tpu_torch.device import device_constant

    rng = np.random.default_rng(7)
    xs = rng.normal(0, 1, (16, 2, 8))
    st_t = test_.init_estimator(2, 8, torch.float64, device="cpu")
    st_j = jax.vmap(lambda _: jest.init_estimator(8, jnp.float64))(jnp.arange(2))
    step_j = jax.vmap(jest.estimate)
    xs_t = [torch.tensor(x) for x in xs]
    made = []
    for name in ("as_tensor", "tensor", "from_numpy", "arange"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: made.append(_n)
                            or _r(*a, **k))
    device_constant.cache_clear()  # the first call below builds the constants
    for level, (x, x_t) in enumerate(zip(xs, xs_t), start=1):
        f_t, st_t = test_.estimate(st_t, x_t)
        f_j, st_j = step_j(st_j, x)
        assert int(st_t.count[0]) == min(level, test_.BUF)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=RTOL, atol=1e-14)
        if level == 1:
            assert made == ["tensor", "tensor"], made
            made.clear()
    assert made == [], f"estimate made tensors after its first call: {made}"
    cpu = torch.device("cpu")
    assert device_constant(tuple(test_.WINDOW_SIZES.tolist()), cpu).tolist() == \
        test_.WINDOW_SIZES.tolist()
    assert device_constant(tuple(range(test_.BUF)), cpu).tolist() == list(range(test_.BUF))


@pytest.mark.parametrize("track", TRACKS)
def test_batched_scenarios(track):
    _, tj, tt = _load(track)
    xm_t, xs_t = t_batched(tt, 8, dtype=torch.float64)
    xm_j, xs_j = j_batched(tj, 8, dtype=jnp.float64)
    np.testing.assert_allclose(xm_t.numpy(), np.asarray(xm_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=RTOL, atol=1e-12)


def test_disturbance_draws():
    """torch.Generator streams differ from jax.random, so the draws are
    checked for their law: seeded reproducibility, zero for 'none', the
    bound for 'absolute', inside the ellipsoid for 'uniform', and the
    per-component std for 'gaussian' (4-sigma band on 4000 draws)."""
    mag = np.array([0.8, 0.8, 0.1, 1.1, 0.1, 0.05, 0.1])
    mk = lambda kind: tdist.disturbance_config(kind, mag, dtype=torch.float64, device="cpu")
    gen = lambda: torch.Generator().manual_seed(7)
    assert tdist.TYPE_NONE == 0
    assert torch.count_nonzero(tdist.draw_disturbance(
        tdist.disturbance_config("gaussian", mag, enabled=False, device="cpu"), gen(), 5)) == 0
    np.testing.assert_array_equal(tdist.draw_disturbance(mk("absolute"), gen(), 3).numpy(),
                                  np.tile(mag, (3, 1)))
    u1 = tdist.draw_disturbance(mk("uniform"), gen(), 4000)
    u2 = tdist.draw_disturbance(mk("uniform"), gen(), 4000)
    assert torch.equal(u1, u2)
    r = torch.sqrt(torch.sum((u1 / torch.tensor(mag)) ** 2, dim=1))
    assert float(r.max()) <= 1.0 + 1e-12
    g = tdist.draw_disturbance(mk("gaussian"), gen(), 4000)
    std = g.std(dim=0).numpy()
    assert np.all(np.abs(std / mag - 1.0) < 4.0 / np.sqrt(2 * 4000))


def test_convert_params_gg_and_trajectory():
    """convert.py carries the JAX package's parameters, gg tables and
    trajectory across from numpy arrays and plain dicts."""
    from tum_control_tpu import config as jcfg
    from tum_control_tpu.controllers.common import GGTables as JGG
    from tum_control_tpu_torch import config as tcfg
    from tum_control_tpu_torch import convert

    sim = jcfg.SimConfig()
    vp = jcfg.load_vehicle_params(jcfg.DEFAULT_CONFIG_PATH, sim.veh_params_file_MPC)
    tp = jcfg.load_tire_params(jcfg.DEFAULT_CONFIG_PATH, sim.tire_params_file_MPC)
    assert convert.vehicle_params(vp._asdict()) == tcfg.load_vehicle_params(
        tcfg.DEFAULT_CONFIG_PATH, sim.veh_params_file_MPC)
    assert convert.tire_params(tp._asdict()) == tcfg.load_tire_params(
        tcfg.DEFAULT_CONFIG_PATH, sim.tire_params_file_MPC)
    ggj = JGG(*jcfg.load_gg_table(jcfg.DEFAULT_CONFIG_PATH, "EDGAR/ggv.csv"))
    ggt = convert.gg_tables({k: np.asarray(getattr(ggj, k)) for k in ("vel", "ax_max", "ax_min",
                                                                       "ay_max")},
                            device="cpu", dtype=torch.float64)
    v = np.linspace(0, 40, 17)
    np.testing.assert_array_equal(ggt.ay_lim(torch.tensor(v)).numpy(), np.asarray(ggj.ay_lim(v)))
    _, tj, tt = _load("modena")
    tc = convert.ref_trajectory({k: np.asarray(v) for k, v in tj._asdict().items()},
                                device="cpu", dtype=torch.float64)
    for f in ("pos", "yaw", "v", "acc", "seg_time", "cum_time"):
        assert torch.equal(getattr(tc, f), getattr(tt, f)), f
    assert tc.n_valid == tt.n_valid
