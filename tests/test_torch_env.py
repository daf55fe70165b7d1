"""The port's multi-lap pieces and RL env against the JAX package on the CPU
in float64: `stack_trajectories`, the planner on one lap per scenario
(against `jax.vmap(planner_emulator)` over the laps), `RLEnv.reset_from`
against `RLEnv.reset` with the same draws, `RLEnv.step` with given actions
on two envs on different laps, and the auto-reset of a finished episode.

The JAX package's random draws cannot be reproduced in torch, so each test
recomputes the draws of JAX's keys (the lap and restart index of a reset)
and hands them to the port. Both sides then run the same float64
operations: the stack and planner agree exactly (indices) or to 1e-12, an
env step of 3 closed-loop steps to 1e-9 (measured: <= 1e-13).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.learn.env import RLEnv as JRLEnv, RLEnvConfig as JRLEnvConfig
from tum_control_tpu.learn.observation import ObservationConfig as JObs
from tum_control_tpu.track.planner import planner_emulator as j_planner
from tum_control_tpu.track.trajectory import (
    load_ref_trajectory as j_load, stack_trajectories as j_stack,
)
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH, MPCConfig, SimConfig
from tum_control_tpu_torch.learn.env import RLEnv, RLEnvConfig
from tum_control_tpu_torch.learn.observation import ObservationConfig
from tum_control_tpu_torch.learn.wmpc import load_param_table
from tum_control_tpu_torch.sim.closed_loop import make_generator
from tum_control_tpu_torch.track.planner import planner_emulator
from tum_control_tpu_torch.track.trajectory import (
    load_ref_trajectory, select_laps, stack_trajectories,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRACKS = ("monteblanco", "modena")
TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = load_param_table(os.path.join(REPO, "data", "F.csv"))


def _path(name):
    return os.path.join(DEFAULT_TRAJECTORY_PATH, f"reftraj_{name}_edgar.json")


@pytest.fixture(scope="module")
def stacks():
    j = j_stack([j_load(_path(t)) for t in TRACKS])
    t = stack_trajectories([load_ref_trajectory(_path(n), dtype=torch.float64, device="cpu")
                            for n in TRACKS])
    return j, t


@pytest.fixture(scope="module")
def envs(stacks):
    """JAX and port envs (nominal NMPC, 3 closed-loop steps per env step)."""
    j_stacked, t_stacked = stacks
    jsim, *_ = j_build_simulation(JSim(sim_mode=0), JMPC())
    tsim, *_ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu",
                                dtype=torch.float64)
    make = lambda cfg_j, cfg_t: (
        JRLEnv(jsim, j_stacked, TABLE, JObs(Ts=0.02), cfg_j),
        RLEnv(tsim, t_stacked, TABLE, ObservationConfig(Ts=0.02), cfg_t))
    return make


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _jax_reset_draws(jenv, key):
    """The (lap, restart index) that JAX's `RLEnv.reset(key)` draws."""
    k1, k2, _ = jax.random.split(key, 3)
    track = int(jax.random.randint(k1, (), 0, jenv.n_tracks))
    pick = int(jax.random.randint(k2, (), 0, len(jenv.cfg.restart_indices)))
    return track, jenv.cfg.restart_indices[pick]


def _keys_on_laps(jenv):
    """Two reset keys, the first drawing lap 0, the second lap 1."""
    found = {}
    for i in range(64):
        key = jax.random.PRNGKey(i)
        found.setdefault(_jax_reset_draws(jenv, key)[0], key)
        if len(found) == 2:
            return jnp.stack([found[0], found[1]])
    raise AssertionError("no keys on both laps")


def _compare_carry(ct, cj, tol=TOL):
    for f in ("x_sim", "x_dist", "x_est", "pose"):
        np.testing.assert_allclose(_np(getattr(ct, f)), _np(getattr(cj, f)), rtol=0, atol=tol,
                                   err_msg=f)
    for f in ("X", "U"):
        np.testing.assert_allclose(_np(getattr(ct.ctrl_state, f)),
                                   _np(getattr(cj.ctrl_state, f)), rtol=0, atol=tol, err_msg=f)
    for f in ct.ctrl_state.warm._fields:
        np.testing.assert_allclose(_np(getattr(ct.ctrl_state.warm, f)),
                                   _np(getattr(cj.ctrl_state.warm, f)), rtol=0, atol=tol,
                                   err_msg=f)
    np.testing.assert_allclose(_np(ct.est_state.buf), _np(cj.est_state.buf), rtol=0, atol=tol)
    np.testing.assert_array_equal(_np(ct.est_state.count), _np(cj.est_state.count))


def test_stack_trajectories_matches_jax(stacks):
    j, t = stacks
    for f in ("pos", "yaw", "v", "acc", "seg_time", "cum_time"):
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(_np(t.n_valid), _np(j.n_valid))
    assert t.pos.shape == (2, 1190, 2) and t.cum_time.shape == (2, 1191)
    one = select_laps(t, torch.tensor([1, 0, 1]))
    assert one.pos.shape == (3, 1190, 2) and one.n_valid.tolist() == [1002, 1190, 1002]


def test_planner_per_scenario_laps_matches_vmapped_jax(stacks):
    """Four scenarios, two on each lap, one of each near its lap's end so
    that its window wraps past the padded slots."""
    j, t = stacks
    laps = np.array([0, 1, 1, 0])
    n_valid = _np(t.n_valid)[laps]
    idx = np.array([300, 500, n_valid[2] - 3, n_valid[3] - 20])
    rng = np.random.default_rng(0)
    pose = _np(t.pos)[laps, idx] + rng.normal(0, 0.5, (4, 2))
    jtraj = jax.tree.map(lambda a: a[jnp.asarray(laps)], j)
    c_j, w_j = jax.vmap(lambda tr, p: j_planner(tr, p, 3.04, 39))(jtraj, jnp.asarray(pose))
    c_t, w_t = planner_emulator(select_laps(t, torch.as_tensor(laps)),
                                torch.tensor(pose), 3.04, 39)
    np.testing.assert_array_equal(_np(c_t), _np(c_j))
    for f in ("pos", "yaw", "v"):
        np.testing.assert_allclose(_np(getattr(w_t, f)), _np(getattr(w_j, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    # the window of the scenario 3 points before the end wraps to the start
    assert np.abs(_np(w_t.pos)[2, -1] - _np(t.pos)[1, 30]).max() < 200.0


def test_reset_from_matches_jax_reset(envs):
    jenv, tenv = envs(JRLEnvConfig(n_mpc_steps=3), RLEnvConfig(n_mpc_steps=3))
    keys = _keys_on_laps(jenv)
    es_j, obs_j = jax.vmap(jenv.reset)(keys)
    draws = [_jax_reset_draws(jenv, k) for k in keys]
    track = torch.tensor([d[0] for d in draws])
    ridx = torch.tensor([d[1] for d in draws])
    es_t, obs_t = tenv.reset_from(track, ridx, make_generator(0, "cpu"))
    np.testing.assert_array_equal(_np(es_t.track), _np(es_j.track))
    np.testing.assert_array_equal(_np(es_t.t), _np(es_j.t))
    _compare_carry(es_t.carry, es_j.carry, tol=1e-12)
    np.testing.assert_allclose(_np(obs_t), _np(obs_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("episode_length", [128, 1])
def test_env_step_matches_jax(envs, episode_length):
    """Two envs on different laps, one step of 3 closed-loop steps under
    actions 3 and 17. With episode_length 1 every env's episode ends and
    it auto-resets to the draws JAX makes from its state's key."""
    jenv, tenv = envs(JRLEnvConfig(n_mpc_steps=3, episode_length=episode_length),
                      RLEnvConfig(n_mpc_steps=3, episode_length=episode_length))
    keys = _keys_on_laps(jenv)
    es_j, _ = jax.vmap(jenv.reset)(keys)
    draws = [_jax_reset_draws(jenv, k) for k in keys]
    es_t, _ = tenv.reset_from(torch.tensor([d[0] for d in draws]),
                              torch.tensor([d[1] for d in draws]), make_generator(0, "cpu"))
    actions = np.array([3, 17])
    es_j2, obs_j, rew_j, done_j = jax.jit(jax.vmap(jenv.step))(es_j, jnp.asarray(actions))
    # the draws JAX's auto-reset makes: reset(split(es.key)[1]) per env
    reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(es_j.key)
    again = [_jax_reset_draws(jenv, k) for k in reset_keys]
    reset_draws = (torch.tensor([d[0] for d in again]), torch.tensor([d[1] for d in again]))
    es_t2, obs_t, rew_t, done_t = tenv.step(es_t, torch.as_tensor(actions), reset_draws)

    np.testing.assert_array_equal(_np(done_t), _np(done_j))
    assert bool(done_t.all()) == (episode_length == 1)
    np.testing.assert_allclose(_np(rew_t), _np(rew_j), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(obs_t), _np(obs_j), rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(es_t2.t), _np(es_j2.t))
    np.testing.assert_array_equal(_np(es_t2.track), _np(es_j2.track))
    _compare_carry(es_t2.carry, es_j2.carry)
    assert np.all((_np(rew_t) > 0) & (_np(rew_t) <= 1))
