"""Where the BO objective's feasibility is decided, held against the JAX
package on the CPU.

- The second segment group (the low-curvature straights) at the 8 initial
  Sobol candidates of `BayesianOptimizer(seed=0)`, the candidates
  `chip_smoke.py`'s bo phase evaluates: on the straight past Modena's
  finish line (indices 876..65), entered at the reference's 28.2 m/s, every
  candidate pushes the normalized combined acceleration past 1.02 within 16
  steps, in float64 in both packages, so no candidate is feasible on that
  group. A straight where they all stay feasible is held beside it.
- The cost weights of the float32 edge: with r_jerk = 0 the float64 first
  solve asks a jerk of -373 and crashes at step 0, while the float32 first
  solve returns u = 0 (status 0); the JAX package's own float32 objective
  counts both pairs feasible over 20 steps.

Tolerances: feasibility and the NaN pattern exactly, the float64 objectives
to 1e-9 (as tests/test_torch_bo.py).
"""
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.learn.bo.objective import ObjectiveEvaluator as JObjectiveEvaluator
from tum_control_tpu.track.trajectory import (
    load_ref_trajectory as j_load, stack_trajectories as j_stack,
)
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH, MPCConfig, SimConfig
from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator, params_to_mods
from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig
from tum_control_tpu_torch.learn.bo.segmentation import get_train_segments
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


TRACKS = ("modena", "monteblanco")   # the bo phase's lap order
T64 = torch.float64


def _path(name):
    return os.path.join(DEFAULT_TRAJECTORY_PATH, f"reftraj_{name}_edgar.json")


def _port_evaluator(dtype, max_steps):
    sim = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu", dtype=dtype)[0]
    stack = stack_trajectories([load_ref_trajectory(_path(t), dtype=dtype, device="cpu")
                                for t in TRACKS])
    return ObjectiveEvaluator(sim, stack, max_steps=max_steps)


def _jax_evaluator(max_steps):
    jsim, *_ = j_build_simulation(JSim(sim_mode=0), JMPC())
    return JObjectiveEvaluator(jsim, j_stack([j_load(_path(t)) for t in TRACKS]),
                               max_steps=max_steps)


def _initial_candidates(n):
    """The parameters of BayesianOptimizer(seed=0)'s initial Sobol data."""
    seen = []

    def record(p):
        seen.append(np.asarray(p))
        return np.zeros((len(p), 2)), np.ones(len(p), dtype=bool)

    bo = BayesianOptimizer([record, record], BOConfig(n_initial=n), seed=0, device="cpu")
    bo.generate_initial_data()
    return seen[0]


def test_group1_straights_are_infeasible_for_every_initial_candidate_as_jax():
    steps = 16
    segs = {(s["trajectory"], s["start"], s["end"]): s
            for s in get_train_segments(tracks=TRACKS)[1]}
    chosen = [("modena", 876, 65), ("modena", 216, 250)]
    assert all(c in segs for c in chosen)
    P = _initial_candidates(8)
    p = np.repeat(P, len(chosen), axis=0)
    tr = np.tile([TRACKS.index(c[0]) for c in chosen], len(P))
    st = np.tile([c[1] for c in chosen], len(P))
    en = np.tile([c[2] for c in chosen], len(P))

    jev = _jax_evaluator(steps)
    f_j, feas_j = (np.asarray(a) for a in jev._run_chunk(
        jnp.asarray(p), jnp.asarray(tr), jnp.asarray(st), jnp.asarray(en)))
    tev = _port_evaluator(T64, steps)
    f_t, feas_t = (a.numpy() for a in tev.run_chunk(
        torch.tensor(p, dtype=T64), torch.tensor(tr), torch.tensor(st), torch.tensor(en)))

    np.testing.assert_array_equal(feas_t, feas_j)
    np.testing.assert_array_equal(np.isnan(f_t), np.isnan(f_j))
    np.testing.assert_allclose(np.nan_to_num(f_t), np.nan_to_num(f_j), rtol=0, atol=1e-9)
    # every candidate crashes on the finish straight and drives the other
    assert feas_t.reshape(len(P), len(chosen)).tolist() == [[False, True]] * len(P)


def _first_step(dtype, P):
    """The port's first closed-loop step of each row of P from Modena's
    index 45: (simU, status, normalized combined acceleration)."""
    ev = _port_evaluator(dtype, 1)
    sim = ev.sim
    track, start = torch.zeros(len(P), dtype=torch.int64), torch.full((len(P),), 45)
    traj = select_laps(ev.stacked, track)
    rows = torch.arange(len(P))
    px = traj.pos[rows, start]
    yaw0 = torch.remainder(traj.yaw[rows, start], 2 * math.pi)
    x0m = torch.cat([px, yaw0[:, None], traj.v[rows, start][:, None],
                     px.new_zeros((len(P), 4))], dim=1)
    carry = sim.init_carry(x0m, x0m[:, :7], key=0)
    zero = torch.zeros_like(carry.x_sim)
    mods = params_to_mods(sim.controller.engine, torch.tensor(P, dtype=dtype))
    carry, log = sim.step(carry, zero, zero, traj=traj, mods=mods)
    return log.simU, log.simSolverDebug[:, 4], ev._a_comb(carry.x_sim, log.MPC_SimX[:, 7])


def test_float32_first_solve_at_zero_jerk_weight_and_jax_float32_verdict():
    P = np.array([[30, 0, 30, 0, 20, 500, 500], [30, 5, 30, 0, 20, 500, 500]], float)
    u64, status64, a64 = _first_step(T64, P)
    assert (status64 == 0).all()
    assert (u64[:, 0] < -300).all() and (a64 > 1.02).all()      # a crash at step 0
    u32, status32, a32 = _first_step(torch.float32, P)
    assert (status32 == 0).all()
    assert (u32 == 0).all() and (a32 <= 1.02).all()             # no crash at step 0

    with jax.enable_x64(False):
        jev = _jax_evaluator(20)
        f_j, feas_j = jev._run_chunk(jnp.asarray(P, jnp.float32), jnp.zeros(2, jnp.int32),
                                     jnp.full(2, 45, jnp.int32), jnp.full(2, 236, jnp.int32))
        assert f_j.dtype == jnp.float32
        f_j, feas_j = np.asarray(f_j), np.asarray(feas_j)
    assert feas_j.tolist() == [True, True] and np.isfinite(f_j).all()
