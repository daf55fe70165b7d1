"""The RTI engine's generic linearization (forward-mode AD of a one-stage
`dyn_step`, vmapped over every stage of every scenario) and the helpers
ported with it, against the JAX package on the CPU in float64:

  * an engine given only the nominal model's `dyn_step` equals the same
    engine given `dyn_jac` (the batched step's Jacobian by
    ops/rti.py::jacobian_fwd) and JAX's jacfwd branch (its nominal engine
    with `lin_rollout` removed) on A, B and xi within 1e-10, and JAX's on
    one solve within 1e-8 (the parity tests' tolerance for a solve);
  * rk4_step_tree / rk4_multistep_tree over pred_ode_tuple, pred_ode_tuple,
    resolve_trajectory_paths, make_mesh and shard_batch (one gloo process).
"""
import copy
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.models import integrators as jint
from tum_control_tpu.models import vehicle_stm as jstm
from tum_control_tpu.ops.ipm import IPMWarm as JWarm
from tum_control_tpu.ops.rti import RTIState as JRTIState
from tum_control_tpu.parallel import mesh as jmesh
from tum_control_tpu.track import trajectory as jtraj
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.controllers.nominal import N_SHOOTING_SUBSTEPS
from tum_control_tpu_torch.models import integrators as tint
from tum_control_tpu_torch.models import vehicle_stm as tstm
from tum_control_tpu_torch.ops.ipm import IPMWarm
from tum_control_tpu_torch.ops.rti import RTIState, jacobian_fwd
from tum_control_tpu_torch.parallel import mesh as tmesh
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track import trajectory as ttraj
from tum_control_tpu_torch.track.planner import planner_emulator

B = 3
f64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """The nominal controller of both packages, engines linearized by
    dyn_step alone and by dyn_jac, and one perturbed iterate at B lap states."""
    sim, _, _, traj, _ = build_simulation(SimConfig(), MPCConfig(), device="cpu", dtype=f64)
    ctrl = sim.controller
    vp, tp, dt = ctrl.vp, ctrl.tp, ctrl.dt
    ode = lambda x, u: tstm.pred_ode(x, u, vp, tp)

    def dyn_step(k, x, u):
        return tint.rk4_multistep(ode, x, u, dt, N_SHOOTING_SUBSTEPS)

    def dyn_jac(x, u):
        nx = x.shape[-1]
        F, J = jacobian_fwd(lambda xu: dyn_step(0, xu[..., :nx], xu[..., nx:]),
                            torch.cat([x, u], dim=-1))
        return F, J[..., :nx], J[..., nx:]

    engines = {}
    for name, hooks in (("dyn_step", dict(dyn_step=dyn_step)), ("dyn_jac", dict(dyn_jac=dyn_jac))):
        e = copy.copy(ctrl.engine)
        e.funcs = e.funcs._replace(lin_rollout=None, **hooks)
        engines[name] = e
    jctrl = j_build_controller(JMPC(), JSim())
    jeng = copy.copy(jctrl.engine)
    jeng.funcs = jeng.funcs._replace(lin_rollout=None)   # JAX's jacfwd-of-dyn_step branch

    x0, _ = batched_scenarios(traj, B, dtype=f64)
    rng = np.random.default_rng(31)
    st = ctrl.init_state(x0)
    X = st.X.numpy() + rng.normal(0, 0.05, st.X.shape)
    U = rng.normal(0, 0.3, st.U.shape)
    warm = [np.ones(st.warm.su.shape) for _ in IPMWarm._fields]
    state = RTIState(X=torch.tensor(X), U=torch.tensor(U), warm=IPMWarm(*map(torch.tensor, warm)))
    jstate = JRTIState(X=X, U=U, warm=JWarm(*warm))
    _, win = planner_emulator(traj, x0[:, :2], 3.04, 39)
    yref, yref_e = ctrl.make_yref(win)
    return dict(engines=engines, jeng=jeng, state=state, jstate=jstate, x0=x0, yref=yref,
                yref_e=yref_e, dyn_step=dyn_step)


def _close(got, ref, tol, msg):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


def test_dyn_step_linearization_matches_dyn_jac_and_jax(case):
    got = case["engines"]["dyn_step"]._linearize(case["state"])
    via_jac = case["engines"]["dyn_jac"]._linearize(case["state"])
    ref = jax.jit(jax.vmap(case["jeng"]._linearize))(case["jstate"])
    for name, a, b, c in zip(("A", "B", "xi"), got, via_jac, ref):
        assert a.shape == b.shape and a.dtype == f64
        _close(a, b.numpy(), 1e-10, f"{name} vs dyn_jac")
        _close(a, c, 1e-10, f"{name} vs JAX")


def test_dyn_step_linearization_passes_the_stage_index(case):
    """dyn_step sees stage k of every scenario: a step that adds k to the
    next state shifts xi by k at stage k and leaves A and B as they were."""
    eng = copy.copy(case["engines"]["dyn_step"])
    step = case["dyn_step"]
    eng.funcs = eng.funcs._replace(dyn_step=lambda k, x, u: step(k, x, u) + k.to(x.dtype))
    A, Bm, xi = eng._linearize(case["state"])
    A0, B0, xi0 = case["engines"]["dyn_step"]._linearize(case["state"])
    N = xi.shape[1]
    _close(xi - xi0, np.broadcast_to(np.arange(N, dtype=float)[None, :, None], xi.shape), 1e-12,
           "xi shift")
    _close(A, A0.numpy(), 0, "A")
    _close(Bm, B0.numpy(), 0, "B")


def test_dyn_step_engine_solve_matches_jax(case):
    eng = case["engines"]["dyn_step"]
    u0, st, stats, _ = eng.solve_full(case["state"], case["x0"], case["yref"], case["yref_e"])
    u0j, stj, statsj, _ = jax.jit(jax.vmap(case["jeng"].solve_full))(
        case["jstate"], case["x0"].numpy(), case["yref"].numpy(), case["yref_e"].numpy())
    _close(u0, u0j, 1e-8, "u0")
    _close(st.X, stj.X, 1e-8, "X")
    _close(st.U, stj.U, 1e-8, "U")
    np.testing.assert_array_equal(stats.status.numpy(), np.asarray(statsj.status))
    np.testing.assert_array_equal(stats.qp_iter.numpy(), np.asarray(statsj.qp_iter))


def test_rk4_tree_and_pred_ode_tuple_match_jax():
    from tum_control_tpu_torch.api import load_vehicle_params, load_tire_params

    cfg = SimConfig()
    path = "data/Config"
    vp = load_vehicle_params(path, cfg.veh_params_file_simulator)
    tp = load_tire_params(path, cfg.tire_params_file_simulator)
    rng = np.random.default_rng(2)
    x = np.stack([rng.normal(0, 1, 5), rng.normal(0, 1, 5), rng.uniform(0, 6, 5),
                  rng.uniform(5, 30, 5), rng.normal(0, 0.5, 5), rng.normal(0, 0.2, 5),
                  rng.normal(0, 0.05, 5), rng.normal(0, 2, 5)])
    u = rng.normal(0, 0.2, (2, 5))
    xt, ut = tuple(map(torch.tensor, x)), tuple(map(torch.tensor, u))
    xj, uj = tuple(map(jnp.asarray, x)), tuple(map(jnp.asarray, u))
    ft = lambda a, b: tstm.pred_ode_tuple(a, b, vp, tp)
    fj = lambda a, b: jstm.pred_ode_tuple(a, b, vp, tp)
    for got, ref in ((ft(xt, ut), fj(xj, uj)),
                     (tint.rk4_step_tree(ft, xt, ut, 0.02), jint.rk4_step_tree(fj, xj, uj, 0.02)),
                     (tint.rk4_multistep_tree(ft, xt, ut, 0.08, 3),
                      jint.rk4_multistep_tree(fj, xj, uj, 0.08, 3))):
        assert isinstance(got, tuple) and len(got) == 8
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)
    # the tuple form is pred_ode on stacked states
    stacked = tstm.pred_ode(torch.tensor(x.T), torch.tensor(u.T), vp, tp)
    np.testing.assert_allclose(torch.stack(ft(xt, ut), dim=1).numpy(), stacked.numpy(),
                               rtol=1e-13, atol=1e-13)


def test_resolve_trajectory_paths_matches_jax():
    args = ("data/Trajectories", "reftraj_monteblanco_edgar.json", "track_monteblanco.json")
    assert ttraj.resolve_trajectory_paths(*args) == jtraj.resolve_trajectory_paths(*args)


def test_make_mesh_and_shard_batch_at_world_one():
    import torch.distributed as dist

    from tum_control_tpu_torch.parallel.distributed import initialize_distributed

    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        mesh = tmesh.make_mesh()
        assert mesh.mesh_dim_names == ("batch",) and mesh.size() == 1
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="one process per device"):
            tmesh.make_mesh(2)
        rng = np.random.default_rng(0)
        tree = {"a": rng.normal(size=(4, 3)), "b": (rng.normal(size=(4,)), "label")}
        got = tmesh.shard_batch(mesh, {"a": torch.tensor(tree["a"]),
                                       "b": (torch.tensor(tree["b"][0]), "label")})
        jm = jmesh.make_mesh(1)
        ref = jmesh.shard_batch(jm, {"a": tree["a"], "b": tree["b"][0]})
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(ref["a"].addressable_shards[0].data))
        np.testing.assert_array_equal(got["b"][0].numpy(),
                                      np.asarray(ref["b"].addressable_shards[0].data))
        assert got["b"][1] == "label"
    finally:
        dist.destroy_process_group()
