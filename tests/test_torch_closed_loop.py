"""The port's nominal-NMPC closed loop against the JAX package, step by
step, on the CPU in float64; the port's import isolation from JAX.

The 200-step Monteblanco drive is the end-to-end check of the slice: the
two packages agree to ~1e-14 at the first steps, and the fixed-iteration
IPM amplifies that roundoff to ~4e-6 over 200 steps (measured), so states
and inputs are held to atol 1e-4 and the solver statuses must be identical.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH, MPCConfig, SimConfig
from tum_control_tpu_torch.ops.ipm import init_warm
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.sim.disturbances import disturbance_config
from tum_control_tpu_torch.sim.estimator import init_estimator
from tum_control_tpu_torch.track.trajectory import load_ref_trajectory


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
STATE_FIELDS = ("MPC_SimX", "CiLX", "DisturbedX", "simU", "simREF", "lat_dev", "vel_dev",
                "dist_deriv", "dist_se")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _builds(**sim_kw):
    jsim, _, _, jtraj, _ = j_build_simulation(JSim(**sim_kw), JMPC())
    tsim, _, _, ttraj, _ = build_simulation(SimConfig(**sim_kw), MPCConfig(), device="cpu",
                                            dtype=torch.float64)
    return jsim, jtraj, tsim, ttraj


def _compare_logs(log_t, log_j, atol=ATOL):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(log_t, f).numpy(), np.asarray(getattr(log_j, f)),
                                   rtol=0, atol=atol, err_msg=f)
    dbg_t, dbg_j = log_t.simSolverDebug.numpy(), np.asarray(log_j.simSolverDebug)
    np.testing.assert_array_equal(dbg_t[..., 2:], dbg_j[..., 2:])  # sqp/qp iters, status
    np.testing.assert_allclose(dbg_t[..., 0], dbg_j[..., 0], rtol=1e-3, atol=atol)  # cost
    np.testing.assert_array_equal(log_t.wmpc_action.numpy(), np.asarray(log_j.wmpc_action))


def test_nominal_closed_loop_200_steps_matches_jax():
    """The verify drive (Monteblanco, sim_mode 0, 200 steps of 0.02 s) at
    batch 2 from two curvature-consistent starts along the lap."""
    n = 200
    jsim, jtraj, tsim, ttraj = _builds(sim_mode=0, T=n * 0.02)
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    _, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=torch.float64)
    carry, log_t = tsim.run(x0m, x0s, n)
    assert log_t.simU.shape == (2, n, 2)
    _compare_logs(log_t, log_j)
    assert (log_t.simSolverDebug[..., 4] == 0).all()
    assert float(log_t.lat_dev.abs().max()) < 0.5
    assert torch.isfinite(carry.x_sim).all()


def test_port_imports_without_jax_and_needs_cuda_by_default():
    """The whole package imports with `jax` and `tum_control_tpu` blocked,
    loads neither, and its entry points (build_simulation, build_controller
    for every controller and WMPC, load_sb3_policy, the convert functions,
    the training entry modules rl_training and bo_optimize) and constructors
    (GGTables, NominalNMPC, StochasticNMPC, ReducedRobustNMPC,
    load_ref_trajectory, disturbance_config, init_estimator, init_warm,
    init_mlp_policy, BayesianOptimizer) raise without a CUDA device unless
    the caller names a device. The same holds for the user-facing entry
    modules (main, get_baseline_performances, bo_postprocess_parameters),
    run_policy, action_probability_trace and load_playback; main and the
    baseline sweep then run on the CPU. So do the serving entry module
    deploy_rt, scaling_report, the scaling_eval tool and
    initialize_distributed, which picks gloo only when the caller names the
    CPU (the real-time executor is host code and needs no card).
    matplotlib and imageio are blocked
    too: nothing imports them at import time, a run without plots needs
    neither, and asking for plots or a GIF raises an ImportError that names
    the missing package."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys

        BLOCKED = {"jax", "jaxlib", "tum_control_tpu", "matplotlib", "imageio"}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import tum_control_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        import numpy as np
        from tum_control_tpu_torch import config as cfg, convert
        from tum_control_tpu_torch.api import build_controller, build_simulation
        from tum_control_tpu_torch.config import MPCConfig, SimConfig
        from tum_control_tpu_torch.controllers.common import GGTables
        from tum_control_tpu_torch.controllers.nominal import NominalNMPC
        from tum_control_tpu_torch.controllers.rnmpc import ReducedRobustNMPC
        from tum_control_tpu_torch.controllers.snmpc import StochasticNMPC
        from tum_control_tpu_torch import bo_optimize, rl_training
        from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer
        from tum_control_tpu_torch.learn.policy import init_mlp_policy, load_sb3_policy
        from tum_control_tpu_torch.sim.closed_loop import make_generator
        from tum_control_tpu_torch.ops.ipm import init_warm
        from tum_control_tpu_torch.sim.disturbances import disturbance_config
        from tum_control_tpu_torch.sim.estimator import init_estimator
        from tum_control_tpu_torch.track.trajectory import load_ref_trajectory

        def needs_cuda(name, fn):
            try:
                fn()
            except RuntimeError as e:
                assert "CUDA" in str(e), (name, e)
            else:
                raise AssertionError(name + " ran without a CUDA device")

        sim = SimConfig()
        snmpc = MPCConfig(controller="snmpc")
        vp = cfg.load_vehicle_params(cfg.DEFAULT_CONFIG_PATH, sim.veh_params_file_MPC)
        tp = cfg.load_tire_params(cfg.DEFAULT_CONFIG_PATH, sim.tire_params_file_MPC)
        table = cfg.load_gg_table(cfg.DEFAULT_CONFIG_PATH, snmpc.lookuptable_gg_limits)
        gg_cpu = GGTables(*table, device="cpu")
        z = lambda *s: np.zeros(s)
        state = dict(X=z(2, 39, 88), U=z(2, 38, 2), warm={k: z(2, 154) for k in (
            "su", "sl", "lam_u", "lam_l", "mu_u", "mu_l")})
        carry = dict(ctrl_state=state, x_sim=z(2, 7), x_dist=z(2, 7), x_est=z(2, 8),
                     est_buf=z(2, 8, 15), est_count=np.zeros(2, np.int32), pose=z(2, 2))
        rnmpc = MPCConfig(controller="rnmpc")
        wmpc = MPCConfig(controller="rnmpc", enable_WMPC=True,
                         WMPC_model="data/wmpc_models/new_BO_F")
        npz = cfg.REPO_ROOT + "/data/wmpc_models/new_BO_F/policy_weights.npz"
        extra = dict(corr_steer=z(2, 39), corr_acc=z(2, 39, 1))
        needs_cuda("build_simulation", lambda: build_simulation(sim, MPCConfig()))
        needs_cuda("build_controller rnmpc", lambda: build_controller(rnmpc, sim))
        needs_cuda("build_simulation wmpc", lambda: build_simulation(sim, wmpc))
        needs_cuda("ReducedRobustNMPC", lambda: ReducedRobustNMPC(rnmpc, 38, 0.08, vp, tp, gg_cpu))
        needs_cuda("load_sb3_policy", lambda: load_sb3_policy(npz))
        needs_cuda("convert.robust_extra", lambda: convert.robust_extra(extra))
        needs_cuda("build_simulation snmpc", lambda: build_simulation(sim, snmpc))
        needs_cuda("build_controller snmpc", lambda: build_controller(snmpc, sim))
        needs_cuda("GGTables", lambda: GGTables(*table))
        needs_cuda("NominalNMPC", lambda: NominalNMPC(MPCConfig(), 38, 0.08, vp, tp, gg_cpu))
        needs_cuda("StochasticNMPC", lambda: StochasticNMPC(snmpc, 38, 0.08, vp, tp, gg_cpu))
        needs_cuda("convert.sim_carry", lambda: convert.sim_carry(carry))
        needs_cuda("convert.rti_state", lambda: convert.rti_state(state))
        needs_cuda("convert.gg_tables", lambda: convert.gg_tables(dict(zip(
            ("vel", "ax_max", "ax_min", "ay_max"), table))))
        traj_file = sim.trajectory_path + "/" + sim.ref_traj_file
        needs_cuda("load_ref_trajectory", lambda: load_ref_trajectory(traj_file))
        needs_cuda("disturbance_config", lambda: disturbance_config("gaussian", z(7)))
        needs_cuda("init_estimator", lambda: init_estimator(2))
        needs_cuda("init_warm", lambda: init_warm(2, 154))
        gen = make_generator(0, "cpu")
        needs_cuda("init_mlp_policy", lambda: init_mlp_policy(gen, 22, 26))
        needs_cuda("BayesianOptimizer", lambda: BayesianOptimizer([]))
        needs_cuda("rl_training", lambda: rl_training.main(["--smoke"]))
        needs_cuda("bo_optimize", lambda: bo_optimize.main(["--smoke"]))
        assert load_ref_trajectory(traj_file, device="cpu").pos.device.type == "cpu"
        assert init_mlp_policy(gen, 22, 26, device="cpu").n_actions == 26
        assert BayesianOptimizer([], device="cpu").device.type == "cpu"
        build_simulation(sim, MPCConfig(), device="cpu")
        build_simulation(sim, snmpc, device="cpu")
        build_simulation(sim, wmpc, device="cpu")
        assert load_sb3_policy(npz, device="cpu").n_actions == 26
        assert convert.robust_extra(extra, device="cpu").corr_acc.shape == (2, 39, 1)
        assert convert.sim_carry(carry, device="cpu").ctrl_state.X.shape == (2, 39, 88)

        import tempfile
        from tum_control_tpu_torch import bo_postprocess_parameters, get_baseline_performances
        from tum_control_tpu_torch import main as entry_main
        from tum_control_tpu_torch.eval import plots
        from tum_control_tpu_torch.eval.live_viz import LiveView
        from tum_control_tpu_torch.learn.evaluation import action_probability_trace, run_policy
        from tum_control_tpu_torch.sim.disturbances import load_playback
        model = "data/wmpc_models/new_BO_F"
        trials = cfg.REPO_ROOT + "/Logs/bo_trials_r4.csv"
        needs_cuda("main", lambda: entry_main.main(["--no-plots", "--T", "0.02"]))
        needs_cuda("get_baseline_performances", lambda: get_baseline_performances.main(
            ["--T", "0.02"]))
        needs_cuda("bo_postprocess_parameters", lambda: bo_postprocess_parameters.main([trials]))
        needs_cuda("run_policy", lambda: run_policy(model, T=0.02))
        needs_cuda("action_probability_trace", lambda: action_probability_trace(model, T=0.02))
        needs_cuda("load_playback", lambda: load_playback("Logs", "full_logs.npz", 5))

        def needs(package, name, fn):
            try:
                fn()
            except ImportError as e:
                assert package in str(e), (name, e)
            else:
                raise AssertionError(name + " ran without " + package)

        tmp = tempfile.mkdtemp()
        needs("matplotlib", "plot_all", lambda: plots.plot_all({}, tmp))
        needs("matplotlib", "run_main with plots", lambda: entry_main.run_main(
            sim, MPCConfig(), device="cpu", logs_path=tmp))
        needs("matplotlib", "LiveView", lambda: LiveView())
        logs, _, _ = entry_main.main(["--no-plots", "--T", "0.04", "--device", "cpu",
                                      "--logs-path", tmp])
        assert logs["simU"].shape == (2, 2)
        out = get_baseline_performances.main(["--T", "0.02", "--device", "cpu", "--out", tmp])
        assert [s.shape for s in out] == [(26, 3), (26, 3)]
        BLOCKED.discard("matplotlib")
        needs("imageio", "LiveView with a GIF", lambda: LiveView(gif_path=tmp + "/x.gif"))

        import socket
        import torch.distributed as dist
        from tum_control_tpu_torch import deploy_rt
        from tum_control_tpu_torch.parallel.distributed import (
            initialize_distributed, scaling_report)
        from tum_control_tpu_torch.tools import scaling_eval
        needs_cuda("deploy_rt", lambda: deploy_rt.main(["--cycles", "1"]))
        sim_cpu, _, _, traj_cpu, _ = build_simulation(sim, MPCConfig(), device="cpu")
        needs_cuda("scaling_report", lambda: scaling_report(sim_cpu, traj_cpu,
                                                            batch_per_device=1, steps=1))
        needs_cuda("scaling_eval", lambda: scaling_eval.main(["--steps", "1"]))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            addr = "127.0.0.1:%d" % s.getsockname()[1]
        needs_cuda("initialize_distributed", lambda: initialize_distributed(addr, 1, 0))
        assert not dist.is_initialized()
        assert initialize_distributed(addr, 1, 0, device="cpu").type == "cpu"
        assert dist.get_backend() == "gloo"
        dist.destroy_process_group()
        print("ISOLATED-OK")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED-OK" in out.stdout


# each public constructor of fresh tensors, called without a device, and
# the tensor it puts on the device it resolves
LOADERS = {
    "load_ref_trajectory": lambda **kw: load_ref_trajectory(
        os.path.join(DEFAULT_TRAJECTORY_PATH, "reftraj_monteblanco_edgar.json"), **kw).pos,
    "disturbance_config": lambda **kw: disturbance_config("gaussian", np.ones(7), **kw).magnitudes,
    "init_estimator": lambda **kw: init_estimator(3, **kw).buf,
    "init_warm": lambda **kw: init_warm(3, 154, **kw).su,
}


@pytest.mark.parametrize("loader", list(LOADERS))
def test_loaders_need_cuda_unless_given_a_device(monkeypatch, loader):
    """Without a CUDA device, each loader raises unless the caller names a
    device, as the entry points do (device.resolve_device); given
    device="cpu", its tensors lie on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LOADERS[loader]()
    assert LOADERS[loader](device="cpu").device.type == "cpu"



def test_fit_tires_needs_cuda_unless_given_a_device(monkeypatch):
    """tools/golden_attribution.py::fit_tires, a library function that makes
    its own tensors, resolves its device as the loaders do: it raises
    without a CUDA device unless the caller names one."""
    from tum_control_tpu_torch.tools import golden_attribution

    rng = np.random.default_rng(5)
    n = 4
    golden = {"simU": 0.01 * rng.standard_normal((n, 2)),
              "CiLX": np.tile([0.0, 0.0, 0.1, 20.0, 0.1, 0.02, 0.01], (n + 1, 1)),
              "MPC_SimX": np.zeros((n + 1, 8))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        golden_attribution.fit_tires(golden, 1)
    _, rms0, rms1, theta = golden_attribution.fit_tires(golden, 1, device="cpu")
    assert theta.shape == (8,) and np.isfinite([rms0, rms1]).all()