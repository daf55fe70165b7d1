"""The port's evaluation layer against the JAX package on the CPU in float64:
log assembly (`eval/logger.py`), the evaluation summary and its npz split,
disturbance playback from a log file, the figures, the live view and its
GIFs, and checkpoints.

Tolerances: the logs of a 30-step closed loop agree to 1e-8 (the closed
loops agree to float64 roundoff, tests/test_torch_closed_loop.py); functions
of the same numpy logs are held to equality.
"""
import os

import numpy as np
import pytest
import torch

import jax

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.eval import logger as jlogger
from tum_control_tpu.sim.disturbances import load_playback as j_load_playback
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.eval import logger, plots
from tum_control_tpu_torch.eval.live_viz import LiveView, animate
from tum_control_tpu_torch.sim.closed_loop import SimLog
from tum_control_tpu_torch.sim.disturbances import load_playback
from tum_control_tpu_torch.utils.checkpoint import load_pytree, save_pytree

F64 = torch.float64
N = 30
FIGURES = ("SimResults.png", "SimResBoxplots.png", "MPC_performance.png", "TrackSim.png",
           "GGDiagram.png", "StateErrors.png")
DISTURBED = dict(simulate_disturbances=True, simulate_state_estimation=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(n, mpc=None, key=0, playback=None, **sim_kw):
    """One scenario of the port's closed loop: (log (1, n, ...), x0m (8,),
    x0s (7,), track, sim)."""
    sim, x0m, x0s, _, track = build_simulation(SimConfig(sim_mode=0, T=n * 0.02, **sim_kw),
                                               mpc or MPCConfig(), device="cpu", dtype=F64)
    _, log = sim.run(x0m[None], x0s[None], n, key=key, playback=playback)
    return log, x0m, x0s, track, sim


@pytest.fixture(scope="module")
def nominal():
    log, x0m, x0s, track, _ = _run(N)
    return log, x0m, x0s, track, logger.assemble_logs(log, x0m[None], x0s[None], N * 0.02,
                                                      scenario=0)


def test_assemble_logs_matches_jax(nominal):
    """30 nominal steps on Monteblanco: the port's logs against the JAX
    package's assemble_logs of its own run, key by key (names, shapes,
    dtypes, values to 1e-8); a batched log with `scenario` and the indexed
    log give the same arrays, and step_times fill simSolverDebug[:, 1]."""
    log, x0m, x0s, _, logs = nominal
    jsim, jx0m, jx0s, *_ = j_build_simulation(JSim(sim_mode=0, T=N * 0.02), JMPC())
    _, jlog = jax.jit(lambda: jsim.run(jx0m, jx0s, N, key=jax.random.PRNGKey(0)))()
    jlogs = jlogger.assemble_logs(jlog, jx0m, jx0s, N * 0.02)
    assert sorted(logs) == sorted(jlogs) and len(logs) == 14
    for k, v in jlogs.items():
        assert logs[k].shape == v.shape and logs[k].dtype == v.dtype, k
        np.testing.assert_allclose(logs[k], v, rtol=0, atol=1e-8, err_msg=k)
    assert np.all(logs["CiLX"][:, 2] >= 0) and np.all(logs["CiLX"][:, 2] < 2 * np.pi)

    times = np.full(N, 1.25e-3)
    one = SimLog(*(f[0] for f in log))
    indexed = logger.assemble_logs(one, x0m, x0s, N * 0.02, step_times=times)
    np.testing.assert_array_equal(indexed["simSolverDebug"][:, 1], times)
    for k, v in logs.items():
        if k != "simSolverDebug":
            np.testing.assert_array_equal(indexed[k], v, err_msg=k)


def test_evaluation_splits_wmpc_logs(tmp_path):
    """A 45-step WMPC run (two policy updates): RL_actions go to
    RL_WMPC_logs.npz with t and the 26 weight sets, full_logs.npz keeps the
    rest with the solve times; the summary and both files equal the JAX
    package's evaluation of the same logs."""
    n = 45
    mpc = MPCConfig(enable_WMPC=True, WMPC_model="data/wmpc_models/new_BO_F")
    log, x0m, x0s, _, sim = _run(n, mpc)
    times = np.full(n, 1.25e-3)
    logs = logger.assemble_logs(log, x0m[None], x0s[None], n * 0.02, step_times=times,
                                scenario=0)
    assert logs["RL_actions"].shape == (n,) and logs["RL_actions"].dtype == np.int32
    assert ((logs["RL_actions"] >= 0) & (logs["RL_actions"] < 26)).all()
    sets = sim.controller.param_table
    kw = dict(save=True, make_plots=False, timestamp=False, wall_time=0.05)
    summary = logger.evaluation(logs, logs_path=str(tmp_path), run_name="t", wmpc_sets=sets, **kw)
    jsummary = jlogger.evaluation(logs, logs_path=str(tmp_path), run_name="j",
                                  wmpc_sets=sets.numpy(), **kw)
    assert summary == jsummary
    wmpc = np.load(tmp_path / "t" / "RL_WMPC_logs.npz")
    assert sorted(wmpc.files) == ["RL_actions", "WMPC_sets", "t"]
    assert wmpc["WMPC_sets"].shape == (26, 7)
    full = np.load(tmp_path / "t" / "full_logs.npz")
    assert "RL_actions" not in full.files
    np.testing.assert_array_equal(full["simSolverDebug"][:, 1], times)
    for name in ("RL_WMPC_logs.npz", "full_logs.npz"):
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_load_playback_roundtrip(tmp_path):
    """Record a disturbed run to full_logs.npz and replay the realization
    from the file with another seed (as tests/test_closed_loop.py does for
    the JAX package): load_playback reads what the JAX package's reads (and
    zero-pads a longer request), the replayed disturbances equal the
    recording and the plant trace agrees to 1e-12."""
    n = 20
    log, x0m, x0s, _, _ = _run(n, key=3, **DISTURBED)
    logs = logger.assemble_logs(log, x0m[None], x0s[None], n * 0.02, scenario=0)
    logger.save_logs(logs, str(tmp_path / "full_logs.npz"))
    w_d, w_s = load_playback(str(tmp_path), "full_logs.npz", n, dtype=F64, device="cpu")
    assert w_d.shape == (n, 7) and w_d.dtype == F64
    for a, b in zip((w_d, w_s), j_load_playback(str(tmp_path), "full_logs.npz", n)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    padded = load_playback(str(tmp_path), str(tmp_path / "full_logs.npz"), n + 5, dtype=F64,
                           device="cpu")
    assert (padded[0][n:] == 0).all() and torch.equal(padded[1][:n], w_s)

    play, *_ = _run(n, key=99, playback=(w_d[None], w_s[None]), disturbance_playback=True,
                    **DISTURBED)
    assert torch.equal(play.dist_deriv, log.dist_deriv)
    assert torch.equal(play.dist_se, log.dist_se)
    np.testing.assert_allclose(play.CiLX.numpy(), log.CiLX.numpy(), rtol=0, atol=1e-12)


def test_plot_all_writes_figures(tmp_path, nominal):
    *_, track, logs = nominal
    plots.plot_all(logs, str(tmp_path), track=track)
    for f in FIGURES:
        assert os.path.getsize(tmp_path / f) > 5000, f
    assert not (tmp_path / "Disturbances.png").exists()
    plots.plot_disturbances(dict(logs, sim_disturbance_derivatives=np.ones((N, 7))),
                            str(tmp_path / "Disturbances.png"))
    assert os.path.getsize(tmp_path / "Disturbances.png") > 5000


def test_live_view_and_animate_gifs(tmp_path, nominal):
    """Replay GIFs in both modes, and the during-sim view fed partial logs
    at three chunk boundaries."""
    log, x0m, x0s, track, logs = nominal
    n2 = animate(logs, track=track, mode=2, frame_skip=10, gif_path=str(tmp_path / "run.gif"))
    assert n2 >= 2 and os.path.getsize(tmp_path / "run.gif") > 1000
    assert animate(logs, track=track, mode=1, frame_skip=15,
                   gif_path=str(tmp_path / "m1.gif")) >= 1
    view = LiveView(track=track, mode=2, gif_path=str(tmp_path / "live.gif"))
    for k in (10, 20, 30):
        part = SimLog(*(f[0, :k] for f in log))
        view.update(logger.assemble_logs(part, x0m, x0s, k * 0.02), k)
    assert view.finish() == 3
    assert os.path.getsize(tmp_path / "live.gif") > 1000


@pytest.mark.parametrize("what", ["dict", "sim_carry"])
def test_checkpoint_roundtrip(tmp_path, what):
    """A dict of tensors and numbers, and a disturbed closed loop's SimCarry
    (NamedTuples, the controller's warm start, the estimator, the
    generator): restored equal, and the restored carry continues exactly as
    the original (the same draws and the same solves)."""
    path = str(tmp_path / "ck.pt")
    if what == "dict":
        tree = {"w": torch.arange(6.0).reshape(2, 3), "step": torch.tensor(7), "lr": 3e-4,
                "nested": (torch.ones(2), None)}
        save_pytree(path, tree)
        out = load_pytree(path, {"w": torch.zeros(2, 3), "step": torch.tensor(0), "lr": 0.0,
                                 "nested": (torch.zeros(2), None)})
        assert torch.equal(out["w"], tree["w"]) and int(out["step"]) == 7
        assert out["lr"] == 3e-4 and torch.equal(out["nested"][0], torch.ones(2))
        assert out["nested"][1] is None
        return
    sim, x0m, x0s, *_ = build_simulation(SimConfig(sim_mode=0, **DISTURBED), MPCConfig(),
                                         device="cpu", dtype=F64)
    carry, _ = sim.run(x0m[None], x0s[None], 2, key=5)
    save_pytree(path, carry)
    restored = load_pytree(path, sim.init_carry(x0m[None], x0s[None], key=0))
    assert type(restored) is type(carry)
    assert torch.equal(restored.key.get_state(), carry.key.get_state())
    _, a = sim.run_from(carry, 2)
    _, b = sim.run_from(restored, 2)
    for f, x, y in zip(SimLog._fields, a, b):
        assert torch.equal(x, y), f
    with pytest.raises(ValueError):
        load_pytree(path, {"w": torch.zeros(2)})
