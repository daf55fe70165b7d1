"""The port's entry point `python -m tum_control_tpu_torch.main` against the
root main.py on the CPU in float64: the same shipped YAML configs, the same
20 closed-loop steps, `full_logs.npz` key by key to 1e-8 (the timing column
simSolverDebug[:, 1] excepted: > 0 in both); its disturbance playback, its
live view with the GIF and the figures, and the empty-playback-file error.
"""
import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch

import main as jmain
from tum_control_tpu_torch import main as tmain
from tum_control_tpu_torch.config import DEFAULT_CONFIG_PATH, load_mpc_config, load_sim_config
from tum_control_tpu_torch.eval.logger import save_logs

F64 = torch.float64
FIGURES = ("SimResults.png", "SimResBoxplots.png", "MPC_performance.png", "TrackSim.png",
           "GGDiagram.png", "StateErrors.png")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shipped(**sim_kw):
    sim = load_sim_config(os.path.join(DEFAULT_CONFIG_PATH, "EDGAR/sim_main_params.yaml"))
    mpc = load_mpc_config(os.path.join(DEFAULT_CONFIG_PATH, "EDGAR/MPC_params.yaml"))
    return dataclasses.replace(sim, **sim_kw), mpc


def _full_logs(logs_path):
    (path,) = glob.glob(os.path.join(logs_path, "run*", "full_logs.npz"))
    return np.load(path)


def test_main_matches_jax_main(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["main.py", "--T", "0.4", "--no-plots", "--cpu",
                                      "--logs-path", str(tmp_path / "jax")])
    jmain.main()
    tmain.main(["--T", "0.4", "--no-plots", "--device", "cpu", "--logs-path",
                str(tmp_path / "torch")], dtype=F64)
    j, t = _full_logs(str(tmp_path / "jax")), _full_logs(str(tmp_path / "torch"))
    assert sorted(t.files) == sorted(j.files) and len(t.files) == 14
    for k in j.files:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        if k == "simSolverDebug":
            assert (t[k][:, 1] > 0).all() and (j[k][:, 1] > 0).all()
            a, b = np.delete(t[k], 1, axis=1), np.delete(j[k], 1, axis=1)
        else:
            a, b = t[k], j[k]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8, err_msg=k)
    assert t["MPC_SimX"].shape == (21, 8) and t["CiLX"].shape == (21, 7)
    assert (t["simSolverDebug"][:, 4] == 0).all()


def test_main_replays_recorded_disturbances(tmp_path):
    """A run with both disturbance kinds, saved as full_logs.npz, replayed
    through `disturbance_playback` with another seed: the disturbances equal
    the recording, and so does the closed loop (to 1e-12)."""
    rec_cfg, mpc = _shipped(T=0.2, simulate_disturbances=True, simulate_state_estimation=True,
                            save_logs=False)
    rec, _, _ = tmain.run_main(rec_cfg, mpc, device="cpu", dtype=F64, logs_path=str(tmp_path),
                               seed=3, make_plots=False)
    assert np.abs(rec["sim_disturbance_derivatives"]).max() > 0
    assert np.abs(rec["sim_disturbance_state_estimation"]).max() > 0
    save_logs(rec, str(tmp_path / "rec" / "full_logs.npz"))
    play_cfg = dataclasses.replace(rec_cfg, disturbance_playback=True,
                                   playback_log_file="rec/full_logs.npz")
    play, _, _ = tmain.run_main(play_cfg, mpc, device="cpu", dtype=F64,
                                logs_path=str(tmp_path), seed=99, make_plots=False)
    for k in ("sim_disturbance_derivatives", "sim_disturbance_state_estimation"):
        np.testing.assert_array_equal(play[k], rec[k])
    np.testing.assert_allclose(play["CiLX"], rec["CiLX"], rtol=0, atol=1e-12)

    with pytest.raises(ValueError, match="playback_log_file is empty"):
        tmain.run_main(dataclasses.replace(play_cfg, playback_log_file=""), mpc, device="cpu",
                       dtype=F64, logs_path=str(tmp_path), make_plots=False)


def test_main_live_view_gif_and_figures(tmp_path):
    """Live visualization (mode 2, chunks of live_plot_freq = 10 steps, the
    render thread) with GIF export and the evaluation figures; the logs
    equal a run without the live view."""
    cfg, mpc = _shipped(T=0.4, live_visualization=2, GIF_animation_generation=True,
                        GIF_file_name="live.gif", file_logs_name="live")
    logs, summary, _ = tmain.run_main(cfg, mpc, device="cpu", dtype=F64,
                                      logs_path=str(tmp_path), make_plots=True)
    assert os.path.getsize(tmp_path / "live.gif") > 1000
    (run_dir,) = glob.glob(os.path.join(str(tmp_path), "live*", ""))
    for f in FIGURES:
        assert os.path.getsize(os.path.join(run_dir, f)) > 5000, f
    assert summary["solver_ok_frac"] == 1.0
    plain, _, _ = tmain.run_main(dataclasses.replace(cfg, live_visualization=0, save_logs=False),
                                 mpc, device="cpu", dtype=F64, make_plots=False)
    for k, v in plain.items():
        if k != "simSolverDebug":
            np.testing.assert_array_equal(logs[k], v, err_msg=k)
