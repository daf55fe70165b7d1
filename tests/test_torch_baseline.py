"""The port's baseline sweep (`python -m tum_control_tpu_torch.
get_baseline_performances`) against the root get_baseline_performances.py
on the CPU in float64: two parameter sets of data/F.csv x Monteblanco and
LVMS (laps of different lengths, padded in the stack) x 20 steps. The npz
files and summary.csv are held key by key: the layout (names, shapes,
dtypes) equal, lat_devs, vel_devs, simU to 1e-8, status and params equal.
"""
import os
import sys

import numpy as np
import pytest
import torch

import get_baseline_performances as jsweep
from tum_control_tpu_torch import get_baseline_performances as tsweep
from tum_control_tpu_torch.config import REPO_ROOT

TRACKS = ("monteblanco", "lvms")
N_STEPS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_matches_jax_script(tmp_path, monkeypatch):
    table = np.loadtxt(os.path.join(REPO_ROOT, "data", "F.csv"), delimiter=",")[[0, 13]]
    params = tmp_path / "F2.csv"
    np.savetxt(params, table, delimiter=",")
    common = ["--T", str(N_STEPS * 0.02), "--params", str(params)]
    monkeypatch.setattr(sys, "argv", ["get_baseline_performances.py", *common, "--cpu",
                                      "--out", str(tmp_path / "jax")])
    jsweep.main()
    summaries = tsweep.main([*common, "--device", "cpu", "--out", str(tmp_path / "torch")],
                            dtype=torch.float64)
    assert len(summaries) == 2 and summaries[0].shape == (2, 3)
    for track in TRACKS:
        tdir, jdir = tmp_path / "torch" / track, tmp_path / "jax" / track
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["0.npz", "1.npz",
                                                                        "summary.csv"]
        for si in range(2):
            t, j = np.load(tdir / f"{si}.npz"), np.load(jdir / f"{si}.npz")
            assert sorted(t.files) == sorted(j.files) == sorted(
                ["lat_devs", "vel_devs", "simU", "status", "params"])
            for k in j.files:
                assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
                atol = 0 if k in ("status", "params") else 1e-8
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=atol, err_msg=f"{track} {k}")
            assert t["simU"].shape == (N_STEPS, 2) and (t["status"] == 0).all()
        np.testing.assert_allclose(np.loadtxt(tdir / "summary.csv", delimiter=","),
                                   np.loadtxt(jdir / "summary.csv", delimiter=","),
                                   rtol=0, atol=1e-8)
