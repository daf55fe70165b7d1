"""The port's BO post-processing on the CPU: the GP surrogate slice figure
(`learn/bo/diagnostics.py`) and the entry module `python -m
tum_control_tpu_torch.bo_postprocess_parameters` on the committed trials of
Logs/bo_trials_r4.csv (2,055 trials), against the JAX package.

The export is held as tests/test_torch_bo.py holds the port's
post-processing: each group's Pareto set equal to the JAX package's, and
the reduction by the port's own k-means (scikit-learn, which the JAX
package clusters with, is not on the GPU machine), so the exported rows are
Pareto points of a group that include every group's per-objective best
points, at most n_per_group + 2 a group. The surrogate figure fits three
GPs of 300 Adam steps a group on the float64 CPU; it is drawn from the
first 150 trials of the file to keep that short (the GP math is held to JAX in test_torch_bo.py).
"""
import os

import numpy as np
import pytest
import torch

from tum_control_tpu.learn.bo import postprocess as jpost
from tum_control_tpu_torch import bo_postprocess_parameters as tpost
from tum_control_tpu_torch.config import REPO_ROOT
from tum_control_tpu_torch.learn.bo.diagnostics import surrogate_slice_plot
from tum_control_tpu_torch.learn.bo.optimizer import BayesianOptimizer, BOConfig
from tum_control_tpu_torch.learn.bo.postprocess import export_parameter_sets

TRIALS = os.path.join(REPO_ROOT, "Logs", "bo_trials_r4.csv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _optimizer():
    bo = BayesianOptimizer(evaluators=[], cfg=BOConfig(), device="cpu")
    bo.load_trials(TRIALS)
    return bo


def test_surrogate_slice_plot(tmp_path):
    """The entry module's --surrogate-plot on the file's first 150 trials
    writes both groups' figures; a group with fewer than 3 feasible trials
    raises."""
    head = tmp_path / "trials150.csv"
    with open(TRIALS) as src:
        head.write_text("".join(src.readlines()[:150]))
    stem = str(tmp_path / "s")
    tpost.main([str(head), "--out", str(tmp_path / "F150.csv"), "--surrogate-plot", stem,
                "--device", "cpu"])
    for g in (0, 1):
        assert os.path.getsize(f"{stem}_g{g}.png") > 5000
    bo = _optimizer()
    bo.trials = [t for t in bo.trials if not np.asarray(t.feasible)[0]][:10]
    with pytest.raises(ValueError, match="feasible trials"):
        surrogate_slice_plot(bo, 0, str(tmp_path / "none.png"))


def test_postprocess_entry_exports_the_pareto_sets(tmp_path):
    out = str(tmp_path / "F_new.csv")
    table = tpost.main([TRIALS, "--out", out, "--plot", str(tmp_path / "fronts.png"),
                        "--device", "cpu"])
    assert os.path.getsize(tmp_path / "fronts.png") > 5000
    assert np.loadtxt(out, delimiter=",").shape == table.shape
    trials = _optimizer().trials
    again = export_parameter_sets(trials, str(tmp_path / "again.csv"), n_per_group=13)
    np.testing.assert_array_equal(table, again)
    for g in (0, 1):
        X, Y = tpost.extract_pareto(trials, g)
        jX, jY = jpost.extract_pareto(trials, g)
        np.testing.assert_array_equal(X, jX)
        np.testing.assert_array_equal(Y, jY)
        rows = np.loadtxt(tmp_path / f"F_new_{g}.csv", delimiter=",")
        assert 2 <= len(rows) <= 13 + 2
        # each exported row is one of the group's Pareto points (4 digits in the CSV)
        for r in rows:
            assert np.isclose(X, r, rtol=1e-3, atol=0).all(axis=1).any()
        for j in range(2):
            assert np.isclose(rows, X[np.argmax(Y[:, j])], rtol=1e-3, atol=0).all(axis=1).any()
