"""The port's policy evaluation (`learn/evaluation.py`) against the JAX
package on the CPU in float64: `run_policy` and `action_probability_trace`
of the converted new_BO_F policy over 25 steps of Monteblanco (one policy
update, at step 20), and the PPO training history's npz round trip and
figure.

Tolerances: the WMPC closed loop agrees with the JAX run to float64
roundoff (tests/test_torch_wmpc.py), so the logs, the summary and the
action probabilities are held to 1e-8 and the actions must be equal.
"""
import os

import numpy as np
import pytest
import torch

from tum_control_tpu.learn import evaluation as jeval
from tum_control_tpu_torch.learn import evaluation as teval

MODEL = "data/wmpc_models/new_BO_F"
T = 0.5  # 25 steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_policy_matches_jax():
    logs, summary = teval.run_policy(MODEL, T=T, device="cpu", dtype=torch.float64)
    jlogs, jsummary = jeval.run_policy(MODEL, T=T)
    assert sorted(logs) == sorted(jlogs) and "RL_actions" in logs
    np.testing.assert_array_equal(logs["RL_actions"], jlogs["RL_actions"])
    assert logs["RL_actions"].shape == (25,)
    for k, v in jlogs.items():
        assert logs[k].shape == v.shape and logs[k].dtype == v.dtype, k
        np.testing.assert_allclose(logs[k], v, rtol=0, atol=1e-8, err_msg=k)
    assert sorted(summary) == sorted(jsummary)
    for k, v in jsummary.items():
        assert abs(summary[k] - v) <= 1e-8, k
    assert summary["solver_ok_frac"] == 1.0


def test_action_probability_trace_matches_jax(tmp_path):
    plot = tmp_path / "probs.png"
    probs, actions = teval.action_probability_trace(MODEL, T=T, plot_path=str(plot),
                                                    device="cpu", dtype=torch.float64)
    jprobs, jactions = jeval.action_probability_trace(MODEL, T=T)
    assert probs.shape == jprobs.shape == (25, 26)
    np.testing.assert_array_equal(actions, np.asarray(jactions))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-12)
    assert os.path.getsize(plot) > 5000


def test_training_history_roundtrip_and_plot(tmp_path):
    hist = teval.TrainingHistory([{"reward_mean": 0.5 + 0.1 * i, "loss": 1.0 / (i + 1)}
                                  for i in range(4)])
    hist.save(str(tmp_path / "h.npz"))
    back = teval.TrainingHistory.load(str(tmp_path / "h.npz"))
    assert back.history == hist.history
    assert jeval.TrainingHistory.load(str(tmp_path / "h.npz")).history == hist.history
    back.plot(str(tmp_path / "h.png"))
    assert os.path.getsize(tmp_path / "h.png") > 5000
