"""WMPC over the R2NMPC and the SNMPC controllers against the JAX package,
closed loop step by step on the CPU in float64 (the nominal base and the
pieces of WMPC are in tests/test_torch_wmpc.py; split for run time).

Tolerances: logs, carried weights and corrections to 1e-8
(`test_torch_closed_loop._compare_logs`, with identical action traces and
solver statuses).
"""
import pytest
import torch

from tum_control_tpu_torch import convert

from test_torch_wmpc import F64, _close, _compare_logs, _extra_np, _wmpc_runs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("controller", ["rnmpc", "snmpc"])
def test_wmpc_over_rnmpc_and_snmpc_closed_loop_matches_jax(controller):
    """WMPC over R2NMPC (weight mods merged with the bound tightening) and
    over SNMPC (the weights reach its structured QP assembly), 25 steps with
    the policy update at step 20 inside."""
    n = 25
    carry_j, log_j, carry_t, log_t = _wmpc_runs(controller, n)
    _compare_logs(log_t, log_j, atol=1e-8)
    assert (log_t.simSolverDebug[..., 4] == 0).all()
    ex_j = convert.wmpc_extra(_extra_np(carry_j.extra), device="cpu", dtype=F64)
    _close(carry_t.extra.W, ex_j.W.numpy(), 1e-8, "W")
    assert (carry_t.extra.base is None) == (controller == "snmpc")
    if controller == "rnmpc":
        for f in ("corr_steer", "corr_acc"):
            _close(getattr(carry_t.extra.base, f), getattr(ex_j.base, f).numpy(), 1e-8, f)
