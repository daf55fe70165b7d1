"""The nominal NMPC's combined-acceleration constraint shapes 0 (separate
limits) and 1 (diamond), options no other port test drives, in closed loop
against the JAX package on the CPU in float64, held as
tests/test_torch_external.py holds its options (states, inputs and
deviations to 1e-8, equal iteration counts and statuses).
"""
import pytest
import torch

from test_torch_external import check_option_closed_loop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [0, 1])
def test_combined_acc_limits_closed_loop_matches_jax(shape):
    check_option_closed_loop(dict(combined_acc_limits=shape))
