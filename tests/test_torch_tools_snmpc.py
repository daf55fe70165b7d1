"""The port's stage_bench (tum_control_tpu_torch/tools/stage_bench.py) on
the SNMPC against the JAX package's tools/stage_bench.py, on the CPU in
float64 at B = 2: each chained stage's carry after R = 2 iterations (the
planner's pose, the stacked RTI state after build_qp's feedback, the IPM's
warm start, the RTI state after two solves, the closed-loop carry after two
steps), within 1e-8 of each output's max |JAX| (float64 on both sides in
different operation orders).

The JAX script runs unchanged but for its timing helper, which keeps the
stages' carries (tests/_torch_tools_jax.py).
"""
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu_torch.tools import stage_bench

B, R = 2, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_bench_snmpc_chained_carries_match_the_jax_script(monkeypatch):
    want = jt.chained("stage_bench", monkeypatch, [B, R, "snmpc"])
    got = stage_bench.main([str(B), str(R), "snmpc", "--device", "cpu"], dtype=torch.float64)
    assert set(want) == {"planner", "build_qp", "ipm", "solve", "full step"}
    for name, w in want.items():
        jt.hold_carry(name, got[name]["carry"], w)
    assert got["build_qp"]["carry"].X.shape == (B, 39, 88)
