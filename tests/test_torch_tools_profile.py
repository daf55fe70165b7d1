"""The port's profile_step (tum_control_tpu_torch/tools/profile_step.py)
against the JAX package's tools/profile_step.py on the nominal NMPC, on the
CPU in float64 at B = 2: each stage's output (the planner window, the QP's
fields, the IPM's w, the solved u0, the plant state after the full step)
within 1e-8 of each output's max |JAX| (float64 on both sides in different
operation orders).

The JAX script runs unchanged but for its timing helper, which keeps the
stages' outputs (tests/_torch_tools_jax.py).
"""
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu_torch.tools import profile_step

B = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_profile_step_stages_match_the_jax_script(monkeypatch):
    want = jt.profile_step(monkeypatch, B)
    got = profile_step.main([str(B), "--repeats", "1", "--device", "cpu"],
                            dtype=torch.float64)["nominal"]
    assert list(got) == ["planner", "build_qp", "ipm+polish", "solve (all)", "plant+estimator",
                         "full step"]
    for f in ("pos", "yaw", "v"):
        jt.assert_close(getattr(got["planner"]["out"], f), getattr(want["planner"], f),
                        f"planner.{f}")
    for f in got["build_qp"]["out"]._fields:
        jt.assert_close(getattr(got["build_qp"]["out"], f), getattr(want["build_qp"], f),
                        f"qp.{f}")
    for name in ("ipm+polish", "solve (all)", "full step"):
        jt.assert_close(got[name]["out"], want[name], name)
    for name, r in got.items():
        assert r["ms"] > 0 and r["kernels"] is None and r["device_ms"] is None, name
        assert r["launches"] == {}, name   # the plain versions on the CPU
