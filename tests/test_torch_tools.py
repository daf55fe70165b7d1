"""The port's measurement and diagnostic tools (tum_control_tpu_torch/tools/)
on the CPU in float64, against the JAX package's scripts (tools/*.py,
imported from their paths and run unchanged but for their timing or output
helpers) where they compute something:

  * roofline's `kernel_model` equals tools/roofline.py::pallas_model at the
    shipped shape and two others (rel 1e-12: the same formulas);
  * batch_sweep, sweep_qpiters, diag_tail, diag_precision and roofline run
    with --device cpu at B = 2 and a few steps (diag_tail's maxima equal
    the port's own run_from log's), and diag_tail as
    `python -m tum_control_tpu_torch.tools.diag_tail`;
  * every tool raises without --device where there is no CUDA device.

profile_step, stage_bench and snmpc_dissect are held to the JAX scripts in
tests/test_torch_tools_{profile,stages,snmpc,dissect}.py, dump_qps in
tests/test_torch_tools_qps.py.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu_torch.tools import (
    batch_sweep, diag_precision, diag_tail, roofline, sweep_qpiters,
)

F64 = torch.float64
CPU = ["--device", "cpu"]
TOOLS = ("batch_sweep", "profile_step", "stage_bench", "snmpc_dissect", "roofline",
         "sweep_qpiters", "diag_tail", "diag_precision", "dump_qps")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [{}, dict(N=20, nx=8, nu=2, qp_iters=3),
                                   dict(N=50, nx=6, nu=3, qp_iters=6, n_polish=2, substeps=1)])
def test_kernel_model_equals_pallas_model(shape):
    want = jt.load_script("roofline").pallas_model(**shape)
    got = roofline.kernel_model(**shape)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-12 * abs(w)


def test_batch_sweep_on_the_cpu():
    rows = batch_sweep.main(["2", "3", "--steps", "2", "--settle", "1"] + CPU, dtype=F64)
    assert [r["batch"] for r in rows] == [2, 3] and rows[0]["rel_eff"] == 1.0
    for r in rows:
        assert r["ok"] == 1.0 and r["solves_per_s"] > 0 and np.isfinite(r["p99_lat_dev"])


def test_sweep_qpiters_on_the_cpu():
    rows = sweep_qpiters.main(["2", "3", "--batch", "2", "--steps", "2", "--settle", "1"] + CPU,
                              dtype=F64)
    assert [r["qp_iters"] for r in rows] == [2, 3]
    for r in rows:
        assert r["ok"] == 1.0 and r["solves_per_s"] > 0 and r["p50"] <= r["p99"] <= r["max"]


def test_diag_tail_maxima_equal_the_run_from_log():
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    res = diag_tail.main(["2", "3", "--settle", "2"] + CPU, dtype=F64)
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=0.06), MPCConfig(),
                                          device="cpu", dtype=F64)
    x0m, x0s = batched_scenarios(traj, 2, dtype=F64)
    c0, slog = sim.run(x0m, x0s, 2)
    _, log = sim.run_from(c0, 3)
    np.testing.assert_array_equal(res["run_max"], log.lat_dev.abs().amax(1).numpy())
    np.testing.assert_array_equal(res["settle_max"], slog.lat_dev.abs().amax(1).numpy())
    assert res["max"] == res["run_max"].max() and res["ok"] == 1.0
    assert [w["scen"] for w in res["worst"]] == list(np.argsort(res["run_max"]))


def test_diag_precision_on_the_cpu(capsys):
    """The five scenarios run; --tf32 changes nothing on the CPU, says so
    and leaves the flags alone."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    argv = ["--steps", "2", "--settle", "1"] + CPU
    rows = diag_precision.main(argv, dtype=F64)
    assert [r["scen"] for r in rows] == diag_precision.SCENARIOS
    assert all(r["ok"] for r in rows)
    assert diag_precision.main(["--tf32"] + argv, dtype=F64) == rows
    assert "on the CPU" in capsys.readouterr().out
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


def test_roofline_on_the_cpu():
    res = roofline.main(["2", "3", "--steps", "2"] + CPU, dtype=F64)
    assert [r["batch"] for r in res["rows"]] == [2, 3]
    for r in res["rows"]:
        assert r["ms"] > 0 and r["device_ms"] is None and r["kernels"] is None
    assert set(res["stages"]) == {2, 3}


def test_diag_tail_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=jt.REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "tum_control_tpu_torch.tools.diag_tail", "2", "2",
                          "--settle", "1"] + CPU, cwd=jt.REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok frac 1.0" in out.stdout


@pytest.mark.parametrize("name", TOOLS)
def test_tool_needs_cuda_unless_given_a_device(name, monkeypatch):
    """Without --device a tool resolves to cuda, and raises where there is
    none, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"tum_control_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
