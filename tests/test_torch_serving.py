"""The port's serving path on the CPU: the native executor built from the
port's own csrc/rt_runtime.cc (cycle clock, telemetry round trip, miss
detection, the record layout of the JAX binding), the entry module
`python -m tum_control_tpu_torch.deploy_rt` in its synchronous mode
against the JAX package's closed loop, its pipelined mode, and the
host-jitter tool.

The served controls are held to JAX's `sim.run` simU from the same start to
float32 rounding of the telemetry record (it stores f4): max |u - u_jax| <=
1e-6 of max |simU|. Both loops run in float64 (`main(argv,
dtype=torch.float64)`), as tests/test_torch_main.py drives the port's
main: a float32 closed loop parts from float64 within 20 steps.
"""
import os
import time

import numpy as np
import pytest
import torch

import jax

from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.utils import rt_runtime as j_rt
from tum_control_tpu_torch import deploy_rt
from tum_control_tpu_torch.tools import host_jitter
from tum_control_tpu_torch.utils import rt_runtime
from tum_control_tpu_torch.utils.rt_runtime import RealtimeExecutor, read_telemetry

CYCLES = 10
TOL_U = 1e-6  # of max |simU|: the record's float32 rounding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_executor_cycle_and_telemetry(tmp_path):
    """As tests/test_runtime.py holds the JAX binding: 50 cycles at 2 ms,
    their spacing, the stats and the binary export read back; the library
    is the port's own build under build/runtime/."""
    ex = RealtimeExecutor(period_s=0.002, ring_capacity=1024)
    assert os.path.dirname(rt_runtime.lib_path()).endswith(os.path.join("build", "runtime"))
    assert os.path.exists(rt_runtime.lib_path())
    starts = []
    for i in range(50):
        t0 = ex.begin_cycle()
        starts.append(t0)
        ex.record(t0, 100_000 + i, 0, 1.5, 0.01, -0.2, 0.3, 0.004)
    stats = ex.stats()
    assert stats["cycles"] == 50
    d = np.diff(starts) / 1e6
    assert np.median(d) == pytest.approx(2.0, rel=0.3)

    path = str(tmp_path / "tele.bin")
    assert ex.export(path) == 50
    rec = read_telemetry(path)
    assert rec.shape[0] == 50
    assert rec["status"].max() == 0
    assert rec["solve_ns"][0] == 100_000
    np.testing.assert_array_equal(rec["cycle"], np.arange(50))
    np.testing.assert_allclose(rec["cost"], 1.5)
    np.testing.assert_allclose(rec["u1"], np.float32(0.004))
    ex.close()


def test_deadline_miss_detection():
    ex = RealtimeExecutor(period_s=0.001)
    ex.begin_cycle()
    time.sleep(0.01)  # blow through several deadlines
    ex.begin_cycle()
    assert ex.stats()["deadline_misses"] >= 1
    ex.close()


def test_telemetry_layout_matches_jax():
    """The record's numpy dtype, and the statistics struct's fields, are the
    JAX binding's: telemetry files are interchangeable."""
    assert rt_runtime._TELEMETRY_DTYPE == j_rt._TELEMETRY_DTYPE
    assert rt_runtime._TELEMETRY_DTYPE.itemsize == 48
    assert rt_runtime._Stats._fields_ == j_rt._Stats._fields_


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    falls back to Python timing."""
    bad = tmp_path / "rt_runtime.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rt_runtime, "SOURCE", str(bad))
    monkeypatch.setattr(rt_runtime, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        rt_runtime.build()


@pytest.fixture(scope="module")
def jax_log():
    """JAX's closed loop over CYCLES steps from the served start."""
    jsim, x0m, x0s, _, _ = j_build_simulation(JSim(sim_mode=0, T=CYCLES * 0.02), JMPC())
    return jax.jit(lambda: jsim.run(x0m, x0s, CYCLES))()[1]


def test_deploy_rt_synchronous_matches_jax(tmp_path, jax_log):
    """10 served cycles on the CPU: 10 records, every status 0, finite
    fields, and the applied controls u0/u1 those of JAX's closed loop from
    the same start (TOL_U)."""
    tele = str(tmp_path / "tele.bin")
    out = deploy_rt.main(["--device", "cpu", "--cycles", str(CYCLES), "--telemetry", tele],
                         dtype=torch.float64)
    assert out["mode"] == "synchronous" and out["exported"] == CYCLES
    assert out["stats"]["cycles"] == CYCLES
    rec = read_telemetry(tele)
    assert rec.shape == (CYCLES,)
    assert (rec["status"] == 0).all()
    for f in ("cost", "lat_dev", "vel_dev", "u0", "u1"):
        assert np.isfinite(rec[f]).all(), f
    assert (rec["solve_ns"] > 0).all()

    log = jax_log
    simU = np.asarray(log.simU)
    u = np.stack([rec["u0"], rec["u1"]], axis=1).astype(np.float64)
    gap = np.abs(u - simU).max(axis=0)
    assert (gap <= TOL_U * np.abs(simU).max(axis=0)).all(), (gap, np.abs(simU).max(axis=0))
    np.testing.assert_allclose(rec["lat_dev"], np.asarray(log.lat_dev), rtol=1e-6, atol=1e-7)


def test_deploy_rt_pipelined(tmp_path, jax_log):
    """--pipeline 2 on the CPU: every cycle recorded with status 0, the
    counts of the serving loop returned and consistent, and each cycle's
    applied control that of the step it applied (apply_log) in JAX's closed
    loop (TOL_U)."""
    tele = str(tmp_path / "tele.bin")
    out = deploy_rt.main(["--device", "cpu", "--cycles", str(CYCLES), "--pipeline", "2",
                          "--telemetry", tele], dtype=torch.float64)
    assert out["mode"] == "pipeline=2" and out["exported"] == CYCLES
    rec = read_telemetry(tele)
    assert rec.shape == (CYCLES,)
    assert (rec["status"] == 0).all()
    assert np.isfinite(rec["u0"]).all() and np.isfinite(rec["u1"]).all()
    assert 1 <= out["distinct_controls"] <= CYCLES
    assert out["stale_cycles"] == CYCLES - out["distinct_controls"]
    assert out["late_env"] + out["late_app"] == out["late_starts"]
    assert out["age"]["completion_p50"] > 0
    seq = out["apply_log"]
    assert seq.shape == (CYCLES,) and (np.diff(seq) >= 0).all()
    assert len(set(seq.tolist())) == out["distinct_controls"]
    simU = np.asarray(jax_log.simU)[seq]
    u = np.stack([rec["u0"], rec["u1"]], axis=1).astype(np.float64)
    gap = np.abs(u - simU).max(axis=0)
    assert (gap <= TOL_U * np.abs(np.asarray(jax_log.simU)).max(axis=0)).all(), gap


def test_deploy_rt_needs_a_device_or_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy_rt.main(["--cycles", "1"])


def test_host_jitter_empty_loop(capsys):
    stats = host_jitter.main(["--cycles", "20", "--period", "0.002"])
    assert stats["cycles"] == 20
    assert "empty-loop misses" in capsys.readouterr().out
