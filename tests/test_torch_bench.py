"""The port's benchmark entry (tum_control_tpu_torch/bench.py) on the CPU:

  * `measure` at B = 2, 3 settle steps and 5 timed steps of the nominal NMPC
    in float64 against the root bench.py's protocol run with the JAX
    package's functions (build_simulation, batched_scenarios, the vmapped
    closed-loop step of `run` / `run_from`, driven step by step so that one
    compile serves the settle and the timed window): the timed window's
    lat_dev within 1e-8 m, the solver statuses equal;
  * `main` prints bench.py's JSON as its last line: exactly its four keys, a
    positive value, vs_baseline = value / 974.7 to its 2 decimals;
  * without a card and without --device, it raises.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu_torch import bench

BATCH, SETTLE, STEPS = 2, 3, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_protocol():
    """bench.py's settle and timed window at BATCH x (SETTLE, STEPS): the
    vmapped step of JAX's scan (`run` = init_carry + steps 0..SETTLE-1,
    `run_from` = steps 0..STEPS-1 from the settled carry)."""
    from tum_control_tpu.api import build_simulation
    from tum_control_tpu.config import MPCConfig, SimConfig
    from tum_control_tpu.parallel.mesh import batched_scenarios

    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=STEPS * 0.02),
                                          MPCConfig(qp_iters=MPCConfig().qp_iters))
    x0m_b, x0s_b = batched_scenarios(traj, BATCH)
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    zero = jnp.zeros(7)
    step = jax.jit(jax.vmap(lambda c, k: sim.step(c, (k, zero, zero)), in_axes=(0, None)))
    carry = jax.vmap(sim.init_carry)(x0m_b, x0s_b, keys)
    for k in range(SETTLE):
        carry, _ = step(carry, k)
    logs = []
    for k in range(STEPS):
        carry, log = step(carry, k)
        logs.append(log)
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs], axis=1), *logs)


def test_measure_matches_the_jax_protocol(monkeypatch):
    monkeypatch.delenv("BENCH_QP_ITERS", raising=False)
    res = bench.measure(BATCH, STEPS, SETTLE, device="cpu", dtype=torch.float64)
    log = res["logs"]["nominal"]
    ref = _jax_protocol()
    assert log.lat_dev.shape == (BATCH, STEPS)
    np.testing.assert_allclose(log.lat_dev.numpy(), ref.lat_dev, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(log.simSolverDebug[..., 4].numpy(), ref.simSolverDebug[..., 4])
    assert res["solves_per_sec"] > 0 and res["ok"] == 1.0
    assert res["single_ms"] > 0 and res["logs"]["single"].lat_dev.shape == (1, STEPS)
    for name in ("snmpc", "rnmpc"):
        c = res["controllers"][name]
        assert c["steps"] == STEPS and c["solves_per_sec"] > 0 and c["ok"] == 1.0
        assert c["vs_ref_single_stream"] == pytest.approx(
            c["solves_per_sec"] * bench.REF_SINGLE_STREAM_MS[name] / 1e3)
        assert torch.isfinite(res["logs"][name].lat_dev).all()
    assert len(res["stderr"]) == 6


def test_main_prints_the_bench_json_line(capsys, monkeypatch):
    monkeypatch.setattr(bench, "SETTLE", 2)   # of 100: the line's form is what is held
    out = bench.main(["2", "3", "--device", "cpu"])
    printed = capsys.readouterr()
    last = json.loads(printed.out.strip().splitlines()[-1])
    assert last == out["json"]
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "nmpc_solves_per_sec" and last["unit"] == "solve/s"
    assert last["value"] > 0
    # bench.py's baseline is 1 / 1.026 ms = 974.66 solve/s, the value rounded to 0.1
    assert last["vs_baseline"] == pytest.approx(last["value"] / 974.7, abs=0.0051)
    assert "solves/s" in printed.err and "single-stream per-step latency" in printed.err


def test_needs_cuda_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["2", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure(2, 1, 1)
