"""The frozen float64 reference against the port's plain path on the CPU
in float64, step by step from the port's own carries, and what the
reference loads."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run as R
from benchmark.compare import carry_tensors
from benchmark.reference.closed_loop import Reference


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config,batch,steps", [("nominal", 3, 3), ("snmpc", 2, 2)])
def test_reference_agrees_with_the_port_in_float64(config, batch, steps):
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    from benchmark.program import settings

    cfg = json.load(open(os.path.join(R.ROOT, "benchmark", "configs", f"{config}.json")))
    sim, _, _, traj, _ = build_simulation(*settings(cfg), device="cpu", dtype=torch.float64)
    carry = sim.init_carry(*batched_scenarios(traj, batch))
    ref = Reference(cfg, R.ROOT, dtype=torch.float64, device="cpu")
    zeros = torch.zeros_like(carry.x_sim)
    for _ in range(steps):
        out = ref.step(carry_tensors(carry))
        carry, log = sim.step(carry, zeros, zeros)
        new = carry_tensors(carry)
        assert torch.equal(out["status"], log.simSolverDebug[:, 4].to(torch.int32))
        assert (out["u0"] - log.simU).abs().max() <= 1e-9 * (1 + log.simU.abs().max())
        for key in ("X", "U", "x_sim", "x_est", "est_buf", "pose"):
            assert (out[key] - new[key]).abs().max() <= 1e-9 * (1 + new[key].abs().max()), key
        for a, b in zip(out["warm"], new["warm"]):
            assert (a - b).abs().max() <= 1e-8 * (1 + b.abs().max())


def test_reference_loads_nothing_of_the_port():
    """In a fresh process: build the reference of each configuration and run
    a step from a hand-made carry (the disturbed one drawing from a CPU
    generator's state); no module of the port, of the JAX package or of JAX
    is loaded."""
    code = r"""
import sys, json, torch
sys.path.insert(0, ROOT)
from benchmark.reference.closed_loop import Reference, CARRY_KEYS
for name in ("nominal", "snmpc", "snmpc_disturbed"):
    cfg = json.load(open(ROOT + "/benchmark/configs/" + name + ".json"))
    ref = Reference(cfg, ROOT)
    x = torch.tensor([[0.0, 0.0, 0.1, 20.0, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    xs = ref._stack(x)
    N, nc = ref.N, ref.prob.con_lb.numel() + ref.prob.u_lb.numel()
    c = dict(X=xs[:, None].expand(1, N + 1, xs.shape[1]).clone(), U=torch.zeros(1, N, 2),
             warm=tuple(torch.ones(1, nc) for _ in range(6)), x_sim=x[:, :7], x_est=x,
             est_buf=torch.zeros(1, 8, 15), est_count=torch.zeros(1, dtype=torch.int32),
             pose=x[:, :2], gen_state=torch.Generator().manual_seed(1).get_state())
    out = ref.step(c)
    assert torch.isfinite(out["u0"]).all()
loaded = sorted({m.split(".")[0] for m in sys.modules}
                & {"tum_control_tpu_torch", "tum_control_tpu", "jax", "jaxlib", "flax"})
print(json.dumps(loaded))
"""
    out = subprocess.run([sys.executable, "-c", f"ROOT = {R.ROOT!r}\n" + code],
                         capture_output=True, text=True, timeout=300, cwd=R.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
