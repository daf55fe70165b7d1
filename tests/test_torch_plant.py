"""The plant's RK4 wrapper (tum_control_tpu_torch/ops/kernels/plant.py) on
the CPU, where it runs the plain version: the plant's ODE object
integrates bit for bit as the plain RK4 over sim_ode / sim_ode_disturbed,
with shared tires, 0-d tensor tires and one tire set per scenario; new
tires rebuild the plant's constants and tire table; tensors on no supported
device are refused; and the closed loop integrates the plant through
`sim/closed_loop.py::rk4_multistep`, the entry point that the benchmark's
`plant_rk4` span wraps (benchmark/tracing.py), once a step and twice with a
derivative disturbance. The kernel runs only on the card
(tests/test_torch_cuda.py)."""
import math

import pytest
import torch

from chip_smoke import plant_case
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import sim_ode, sim_ode_disturbed
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels.linearize import kernel_params
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.sim import closed_loop

B = 16


@pytest.mark.parametrize("disturbed", [False, True])
@pytest.mark.parametrize("tires", ["shared", "one", "per"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plant_ode_integrates_as_the_plain_rk4(tires, disturbed, dtype):
    plant, x, u, w = plant_case(B, tires, "cpu", dtype)
    vp, tp = plant.vp, plant.tp
    if disturbed:
        ode, f = plant.ode(w), lambda a, b: sim_ode_disturbed(a, b, w, vp, tp)
    else:
        ode, f = plant.ode(), lambda a, b: sim_ode(a, b, vp, tp)
    assert torch.equal(ode(x, u), f(x, u))
    got = rk4_multistep(ode, x, u, plant.dt, plant.n_sub)
    want = rk4_multistep(f, x, u, plant.dt, plant.n_sub)
    assert torch.equal(got, want)
    # another step size or substep count integrates as the plain RK4 too
    assert torch.equal(rk4_multistep(ode, x, u, 0.08, 3), rk4_multistep(f, x, u, 0.08, 3))


def test_new_tires_rebuild_the_plant():
    """set_tires (and assigning tp_sim) rebuild the plant: tensor tires get a
    device table (one row a scenario) and NaN in the parameter block's tire
    slots, float tires the block of those floats and no table; the tires
    read back are the very object given (the served graph's key)."""
    sim = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device="cpu",
                           dtype=torch.float64)[0]
    tp0 = sim.tp_sim
    assert sim.plant.table is None
    assert list(sim.plant.prm) == list(kernel_params(sim.vp_sim, tp0, sim.Ts,
                                                     closed_loop.PLANT_SUBSTEPS))
    tpB = plant_case(B, "per")[0].tp
    sim.set_tires(tpB)
    assert sim.tp_sim is tpB and sim.controller.tp is tpB
    assert sim.plant.table.shape == (B, 12) and math.isnan(sim.plant.prm[14])
    sim.tp_sim = tp0
    assert sim.tp_sim is tp0 and sim.plant.table is None
    assert list(sim.plant.prm) == list(kernel_params(sim.vp_sim, tp0, sim.Ts,
                                                     closed_loop.PLANT_SUBSTEPS))


def test_plant_refuses_tensors_on_no_supported_device():
    plant, x, u, w = plant_case(4, "shared", "cpu", torch.float32)
    build.reset_launches()
    with pytest.raises(ValueError):
        plant.integrate(x.to("meta"), u.to("meta"), None, plant.dt, plant.n_sub)
    with pytest.raises(ValueError):
        plant.integrate(x, u, w.to("meta"), plant.dt, plant.n_sub)
    assert build.LAUNCHES["plant"] == 0


@pytest.mark.parametrize("disturbed", [False, True])
def test_closed_loop_integrates_the_plant_through_rk4_multistep(monkeypatch, disturbed):
    """One call of closed_loop.rk4_multistep per plant integration, each with
    the plant's ODE: once a step, twice with derivative disturbances; the
    logged states are what those calls returned."""
    from benchmark.tracing import WRAPPED

    assert WRAPPED["plant_rk4"] == ("tum_control_tpu_torch.sim.closed_loop", "rk4_multistep")
    sim_cfg = SimConfig(sim_mode=0, simulate_disturbances=disturbed)
    sim, _, _, traj, _ = build_simulation(sim_cfg, MPCConfig(), device="cpu",
                                          dtype=torch.float32)
    x0m, x0s = batched_scenarios(traj, 2, dtype=torch.float32)
    calls, outs = [], []

    def counted(f, *args):
        calls.append(f)
        outs.append(rk4_multistep(f, *args))
        return outs[-1]

    monkeypatch.setattr(closed_loop, "rk4_multistep", counted)
    steps = 2
    _, log = sim.run(x0m, x0s, steps)
    per_step = 2 if disturbed else 1
    assert len(calls) == per_step * steps
    assert all(hasattr(f, "integrate") for f in calls)
    assert [f.w is not None for f in calls] == ([False, True] if disturbed else [False]) * steps
    for k in range(steps):
        assert torch.equal(log.CiLX[:, k], outs[per_step * k])
        if disturbed:
            assert torch.equal(log.DisturbedX[:, k], outs[per_step * k + 1])
