"""The reference over the whole closed-loop carry, on the CPU in float64:
the disturbed step drawn from the program's generator state, `engine.rti`
with a Problem set per scenario, the controller's carried state in the
sampled carry, and the serve driver's refusal of a configuration that
draws. (A reference controller with carried state added by files alone:
test_bench_spec.py.)

    python -m pytest benchmark/tests/test_bench_carry.py -q
"""
import dataclasses
import json
import os

import pytest
import torch

from benchmark import run as R
from benchmark.compare import carry_tensors, copy, extra_tensors
from benchmark.program import draws, settings
from benchmark.reference.closed_loop import Reference
from benchmark.reference.engine import rti

PER_SCENARIO = ("W", "We", "con_lb", "con_ub", "con_z1", "con_z2", "u_lb", "u_ub", "u_z1", "u_z2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name):
    return json.load(open(os.path.join(R.ROOT, "benchmark", "configs", f"{name}.json")))


def port(cfg, batch, mpc=None, key=None):
    """The port's closed loop of `cfg` in float64 on the CPU and its carry of
    `batch` scenarios spread around the lap."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    sim_cfg, mpc_cfg = settings(cfg)
    if mpc:
        mpc_cfg = dataclasses.replace(mpc_cfg, **mpc)
    sim, _, _, traj, _ = build_simulation(sim_cfg, mpc_cfg, device="cpu", dtype=torch.float64)
    return sim, sim.init_carry(*batched_scenarios(traj, batch), key=key)


def rel(a, b):
    return float((a - b).abs().max() / (1 + b.abs().max()))


def test_the_disturbed_step_equals_the_ports():
    """Both draws on: the reference draws from the program's generator state
    exactly what the port drew, and its step is the port's to 1e-12."""
    cfg = config("snmpc_disturbed")
    sim, carry = port(cfg, 4, key=2**31 + 17)
    assert draws(sim)
    ref = Reference(cfg, R.ROOT, dtype=torch.float64, device="cpu")
    z = torch.zeros_like(carry.x_sim)
    for _ in range(2):
        out = ref.step(carry_tensors(carry, draws=True))
        carry, log = sim.step(carry, z, z)
        new = carry_tensors(carry)
        assert torch.equal(out["w_deriv"], log.dist_deriv) and torch.equal(out["w_se"], log.dist_se)
        assert log.dist_deriv.abs().amax() > 0 and log.dist_se.abs().amax() > 0
        assert torch.equal(out["status"], log.simSolverDebug[:, 4].to(torch.int32))
        assert rel(out["u0"], log.simU) <= 1e-12
        for key in ("X", "U", "x_sim", "x_est", "est_buf", "pose"):
            assert rel(out[key], new[key]) <= 1e-12, key
    with pytest.raises(ValueError, match="generator state"):
        ref.step(carry_tensors(carry))


def _states(out):
    X, U, warm, status, A = out
    return dict(X=X, U=U, status=status, A=A, **{f"warm{i}": w for i, w in enumerate(warm)})


def test_rti_takes_a_problem_per_scenario():
    """Per-scenario fields equal to the static ones: bitwise the static run.
    One scenario's upper bounds tightened and another's weights changed: the
    port's RTIEngine.solve_full under the same QPMods, A included."""
    from tum_control_tpu_torch.ops.ipm import IPMWarm
    from tum_control_tpu_torch.ops.rti import QPMods, RTIState

    cfg = config("nominal")
    B = 3
    sim, carry = port(cfg, B)
    eng = sim.controller.engine
    ref = Reference(cfg, R.ROOT, dtype=torch.float64, device="cpu")
    p = ref.prob
    for f in PER_SCENARIO:
        assert torch.equal(getattr(p, f), getattr(eng, f)), f
    x0, st = carry.x_est, carry.ctrl_state
    _, yref, yref_e = ref.references(carry.pose)
    args = (st.X, st.U, tuple(st.warm), x0, yref, yref_e)
    static = _states(rti(p, *args))
    batched = p._replace(**{f: getattr(p, f).expand(B, *getattr(p, f).shape).clone()
                            for f in PER_SCENARIO})
    same = _states(rti(batched, *args))
    assert all(torch.equal(same[k], static[k]) for k in static)

    nh = eng.con_ub.shape[-1] - 1
    con_ub, W = batched.con_ub.clone(), batched.W.clone()
    con_ub[1, 1:-1, nh] = x0[1, 6] - 0.02   # the steering bound, below the steering angle
    con_ub[1, 1:-1, :nh] = 0.05             # the acceleration rows, soft
    W[2] *= torch.tensor([2.0, 2.0, 0.5, 1.0, 3.0, 0.5], dtype=W.dtype)
    got = _states(rti(batched._replace(con_ub=con_ub, W=W), *args))
    _, new, stats, A = eng.solve_full(RTIState(st.X, st.U, IPMWarm(*st.warm)), x0, yref, yref_e,
                                      QPMods(W=W, con_ub=con_ub))
    want = _states((new.X, new.U, tuple(new.warm), stats.status, A))
    assert torch.equal(got["status"], want["status"]) and not got["status"].any()
    for k in want:
        assert rel(got[k], want[k]) <= 1e-10, k
    moved = (got["U"] - static["U"]).abs().amax(dim=(1, 2))
    assert moved[0] == 0 and moved[1] > 1e-6 and moved[2] > 1e-6


@pytest.mark.parametrize("wmpc", [False, True], ids=["rnmpc", "wmpc_rnmpc"])
def test_the_sampled_carry_holds_the_carried_state(wmpc):
    """R2NMPC's back-offs, and WMPC's weights, observation, counters and its
    R2NMPC base, after a step: every tensor in field order, copied with the
    sample; the generator's state only where the configuration draws."""
    mpc = dict(controller="rnmpc")
    if wmpc:
        mpc.update(enable_WMPC=True, WMPC_model="data/wmpc_models/new_BO_F")
    sim, carry = port(config("nominal"), 2, mpc=mpc)
    z = torch.zeros_like(carry.x_sim)
    carry, _ = sim.step(carry, z, z)
    fields = list(carry.extra[:-1]) + list(carry.extra.base) if wmpc else list(carry.extra)
    assert len(fields) == (9 if wmpc else 2)
    got = carry_tensors(carry)
    assert len(got["extra"]) == len(fields)
    assert all(a is b for a, b in zip(got["extra"], fields))
    assert extra_tensors(carry.extra) == got["extra"]
    kept = copy(got)["extra"]
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(kept, fields))
    assert "gen_state" not in got and not draws(sim)
    assert torch.equal(carry_tensors(carry, draws=True)["gen_state"], carry.key.get_state())
    _, plain = port(config("nominal"), 2)
    assert "extra" not in carry_tensors(plain)


def test_the_serve_driver_refuses_draws(monkeypatch):
    cell_of = R.cell_of

    def served(spec, w, root=R.ROOT):
        c = cell_of(spec, "nominal.serve", root)
        c.cfg = config("snmpc_disturbed")
        return c

    monkeypatch.setattr(R, "cell_of", served)
    with pytest.raises(ValueError, match="draws disturbances"):
        R.run_cell("nominal.serve", 1, 1.0, False, device="cpu")
