"""R2NMPC under the WMPC policy (configs/rnmpc_wmpc.json) against its
reference controller (reference/controller_rnmpc_wmpc.py), on the CPU: the
port's closed-loop step and carried state equal the float64 reference's
through a policy update, with the shipped policy and with a seeded random
one; and faults planted in the port make the cell's comparison judge the run
not correct, at a sampled step that is not an update step too.

    python -m pytest benchmark/tests/test_bench_rnmpc_wmpc.py -q
"""
import json
import os

import pytest
import torch

from benchmark import compare
from benchmark import driver_batch, faults
from benchmark import run as R
from benchmark.compare import carry_tensors, extra_tensors
from benchmark.program import settings
from benchmark.reference.closed_loop import Reference

CELL = "rnmpc_wmpc.b16"
STEPS = 24        # the first policy update is the 21st solve
PERIOD = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(model_dir=None):
    cfg = json.load(open(os.path.join(R.ROOT, "benchmark", "configs", "rnmpc_wmpc.json")))
    if model_dir is not None:
        cfg["mpc"] = dict(cfg["mpc"], WMPC_model=str(model_dir))
    return cfg


def random_policy(path):
    """A policy of the shipped widths with orthogonal weights from a fixed
    seed, written where WMPC_model finds it (no rl_config.yaml: the port's
    defaults, 10 points and F.csv)."""
    from tum_control_tpu_torch.learn.policy import init_mlp_policy, save_policy_npz

    gen = torch.Generator().manual_seed(19)
    save_policy_npz(init_mlp_policy(gen, 22, 26, device="cpu", dtype=torch.float64),
                    str(path / "policy_weights.npz"))
    return path


def rel(a, b):
    return float((a - b).abs().max() / (1 + b.abs().max()))


@pytest.mark.parametrize("policy", ["shipped", "random"])
def test_the_port_equals_the_reference_through_a_policy_update(tmp_path, policy):
    """B = 4, float64, 24 steps from the lap's spread starts: at every step the
    reference, given the port's carry before it, gives the port's u0, X, U and
    every float of the new carry to 1e-10, and its status, counters and
    actions."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    cfg = config(random_policy(tmp_path) if policy == "random" else None)
    sim_cfg, mpc_cfg = settings(cfg)
    sim, _, _, traj, _ = build_simulation(sim_cfg, mpc_cfg, device="cpu", dtype=torch.float64)
    carry = sim.init_carry(*batched_scenarios(traj, 4))
    ref = Reference(cfg, R.ROOT, dtype=torch.float64, device="cpu")
    built = sim.controller.base.engine
    for a, b in zip(ref.init_extra(carry.x_est), extra_tensors(carry.extra)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    z = torch.zeros_like(carry.x_sim)
    for i in range(STEPS):
        out = ref.step(carry_tensors(carry))
        carry, log = sim.step(carry, z, z)
        new = carry_tensors(carry)
        assert torch.equal(out["status"], log.simSolverDebug[:, 4].to(torch.int32))
        assert rel(out["u0"], log.simU) <= 1e-10, i
        for key in ("X", "U", "x_sim", "x_est", "est_buf", "pose"):
            assert rel(out[key], new[key]) <= 1e-10, (i, key)
        for j, (a, b) in enumerate(zip(out["extra"], new["extra"])):
            if a.is_floating_point():
                assert rel(a, b) <= 1e-10, (i, j)
            else:
                assert torch.equal(a, b), (i, j)
        steps = carry.extra.steps
        assert (steps == (i + 1 if i < PERIOD else i + 1 - PERIOD)).all()
        assert torch.equal(log.wmpc_action, carry.extra.action)
    # the update swapped the weights, and the back-offs tighten the bounds
    assert not torch.equal(carry.extra.W, built.W.expand_as(carry.extra.W))
    assert (carry.extra.base.corr_acc[:, 1:-1] > 0).all()


def _zeroed(monkeypatch):
    from tum_control_tpu_torch.controllers.rnmpc import ReducedRobustNMPC, RobustExtra

    propagate = ReducedRobustNMPC._propagate
    monkeypatch.setattr(ReducedRobustNMPC, "_propagate", lambda self, *a: RobustExtra(
        *(torch.zeros_like(t) for t in propagate(self, *a))))


def _no_disturbance(monkeypatch):
    from tum_control_tpu_torch.controllers.rnmpc import ReducedRobustNMPC

    init = ReducedRobustNMPC.__init__

    def without(self, *a, **kw):
        init(self, *a, **kw)
        self.BWB = torch.zeros_like(self.BWB)

    monkeypatch.setattr(ReducedRobustNMPC, "__init__", without)


def _unswapped(monkeypatch):
    from tum_control_tpu_torch.learn.wmpc import WMPCController

    solve = WMPCController.solve_with_extra

    def kept(self, state, extra, *a, **kw):
        out, new_state, new = solve(self, state, extra, *a, **kw)
        return out, new_state, new._replace(W=extra.W, We=extra.We, L1=extra.L1, L2=extra.L2)

    monkeypatch.setattr(WMPCController, "solve_with_extra", kept)


def _no_last_tanh(monkeypatch):
    from tum_control_tpu_torch.learn.policy import MLPPolicy

    def logits(self, obs):
        h = obs
        for i, layer in enumerate(self.pi):
            h = layer(h)
            if i < len(self.pi) - 1:
                h = torch.tanh(h)
        return self.action_net(h)

    monkeypatch.setattr(MLPPolicy, "logits", logits)


FAULTS = dict(backoffs_zeroed=_zeroed, no_disturbance_term=_no_disturbance,
              weights_not_swapped=_unswapped, last_tanh_dropped=_no_last_tanh)


class Clock:
    """driver_batch's clock: every reading half a second after the last, so a
    window of `seconds` runs that many steps."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.5
        return self.t


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    """The cell at B = 4 in float32, 19 warm-up steps and a window of 10
    steps, all sampled (solves 20 to 29, the 21st an update), judged by the
    cell's limits: correct without a fault; with each fault not correct, and
    a pair off at a sampled step that does not update."""
    cell_of = R.cell_of

    def small(spec, w, root=R.ROOT):
        c = cell_of(spec, w, root)
        c.traffic = dict(c.traffic, batch=4, warmup_steps=19, sample_steps=10)
        return c

    judged = []
    gaps = compare.gaps

    def kept(samples, reference, outs=None):
        g = gaps(samples, reference, outs)
        judged.append((samples, g))
        return g

    monkeypatch.setattr(R, "cell_of", small)
    monkeypatch.setattr(driver_batch, "time", Clock())
    monkeypatch.setattr(compare, "gaps", kept)
    if fault:
        FAULTS[fault](monkeypatch)
    n = torch.get_num_threads()
    try:
        res = R.run_cell(CELL, 2**31 + 1919, 10.0, False, device="cpu")
    finally:
        torch.set_num_threads(n)
    c = res["compared"]
    samples, g = judged[-1]
    assert len(samples) == 10 and res["attempted"] == 40
    steps = torch.cat([s["before"]["extra"][0] for s in samples])
    assert int((steps == PERIOD).sum()) == 4
    if fault is None:
        assert res["correct"] is True, c
        return
    assert res["correct"] is False, c
    off = compare.pair_scores(g, R.cell_of(R.load_spec(), CELL).limits) > compare.PAIR_FACTOR
    assert (off & (steps != PERIOD)).any(), c


def _one_scenario(change):
    """faults.py's `one_control` / `one_status` where this controller produces
    its output: its `solve_with_extra` (faults.py wraps a `solve`, which a
    controller that carries state does not have)."""
    def plant(monkeypatch):
        from tum_control_tpu_torch.learn.wmpc import WMPCController

        solve = WMPCController.solve_with_extra

        def broken(self, *a, **kw):
            out, state, extra = solve(self, *a, **kw)
            return change(out), state, extra

        monkeypatch.setattr(WMPCController, "solve_with_extra", broken)
    return plant


def _one_status(out):
    stats = out.stats.clone()
    stats[faults._row(stats.shape[0]), 4] = 1
    return out._replace(stats=stats)


def _stepping(build, fault):
    def broken(ctx, batch):
        sim, carry, lap_points = build(ctx, batch)
        sim.step = fault(sim)
        return sim, carry, lap_points
    return broken


ONE = dict(one_control=_one_scenario(lambda out: faults._steer(out, faults._row(out.u0.shape[0]))),
           one_status=_one_scenario(_one_status),
           one_state=lambda monkeypatch: monkeypatch.setattr(
               faults.program, "build", _stepping(faults.program.build, faults.one_state)))


@pytest.mark.parametrize("fault", [None, *ONE])
def test_one_broken_scenario_of_the_cell_is_not_correct(monkeypatch, fault):
    """The cell at its own batch of 16 in float32, a window of 8 steps, all
    sampled: sound, correct; with one scenario broken on every step (faults.py's
    one-scenario faults), that scenario is off in every sampled step, more
    pairs than the limit allows. (test_bench_faults.py's full-batch cases ask
    for 384 solves in a window of 6 s, which this batch of 16 does not reach on
    the CPU.)"""
    cell_of = R.cell_of

    def sampled(spec, w, root=R.ROOT):
        c = cell_of(spec, w, root)
        c.traffic = dict(c.traffic, sample_steps=8)
        return c

    monkeypatch.setattr(R, "cell_of", sampled)
    monkeypatch.setattr(driver_batch, "time", Clock())
    if fault:
        ONE[fault](monkeypatch)
    n = torch.get_num_threads()
    try:
        res = R.run_cell(CELL, 2**31 + 4321, 8.0, False, device="cpu")
    finally:
        torch.set_num_threads(n)
    c = res["compared"]
    assert res["attempted"] == 8 * 16
    if fault is None:
        assert res["correct"] is True, c
    else:
        assert res["correct"] is False and c["pairs_off"]["value"] > c["pairs_off"]["limit"], c
