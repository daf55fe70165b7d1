"""The served step's graph rule on the CPU (deploy_rt.packed_step): without a
card the step stays eager and equals `sim.step` plus the packing, and the
counter counts eager steps only; the graph's key (what a replay reads by
reference, and the carry's shapes) and its input rebinding (a carry that is
not the static one is copied in, tensor by tensor), which run without a
card. The graph itself is held against the eager step on the card
(tests/test_torch_cuda.py). B = 1, float64, one torch thread.
"""
import pytest
import torch

from tum_control_tpu_torch import deploy_rt
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.sim.closed_loop import make_generator


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _served(**sim_kw):
    sim, x0m, x0s, _, _ = build_simulation(SimConfig(sim_mode=0, **sim_kw), MPCConfig(),
                                           device="cpu", dtype=torch.float64)
    return sim, sim.init_carry(x0m[None], x0s[None], key=3)


@pytest.fixture(scope="module")
def served():
    return _served()


def _equal(a, b):
    ta, tb = deploy_rt._tensors(a), deploy_rt._tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def test_cpu_step_stays_eager_and_equals_the_step(served):
    sim, carry = served
    zeros = torch.zeros_like(carry.x_sim)
    before = dict(deploy_rt.GRAPH_STEPS)
    got = carry
    for _ in range(3):
        want, log = sim.step(got, zeros, zeros)
        got, packed = deploy_rt.packed_step(sim, got, zeros)
        assert _equal(got, want)
        assert packed.dtype == torch.float32 and packed.shape == (deploy_rt.PACKED,)
        assert torch.equal(packed, deploy_rt.pack_telemetry(log))
        assert torch.equal(packed[:2], log.simU[0].float())
        assert torch.equal(packed[2:7], log.simSolverDebug[0].float())
    assert {k: deploy_rt.GRAPH_STEPS[k] - before[k] for k in before} == dict(
        eager=3, capture=0, replay=0)
    assert sim not in deploy_rt._GRAPHS


def test_graph_key_changes_with_what_a_replay_reads(served):
    sim, carry = served
    zeros = torch.zeros_like(carry.x_sim)
    g = deploy_rt.StepGraph(deploy_rt.graph_objects(sim, carry),
                            deploy_rt.graph_signature(carry, zeros))
    assert g.fits(sim, carry, zeros)
    # new tensors of the same shapes and a new generator: the same key (the
    # nominal served sim draws nothing)
    other = deploy_rt._cloned(carry)._replace(key=make_generator(9, "cpu"))
    assert not deploy_rt.draws(sim) and g.fits(sim, other, zeros.clone())
    # another batch, another dtype
    wide = deploy_rt._cloned(carry)._replace(x_sim=carry.x_sim.expand(2, -1).clone())
    assert not g.fits(sim, wide, zeros)
    assert not g.fits(sim, carry, zeros.float())
    # new tires (sim.set_tires), another lap object
    tp, ctrl_tp = sim.tp_sim, sim.controller.tp
    try:
        sim.set_tires(type(tp)(*(torch.tensor(float(v), dtype=torch.float64) for v in tp)))
        assert not g.fits(sim, carry, zeros)
    finally:
        sim.tp_sim = tp
        sim.controller.set_tires(ctrl_tp)
    assert g.fits(sim, carry, zeros)
    lap = sim.traj
    try:
        sim.traj = type(lap)(*lap)
        assert not g.fits(sim, carry, zeros)
    finally:
        sim.traj = lap


def test_a_drawing_sim_keys_its_generator():
    sim, carry = _served(simulate_disturbances=True, simulate_state_estimation=True)
    zeros = torch.zeros_like(carry.x_sim)
    assert deploy_rt.draws(sim)
    g = deploy_rt.StepGraph(deploy_rt.graph_objects(sim, carry),
                            deploy_rt.graph_signature(carry, zeros))
    assert g.fits(sim, carry, zeros)
    assert not g.fits(sim, carry._replace(key=make_generator(3, "cpu")), zeros)
    sim.playback = True  # played-back disturbances draw nothing
    assert not deploy_rt.draws(sim)


def test_load_copies_in_what_is_not_the_static_carry(served):
    sim, carry = served
    zeros = torch.zeros_like(carry.x_sim)
    g = deploy_rt.StepGraph(deploy_rt.graph_objects(sim, carry),
                            deploy_rt.graph_signature(carry, zeros))
    g.carry, g.zeros = deploy_rt._cloned(carry), zeros.clone()
    static = deploy_rt._tensors(g.carry)
    ptrs = [t.data_ptr() for t in static]
    nxt, _ = sim.step(carry, zeros, zeros)
    # the static carry itself: nothing moves
    g.load(g.carry, g.zeros)
    assert _equal(g.carry, carry)
    # another carry: every tensor copied into the static buffers in place
    g.load(nxt, torch.ones_like(zeros))
    assert _equal(g.carry, nxt) and torch.equal(g.zeros, torch.ones_like(zeros))
    assert [t.data_ptr() for t in deploy_rt._tensors(g.carry)] == ptrs
    assert all(a is b for a, b in zip(deploy_rt._tensors(g.carry), static))
    # a carry that shares some of the static tensors: the others copied
    mixed = g.carry._replace(x_sim=carry.x_sim.clone(), x_est=carry.x_est.clone())
    g.load(mixed, g.zeros)
    assert torch.equal(g.carry.x_sim, carry.x_sim) and torch.equal(g.carry.x_est, carry.x_est)
    assert torch.equal(g.carry.pose, nxt.pose)
