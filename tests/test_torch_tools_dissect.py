"""SNMPC's engine hooks and the port's snmpc_dissect
(tum_control_tpu_torch/tools/snmpc_dissect.py) against the JAX package, on
the CPU in float64 at B = 2:

  * `lin_condense`, `con_jac` and `y_jac` (the JAX package's
    controllers/snmpc.py closures, reached through `eng.funcs`) against
    JAX's at one warm state, within 1e-10 of each output's max |JAX| (the
    same operations in another order; measured ~1e-15);
  * the engine's generic path through the three hooks against the
    structured build_qp inside the port (the JAX package's structured-
    equals-dense anchor), within 1e-10 of each field's max;
  * snmpc_dissect's four chained stages after R = 2 iterations against
    tools/snmpc_dissect.py's (run unchanged but for its timing helper,
    tests/_torch_tools_jax.py), within 1e-8 of each output's max |JAX|.
"""
import copy

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_tools_jax as jt
from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.config import MPCConfig as JMPCConfig
from tum_control_tpu.config import SimConfig as JSimConfig
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.tools import snmpc_dissect
from tum_control_tpu_torch.tools.common import lap_starts

B, R = 2, 2
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run has six workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def warm_state():
    """The port's SNMPC at B = 2 after 3 closed-loop steps from the lap
    starts: (sim, X, U, d0) with d0 the fanned estimate minus X[:, 0]."""
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(controller="snmpc"),
                                          device="cpu", dtype=F64)
    x0 = lap_starts(traj, B, F64, "cpu")
    carry, _ = sim.run_from(sim.init_carry(x0, x0[:, :7].contiguous()), 3)
    st = carry.ctrl_state
    return sim, st.X, st.U, sim.controller._fan(carry.x_est) - st.X[:, 0]


def test_snmpc_hooks_match_jax(warm_state):
    sim, X, U, d0 = warm_state
    jsim, *_ = j_build_simulation(JSimConfig(sim_mode=0), JMPCConfig(controller="snmpc"))
    jf = jsim.controller.engine.funcs
    f = sim.controller.engine.funcs
    N = X.shape[1] - 1
    a = lambda t: jnp.asarray(t.numpy())
    e_j, G_j = jax.jit(jax.vmap(jf.lin_condense))(a(X), a(U), a(d0))
    e_t, G_t = f.lin_condense(X, U, d0)
    jt.assert_close(e_t, e_j, "lin_condense e", 1e-10)
    jt.assert_close(G_t, G_j, "lin_condense Gamma", 1e-10)
    kall = jnp.broadcast_to(jnp.arange(N + 1), (B, N + 1))
    C_j, Jc_j = jax.jit(jax.vmap(jax.vmap(jf.con_jac)))(kall, a(X))
    C_t, Jc_t = f.con_jac(X)
    jt.assert_close(C_t, C_j, "con_jac C", 1e-10)
    jt.assert_close(Jc_t, Jc_j, "con_jac Jc", 1e-10)
    ks = jnp.broadcast_to(jnp.arange(N), (B, N))
    for name, g, w in zip(("Y", "Jx", "Ju"), f.y_jac(X[:, :-1], U),
                          jax.jit(jax.vmap(jax.vmap(jf.y_jac)))(ks, a(X[:, :-1]), a(U))):
        jt.assert_close(g, w, f"y_jac {name}", 1e-10)


def test_engine_hook_path_equals_the_structured_qp(warm_state):
    """The generic engine path through lin_condense, y_jac and con_jac (the
    dense Gamma, analytic Jacobians) builds the structured path's QP."""
    from tum_control_tpu_torch.track.planner import planner_emulator

    sim, X, U, d0 = warm_state
    ctrl = sim.controller
    eng = ctrl.engine
    x0 = d0 + X[:, 0]
    yref, yref_e = ctrl.make_yref(planner_emulator(sim.traj, X[:, 0, :2], sim.Tp, sim.N + 1)[1])
    state = eng.init_state(x0)._replace(X=X, U=U)
    qp_s = eng._build_qp(state, x0, yref, yref_e)[0]
    dense = copy.copy(eng)
    dense.funcs = eng.funcs._replace(build_qp=None, expand_dx=None)
    qp_d, e, Gam, A = dense._build_qp(state, x0, yref, yref_e)
    assert Gam.shape == (B, 39, 88, 76) and not A.any()
    for name in qp_s._fields:
        jt.assert_close(getattr(qp_d, name), getattr(qp_s, name).numpy(), f"qp.{name}", 1e-10)


def test_snmpc_dissect_stages_match_the_jax_script(monkeypatch):
    want = jt.chained("snmpc_dissect", monkeypatch, [B, R])
    got = snmpc_dissect.main([str(B), str(R), "--device", "cpu"], dtype=F64)
    assert set(want) == {"lin_condense", "con rows", "cost blocks", "full build_qp"}
    for name, w in want.items():
        jt.hold_carry(name, got[name]["carry"], w)
        assert got[name]["host_ms"] > 0 and got[name]["device_ms"] is None
