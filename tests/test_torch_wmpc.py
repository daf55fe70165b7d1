"""The port's weights-varying MPC against the JAX package on the CPU in
float64: the policy MLP, the observation, the engine under QPMods, and the
WMPC closed loop over the nominal controller step by step.

Tolerances: the MLP and the observation are the same operations in another
order (1e-12; the argmax must agree everywhere). The engine under QPMods is
held as SNMPC's port-against-JAX solve (tests/test_torch_snmpc.py): 1e-9 for
iterates and outputs, identical statuses and iteration counts. The closed
loop stays within float64 roundoff of the JAX run, as SNMPC's (2.5e-14,
`test_torch_snmpc.py`): held to 1e-8 by `test_torch_closed_loop._compare_logs`, which also
requires identical solver statuses and the identical action trace.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu import config as jcfg
from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.learn import observation as jobs
from tum_control_tpu.learn.policy import load_sb3_policy as j_load_sb3_policy
from tum_control_tpu.ops.rti import QPMods as JQPMods
from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu.track.planner import RefWindow as JRefWindow
from tum_control_tpu_torch import config as tcfg
from tum_control_tpu_torch import convert
from tum_control_tpu_torch.api import build_controller, build_simulation
from tum_control_tpu_torch.learn import observation as tobs
from tum_control_tpu_torch.learn.policy import load_sb3_policy
from tum_control_tpu_torch.learn.wmpc import WMPCExtra
from tum_control_tpu_torch.ops.ipm import IPMWarm
from tum_control_tpu_torch.ops.rti import QPMods
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track.planner import RefWindow

from test_torch_closed_loop import _compare_logs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
T = lambda a: torch.tensor(np.asarray(a))
MODEL = "data/wmpc_models/new_BO_F"
NPZ = f"{tcfg.REPO_ROOT}/{MODEL}/policy_weights.npz"


def _close(got, ref, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


def test_policy_matches_jax_and_converts():
    """new_BO_F (22 -> 128 -> 256 -> 128 tanh, 26 actions): logits and
    values to 1e-12, the same argmax on 1,000 seeded observations; the
    JAX package's MLPPolicy carried across by convert.mlp_policy is the
    same network."""
    jp = j_load_sb3_policy(NPZ)
    tp = load_sb3_policy(NPZ, device="cpu", dtype=F64)
    assert tp.n_actions == 26 and not any(p.requires_grad for p in tp.parameters())
    obs = np.random.default_rng(60).uniform(-0.5, 1.5, (1000, 22))
    _close(tp.logits(T(obs)), jax.vmap(jp.logits)(jnp.asarray(obs)), 1e-12, "logits")
    _close(tp.value(T(obs)), jax.vmap(jp.value)(jnp.asarray(obs)), 1e-12, "value")
    np.testing.assert_array_equal(tp.predict(T(obs)).numpy(),
                                  np.asarray(jax.vmap(jp.predict)(jnp.asarray(obs))))
    fields = {k: [np.asarray(a) for a in v] if isinstance(v, tuple) else np.asarray(v)
              for k, v in jp._asdict().items()}
    cp = convert.mlp_policy(fields, device="cpu", dtype=F64)
    for a, b in zip(cp.state_dict().values(), tp.state_dict().values()):
        assert torch.equal(a, b)


def test_unwrap_matches_numpy():
    """Steps of exactly +-pi (numpy's tie rule) and multi-turn jumps."""
    rng = np.random.default_rng(61)
    p = np.cumsum(rng.normal(0, 2.5, (4, 40)), axis=1)
    p[0, 5:] += np.pi          # a step of exactly +pi
    p[1, 7:] -= np.pi
    p[2, 9:] += 4 * np.pi
    _close(tobs.unwrap(T(p)), np.unwrap(p), 1e-12)
    _close(tobs.unwrap(T(p)), jax.vmap(jnp.unwrap)(jnp.asarray(p)), 1e-12)


def test_make_observation_matches_jax():
    """Three 39-point windows, one of whose yaw crosses +-pi, one of whose
    crosses the other way; the 4x yaw-rate quirk (sim Ts) in both."""
    rng = np.random.default_rng(62)
    B, n = 3, 39
    t = np.arange(n) * 0.08
    yaw = np.stack([0.3 + 0.2 * t, np.pi - 0.4 + 0.3 * t, -np.pi + 0.3 - 0.25 * t])
    yaw = (yaw + np.pi) % (2 * np.pi) - np.pi      # wrapped, as the planner's headings
    v = 20 + rng.normal(0, 2, (B, n))
    pos = np.cumsum(rng.normal(0, 1, (B, n, 2)), axis=1)
    lat, vel = rng.normal(0, 0.5, B), rng.normal(0, 1, B)
    cfg_t, cfg_j = tobs.ObservationConfig(Ts=0.02), jobs.ObservationConfig(Ts=0.02)
    got = tobs.make_observation(cfg_t, T(lat), T(vel), RefWindow(T(pos), T(yaw), T(v)))
    ref = jax.vmap(lambda a, b, w: jobs.make_observation(cfg_j, a, b, w))(
        jnp.asarray(lat), jnp.asarray(vel),
        JRefWindow(pos=jnp.asarray(pos), yaw=jnp.asarray(yaw), v=jnp.asarray(v)))
    assert got.shape == (B, cfg_t.n_observations)
    _close(got, ref, 1e-12)
    assert float(got[:, 12:].abs().max()) < 1.0   # no 2 pi jump left in the rates


def _window(N, B):
    n = N + 1
    t = np.arange(n) * 0.08
    pos = np.stack([np.stack([20 * np.cos(0.3) * t + b, 20 * np.sin(0.3) * t + 0.3], 1)
                    for b in range(B)])
    return pos, np.stack([0.3 + 0.05 * t] * B), np.full((B, n), 21.0)


@pytest.mark.parametrize("fields", [("W", "We"), ("con_z1", "con_z2"), ("con_lb", "con_ub"),
                                    ("u_z1", "u_z2")])
def test_engine_with_qpmods_matches_jax(fields):
    """RTIEngine.solve_full under per-scenario QPMods (these fields set, the
    rest static) against the vmapped JAX engine, from the same state."""
    jctrl = j_build_controller(jcfg.MPCConfig(), jcfg.SimConfig())
    tctrl = build_controller(tcfg.MPCConfig(), tcfg.SimConfig(), device="cpu", dtype=F64)
    eng = tctrl.engine
    N, B = tctrl.N, 2
    rng = np.random.default_rng(63)
    static = dict(zip(QPMods._fields, (a.numpy() for a in eng._merged())))
    draw = {
        "W": lambda: rng.uniform(0.5, 3.0, (B, 6)),
        "We": lambda: rng.uniform(0.5, 3.0, (B, 4)),
        "con_z1": lambda: static["con_z1"] * rng.uniform(0.2, 3.0, (B, N + 1, 2)),
        "con_z2": lambda: static["con_z2"] * rng.uniform(0.2, 3.0, (B, N + 1, 2)),
        "con_lb": lambda: static["con_lb"] + np.abs(rng.normal(0, 0.05, (B, N + 1, 2))),
        "con_ub": lambda: static["con_ub"] - np.abs(rng.normal(0, 0.05, (B, N + 1, 2))),
        "u_z1": lambda: static["u_z1"] * rng.uniform(0.2, 3.0, (B, N, 2)),
        "u_z2": lambda: static["u_z2"] * rng.uniform(0.2, 3.0, (B, N, 2)),
    }
    vals = {f: draw[f]() for f in fields}
    x0 = np.array([[0.0, 0.0, 0.3, 20.0, 0.1, 0.05, 0.01, -0.5],
                   [1.0, 0.2, 0.3, 24.0, -0.1, 0.02, 0.0, 0.8]])
    pos, yaw, v = _window(N, B)
    twin = RefWindow(*(T(a) for a in (pos, yaw, v)))
    yref, yref_e = tctrl.make_yref(twin)
    tst = eng.init_state(T(x0))
    u_t, st_t, stats_t, A_t = eng.solve_full(tst, T(x0), yref, yref_e,
                                             QPMods(**{f: T(a) for f, a in vals.items()}))
    jst = jax.vmap(jctrl.engine.init_state)(jnp.asarray(x0))
    u_j, st_j, stats_j, A_j = jax.jit(jax.vmap(jctrl.engine.solve_full))(
        jst, jnp.asarray(x0), jnp.asarray(yref.numpy()), jnp.asarray(yref_e.numpy()),
        JQPMods(**{f: jnp.asarray(a) for f, a in vals.items()}))
    _close(u_t, u_j, 1e-9, "u0")
    _close(st_t.X, st_j.X, 1e-9, "X")
    _close(st_t.U, st_j.U, 1e-9, "U")
    _close(A_t, A_j, 1e-9, "A_lin")
    for k in IPMWarm._fields:
        _close(getattr(st_t.warm, k), getattr(st_j.warm, k), 1e-6, k)
    np.testing.assert_array_equal(stats_t.status.numpy(), np.asarray(stats_j.status))
    np.testing.assert_array_equal(stats_t.qp_iter.numpy(), np.asarray(stats_j.qp_iter))
    _close(stats_t.cost, stats_j.cost, 1e-8, "cost")
    # the mods moved the solution away from the static problem's
    u_s = eng.solve_full(tst, T(x0), yref, yref_e)[0]
    assert float((u_s - u_t).abs().max()) > 1e-8


def _wmpc_runs(controller, n):
    kw = dict(controller=controller, enable_WMPC=True, WMPC_model=MODEL,
              weights_update_period=20)
    jsim, _, _, jtraj, _ = j_build_simulation(jcfg.SimConfig(sim_mode=0, T=n * 0.02),
                                              jcfg.MPCConfig(**kw))
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    carry_j, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    tsim, _, _, ttraj, _ = build_simulation(tcfg.SimConfig(sim_mode=0), tcfg.MPCConfig(**kw),
                                            device="cpu", dtype=F64)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=F64)
    carry_t, log_t = tsim.run(x0m, x0s, n)
    return carry_j, log_j, carry_t, log_t


def _extra_np(extra):
    d = {f: np.asarray(getattr(extra, f)) for f in WMPCExtra._fields if f != "base"}
    d["base"] = None if extra.base is None else {f: np.asarray(v) for f, v in
                                                 extra.base._asdict().items()}
    return d


def test_wmpc_nominal_closed_loop_60_steps_matches_jax():
    """WMPC over the nominal NMPC, 60 steps (policy updates at steps 20 and
    40): identical action traces, logs as the nominal loop's, and the final
    WMPCExtra (through convert.wmpc_extra) with the swapped-in weights."""
    n = 60
    carry_j, log_j, carry_t, log_t = _wmpc_runs("nominal", n)
    _compare_logs(log_t, log_j, atol=1e-8)
    acts = log_t.wmpc_action
    assert (acts[:, :20] == 0).all() and (acts >= 0).all()
    assert (log_t.simSolverDebug[..., 4] == 0).all()
    ex_j = convert.wmpc_extra(_extra_np(carry_j.extra), device="cpu", dtype=F64)
    for f in ("steps", "action"):
        assert torch.equal(getattr(carry_t.extra, f), getattr(ex_j, f)), f
    for f in ("W", "We", "L1", "L2", "obs"):
        _close(getattr(carry_t.extra, f), getattr(ex_j, f).numpy(), 1e-8, f)
    table = np.loadtxt(f"{tcfg.REPO_ROOT}/data/F.csv", delimiter=",")
    p = table[carry_t.extra.action.numpy()]
    _close(carry_t.extra.W, p[:, [0, 0, 1, 2, 3, 4]], 0.0, "W = table row, no 0.01 factor")

