"""The port's SNMPC against the JAX package on the CPU in float64: the PCE
constants, the analytic gg-constraint Jacobian, K6's plain version, the
structured QP against the dense one inside the port, the port against JAX
at one warm state, and a 60-step closed loop step by step.

Tolerances: the PCE constants are the same numpy arithmetic (1e-14). The
constraint Jacobian and K6's plain version are the same operations in
another order (1e-12). Structured against dense follows the JAX package's
own test (tests/test_controllers.py): 1e-12 condensing, 1e-9 QP fields,
1e-10 u and X. Port against JAX: the same functions in float64 agree to
~1e-13 (measured), held at 1e-9 for QP data and iterates (1e-6 for the
IPM's dual warm start, whose entries reach 1e5). The 60-step closed loop
agreed to 2.5e-14 (measured); it is held at 1e-8 with identical statuses
and qp_iter.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu import config as jcfg
from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.api import build_simulation as j_build_simulation
from tum_control_tpu.controllers import common as jcommon
from tum_control_tpu.controllers import pce as jpce
from tum_control_tpu.ops.pallas_kernels.condense import condense_scan_from_ref
from tum_control_tpu.parallel.mesh import batched_scenarios as j_batched
from tum_control_tpu.track.planner import RefWindow as JRefWindow
from tum_control_tpu_torch import config as tcfg
from tum_control_tpu_torch import convert
from tum_control_tpu_torch.api import build_controller, build_simulation
from tum_control_tpu_torch.controllers import common as tcommon
from tum_control_tpu_torch.controllers import pce as tpce
from tum_control_tpu_torch.controllers.snmpc import StochasticNMPC
from tum_control_tpu_torch.ops.ipm import IPMWarm
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels.condense import condense_from, condense_from_ref
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track.planner import RefWindow


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64


def _close(got, ref, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# PCE constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_samples,n_vars,degree", [(10, 3, 2), (7, 2, 3), (5, 3, 2)])
def test_pce_constants_and_fan(n_samples, n_vars, degree):
    """alpha_indices, the Hammersley normal samples, the regression matrix
    (w and A) and the sample fan equal JAX's; an underdetermined fit
    (5 samples, 10 terms) warns in both."""
    np.testing.assert_array_equal(tpce.alpha_indices(n_vars, degree),
                                  jpce.alpha_indices(n_vars, degree))
    assert tpce.n_poly_terms(n_vars, degree) == jpce.n_poly_terms(n_vars, degree)
    _close(tpce.hammersley_normal_samples(n_samples, n_vars),
           jpce.hammersley_normal_samples(n_samples, n_vars), 1e-14)
    under = n_samples < jpce.n_poly_terms(n_vars, degree)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        w_t, A_t = tpce.regression_matrix(n_samples, n_vars, degree)
        w_j, A_j = jpce.regression_matrix(n_samples, n_vars, degree)
    assert sum("underdetermined" in str(r.message) for r in rec) == (2 if under else 0)
    _close(w_t, w_j, 1e-14)
    _close(A_t, A_j, 1e-14)

    stds = np.zeros(8)
    stds[[3, 4, 5][:n_vars]] = [0.8, 0.35, 0.035][:n_vars]
    x0 = np.random.default_rng(40).normal(0, 5, (3, 8))
    fan_t = tpce.fan_initial_state(torch.tensor(x0), torch.tensor(tpce.fan_offsets(w_t, stds)))
    fan_j = jax.vmap(lambda x: jpce.fan_initial_state(x, w_j, stds))(jnp.asarray(x0))
    assert fan_t.shape == (3, n_samples + 1, 8)
    _close(fan_t, fan_j, 1e-14)


# ---------------------------------------------------------------------------
# analytic gg-constraint Jacobian
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [0, 1, 2])
def test_acc_constraints_jac(shape):
    """Values and Jacobians equal JAX's analytic version and jacfwd of
    acc_constraints, below gg.vel[0], above gg.vel[-1], inside, at the
    knots (analytic only: the slope there is one-sided by convention) and
    with braking a_lon < 0. The shipped table starts at 0 m/s, so it is
    shifted by 3 m/s to have speeds below its first knot."""
    vel, ax_max, ax_min, ay_max = tcfg.load_gg_table(tcfg.DEFAULT_CONFIG_PATH, "EDGAR/ggv.csv")
    vel = np.asarray(vel) + 3.0
    ggj = jcommon.GGTables(vel, ax_max, ax_min, ay_max)
    ggt = tcommon.GGTables(vel, ax_max, ax_min, ay_max, device="cpu", dtype=F64)
    rng = np.random.default_rng(41)
    n = 60
    x = rng.normal(0, 1, (n, 8))
    speed = np.concatenate([rng.uniform(0.3, vel[0] - 0.01, 8),
                            rng.uniform(vel[-1] + 1, vel[-1] + 20, 8),
                            rng.uniform(vel[0] + 0.01, vel[-1] - 0.01, n - 16)])
    ang = rng.uniform(-0.2, 0.2, n)
    x[:, 3], x[:, 4] = speed * np.cos(ang), speed * np.sin(ang)
    x[:, 7] = rng.normal(0, 4, n)
    x[::3, 7] = -np.abs(x[::3, 7])                     # braking rows
    acc_min = -3.5

    h_t, dh_t = tcommon.acc_constraints_jac(torch.tensor(x), ggt, acc_min, shape)
    h_j, dh_j = jax.vmap(lambda r: jcommon.acc_constraints_jac(r, ggj, acc_min, shape))(
        jnp.asarray(x))
    _close(h_t, h_j, 1e-12, "h vs JAX analytic")
    _close(dh_t, dh_j, 1e-12, "dh vs JAX analytic")

    def h_of(r):
        v = jnp.sqrt(r[3] ** 2 + r[4] ** 2)
        return jcommon.acc_constraints(v, r[7], r[3] * r[5], ggj, acc_min, shape)

    _close(h_t, jax.vmap(h_of)(jnp.asarray(x)), 1e-12, "h vs acc_constraints")
    _close(dh_t, jax.vmap(jax.jacfwd(h_of))(jnp.asarray(x)), 1e-12, "dh vs jacfwd")

    # exactly at the knots: the port's slope is JAX's interp_slope
    vk = np.asarray(vel[1:-1], dtype=float)
    _close(tcommon.interp_slope(torch.tensor(vk), ggt.vel, ggt.ay_max),
           jcommon.interp_slope(jnp.asarray(vk), ggj.vel, ggj.ay_max), 1e-12)


# ---------------------------------------------------------------------------
# K6, plain version
# ---------------------------------------------------------------------------
def _carry_case(B, N2, nx, nu, nz, col0, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.03, (B, N2, nx, nx)) + 0.95 * np.eye(nx)   # stable, as K1's are
    Bm = rng.normal(0, 1, (B, N2, nx, nu))
    xi = rng.normal(0, 0.1, (B, N2, nx))
    e0 = rng.normal(0, 1, (B, nx))
    G0 = np.zeros((B, nx, nz))
    G0[..., :col0] = rng.normal(0, 1, (B, nx, col0))   # the head's carry
    return A, Bm, xi, e0, G0


@pytest.mark.parametrize("B,N2,nx,nu,nz,col0", [(3, 5, 8, 2, 16, 4), (2, 33, 8, 2, 76, 10)])
def test_condense_from_ref_matches_jax(B, N2, nx, nu, nz, col0):
    """condense_from_ref = the vmapped condense_scan_from_ref, small and at
    SNMPC's tail shapes; on CPU tensors the wrapper is the plain version
    and counts no launch."""
    A, Bm, xi, e0, G0 = _carry_case(B, N2, nx, nu, nz, col0, 42)
    e_j, G_j = jax.vmap(lambda *a: condense_scan_from_ref(*a, col0))(A, Bm, xi, e0, G0)
    args = [torch.tensor(a) for a in (A, Bm, xi, e0, G0)]
    e_t, G_t = condense_from_ref(*args, col0)
    assert e_t.shape == (B, N2 + 1, nx) and G_t.shape == (B, N2 + 1, nx, nz)
    _close(e_t, e_j, 1e-12, "e")
    _close(G_t, G_j, 1e-12, "Gamma")
    build.reset_launches()
    e_w, G_w = condense_from(*args, col0)
    assert torch.equal(e_w, e_t) and torch.equal(G_w, G_t)
    assert build.LAUNCHES["condense_from"] == 0
    np.testing.assert_array_equal(args[4].numpy(), G0)   # the carry is not written


# ---------------------------------------------------------------------------
# structured == dense, inside the port
# ---------------------------------------------------------------------------
def _gg_vp_tp(sim_cfg, mpc):
    vp = tcfg.load_vehicle_params(tcfg.DEFAULT_CONFIG_PATH, sim_cfg.veh_params_file_MPC)
    tp = tcfg.load_tire_params(tcfg.DEFAULT_CONFIG_PATH, sim_cfg.tire_params_file_MPC)
    gg = tcommon.GGTables(*tcfg.load_gg_table(tcfg.DEFAULT_CONFIG_PATH, mpc.lookuptable_gg_limits),
                          device="cpu", dtype=F64)
    return vp, tp, gg


def _window(N, B):
    """The JAX package's test window, one per scenario with a small shift."""
    n = N + 1
    t = np.arange(n) * 0.08
    pos = np.stack([np.stack([20 * np.cos(0.3) * t + b, 20 * np.sin(0.3) * t + 0.3], 1)
                    for b in range(B)])
    yaw = np.stack([0.3 + 0.05 * t] * B)
    v = np.full((B, n), 21.0)
    return pos, yaw, v


def _dense_from_structured(ctrl, X, U, d0):
    """The dense (B, N+1, nx) e and (B, N+1, nx, nz) Gamma assembled from
    the structured pieces of `lin_structured` (the JAX package's
    `lin_condense`)."""
    e_full, Gam_nom, G_head, G_frozen = ctrl._lin_structured(X, U, d0)
    Bt, N1, ns1 = e_full.shape[:3]
    H, nz = G_head.shape[1], Gam_nom.shape[-1]
    G_smp = torch.cat([G_head[:, :, 1:],
                       G_frozen[:, None].expand(Bt, N1 - H, ns1 - 1, 8, nz)], dim=1)
    G_full = torch.cat([Gam_nom[:, :, None], G_smp], dim=2)
    return e_full.reshape(Bt, N1, ctrl.nx), G_full.reshape(Bt, N1, ctrl.nx, nz)


def test_snmpc_structured_equals_dense():
    """The structured (two-phase, K6) linearize + condense equals the dense
    88-state path, and build_qp builds the QP the generic forward-mode path
    builds from the dense sensitivities (the JAX package's
    tests/test_controllers.py, batched)."""
    sim_cfg = tcfg.SimConfig(Tp=10 * 0.08)
    mpc = tcfg.MPCConfig(controller="snmpc")
    vp, tp, gg = _gg_vp_tp(sim_cfg, mpc)
    mk = lambda s: StochasticNMPC(mpc, sim_cfg.N, sim_cfg.Ts_MPC, vp, tp, gg, structured=s,
                                  device="cpu", dtype=F64)
    c_s, c_d = mk(True), mk(False)
    assert c_s.engine.funcs.build_qp is not None and c_d.engine.funcs.build_qp is None

    B, N = 2, sim_cfg.N
    x0 = torch.tensor([[0.0, 0.0, 0.3, 20.0, 0.1, 0.05, 0.01, -0.5],
                       [1.0, 0.2, 0.3, 21.0, -0.1, 0.02, 0.0, 0.4]], dtype=F64)
    win = RefWindow(*(torch.tensor(a) for a in _window(N, B)))
    st = c_d.init_state(x0)
    for _ in range(3):
        _, st = c_d.solve(st, x0, win)

    d0 = c_d._fan(x0) - st.X[:, 0]
    A, Bm, xi = c_d.engine._linearize(st)
    from tum_control_tpu_torch.ops.kernels.condense import condense
    e_ref, G_ref = condense(A, Bm, xi, d0)
    e_st, G_st = _dense_from_structured(c_s, st.X, st.U, d0)
    _close(e_st, e_ref.numpy(), 1e-12, "e")
    _close(G_st, G_ref.numpy(), 1e-12, "Gamma")

    yref = c_d.make_yref(win)
    qp_d = c_d.engine._build_qp(st, c_d._fan(x0), *yref)[0]
    qp_s = c_s.engine._build_qp(st, c_s._fan(x0), *yref)[0]
    for f in qp_d._fields:
        _close(getattr(qp_s, f), getattr(qp_d, f).numpy(), 1e-9, f)

    u_d, st_d, _ = c_d.engine.solve(st, c_d._fan(x0), *yref)
    u_s, st_s, _ = c_s.engine.solve(st, c_s._fan(x0), *yref)
    _close(u_s, u_d.numpy(), 1e-10, "u")
    _close(st_s.X, st_d.X.numpy(), 1e-10, "X")


def test_snmpc_uph_freeze_semantics():
    """dyn_step: beyond the UPH the samples stay frozen and the nominal keeps
    integrating; below it every copy moves (the JAX package's test, and the
    port's stacked step equal to JAX's node by node)."""
    ctrl = build_controller(tcfg.MPCConfig(controller="snmpc"), tcfg.SimConfig(), device="cpu",
                            dtype=F64)
    jctrl = j_build_controller(jcfg.MPCConfig(controller="snmpc"), jcfg.SimConfig())
    N, uph = ctrl.N, ctrl.cfg.uncertainty_propagation_horizon
    x0 = torch.tensor([[0.0, 0.0, 0.2, 15.0, 0.1, 0.05, 0.01, 0.3]], dtype=F64)
    stacked = ctrl._fan(x0)                                      # (1, 88)
    X = stacked[:, None].expand(1, N, ctrl.nx)
    U = torch.tensor([0.4, 0.01], dtype=F64).expand(1, N, 2)
    nxt = ctrl.dyn_step(X, U)[0].reshape(N, -1, 8).numpy()
    F, _, _ = ctrl.engine.funcs.dyn_jac(X, U)          # dyn_jac's F is the same step
    _close(F[0].reshape(N, -1, 8), nxt, 1e-13, "dyn_jac F")
    xs = stacked[0].reshape(-1, 8).numpy()
    np.testing.assert_allclose(nxt[uph:, 1:], np.broadcast_to(xs[1:], nxt[uph:, 1:].shape), rtol=0)
    assert np.abs(nxt[uph, 0] - xs[0]).max() > 1e-3
    assert np.abs(nxt[0, 1:] - xs[1:]).max() > 1e-3
    for k in (0, uph - 1, uph, N - 1):
        ref = np.asarray(jctrl.engine.funcs.dyn_step(k, stacked[0].numpy(), U[0, 0].numpy()))
        _close(nxt[k].reshape(-1), ref, 1e-12, f"dyn_step node {k}")
    h = ctrl.engine.funcs.con_stage(stacked[:, None].expand(1, N + 1, ctrl.nx))[0].numpy()
    for k in (0, uph, N):
        _close(h[k], jctrl.engine.funcs.con_stage(k, stacked[0].numpy()), 1e-12, f"con node {k}")


# ---------------------------------------------------------------------------
# port against JAX at one warm state
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def warm_case():
    """Both controllers, a JAX warm state after 3 solves at two scenarios,
    carried across by convert.rti_state."""
    jctrl = j_build_controller(jcfg.MPCConfig(controller="snmpc"), jcfg.SimConfig())
    tctrl = build_controller(tcfg.MPCConfig(controller="snmpc"), tcfg.SimConfig(), device="cpu",
                             dtype=F64)
    N, B = jctrl.N, 2
    x0 = np.array([[0.0, 0.0, 0.3, 20.0, 0.1, 0.05, 0.01, -0.5],
                   [1.0, 0.2, 0.3, 24.0, -0.1, 0.02, 0.0, 0.8]])
    pos, yaw, v = _window(N, B)
    jwin = JRefWindow(pos=jnp.asarray(pos), yaw=jnp.asarray(yaw), v=jnp.asarray(v))
    jsolve = jax.jit(jax.vmap(jctrl.solve))
    jst = jax.vmap(jctrl.init_state)(jnp.asarray(x0))
    for _ in range(3):
        _, jst = jsolve(jst, jnp.asarray(x0), jwin)
    state_np = dict(X=np.asarray(jst.X), U=np.asarray(jst.U),
                    warm={k: np.asarray(getattr(jst.warm, k)) for k in IPMWarm._fields})
    tst = convert.rti_state(state_np, device="cpu", dtype=F64)
    twin = RefWindow(*(torch.tensor(a) for a in (pos, yaw, v)))
    return jctrl, tctrl, jst, tst, x0, jwin, twin


def test_snmpc_structured_pieces_and_qp_match_jax(warm_case):
    jctrl, tctrl, jst, tst, x0, jwin, twin = warm_case
    xf_t = tctrl._fan(torch.tensor(x0))
    xf_j = jax.vmap(jctrl._fan)(jnp.asarray(x0))
    _close(xf_t, xf_j, 1e-14, "fan")
    d0 = xf_t - tst.X[:, 0]
    pieces_t = tctrl._lin_structured(tst.X, tst.U, d0)
    pieces_j = jax.jit(jax.vmap(jctrl._lin_structured))(jst.X, jst.U, jnp.asarray(d0.numpy()))
    for name, a, b in zip(("e_full", "Gam_nom", "G_head", "G_frozen"), pieces_t, pieces_j):
        assert a.shape == b.shape, name
        _close(a, b, 1e-9, name)

    yref, yref_e = tctrl.make_yref(twin)
    qp_t, _ = tctrl.engine.funcs.build_qp(tst.X, tst.U, xf_t, yref, yref_e,
                                          tctrl.engine._merged())
    merged = jctrl.engine._merged(None)
    qp_j, _ = jax.jit(jax.vmap(
        lambda X, U, x, yr, ye: jctrl.engine.funcs.build_qp(X, U, x, yr, ye, merged)))(
        jst.X, jst.U, xf_j, jnp.asarray(yref.numpy()), jnp.asarray(yref_e.numpy()))
    assert qp_t.G.shape == (2, 78, 76) and qp_t.H0.shape == (2, 76, 76)
    for f in qp_t._fields:
        _close(getattr(qp_t, f), getattr(qp_j, f), 1e-9, f)


def test_snmpc_solve_matches_jax(warm_case):
    jctrl, tctrl, jst, tst, x0, jwin, twin = warm_case
    out_t, st_t = tctrl.solve(tst, torch.tensor(x0), twin)
    out_j, st_j = jax.jit(jax.vmap(jctrl.solve))(jst, jnp.asarray(x0), jwin)
    _close(out_t.u0, out_j.u0, 1e-9, "u0")
    assert out_t.pred_X.shape == (2, jctrl.N + 1, 8)
    _close(out_t.pred_X, out_j.pred_X, 1e-9, "pred_X")
    _close(st_t.X, st_j.X, 1e-9, "X")
    _close(st_t.U, st_j.U, 1e-9, "U")
    for k in IPMWarm._fields:
        _close(getattr(st_t.warm, k), getattr(st_j.warm, k), 1e-6, k)
    np.testing.assert_array_equal(out_t.stats[:, 2:].numpy(), np.asarray(out_j.stats)[:, 2:])
    _close(out_t.stats[:, 0], np.asarray(out_j.stats)[:, 0], 1e-8, "cost")


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------
def test_snmpc_closed_loop_60_steps_matches_jax():
    """Monteblanco, sim_mode 0, batch 2 from batched_scenarios, 60 steps
    through api.build_simulation and ClosedLoopSim.run, step by step."""
    n = 60
    jsim, _, _, jtraj, _ = j_build_simulation(jcfg.SimConfig(sim_mode=0, T=n * 0.02),
                                              jcfg.MPCConfig(controller="snmpc"))
    x0m_j, x0s_j = j_batched(jtraj, 2, dtype=jnp.float64)
    _, log_j = jax.jit(jax.vmap(lambda a, b: jsim.run(a, b, n)))(x0m_j, x0s_j)
    tsim, _, _, ttraj, _ = build_simulation(tcfg.SimConfig(sim_mode=0),
                                            tcfg.MPCConfig(controller="snmpc"), device="cpu",
                                            dtype=F64)
    x0m, x0s = batched_scenarios(ttraj, 2, dtype=F64)
    carry, log_t = tsim.run(x0m, x0s, n)
    assert carry.ctrl_state.X.shape == (2, tsim.N + 1, 88)
    for f in ("MPC_SimX", "CiLX", "DisturbedX", "simU", "simREF", "lat_dev", "vel_dev"):
        _close(getattr(log_t, f), getattr(log_j, f), 1e-8, f)
    dbg_t, dbg_j = log_t.simSolverDebug.numpy(), np.asarray(log_j.simSolverDebug)
    np.testing.assert_array_equal(dbg_t[..., 2:], dbg_j[..., 2:])  # sqp/qp iters, status
    np.testing.assert_allclose(dbg_t[..., 0], dbg_j[..., 0], rtol=1e-9, atol=1e-8)
    assert (dbg_t[..., 4] == 0).all()
    assert float(log_t.lat_dev.abs().max()) < 0.5
