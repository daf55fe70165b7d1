"""The port's soft-QP solver API on QPs of general rows only (n_id = 0)
against the JAX package, on the CPU in float64: `solve_soft_qp`,
`newton_polish`, `objective` and `solve_soft_qp_ipm(n_id=0)` on
tests/test_soft_qp.py's random QPs (seeds 0-3: nz 12, 20 dense rows, two
of them hard, z2 = 1e7), the JAX functions on each QP alone and the
port's on the same QPs as one batch.

The hard rows put the Newton matrices at cond ~1e8, so the two packages'
Cholesky factors (LAPACK's, the port's plain loop) part by ~1e-9 relative
in w per Newton step. The semismooth Newton solve from w = 0 is far from
converged on these QPs after 15 steps, and its exact line search amplifies
such differences: JAX's own 15-step solve moves by 0.26-0.8 when its start
moves by 1e-9. So the Newton solve is held step by step (one port step from
JAX's iterate lands on JAX's next iterate within TOL_W), and whole only as
far as the two paths coincide (two steps). The IPM converges: its w is
held within TOL_W_IPM (on seed 2 JAX's own w moves by 5.5e-8 when c0 moves
by 1e-12), the objective within TOL_OBJ relative, the KKT residual at the
port's point within TOL_KKT (the residual jumps by z1 where a row lies on
its bound, so it is compared at one point).

With n_id = nz the identity block is analytic; it must equal the same rows
stored in G and solved with n_id = 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tum_control_tpu.ops import ipm as jipm
from tum_control_tpu.ops import soft_qp as jqp
from tum_control_tpu_torch.ops import ipm as tipm
from tum_control_tpu_torch.ops import soft_qp as tqp

from test_soft_qp import _random_qp

SEEDS = (0, 1, 2, 3)
TOL_W, TOL_W_IPM, TOL_KKT, TOL_OBJ = 1e-8, 1e-7, 1e-10, 1e-10
j_newton = jax.jit(jqp.newton_polish, static_argnames=("n_iters",))


def _qps(seeds=SEEDS, **kw):
    """(JAX QPs one by one, the port's batch of the same QPs)."""
    jqps = [_random_qp(np.random.default_rng(s), **kw) for s in seeds]
    tq = tqp.CondensedQP(*(torch.tensor(np.stack([np.asarray(getattr(q, f)) for q in jqps]))
                           for f in tqp.CondensedQP._fields))
    return jqps, tq


def _close(got, ref, atol, msg):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


def _kkt_at(jqps, w):
    """JAX's KKT residual at the port's points."""
    return [float(j_newton(q, jnp.asarray(x), n_iters=0)[1]) for q, x in zip(jqps, w)]


def test_objective_matches_jax():
    jqps, tq = _qps()
    w = np.random.default_rng(3).standard_normal(tq.g0.shape)
    np.testing.assert_allclose(tqp.objective(tq, torch.tensor(w)).numpy(),
                               [jqp.objective(q, x) for q, x in zip(jqps, w)], rtol=1e-13)


@pytest.mark.parametrize("seed", SEEDS)
def test_newton_steps_match_jax(seed):
    """15 Newton steps, each from JAX's iterate: the port's step lands on
    JAX's next iterate, and its KKT residual is JAX's at the port's point."""
    jqps, tq = _qps(seeds=(seed,))
    q, w = jqps[0], jnp.zeros(tq.g0.shape[1])
    for k in range(15):
        w_next = j_newton(q, w, n_iters=1)[0]
        wt, kkt = tqp.newton_polish(tq, torch.tensor(np.asarray(w))[None], n_iters=1)
        scale = max(1.0, float(jnp.abs(w_next).max()))
        _close(wt, np.asarray(w_next)[None], TOL_W * scale, f"w after step {k + 1}")
        np.testing.assert_allclose(kkt.numpy(), _kkt_at(jqps, wt.numpy()), rtol=TOL_KKT)
        w = w_next


def test_solve_soft_qp_matches_jax():
    """The whole solve over the steps where both paths coincide."""
    jqps, tq = _qps()
    w, kkt = tqp.solve_soft_qp(tq, n_iters=2)
    ref = np.stack([jqp.solve_soft_qp(q, n_iters=2)[0] for q in jqps])
    _close(w, ref, TOL_W * max(1.0, np.abs(ref).max()), "w")
    np.testing.assert_allclose(kkt.numpy(), _kkt_at(jqps, w.numpy()), rtol=TOL_KKT)
    np.testing.assert_allclose(tqp.objective(tq, w).numpy(),
                               [jqp.objective(q, x) for q, x in zip(jqps, w.numpy())],
                               rtol=TOL_OBJ)


@pytest.mark.parametrize("n_iters,n_polish", [(50, 2), (90, 4)])
def test_ipm_general_rows_match_jax(n_iters, n_polish):
    jqps, tq = _qps()
    w, kkt, stats = tipm.solve_soft_qp_ipm(tq, n_iters=n_iters, n_polish=n_polish, n_id=0,
                                           want_stats=True)
    ref = [jipm.solve_soft_qp_ipm(q, n_iters=n_iters, n_polish=n_polish, want_stats=True)
           for q in jqps]
    _close(w, np.stack([r[0] for r in ref]), TOL_W_IPM, "w")
    np.testing.assert_allclose(kkt.numpy(), _kkt_at(jqps, w.numpy()), rtol=TOL_KKT)
    np.testing.assert_array_equal(stats.iters.numpy(), [int(r[2].iters) for r in ref])
    np.testing.assert_allclose(tqp.objective(tq, w).numpy(),
                               [jqp.objective(q, r[0]) for q, r in zip(jqps, ref)], rtol=TOL_OBJ)


def test_ipm_general_rows_warm_start_matches_jax():
    """The warm-started solve returns JAX's warm start too."""
    jqps, tq = _qps()
    rng = np.random.default_rng(9)
    wv = [10.0 ** rng.uniform(-4, 6, tq.c0.shape) for _ in range(6)]
    w, kkt, warm = tipm.solve_soft_qp_ipm(tq, n_iters=8, n_polish=1, n_id=0,
                                          warm=tipm.IPMWarm(*map(torch.tensor, wv)))
    ref = [jipm.solve_soft_qp_ipm(q, n_iters=8, n_polish=1, warm=jipm.IPMWarm(*(x[i] for x in wv)))
           for i, q in enumerate(jqps)]
    _close(w, np.stack([r[0] for r in ref]), TOL_W_IPM, "w")
    for k, name in enumerate(tipm.IPMWarm._fields):
        np.testing.assert_allclose(warm[k].numpy(), np.stack([r[2][k] for r in ref]), rtol=1e-8,
                                   atol=1e-10, err_msg=name)


def test_con_products_without_identity_rows():
    jqps, tq = _qps()
    rng = np.random.default_rng(4)
    w = rng.standard_normal(tq.g0.shape)
    y = rng.standard_normal(tq.c0.shape)
    for name, fn, arg in (("con_mul", "con_mul", w), ("con_tmul", "con_tmul", y),
                          ("con_normal", "con_normal", np.abs(y))):
        got = getattr(tqp, fn)(tq, torch.tensor(arg))
        ref = np.stack([getattr(jqp, fn)(q, a) for q, a in zip(jqps, arg)])
        _close(got, ref, 1e-12, name)


def test_unconstrained_limit():
    """With every row slack-free, the solution is -H0^-1 g0 (JAX's test)."""
    _, tq = _qps(seeds=(7,), hard_rows=0)
    tq = tq._replace(z1=torch.zeros_like(tq.z1), z2=torch.zeros_like(tq.z2))
    w, _ = tqp.solve_soft_qp(tq, n_iters=5)
    exact = torch.linalg.solve(tq.H0, -tq.g0[..., None])[..., 0]
    np.testing.assert_allclose(w.numpy(), exact.numpy(), rtol=1e-6, atol=1e-8)


def test_identity_rows_equal_stored_rows():
    """n_id = nz (the engine's layout, the identity block analytic) equals
    the same QP with the identity rows stored in G and n_id = 0, for the
    Newton solve and the IPM."""
    _, tq = _qps(seeds=(5, 6))
    B, nz = tq.g0.shape
    rng = np.random.default_rng(8)
    box = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, (B, nz)))
    ext = lambda a, b: torch.cat([a, b], dim=1)
    qid = tq._replace(c0=ext(tq.c0, box(-0.2, 0.2)), lb=ext(tq.lb, -box(0.1, 0.5)),
                      ub=ext(tq.ub, box(0.1, 0.5)), z1=ext(tq.z1, box(10, 200)),
                      z2=ext(tq.z2, box(1, 20)))
    stored = qid._replace(G=torch.cat([tq.G, torch.eye(nz, dtype=tq.G.dtype).expand(B, nz, nz)],
                                      dim=1))
    for label, fn in (("solve_soft_qp", lambda q, n: tqp.solve_soft_qp(q, n_iters=10, n_id=n)),
                      ("ipm", lambda q, n: tipm.solve_soft_qp_ipm(q, n_iters=30, n_id=n))):
        w_id, kkt_id = fn(qid, nz)
        w_st, kkt_st = fn(stored, 0)
        _close(w_id, w_st.numpy(), 1e-9, label)
        _close(tqp.objective(qid, w_id, nz), tqp.objective(stored, w_st).numpy(), 1e-9, label)


def test_row_count_must_match_n_id():
    """A QP whose rows end with nz identity rows, passed without n_id = nz
    (or the other way round), is refused, not solved wrong."""
    _, tq = _qps(seeds=(0,))
    with pytest.raises(ValueError, match="identity rows"):
        tipm.solve_soft_qp_ipm(tq, n_id=tq.g0.shape[1])
    nz = tq.g0.shape[1]
    pad = lambda a: torch.cat([a, a[:, :nz]], dim=1)
    qid = tq._replace(c0=pad(tq.c0), lb=pad(tq.lb), ub=pad(tq.ub), z1=pad(tq.z1), z2=pad(tq.z2))
    with pytest.raises(ValueError, match="identity rows"):
        tipm.solve_soft_qp_ipm(qid)
