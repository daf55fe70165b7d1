"""The plain PyTorch versions of the ported kernels (K1-K5, K7, K8) against
the JAX package's references, on the CPU; and the wrappers' dispatch rule.

  K1 linearize_ref   vs make_linearize_rollout's jacfwd_path (vmapped)
  K2 condense_ref    vs condense_scan_ref
  K6 condense_from_ref vs condense_scan_from_ref from a carry dense in every
                     column
  K3 cholesky_ref    vs jnp.linalg.cholesky
  K5 chol_solve_ref  vs jax.scipy.linalg.cho_solve
  K4 iteration_ref   vs the vmapped iteration_ref (float64), and at float32,
                     B = 128 vs the Pallas kernel fused_iteration_batched in
                     interpret mode, as tests/test_ipm_fused.py runs it.
  K8 condense_mxu_ref vs _condense_tpu_mxu (its pallas_call in interpret
                     mode) and condense_scan_ref
  K7 cholesky_unblocked_ref / chol_solve_unblocked_ref vs _chol_kernel /
                     _solve_kernel (a test-built interpret-mode pallas_call
                     in the lanes layout), jnp.linalg.cholesky and cho_solve
  K3, K7 on an ill-conditioned IPM-shaped H (cond ~1e6-5e7) vs
                     jnp.linalg.cholesky; chol_plan's layout, and the
                     wrappers' refusals before any launch
  K4, K1             ipm_plan's and linearize_plan's launch shapes; the K4
                     wrapper's refusals before any launch
  K2, K6, K5, K7     condense_plan's and chol_solve_plan's launch shapes; the
                     solve wrappers' refusals before any launch

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py), where they are held against these plain versions.
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
from jax.experimental import pallas as pl

from tum_control_tpu.api import build_controller as j_build_controller
from tum_control_tpu.config import MPCConfig as JMPC, SimConfig as JSim
from tum_control_tpu.ops.pallas_kernels import chol as jchol
from tum_control_tpu.ops.pallas_kernels import condense as jcondense
from tum_control_tpu.ops.pallas_kernels import ipm_iter as jipm
from tum_control_tpu.ops.pallas_kernels.condense import condense_scan_from_ref, condense_scan_ref
from tum_control_tpu_torch.api import build_controller
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels import chol as tchol
from tum_control_tpu_torch.ops.kernels.chol import (
    MAX_N_CHOL, CholPlan, SolvePlan, chol_plan, chol_solve, chol_solve_cuda, chol_solve_plan,
    chol_solve_ref, chol_solve_unblocked, chol_solve_unblocked_cuda, chol_solve_unblocked_ref,
    cholesky, cholesky_ref, cholesky_unblocked, cholesky_unblocked_ref,
)
from tum_control_tpu_torch.ops.kernels.condense import (
    CondensePlan, condense, condense_from, condense_from_ref, condense_mxu, condense_mxu_ref,
    condense_plan,
)
from tum_control_tpu_torch.ops.kernels import ipm_iter as tipm
from tum_control_tpu_torch.ops.kernels.ipm_iter import (
    IpmPlan, fused_iteration, ipm_plan, masks_of, sigma_of,
)
from tum_control_tpu_torch.ops.kernels.linearize import LinearizePlan, linearize_plan

from chip_smoke import ipm_shaped_h
from test_ipm_fused import _init_carry, _random_problem

T = lambda a: torch.tensor(np.asarray(a))


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n + 4))
    return A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n)


def test_k1_linearize_plain_matches_jacfwd_path():
    """Same RK4 over the same model in float64: agreement to ~1e-12."""
    rng = np.random.default_rng(10)
    B, N = 3, 38
    XU = np.concatenate([
        rng.uniform(-50, 50, (B, N, 2)), rng.uniform(0, 6.2, (B, N, 1)),
        rng.uniform(0.0, 30, (B, N, 1)), rng.normal(0, 0.5, (B, N, 4)),
        rng.normal(0, 1, (B, N, 2)),
    ], axis=2)
    XU[0, :5, 3] = 0.0          # standstill rows: the low-speed guard
    XU[1, :5, 4:7] = 0.0        # exactly zero slip
    jctrl = j_build_controller(JMPC(), JSim())
    Fj, Jj = jax.jit(jax.vmap(jctrl.engine.funcs.lin_rollout))(XU)
    tctrl = build_controller(MPCConfig(), SimConfig(), device="cpu", dtype=torch.float64)
    Ft, Jt = tctrl.engine.funcs.lin_rollout(T(XU))
    assert Jt.shape == (B, N, 8, 10)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-12, atol=1e-10)


def test_k2_condense_plain_matches_scan_ref():
    """Products of 38 stage matrices in float64, same order: rtol 1e-12."""
    rng = np.random.default_rng(11)
    Bt, N, nx, nu = 4, 38, 8, 2
    A = np.eye(nx) + 0.1 * rng.standard_normal((Bt, N, nx, nx))
    Bm = rng.standard_normal((Bt, N, nx, nu))
    xi = rng.standard_normal((Bt, N, nx))
    d0 = rng.standard_normal((Bt, nx))
    e_j, G_j = jax.vmap(condense_scan_ref)(A, Bm, xi, d0)
    e_t, G_t = condense(T(A), T(Bm), T(xi), T(d0))
    assert G_t.shape == (Bt, N + 1, nx, N * nu)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-12, atol=1e-12)
    assert torch.count_nonzero(G_t[:, 0]) == 0
    assert torch.count_nonzero(G_t[:, 5, :, 5 * nu:]) == 0  # columns past k*nu stay 0


@pytest.mark.parametrize("n", [1, 12, 17, 76])
def test_k3_k5_cholesky_and_solve(n):
    """Well-conditioned SPD (cond ~ 1e2) in float64: rtol 1e-11."""
    H = _spd(5, n, seed=12 + n)
    b = np.random.default_rng(13).standard_normal((5, n))
    L_t = cholesky(T(H))
    L_j = jnp.linalg.cholesky(H)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-11, atol=1e-12)
    assert torch.count_nonzero(torch.triu(L_t, 1)) == 0
    x_t = chol_solve(L_t, T(b))
    x_j = jax.vmap(lambda L, r: jsl.cho_solve((L, True), r))(L_j, b)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(chol_solve_ref(L_t, T(b)).numpy(), x_t.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(cholesky_ref(T(H)).numpy(), L_t.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("B,N2,nx,nu,nz,col0", [(3, 5, 8, 2, 16, 4), (4, 33, 8, 2, 76, 10)])
def test_k6_condense_from_plain_matches_scan_from_ref_dense_carry(B, N2, nx, nu, nz, col0):
    """K6's plain version from a carry Gamma0 that is nonzero in every column
    (the card is held to it with such a carry): the vmapped
    condense_scan_from_ref in float64, same order, to 1e-12 of the max; the
    wrapper takes CPU tensors to it and counts no launch."""
    rng = np.random.default_rng(22)
    A = 0.95 * np.eye(nx) + rng.normal(0, 0.03, (B, N2, nx, nx))
    args = (A, rng.normal(0, 1, (B, N2, nx, nu)), rng.normal(0, 0.1, (B, N2, nx)),
            rng.normal(0, 1, (B, nx)), rng.normal(0, 1, (B, nx, nz)))
    e_j, G_j = jax.vmap(lambda *a: condense_scan_from_ref(*a, col0))(*args)
    e_t, G_t = condense_from_ref(*(T(a) for a in args), col0)
    for got, ref in ((e_t, e_j), (G_t, G_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert np.count_nonzero(np.asarray(G_j)[:, -1]) == B * nx * nz
    build.reset_launches()
    e_w, G_w = condense_from(*(T(a) for a in args), col0)
    assert torch.equal(e_w, e_t) and torch.equal(G_w, G_t)
    assert build.LAUNCHES["condense_from"] == 0


def _k4_inputs(B, nz, ncg, seed, dtype):
    H0, g0, G, c0, lb, ub, z1, z2 = (np.asarray(a, dtype) for a in _random_problem(B, nz, ncg, seed))
    carry, nt, masks = _init_carry(*(jnp.asarray(a, jnp.float32) for a in (c0, lb, ub, z2)), nz)
    carry = tuple(np.asarray(c, dtype) for c in carry)
    nt = np.asarray(nt, dtype)
    sig = np.asarray(jax.vmap(jipm.sigma_of)(*carry[2:10], z1, z2, *masks))
    H = H0 + np.einsum("bic,bi,bid->bcd", G, sig[:, :ncg], G) + (sig[:, ncg:, None] + 1e-11) * np.eye(nz)
    L = np.linalg.cholesky(H.astype(np.float64)).astype(dtype)
    lam_d = carry[6] - carry[7]
    rw = (np.einsum("bij,bj->bi", H0, carry[0]) + g0 + np.einsum("bij,bi->bj", G, lam_d[:, :ncg])
          + lam_d[:, ncg:]).astype(dtype)
    return dict(L=L, G=G, rw=rw, c0=c0, lb=lb, ub=ub, z1=z1, z2=z2, nt=nt), carry, masks


@pytest.mark.parametrize("nz,ncg", [(12, 10), (76, 78)])
def test_k4_plain_matches_vmapped_iteration_ref(nz, ncg):
    """One Mehrotra iteration from identical float64 inputs: rtol 1e-9
    (the direction solves of a cond ~1e4 system, in a different but
    exact-arithmetic-equivalent substitution order)."""
    args, carry, masks = _k4_inputs(16, nz, ncg, seed=14, dtype=np.float64)
    ref_c, ref_sig, ref_unc = jax.vmap(
        lambda *a: jipm.iteration_ref(*a, n_id=nz, gamma_ftb=0.99)
    )(*args.values(), *carry)
    got_c, got_sig, got_unc = fused_iteration(*(T(a) for a in args.values()),
                                              tuple(T(c) for c in carry), 0.99)
    for name, g, r in zip(["w", "Gw", "su", "sl", "pu", "pl", "lam_u", "lam_l", "mu_u", "mu_l"],
                          got_c, ref_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got_sig.numpy(), np.asarray(ref_sig), rtol=1e-9, atol=1e-10)
    np.testing.assert_array_equal(got_unc.numpy(), np.asarray(ref_unc))
    s_t = sigma_of(*(T(c) for c in carry[2:10]), T(args["z1"]), T(args["z2"]),
                   *masks_of(T(args["lb"]), T(args["ub"]), T(args["z2"])))
    s_j = jax.vmap(jipm.sigma_of)(*carry[2:10], args["z1"], args["z2"], *masks)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12, atol=0)


@pytest.mark.parametrize("nz,ncg", [(12, 10), (16, 6)])
def test_k4_plain_f32_matches_pallas_kernel_interpret(nz, ncg):
    """float32, B = 128, against the TPU kernel body run in interpret mode
    (factor padded to a multiple of 16 with an identity tail, as the TPU
    path pads it); the tolerance of tests/test_ipm_fused.py, 2e-4."""
    B = jipm.LANES
    args, carry, _ = _k4_inputs(B, nz, ncg, seed=0, dtype=np.float32)
    npad = -(-nz // 16) * 16
    Lp = np.zeros((B, npad, npad), np.float32)
    Lp[:, :nz, :nz] = args["L"]
    Lp[:, np.arange(nz, npad), np.arange(nz, npad)] = 1.0
    lanes_mat = lambda a: jnp.transpose(jnp.asarray(a).reshape(1, B, *a.shape[1:]), (0, 2, 3, 1))
    lanes = lambda a: jipm._lanes(jnp.asarray(a), B)
    k_c, k_sig, k_unc = jipm.fused_iteration_batched(
        lanes_mat(Lp), lanes_mat(args["G"]), lanes(args["rw"]),
        *(lanes(args[k]) for k in ("c0", "lb", "ub", "z1", "z2")), lanes(args["nt"][:, None]),
        tuple(lanes(c) for c in carry), 0.99, interpret=True,
    )
    got_c, got_sig, got_unc = fused_iteration(*(T(a) for a in args.values()),
                                              tuple(T(c) for c in carry), 0.99)
    assert got_c[0].dtype == torch.float32
    for g, k in zip(got_c, k_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(jipm._unlanes(k, B)), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_sig.numpy(), np.asarray(jipm._unlanes(k_sig, B)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got_unc.numpy(), np.asarray(k_unc).reshape(B))


def test_wrappers_dispatch_by_tensor():
    """CPU tensors take the plain version (no build, no launch); tensors
    that lie on no supported device raise; no launch is counted."""
    build.reset_launches()
    H = T(_spd(2, 6, seed=1))
    assert torch.equal(cholesky(H), cholesky_ref(H))
    with pytest.raises(ValueError):
        build.use_kernel(torch.empty(3, device="meta"))
    with pytest.raises(ValueError):
        build.use_kernel(H, torch.empty(3, device="meta"))
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert set(build.LAUNCHES) == {"linearize", "condense", "condense_from", "cholesky",
                                   "chol_solve", "ipm_iteration", "condense_mxu",
                                   "cholesky_unblocked", "chol_solve_unblocked", "plant"}


@pytest.mark.parametrize("nx,to_kernel", [(8, True), (16, True), (17, False), (88, False)])
def test_k2_condense_refuses_wide_states(monkeypatch, nx, to_kernel):
    """On the card, `condense` takes a state of at most 16 (the JAX
    package's MAX_NX_FAST) to K2 and refuses a wider one (SNMPC's dense
    88-state stack) with a ValueError; on the CPU every width goes to the
    plain version. The card's dispatch is stood in for here: `use_kernel`
    answers yes as for CUDA float32 tensors, and loading the kernel's
    library stops the call, which shows the launch was reached."""
    from tum_control_tpu_torch.ops.kernels import condense as cmod

    rng = np.random.default_rng(15)
    Bt, N, nu = 2, 4, 2
    A = T(np.eye(nx) + 0.1 * rng.standard_normal((Bt, N, nx, nx)))
    args = (A, T(rng.standard_normal((Bt, N, nx, nu))), T(rng.standard_normal((Bt, N, nx))),
            T(rng.standard_normal((Bt, nx))))
    build.reset_launches()
    e, G = cmod.condense(*args)
    e_r, G_r = cmod.condense_ref(*args)
    assert torch.equal(e, e_r) and torch.equal(G, G_r)

    class Launched(Exception):
        pass

    def library(name):
        raise Launched(name)

    monkeypatch.setattr(cmod.build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cmod.build, "library", library)
    with pytest.raises(Launched if to_kernel else ValueError):
        cmod.condense(*args)
    assert build.LAUNCHES["condense"] == 0


def _condense_case(Bt, N, nx, nu, seed, dtype):
    rng = np.random.default_rng(seed)
    A = 0.97 * np.eye(nx) + rng.normal(0, 0.05, (Bt, N, nx, nx))   # stable, as K1's are
    return tuple(np.asarray(a, dtype) for a in (
        A, rng.standard_normal((Bt, N, nx, nu)), rng.normal(0, 0.1, (Bt, N, nx)),
        rng.standard_normal((Bt, nx))))


def test_k8_condense_mxu_plain_matches_interpret_kernel_and_scan_ref(monkeypatch):
    """float32, B = 20 (padded to 2 blocks of 16 scenarios): against the TPU
    kernel body run through `_condense_tpu_mxu` with its `pallas_call` in
    interpret mode (each output to 2e-5 of its max: float32 products of 38
    stages in another order). float64: against condense_scan_ref and K2's
    plain version (1e-12). The wrapper takes CPU tensors to the plain
    version and counts no launch."""
    args32 = _condense_case(20, 38, 8, 2, 16, np.float32)
    interp = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(jcondense, "pl", interp)
    e_k, G_k = jcondense._condense_tpu_mxu(*(jnp.asarray(a) for a in args32))
    e_t, G_t = condense_mxu_ref(*(T(a) for a in args32))
    assert e_t.dtype == torch.float32 and G_t.shape == (20, 39, 8, 76)
    for got, ref in ((e_t, e_k), (G_t, G_k)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())

    args = _condense_case(4, 38, 8, 2, 17, np.float64)
    e_j, G_j = jax.vmap(condense_scan_ref)(*args)
    build.reset_launches()
    e_t, G_t = condense_mxu(*(T(a) for a in args))
    assert build.LAUNCHES["condense_mxu"] == 0
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=0, atol=1e-12)
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=0, atol=1e-12)
    e2, G2 = condense(*(T(a) for a in args))
    np.testing.assert_allclose(e_t.numpy(), e2.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(G_t.numpy(), G2.numpy(), rtol=0, atol=1e-12)


def _lanes_call(kernel, out, *args):
    """A TPU kernel body over (1, n, ..., 128) lanes-layout refs, run in
    interpret mode with the whole arrays as its blocks."""
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(out.shape, out.dtype),
                          interpret=True)(*args)


@pytest.mark.parametrize("n", [12, 76])
def test_k7_plain_matches_unblocked_kernels_interpret(n):
    """float64, 128 matrices in the lanes: the unblocked TPU kernels
    `_chol_kernel` and `_solve_kernel` against the port's plain versions of
    their pivot loops (1e-12: the same arithmetic), and both against
    jnp.linalg.cholesky / cho_solve (1e-11, cond ~1e2); the wrappers take
    CPU tensors to the plain versions."""
    B = jchol.LANES
    H = _spd(B, n, seed=18 + n)
    b = np.random.default_rng(19).standard_normal((B, n))
    to_lanes = lambda a: jnp.moveaxis(jnp.asarray(a)[None], 1, -1)     # (1, n, .., 128)
    from_lanes = lambda a: np.moveaxis(np.asarray(a)[0], -1, 0)
    Lt = _lanes_call(jchol._chol_kernel, to_lanes(H), to_lanes(H))
    xt = _lanes_call(jchol._solve_kernel, to_lanes(b), Lt, to_lanes(b))
    L_k, x_k = from_lanes(Lt), from_lanes(xt)

    build.reset_launches()
    L_t = cholesky_unblocked(T(H))
    x_t = chol_solve_unblocked(L_t, T(b))
    assert build.LAUNCHES["cholesky_unblocked"] == 0 and build.LAUNCHES["chol_solve_unblocked"] == 0
    assert torch.equal(L_t, cholesky_unblocked_ref(T(H)))
    assert torch.equal(x_t, chol_solve_unblocked_ref(L_t, T(b)))
    np.testing.assert_allclose(L_t.numpy(), L_k, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x_t.numpy(), x_k, rtol=0, atol=1e-12)
    assert torch.count_nonzero(torch.triu(L_t, 1)) == 0
    L_j = np.asarray(jnp.linalg.cholesky(H))
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=1e-11, atol=1e-12)
    x_j = np.asarray(jax.vmap(lambda L, r: jsl.cho_solve((L, True), r))(L_j, b))
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("plain", [cholesky_ref, cholesky_unblocked_ref], ids=["K3", "K7"])
def test_k3_k7_plain_on_ill_conditioned_ipm_h(plain):
    """float64, the IPM-shaped H that chip_smoke.py holds the card to (cond
    ~1e6-5e7 here): each plain version against jnp.linalg.cholesky to 1e-10
    of max |L| (observed <= 4e-13; cond eps ~5e-9 is the first-order bound
    of a backward-stable factorization), upper triangle exactly 0."""
    H = ipm_shaped_h(np.random.default_rng(20), 8, 76, 78).astype(np.float64)
    L_j = np.asarray(jnp.linalg.cholesky(H))
    L_t = plain(T(H))
    np.testing.assert_allclose(L_t.numpy(), L_j, rtol=0, atol=1e-10 * np.abs(L_j).max())
    assert torch.count_nonzero(torch.triu(L_t, 1)) == 0


@pytest.mark.parametrize("n,plan", [
    (1, CholPlan(16, 20, 1, 4 * (16 * 20 + 16))),
    (17, CholPlan(32, 36, 2, 4 * (32 * 36 + 16))),
    (76, CholPlan(80, 84, 5, 26944)),
    (128, CholPlan(128, 132, 8, 67648)),
])
def test_k3_k7_plan(n, plan):
    """The factorization kernel's layout: n padded to a multiple of 16,
    ld = npad + 4 (= 4 mod 8), shared memory for the matrix and 16 pivots
    (above the default 48 KB only at n > 96)."""
    assert chol_plan(n) == plan
    assert plan.ld % 8 == 4 and (plan.smem_bytes > 48 * 1024) == (n > 96)


class _OnCard:
    """Stands in for a CUDA tensor where there is none: the dispatch rule
    and the wrappers' checks read only device, dtype, shape and
    contiguity."""

    def __init__(self, t):
        self.t, self.device, self.dtype, self.shape = t, torch.device("cuda", 0), t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def is_contiguous(self):
        return self.t.is_contiguous()


@pytest.mark.parametrize("factor", [cholesky, cholesky_unblocked], ids=["K3", "K7"])
@pytest.mark.parametrize("case", ["n_in_range", "n_above_max", "n_zero", "non_contiguous",
                                  "cpu_cuda_mix", "float64"])
def test_k3_k7_wrappers_refuse_before_launch(monkeypatch, factor, case):
    """On the card the wrappers take n in 1..MAX_N_CHOL and contiguous
    float32 tensors that all lie on the card; anything else raises before
    the kernel's library is loaded, and no launch is counted. Loading the
    library stops the call here, which shows the launch was reached."""

    class Launched(Exception):
        pass

    def library(name):
        raise Launched(name)

    monkeypatch.setattr(tchol.build, "library", library)
    n = {"n_above_max": MAX_N_CHOL + 1, "n_zero": 0}.get(case, 76)
    H = T(_spd(2, n, seed=21)).float() if n else torch.zeros(2, 0, 0)
    build.reset_launches()
    if case == "n_in_range":
        with pytest.raises(Launched):
            factor(_OnCard(H))
    elif case == "non_contiguous":
        with pytest.raises(ValueError):
            factor(_OnCard(H.transpose(1, 2)))
    elif case == "cpu_cuda_mix":
        solve = chol_solve if factor is cholesky else chol_solve_unblocked
        with pytest.raises(ValueError):
            solve(_OnCard(H), torch.zeros(2, n))
    elif case == "float64":
        with pytest.raises(TypeError):
            factor(_OnCard(H.double()))
    else:
        with pytest.raises(ValueError):
            factor(_OnCard(H))
    assert all(v == 0 for v in build.LAUNCHES.values())


@pytest.mark.parametrize("nz,ncg,plan", [
    (76, 78, IpmPlan(80, 84, 256, 12, 7, 64080, 255)),
    (5, 6, IpmPlan(16, 20, 256, 6, 1,
                   4 * (16 * 20 + 6 * 20 + 16 + 16 * 16 + 12 + 16 + 6 * 16 + 192), 255)),
    (17, 20, IpmPlan(32, 36, 256, 20, 1,
                     4 * (32 * 36 + 20 * 36 + 32 + 32 * 16 + 40 + 32 + 20 * 32 + 192), 255)),
    (128, 128, IpmPlan(128, 132, 256, 8, 16,
                       4 * (128 * 132 + 128 * 132 + 128 + 128 * 16 + 256 + 128 + 8 * 128 + 192),
                       255)),
])
def test_k4_plan(nz, ncg, plan):
    """K4's launch shape: L padded to a multiple of 16 rows, ld = npad + 4
    (= 4 mod 8), one block of 256 threads (one per constraint row), G^T y in
    slices over as many threads as hold a float4 of columns (no empty
    slice); shared memory for L, G, 1 / L_jj, the transposed diagonal
    blocks, y, x, the slices' sums and 3 reductions, above 48 KB at the
    shipped shape."""
    assert ipm_plan(nz, ncg) == plan
    assert plan.ld % 8 == 4 and plan.threads % 32 == 0
    assert plan.parts * plan.rows_per_part >= ncg > (plan.parts - 1) * plan.rows_per_part


@pytest.mark.parametrize("nz,ncg", [(0, 10), (129, 10), (20, 237), (8, -1), (128, 129)])
def test_k4_plan_refuses(nz, ncg):
    """nz outside 1..128, ncg + nz above 256 rows, or a negative ncg."""
    with pytest.raises(ValueError):
        ipm_plan(nz, ncg)


@pytest.mark.parametrize("case", ["in_range", "nz_above_max", "too_many_rows", "float64"])
def test_k4_wrapper_refuses_before_launch(monkeypatch, case):
    """On the card the K4 wrapper takes what ipm_plan takes, in contiguous
    float32 tensors; anything else raises before the kernel's library is
    loaded, and no launch is counted. Loading the library stops the call
    here, which shows the launch was reached."""

    class Launched(Exception):
        pass

    def library(name):
        raise Launched(name)

    monkeypatch.setattr(tipm.build, "library", library)
    nz, ncg = {"nz_above_max": (129, 10), "too_many_rows": (100, 160)}.get(case, (76, 78))
    nc, B = nz + ncg, 2
    dt = torch.float64 if case == "float64" else torch.float32
    z = lambda *s: _OnCard(torch.zeros(*s, dtype=dt))
    args = (z(B, nz, nz), z(B, ncg, nz), z(B, nz)) + tuple(z(B, nc) for _ in range(5)) + (z(B),)
    carry = (z(B, nz),) + tuple(z(B, nc) for _ in range(9))
    build.reset_launches()
    expected = {"in_range": Launched, "float64": TypeError}.get(case, ValueError)
    with pytest.raises(expected):
        fused_iteration(*args, carry)
    assert all(v == 0 for v in build.LAUNCHES.values())


@pytest.mark.parametrize("n_el,blocks", [(1, 1), (111, 9), (4864, 380), (11264, 880)])
def test_k1_plan(n_el, blocks):
    """K1's launch shape: one tangent per thread, 10 threads per element,
    128 threads a block; the SNMPC shape (11,264 elements) in 880 blocks,
    which 7 blocks per SM (at most 73 registers a thread) keep resident at
    once on 132 SMs; n_el < 1 refused."""
    assert linearize_plan(n_el) == LinearizePlan(128, blocks, 1, 10, 73)
    assert linearize_plan(11264).blocks <= 7 * 132
    with pytest.raises(ValueError):
        linearize_plan(0)


@pytest.mark.parametrize("N,nx,nu,nz,plan", [
    (38, 8, 2, 76, CondensePlan(32, 3, 8, 4 * (38 * 64 + 38 * 16 + 38 * 8))),   # K2, shipped
    (33, 8, 2, 76, CondensePlan(32, 3, 8, 4 * (33 * 64 + 33 * 16 + 33 * 8))),   # K6, shipped
    (1, 8, 2, 2, CondensePlan(32, 1, 8, 4 * (64 + 16 + 8))),
    (64, 8, 2, 128, CondensePlan(32, 5, 8, 4 * (64 * 64 + 64 * 16 + 64 * 8))),  # 129 columns
    (10, 16, 3, 30, CondensePlan(32, 1, 0, 4 * (10 * 256 + 10 * 48 + 10 * 16))),
    (12, 1, 1, 12, CondensePlan(32, 1, 0, 4 * (12 + 12 + 12))),
    (5, 3, 1, 31, CondensePlan(32, 1, 0, 4 * (48 + 16 + 16))),   # arrays padded to 4 floats
    (4, 3, 1, 32, CondensePlan(32, 2, 0, 4 * (36 + 12 + 12))),   # 33 columns: two blocks
])
def test_k2_k6_plan(N, nx, nu, nz, plan):
    """K2 / K6's launch shape: one thread per column of Gam and one for e,
    32 a block, so ceil((nz + 1) / 32) blocks per scenario; the unrolled
    body at nx = 8, the generic one otherwise; shared memory for the
    scenario's A, B and xi, each padded to a multiple of 16 bytes."""
    assert condense_plan(N, nx, nu, nz) == plan
    assert (plan.blocks - 1) * plan.threads < nz + 1 <= plan.blocks * plan.threads


@pytest.mark.parametrize("N,nx,nu,nz", [(38, 17, 2, 76), (38, 0, 2, 76), (0, 8, 2, 0),
                                        (38, 8, 0, 0), (300, 16, 2, 600), (38, 88, 2, 76)])
def test_k2_k6_plan_refuses(N, nx, nu, nz):
    """nx outside 1..16 (a column in registers), N < 1, nu < 1, or A, B, xi
    beyond the 227 KB of shared memory a block may have (300 stages at
    nx = 16: 330 KB)."""
    with pytest.raises(ValueError):
        condense_plan(N, nx, nu, nz)


@pytest.mark.parametrize("n,plan", [
    (1, SolvePlan(16, 20, 128, 4 * (16 * 20 + 16 * 16 + 32))),
    (17, SolvePlan(32, 36, 128, 4 * (32 * 36 + 32 * 16 + 64))),
    (76, SolvePlan(80, 84, 128, 32640)),
    (128, SolvePlan(128, 132, 128, 76800)),
])
def test_k5_plan(n, plan):
    """The solve's layout: L padded to a multiple of 16 rows, ld = npad + 4
    (= 4 mod 8), 128 threads (all stage L, warp 0 substitutes), shared
    memory for L, its transposed diagonal blocks, 1 / L_jj and x (above the
    default 48 KB only at n > 96); n outside 1..128 refused."""
    assert chol_solve_plan(n) == plan
    assert plan.ld % 8 == 4 and (plan.smem_bytes > 48 * 1024) == (n > 96)
    for bad in (0, MAX_N_CHOL + 1):
        with pytest.raises(ValueError):
            chol_solve_plan(bad)


@pytest.mark.parametrize("solve", [chol_solve_cuda, chol_solve_unblocked_cuda], ids=["K5", "K7"])
@pytest.mark.parametrize("case", ["n_in_range", "n_above_max", "n_zero", "non_contiguous",
                                  "cpu_cuda_mix", "float64", "rhs_shape"])
def test_k5_wrapper_refuses_before_launch(monkeypatch, solve, case):
    """The solve kernels' entry points take n in 1..MAX_N_CHOL and
    contiguous float32 tensors that all lie on the card, b of shape (B, n);
    anything else raises before the kernel's library is loaded, and no
    launch is counted. Loading the library stops the call here, which
    shows the launch was reached."""

    class Launched(Exception):
        pass

    def library(name):
        raise Launched(name)

    monkeypatch.setattr(tchol.build, "library", library)
    n = {"n_above_max": MAX_N_CHOL + 1, "n_zero": 0}.get(case, 76)
    L = torch.tril(T(_spd(2, n, seed=23))).float() if n else torch.zeros(2, 0, 0)
    b = torch.zeros(2, n)
    args = {"non_contiguous": (_OnCard(L.transpose(1, 2)), _OnCard(b)),
            "cpu_cuda_mix": (_OnCard(L), b),
            "float64": (_OnCard(L), _OnCard(b.double())),
            "rhs_shape": (_OnCard(L), _OnCard(torch.zeros(2, n + 1)))}.get(case,
                                                                          (_OnCard(L), _OnCard(b)))
    build.reset_launches()
    expected = {"n_in_range": Launched, "float64": TypeError}.get(case, ValueError)
    with pytest.raises(expected):
        solve(*args)
    assert all(v == 0 for v in build.LAUNCHES.values())
