"""The port's CUDA kernels on the card: each wrapper against its plain
PyTorch version on the same CUDA float32 inputs, the dispatch rule's
refusals, the launch counters, and a short closed loop of each ported
controller (nominal, R2NMPC and WMPC over R2NMPC: K1-K5; SNMPC: K1, K3-K6).
K7 and K8, which no path launches, are held on their own inputs (K8 also
bitwise against K2, and at N = 64). K4 is also held on its own, at ragged
and the shipped shapes and with a non-finite factor; K1 at the SNMPC shape
and at a ragged element count; K2 at ragged shapes (both kernel bodies), K6
from a carry dense in every column, K5 and the K7 solve with garbage above
L's diagonal; the kernels' own launch-shape queries against the Python
plans. The tuning loops' pieces: the planner on one lap per scenario
against the CPU, one RL env step and one BO objective chunk against the CPU
float64 run from the same state, each through K1-K5. One scenario (B = 1,
main.py's closed loop): K1 and K4 at that shape, and 5 steps of the entry
module's run_main through K1-K5. The tire gradient through K1-K5 (their
backward the plain versions' VJP) against the CPU. Two tools: profile_step's
per-stage kernel counts, and diag_precision --tf32 restoring the flags.
K1 with one tire set per scenario (its tire table) against its plain
version, against one shared-tire launch per member, and the table launch
bitwise against the shared-tire launch on the same values; one step of the
closed-loop tire fit under set_sync_debug_mode("error").
No host sync: steps of each loop path (WMPC: a policy period) and one
served cycle of the pipelined dispatcher under
torch.cuda.set_sync_debug_mode("error"). The evaluation tools at a tiny T:
each runs on the card and launches its path's kernels (and no other); the
acc24 propagation against the CPU's float64 one; the SB3 converter. The
host spans (utils/trace.py) inside a region captured in a CUDA graph.

Marked `cuda`; without a CUDA device every test skips. On a GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 on both sides in different operation orders, held for
each output as max |kernel - plain| <= tol * max(1, max |plain|); on an
ill-conditioned H the factorizations are held by backward error instead.
"""
import ctypes
import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    BACKWARD_TOL, NOMINAL_KERNELS, PATH_CONFIG, TOL_ENV, TOL_GRAD, TOL_OBJ, TRACKS_BO,
    backward_error, diffmode_gradient, diffmode_references, grad_gap, ipm_shaped_h, ipm_start,
    k4_args, make_env, random_qp, stacked_laps, without_sync,
)
from tum_control_tpu_torch.api import build_controller, build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels.chol import (
    MAX_N_CHOL, chol_plan, chol_solve, chol_solve_plan, chol_solve_ref, chol_solve_unblocked,
    chol_solve_unblocked_ref, cholesky, cholesky_ref, cholesky_unblocked, cholesky_unblocked_ref,
)
from tum_control_tpu_torch.ops.kernels.condense import (
    condense, condense_from, condense_from_ref, condense_mxu, condense_mxu_ref, condense_plan,
    condense_ref,
)
from tum_control_tpu_torch.ops.kernels.ipm_iter import fused_iteration, ipm_plan, iteration_ref
from tum_control_tpu_torch.ops.kernels.linearize import linearize_plan, linearize_ref
from tum_control_tpu_torch.parallel.mesh import batched_scenarios
from tum_control_tpu_torch.track.trajectory import load_ref_trajectory

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, tol):
    scale = max(1.0, float(ref.abs().max()))
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol * scale, (err, scale)


def _spd(B, n, seed, dev):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n + 4))
    H = A @ A.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    return torch.tensor(H, dtype=torch.float32, device=dev)


# K3 and K7 (one kernel body, csrc/chol.cu) over ragged and whole panels of 16
# up to the limit n = 128, one matrix, a few, and 130 (about one wave on 132
# SMs, not a multiple of 32)
CHOL_SHAPES = [(B, n) for B in (1, 3, 130) for n in (1, 12, 15, 16, 17, 33, 76, 80, 128)]
# kernel wrapper, plain version
FACTORS = {"K3": (cholesky, cholesky_ref), "K7": (cholesky_unblocked, cholesky_unblocked_ref)}


@pytest.mark.parametrize("B,n", CHOL_SHAPES)
def test_cholesky_and_solve_kernels(dev, B, n):
    H = _spd(B, n, 1, dev)
    b = torch.randn(B, n, device=dev, generator=torch.Generator(dev).manual_seed(0))
    build.reset_launches()
    L = cholesky(H)
    x = chol_solve(L, b)
    assert build.LAUNCHES["cholesky"] == 1 and build.LAUNCHES["chol_solve"] == 1
    _close(L, cholesky_ref(H), 1e-4)
    _close(x, chol_solve_ref(L, b), 1e-4)
    assert torch.count_nonzero(torch.triu(L, 1)) == 0


def test_linearize_and_condense_kernels(dev):
    ctrl = build_controller(MPCConfig(), SimConfig(), device=dev)
    lr = ctrl.engine.funcs.lin_rollout
    rng = np.random.default_rng(2)
    XU = np.concatenate([rng.uniform(-50, 50, (4, 38, 3)), rng.uniform(0, 30, (4, 38, 1)),
                         rng.normal(0, 0.3, (4, 38, 6))], axis=2)
    XU[0, :3, 3] = 0.0  # the low-speed guard
    XU = torch.tensor(XU, dtype=torch.float32, device=dev)
    F, J = lr(XU)
    from tum_control_tpu_torch.ops.kernels.linearize import linearize_ref
    Fp, Jp = linearize_ref(XU, lr.step, 8)
    _close(F, Fp, 1e-4)
    _close(J, Jp, 1e-4)
    A, Bm = J[..., :8].contiguous(), J[..., 8:].contiguous()
    xi = torch.randn(4, 38, 8, device=dev) * 0.01
    d0 = torch.randn(4, 8, device=dev)
    e, G = condense(A, Bm, xi, d0)
    ep, Gp = condense_ref(A, Bm, xi, d0)
    _close(e, ep, 1e-4)
    _close(G, Gp, 1e-4)


@pytest.mark.parametrize("B,N2,nz,col0", [(3, 5, 16, 4), (128, 33, 76, 10)])
def test_condense_from_kernel(dev, B, N2, nz, col0):
    """K6 against its plain version, small and at SNMPC's tail shapes, from
    a carry Gamma0 that is nonzero in its first col0 columns."""
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    A = t(0.95 * np.eye(8) + rng.normal(0, 0.03, (B, N2, 8, 8)))
    Bm = t(rng.normal(0, 1, (B, N2, 8, 2)))
    xi = t(rng.normal(0, 0.1, (B, N2, 8)))
    e0 = t(rng.normal(0, 1, (B, 8)))
    G0 = np.zeros((B, 8, nz))
    G0[..., :col0] = rng.normal(0, 1, (B, 8, col0))
    G0 = t(G0)
    build.reset_launches()
    e, G = condense_from(A, Bm, xi, e0, G0, col0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["condense_from"] == 1
    ep, Gp = condense_from_ref(A, Bm, xi, e0, G0, col0)
    _close(e, ep, 2e-5)
    _close(G, Gp, 2e-5)
    assert torch.equal(G[:, 0], G0) and torch.equal(e[:, 0], e0)


def _held(got, ref, tol=2e-5):
    """max |kernel - plain| <= tol * max |plain|, chip_smoke.py's rule."""
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), (err, float(ref.abs().max()))


# (B, N, nx, nu): one stage; a few; the shipped shape; nz = 128 (129 columns,
# 5 blocks a scenario); the generic body at nx = 16 and at nx = 1; 150 stages,
# whose A, B, xi (52,800 bytes) take the opt-in above 48 KB
K2_SHAPES = [(1, 1, 8, 2), (3, 5, 8, 2), (128, 38, 8, 2), (7, 64, 8, 2), (5, 10, 16, 3),
             (2, 12, 1, 1), (2, 150, 8, 2)]


@pytest.mark.parametrize("B,N,nx,nu", K2_SHAPES)
def test_condense_kernel_shapes(dev, B, N, nx, nu):
    """K2 against its plain version at ragged shapes: e and Gamma each to
    2e-5 of its max |plain|, stage 0 exactly (d0, 0); one launch."""
    rng = np.random.default_rng(40 + N)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    A = t(0.97 * np.eye(nx) + rng.normal(0, 0.05, (B, N, nx, nx)))
    Bm, xi = t(rng.normal(0, 1, (B, N, nx, nu))), t(rng.normal(0, 0.1, (B, N, nx)))
    d0 = t(rng.normal(0, 1, (B, nx)))
    build.reset_launches()
    e, G = condense(A, Bm, xi, d0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["condense"] == 1
    ep, Gp = condense_ref(A, Bm, xi, d0)
    _held(e, ep)
    _held(G, Gp)
    assert torch.equal(e[:, 0], d0) and torch.count_nonzero(G[:, 0]) == 0


def test_condense_from_kernel_dense_carry(dev):
    """K6 at SNMPC's tail shape (128 scenarios, 33 stages, nz = 76,
    col0 = 10) from a carry Gamma0 that is nonzero in every column: no
    column may be taken for zero. e and Gamma each to 2e-5 of max |plain|."""
    rng = np.random.default_rng(43)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    B, N2, nz, col0 = 128, 33, 76, 10
    A = t(0.95 * np.eye(8) + rng.normal(0, 0.03, (B, N2, 8, 8)))
    Bm, xi = t(rng.normal(0, 1, (B, N2, 8, 2))), t(rng.normal(0, 0.1, (B, N2, 8)))
    e0, G0 = t(rng.normal(0, 1, (B, 8))), t(rng.normal(0, 1, (B, 8, nz)))
    assert torch.count_nonzero(G0) == G0.numel()
    build.reset_launches()
    e, G = condense_from(A, Bm, xi, e0, G0, col0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["condense_from"] == 1
    ep, Gp = condense_from_ref(A, Bm, xi, e0, G0, col0)
    _held(e, ep)
    _held(G, Gp)
    assert torch.equal(G[:, 0], G0) and torch.equal(e[:, 0], e0)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 76, 80, 128])
@pytest.mark.parametrize("kernel", ["K5", "K7"])
def test_chol_solve_reads_only_the_lower_triangle(dev, kernel, n):
    """K5 and the K7 solve with large garbage (and a NaN) above L's
    diagonal give the plain version's solution on the clean factor: to 2e-5
    of max |plain|; one launch each. 130 systems, ragged and whole blocks of
    16 up to the limit n = 128."""
    solve, ref = {"K5": (chol_solve, chol_solve_ref),
                  "K7": (chol_solve_unblocked, chol_solve_unblocked_ref)}[kernel]
    L = torch.linalg.cholesky(_spd(130, n, 44, dev)).contiguous()
    b = torch.randn(130, n, device=dev, generator=torch.Generator(dev).manual_seed(2))
    junk = torch.triu(torch.full_like(L, 1e30), 1)
    if n > 1:
        junk[:, 0, n - 1] = float("nan")
    build.reset_launches()
    x = solve(L + junk, b)
    torch.cuda.synchronize()
    counter = {"K5": "chol_solve", "K7": "chol_solve_unblocked"}[kernel]
    assert build.LAUNCHES[counter] == 1
    _held(x, ref(L, b))


def test_condense_plan_matches_the_kernel(dev):
    """csrc/condense.cu's launch shape of K2 / K6 at each (N, nx, nu, nz)
    equals condense_plan's, and both refuse the same shapes."""
    lib = build.library("condense")
    out = (ctypes.c_int * 4)()
    for N, nx, nu, nz in [(38, 8, 2, 76), (33, 8, 2, 76), (1, 8, 2, 2), (64, 8, 2, 128),
                          (10, 16, 3, 30), (12, 1, 1, 12), (5, 3, 1, 31), (38, 17, 2, 76),
                          (0, 8, 2, 0), (38, 8, 0, 0), (300, 16, 2, 600), (200, 16, 2, 400),
                          (150, 8, 2, 300)]:
        ok = lib.condense_launch_plan(N, nx, nu, nz, out) == 0
        try:
            plan = condense_plan(N, nx, nu, nz)
        except ValueError:
            assert not ok, (N, nx, nu, nz)
            continue
        assert ok and tuple(out) == tuple(plan), (N, nx, nu, nz, tuple(out), plan)


def test_chol_solve_plan_matches_the_kernel(dev):
    """csrc/chol.cu's solve layout at every n equals chol_solve_plan's, and
    both refuse n outside 1..MAX_N_CHOL."""
    lib = build.library("chol")
    out = (ctypes.c_int * 4)()
    for n in range(1, MAX_N_CHOL + 1):
        assert lib.chol_solve_plan(n, out) == 0
        assert tuple(out) == tuple(chol_solve_plan(n)), n
    assert lib.chol_solve_plan(0, out) == -1 and lib.chol_solve_plan(MAX_N_CHOL + 1, out) == -1


@pytest.mark.parametrize("B,n", CHOL_SHAPES)
def test_unblocked_cholesky_and_solve_kernels(dev, B, n):
    """K7 against its plain versions (the same pivot loops)."""
    H = _spd(B, n, 6, dev)
    b = torch.randn(B, n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    build.reset_launches()
    L = cholesky_unblocked(H)
    x = chol_solve_unblocked(L, b)
    torch.cuda.synchronize()
    assert build.LAUNCHES["cholesky_unblocked"] == 1 and build.LAUNCHES["chol_solve_unblocked"] == 1
    _close(L, cholesky_unblocked_ref(H), 2e-5)
    _close(x, chol_solve_unblocked_ref(L, b), 2e-5)
    assert torch.count_nonzero(torch.triu(L, 1)) == 0


@pytest.mark.parametrize("kernel", list(FACTORS))
def test_cholesky_ill_conditioned_by_backward_error(dev, kernel):
    """An IPM-shaped H of cond ~1e7-1e8, where two float32 orders of one
    factorization part by more than 2e-5 of max |L| without either being
    wrong: held by backward error, max |L L^T - H| / max |H| <= 2e-5 (n eps
    ~4.5e-6 at n = 76) and at most twice the plain version's own."""
    fn, ref = FACTORS[kernel]
    H = torch.tensor(ipm_shaped_h(np.random.default_rng(8), 130, 76, 78), device=dev)
    L, Lp = fn(H), ref(H)
    assert torch.isfinite(L).all() and torch.isfinite(Lp).all()
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    be, be_plain = backward_error(L, H), backward_error(Lp, H)
    assert be <= BACKWARD_TOL and be <= 2.0 * be_plain, (be, be_plain)


@pytest.mark.parametrize("kernel", list(FACTORS))
@pytest.mark.parametrize("n", [17, 76])
def test_cholesky_non_spd_gives_non_finite_factor(dev, kernel, n):
    """A matrix with a negative diagonal entry has a negative pivot: its
    factor is non-finite, in exactly the matrices where the plain version's
    is, and every other matrix of the batch keeps its finite factor."""
    fn, ref = FACTORS[kernel]
    H = _spd(130, n, 9, dev)
    bad = torch.zeros(130, dtype=torch.bool, device=dev)
    for k, j in ((0, 0), (7, n // 2), (64, n - 1), (129, 15 % n)):
        H[k, j, j] = -1.0
        bad[k] = True
    L, Lp = fn(H), ref(H)
    torch.cuda.synchronize()
    assert torch.equal(~torch.isfinite(L).all(dim=(1, 2)), bad)
    assert torch.equal(~torch.isfinite(Lp).all(dim=(1, 2)), bad)
    _close(L[~bad], Lp[~bad], 2e-5)


def test_cholesky_plan_matches_the_kernel(dev):
    """csrc/chol.cu's shared-memory size at every n equals chol_plan's, and
    both refuse n outside 1..MAX_N_CHOL."""
    lib = build.library("chol")
    for n in range(1, MAX_N_CHOL + 1):
        assert lib.cholesky_smem_bytes(n) == chol_plan(n).smem_bytes, n
    assert lib.cholesky_smem_bytes(0) == -1 and lib.cholesky_smem_bytes(MAX_N_CHOL + 1) == -1


def _k8_inputs(B, N, dev, seed=7):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    A = t(0.97 * np.eye(8) + rng.normal(0, 0.05, (B, N, 8, 8)))
    Bm, xi = t(rng.normal(0, 1, (B, N, 8, 2))), t(rng.normal(0, 0.1, (B, N, 8)))
    return A, Bm, xi, t(rng.normal(0, 1, (B, 8)))


@pytest.mark.parametrize("B,N", [(3, 5), (128, 38), (2, 64)])
def test_condense_mxu_kernel(dev, B, N):
    """K8 against its plain version, small, at the nominal shapes and at
    N = 64 (nz + 1 = 129 columns, five blocks a scenario); e also against
    K2's e on the same inputs."""
    A, Bm, xi, d0 = _k8_inputs(B, N, dev)
    build.reset_launches()
    e, G = condense_mxu(A, Bm, xi, d0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["condense_mxu"] == 1
    ep, Gp = condense_mxu_ref(A, Bm, xi, d0)
    _close(e, ep, 2e-5)
    _close(G, Gp, 2e-5)
    _close(e, condense(A, Bm, xi, d0)[0], 2e-5)
    assert torch.equal(e[:, 0], d0) and torch.count_nonzero(G[:, 0]) == 0


@pytest.mark.parametrize("B", [128, 1])
def test_condense_mxu_equals_condense_bitwise(dev, B):
    """K8 is K2's kernel writing one augmented tensor: assigning B_k to a
    column that holds only +-0 equals K2's addition bit for bit, so both
    outputs equal K2's exactly."""
    args = _k8_inputs(B, 38, dev, seed=11)
    e8, G8 = condense_mxu(*args)
    e2, G2 = condense(*args)
    torch.cuda.synchronize()
    assert torch.equal(e8, e2) and torch.equal(G8, G2)


@pytest.mark.parametrize("nx,N", [(17, 4), (16, 300), (8, 700)])
def test_condense_mxu_refuses_what_it_cannot_hold(dev, nx, N):
    """K8 refuses what K2 refuses (condense_plan): more than 16 states (a
    column in registers), inputs beyond 227 KB of shared memory; the wrapper
    raises and launches nothing."""
    A = torch.zeros(2, N, nx, nx, device=dev)
    args = (A, torch.zeros(2, N, nx, 2, device=dev), torch.zeros(2, N, nx, device=dev),
            torch.zeros(2, nx, device=dev))
    with pytest.raises(ValueError):
        condense_plan(N, nx, 2, N * 2)
    build.reset_launches()
    with pytest.raises(ValueError):
        condense_mxu(*args)
    assert build.LAUNCHES["condense_mxu"] == 0


def test_condense_mxu_refuses_what_the_kernel_does_not_take(dev):
    """float64 and a non-contiguous input: refused before any launch."""
    A, Bm, xi, d0 = _k8_inputs(2, 5, dev)
    build.reset_launches()
    with pytest.raises(TypeError):
        condense_mxu(A.double(), Bm.double(), xi.double(), d0.double())
    with pytest.raises(ValueError):
        condense_mxu(A.transpose(2, 3), Bm, xi, d0)
    assert build.LAUNCHES["condense_mxu"] == 0


def test_condense_refuses_wide_states_on_the_card(dev):
    """nx = 88 (SNMPC's dense stack) exceeds K2's shared-memory layout:
    `condense` raises on the card and launches nothing."""
    g = torch.Generator(dev).manual_seed(5)
    A = torch.eye(88, device=dev) + 0.01 * torch.randn(2, 4, 88, 88, device=dev, generator=g)
    Bm = torch.randn(2, 4, 88, 2, device=dev, generator=g)
    xi = torch.randn(2, 4, 88, device=dev, generator=g)
    d0 = torch.randn(2, 88, device=dev, generator=g)
    build.reset_launches()
    with pytest.raises(ValueError):
        condense(A, Bm, xi, d0)
    assert build.LAUNCHES["condense"] == 0


def test_dispatch_refuses_what_the_kernels_do_not_take(dev):
    H = _spd(2, 8, 3, dev)
    with pytest.raises(TypeError):
        cholesky(H.double())
    with pytest.raises(ValueError):
        cholesky(H.transpose(1, 2))
    with pytest.raises(ValueError):
        chol_solve(H, torch.zeros(2, 8))  # one tensor on the CPU


def _k4_case(B, nz, ncg, seed, dev):
    """A random soft QP's first IPM iteration: K4's inputs before the
    carry, with the factor of H taken in float64, and the carry."""
    qp = random_qp(np.random.default_rng(seed), dev, B, nz, ncg)
    carry, nt, H = ipm_start(qp)
    L = torch.tensor(np.linalg.cholesky(H.double().cpu().numpy()), dtype=torch.float32, device=dev)
    return k4_args(qp, carry, nt, L), carry


# ragged nz (one, two and three substitution blocks, each with a padded tail),
# batches that are not a multiple of 32, and the shipped shape, also for one
# scenario (main.py's closed loop)
K4_SHAPES = [(3, 5, 6), (130, 17, 20), (7, 40, 44), (128, 76, 78), (1, 76, 78)]


@pytest.mark.parametrize("B,nz,ncg", K4_SHAPES)
def test_ipm_iteration_kernel(dev, B, nz, ncg):
    """K4 against iteration_ref on the same float32 inputs: every carry
    output and sigma to 1e-4 (float32 in two operation orders through a
    factor of cond ~1e3), the unconverged flags equal; one launch."""
    args, carry = _k4_case(B, nz, ncg, 30 + nz, dev)
    build.reset_launches()
    kc, ksig, kunc = fused_iteration(*args, carry)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ipm_iteration"] == 1
    pc, psig, punc = iteration_ref(*args, carry)
    for g, r in zip(kc + (ksig,), pc + (psig,)):
        _close(g, r, 1e-4)
    assert torch.equal(kunc, punc)


def test_ipm_iteration_keeps_the_carry_of_a_non_finite_factor(dev):
    """A factor with a NaN (what a failed factorization leaves) gives a
    non-finite direction: that scenario keeps its carry, its sigma is the
    carry's, `unconverged` is the plain version's, and every other
    scenario of the batch is held as usual."""
    args, carry = _k4_case(130, 76, 78, 41, dev)
    L = args[0].clone()
    bad = torch.zeros(130, dtype=torch.bool, device=dev)
    for k, i, j in ((0, 5, 3), (64, 75, 75), (129, 40, 0)):
        L[k, i, j] = float("nan")
        bad[k] = True
    args = (L,) + args[1:]
    kc, ksig, kunc = fused_iteration(*args, carry)
    pc, psig, punc = iteration_ref(*args, carry)
    torch.cuda.synchronize()
    assert torch.equal(kunc, punc)
    for g, c in zip(kc, carry):
        assert torch.equal(g[bad], c[bad])
    for g, r in zip(kc + (ksig,), pc + (psig,)):
        assert torch.isfinite(g).all()
        _close(g[~bad], r[~bad], 1e-4)


def test_ipm_iteration_plan_matches_the_kernel(dev):
    """csrc/ipm_iter.cu's launch shape at each (nz, ncg) equals ipm_plan's,
    and both refuse the same shapes."""
    lib = build.library("ipm_iter")
    out = (ctypes.c_int * 6)()
    for nz in (1, 5, 16, 17, 40, 76, 80, 96, 128):
        for ncg in (0, 3, 20, 78, 200, 384, 500):
            ok = lib.ipm_iteration_plan(nz, ncg, out) == 0
            try:
                plan = ipm_plan(nz, ncg)
            except ValueError:
                assert not ok, (nz, ncg)
                continue
            assert ok and tuple(out) == plan[:6], (nz, ncg, tuple(out), plan)


@pytest.mark.parametrize("case", ["snmpc", "ragged", "single"])
def test_linearize_kernel_shapes(dev, case):
    """K1 at the SNMPC shape (128 scenarios x 88 elements, one RK4 substep),
    at 3 x 37 elements of the nominal step (a ragged last block) and at one
    scenario's 38 (main.py's closed loop: one block, mostly idle lanes), on
    states spread about starts along the lap as chip_smoke.py draws them:
    F and every column of J to 2e-5 of its max |plain|; one launch. (Near
    standstill, where an RK4 stage crosses the low-speed guard and J grows
    as 1 / vlong^2, two float32 orders part by more; the guard is held in
    test_linearize_and_condense_kernels.)"""
    if case == "snmpc":
        lr = build_controller(MPCConfig(controller="snmpc"), SimConfig(), device=dev).lin_roll8
        B, N = 128, 88
    else:
        lr = build_controller(MPCConfig(), SimConfig(), device=dev).engine.funcs.lin_rollout
        B, N = (3, 37) if case == "ragged" else (1, 38)
    rng = np.random.default_rng(11)
    traj = load_ref_trajectory(os.path.join(SimConfig().trajectory_path,
                                            SimConfig().ref_traj_file), torch.float64, device="cpu")
    x0, _ = batched_scenarios(traj, B, dtype=torch.float64)
    X = x0.numpy()[:, None, :] + rng.normal(0, 1, (B, N, 8)) * [0.5, 0.5, 0.05, 1, 0.1, 0.05,
                                                                0.02, 0.5]
    XU = np.concatenate([X, rng.normal(0, 1, (B, N, 2)) * [1.0, 0.1]], axis=2)
    XU = torch.tensor(XU, dtype=torch.float32, device=dev)
    build.reset_launches()
    F, J = lr(XU)
    torch.cuda.synchronize()
    assert build.LAUNCHES["linearize"] == 1
    Fp, Jp = linearize_ref(XU, lr.step, 8)
    for g, r in [(F, Fp)] + [(J[..., c], Jp[..., c]) for c in range(10)]:
        err = float((g.double() - r.double()).abs().max())
        assert err <= 2e-5 * float(r.abs().max()), err


def test_linearize_plan_matches_the_kernel(dev):
    """csrc/linearize.cu's launch shape at each element count equals
    linearize_plan's."""
    lib = build.library("linearize")
    out = (ctypes.c_int * 4)()
    for n_el in (1, 111, 4864, 11264, 100000):
        assert lib.linearize_launch_plan(n_el, out) == 0
        assert tuple(out) == linearize_plan(n_el)[:4], n_el
    assert lib.linearize_launch_plan(0, out) == -1


# launches over 5 closed-loop steps, per path of chip_smoke.PATH_CONFIG: one K1 and one
# condensing launch per step, 3 IPM iterations (K3 + K4) and one polish (K3 + K5)
NOMINAL_LAUNCHES = {"linearize": 5, "condense": 5, "condense_from": 0, "cholesky": 20,
                    "chol_solve": 5, "ipm_iteration": 15, "condense_mxu": 0,
                    "cholesky_unblocked": 0, "chol_solve_unblocked": 0}
PATH_LAUNCHES = {
    "nominal": NOMINAL_LAUNCHES,
    "snmpc": dict(NOMINAL_LAUNCHES, condense=0, condense_from=5),
    "rnmpc": NOMINAL_LAUNCHES,
    "wmpc_rnmpc": NOMINAL_LAUNCHES,
    "nominal_external": NOMINAL_LAUNCHES,
}


@pytest.mark.parametrize("path", list(PATH_CONFIG))
def test_short_closed_loop_goes_through_every_kernel(dev, path):
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(**PATH_CONFIG[path]))
    x0m, x0s = batched_scenarios(traj, 4, dtype=torch.float32, device=dev)
    build.reset_launches()
    carry, log = sim.run(x0m, x0s, 5)
    torch.cuda.synchronize()
    assert build.LAUNCHES == PATH_LAUNCHES[path]
    assert (log.simSolverDebug[..., 4] == 0).all()
    for f, v in log._asdict().items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), f
    wmpc = PATH_CONFIG[path].get("enable_WMPC", False)
    assert ((log.wmpc_action >= 0) if wmpc else (log.wmpc_action == -1)).all()


def test_planner_per_scenario_laps_on_card(dev):
    """The planner on one lap per scenario (two laps, poses near both ends)
    on the card against the same float32 inputs on the CPU."""
    from tum_control_tpu_torch.track.planner import planner_emulator
    from tum_control_tpu_torch.track.trajectory import select_laps

    laps = torch.tensor([0, 1, 1, 0, 1, 0])
    stacked = stacked_laps(TRACKS_BO, "cpu", torch.float32)
    idx = torch.tensor([10, 500, 998, 1185, 3, 700])
    pose = stacked.pos[laps, idx] + 0.3
    c_cpu, w_cpu = planner_emulator(select_laps(stacked, laps), pose, 3.04, 39)
    on_card = stacked_laps(TRACKS_BO, dev, torch.float32)
    c, w = planner_emulator(select_laps(on_card, laps.to(dev)), pose.to(dev), 3.04, 39)
    assert torch.equal(c.cpu(), c_cpu)
    for f in ("pos", "yaw", "v"):
        _close(getattr(w, f).cpu(), getattr(w_cpu, f), 1e-6)


def test_env_step_on_card_matches_cpu(dev):
    """One RL env step (4 envs on both laps, 3 closed-loop steps) on the card
    against the CPU float64 step from the same reset: obs and reward within
    chip_smoke.TOL_ENV, and every nominal kernel launched."""
    from tum_control_tpu_torch.learn.env import RLEnvConfig

    envs = {d: make_env(d, dt) for d, dt in ((dev, torch.float32), ("cpu", torch.float64))}
    out = {}
    for d, env in envs.items():
        env.cfg = RLEnvConfig(n_mpc_steps=3)
        track = torch.tensor([0, 1, 1, 0], device=env.device)
        ridx = torch.tensor([0, 100, 400, 800], device=env.device)
        es, _ = env.reset_from(track, ridx, None)
        action = torch.tensor([0, 5, 12, 25], device=env.device)
        if d == dev:
            build.reset_launches()
        out[d] = env.step(es, action, (track, ridx))
        if d == dev:
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
    assert launches == {k: 3 * v // 5 for k, v in NOMINAL_LAUNCHES.items()}
    for i in (1, 2):
        err = float((out[dev][i].double().cpu() - out["cpu"][i]).abs().max())
        assert err <= TOL_ENV, (i, err)
    assert torch.equal(out[dev][3].cpu(), out["cpu"][3])


def test_objective_chunk_on_card_matches_cpu(dev):
    """One BO objective chunk (4 (candidate, segment) pairs on the two laps,
    20 steps) on the card against the CPU float64 chunk: feasibility equal,
    objectives within chip_smoke.TOL_OBJ, and every nominal kernel launched.

    The crashing pair crashes at its first step in float32 and float64 alike
    (a_comb ~9.4 against 1.02). Weights that extreme sit on the edge
    elsewhere: [30, 0, 30, 0, 20, 500, 500] from Modena's index 45 crashes at
    step 0 in float64 (a_comb 8.5) but at step 3 in float32, and with
    q_yaw = 5 the float32 first solve fails (status 3, the plant coasts)
    where float64's returns a finite crash; so no such pair is used here.
    The JAX package's float32 objective counts both of those pairs feasible
    over 20 steps (tests/test_torch_bo_feasibility.py): float64 and float32
    part there in the reference too."""
    from tum_control_tpu_torch.learn.bo.objective import ObjectiveEvaluator

    P = np.array([[10, 2, 10, 2, 200, 1000, 1000], [10, 2, 10, 2, 200, 1000, 1000],
                  [30, 0, 30, 0, 20, 500, 500], [1, 5, 1, 6, 400, 2000, 2000]], float)
    tr, st, en = torch.tensor([0, 1, 1, 0]), torch.tensor([45, 600, 600, 45]), \
        torch.tensor([236, 608, 608, 236])
    res = {}
    for d, dt in ((dev, torch.float32), ("cpu", torch.float64)):
        sim = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device=d, dtype=dt)[0]
        ev = ObjectiveEvaluator(sim, stacked_laps(TRACKS_BO, d, dt), max_steps=20)
        p = torch.tensor(P, dtype=dt, device=d)
        if d == dev:
            build.reset_launches()
        res[d] = ev.run_chunk(p, tr.to(d), st.to(d), en.to(d))
        if d == dev:
            torch.cuda.synchronize()
            assert all(build.LAUNCHES[k] > 0 for k in
                       ("linearize", "condense", "cholesky", "chol_solve", "ipm_iteration"))
    f, feas = (a.cpu() for a in res[dev])
    assert feas.tolist() == [True, True, False, True]
    assert torch.equal(feas, res["cpu"][1])
    assert torch.equal(torch.isnan(f), torch.isnan(res["cpu"][0]))
    assert float((f.double() - res["cpu"][0]).nan_to_num().abs().max()) <= TOL_OBJ


def test_run_main_single_scenario_goes_through_every_kernel(dev, tmp_path):
    """main.py's closed loop on the card: one scenario (B = 1) of the shipped
    configs for 5 steps in float32, plots off: the logs in the reference
    layout, finite, every solve ok, and K1-K5 launched (5 steps and the
    warm-up chunk) and no other kernel."""
    from tum_control_tpu_torch import main as entry_main

    build.reset_launches()
    logs, summary, wall = entry_main.main(["--T", "0.1", "--no-plots", "--logs-path",
                                           str(tmp_path)])
    torch.cuda.synchronize()
    steps = 5 + entry_main.WARMUP_STEPS
    assert build.LAUNCHES == {k: v // 5 * steps for k, v in NOMINAL_LAUNCHES.items()}
    assert logs["simU"].shape == (5, 2) and logs["CiLX"].shape == (6, 7)
    for k, v in logs.items():
        assert np.isfinite(v).all(), k
    assert (logs["simSolverDebug"][:, 1] > 0).all()
    assert summary["solver_ok_frac"] == 1.0 and wall > 0


def test_tire_gradient_through_the_kernels_matches_cpu(dev):
    """The closed-loop tire gradient on the card, K1-K5 in the forward and the
    plain versions' VJP in the backward (ops/diffmode.py), against the
    nearest of the CPU's reference gradients per component, as chip_smoke's
    diffmode phase (TOL_GRAD: the float32 loop's gradient is bimodal there)."""
    build.reset_launches()
    g32 = diffmode_gradient(dev, torch.float32)[0]
    for name in NOMINAL_KERNELS:
        assert build.LAUNCHES[name] > 0, name
    refs = diffmode_references(diffmode_gradient("cpu", torch.float64)[0])
    gaps = {name: grad_gap(g32, r) for name, r in refs.items()}
    assert min(float(g.max()) for g in gaps.values()) <= TOL_GRAD, gaps


def test_diag_precision_tf32_restores_the_flags(dev):
    """diag_precision --tf32 turns TF32 on for its run only."""
    from tum_control_tpu_torch.tools import diag_precision

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    rows = diag_precision.main(["--tf32", "--steps", "3", "--settle", "1"])
    assert len(rows) == 5 and all(np.isfinite(r["run_max"]) for r in rows)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


def test_profile_step_counts_each_stage_on_the_card(dev):
    """profile_step at B = 4 on the card: every stage's profiler window
    holds device kernels; the QP stages launch K1-K5 (build_qp K1 and K2,
    the IPM K3-K5), the planner none of them."""
    from tum_control_tpu_torch.tools import profile_step

    res = profile_step.main(["4", "--repeats", "2"])["nominal"]
    for name, r in res.items():
        assert r["kernels"] > 0 and r["device_ms"] > 0 and r["ms"] > 0, name
    assert res["planner"]["launches"] == {}
    assert set(res["build_qp"]["launches"]) == {"linearize", "condense"}
    assert set(res["ipm+polish"]["launches"]) == {"cholesky", "ipm_iteration", "chol_solve"}
    assert set(res["full step"]["launches"]) == set(NOMINAL_KERNELS)


@pytest.mark.parametrize("path", list(PATH_CONFIG))
def test_loop_steps_make_no_host_sync(dev, path):
    """Under torch.cuda.set_sync_debug_mode("error") (chip_smoke.without_sync)
    no op of a step may make the host wait for the card."""
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(**PATH_CONFIG[path]))
    x0m, x0s = batched_scenarios(traj, 4, dtype=torch.float32, device=dev)
    carry, _ = sim.run(x0m, x0s, 2)
    n = getattr(sim.controller, "period", 1)
    carry, log = without_sync(lambda: sim.run_from(carry, n), path, n)
    assert (log.simSolverDebug[..., 4] == 0).all() and torch.isfinite(log.simU).all()


def test_served_cycle_makes_no_host_sync(dev):
    from tum_control_tpu_torch.deploy_rt import PACKED, dispatch_step

    sim, x0m, x0s, _, _ = build_simulation(SimConfig(sim_mode=0, T=0.1), MPCConfig())
    carry = sim.init_carry(x0m[None], x0s[None], key=0)
    zeros = torch.zeros_like(carry.x_sim)
    rows = torch.empty((2, PACKED), dtype=torch.float32, pin_memory=True)
    carry, ev = dispatch_step(sim, carry, zeros, rows[0])
    ev.synchronize()
    carry, ev = without_sync(lambda: dispatch_step(sim, carry, zeros, rows[1]), "serve", 1)
    ev.synchronize()
    assert torch.isfinite(rows).all() and float(rows[1, 6]) == 0.0


EVAL_TOOLS = {
    "one_lap": ["monteblanco", "snmpc", "0.1"],
    "quality_exp": ["2", "--T", "0.1"],
    "multitrack_eval": ["0.04"],
    "wmpc_eval": ["data/wmpc_models/new_BO_F", "0.1", "lvms"],
    "rl_protocol_eval": ["0.04", "data/wmpc_models/new_BO_F"],
    "catalog_noise_validation": ["--T", "0.04", "--seeds", "1", "--tracks", "lvms",
                                 "--catalogs", "data/F.csv"],
}


@pytest.mark.parametrize("name", sorted(EVAL_TOOLS))
def test_evaluation_tool_on_the_card(dev, name, tmp_path):
    import importlib

    from chip_smoke import tool_kernels

    argv = EVAL_TOOLS[name]
    if name == "catalog_noise_validation":
        argv = argv + ["--out", str(tmp_path / "cat.json")]
    mod = importlib.import_module(f"tum_control_tpu_torch.tools.{name}")
    build.reset_launches()
    res = mod.main(argv)
    torch.cuda.synchronize()
    launched = {k for k, n in build.LAUNCHES.items() if n}
    assert launched == set(tool_kernels(name, argv)), launched
    rows = res if isinstance(res, list) else [res]
    for r in rows:
        for lap in r.get("laps", [r]):
            if "log" in lap:
                assert lap["ok"] == 1.0 and np.isfinite(lap["lat_max"])
    if name == "catalog_noise_validation":
        assert res["runs"]["data/F.csv"]["max_lat"].shape == (26, 1, 1)


def test_acc24_propagation_on_the_card(dev):
    from chip_smoke import TOL_PROPAGATION
    from tum_control_tpu_torch.scripts.acc24_figures import propagate

    build.reset_launches()
    got = propagate()[0]
    assert not any(build.LAUNCHES.values())
    ref = propagate("cpu", torch.float64)[0]
    assert got.shape == ref.shape == (15, 11, 8)
    assert np.abs(got - ref).max() <= TOL_PROPAGATION * np.abs(ref).max()


def test_sb3_converter_loads_on_the_card(dev, tmp_path):
    from chip_smoke import make_sb3_checkpoint
    from tum_control_tpu_torch.tools import convert_sb3_checkpoint

    make_sb3_checkpoint(str(tmp_path / "src"))
    assert convert_sb3_checkpoint.main([str(tmp_path / "src"), str(tmp_path / "out")]) == \
        ["new_BO_F"]
    assert (tmp_path / "out" / "new_BO_F" / "rl_config.yaml").exists()


def _tire_inputs(dev, B, N, seed):
    """K1 inputs about lap states (as test_linearize_kernel_shapes draws
    them) and B tire sets: the shipped set times exp(theta_b), theta_b ~
    N(0, 0.05^2) per coefficient."""
    from tum_control_tpu_torch.params import TireParams

    rng = np.random.default_rng(seed)
    traj = load_ref_trajectory(os.path.join(SimConfig().trajectory_path,
                                            SimConfig().ref_traj_file), torch.float64, device="cpu")
    x0, _ = batched_scenarios(traj, B, dtype=torch.float64)
    X = x0.numpy()[:, None, :] + rng.normal(0, 1, (B, N, 8)) * [0.5, 0.5, 0.05, 1, 0.1, 0.05,
                                                                0.02, 0.5]
    XU = np.concatenate([X, rng.normal(0, 1, (B, N, 2)) * [1.0, 0.1]], axis=2)
    tp0 = build_controller(MPCConfig(), SimConfig(), device=dev).tp
    vals = np.exp(np.log(np.array(tp0[:8])) + rng.normal(0, 0.05, (B, 8)))
    tp = TireParams(*torch.tensor(vals.T, dtype=torch.float32, device=dev).unbind(0), mu=tp0.mu)
    return torch.tensor(XU, dtype=torch.float32, device=dev), tp, vals, tp0.mu


@pytest.mark.parametrize("case", ["nominal", "snmpc_uph15"])
def test_linearize_per_scenario_tires(dev, case):
    """K1 with one tire set per scenario (its table) against its plain
    version with (B,) tires, at the nominal shape (128 x 38, 3 substeps)
    and at the SNMPC's at UPH 15 (128 x 188, one substep), to 2e-5 of each
    output's max; one launch."""
    from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout

    N, n_sub = (38, 3) if case == "nominal" else (15 * 11 + 23, 1)
    XU, tp, _, _ = _tire_inputs(dev, 128, N, 12)
    vp = build_controller(MPCConfig(), SimConfig(), device=dev).vp
    lin = LinearizeRollout(vp, tp, 0.08, n_sub)
    build.reset_launches()
    F, J = lin(XU)
    torch.cuda.synchronize()
    assert build.LAUNCHES["linearize"] == 1
    Fp, Jp = linearize_ref(XU, lin.step, 8)
    for g, r in [(F, Fp)] + [(J[..., c], Jp[..., c]) for c in range(10)]:
        err = float((g.double() - r.double()).abs().max())
        assert err <= 2e-5 * float(r.abs().max()), err


def test_linearize_per_scenario_tires_equal_member_launches(dev):
    """K1 over a batch with one tire set per scenario equals one launch of
    the shared-tire kernel per member with that member's set as floats, to
    2e-5 of each output's max (the table's constants come from float32 tire
    values, the argument block's from float64 ones)."""
    from tum_control_tpu_torch.ops.kernels.linearize import LinearizeRollout
    from tum_control_tpu_torch.params import TireParams

    XU, tp, vals, mu = _tire_inputs(dev, 6, 38, 13)
    vp = build_controller(MPCConfig(), SimConfig(), device=dev).vp
    F, J = LinearizeRollout(vp, tp, 0.08, 3)(XU)
    for b in range(6):
        lin1 = LinearizeRollout(vp, TireParams(*vals[b], mu=mu), 0.08, 3)
        assert lin1.table is None
        F1, J1 = lin1(XU[b:b + 1].contiguous())
        for g, r in ((F[b:b + 1], F1), (J[b:b + 1], J1)):
            err = float((g.double() - r.double()).abs().max())
            assert err <= 2e-5 * float(r.abs().max()), (b, err)


def test_linearize_table_launch_equals_the_shared_launch(dev):
    """The shared-tire launch (the argument block's tires, the controllers'
    path) and the table launch whose every row holds that block's own tire
    values give the same bits, at the nominal and the SNMPC shapes."""
    from chip_smoke import TABLE_SLOTS
    from tum_control_tpu_torch.ops.kernels.linearize import linearize_cuda

    for ctrl_name, N in (("nominal", 38), ("snmpc", 88)):
        ctrl = build_controller(MPCConfig(controller=ctrl_name), SimConfig(), device=dev)
        lin = ctrl.lin_rollout if ctrl_name == "nominal" else ctrl.lin_roll8
        XU, _, _, _ = _tire_inputs(dev, 16, N, 14)
        rows = torch.tensor([list(lin.prm)[i] for i in TABLE_SLOTS], dtype=torch.float32,
                            device=dev)
        F1, J1 = linearize_cuda(XU, lin.prm, lin.n_sub)
        for table in (rows[None], rows.expand(16, -1).contiguous()):
            F2, J2 = linearize_cuda(XU, lin.prm, lin.n_sub, tires=table)
            assert torch.equal(F1, F2) and torch.equal(J1, J2), ctrl_name


def test_fit_step_makes_no_host_sync(dev, tmp_path):
    """One step of the closed-loop tire fit (tires replaced from theta, the
    closed-loop step, the sanitizer) under set_sync_debug_mode("error"), on
    a golden pair the card writes."""
    from chip_smoke import without_sync
    from tum_control_tpu_torch.tools import fit_tires_closedloop as cl
    from tum_control_tpu_torch.tools import tire_fit

    paths = []
    for name, cfg in (("nominal", MPCConfig()), ("snmpc", MPCConfig(**tire_fit.SNMPC))):
        paths.append(str(tmp_path / name / "full_logs.npz"))
        tire_fit.write_golden(paths[-1], cfg, 8, "EDGAR/pacejka_params_2023fit.yaml", dev,
                              torch.float32, start=240)
    args = cl.parse_args(["--golden", paths[0], "--golden-snmpc", paths[1], "--n-chunks", "2",
                          "--chunk-len", "3", "--skip", "1"])
    prob = cl.FitProblem(args, dev, torch.float32)
    for sim, x0m, x0s, _ in prob.runs:
        carry = sim.init_carry(x0m, x0s, key=0)
        th = prob.theta0.clone().requires_grad_(True)
        th, carry, _, _ = prob.step(sim, th, carry)
        th, carry, d, st = without_sync(lambda: prob.step(sim, th, carry), "fit step", 1)
        assert torch.isfinite(d).all()


def test_general_row_qp_launches_k3_and_k5_not_k4(dev):
    """QPs of general rows only (n_id = 0), chip_smoke.qp_hold: the IPM runs
    its plain iteration (JAX's rule sends only n_id = nz to the fused
    kernel), so K3 factors each iteration's normal matrix, K3 + K5 each
    polish step, and K4 never launches; the Newton solve launches K3 and K5
    each step; both held against the CPU's float64 solve."""
    from chip_smoke import QP_NEWTON_ITERS, qp_hold

    runs = qp_hold(dev)
    nonzero = lambda path: {k: v for k, v in runs[path]["launches"].items() if v}
    assert nonzero("qp/ipm") == dict(cholesky=32, chol_solve=2)
    assert nonzero("qp/newton") == dict(cholesky=QP_NEWTON_ITERS, chol_solve=QP_NEWTON_ITERS)


def test_dyn_step_linearization_makes_no_host_sync(dev):
    """The engine's jacfwd-of-dyn_step branch (vmapped over every stage of
    every scenario, the stage index from torch.arange on the card) inside one
    solve_full under set_sync_debug_mode("error"), and its A, B, xi against
    K1's (the same step, differentiated by the kernel)."""
    import copy

    from tum_control_tpu_torch.controllers.nominal import N_SHOOTING_SUBSTEPS
    from tum_control_tpu_torch.models.integrators import rk4_multistep
    from tum_control_tpu_torch.models.vehicle_stm import pred_ode
    from tum_control_tpu_torch.track.planner import planner_emulator

    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig())
    ctrl = sim.controller
    eng = copy.copy(ctrl.engine)
    eng.funcs = eng.funcs._replace(lin_rollout=None, dyn_step=lambda k, x, u: rk4_multistep(
        lambda a, b: pred_ode(a, b, ctrl.vp, ctrl.tp), x, u, ctrl.dt, N_SHOOTING_SUBSTEPS))
    x0, _ = batched_scenarios(traj, 8, dtype=torch.float32, device=dev)
    st = ctrl.init_state(x0)
    st = st._replace(U=0.1 * torch.ones_like(st.U))
    _, win = planner_emulator(traj, x0[:, :2], sim.Tp, sim.N + 1)
    yref, yref_e = ctrl.make_yref(win)
    eng.solve_full(st, x0, yref, yref_e)
    u0, _, stats, _ = without_sync(lambda: eng.solve_full(st, x0, yref, yref_e), "dyn_step", 1)
    assert (stats.status == 0).all() and torch.isfinite(u0).all()
    for a, b in zip(eng._linearize(st), ctrl.engine._linearize(st)):
        _close(a, b, 1e-4)


def test_bench_measure_launches_every_path_kernel(dev):
    """bench.py's protocol at B = 128 (a few steps): the nominal NMPC and
    the R2NMPC launch K1-K5, the SNMPC K1, K3-K6; every controller solves."""
    from tum_control_tpu_torch import bench

    build.reset_launches()
    res = bench.measure(128, 3, 2, device=dev)
    assert {k for k, v in build.LAUNCHES.items() if v} == {
        "linearize", "condense", "condense_from", "cholesky", "chol_solve", "ipm_iteration"}
    assert res["ok"] >= 0.99 and all(c["ok"] >= 0.99 for c in res["controllers"].values())
    assert res["solves_per_sec"] > 0 and res["single_ms"] > 0


def test_spans_are_capture_safe(dev):
    """A span (utils/trace.py) inside a region captured into a CUDA graph
    does not break the capture: the replay equals the eager result, the span
    around the replay fires and the one inside the replayed region does not."""
    from tum_control_tpu_torch.utils import trace

    def region(x):
        with trace.span("tc.test.region"):
            return torch.tanh(x) * 2.0 + x.sum(dim=1, keepdim=True)

    x = torch.randn(128, 80, device=dev)
    eager = region(x)
    static = torch.zeros_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            region(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with trace.span("tc.test.capture"):
        with torch.cuda.graph(graph):
            out = region(static)
    trace.reset()
    static.copy_(x)
    with trace.span("tc.test.replay"):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    snap = trace.snapshot()
    assert [root for root, *_ in snap["records"]] == ["tc.test.replay"]
    assert [name for name, *_ in snap["spans"][0][1]] == ["tc.test.replay"]
