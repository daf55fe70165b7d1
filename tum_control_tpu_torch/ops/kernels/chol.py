"""K3: batched Cholesky factorization, K5: the solve L L^T x = b.

Port of tum_control_tpu/ops/pallas_kernels/chol.py (`_chol_kernel_blocked`
and `_solve_kernel_blocked`, launched by `_cholesky_tpu_packed` /
`_solve_tpu_packed`). The port's factor is an ordinary (B, n, n)
lower-triangular tensor at the caller's n (76 on the main path), not an
opaque lanes layout; the pad to a multiple of 16 lives in the kernel's
shared memory only.

  * `cholesky_ref`, `chol_solve_ref`: plain PyTorch loops (right-looking
    elimination; forward then backward substitution);
  * `cholesky`, `chol_solve`: the wrappers. CPU tensors -> the plain loops;
    CUDA float32 tensors -> csrc/chol.cu; anything else raises.

K7 ports the unblocked TPU kernels `_chol_kernel` and `_solve_kernel`,
which no `pallas_call` of the JAX package passes (so no path of the port
launches them either), with their arithmetic: each pivot scales its column
by rsqrt(a_jj), the solve multiplies by 1 / L_jj:

  * `cholesky_unblocked_ref`, `chol_solve_unblocked_ref`: the same pivot
    loops in plain PyTorch;
  * `cholesky_unblocked`, `chol_solve_unblocked`: the wrappers, dispatching
    as K3 and K5 do, to csrc/chol.cu's `*_unblocked_f32` entry points.

K3 and K7 share one kernel body (csrc/chol.cu::chol_factor_kernel, a
blocked factorization in 16-wide panels); `chol_plan` gives its layout and
refuses what it does not take, before any launch. K5 and the K7 solve share
another (chol_solve_kernel, the blocked substitution of csrc/trisolve.cuh
that K4 runs too); `chol_solve_plan` does the same for it.

`torch.linalg.cholesky_ex` / `torch.cholesky_solve` compute the same
functions; they are timing yardsticks only and are not used here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
from tum_control_tpu_torch.ops.kernels import build

MAX_N_CHOL = 128     # csrc/chol.cu::CHOL_MAX_N, the factorization's and the solve's limit
PANEL = 16           # csrc/trisolve.cuh::NB: K3's panel, the substitution's block
SOLVE_THREADS = 128  # csrc/chol.cu::SOLVE_THREADS


class CholPlan(NamedTuple):
    """Layout of the factorization kernel at n (csrc/chol.cu computes the
    same): the matrix padded to `npad` rows with an identity tail, row-major
    in shared memory with leading dimension `ld`, factored in `panels`
    panels of 16 columns, in `smem_bytes` of shared memory (the matrix and
    16 pivots)."""
    npad: int
    ld: int
    panels: int
    smem_bytes: int


def chol_plan(n: int) -> CholPlan:
    """The factorization kernel's layout at n; raises for n outside
    1..MAX_N_CHOL."""
    if not 1 <= n <= MAX_N_CHOL:
        raise ValueError(f"the Cholesky kernel takes 1 <= n <= {MAX_N_CHOL}, got n = {n}")
    npad = -(-n // PANEL) * PANEL
    ld = npad + 4   # = 4 mod 8: 16-byte reads of 8 consecutive rows hit distinct banks
    return CholPlan(npad, ld, npad // PANEL, 4 * (npad * ld + PANEL))


class SolvePlan(NamedTuple):
    """Layout of the solve kernel (K5, the K7 solve) at n (csrc/chol.cu's
    `solve_layout`): L padded to `npad` rows with an identity tail,
    row-major in shared memory with leading dimension `ld`, `threads` per
    block (all stage L, warp 0 substitutes), `smem_bytes` of shared memory
    (L, its transposed diagonal blocks, 1 / L_jj and x)."""
    npad: int
    ld: int
    threads: int
    smem_bytes: int


def chol_solve_plan(n: int) -> SolvePlan:
    """The solve kernel's layout at n; raises for n outside 1..MAX_N_CHOL."""
    if not 1 <= n <= MAX_N_CHOL:
        raise ValueError(f"the solve kernel takes 1 <= n <= {MAX_N_CHOL}, got n = {n}")
    npad = -(-n // PANEL) * PANEL
    ld = npad + 4
    return SolvePlan(npad, ld, SOLVE_THREADS, 4 * (npad * ld + npad * PANEL + 2 * npad))


def cholesky_ref(H):
    """(B, n, n) SPD -> lower factor L (B, n, n); reads the lower triangle.

    Right-looking elimination, written out of place (each step makes the
    trailing block anew instead of updating it) so that reverse mode runs
    through it (the kernel's backward, ops/diffmode.py); the arithmetic is
    that of the in-place loop."""
    n = H.shape[-1]
    A = H
    cols = []
    for j in range(n):
        d = torch.sqrt(A[:, 0, 0])
        col = A[:, 1:, 0] / d[:, None]
        cols.append(torch.nn.functional.pad(torch.cat([d[:, None], col], dim=1), (j, 0)))
        A = A[:, 1:, 1:] - col[:, :, None] * col[:, None, :]
    return torch.stack(cols, dim=2)


def chol_solve_ref(L, b):
    """(B, n, n) lower factor, (B, n) -> x with L L^T x = b: forward, then
    backward substitution, out of place as `cholesky_ref`."""
    n = L.shape[-1]
    r, y = b, []
    for j in range(n):
        y.append(r[:, 0] / L[:, j, j])
        r = r[:, 1:] - L[:, j + 1:, j] * y[j][:, None]
    r, x = torch.stack(y, dim=1), [None] * n
    for j in range(n - 1, -1, -1):
        x[j] = r[:, j] / L[:, j, j]
        r = r[:, :j] - L[:, j, :j] * x[j][:, None]
    return torch.stack(x, dim=1)


def _check_square(H):
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"expected (B, n, n) matrices, got {tuple(H.shape)}")


def _factor_cuda(H, fn_name, counter):
    """Launches csrc/chol.cu's factorization (K3 or K7) on a CUDA float32
    (B, n, n) tensor; n is checked against `chol_plan` before the library
    is loaded."""
    build.check_kernel_inputs(H)
    _check_square(H)
    B, n, _ = H.shape
    chol_plan(n)
    fn = getattr(build.library("chol"), fn_name)
    L = torch.empty_like(H)
    with torch.cuda.device(H.device):
        status = fn(build.ptr(H), build.ptr(L), B, n, build.stream_of(H))
    build.check_status(fn_name, status)
    build.LAUNCHES[counter] += 1
    return L


def cholesky_cuda(H):
    return _factor_cuda(H, "cholesky_f32", "cholesky")


def _solve_cuda(L, b, fn_name, counter):
    """Launches csrc/chol.cu's solve (K5 or the K7 solve) on contiguous CUDA
    float32 L (B, n, n) and b (B, n); the inputs and n (`chol_solve_plan`)
    are checked before the library is loaded."""
    build.check_kernel_inputs(L, b)
    _check_square(L)
    B, n, _ = L.shape
    if tuple(b.shape) != (B, n):
        raise ValueError(f"{fn_name}: rhs {tuple(b.shape)} does not match L {tuple(L.shape)}")
    chol_solve_plan(n)
    fn = getattr(build.library("chol"), fn_name)
    x = torch.empty_like(b)
    with torch.cuda.device(L.device):
        status = fn(build.ptr(L), build.ptr(b), build.ptr(x), B, n, build.stream_of(L))
    build.check_status(fn_name, status)
    build.LAUNCHES[counter] += 1
    return x


def chol_solve_cuda(L, b):
    return _solve_cuda(L, b, "chol_solve_f32", "chol_solve")


def cholesky(H):
    """Batched lower Cholesky factor; dispatches by device (module doc)."""
    if build.use_kernel(H):
        return kernel_with_plain_vjp(cholesky_cuda, cholesky_ref, H)
    return cholesky_ref(H)


def chol_solve(L, b):
    """Batched L L^T x = b; dispatches by device (module doc)."""
    if build.use_kernel(L, b):
        return kernel_with_plain_vjp(chol_solve_cuda, chol_solve_ref, L, b)
    return chol_solve_ref(L, b)


def cholesky_unblocked_ref(H):
    """(B, n, n) SPD -> lower factor L by K7's pivot loop: column j scaled by
    rsqrt(a_jj), then the rank-1 update of the trailing block; out of place,
    as `cholesky_ref`."""
    n = H.shape[-1]
    A, cols = H, []
    for j in range(n):
        col = A[:, :, 0] * torch.rsqrt(A[:, 0, 0])[:, None]
        cols.append(torch.nn.functional.pad(col, (j, 0)))
        A = A[:, 1:, 1:] - col[:, 1:, None] * col[:, None, 1:]
    return torch.stack(cols, dim=2)


def chol_solve_unblocked_ref(L, b):
    """(B, n, n) lower factor, (B, n) -> x with L L^T x = b by K7's column-wise
    forward and row-wise backward substitution (multiplying by 1 / L_jj);
    out of place, as `chol_solve_ref`."""
    n = L.shape[-1]
    r, y = b, []
    for j in range(n):
        y.append(r[:, 0] * (1.0 / L[:, j, j]))
        r = r[:, 1:] - L[:, j + 1:, j] * y[j][:, None]
    r, x = torch.stack(y, dim=1), [None] * n
    for j in range(n - 1, -1, -1):
        x[j] = r[:, j] * (1.0 / L[:, j, j])
        r = r[:, :j] - L[:, j, :j] * x[j][:, None]
    return torch.stack(x, dim=1)


def cholesky_unblocked_cuda(H):
    return _factor_cuda(H, "cholesky_unblocked_f32", "cholesky_unblocked")


def chol_solve_unblocked_cuda(L, b):
    return _solve_cuda(L, b, "chol_solve_unblocked_f32", "chol_solve_unblocked")


def cholesky_unblocked(H):
    """Batched lower Cholesky factor (K7); dispatches by device."""
    if build.use_kernel(H):
        return kernel_with_plain_vjp(cholesky_unblocked_cuda, cholesky_unblocked_ref, H)
    return cholesky_unblocked_ref(H)


def chol_solve_unblocked(L, b):
    """Batched L L^T x = b (K7); dispatches by device."""
    if build.use_kernel(L, b):
        return kernel_with_plain_vjp(chol_solve_unblocked_cuda, chol_solve_unblocked_ref, L, b)
    return chol_solve_unblocked_ref(L, b)
