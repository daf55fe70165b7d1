"""K2 and K6: batched condensing of the OCP sensitivities.

K2 ports tum_control_tpu/ops/pallas_kernels/condense.py `_make_kernel`
(launched by `_condense_tpu`). Per scenario, the affine map from the stacked
control deviations w = vec(dU) to the state deviations:

    dx_k = e_k + Gam_k w,   e_{k+1} = A_k e_k + xi_k,
                            Gam_{k+1} = A_k Gam_k + B_k E_k,   (e_0, Gam_0) = (d0, 0)

  * `condense_ref`: the plain PyTorch version (the stage loop of the JAX
    package's `condense_scan_ref`, batched);
  * `condense`: the wrapper; CPU tensors -> `condense_ref`, CUDA float32
    tensors -> csrc/condense.cu, anything else raises.

K2 takes states of at most 16 (the JAX package's MAX_NX_FAST): one thread
keeps a column of Gam (nx values) in registers, and SNMPC's dense 88-state
stack would need 1.2 MB of shared memory for its A, above the 227 KB a
block may have, so the wrapper refuses a wider state on the card. The dense
SNMPC oracle runs on the CPU; SNMPC's main (structured) path condenses 8
states through K6. `condense_plan` gives the launch shape of K2 and K6 and
refuses what they do not take, before any launch.

K6 ports `_make_kernel_from` (launched by `_condense_tpu_from`): the same
recurrence over a stage sub-range from a carry (e0, Gam0), stage t's B in
the columns col0 + t nu .. col0 + (t+1) nu of an nz-wide Gam:

  * `condense_from_ref`: the plain version (`condense_scan_from_ref`, batched);
  * `condense_from`: the wrapper; CPU -> `condense_from_ref`, CUDA float32
    -> csrc/condense.cu (`condense_from_f32`), anything else raises.

K8 ports `_make_mxu_kernel` (launched by `_condense_tpu_mxu`, which no
caller of the JAX package reaches, so no path of the port does either): the
K2 recurrence on an augmented carry [Gam | e] of nx x (nz+1), stage k's B
*assigned* to its columns and xi_k added to the e column:

  * `condense_mxu_ref`: the plain version of those semantics, batched;
  * `condense_mxu`: the wrapper; CPU -> `condense_mxu_ref`, CUDA float32 ->
    csrc/condense.cu (`condense_aug_f32`: K2's kernel writing one
    (B, N+1, nx, nz+1) output, bitwise equal to K2's), anything else
    raises, as does a shape outside `condense_plan`. Both return
    (e, Gam) = (out[..., nz], out[..., :nz]), as the JAX function.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
from tum_control_tpu_torch.ops.kernels import build

MAX_NX = 16           # csrc/condense.cu::COND_MAX_NX: a column's nx values in registers
COLUMNS = 32          # COND_THREADS: columns of Gam (or e), one per thread, per block
FAST_NX = 8           # COND_FAST_NX: the nx of the unrolled kernel body
SMEM_BYTES = 232448   # shared memory a block may use on Hopper


class CondensePlan(NamedTuple):
    """Launch shape of K2 / K6 / K8 at (N, nx, nu, nz) (csrc/condense.cu computes
    the same, `cond_layout`): `threads` per block, one per column of Gam or
    e; `blocks` per scenario for its nz + 1 columns; `nx_template` the nx of
    the unrolled kernel body (0: the generic body, any nx <= 16);
    `smem_bytes` of shared memory for the scenario's A, B and xi (each
    padded to 16 bytes)."""
    threads: int
    blocks: int
    nx_template: int
    smem_bytes: int


def condense_plan(N: int, nx: int, nu: int, nz: int) -> CondensePlan:
    """K2 / K6 / K8's launch shape; raises for N < 1, nx outside 1..MAX_NX, nu < 1,
    nz < 0, or A, B, xi beyond a block's shared memory."""
    if N < 1 or not 1 <= nx <= MAX_NX or nu < 1 or nz < 0:
        raise ValueError(f"condense: K2 / K6 take N >= 1, 1 <= nx <= {MAX_NX} (a column in "
                         f"registers), nu >= 1; got N = {N}, nx = {nx}, nu = {nu}, nz = {nz}")
    r4 = lambda v: -(-v // 4) * 4
    smem = 4 * (r4(N * nx * nx) + r4(N * nx * nu) + r4(N * nx))
    if smem > SMEM_BYTES:
        raise ValueError(f"condense: A, B, xi of {N} stages take {smem} bytes of shared memory, "
                         f"above {SMEM_BYTES}")
    return CondensePlan(COLUMNS, (nz + COLUMNS) // COLUMNS, FAST_NX if nx == FAST_NX else 0, smem)


def condense_ref(A, B, xi, d0):
    """A (Bt,N,nx,nx), B (Bt,N,nx,nu), xi (Bt,N,nx), d0 (Bt,nx)
    -> e (Bt,N+1,nx), Gam (Bt,N+1,nx,nz)."""
    Bt, N, nx, nu = B.shape
    G0 = torch.zeros((Bt, nx, N * nu), dtype=A.dtype, device=A.device)
    return condense_from_ref(A, B, xi, d0, G0, 0)


def condense_cuda(A, B, xi, d0):
    """Launch csrc/condense.cu (K2) on contiguous CUDA float32 tensors."""
    Bt, N, nx, nu = B.shape
    if A.shape != (Bt, N, nx, nx) or xi.shape != (Bt, N, nx) or d0.shape != (Bt, nx):
        raise ValueError("condense: inconsistent shapes "
                         f"{tuple(A.shape)} {tuple(B.shape)} {tuple(xi.shape)} {tuple(d0.shape)}")
    nz = N * nu
    condense_plan(N, nx, nu, nz)
    e = torch.empty((Bt, N + 1, nx), dtype=A.dtype, device=A.device)
    gam = torch.empty((Bt, N + 1, nx, nz), dtype=A.dtype, device=A.device)
    fn = build.library("condense").condense_f32
    with torch.cuda.device(A.device):
        status = fn(build.ptr(A), build.ptr(B), build.ptr(xi), build.ptr(d0), build.ptr(e),
                    build.ptr(gam), Bt, N, nx, nu, build.stream_of(A))
    build.check_status("condense_f32", status)
    build.LAUNCHES["condense"] += 1
    return e, gam


def condense(A, B, xi, d0):
    """Batched condensing; dispatches by device (module doc)."""
    if build.use_kernel(A, B, xi, d0):
        return kernel_with_plain_vjp(condense_cuda, condense_ref, A, B, xi, d0)
    return condense_ref(A, B, xi, d0)


def condense_from_ref(A, B, xi, e0, G0, col0: int):
    """A (Bt,N2,nx,nx), B (Bt,N2,nx,nu), xi (Bt,N2,nx), e0 (Bt,nx),
    G0 (Bt,nx,nz) -> e (Bt,N2+1,nx), Gam (Bt,N2+1,nx,nz); entry 0 is
    (e0, G0)."""
    N2, nu = B.shape[1], B.shape[3]
    e, gam = e0, G0
    es, gams = [e], [gam]
    for t in range(N2):
        e = torch.matmul(A[:, t], e[..., None])[..., 0] + xi[:, t]
        gam = torch.matmul(A[:, t], gam)
        c = col0 + t * nu
        gam[:, :, c:c + nu] += B[:, t]
        es.append(e)
        gams.append(gam)
    return torch.stack(es, dim=1), torch.stack(gams, dim=1)


def condense_from_cuda(A, B, xi, e0, G0, col0: int):
    """Launch csrc/condense.cu (K6) on contiguous CUDA float32 tensors."""
    Bt, N2, nx, nu = B.shape
    nz = G0.shape[-1]
    if (A.shape != (Bt, N2, nx, nx) or xi.shape != (Bt, N2, nx) or e0.shape != (Bt, nx)
            or G0.shape != (Bt, nx, nz)):
        raise ValueError("condense_from: inconsistent shapes " + " ".join(
            str(tuple(t.shape)) for t in (A, B, xi, e0, G0)))
    if col0 < 0 or col0 + N2 * nu > nz:
        raise ValueError(f"condense_from: columns {col0} .. {col0 + N2 * nu} exceed nz = {nz}")
    condense_plan(N2, nx, nu, nz)
    e = torch.empty((Bt, N2 + 1, nx), dtype=A.dtype, device=A.device)
    gam = torch.empty((Bt, N2 + 1, nx, nz), dtype=A.dtype, device=A.device)
    fn = build.library("condense").condense_from_f32
    with torch.cuda.device(A.device):
        status = fn(build.ptr(A), build.ptr(B), build.ptr(xi), build.ptr(e0), build.ptr(G0),
                    build.ptr(e), build.ptr(gam), Bt, N2, nx, nu, nz, int(col0),
                    build.stream_of(A))
    build.check_status("condense_from_f32", status)
    build.LAUNCHES["condense_from"] += 1
    return e, gam


def condense_from(A, B, xi, e0, G0, col0: int):
    """Init-carry condensing over a stage sub-range; dispatches by device."""
    if build.use_kernel(A, B, xi, e0, G0):
        return kernel_with_plain_vjp(lambda *a: condense_from_cuda(*a, col0),
                                     lambda *a: condense_from_ref(*a, col0), A, B, xi, e0, G0)
    return condense_from_ref(A, B, xi, e0, G0, col0)


def condense_mxu_ref(A, B, xi, d0):
    """A (Bt,N,nx,nx), B (Bt,N,nx,nu), xi (Bt,N,nx), d0 (Bt,nx) ->
    (e (Bt,N+1,nx), Gam (Bt,N+1,nx,nz)) through the augmented carry."""
    Bt, N, nx, nu = B.shape
    nz = N * nu
    G = torch.cat([A.new_zeros((Bt, nx, nz)), d0[..., None]], dim=-1)
    outs = [G]
    for k in range(N):
        G = torch.matmul(A[:, k], G)
        G[:, :, k * nu:(k + 1) * nu] = B[:, k]
        G[:, :, nz] += xi[:, k]
        outs.append(G)
    out = torch.stack(outs, dim=1)
    return out[..., nz], out[..., :nz]


def condense_mxu_cuda(A, B, xi, d0):
    """Launch csrc/condense.cu (K8) on contiguous CUDA float32 tensors."""
    Bt, N, nx, nu = B.shape
    if A.shape != (Bt, N, nx, nx) or xi.shape != (Bt, N, nx) or d0.shape != (Bt, nx):
        raise ValueError("condense_mxu: inconsistent shapes "
                         f"{tuple(A.shape)} {tuple(B.shape)} {tuple(xi.shape)} {tuple(d0.shape)}")
    nz = N * nu
    condense_plan(N, nx, nu, nz)
    out = torch.empty((Bt, N + 1, nx, nz + 1), dtype=A.dtype, device=A.device)
    fn = build.library("condense").condense_aug_f32
    with torch.cuda.device(A.device):
        status = fn(build.ptr(A), build.ptr(B), build.ptr(xi), build.ptr(d0), build.ptr(out),
                    Bt, N, nx, nu, build.stream_of(A))
    build.check_status("condense_aug_f32", status)
    build.LAUNCHES["condense_mxu"] += 1
    return out[..., nz], out[..., :nz]


def condense_mxu(A, B, xi, d0):
    """Augmented-carry condensing (K8); dispatches by device (module doc)."""
    if build.use_kernel(A, B, xi, d0):
        return kernel_with_plain_vjp(condense_mxu_cuda, condense_mxu_ref, A, B, xi, d0)
    return condense_mxu_ref(A, B, xi, d0)
