"""K2: batched full condensing of the OCP sensitivities.

Port of tum_control_tpu/ops/pallas_kernels/condense.py (`_make_kernel`,
launched by `_condense_tpu`). Per scenario, the affine map from the stacked
control deviations w = vec(dU) to the state deviations:

    dx_k = e_k + Gam_k w,   e_{k+1} = A_k e_k + xi_k,
                            Gam_{k+1} = A_k Gam_k + B_k E_k,   (e_0, Gam_0) = (d0, 0)

  * `condense_ref`: the plain PyTorch version (the stage loop of the JAX
    package's `condense_scan_ref`, batched);
  * `condense`: the wrapper. CPU tensors -> `condense_ref`; CUDA float32
    tensors -> csrc/condense.cu; anything else raises.
"""
from __future__ import annotations


import torch

from tum_control_tpu_torch.ops.kernels import build


def condense_ref(A, B, xi, d0):
    """A (Bt,N,nx,nx), B (Bt,N,nx,nu), xi (Bt,N,nx), d0 (Bt,nx)
    -> e (Bt,N+1,nx), Gam (Bt,N+1,nx,nz)."""
    Bt, N, nx, nu = B.shape
    nz = N * nu
    e = d0
    gam = torch.zeros((Bt, nx, nz), dtype=A.dtype, device=A.device)
    es, gams = [e], [gam]
    for k in range(N):
        e = torch.matmul(A[:, k], e[..., None])[..., 0] + xi[:, k]
        gam = torch.matmul(A[:, k], gam)
        gam[:, :, k * nu:(k + 1) * nu] += B[:, k]
        es.append(e)
        gams.append(gam)
    return torch.stack(es, dim=1), torch.stack(gams, dim=1)


def condense_cuda(A, B, xi, d0):
    """Launch csrc/condense.cu on contiguous CUDA float32 tensors."""
    Bt, N, nx, nu = B.shape
    if A.shape != (Bt, N, nx, nx) or xi.shape != (Bt, N, nx) or d0.shape != (Bt, nx):
        raise ValueError("condense: inconsistent shapes "
                         f"{tuple(A.shape)} {tuple(B.shape)} {tuple(xi.shape)} {tuple(d0.shape)}")
    nz = N * nu
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
    """Batched condensing; dispatches by the tensors' device (module doc)."""
    if build.use_kernel(A, B, xi, d0):
        return condense_cuda(A, B, xi, d0)
    return condense_ref(A, B, xi, d0)
