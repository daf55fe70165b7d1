"""K1: fused rollout + exact forward sensitivities of the shooting step.

Port of tum_control_tpu/ops/pallas_kernels/linearize.py. For every
(scenario, stage) element: F = step(x, u), the RK4 of the prediction model
over one shooting interval, and J = dF/d(x, u).

  * `linearize_ref`: the plain PyTorch version, `torch.func.jacfwd` of the
    array-form step (the analogue of the JAX package's `jacfwd_path`);
  * `LinearizeRollout`: the wrapper. CPU tensors -> `linearize_ref`; CUDA
    float32 tensors -> csrc/linearize.cu; anything else raises;
  * `linearize_plan`: the kernel's launch shape at a given element count.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import G_ACC, pred_ode
from tum_control_tpu_torch.ops.kernels import build


TANGENTS_PER_THREAD = 1   # csrc/linearize.cu::LIN_ND
THREADS = 128             # LIN_THREADS
MIN_BLOCKS_PER_SM = 7     # LIN_MIN_BLOCKS: at most 65536 / (7 * 128) = 73 registers a thread


class LinearizePlan(NamedTuple):
    """Launch shape of csrc/linearize.cu at `n_el` elements: `threads` per
    block, `blocks`, each thread carrying `tangents_per_thread` of the 10
    input directions, so `threads_per_element` threads per element;
    `max_registers` per thread is the cap its launch bound sets."""
    threads: int
    blocks: int
    tangents_per_thread: int
    threads_per_element: int
    max_registers: int


def linearize_plan(n_el: int) -> LinearizePlan:
    """The K1 kernel's launch shape; raises for n_el < 1."""
    if n_el < 1:
        raise ValueError(f"the linearize kernel takes at least one element, got {n_el}")
    per_el = 10 // TANGENTS_PER_THREAD
    return LinearizePlan(THREADS, -(-n_el * per_el // THREADS), TANGENTS_PER_THREAD, per_el,
                         65536 // (MIN_BLOCKS_PER_SM * THREADS))


def make_step(vp, tp, dt: float, n_sub: int):
    """Array-form discrete step (x (..., nx), u (..., nu)) -> (..., nx)."""
    return lambda x, u: rk4_multistep(lambda xx, uu: pred_ode(xx, uu, vp, tp), x, u, dt, n_sub)


def linearize_ref(XU, step, nx: int):
    """XU (B, N, nx+nu) -> F (B, N, nx), J (B, N, nx, nx+nu) by jacfwd.

    The step is differentiated with respect to one offset v added to every
    (scenario, stage) row: rows do not interact, so d step(xu_r + v) / dv is
    row r's own Jacobian. Keeping the rows batched (instead of vmapping over
    single rows) keeps every intermediate at least 1-D, which also keeps
    functorch's tangents in XU's dtype."""
    B, N, nv = XU.shape
    flat = XU.reshape(B * N, nv)

    def step_shifted(v):
        xu = flat + v
        return step(xu[:, :nx], xu[:, nx:])

    J = torch.func.jacfwd(step_shifted)(torch.zeros_like(flat[0]))
    F = step(flat[:, :nx], flat[:, nx:])
    return F.reshape(B, N, nx), J.reshape(B, N, nx, nv)


def kernel_params(vp, tp, dt: float, n_sub: int):
    """The model constants in csrc/model.cuh's ModelParams order (the
    reciprocals of its constant divisors last), then the RK4 step sizes h,
    h/2, h/6 (computed in double, as the plain version's Python floats)."""
    Fz_f = vp.m * vp.lr * G_ACC / (vp.lf + vp.lr)
    Fz_r = vp.m * vp.lf * G_ACC / (vp.lf + vp.lr)
    Fmax_f = math.sqrt(Fz_f**2 + (tp.Cf * Fz_f) ** 2)
    Fmax_r = math.sqrt(Fz_r**2 + (tp.Cr * Fz_r) ** 2)
    h = dt / n_sub
    vals = [
        vp.lf, vp.lr, vp.m, vp.Iz, 0.5 * vp.ro * vp.S * vp.Cd,
        vp.m * G_ACC * math.sin(vp.banking) * math.sin(tp.mu),
        vp.m * G_ACC * math.sin(vp.banking) * math.cos(tp.mu),
        vp.fr0, vp.fr1, vp.fr4, Fz_f, Fz_r, Fmax_f, Fmax_r,
        tp.Bf, tp.Cf, tp.Df, tp.Ef, tp.Br, tp.Cr, tp.Dr, tp.Er,
        1.0 / vp.m, 1.0 / vp.Iz, 1.0 / Fmax_f, 1.0 / Fmax_r,
        h, 0.5 * h, h / 6.0,
    ]
    return (ctypes.c_double * len(vals))(*vals)


def linearize_cuda(XU, prm, n_sub: int, nx: int = 8):
    """Launch csrc/linearize.cu on a contiguous CUDA float32 XU (B, N, 10)."""
    B, N, nv = XU.shape
    if nx != 8 or nv != 10:
        raise ValueError(f"the linearize kernel is built for nx=8, nu=2, got XU {tuple(XU.shape)}")
    F = torch.empty((B, N, nx), dtype=XU.dtype, device=XU.device)
    J = torch.empty((B, N, nx, nv), dtype=XU.dtype, device=XU.device)
    fn = build.library("linearize").linearize_f32
    with torch.cuda.device(XU.device):
        status = fn(build.ptr(XU), build.ptr(F), build.ptr(J), B * N,
                    ctypes.cast(prm, ctypes.c_void_p), n_sub, build.stream_of(XU))
    build.check_status("linearize_f32", status)
    build.LAUNCHES["linearize"] += 1
    return F, J


class LinearizeRollout:
    """XU (B, N, nx+nu) -> (F (B, N, nx), J (B, N, nx, nx+nu))."""

    def __init__(self, vp, tp, dt: float, n_sub: int, nx: int = 8):
        self.nx, self.n_sub = nx, n_sub
        self.step = make_step(vp, tp, dt, n_sub)
        self.prm = kernel_params(vp, tp, dt, n_sub)

    def __call__(self, XU):
        if build.use_kernel(XU):
            return linearize_cuda(XU, self.prm, self.n_sub, self.nx)
        return linearize_ref(XU, self.step, self.nx)
