"""K1: fused rollout + exact forward sensitivities of the shooting step.

Port of tum_control_tpu/ops/pallas_kernels/linearize.py. For every
(scenario, stage) element: F = step(x, u), the RK4 of the prediction model
over one shooting interval, and J = dF/d(x, u).

  * `linearize_ref`: the plain PyTorch version, `torch.func.jacfwd` of the
    array-form step (the analogue of the JAX package's `jacfwd_path`);
  * `LinearizeRollout`: the wrapper. CPU tensors -> `linearize_ref`; CUDA
    float32 tensors -> csrc/linearize.cu; anything else raises. Tires are
    one shared set, or one set per scenario (`tire_table`);
  * `linearize_plan`: the kernel's launch shape at a given element count.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import G_ACC, pred_ode
from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
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
    """Array-form discrete step (x (..., nx), u (..., nu)) -> (..., nx).
    Tire parameters of shape (B,) are per scenario, the first axis of x."""
    return lambda x, u: rk4_multistep(lambda xx, uu: pred_ode(xx, uu, vp, tp), x, u, dt, n_sub)


def linearize_ref(XU, step, nx: int):
    """XU (B, N, nx+nu) -> F (B, N, nx), J (B, N, nx, nx+nu) by jacfwd.

    The step is differentiated with respect to one offset v added to every
    (scenario, stage) row: rows do not interact, so d step(xu_r + v) / dv is
    row r's own Jacobian. Keeping the rows batched (instead of vmapping over
    single rows) keeps every intermediate at least 1-D, which also keeps
    functorch's tangents in XU's dtype, and keeps the scenario axis first,
    where per-scenario tires (B,) broadcast."""
    def step_shifted(v):
        xu = XU + v
        return step(xu[..., :nx], xu[..., nx:])

    J = torch.func.jacfwd(step_shifted)(torch.zeros_like(XU[0, 0]))
    F = step(XU[..., :nx], XU[..., nx:])
    return F, J


def axle_loads(vp):
    """Static front and rear axle loads Fz_f, Fz_r (N)."""
    return (vp.m * vp.lr * G_ACC / (vp.lf + vp.lr), vp.m * vp.lf * G_ACC / (vp.lf + vp.lr))


def kernel_params(vp, tp, dt: float, n_sub: int):
    """The model constants in csrc/model.cuh's ModelParams order (the
    reciprocals of its constant divisors last), then the RK4 step sizes h,
    h/2, h/6 (computed in double, as the plain version's Python floats).
    Tire parameters given as tensors are not read on the host (that would
    wait for the card): their slots, and the constants derived from them,
    hold NaN, and the kernel reads them from `tire_table`'s rows. `mu` is
    a float."""
    nan = float("nan")
    tp = type(tp)(*(nan if isinstance(v, torch.Tensor) else v for v in tp[:8]), mu=tp.mu)
    Fz_f, Fz_r = axle_loads(vp)
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


def tire_table(vp, tp):
    """The kernel's per-scenario tire rows, (R, 12) on the tires' device and
    in their type (float32 on the card): Bf, Cf, Df, Ef, Br, Cr, Dr, Er,
    Fmax_f, Fmax_r, 1 / Fmax_f, 1 / Fmax_r, from tire parameters of which at
    least one is a tensor (0-d: R = 1; (B,): R = B; floats are broadcast).
    Computed in float64, as kernel_params computes them on the host, without
    reading a value back."""
    ref = next(v for v in tp[:8] if isinstance(v, torch.Tensor))
    cols = torch.broadcast_tensors(*(
        v.detach().to(torch.float64).reshape(-1) if isinstance(v, torch.Tensor)
        else torch.full((1,), v, dtype=torch.float64, device=ref.device)
        for v in tp[:8]))
    Fz_f, Fz_r = axle_loads(vp)
    Fmax_f = torch.sqrt(Fz_f**2 + (cols[1] * Fz_f) ** 2)
    Fmax_r = torch.sqrt(Fz_r**2 + (cols[5] * Fz_r) ** 2)
    return torch.stack([*cols, Fmax_f, Fmax_r, 1.0 / Fmax_f, 1.0 / Fmax_r],
                       dim=1).to(ref.dtype).contiguous()


def linearize_cuda(XU, prm, n_sub: int, nx: int = 8, tires=None):
    """Launch csrc/linearize.cu on a contiguous CUDA float32 XU (B, N, 10);
    `tires` a tire_table of 1 or B rows (row b for scenario b), or None for
    the tires of `prm`."""
    B, N, nv = XU.shape
    if nx != 8 or nv != 10:
        raise ValueError(f"the linearize kernel is built for nx=8, nu=2, got XU {tuple(XU.shape)}")
    F = torch.empty((B, N, nx), dtype=XU.dtype, device=XU.device)
    J = torch.empty((B, N, nx, nv), dtype=XU.dtype, device=XU.device)
    lib = build.library("linearize")
    with torch.cuda.device(XU.device):
        if tires is None:
            status = lib.linearize_f32(build.ptr(XU), build.ptr(F), build.ptr(J), B * N,
                                       ctypes.cast(prm, ctypes.c_void_p), n_sub,
                                       build.stream_of(XU))
        else:
            build.check_kernel_inputs(XU, tires)
            if tires.dim() != 2 or tires.shape[1] != 12 or tires.shape[0] not in (1, B):
                raise ValueError(f"the tire table must be (1 or {B}, 12), got {tuple(tires.shape)}")
            per_row = N if tires.shape[0] == B else B * N
            status = lib.linearize_tires_f32(build.ptr(XU), build.ptr(F), build.ptr(J), B * N,
                                             ctypes.cast(prm, ctypes.c_void_p), build.ptr(tires),
                                             per_row, n_sub, build.stream_of(XU))
    build.check_status("linearize_f32", status)
    build.LAUNCHES["linearize"] += 1
    return F, J


class LinearizeRollout:
    """XU (B, N, nx+nu) -> (F (B, N, nx), J (B, N, nx, nx+nu)).

    Tire parameters are floats (one set), or tensors: 0-d (one set, e.g.
    under autograd) or (B,) (one set per scenario, the first axis of XU).
    The kernel reads tensor-valued tires from a device table (`tire_table`,
    built by `set_tires`), and its backward (ops/diffmode.py)
    differentiates the plain version in XU and in those tensors."""

    def __init__(self, vp, tp, dt: float, n_sub: int, nx: int = 8):
        self.nx, self.n_sub = nx, n_sub
        self.vp, self.dt = vp, dt
        self.set_tires(tp)

    def set_tires(self, tp):
        """Replace the tires; no value is read back from the card."""
        self.tp = tp
        self.prm = kernel_params(self.vp, tp, self.dt, self.n_sub)
        self.tires = tuple(v for v in tp if isinstance(v, torch.Tensor))
        self.table = tire_table(self.vp, tp) if self.tires else None

    def step(self, x, u):
        """The discrete step with the current tires (make_step)."""
        return make_step(self.vp, self.tp, self.dt, self.n_sub)(x, u)

    def _plain(self, XU, *tires):
        """linearize_ref with the tensor-valued tire parameters `tires`."""
        it = iter(tires)
        tp = type(self.tp)(*(next(it) if isinstance(v, torch.Tensor) else v for v in self.tp))
        return linearize_ref(XU, make_step(self.vp, tp, self.dt, self.n_sub), self.nx)

    def __call__(self, XU):
        if build.use_kernel(XU):
            return kernel_with_plain_vjp(
                lambda XU, *_: linearize_cuda(XU, self.prm, self.n_sub, self.nx, self.table),
                self._plain, XU, *self.tires)
        return linearize_ref(XU, self.step, self.nx)
