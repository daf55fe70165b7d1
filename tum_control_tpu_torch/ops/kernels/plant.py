"""The plant's RK4 over one simulation step as one launch (csrc/plant.cu).

No TPU kernel stands behind it: the JAX package integrates the plant in
plain JAX, which XLA fuses; eager PyTorch launches each of the RK4's ~1,700
elementwise ops on its own.

  * `plant_ref`: the plain version, `rk4_multistep` over `sim_ode`
    (`sim_ode_disturbed` with a derivative disturbance w);
  * `plant_cuda`: the launch on contiguous CUDA float32 tensors;
  * `Plant`: the wrapper the closed loop holds, with the model constants
    (and for tensor tires their device table) built once per set of tires.
    `Plant.ode(w)` is the plant's ODE, a `PlantODE`, whose `integrate`
    `models/integrators.py::rk4_multistep` hands the whole integration:
    CPU tensors -> `plant_ref`; CUDA float32 tensors -> the kernel, with the
    plain version's VJP as its backward (ops/diffmode.py); anything else
    raises.
"""
from __future__ import annotations

import ctypes

import torch

from tum_control_tpu_torch.models.integrators import rk4_multistep
from tum_control_tpu_torch.models.vehicle_stm import sim_ode, sim_ode_disturbed
from tum_control_tpu_torch.ops.diffmode import kernel_with_plain_vjp
from tum_control_tpu_torch.ops.kernels import build
from tum_control_tpu_torch.ops.kernels.linearize import kernel_params, kernel_tires, with_tires

NX, NU = 7, 2


def plant_ode(x, u, w, vp, tp):
    """`sim_ode`, or `sim_ode_disturbed` with a derivative disturbance w."""
    return sim_ode(x, u, vp, tp) if w is None else sim_ode_disturbed(x, u, w, vp, tp)


def plant_ref(x, u, w, vp, tp, dt: float, n_sub: int):
    """x (..., 7) after n_sub RK4 substeps over dt with u (..., 2) = [a,
    steering rate] held; w (..., 7) a derivative disturbance, or None."""
    return rk4_multistep(lambda xx, uu: plant_ode(xx, uu, w, vp, tp), x, u, dt, n_sub)


def plant_cuda(x, u, w, prm, n_sub: int, tires=None):
    """Launch csrc/plant.cu on contiguous CUDA float32 x (B, 7), u (B, 2)
    and w (B, 7) or None; `prm` a kernel_params block, `tires` a tire_table
    of 1 or B rows (row b for scenario b), or None for the tires of `prm`."""
    B = x.shape[0]
    if x.shape != (B, NX) or u.shape != (B, NU) or (w is not None and w.shape != (B, NX)):
        raise ValueError(f"the plant kernel takes x (B, 7), u (B, 2) and w (B, 7), got "
                         f"{tuple(x.shape)}, {tuple(u.shape)}, "
                         f"{None if w is None else tuple(w.shape)}")
    extra = tuple(t for t in (w, tires) if t is not None)
    build.check_kernel_inputs(x, u, *extra)
    if tires is not None and (tires.dim() != 2 or tires.shape[1] != 12
                              or tires.shape[0] not in (1, B)):
        raise ValueError(f"the tire table must be (1 or {B}, 12), got {tuple(tires.shape)}")
    out = torch.empty_like(x)
    opt = lambda t: None if t is None else build.ptr(t)
    lib = build.library("plant")
    with torch.cuda.device(x.device):
        status = lib.plant_f32(build.ptr(x), build.ptr(u), opt(w), build.ptr(out), B,
                               ctypes.cast(prm, ctypes.c_void_p), opt(tires),
                               0 if tires is None else tires.shape[0], n_sub,
                               build.stream_of(x))
    build.check_status("plant_f32", status)
    build.LAUNCHES["plant"] += 1
    return out


class Plant:
    """The closed loop's plant: vehicle `vp`, tires `tp` (floats, or
    tensors, 0-d or (B,) with one set per scenario), integrated over `dt` in
    `n_sub` RK4 substeps. The kernel reads tensor-valued tires from a device
    table; nothing is read back from the card."""

    def __init__(self, vp, tp, dt: float, n_sub: int):
        self.vp, self.tp, self.dt, self.n_sub = vp, tp, dt, n_sub
        self.prm, self.tires, self.table = kernel_tires(vp, tp, dt, n_sub)

    def ode(self, w=None) -> "PlantODE":
        """The plant's ODE, disturbed by w (B, 7) where given."""
        return PlantODE(self, w)

    def integrate(self, x, u, w, dt: float, n_sub: int):
        """`plant_ref` with these tires; on the card one launch."""
        ins = tuple(t for t in (x, u, w) if t is not None)
        flat = tuple(t.contiguous() for t in ins)
        if not build.use_kernel(*flat):
            return plant_ref(x, u, w, self.vp, self.tp, dt, n_sub)
        prm = self.prm if (dt, n_sub) == (self.dt, self.n_sub) else \
            kernel_params(self.vp, self.tp, dt, n_sub)
        n = len(flat)

        def split(args):
            return args[0], args[1], args[2] if n == 3 else None

        return kernel_with_plain_vjp(
            lambda *a: plant_cuda(*split(a), prm, n_sub, self.table),
            lambda *a: plant_ref(*split(a), self.vp, with_tires(self.tp, a[n:]), dt, n_sub),
            *flat, *self.tires)


class PlantODE:
    """xdot = f(x, u) of the plant, `sim_ode` (`sim_ode_disturbed` with w),
    carrying its fused integrator (`integrate`)."""

    def __init__(self, plant: Plant, w=None):
        self.plant, self.w = plant, w

    def __call__(self, x, u):
        return plant_ode(x, u, self.w, self.plant.vp, self.plant.tp)

    def integrate(self, x, u, dt: float, n_steps: int):
        return self.plant.integrate(x, u, self.w, dt, n_steps)
