"""Dynamic single-track (bicycle) vehicle model with Pacejka lateral tires.

Port of tum_control_tpu/models/vehicle_stm.py. Functions take tensors with
any leading batch shape and the state on the last axis, and tire parameters
shared by the batch or one per scenario, the first leading axis:

  pred: x = [posx, posy, yaw, vlong, vlat, yawrate, delta_f, a], u = [jerk, ddelta]
  sim:  x = [posx, posy, yaw, vlong, vlat, yawrate, delta_f],    u = [a, ddelta]

The low-speed slip-angle guard is the NaN-safe double `where` of the JAX
package, so forward-mode tangents stay finite as vlong -> 0. The CUDA kernel
in csrc/linearize.cu evaluates the same formulas (kept in step by the
kernel's comparison with `ops.kernels.linearize.linearize_ref`).
"""
from __future__ import annotations

import math

import torch

from tum_control_tpu_torch.params import TireParams, VehicleParams

G_ACC = 9.81
VLONG_EPS = 1e-3  # below this longitudinal speed, slip angles are forced to 0


def _scalar(fn_math, fn_torch, v):
    """`fn_math(v)` of a Python float, `fn_torch(v)` of a tensor: tire
    parameters may be 0-d tensors under autograd (params.scaled_tire_params),
    which the math module would turn into floats and cut from the graph."""
    return fn_torch(v) if isinstance(v, torch.Tensor) else fn_math(v)


def _per_scenario(v, like):
    """A tire parameter as it broadcasts against `like` (..., the states'
    leading axes): a (B,) tensor holds one value per scenario, the first
    axis, and gains an axis for each further one (stages, sample copies);
    floats and 0-d tensors pass as they are."""
    if isinstance(v, torch.Tensor) and v.dim() == 1 and like.dim() > 1:
        return v.reshape(v.shape + (1,) * (like.dim() - 1))
    return v


def _pacejka(alpha, B, C, D, E):
    """Pacejka 'magic formula' lateral force at constant tyre load."""
    Ba = B * alpha
    return D * torch.sin(C * torch.atan(Ba - E * (Ba - torch.atan(Ba))))


def lateral_forces(vlong, vlat, yawrate, delta_f, a, vp: VehicleParams, tp: TireParams):
    """Shared force core -> (Fx_f, Fx_r, Fy_f, Fy_r, Faero, Fbank_x, Fbank_y).
    Tire parameters are floats, 0-d tensors or (B,) tensors, one per
    scenario (the first axis of the states)."""
    tp = type(tp)(*(_per_scenario(v, vlong) for v in tp))
    # rolling resistance (v in km/h); the 1e-24 keeps the sqrt tangent finite
    # at standstill
    v_kmh = torch.sqrt(vlong**2 + vlat**2 + 1e-24) * 3.6
    fr = vp.fr0 + vp.fr1 * v_kmh / 100.0 + vp.fr4 * (v_kmh / 100.0) ** 4
    Fz_f = vp.m * vp.lr * G_ACC / (vp.lf + vp.lr)
    Fz_r = vp.m * vp.lf * G_ACC / (vp.lf + vp.lr)
    Fr_f = fr * Fz_f
    Fr_r = fr * Fz_r

    # banking + aero (banking = 0 in all shipped configs)
    Fbank_x = vp.m * G_ACC * math.sin(vp.banking) * _scalar(math.sin, torch.sin, tp.mu)
    Fbank_y = vp.m * G_ACC * math.sin(vp.banking) * _scalar(math.cos, torch.cos, tp.mu)
    Faero = 0.5 * vp.ro * vp.S * vp.Cd * vlong**2

    # longitudinal tire forces: rear-driven powertrain, zero brake split
    Fd = vp.m * a
    Fx_f = -Fr_f
    Fx_r = Fd - Fr_r

    # slip angles with a NaN-safe low-speed guard (zero slip below VLONG_EPS)
    moving = vlong > VLONG_EPS
    vl_safe = torch.where(moving, vlong, torch.ones_like(vlong))
    zero = torch.zeros_like(vlong)
    alpha_f = torch.where(moving, delta_f - torch.atan((vlat + vp.lf * yawrate) / vl_safe), zero)
    alpha_r = torch.where(moving, torch.atan((vp.lr * yawrate - vlat) / vl_safe), zero)

    # Pacejka lateral forces + combined-slip de-rating, cos(arcsin(g)) = sqrt(1 - g^2)
    Fy_f_lat = _pacejka(alpha_f, tp.Bf, tp.Cf, tp.Df, tp.Ef)
    Fy_r_lat = _pacejka(alpha_r, tp.Br, tp.Cr, tp.Dr, tp.Er)
    Fmax_f = _scalar(math.sqrt, torch.sqrt, Fz_f**2 + (tp.Cf * Fz_f) ** 2)
    Fmax_r = _scalar(math.sqrt, torch.sqrt, Fz_r**2 + (tp.Cr * Fz_r) ** 2)
    Gy_f = torch.clamp(Fx_f / Fmax_f, -0.98, 0.98)
    Gy_r = torch.clamp(Fx_r / Fmax_r, -0.98, 0.98)
    Fy_f = Fy_f_lat * torch.sqrt(1.0 - Gy_f**2)
    Fy_r = Fy_r_lat * torch.sqrt(1.0 - Gy_r**2)
    return Fx_f, Fx_r, Fy_f, Fy_r, Faero, Fbank_x, Fbank_y


def _body_derivatives(yaw, vlong, vlat, yawrate, delta_f, a, vp, tp):
    """(posx_dot, posy_dot, yaw_dot, vlong_dot, vlat_dot, yawrate_dot)."""
    Fx_f, Fx_r, Fy_f, Fy_r, Faero, Fbank_x, Fbank_y = lateral_forces(
        vlong, vlat, yawrate, delta_f, a, vp, tp
    )
    cd, sd = torch.cos(delta_f), torch.sin(delta_f)
    posx_dot = vlong * torch.cos(yaw) - vlat * torch.sin(yaw)
    posy_dot = vlong * torch.sin(yaw) + vlat * torch.cos(yaw)
    vlong_dot = (Fx_r - Faero - Fy_f * sd + Fx_f * cd - Fbank_x + vp.m * vlat * yawrate) / vp.m
    vlat_dot = (Fy_r + Fy_f * cd + Fx_f * sd - Fbank_y - vp.m * vlong * yawrate) / vp.m
    yawrate_dot = (vp.lf * (Fy_f * cd + Fx_f * sd) - vp.lr * Fy_r) / vp.Iz
    return posx_dot, posy_dot, yawrate, vlong_dot, vlat_dot, yawrate_dot


def pred_ode(x, u, vp: VehicleParams, tp: TireParams):
    """8-state prediction-model ODE xdot = f(x, u); u = [jerk, steering_rate]."""
    d = _body_derivatives(
        x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6], x[..., 7], vp, tp
    )
    return torch.stack([d[0], d[1], d[2], d[3], d[4], d[5], u[..., 1], u[..., 0]], dim=-1)


def sim_ode(x, u, vp: VehicleParams, tp: TireParams):
    """7-state plant ODE; u = [a, steering_rate]."""
    d = _body_derivatives(
        x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6], u[..., 0], vp, tp
    )
    return torch.stack([d[0], d[1], d[2], d[3], d[4], d[5], u[..., 1]], dim=-1)


def sim_ode_disturbed(x, u, w, vp: VehicleParams, tp: TireParams):
    """Plant ODE with additive state-derivative disturbance w (..., 7)."""
    return sim_ode(x, u, vp, tp) + w
