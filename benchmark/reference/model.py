"""Vehicle model, tires, gg limits and RK4 of the reference (see __init__)."""
from __future__ import annotations

import math
import os
from types import SimpleNamespace

import numpy as np
import torch
import yaml

G_ACC = 9.81
VLONG_EPS = 1e-3


def _yaml(path):
    with open(path, "r") as fh:
        return yaml.safe_load(fh)


def load_vehicle(path) -> SimpleNamespace:
    d = _yaml(path)
    keys = ("lf", "lr", "m", "Iz", "ro", "S", "Cd", "acc_min", "delta_f_min", "delta_f_max",
            "delta_f_dot_min", "delta_f_dot_max")
    vp = SimpleNamespace(**{k: float(d[k]) for k in keys})
    vp.banking = float(np.deg2rad(d.get("banking_deg", 0.0)))
    vp.fr0, vp.fr1, vp.fr4 = 0.009, 0.002, 0.0003
    return vp


def load_tires(path) -> SimpleNamespace:
    d = _yaml(path)
    f, r = d["tire_params"]["front"], d["tire_params"]["rear"]
    return SimpleNamespace(Bf=float(f["Bf"]), Cf=float(f["Cf"]), Df=float(f["Df"]),
                           Ef=float(f["Ef"]), Br=float(r["Br"]), Cr=float(r["Cr"]),
                           Dr=float(r["Dr"]), Er=float(r["Er"]), mu=float(d["mu"]))


class GG:
    """Velocity-indexed gg limits (ggv.csv) and `jnp.interp`'s rule."""

    def __init__(self, path, dtype, device):
        raw = np.genfromtxt(path, delimiter=",", skip_header=1)
        t = lambda a: torch.as_tensor(a.copy(), dtype=dtype, device=device)
        self.vel, self.ax_max, self.ay_max = t(raw[:, 0]), t(raw[:, 1]), t(raw[:, 3])

    @staticmethod
    def interp(x, xp, fp):
        n = xp.shape[0]
        i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
        x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
        dx = x1 - x0
        dx0 = torch.abs(dx) <= np.spacing(torch.finfo(xp.dtype).eps)
        f = torch.where(dx0, f0,
                        f0 + ((x - x0) / torch.where(dx0, torch.ones_like(dx), dx)) * (f1 - f0))
        f = torch.where(x < xp[0], fp[0], f)
        return torch.where(x > xp[-1], fp[-1], f)


def acc_constraints(vel_abs, a_lon, a_lat, gg: GG, acc_min: float, shape: int):
    ay_max = gg.interp(vel_abs, gg.vel, gg.ay_max)
    ax_max = torch.where(a_lon < 0, torch.full_like(a_lon, -acc_min),
                         gg.interp(vel_abs, gg.vel, gg.ax_max))
    if shape == 0:
        return torch.stack([a_lon / ax_max, a_lat / ay_max], dim=-1)
    if shape == 1:
        return torch.stack([a_lon / ax_max + a_lat / ay_max, a_lon / ax_max - a_lat / ay_max],
                           dim=-1)
    return ((a_lon / ax_max) ** 2 + (a_lat / ay_max) ** 2)[..., None]


def acc_bounds(shape: int):
    if shape in (0, 1):
        return np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    return np.array([0.0]), np.array([1.0])


N_H = {0: 2, 1: 2, 2: 1}


def wrap_2pi(yaw):
    return torch.remainder(yaw, 2.0 * math.pi)


def _pacejka(alpha, B, C, D, E):
    Ba = B * alpha
    return D * torch.sin(C * torch.atan(Ba - E * (Ba - torch.atan(Ba))))


def _derivatives(yaw, vlong, vlat, yawrate, delta_f, a, vp, tp):
    v_kmh = torch.sqrt(vlong**2 + vlat**2 + 1e-24) * 3.6
    fr = vp.fr0 + vp.fr1 * v_kmh / 100.0 + vp.fr4 * (v_kmh / 100.0) ** 4
    Fz_f = vp.m * vp.lr * G_ACC / (vp.lf + vp.lr)
    Fz_r = vp.m * vp.lf * G_ACC / (vp.lf + vp.lr)
    Fbank_x = vp.m * G_ACC * math.sin(vp.banking) * math.sin(tp.mu)
    Fbank_y = vp.m * G_ACC * math.sin(vp.banking) * math.cos(tp.mu)
    Faero = 0.5 * vp.ro * vp.S * vp.Cd * vlong**2
    Fx_f = -fr * Fz_f
    Fx_r = vp.m * a - fr * Fz_r
    moving = vlong > VLONG_EPS
    vl_safe = torch.where(moving, vlong, torch.ones_like(vlong))
    zero = torch.zeros_like(vlong)
    alpha_f = torch.where(moving, delta_f - torch.atan((vlat + vp.lf * yawrate) / vl_safe), zero)
    alpha_r = torch.where(moving, torch.atan((vp.lr * yawrate - vlat) / vl_safe), zero)
    Fy_f_lat = _pacejka(alpha_f, tp.Bf, tp.Cf, tp.Df, tp.Ef)
    Fy_r_lat = _pacejka(alpha_r, tp.Br, tp.Cr, tp.Dr, tp.Er)
    Fmax_f = math.sqrt(Fz_f**2 + (tp.Cf * Fz_f) ** 2)
    Fmax_r = math.sqrt(Fz_r**2 + (tp.Cr * Fz_r) ** 2)
    Gy_f = torch.clamp(Fx_f / Fmax_f, -0.98, 0.98)
    Gy_r = torch.clamp(Fx_r / Fmax_r, -0.98, 0.98)
    Fy_f = Fy_f_lat * torch.sqrt(1.0 - Gy_f**2)
    Fy_r = Fy_r_lat * torch.sqrt(1.0 - Gy_r**2)
    cd, sd = torch.cos(delta_f), torch.sin(delta_f)
    return (vlong * torch.cos(yaw) - vlat * torch.sin(yaw),
            vlong * torch.sin(yaw) + vlat * torch.cos(yaw),
            yawrate,
            (Fx_r - Faero - Fy_f * sd + Fx_f * cd - Fbank_x + vp.m * vlat * yawrate) / vp.m,
            (Fy_r + Fy_f * cd + Fx_f * sd - Fbank_y - vp.m * vlong * yawrate) / vp.m,
            (vp.lf * (Fy_f * cd + Fx_f * sd) - vp.lr * Fy_r) / vp.Iz)


def pred_ode(x, u, vp, tp):
    """8 states [posx, posy, yaw, vlong, vlat, yawrate, delta_f, a], u = [jerk, ddelta]."""
    d = _derivatives(x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6], x[..., 7], vp, tp)
    return torch.stack([*d, u[..., 1], u[..., 0]], dim=-1)


def sim_ode(x, u, vp, tp):
    """7 plant states, u = [a, ddelta]."""
    d = _derivatives(x[..., 2], x[..., 3], x[..., 4], x[..., 5], x[..., 6], u[..., 0], vp, tp)
    return torch.stack([*d, u[..., 1]], dim=-1)


def rk4(f, x, u, dt, n_steps: int):
    h = dt / n_steps
    for _ in range(n_steps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def data_paths(root: str, sim: dict, mpc: dict) -> dict:
    """The raw files a configuration reads, under the checkout's data/."""
    cfg = os.path.join(root, "data", "Config")
    return dict(veh_pred=os.path.join(cfg, sim["veh_params_file_MPC"]),
                tire_pred=os.path.join(cfg, sim["tire_params_file_MPC"]),
                veh_sim=os.path.join(cfg, sim["veh_params_file_simulator"]),
                tire_sim=os.path.join(cfg, sim["tire_params_file_simulator"]),
                gg=os.path.join(cfg, mpc["lookuptable_gg_limits"]),
                traj=os.path.join(root, "data", "Trajectories", sim["ref_traj_file"]))
