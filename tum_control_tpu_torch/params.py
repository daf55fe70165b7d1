"""Vehicle / tire parameter records (copy of tum_control_tpu/params.py).

Plain NamedTuples of Python floats, built from the reference-format YAML
dicts under data/Config. They are closed over by the model functions; the
port keeps its own copy so it never imports the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TireParams(NamedTuple):
    """Pacejka 'magic formula' lateral tire parameters (front/rear) + friction."""

    Bf: float = 10.0
    Cf: float = 1.3
    Df: float = 15591.427
    Ef: float = 0.97
    Br: float = 10.0
    Cr: float = 1.6
    Dr: float = 24629.523
    Er: float = 0.97
    mu: float = 1.0489


class VehicleParams(NamedTuple):
    """Single-track chassis parameters + operational bounds (EDGAR VW T7)."""

    lf: float = 1.484
    lr: float = 1.644
    m: float = 2520.0
    Iz: float = 13600.0
    ro: float = 1.225
    S: float = 2.9
    Cd: float = 0.35
    veh_length: float = 4.973
    veh_width: float = 1.941
    banking: float = 0.0  # road banking angle [rad]
    # bounds
    jerk_min: float = -8.0
    jerk_max: float = 6.0
    lat_acc_min: float = -5.886
    lat_acc_max: float = 5.886
    acc_min: float = -3.5
    acc_max: float = 2.5
    delta_f_min: float = -0.610865
    delta_f_max: float = 0.610865
    delta_f_dot_min: float = -0.322
    delta_f_dot_max: float = 0.322
    # rolling-resistance coefficients
    fr0: float = 0.009
    fr1: float = 0.002
    fr4: float = 0.0003


def scaled_tire_params(tp: TireParams, theta) -> TireParams:
    """`tp` with its 8 Pacejka coefficients (Bf, Cf, Df, Ef, Br, Cr, Dr, Er)
    multiplied by exp(theta): theta a (8,) tensor of log-multipliers, so the
    result holds 0-d tensors that autograd follows back to theta (the
    parameterization of tools/fit_tires_closedloop.py); mu stays a float."""
    import torch

    base = torch.tensor(tp[:8], dtype=theta.dtype, device=theta.device)
    return TireParams(*torch.exp(torch.log(base) + theta).unbind(), mu=tp.mu)


def vehicle_params_from_dict(d: dict) -> VehicleParams:
    """Build VehicleParams from a reference-format YAML dict."""
    banking = float(np.deg2rad(d.get("banking_deg", 0.0)))
    return VehicleParams(
        lf=float(d["lf"]),
        lr=float(d["lr"]),
        m=float(d["m"]),
        Iz=float(d["Iz"]),
        ro=float(d["ro"]),
        S=float(d["S"]),
        Cd=float(d["Cd"]),
        veh_length=float(d.get("veh_length", 4.973)),
        veh_width=float(d.get("veh_width", 1.941)),
        banking=banking,
        jerk_min=float(d["jerk_min"]),
        jerk_max=float(d["jerk_max"]),
        lat_acc_min=float(d["lat_acc_min"]),
        lat_acc_max=float(d["lat_acc_max"]),
        acc_min=float(d["acc_min"]),
        acc_max=float(d["acc_max"]),
        delta_f_min=float(d["delta_f_min"]),
        delta_f_max=float(d["delta_f_max"]),
        delta_f_dot_min=float(d["delta_f_dot_min"]),
        delta_f_dot_max=float(d["delta_f_dot_max"]),
    )


def tire_params_from_dict(d: dict) -> TireParams:
    """Build TireParams from a reference-format YAML dict."""
    tp = d["tire_params"]
    return TireParams(
        Bf=float(tp["front"]["Bf"]),
        Cf=float(tp["front"]["Cf"]),
        Df=float(tp["front"]["Df"]),
        Ef=float(tp["front"]["Ef"]),
        Br=float(tp["rear"]["Br"]),
        Cr=float(tp["rear"]["Cr"]),
        Dr=float(tp["rear"]["Dr"]),
        Er=float(tp["rear"]["Er"]),
        mu=float(d["mu"]),
    )
