"""Scenario starts from the seed, made on the device.

The construction of `tum_control_tpu_torch/parallel/mesh.py::batched_scenarios`
(copied here; that function is the one to delete in favour of this one):
`batch` starts spread evenly along the reference lap, each at its
steady-cornering kinematic state (yawrate from the lap's yaw profile,
kappa = yawrate / v, delta_f = atan(wheelbase kappa), vlat = v tan(atan(lr
kappa)), a = the reference acceleration). Added: a seeded phase of the
whole spread along the lap, and a seeded lateral offset and heading error
of each start, uniform within the traffic file's amplitudes. The work per
step does not depend on them (fixed SQP and QP iteration counts); they move
which states the comparison with the reference sees.
"""
from __future__ import annotations

import json
import math

import torch


def lap_tensors(path: str, device) -> dict:
    """The raw reference lap (float64 on `device`)."""
    with open(path, "r") as fh:
        raw = json.load(fh)
    t = lambda k: torch.as_tensor(raw[k], dtype=torch.float64, device=device)
    return dict(pos=torch.stack([t("pos_x"), t("pos_y")], dim=1), v=t("ref_v"), yaw=t("ref_yaw"),
                acc=t("ref_acc") if "ref_acc" in raw else torch.zeros_like(t("ref_v")))


def starts(lap: dict, batch: int, seed: int, offset_m: float, yaw_rad: float,
           wheelbase: float, lr: float, dtype, device):
    """(x0_mpc (batch, 8), x0_sim (batch, 7)) in `dtype` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    draw = lambda *shape: torch.rand(shape, generator=g, **f64)
    pos, v_all, yaw_raw = lap["pos"], lap["v"], lap["yaw"]
    M = pos.shape[0]
    phase = draw(1)
    idx = torch.floor((torch.arange(batch, **f64) + phase) * (M / batch)).long() % M
    seg = torch.linalg.norm(pos - torch.roll(pos, 1, dims=0), dim=1) / v_all
    yaw_un = _unwrap(yaw_raw)
    dyaw = yaw_un[(idx + 1) % M] - yaw_un[(idx - 1) % M]
    dyaw = torch.remainder(dyaw + math.pi, 2 * math.pi) - math.pi
    yawrate = dyaw / torch.clamp(seg[idx % M] + seg[(idx + 1) % M], min=1e-6)
    v = v_all[idx]
    kappa = yawrate / torch.clamp(v, min=0.1)
    delta_f = torch.atan(wheelbase * kappa)
    vlat = v * torch.tan(torch.atan(lr * kappa))
    yaw = torch.remainder(yaw_raw[idx], 2 * math.pi)
    off = (2 * draw(batch) - 1) * offset_m
    p = pos[idx] + off[:, None] * torch.stack([-torch.sin(yaw), torch.cos(yaw)], dim=1)
    yaw = torch.remainder(yaw + (2 * draw(batch) - 1) * yaw_rad, 2 * math.pi)
    x0m = torch.stack([p[:, 0], p[:, 1], yaw, v, vlat, yawrate, delta_f, lap["acc"][idx]], dim=1)
    x0m = x0m.to(dtype)
    return x0m, x0m[:, :7].contiguous()


def _unwrap(a):
    """numpy.unwrap of a 1-D tensor."""
    d = torch.diff(a)
    dd = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    dd = torch.where((dd == -math.pi) & (d > 0), torch.full_like(dd, math.pi), dd)
    return torch.cat([a[:1], a[:1] + torch.cumsum(dd, dim=0)])
