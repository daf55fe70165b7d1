"""Scenario batches (port of tum_control_tpu/parallel/mesh.py::batched_scenarios;
the device-mesh helpers wait for the multi-GPU slice)."""
from __future__ import annotations

import numpy as np
import torch


def batched_scenarios(traj, batch: int, dtype=None, vp=None, device=None):
    """(batch, 8) MPC and (batch, 7) plant initial states spread along a lap.

    States are curvature-consistent: yawrate, steering and side slip start at
    their steady-cornering kinematic values from the reference yaw profile:

        yawrate = dyaw/dt (centered difference over segment times)
        kappa   = yawrate / v
        delta_f = atan(wheelbase * kappa)
        vlat    = v * tan(atan(lr * kappa))
        a       = ref_acc

    `vp` supplies the wheelbase geometry (EDGAR values if omitted). Computed
    in float64 numpy, then cast to `dtype` on `device` (by default those of
    the trajectory).
    """
    l_wb, lr = (3.128, 1.644) if vp is None else (vp.lf + vp.lr, vp.lr)
    M = traj.n_points
    host = lambda t: t.detach().cpu().double().numpy()
    starts = np.linspace(0, M - 1, batch).astype(np.int32)
    pos = host(traj.pos)[starts]
    yaw_all = np.unwrap(host(traj.yaw))
    seg = host(traj.seg_time)
    v_all = host(traj.v)
    dyaw = yaw_all[(starts + 1) % M] - yaw_all[(starts - 1) % M]
    dyaw = np.mod(dyaw + np.pi, 2 * np.pi) - np.pi  # re-wrap across the seam
    dt2 = seg[starts % M] + seg[(starts + 1) % M]
    yawrate = dyaw / np.maximum(dt2, 1e-6)
    v = v_all[starts]
    kappa = yawrate / np.maximum(v, 0.1)
    delta_f = np.arctan(l_wb * kappa)
    vlat = v * np.tan(np.arctan(lr * kappa))
    acc = host(traj.acc)[starts]
    yaw = np.mod(host(traj.yaw)[starts], 2 * np.pi)
    x0m = torch.as_tensor(
        np.stack([pos[:, 0], pos[:, 1], yaw, v, vlat, yawrate, delta_f, acc], axis=1),
        dtype=traj.pos.dtype if dtype is None else dtype,
        device=traj.pos.device if device is None else device,
    )
    return x0m, x0m[:, :7].contiguous()
