"""Carry state of the JAX package across to the port.

Every function takes numpy arrays and plain dicts (e.g. `nt._asdict()` of a
JAX NamedTuple with each leaf passed through `np.asarray`), never JAX
objects, and returns the port's records on the requested device/dtype.
The device is `cuda` unless the caller names one (device.py): without a
CUDA device, a call that names none raises. Arrays are batch-first, as a
vmapped JAX run produces them; add the batch axis to the state of an
unbatched run first.
"""
from __future__ import annotations

import numpy as np
import torch

from tum_control_tpu_torch.controllers.common import GGTables
from tum_control_tpu_torch.controllers.rnmpc import RobustExtra
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.policy import MLPPolicy, policy_from_arrays
from tum_control_tpu_torch.learn.wmpc import WMPCExtra
from tum_control_tpu_torch.ops.ipm import IPMWarm
from tum_control_tpu_torch.ops.rti import RTIState
from tum_control_tpu_torch.params import TireParams, VehicleParams
from tum_control_tpu_torch.sim.closed_loop import SimCarry, make_generator
from tum_control_tpu_torch.sim.estimator import EstimatorState
from tum_control_tpu_torch.track.trajectory import RefTrajectory

WARM_FIELDS = IPMWarm._fields  # su, sl, lam_u, lam_l, mu_u, mu_l


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def vehicle_params(d: dict) -> VehicleParams:
    return VehicleParams(**{k: float(v) for k, v in d.items()})


def tire_params(d: dict) -> TireParams:
    return TireParams(**{k: float(v) for k, v in d.items()})


def gg_tables(d: dict, device=None, dtype=None) -> GGTables:
    """From {vel, ax_max, ax_min, ay_max} arrays."""
    return GGTables(d["vel"], d["ax_max"], d["ax_min"], d["ay_max"], device=device, dtype=dtype)


def ref_trajectory(d: dict, device=None, dtype=None) -> RefTrajectory:
    """From {pos, yaw, v, acc, seg_time, cum_time, n_valid}."""
    device = resolve_device(device)
    return RefTrajectory(
        **{k: _t(d[k], dtype, device) for k in ("pos", "yaw", "v", "acc", "seg_time", "cum_time")},
        n_valid=int(np.asarray(d["n_valid"])),
    )


def rti_state(d: dict, device=None, dtype=None) -> RTIState:
    """From {X (B,N+1,nx), U (B,N,nu), warm: {su, sl, lam_u, lam_l, mu_u, mu_l}};
    nx is 8 for the nominal controller, 8 (n_samples + 1) for SNMPC's
    stacked state."""
    device = resolve_device(device)
    return RTIState(
        X=_t(d["X"], dtype, device),
        U=_t(d["U"], dtype, device),
        warm=IPMWarm(*(_t(d["warm"][k], dtype, device) for k in WARM_FIELDS)),
    )


def sim_carry(d: dict, seed: int = 0, device=None, dtype=None) -> SimCarry:
    """From {ctrl_state: (as rti_state), x_sim, x_dist, x_est, est_buf
    (B,8,15), est_count (B,), pose}. A JAX PRNG key has no torch
    counterpart: the disturbance generator is seeded from `seed`."""
    device = resolve_device(device)
    return SimCarry(
        ctrl_state=rti_state(d["ctrl_state"], device, dtype),
        extra=None,
        x_sim=_t(d["x_sim"], dtype, device),
        x_dist=_t(d["x_dist"], dtype, device),
        x_est=_t(d["x_est"], dtype, device),
        est_state=EstimatorState(
            buf=_t(d["est_buf"], dtype, device),
            count=torch.as_tensor(np.asarray(d["est_count"]), dtype=torch.int32, device=device),
        ),
        pose=_t(d["pose"], dtype, device),
        key=make_generator(seed, device),
    )


def robust_extra(d: dict, device=None, dtype=None) -> RobustExtra:
    """From {corr_steer (B, N+1), corr_acc (B, N+1, nh)}."""
    device = resolve_device(device)
    return RobustExtra(corr_steer=_t(d["corr_steer"], dtype, device),
                       corr_acc=_t(d["corr_acc"], dtype, device))


def wmpc_extra(d: dict, device=None, dtype=None) -> WMPCExtra:
    """From {steps (B,), obs, action (B,), W, We, L1, L2, base}; `base` is
    None or the R2NMPC base's {corr_steer, corr_acc}."""
    device = resolve_device(device)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)
    base = d.get("base")
    return WMPCExtra(
        steps=i32(d["steps"]), obs=_t(d["obs"], dtype, device), action=i32(d["action"]),
        W=_t(d["W"], dtype, device), We=_t(d["We"], dtype, device),
        L1=_t(d["L1"], dtype, device), L2=_t(d["L2"], dtype, device),
        base=None if base is None else robust_extra(base, device, dtype),
    )


def mlp_policy(d: dict, device=None, dtype=torch.float32) -> MLPPolicy:
    """From the JAX package's MLPPolicy fields {pi_w, pi_b, vf_w, vf_b
    (3 each), act_w, act_b, val_w, val_b}, its weights (in, out)."""
    arrs = {}
    for prefix, key in (("policy_net", "pi"), ("value_net", "vf")):
        for i, (w, b) in zip((0, 2, 4), zip(d[f"{key}_w"], d[f"{key}_b"])):
            arrs[f"mlp_extractor__{prefix}__{i}__weight"] = np.asarray(w).T
            arrs[f"mlp_extractor__{prefix}__{i}__bias"] = np.asarray(b)
    for name, key in (("action_net", "act"), ("value_net", "val")):
        arrs[f"{name}__weight"] = np.asarray(d[f"{key}_w"]).T
        arrs[f"{name}__bias"] = np.asarray(d[f"{key}_b"])
    return policy_from_arrays(arrs, device=device, dtype=dtype)
