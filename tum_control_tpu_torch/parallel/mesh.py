"""Scenario batches and their sharding (port of
tum_control_tpu/parallel/mesh.py).

A batch is sharded across processes, one per card (parallel/distributed.py):
`make_mesh` is a `torch.distributed` DeviceMesh over the initialized process
group, with the JAX mesh's axis names, and `shard_batch` takes this rank's
rows of the leading (scenario) axis, the rows a JAX device holds under
`NamedSharding(mesh, P("batch"))`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map


def make_mesh(n_devices: int = None, axis_names=("batch",)):
    """A one-axis DeviceMesh over the ranks of the initialized process group
    (parallel/distributed.py::initialize_distributed): `n_devices` (default:
    the world size, the only count it takes), its axis named `axis_names`;
    on cuda under NCCL, else on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py::initialize_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a process group of {world}: "
                         "one process per device")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=tuple(axis_names))


def shard_batch(mesh, tree, axis: str = "batch"):
    """This rank's rows of the leading axis of every tensor in a nest (tuples,
    NamedTuples, lists, dicts): rows [r b, (r + 1) b) with r the rank's
    coordinate on `axis` and b = rows / the axis' size; anything else
    passes through."""
    r = mesh.get_local_rank(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def rows(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.shape[0] % n:
            raise ValueError(f"{t.shape[0]} rows do not split over {n} devices")
        b = t.shape[0] // n
        return t[r * b:(r + 1) * b]

    return tree_map(rows, tree)


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
