"""A one-step check and a multi-device dry run of the port (counterpart of
the root __graft_entry__.py):

  * `entry()`: (fn, example_args), one forward step of the nominal NMPC, the
    planner window and one SQP-RTI solve (K1-K5 on the card), from
    warm-start tensors: `fn(X, U, warm, x0, pose) -> (u0, pred_X, stats)`;
  * `dryrun_multichip(n)`: the batched closed loop over n devices, one
    process each (parallel/distributed.py: NCCL on cards, gloo on the CPU),
    for every controller composition: the nominal NMPC, the SNMPC and the
    R2NMPC, and WMPC (the new_BO_F policy) over each of the three. A global
    batch of 2 n scenarios spread along the lap (batched_scenarios) is split
    over the mesh's "batch" axis (parallel/mesh.py::make_mesh, shard_batch),
    each rank runs its rows for 2 steps, and the mean |lat_dev| over the
    global batch is an all-reduce of the shards' sums; it must be finite.

    python -m tum_control_tpu_torch.dryrun [--nproc N] [--device cuda|cpu]

starts N processes (default: the card count, or 2 with --device cpu) joined
by tcp:// on a free localhost port, or joins the env:// group under
torchrun, and prints each composition's mean.
"""
import argparse
import math
import os
import sys

import torch

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.tools.scaling_eval import _free_port

WMPC = dict(enable_WMPC=True, WMPC_model="data/wmpc_models/new_BO_F")
DRYRUN_T, DRYRUN_STEPS = 0.04, 2


def compositions():
    """The six MPCConfigs of the dry run: each controller, then WMPC over
    each."""
    from tum_control_tpu_torch.config import MPCConfig

    return [MPCConfig(), MPCConfig(controller="snmpc"), MPCConfig(controller="rnmpc"),
            MPCConfig(**WMPC), MPCConfig(controller="snmpc", **WMPC),
            MPCConfig(controller="rnmpc", **WMPC)]


def composition_name(mpc_cfg) -> str:
    return mpc_cfg.controller + ("+wmpc" if mpc_cfg.enable_WMPC else "")


def entry(device=None, dtype=torch.float32):
    """(fn, example_args): one nominal-NMPC forward step (planner window +
    solve) from the controller's cold start at the lap's start, one
    scenario, on `device` (cuda unless named)."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.ops.rti import RTIState
    from tum_control_tpu_torch.track.planner import planner_emulator

    sim_cfg = SimConfig(sim_mode=0, T=1.0)
    sim, x0m, _, traj, _ = build_simulation(sim_cfg, MPCConfig(), device=resolve_device(device),
                                            dtype=dtype)
    ctrl = sim.controller
    x0 = x0m[None]
    st = ctrl.init_state(x0)

    def fn(X, U, warm, x0, pose):
        _, window = planner_emulator(traj, pose, sim_cfg.Tp, sim_cfg.N + 1)
        out, _ = ctrl.solve(RTIState(X=X, U=U, warm=warm), x0, window)
        return out.u0, out.pred_X, out.stats

    return fn, (st.X, st.U, st.warm, x0, x0[:, :2].contiguous())


def dryrun_multichip(n_devices: int, device=None, dtype=torch.float32) -> dict:
    """Runs every composition sharded over an n-device mesh; returns
    {composition name: all-reduced mean |lat_dev| (m)}. Needs the process
    group of n processes (parallel/distributed.py::initialize_distributed);
    at n = 1 without one, it opens and closes a one-process group itself.
    `device` is this rank's (cuda unless named)."""
    import torch.distributed as dist

    from tum_control_tpu_torch.parallel.distributed import initialize_distributed

    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return _dryrun(n_devices, device, dtype)
    if n_devices != 1:
        raise RuntimeError(f"a dry run over {n_devices} devices needs their process group "
                           "(parallel/distributed.py::initialize_distributed)")
    device = initialize_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        return _dryrun(1, device, dtype)
    finally:
        dist.destroy_process_group()


def _dryrun(n_devices, device, dtype):
    import torch.distributed as dist

    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import SimConfig
    from tum_control_tpu_torch.parallel.distributed import _all_reduce
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios, make_mesh, shard_batch

    mesh = make_mesh(n_devices)
    batch = 2 * n_devices
    means = {}
    for mpc_cfg in compositions():
        sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=DRYRUN_T), mpc_cfg,
                                              device=device, dtype=dtype)
        x0m, x0s = shard_batch(mesh, batched_scenarios(traj, batch))
        _, log = sim.run(x0m, x0s, DRYRUN_STEPS, key=0)
        total = _all_reduce(log.lat_dev.abs().double().sum()[None], device, dist.ReduceOp.SUM)
        name = composition_name(mpc_cfg)
        means[name] = float(total[0]) / (batch * DRYRUN_STEPS)
        if not math.isfinite(means[name]):
            raise AssertionError(f"{name}: mean |lat_dev| {means[name]}")
    return means


def worker(rank, world, address, device):
    """One rank of the command line's dry run; rank 0 prints the means."""
    import torch.distributed as dist

    from tum_control_tpu_torch.parallel.distributed import initialize_distributed

    if device.type == "cpu":
        torch.set_num_threads(1)
    if address is None:  # torchrun
        dev = initialize_distributed(device=device)
    else:
        dev = initialize_distributed(address, world, rank, device=device)
    try:
        means = dryrun_multichip(dist.get_world_size(), device=dev)
        if dist.get_rank() == 0:
            for name, m in means.items():
                print(f"{name}: mean |lat_dev| {m:.6f} m over {dist.get_world_size()} devices "
                      f"({dist.get_backend()})", flush=True)
        return means
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        return worker(None, None, None, device)
    nproc = args.nproc or (2 if device.type == "cpu" else torch.cuda.device_count())
    address = f"tcp://127.0.0.1:{_free_port()}"
    if nproc == 1:
        return worker(0, 1, address, device)
    import torch.multiprocessing as mp

    from tum_control_tpu_torch import dryrun  # by import path, also under -m

    mp.start_processes(dryrun.worker, args=(nproc, address, device), nprocs=nproc, join=True,
                       start_method="spawn")
    return None


if __name__ == "__main__":
    main(sys.argv[1:])
