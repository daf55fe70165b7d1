"""Scenario data parallelism across processes (port of
tum_control_tpu/parallel/distributed.py).

One process per card (or per CPU worker under gloo), joined by
`torch.distributed`: every rank runs its contiguous shard of a global
scenario batch through the batched closed loop, and the metrics that span
the batch are all-reduced. Scenarios do not interact, so a shard's rows
are the rows the unsharded run computes.

  * `initialize_distributed`: the process group, NCCL on cuda and gloo on
    the CPU; `tcp://` when an address is given, else `env://` (torchrun);
  * `sharded_run`: the sharded closed loop and its global mean |lat_dev| and
    solver-ok count, each an all-reduce;
  * `scaling_report`: aggregate solves/s at each device count, and the
    efficiency against one device.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.parallel.mesh import batched_scenarios


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           device=None) -> torch.device:
    """Join the process group; returns this rank's device.

    `coordinator_address` ("host:port" or "tcp://host:port") with
    `num_processes` and `process_id` uses the tcp:// rendezvous; without
    it, the env:// variables that torchrun sets. The backend follows the
    device (device.py: cuda unless the caller names one): NCCL on cuda,
    gloo on the CPU. On cuda, rank r takes card LOCAL_RANK (else r) modulo
    the card count."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        rank = int(process_id)
        kwargs = dict(init_method=addr, world_size=int(num_processes), rank=rank)
    else:
        rank = int(os.environ.get("RANK", "0"))
        kwargs = dict(init_method="env://")
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)
    return device


def _world():
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce(values, device, op):
    """all_reduce of a float64 vector on `device` (NCCL takes CUDA tensors,
    gloo CPU ones) whenever a process group is up, at world size 1 too;
    identity outside a group."""
    t = torch.as_tensor(values, dtype=torch.float64, device=device)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, op=op)
    return t


class ShardedRun(NamedTuple):
    mean_abs_lat_dev: float  # over every scenario and step of the global batch
    solver_ok: int           # statuses 0 over the global batch
    local_mean: float        # the same mean over this rank's shard alone
    log: object              # this rank's SimLog, (batch / world, steps, ...)


def sharded_run(sim, traj, batch: int, steps: int, device=None) -> ShardedRun:
    """The closed loop over a global batch of `batch` scenarios spread along
    the lap (batched_scenarios), rank r running rows [r b, (r + 1) b) with
    b = batch / world size; the global mean |lat_dev| and the solver-ok
    count are all-reduces of the shards' sums."""
    device = resolve_device(device)
    rank, world = _world()
    if batch % world:
        raise ValueError(f"a global batch of {batch} does not split over {world} ranks")
    b = batch // world
    x0m, x0s = batched_scenarios(traj, batch, device=device)
    x0m, x0s = x0m[rank * b:(rank + 1) * b], x0s[rank * b:(rank + 1) * b]
    _, log = sim.run(x0m, x0s, steps, key=0)
    lat = log.lat_dev.abs().to(torch.float64)
    ok = (log.simSolverDebug[..., 4] == 0).sum().to(torch.float64)
    tot = _all_reduce(torch.stack([lat.sum(), ok]), device, dist.ReduceOp.SUM)
    return ShardedRun(mean_abs_lat_dev=float(tot[0]) / (batch * steps), solver_ok=int(tot[1]),
                      local_mean=float(lat.mean()), log=log)


def scaling_report(sim, traj, device_counts=None, batch_per_device: int = 128, steps: int = 50,
                   device=None):
    """Aggregate solves/s at each device count n (default [1, world size]).

    At n, ranks < n each run their shard of a global batch of
    batch_per_device * n scenarios for `steps` steps, once warm and once
    timed; the aggregate is the global batch x steps over the slowest
    rank's time (a MAX all-reduce, to which the idle ranks give 0). Every
    rank takes part in the collectives and returns the same rows:
    {"devices", "batch", "solves_per_sec", "efficiency"}."""
    device = resolve_device(device)
    rank, world = _world()
    counts = sorted(set(device_counts or [1, world]))
    if counts[0] < 1 or counts[-1] > world:
        raise ValueError(f"device counts {counts} outside 1..{world} (the world size)")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    results = []
    for n in counts:
        batch = batch_per_device * n
        x0m, x0s = batched_scenarios(traj, batch, device=device)
        lo, hi = rank * batch_per_device, (rank + 1) * batch_per_device
        dt = 0.0
        for _ in range(2):  # a warm run, then the timed one
            _all_reduce([0.0], device, dist.ReduceOp.MAX)  # start together
            if rank < n:
                t0 = time.perf_counter()
                sim.run(x0m[lo:hi], x0s[lo:hi], steps, key=0)
                sync()
                dt = time.perf_counter() - t0
        dt = float(_all_reduce([dt], device, dist.ReduceOp.MAX)[0])
        results.append({"devices": n, "batch": batch, "solves_per_sec": batch * steps / dt,
                        "efficiency": None})
    base = results[0]["solves_per_sec"] / results[0]["devices"]
    for r in results:
        r["efficiency"] = r["solves_per_sec"] / (r["devices"] * base)
    return results
