"""Aggregate closed-loop solve throughput at each device count, written to a
JSON file (port of tools/scaling_eval.py):

    python -m tum_control_tpu_torch.tools.scaling_eval [OUT.json]
        [--nproc N] [--device cuda|cpu] [--batch-per-device 128] [--steps 50]
    torchrun --nproc-per-node N -m tum_control_tpu_torch.tools.scaling_eval [OUT.json]

One process per device: under torchrun the processes join through the
env:// variables; otherwise the tool starts --nproc processes itself
(default: the card count, or 1 with --device cpu), joined by tcp:// on a
free localhost port. Rank 0 writes parallel/distributed.py's
`scaling_report` at device counts 1, 2, 4, ... up to the world size, plus
the world size itself. On the CPU the processes run under gloo, each with
one torch thread: the rows show that the sharded program runs and reduces
at every count, not what a device would do.
"""
import argparse
import json
import os
import socket
import sys

import torch

from tum_control_tpu_torch.device import resolve_device

DEFAULT_OUT = "Logs/scaling_report.json"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=DEFAULT_OUT)
    ap.add_argument("--nproc", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch-per-device", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    return ap.parse_args(argv)


def device_counts(world: int):
    counts, n = [], 1
    while n < world:
        counts.append(n)
        n *= 2
    return counts + [world]


def worker(rank, world, address, args, device):
    """One rank: join the group on `device` (main's resolved device), build
    the nominal closed loop there, run scaling_report; rank 0 writes the
    JSON. Returns the rows."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.distributed import initialize_distributed, scaling_report

    if device.type == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    if address is None:  # torchrun
        dev = initialize_distributed(device=device)
    else:
        dev = initialize_distributed(address, world, rank, device=device)
    try:
        world = dist.get_world_size()
        sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0), MPCConfig(), device=dev)
        rows = scaling_report(sim, traj, device_counts(world), args.batch_per_device, args.steps,
                              device=dev)
        if dist.get_rank() == 0:
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            report = {"platform": dev.type, "device": name, "world_size": world,
                      "backend": dist.get_backend(), "batch_per_device": args.batch_per_device,
                      "steps": args.steps, "rows": rows}
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)
            for r in rows:
                print(f"devices={r['devices']} batch={r['batch']} "
                      f"solves/s={r['solves_per_sec']:.1f} eff={r['efficiency']:.3f}")
            print("wrote", args.out)
        return rows
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:
        return worker(None, None, None, args, device)
    nproc = args.nproc or (1 if device.type == "cpu" else torch.cuda.device_count())
    address = f"tcp://127.0.0.1:{_free_port()}"
    if nproc == 1:
        return worker(0, 1, address, args, device)
    import torch.multiprocessing as mp

    from tum_control_tpu_torch.tools import scaling_eval  # by import path, also under -m

    mp.start_processes(scaling_eval.worker, args=(nproc, address, args, device), nprocs=nproc,
                       join=True, start_method="spawn")
    with open(args.out) as f:
        return json.load(f)["rows"]


if __name__ == "__main__":
    main(sys.argv[1:])
