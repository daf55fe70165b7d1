"""Closed-loop throughput against batch size (port of tools/batch_sweep.py):

    python -m tum_control_tpu_torch.tools.batch_sweep [batches...] [--steps 300]
        [--settle 100] [--device cuda|cpu]

bench.py's settle-and-measure protocol (common.settle_and_run) at each batch
(default 64 128 256 512 1024): solves/s, microseconds per solve, the
efficiency relative to the smallest batch's per-scenario rate, and the p99
of |lat_dev| over the timed window. The JAX script tiles batches above 512
into sequential 512-wide programs (lax.map), because beyond that its step's
intermediates spilled out of the TPU's VMEM. Nothing here corresponds: each
step runs the whole batch as one set of batched launches, whose tensors
live in device memory at any batch, so every batch runs whole.
"""
import argparse
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batches", nargs="*", type=int, default=[64, 128, 256, 512, 1024])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--settle", type=int, default=100)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns [dict(batch, solves_per_s, us_per_solve, rel_eff, p99_lat_dev,
    ok)] in the order of the batches."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    args = parse_args(argv)
    device = common.start(args, dtype)
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=args.steps * 0.02),
                                          MPCConfig(), device=device, dtype=dtype)
    print(f"steps={args.steps} settle={args.settle}")
    print(f"{'batch':>6} {'solves/s':>10} {'us/solve':>9} {'rel_eff':>8} {'p99 lat_dev':>12}")
    rows, base = [], None
    for batch in args.batches:
        x0m, x0s = batched_scenarios(traj, batch, dtype=dtype, device=device)
        *_, log, dt = common.settle_and_run(sim, x0m, x0s, args.settle, args.steps, device)
        sps = batch * args.steps / dt
        if base is None:
            base = sps / batch   # per-scenario rate at the first batch
        lat = log.lat_dev.abs().double().cpu().numpy()
        rows.append(dict(batch=batch, solves_per_s=sps, us_per_solve=1e6 / sps,
                         rel_eff=sps / (batch * base), p99_lat_dev=float(np.percentile(lat, 99)),
                         ok=float((log.simSolverDebug[..., 4] == 0).double().mean())))
        r = rows[-1]
        print(f"{batch:>6} {sps:>10.1f} {r['us_per_solve']:>9.2f} {r['rel_eff']:>8.3f} "
              f"{r['p99_lat_dev']:>12.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
