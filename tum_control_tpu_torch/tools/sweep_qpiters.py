"""Closed-loop throughput and tracking against the IPM's iteration count
(port of tools/sweep_qpiters.py):

    python -m tum_control_tpu_torch.tools.sweep_qpiters [counts...] [--batch 256]
        [--steps 1000] [--settle 100] [--device cuda|cpu]

For each qp_iters count (default 4 5 6) the nominal closed loop at `batch`
scenarios under bench.py's protocol (common.settle_and_run): solves/s, the
solver-ok fraction and |lat_dev| p50 / p99 / max over the timed window.
The JAX script fixes batch, steps and settle at 256, 1000 and 100.
"""
import argparse
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("counts", nargs="*", type=int, default=[4, 5, 6])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--settle", type=int, default=100)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns [dict(qp_iters, solves_per_s, ok, p50, p99, max)]."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    args = parse_args(argv)
    device = common.start(args, dtype)
    rows = []
    for it in args.counts:
        sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=args.steps * 0.02),
                                              MPCConfig(qp_iters=it), device=device, dtype=dtype)
        x0m, x0s = batched_scenarios(traj, args.batch, dtype=dtype, device=device)
        *_, log, dt = common.settle_and_run(sim, x0m, x0s, args.settle, args.steps, device)
        lat = log.lat_dev.abs().double().cpu().numpy()
        ok = float((log.simSolverDebug[..., 4] == 0).double().mean())
        rows.append(dict(qp_iters=it, solves_per_s=args.batch * args.steps / dt, ok=ok,
                         p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)),
                         max=float(lat.max())))
        r = rows[-1]
        print(f"qp_iters={it}: {r['solves_per_s']:.1f} solves/s, ok={ok:.4f}, "
              f"lat p50/p99/max = {r['p50']:.4f}/{r['p99']:.4f}/{r['max']:.4f} m", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
