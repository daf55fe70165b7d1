"""Tracking quality against the SQP iterations per step (port of
tools/quality_exp.py):

    python -m tum_control_tpu_torch.tools.quality_exp K [--T 100] [--device cuda|cpu]

The nominal NMPC with `MPCConfig(sqp_iters=K)` over the Monteblanco lap
(the JAX script fixes T = 100 s; `--T` cuts it), one scenario: |lat_dev|
mean / max, |vel_dev| mean, the solver-ok share and the run's wall
seconds. At K > 1 each step linearizes, condenses and solves K times (K1,
K2, K3 x 4, K4 x 3, K5 per iteration).
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("K", type=int)
    ap.add_argument("--T", type=float, default=100.0)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(sqp_iters, the lap's stats, log)."""
    from tum_control_tpu_torch.config import MPCConfig

    args = parse_args(argv)
    device = common.start(args, dtype)
    lap = common.lap_run("monteblanco", MPCConfig(sqp_iters=args.K), args.T, device, dtype)
    s = lap.stats
    print(f"sqp_iters={args.K} dev_lat mean/max {s['lat_mean']:.4f}/{s['lat_max']:.4f} "
          f"dev_vel mean {s['vel_mean']:.4f} ok {s['ok']*100:.1f}% wall {s['wall']:.1f}s",
          flush=True)
    return dict(sqp_iters=args.K, **s, log=lap.log)


if __name__ == "__main__":
    main(sys.argv[1:])
