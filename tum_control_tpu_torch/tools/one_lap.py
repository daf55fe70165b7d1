"""One closed-loop lap of one controller on one track (port of
tools/one_lap.py):

    python -m tum_control_tpu_torch.tools.one_lap TRACK CTRL T [--device cuda|cpu]

Prints the build time and M (the reference lap's points), then |lat_dev|
mean / max, |vel_dev| mean, the solver-ok share and the run's wall seconds
(common.lap_run). The JAX script's wall time includes the jit compile of
its scan; here the steps launch kernels built before or at their first
launch.
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("track")
    ap.add_argument("ctrl")
    ap.add_argument("T", type=float)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(track, ctrl, build_s, M, the lap's stats, log)."""
    from tum_control_tpu_torch.config import MPCConfig

    args = parse_args(argv)
    device = common.start(args, dtype)
    lap = common.lap_run(args.track, MPCConfig(controller=args.ctrl), args.T, device, dtype)
    print("build", lap.build_s, "M:", lap.n_points, flush=True)
    s = lap.stats
    print(f"{args.track} {args.ctrl} dev_lat mean/max {s['lat_mean']:.3f}/{s['lat_max']:.3f} "
          f"dev_vel mean {s['vel_mean']:.3f} ok {s['ok']*100:.1f}% wall {s['wall']:.1f}s",
          flush=True)
    return dict(track=args.track, ctrl=args.ctrl, build_s=lap.build_s, M=lap.n_points, **s,
                log=lap.log)


if __name__ == "__main__":
    main(sys.argv[1:])
