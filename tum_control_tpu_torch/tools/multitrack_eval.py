"""Full-lap closed-loop evaluation on the three reference tracks
(Monteblanco, Modena, LVMS) for every controller (port of
tools/multitrack_eval.py):

    python -m tum_control_tpu_torch.tools.multitrack_eval [T_seconds] [--device cuda|cpu]

One scenario a (track, controller) pair, T = 100 s by default; one row
each: |lat_dev| mean / max, |vel_dev| mean, the solver-ok share and the
run's wall seconds (common.lap_run).
"""
import argparse
import sys

import torch

from tum_control_tpu_torch.tools import common

TRACKS = ("monteblanco", "modena", "lvms")
CONTROLLERS = ("nominal", "snmpc", "rnmpc")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("T", type=float, nargs="?", default=100.0)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns [dict(track, ctrl, the lap's stats, log)] in the printed order."""
    from tum_control_tpu_torch.config import MPCConfig

    args = parse_args(argv)
    device = common.start(args, dtype)
    rows = []
    for track in TRACKS:
        for ctrl in CONTROLLERS:
            lap = common.lap_run(track, MPCConfig(controller=ctrl), args.T, device, dtype)
            s = lap.stats
            print(f"{track:12s} {ctrl:8s} dev_lat mean/max {s['lat_mean']:.3f}/"
                  f"{s['lat_max']:.3f} dev_vel mean {s['vel_mean']:.3f} ok {s['ok']*100:.1f}% "
                  f"wall {s['wall']:.1f}s", flush=True)
            rows.append(dict(track=track, ctrl=ctrl, **s, log=lap.log))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
