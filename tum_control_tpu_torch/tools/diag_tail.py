"""The |lat_dev| tail of the nominal closed loop, scenario by scenario
(port of tools/diag_tail.py):

    python -m tum_control_tpu_torch.tools.diag_tail [batch] [steps] [--settle 100]
        [--device cuda|cpu]

Runs bench.py's protocol (common.settle_and_run) at `batch` (default 256)
scenarios from batched_scenarios for `steps` (300) timed steps after the
settle, and prints the solver-ok fraction, the p50 / p99 / max of |lat_dev|
over the timed window and the 10 scenarios with the largest maximum: their
start point on the lap, the maxima over the settle and the timed window,
the step of the maximum, the start's speed, yaw rate, steering angle and
acceleration, and the number of failed solves.
"""
import argparse
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("steps", nargs="?", type=int, default=300)
    ap.add_argument("--settle", type=int, default=100)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(ok, p50, p99, max, run_max (batch,), settle_max (batch,),
    worst: [dict] of the 10 largest maxima, largest last)."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    args = parse_args(argv)
    device = common.start(args, dtype)
    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=args.steps * 0.02),
                                          MPCConfig(), device=device, dtype=dtype)
    x0m, x0s = batched_scenarios(traj, args.batch, dtype=dtype, device=device)
    _, slog, _, log, dt = common.settle_and_run(sim, x0m, x0s, args.settle, args.steps, device)
    print(f"ran {args.batch} x {args.steps} steps in {dt:.1f} s", file=sys.stderr)

    host = lambda t: t.double().cpu().numpy()
    lat, slat = np.abs(host(log.lat_dev)), np.abs(host(slog.lat_dev))
    st = host(log.simSolverDebug[..., 4])
    per = lat.max(axis=1)
    res = dict(ok=float((st == 0).mean()), p50=float(np.percentile(lat, 50)),
               p99=float(np.percentile(lat, 99)), max=float(lat.max()), run_max=per,
               settle_max=slat.max(axis=1), worst=[])
    print("ok frac", res["ok"])
    print("p50/p99/max", res["p50"], res["p99"], res["max"])
    starts = np.linspace(0, traj.n_points - 1, args.batch).astype(int)
    x0 = host(x0m)
    for i in np.argsort(per)[-10:]:
        w = dict(scen=int(i), start=int(starts[i]), settle_max=float(slat[i].max()),
                 run_max=float(per[i]), argmax=int(lat[i].argmax()), v0=float(x0[i, 3]),
                 yr0=float(x0[i, 5]), df0=float(x0[i, 6]), a0=float(x0[i, 7]),
                 stat=int((st[i] != 0).sum()))
        res["worst"].append(w)
        print(f"scen {w['scen']} start={w['start']} settle_max={w['settle_max']:.2f} "
              f"run_max={w['run_max']:.2f} argmax={w['argmax']} v0={w['v0']:.1f} "
              f"yr0={w['yr0']:.3f} df0={w['df0']:.3f} a0={w['a0']:.2f} stat={w['stat']}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
