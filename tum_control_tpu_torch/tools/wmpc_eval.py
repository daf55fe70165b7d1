"""Evaluate a WMPC policy on a full closed-loop run (port of
tools/wmpc_eval.py):

    python -m tum_control_tpu_torch.tools.wmpc_eval MODEL_DIR [T] [TRACK] [--device cuda|cpu]
    WMPC_EVAL_ACTIONS_PLOT=path.png python -m tum_control_tpu_torch.tools.wmpc_eval ...

Runs `enable_WMPC=True` with the model directory (policy_weights.npz and
optionally rl_config.yaml with its actions_file) over TRACK (default
monteblanco) for T seconds (default 40), one scenario, and prints lat_dev
RMS / max, vel_dev RMS, the solver-ok share and the run's wall seconds.
With WMPC_EVAL_ACTIONS_PLOT set it also saves the policy's
action-probability trace (learn/evaluation.py::action_probability_trace),
which needs matplotlib (imported there, only then).
"""
import argparse
import os
import sys

import torch

from tum_control_tpu_torch.tools import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("T", type=float, nargs="?", default=40.0)
    ap.add_argument("track", nargs="?", default="monteblanco")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(model_dir, track, T, the lap's stats, log, and `trace`,
    (probs, actions) of the action-probability trace, when it was made)."""
    from tum_control_tpu_torch.config import MPCConfig

    args = parse_args(argv)
    device = common.start(args, dtype)
    mpc_cfg = MPCConfig(enable_WMPC=True, WMPC_model=args.model_dir)
    lap = common.lap_run(args.track, mpc_cfg, args.T, device, dtype)
    s = lap.stats
    print(f"{args.model_dir} on {args.track} ({args.T:.0f}s): dev_lat RMS/max "
          f"{s['lat_rms']:.3f}/{s['lat_max']:.3f} m, dev_vel RMS {s['vel_rms']:.3f} m/s, "
          f"ok {s['ok']*100:.1f}%, wall {s['wall']:.1f}s", flush=True)
    out = dict(model_dir=args.model_dir, track=args.track, T=args.T, **s, log=lap.log)
    plot = os.environ.get("WMPC_EVAL_ACTIONS_PLOT")
    if plot:
        from tum_control_tpu_torch.learn.evaluation import action_probability_trace

        out["trace"] = action_probability_trace(args.model_dir, track=args.track, T=args.T,
                                                 plot_path=plot, device=device, dtype=dtype)
        print(f"action-probability trace -> {plot}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
