"""WMPC evaluation at the reference's own protocol (port of
tools/rl_protocol_eval.py):

    python -m tum_control_tpu_torch.tools.rl_protocol_eval [T] [MODEL_DIR ...]
        [--device cuda|cpu]

Full T-second laps (default 120 s, the ACC24 golden window, at least one
lap) on all three tracks, per track lat_dev RMS / max, vel_dev RMS and the
solver-ok share, with the mean RMS and the worst max over the tracks, for

  * static weights (the shipped MPC_params.yaml point, no WMPC),
  * each model directory given, by default those of DEFAULT_MODELS that
    exist: the converted reference SB3 policy (new_BO_F) and the
    self-trained PPO seeds.

The JAX script runs on its CPU in float64 unless RL_EVAL_TPU is set;
here `--device` chooses (cuda by default, float32 there; `main(argv,
dtype=...)` takes float64 for the CPU).
"""
import argparse
import os
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common

TRACKS = ("monteblanco", "modena", "lvms")
DEFAULT_MODELS = (
    "data/wmpc_models/new_BO_F",
    "data/wmpc_models/jax_ppo_r2",
    "data/wmpc_models/jax_ppo_s1",
    "data/wmpc_models/jax_ppo_s2",
)


def run_lap(track: str, T: float, model_dir: str = None, device=None, dtype=torch.float32):
    """The lap of one row and track (common.Lap): the static weights without
    `model_dir`, else WMPC with that model."""
    from tum_control_tpu_torch.config import MPCConfig
    from tum_control_tpu_torch.device import resolve_device

    mpc_cfg = (MPCConfig(enable_WMPC=True, WMPC_model=model_dir) if model_dir
               else MPCConfig())
    return common.lap_run(track, mpc_cfg, T, resolve_device(device), dtype)


def run_one(track: str, T: float, model_dir: str = None, device=None, dtype=torch.float32):
    """(lat_dev RMS, max |lat_dev|, vel_dev RMS, solver-ok share) of run_lap."""
    s = run_lap(track, T, model_dir, device, dtype).stats
    return s["lat_rms"], s["lat_max"], s["vel_rms"], s["ok"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("T", type=float, nargs="?", default=120.0)
    ap.add_argument("models", nargs="*")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns [dict(name, model_dir, laps: [dict(track, the lap's stats,
    log)], mean_rms, worst_max)] in the printed order."""
    from tum_control_tpu_torch.config import REPO_ROOT

    args = parse_args(argv)
    device = common.start(args, dtype)
    exists = lambda m: os.path.exists(m if os.path.isabs(m) else os.path.join(REPO_ROOT, m))
    models = args.models or [m for m in DEFAULT_MODELS if exists(m)]
    rows = [("static (MPC_params.yaml)", None)] + [(os.path.basename(m), m) for m in models]
    print(f"full {args.T:.0f} s laps, all tracks  (lat RMS / lat max / vel RMS / ok%)")
    out = []
    for name, mdir in rows:
        cells, laps = [], []
        for track in TRACKS:
            lap = run_lap(track, args.T, mdir, device, dtype)
            s = lap.stats
            cells.append(f"{track[:5]}: {s['lat_rms']:.3f}/{s['lat_max']:.3f}/"
                         f"{s['vel_rms']:.3f}/{s['ok']*100:.0f}%")
            laps.append(dict(track=track, **s, log=lap.log))
        mean_rms = float(np.mean([lp["lat_rms"] for lp in laps]))
        worst_max = float(np.max([lp["lat_max"] for lp in laps]))
        print(f"{name:26s} {'  '.join(cells)}  | mean RMS {mean_rms:.3f}, "
              f"worst max {worst_max:.3f}", flush=True)
        out.append(dict(name=name, model_dir=mdir, laps=laps, mean_rms=mean_rms,
                        worst_max=worst_max))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
