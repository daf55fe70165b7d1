"""Five tail scenarios of the nominal closed loop at the card's default
float32 products and with TF32 (port of tools/diag_precision.py):

    python -m tum_control_tpu_torch.tools.diag_precision [--tf32] [--steps 300]
        [--settle 100] [--device cuda|cpu]

Runs scenarios 213, 202, 242, 199 and 211 of batched_scenarios(traj, 256)
for `settle` steps, then `steps` more, and prints each one's max |lat_dev|,
its step and whether every solve was ok. The JAX script's --highest forced
exact float32 matrix products where the TPU's default takes bf16 passes.
The card's default is exact (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False, as chip_smoke.py checks); --tf32
turns both on, the known trap of the gradient products (ROADMAP.md, section
3): diff a default run against a --tf32 run. The flags are global to the
process, so the tool restores them on exit; run it with --tf32 only in a
process of its own. On the CPU the flags change nothing, and the tool
leaves them alone and says so.
"""
import argparse
import sys

import numpy as np
import torch

from tum_control_tpu_torch.tools import common

SCENARIOS = [213, 202, 242, 199, 211]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--settle", type=int, default=100)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def run(args, device, dtype):
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig, SimConfig
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    sim, _, _, traj, _ = build_simulation(SimConfig(sim_mode=0, T=args.steps * 0.02),
                                          MPCConfig(), device=device, dtype=dtype)
    x0m, x0s = batched_scenarios(traj, 256, dtype=dtype, device=device)
    idx = torch.tensor(SCENARIOS, device=device)
    *_, log, _ = common.settle_and_run(sim, x0m[idx], x0s[idx], args.settle, args.steps, device)
    lat = np.abs(log.lat_dev.double().cpu().numpy())
    st = log.simSolverDebug[..., 4].cpu().numpy()
    mode = "tf32" if args.tf32 else "default"
    rows = []
    for j, scen in enumerate(SCENARIOS):
        rows.append(dict(scen=scen, run_max=float(lat[j].max()), argmax=int(lat[j].argmax()),
                         ok=bool((st[j] == 0).all())))
        print(f"[{mode}] scen {scen}: run_max={rows[-1]['run_max']:.4f} at {rows[-1]['argmax']}, "
              f"ok={int(rows[-1]['ok'])}")
    return rows


def main(argv=None, dtype=torch.float32):
    """Returns [dict(scen, run_max, argmax, ok)] of the five scenarios."""
    args = parse_args(argv)
    device = common.start(args, dtype)
    if not args.tf32:
        return run(args, device, dtype)
    if device.type != "cuda":
        print("--tf32: the TF32 flags act on CUDA matrix products only; on the CPU the run is "
              "the default one")
        return run(args, device, dtype)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return run(args, device, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


if __name__ == "__main__":
    main(sys.argv[1:])
