"""Baseline sweep on the GPU: every WMPC parameter set over full laps (the
port's counterpart of the root get_baseline_performances.py):

    python -m tum_control_tpu_torch.get_baseline_performances [--T 40]
        [--tracks monteblanco lvms] [--params data/F.csv] [--out Logs/baseline]
        [--device cuda|cpu]

The whole (parameter set x track) product is one batched closed loop of
n_sets x n_tracks scenarios, each on its own lap under its own QP weights,
on `--device` (cuda by default: without a card the run raises unless
`--device cpu` is given). Writes `<out>/<track>/<set>.npz` (lat_devs,
vel_devs, simU, status, params) and `<out>/<track>/summary.csv`.
"""
import argparse
import math
import os
import time

import numpy as np
import torch

from tum_control_tpu_torch import config as cfg_mod
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.bo.objective import params_to_mods
from tum_control_tpu_torch.learn.wmpc import load_param_table
from tum_control_tpu_torch.track.trajectory import (
    load_ref_trajectory, select_laps, stack_trajectories,
)


def sweep_start(sim, table, stacked):
    """The sweep's n_sets x n_tracks scenarios: scenario s * n_tracks + t
    runs row s of `table` (n_sets, 7) on lap t of `stacked`, from the lap's
    first point. Returns (carry, traj, mods): the initial carry, each
    scenario's lap and QP weights for `ClosedLoopSim.step`."""
    eng = sim.controller.engine
    dev, dt = eng.W.device, eng.W.dtype
    n_sets, n_tracks = len(table), stacked.pos.shape[0]
    p = torch.as_tensor(np.asarray(table), dtype=dt, device=dev).repeat_interleave(n_tracks, 0)
    traj = select_laps(stacked, torch.arange(n_tracks, device=dev).repeat(n_sets))
    mods = params_to_mods(eng, p)
    px = traj.pos[:, 0]
    yaw0 = torch.remainder(traj.yaw[:, 0], 2 * math.pi)
    x0m = torch.cat([px, yaw0[:, None], traj.v[:, :1], px.new_zeros((px.shape[0], 4))], dim=1)
    return sim.init_carry(x0m, x0m[:, :7], key=0), traj, mods


def sweep(sim, table, stacked, n_steps: int):
    """Every row of `table` (n_sets, 7) on every lap of `stacked` for
    `n_steps` closed-loop steps from the lap's first point, with no
    disturbance (scenarios as `sweep_start` lays them out). Returns
    (lat_dev, vel_dev, simU, status) tensors of shape (n_sets, n_tracks,
    n_steps[, 2])."""
    n_sets, n_tracks = len(table), stacked.pos.shape[0]
    carry, traj, mods = sweep_start(sim, table, stacked)
    zero = torch.zeros_like(carry.x_sim)
    lat, vel, U, status = [], [], [], []
    for _ in range(n_steps):
        carry, log = sim.step(carry, zero, zero, traj=traj, mods=mods)
        lat.append(log.lat_dev)
        vel.append(log.vel_dev)
        U.append(log.simU)
        status.append(log.simSolverDebug[:, 4])
    shape = lambda x: torch.stack(x, dim=1).reshape((n_sets, n_tracks, n_steps) + x[0].shape[1:])
    return shape(lat), shape(vel), shape(U), shape(status)


def write_results(out: str, tracks, table, lat, vel, U, status) -> list:
    """The reference layout: one npz per (track, set) and a summary.csv per
    track (max |lat_dev|, RMS vel_dev, solver-ok fraction per set). Returns
    the summaries, (n_sets, 3) per track."""
    lat, vel, U, status = (x.cpu().numpy() for x in (lat, vel, U, status))
    summaries = []
    os.makedirs(out, exist_ok=True)
    for ti, tname in enumerate(tracks):
        tdir = os.path.join(out, tname)
        os.makedirs(tdir, exist_ok=True)
        for si in range(len(table)):
            np.savez(os.path.join(tdir, f"{si}.npz"), lat_devs=lat[si, ti], vel_devs=vel[si, ti],
                     simU=U[si, ti], status=status[si, ti], params=table[si])
        summary = np.stack([
            np.abs(lat[:, ti]).max(axis=1),
            np.sqrt((vel[:, ti] ** 2).mean(axis=1)),
            (status[:, ti] == 0).mean(axis=1),
        ], axis=1)
        np.savetxt(os.path.join(tdir, "summary.csv"), summary, delimiter=",",
                   header="max_lat_dev,rms_vel_dev,solver_ok_frac")
        print(f"{tname}: max|lat| range [{summary[:, 0].min():.3f}, "
              f"{summary[:, 0].max():.3f}] m")
        summaries.append(summary)
    return summaries


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=40.0)
    ap.add_argument("--tracks", nargs="+", default=["monteblanco", "lvms"])
    ap.add_argument("--params", default="data/F.csv")
    ap.add_argument("--out", default="Logs/baseline")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim_cfg = SimConfig(sim_mode=0, T=args.T)
    sim, *_ = build_simulation(sim_cfg, MPCConfig(), device=device, dtype=dtype)
    n_steps = sim_cfg.Nsim
    table = load_param_table(os.path.join(cfg_mod.REPO_ROOT, args.params))
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"),
                            dtype=dtype, device=device)
        for t in args.tracks
    ])
    print(f"sweeping {len(table)} parameter sets x {len(args.tracks)} tracks x {n_steps} steps "
          f"on {device}")
    t0 = time.perf_counter()
    lat, vel, U, status = sweep(sim, table, stacked, n_steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"sweep: {time.perf_counter() - t0:.3f} s")
    return write_results(args.out, args.tracks, table, lat, vel, U, status)


if __name__ == "__main__":
    main()
