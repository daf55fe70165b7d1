"""Validate the WMPC action catalogs under state-estimation noise (port of
tools/catalog_noise_validation.py):

    python -m tum_control_tpu_torch.tools.catalog_noise_validation [--T 40] [--seeds 3]
        [--tracks monteblanco modena lvms]
        [--catalogs data/F.csv data/F_jax_r4.csv data/F_jax_r4_lowrisk.csv]
        [--out Logs/catalog_noise_torch.json] [--device cuda|cpu]

Every set of each catalog runs under the reference's state-estimation
noise envelope (gaussian, SimConfig.w_state_estimation), on every track
and for every seed: (sets x tracks x seeds) closed loops of the nominal
NMPC, each scenario on its own lap (track/trajectory.py::select_laps)
under its set's weights (learn/bo/objective.py::params_to_mods), from the
lap's first point. Per set: the worst max |lat_dev| and the lowest
solver-ok share over its tracks and seeds; per catalog the worst case and
the flagged sets (worst > 2 m or ok < 1). Writes the JAX script's JSON
layout and prints one line per catalog.

Common random numbers, as in the JAX script, where every scenario draws
from PRNGKey(seed): every set and every track of one seed sees the same
noise sequence. Here the batch shares one generator, so the noise is drawn
once per seed (an (n_steps, 7) sequence from a generator seeded with the
seed, sim/disturbances.py::draw_disturbance) and replayed to each scenario
of that seed through the loop's playback input. The derivative
disturbances stay off, as in the JAX script's SimConfig.

The JAX script pads its batch to a multiple of 128, the Pallas kernels'
lane width, and vmaps one jitted scan over it. Nothing here corresponds:
a catalog's scenarios run as one unpadded batch (F.csv: 26 sets x 3
tracks x 3 seeds = 234) of batched launches per step.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tum_control_tpu_torch.tools import common

NOISE = "gaussian SE envelope sim_main_params.yaml:50-67"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=float, default=40.0)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--tracks", nargs="+", default=["monteblanco", "modena", "lvms"])
    ap.add_argument("--catalogs", nargs="+",
                    default=["data/F.csv", "data/F_jax_r4.csv", "data/F_jax_r4_lowrisk.csv"])
    ap.add_argument("--out", default="Logs/catalog_noise_torch.json")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def noise_config(T: float):
    """The tool's closed loop: the default lap, T seconds, the state-
    estimation noise on and taken from the playback input."""
    from tum_control_tpu_torch.config import SimConfig

    return SimConfig(sim_mode=0, T=T, simulate_state_estimation=True, disturbance_playback=True)


def seed_noise(sim, seeds, n_steps: int) -> torch.Tensor:
    """(len(seeds), n_steps, 7): seed s's noise sequence, drawn from a
    generator seeded with s."""
    from tum_control_tpu_torch.sim.closed_loop import make_generator
    from tum_control_tpu_torch.sim.disturbances import draw_disturbance

    dev = sim.dist_se.magnitudes.device
    return torch.stack([draw_disturbance(sim.dist_se, make_generator(int(s), dev), n_steps)
                        for s in seeds])


def catalog_start(sim, table, stacked, n_seeds: int):
    """The (sets x tracks x seeds) scenarios, seeds fastest: scenario
    (s * n_tracks + t) * n_seeds + d runs row s of `table` on lap t of
    `stacked` from the lap's first point (the baseline sweep's scenario
    s * n_tracks + t, get_baseline_performances.py::sweep_start, once per
    seed) under seed d's noise. Returns (carry, traj, mods, seed_pos): the
    initial carry, each scenario's lap and QP weights for
    `ClosedLoopSim.step`, and its seed's position (n,)."""
    from tum_control_tpu_torch.get_baseline_performances import sweep_start

    carry, traj, mods = sweep_start(sim, table, stacked)
    n = carry.x_sim.shape[0]
    ar = lambda k: torch.arange(k, device=carry.x_sim.device)
    rows = ar(n).repeat_interleave(n_seeds)
    carry, traj, mods = (common.take_rows(x, rows) for x in (carry, traj, mods))
    return carry, traj, mods, ar(n_seeds).repeat(n)


def run_catalog(sim, table, stacked, noise, n_steps: int):
    """Every row of `table` on every lap of `stacked` under every seed's
    noise (`noise` (n_seeds, >= n_steps, 7), replayed), n_steps steps.
    Returns (max |lat_dev|, solver-ok share), each (sets, tracks, seeds)."""
    n_sets, n_tracks, n_seeds = len(table), stacked.pos.shape[0], noise.shape[0]
    carry, traj, mods, seed_pos = catalog_start(sim, table, stacked, n_seeds)
    w_se = noise[seed_pos]
    zero = torch.zeros_like(carry.x_sim)
    max_lat = torch.zeros_like(carry.x_sim[:, 0])
    n_ok = torch.zeros_like(max_lat)
    for k in range(n_steps):
        carry, log = sim.step(carry, zero, w_se[:, k], traj=traj, mods=mods)
        max_lat = torch.maximum(max_lat, log.lat_dev.abs())
        n_ok = n_ok + (log.simSolverDebug[:, 4] == 0).to(n_ok.dtype)
    shape = (n_sets, n_tracks, n_seeds)
    return max_lat.reshape(shape), (n_ok / n_steps).reshape(shape)


def catalog_report(n_sets: int, max_lat, ok) -> dict:
    """The JSON entry of one catalog from its (sets, tracks, seeds) arrays."""
    per_set_worst = max_lat.max(axis=(1, 2))
    per_set_ok = ok.min(axis=(1, 2))
    flagged = np.nonzero((per_set_worst > 2.0) | (per_set_ok < 1.0))[0]
    return {
        "n_sets": int(n_sets),
        "worst_max_lat_dev": float(per_set_worst.max()),
        "median_max_lat_dev": float(np.median(per_set_worst)),
        "min_solver_ok": float(per_set_ok.min()),
        "sets_flagged": [int(i) for i in flagged],
        "per_set_worst": [round(float(v), 3) for v in per_set_worst],
        "per_set_ok": [round(float(v), 4) for v in per_set_ok],
    }


def main(argv=None, dtype=torch.float32, noise=None):
    """Returns dict(report (the JSON), out, runs: {catalog: dict(max_lat,
    ok (sets, tracks, seeds) numpy, seconds, scenarios)}, noise). `noise`
    (n_seeds, >= n_steps, 7) replaces the seeds' draws (the tests feed
    recorded sequences)."""
    from tum_control_tpu_torch import config as cfg_mod
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.config import MPCConfig
    from tum_control_tpu_torch.learn.wmpc import load_param_table
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories

    args = parse_args(argv)
    device = common.start(args, dtype)
    sim_cfg = noise_config(args.T)
    sim, *_ = build_simulation(sim_cfg, MPCConfig(), device=device, dtype=dtype)
    n_steps = sim_cfg.Nsim
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"),
                            dtype=dtype, device=device)
        for t in args.tracks])
    if noise is None:
        noise = seed_noise(sim, range(args.seeds), n_steps)
    noise = torch.as_tensor(noise, dtype=dtype, device=device)
    if noise.shape[0] != args.seeds or noise.shape[1] < n_steps:
        raise ValueError(f"noise of shape {tuple(noise.shape)} for {args.seeds} seeds and "
                         f"{n_steps} steps")
    report = {"T": args.T, "seeds": args.seeds, "tracks": args.tracks, "noise": NOISE,
              "catalogs": {}}
    runs = {}
    for cat in args.catalogs:
        table = load_param_table(os.path.join(cfg_mod.REPO_ROOT, cat))
        common.sync(device)
        t0 = time.perf_counter()
        max_lat, ok = run_catalog(sim, table, stacked, noise, n_steps)
        max_lat, ok = max_lat.double().cpu().numpy(), ok.double().cpu().numpy()
        secs = time.perf_counter() - t0
        entry = report["catalogs"][cat] = catalog_report(len(table), max_lat, ok)
        runs[cat] = dict(max_lat=max_lat, ok=ok, seconds=secs, scenarios=max_lat.size)
        print(f"{cat}: {len(table)} sets, worst max|lat_dev| {entry['worst_max_lat_dev']:.3f} m "
              f"(median {entry['median_max_lat_dev']:.3f}), min solver-ok "
              f"{entry['min_solver_ok']:.4f}, flagged sets: {entry['sets_flagged']}",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", args.out)
    return dict(report=report, out=args.out, runs=runs, noise=noise)


if __name__ == "__main__":
    main(sys.argv[1:])
