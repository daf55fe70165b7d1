"""The system under test as the drivers build it: the port's closed loop
through its public entry point `api.build_simulation`, in float32 on the
run's device, started from the seeded scenarios (benchmark/scenarios.py).
This module and the drivers are the only files of the benchmark that
import the port."""
from __future__ import annotations

import os
import sys

import torch

from benchmark.scenarios import lap_tensors, starts


def settings(cfg: dict):
    """(SimConfig, MPCConfig) of a configuration file."""
    from tum_control_tpu_torch.config import MPCConfig, SimConfig

    mpc = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["mpc"].items()}
    return SimConfig(**cfg["sim"]), MPCConfig(**mpc)


def build(ctx, batch: int):
    """(sim, initial SimCarry, lap points) for `batch` scenarios; prints
    the set-up's phases so far."""
    import time

    t0 = time.perf_counter()
    from tum_control_tpu_torch.api import build_simulation

    sim_cfg, mpc_cfg = settings(ctx.cell.cfg)
    t1 = time.perf_counter()
    sim, *_ = build_simulation(sim_cfg, mpc_cfg, device=ctx.device, dtype=torch.float32)
    t2 = time.perf_counter()
    lap = lap_tensors(os.path.join(sim_cfg.trajectory_path, sim_cfg.ref_traj_file), ctx.device)
    tr = ctx.cell.traffic
    vp = sim.controller.vp
    x0m, x0s = starts(lap, batch, ctx.seed, tr["lateral_offset_m"], tr["heading_error_rad"],
                      vp.lf + vp.lr, vp.lr, torch.float32, ctx.device)
    carry = sim.init_carry(x0m, x0s, key=ctx.seed)
    sync(ctx.device)
    t3 = time.perf_counter()
    say(f"set-up phases (s): before the port's import {t0 - ctx.t_start!r}, its import "
        f"{t1 - t0!r}, build_simulation {t2 - t1!r}, starts {t3 - t2!r}")
    return sim, carry, int(lap["pos"].shape[0])


def draws(sim) -> bool:
    """Whether the closed loop's step draws from its generator: sim_mode 0,
    no recorded disturbances played back, a derivative disturbance or
    estimation noise on."""
    from tum_control_tpu_torch.sim.disturbances import TYPE_NONE

    return (sim.sim_mode == 0 and not sim.playback
            and any(d.kind != TYPE_NONE for d in (sim.dist_deriv, sim.dist_se)))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def launches():
    """The hand-written kernels' launch counters (ops/kernels/build.py)."""
    from tum_control_tpu_torch.ops.kernels import build as kbuild

    return dict(kbuild.LAUNCHES)


class Result:
    """What a driver hands back to run.py: e2e (end-to-end metrics by name),
    attempted, failed, samples (compare.Sampler's), sample_rows, record
    (the traced run's spans and profile, for the per-layer readers; None
    untraced), memory_peak_bytes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def say(msg):
    print(msg, file=sys.stderr, flush=True)
