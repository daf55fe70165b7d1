"""High-level assembly: configs -> controller + closed-loop simulation
(port of tum_control_tpu/api.py; this slice builds the nominal and the
stochastic (SNMPC) controllers).

Everything runs on `cuda` unless the caller passes a device (the CPU tests
pass `device="cpu"`); without a CUDA device and without an explicit device,
`build_controller` and `build_simulation` raise (device.py).
"""
from __future__ import annotations

import os

import torch

from tum_control_tpu_torch import config as cfg_mod
from tum_control_tpu_torch.config import (
    MPCConfig, SimConfig, load_gg_table, load_tire_params, load_vehicle_params,
)
from tum_control_tpu_torch.controllers.common import GGTables
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.sim.closed_loop import ClosedLoopSim
from tum_control_tpu_torch.sim.disturbances import disturbance_config
from tum_control_tpu_torch.track.trajectory import initial_state, load_ref_trajectory, load_track


def build_controller(mpc_cfg: MPCConfig, sim_cfg: SimConfig, config_path: str = None,
                     device=None, dtype=torch.float32):
    device = resolve_device(device)
    config_path = config_path or cfg_mod.DEFAULT_CONFIG_PATH
    vp = load_vehicle_params(config_path, sim_cfg.veh_params_file_MPC)
    tp = load_tire_params(config_path, sim_cfg.tire_params_file_MPC)
    gg = GGTables(*load_gg_table(config_path, mpc_cfg.lookuptable_gg_limits),
                  device=device, dtype=dtype)
    name = mpc_cfg.controller.lower()
    if name == "nominal":
        from tum_control_tpu_torch.controllers.nominal import NominalNMPC

        ctrl = NominalNMPC(mpc_cfg, sim_cfg.N, sim_cfg.Ts_MPC, vp, tp, gg, device=device,
                           dtype=dtype)
    elif name == "snmpc":
        from tum_control_tpu_torch.controllers.snmpc import StochasticNMPC

        ctrl = StochasticNMPC(mpc_cfg, sim_cfg.N, sim_cfg.Ts_MPC, vp, tp, gg, device=device,
                              dtype=dtype)
    elif name == "rnmpc":
        raise NotImplementedError(f"controller '{name}' waits for its slice of the port")
    else:
        raise ValueError(f"unknown controller '{mpc_cfg.controller}'")
    if mpc_cfg.enable_WMPC:
        raise NotImplementedError("WMPC waits for its slice of the port")
    return ctrl


def build_simulation(sim_cfg: SimConfig, mpc_cfg: MPCConfig, config_path: str = None,
                     device=None, dtype=torch.float32):
    """Returns (sim, x0_mpc (8,), x0_sim (7,), traj, track); batch the initial
    states (e.g. `x0_mpc[None]` or parallel/mesh.py::batched_scenarios)
    before `sim.run`."""
    device = resolve_device(device)
    config_path = config_path or cfg_mod.DEFAULT_CONFIG_PATH
    controller = build_controller(mpc_cfg, sim_cfg, config_path, device=device, dtype=dtype)
    ref_traj_path = os.path.join(sim_cfg.trajectory_path, sim_cfg.ref_traj_file)
    traj = load_ref_trajectory(ref_traj_path, dtype=dtype, device=device)
    track = load_track(os.path.join(sim_cfg.trajectory_path, sim_cfg.track_file))
    vp_sim = load_vehicle_params(config_path, sim_cfg.veh_params_file_simulator)
    tp_sim = load_tire_params(config_path, sim_cfg.tire_params_file_simulator)
    x0_mpc, x0_sim = initial_state(ref_traj_path, sim_cfg.idx_ref_start)
    dist_deriv = disturbance_config(
        sim_cfg.disturbance_type_derivatives, sim_cfg.w_derivatives,
        enabled=sim_cfg.simulate_disturbances, dtype=dtype, device=device,
    )
    dist_se = disturbance_config(
        sim_cfg.disturbance_type_state_estimation, sim_cfg.w_state_estimation,
        enabled=sim_cfg.simulate_state_estimation, dtype=dtype, device=device,
    )
    sim = ClosedLoopSim(
        controller=controller, traj=traj, sim_mode=sim_cfg.sim_mode, Ts=sim_cfg.Ts_sim_step,
        Tp=sim_cfg.Tp, N=sim_cfg.N, vp_sim=vp_sim, tp_sim=tp_sim, dist_deriv=dist_deriv,
        dist_se=dist_se, playback=sim_cfg.disturbance_playback,
    )
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return sim, t(x0_mpc), t(x0_sim), traj, track
