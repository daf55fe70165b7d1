"""High-level assembly: configs -> controller + closed-loop simulation
(port of tum_control_tpu/api.py): the nominal, stochastic (SNMPC) and
reduced robustified (R2NMPC) controllers, each optionally wrapped by the
weights-varying policy (WMPC).

Everything runs on `cuda` unless the caller passes a device (the CPU tests
pass `device="cpu"`); without a CUDA device and without an explicit device,
`build_controller` and `build_simulation` raise (device.py).
"""
from __future__ import annotations

import os
import warnings

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
                     device=None, dtype=torch.float32, tire_params=None):
    """`tire_params` (a TireParams, e.g. of 0-d tensors under autograd,
    params.scaled_tire_params) replaces the tire file's."""
    device = resolve_device(device)
    config_path = config_path or cfg_mod.DEFAULT_CONFIG_PATH
    vp = load_vehicle_params(config_path, sim_cfg.veh_params_file_MPC)
    tp = tire_params or load_tire_params(config_path, sim_cfg.tire_params_file_MPC)
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
        from tum_control_tpu_torch.controllers.rnmpc import ReducedRobustNMPC

        ctrl = ReducedRobustNMPC(mpc_cfg, sim_cfg.N, sim_cfg.Ts_MPC, vp, tp, gg, device=device,
                                 dtype=dtype)
    else:
        raise ValueError(f"unknown controller '{mpc_cfg.controller}'")
    if mpc_cfg.enable_WMPC:
        ctrl = _wrap_wmpc(ctrl, mpc_cfg, sim_cfg, device, dtype)
    return ctrl


def _wrap_wmpc(ctrl, mpc_cfg: MPCConfig, sim_cfg: SimConfig, device, dtype):
    """Attach the weights-varying policy of `mpc_cfg.WMPC_model` (a directory
    with policy_weights.npz and, optionally, rl_config.yaml)."""
    from tum_control_tpu_torch.learn.observation import ObservationConfig
    from tum_control_tpu_torch.learn.policy import load_sb3_policy
    from tum_control_tpu_torch.learn.wmpc import WMPCController, load_param_table

    root = cfg_mod.REPO_ROOT
    model_dir = mpc_cfg.WMPC_model
    if not os.path.isabs(model_dir):
        model_dir = os.path.join(root, model_dir)
    policy = load_sb3_policy(os.path.join(model_dir, "policy_weights.npz"), device=device,
                             dtype=dtype)
    rl_cfg_path = os.path.join(model_dir, "rl_config.yaml")
    n_points, n_stack = 10, 1
    actions_file = "data/F.csv"
    if os.path.exists(rl_cfg_path):
        rl_cfg = cfg_mod._load_yaml(rl_cfg_path)
        n_points = int(rl_cfg.get("obs_n_anticipation_points", 10))
        n_stack = int(rl_cfg.get("n_obs_stack", 1))
        # the catalogue the policy's actions index into; must match training
        actions_file = rl_cfg.get("actions_file", actions_file)
    if not os.path.isabs(actions_file):
        # converted reference checkpoints name the reference repository's
        # layout; the same catalogue ships here under data/<name>, an exact
        # alias resolved silently. Anything else resolves against the repo.
        ref_prefix = "Learning_To_Adapt/SafeRL_WMPC/_parameters/"
        if actions_file.startswith(ref_prefix):
            actions_file = os.path.join(root, "data", actions_file[len(ref_prefix):])
        else:
            actions_file = os.path.join(root, actions_file)
    if not os.path.exists(actions_file):
        fallback = os.path.join(root, "data", os.path.basename(actions_file))
        if os.path.exists(fallback):
            warnings.warn(f"WMPC actions_file '{actions_file}' not found; substituting "
                          f"'{fallback}'. Verify it matches the catalog the policy was "
                          "trained on.")
            actions_file = fallback
    table = load_param_table(actions_file)
    if policy.n_actions != len(table):
        raise ValueError(f"WMPC policy action head has {policy.n_actions} actions but catalog "
                         f"'{actions_file}' has {len(table)} rows: the checkpoint was trained "
                         "against a different actions_file.")
    return WMPCController(
        base=ctrl, policy=policy, param_table=table,
        obs_cfg=ObservationConfig(n_points=n_points, Ts=sim_cfg.Ts),
        update_period=mpc_cfg.weights_update_period, n_stack=n_stack,
    )


def build_simulation(sim_cfg: SimConfig, mpc_cfg: MPCConfig, config_path: str = None,
                     device=None, dtype=torch.float32, tire_params=None):
    """Returns (sim, x0_mpc (8,), x0_sim (7,), traj, track); batch the initial
    states (e.g. `x0_mpc[None]` or parallel/mesh.py::batched_scenarios)
    before `sim.run`. `tire_params` replaces the tires of both the plant and
    the controller (build_controller)."""
    device = resolve_device(device)
    config_path = config_path or cfg_mod.DEFAULT_CONFIG_PATH
    controller = build_controller(mpc_cfg, sim_cfg, config_path, device=device, dtype=dtype,
                                  tire_params=tire_params)
    ref_traj_path = os.path.join(sim_cfg.trajectory_path, sim_cfg.ref_traj_file)
    traj = load_ref_trajectory(ref_traj_path, dtype=dtype, device=device)
    track = load_track(os.path.join(sim_cfg.trajectory_path, sim_cfg.track_file))
    vp_sim = load_vehicle_params(config_path, sim_cfg.veh_params_file_simulator)
    tp_sim = tire_params or load_tire_params(config_path, sim_cfg.tire_params_file_simulator)
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
