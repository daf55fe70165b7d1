"""Typed configuration layer (copy of tum_control_tpu/config.py).

Loads the reference's YAML config schema unchanged into frozen dataclasses.
`REPO_ROOT` is the repository that holds this package, so `data/Config` and
`data/Trajectories` are the files the JAX package reads too.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import yaml

from tum_control_tpu_torch.params import (
    TireParams,
    VehicleParams,
    tire_params_from_dict,
    vehicle_params_from_dict,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG_PATH = os.path.join(REPO_ROOT, "data", "Config")
DEFAULT_TRAJECTORY_PATH = os.path.join(REPO_ROOT, "data", "Trajectories")


def _load_yaml(path: str) -> dict:
    with open(path, "r") as fh:
        return yaml.safe_load(fh)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Master simulation parameters (reference sim_main_params.yaml schema)."""

    sim_mode: int = 0              # 0 = CiL (separate plant), 1 = MPC-in-loop
    trajectory_path: str = DEFAULT_TRAJECTORY_PATH
    track_file: str = "track_monteblanco.json"
    ref_traj_file: str = "reftraj_monteblanco_edgar.json"
    idx_ref_start: int = 0
    ref_trajectory_type: int = 0
    veh_params_file_simulator: str = "EDGAR/veh_params_sim.yaml"
    tire_params_file_simulator: str = "EDGAR/pacejka_params.yaml"
    veh_params_file_MPC: str = "EDGAR/veh_params_pred.yaml"
    tire_params_file_MPC: str = "EDGAR/pacejka_params.yaml"
    Ts: float = 0.02
    T: float = 100.0
    Tp: float = 3.04
    Ts_MPC: float = 0.08
    # disturbances
    disturbance_playback: bool = False
    playback_log_file: str = ""
    simulate_state_estimation: bool = False
    disturbance_type_state_estimation: str = "gaussian"
    w_state_estimation: tuple = (0.15, 0.15, 0.01, 0.8, 0.35, 0.05, 0.005)
    simulate_disturbances: bool = False
    disturbance_type_derivatives: str = "uniform"
    w_derivatives: tuple = (0.8, 0.8, 0.1, 1.1, 0.1, 0.05, 0.1)
    # logging / viz (host-side)
    save_logs: bool = True
    file_logs_name: str = "run"
    live_visualization: int = 0
    live_plot_freq: int = 10
    xwidth: float = 100.0
    ywidth: float = 100.0
    GIF_animation_generation: bool = False
    GIF_file_name: str = "run.gif"

    @property
    def N(self) -> int:
        return int(self.Tp / self.Ts_MPC)

    @property
    def Nsim(self) -> int:
        return int(self.T / self.Ts) if self.sim_mode == 0 else int(self.T / self.Ts_MPC)

    @property
    def Ts_sim_step(self) -> float:
        """Wall interval covered by one closed-loop step."""
        return self.Ts if self.sim_mode == 0 else self.Ts_MPC


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Controller parameters (reference MPC_params.yaml schema)."""

    controller: str = "nominal"    # 'nominal' | 'snmpc' | 'rnmpc'
    costfunction_type: str = "NONLINEAR_LS"
    # cost scales + weights
    s_lon: float = 1.0
    s_lat: float = 1.0
    s_yaw: float = 1.0
    s_vel: float = 1.0
    s_jerk: float = 1.0
    s_steering_rate: float = 1.0
    q_lon: float = 2.8
    q_lat: float = 2.8
    q_yaw: float = 0.4
    q_vel: float = 0.2
    r_jerk: float = 38.1
    r_steering_rate: float = 101.4
    L1_pen: float = 106.7
    L2_pen: float = 9.9
    # constraints
    lookuptable_gg_limits: str = "EDGAR/ggv.csv"
    combined_acc_limits: int = 2   # 0 separate | 1 diamond | 2 circle
    # SNMPC / RNMPC
    stds: tuple = (0.0, 0.0, 0.0, 0.8, 0.35, 0.035, 0.0, 0.0)
    uncertainty_propagation_horizon: int = 5
    n_samples: int = 10
    gamma: float = 0.8
    expansion_degree: int = 2
    disturbance_type: str = "gaussian"
    # WMPC
    enable_WMPC: bool = False
    WMPC_model: str = ""
    weights_update_period: int = 20
    # solver: Mehrotra iterations per RTI QP solve, SQP iterations per step
    qp_iters: int = 3
    sqp_iters: int = 1

    def Q(self) -> np.ndarray:
        return np.diag(
            [
                self.q_lon / self.s_lon**2,
                self.q_lat / self.s_lat**2,
                self.q_yaw / self.s_yaw**2,
                self.q_vel / self.s_vel**2,
            ]
        )

    def R(self) -> np.ndarray:
        return np.diag(
            [self.r_jerk / self.s_jerk**2, self.r_steering_rate / self.s_steering_rate**2]
        )


_SE_KEYS = ("w_posx", "w_posy", "w_yaw", "w_vlong", "w_vlat", "w_yawrate", "w_delta_f")
_DERIV_KEYS = (
    "w_posx_dot", "w_posy_dot", "w_yaw_dot", "w_vlong_dot",
    "w_vlat_dot", "w_yawrate_dot", "w_delta_f_dot",
)


def load_sim_config(path: str) -> SimConfig:
    """Load a reference-format sim_main_params.yaml."""
    d = _load_yaml(path)
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if all(k in d for k in _SE_KEYS):
        kw["w_state_estimation"] = tuple(float(d[k]) for k in _SE_KEYS)
    if all(k in d for k in _DERIV_KEYS):
        kw["w_derivatives"] = tuple(float(d[k]) for k in _DERIV_KEYS)
    if "simMode" in d:
        kw["sim_mode"] = int(d["simMode"])
    if "trajectory_path" in d and not os.path.isabs(d["trajectory_path"]):
        kw["trajectory_path"] = os.path.join(REPO_ROOT, "data", d["trajectory_path"])
    return SimConfig(**kw)


def load_mpc_config(path: str) -> MPCConfig:
    """Load a reference-format MPC_params.yaml."""
    d = _load_yaml(path)
    fields = {f.name for f in dataclasses.fields(MPCConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    if "stds" in d:
        kw["stds"] = tuple(float(s) for s in d["stds"])
    return MPCConfig(**kw)


def load_vehicle_params(config_path: str, rel_file: str) -> VehicleParams:
    return vehicle_params_from_dict(_load_yaml(os.path.join(config_path, rel_file)))


def load_tire_params(config_path: str, rel_file: str) -> TireParams:
    return tire_params_from_dict(_load_yaml(os.path.join(config_path, rel_file)))


def load_gg_table(config_path: str, rel_file: str):
    """velocity-indexed (vel, ax_max, ax_min, ay_max) arrays from ggv.csv."""
    raw = np.genfromtxt(os.path.join(config_path, rel_file), delimiter=",", skip_header=1)
    return raw[:, 0].copy(), raw[:, 1].copy(), raw[:, 2].copy(), raw[:, 3].copy()
