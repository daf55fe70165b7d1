"""Shared pieces of the tire-identification tools (golden_attribution,
fit_tires_closedloop, fit_tires_es): the ACC24 golden logs and their
chunks, the tire vector as log-multipliers on a base set, the tire YAML
writer, and the closed loop the JAX tools build by hand (no disturbances,
the MPC's vehicle file for plant and controller, the tires on both).

A golden log is a reference-format `full_logs.npz`; the tools read five of
its arrays: CiLX (n+1, 7), MPC_SimX (n+1, 8), simU (n, 2), dev_lat (n,),
dev_vel (n,), the layout `eval/logger.py::save_logs` writes. The ACC24
goldens are not in the repository: every tool takes their paths as options
and raises, naming the file, where one is missing.
"""
from __future__ import annotations

import ast
import os

import numpy as np
import torch
import yaml

from tum_control_tpu_torch.config import (
    DEFAULT_CONFIG_PATH, REPO_ROOT, MPCConfig, SimConfig, load_gg_table, load_tire_params,
    load_vehicle_params,
)
from tum_control_tpu_torch.params import TireParams

EDGAR = os.path.join(DEFAULT_CONFIG_PATH, "EDGAR")
FIT_YAML = os.path.join(EDGAR, "pacejka_params_2023fit.yaml")
BLEND_YAML = os.path.join(EDGAR, "pacejka_params_2023fit_snmpc.yaml")
CL_YAML = os.path.join(EDGAR, "pacejka_params_2023fit_cl.yaml")
SHIPPED = "EDGAR/pacejka_params.yaml"
LOG_DIR = os.path.join(REPO_ROOT, "Logs", "attribution")
TIRE_KEYS = ("Bf", "Cf", "Df", "Ef", "Br", "Cr", "Dr", "Er")
# the SNMPC of the goldens (their run names)
SNMPC = dict(controller="snmpc", uncertainty_propagation_horizon=15)


def jax_golden_paths():
    """(nominal, SNMPC) golden paths the JAX tools read by default: the
    GOLDEN_NOM and GOLDEN_SNM constants of the root tools/fit_tires_es.py
    (the same files as tools/fit_tires_closedloop.py's and
    tools/golden_attribution.py's), read from that script's text, so that
    the port's tools look where the JAX tools look. The SNMPC golden is of
    the same recordings and tires: n_samples = 10, UPH = 15."""
    with open(os.path.join(REPO_ROOT, "tools", "fit_tires_es.py")) as fh:
        body = ast.parse(fh.read()).body
    found = {node.targets[0].id: ast.literal_eval(node.value) for node in body
             if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
             and node.targets[0].id in ("GOLDEN_NOM", "GOLDEN_SNM")}
    return found["GOLDEN_NOM"], found["GOLDEN_SNM"]


def golden_args(ap):
    """--golden and --golden-snmpc; without them, jax_golden_paths()."""
    ap.add_argument("--golden", default=None,
                    help="nominal golden full_logs.npz (default: the JAX tools' ACC24 path)")
    ap.add_argument("--golden-snmpc", default=None,
                    help="SNMPC golden full_logs.npz (default: the JAX tools' ACC24 path)")


def resolve_goldens(args):
    """Fills args.golden and args.golden_snmpc where they were not given."""
    if args.golden is None or args.golden_snmpc is None:
        nom, snm = jax_golden_paths()
        args.golden = args.golden or nom
        args.golden_snmpc = args.golden_snmpc or snm
    return args


def load_golden(path: str, option: str = "--golden") -> dict:
    """The golden log's arrays; raises FileNotFoundError naming the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"golden log {path} not found (the ACC24 golden logs are not in the repository; "
            f"pass another full_logs.npz with {option})")
    with np.load(path) as d:
        return {k: d[k] for k in ("CiLX", "MPC_SimX", "simU", "dev_lat", "dev_vel")}


def read_tire_values(path: str) -> np.ndarray:
    """The 8 Pacejka coefficients of a tire YAML, in TIRE_KEYS order."""
    with open(path) as fh:
        tp = yaml.safe_load(fh)["tire_params"]
    return np.array([tp["front" if k.endswith("f") else "rear"][k] for k in TIRE_KEYS])


def shipped_tires() -> TireParams:
    return load_tire_params(DEFAULT_CONFIG_PATH, SHIPPED)


def log_base(tp: TireParams, dtype, device) -> torch.Tensor:
    """log of tp's 8 Pacejka coefficients, the base of the log-multipliers."""
    return torch.log(torch.tensor(np.array(tp[:8], dtype=np.float64), dtype=dtype,
                                  device=device))


def tires_at(theta, base, mu: float) -> TireParams:
    """exp(base + theta) as TireParams: theta (8,) gives one set of 0-d
    tensors, theta (P, 8) one set per scenario, (P,) tensors."""
    return TireParams(*torch.exp(base + theta).unbind(-1), mu=mu)


def tire_floats(tp: TireParams) -> dict:
    return {k: float(v) for k, v in zip(TIRE_KEYS + ("mu",), tp)}


def tire_yaml(tp: TireParams, header: str) -> str:
    """The tire file's text: the JAX tools' layout and digits."""
    v = tire_floats(tp)
    return (header + "tire_params:\n"
            "  front:\n"
            f"    Bf: {v['Bf']:.6f}\n    Cf: {v['Cf']:.6f}\n"
            f"    Df: {v['Df']:.3f}\n    Ef: {v['Ef']:.6f}\n"
            "  rear:\n"
            f"    Br: {v['Br']:.6f}\n    Cr: {v['Cr']:.6f}\n"
            f"    Dr: {v['Dr']:.3f}\n    Er: {v['Er']:.6f}\n"
            f"mu: {v['mu']:.6f}\n")


def write_tires(path: str, tp: TireParams, header: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(tire_yaml(tp, header))


def golden_chunks(d: dict, n_chunks: int, chunk_len: int, dtype, device):
    """`n_chunks` windows of `chunk_len` steps, evenly spaced over the log:
    each starts from the logged plant state CiLX plus the logged accel state
    MPC_SimX[:, 7] (the 8-state MPC state, as the reference simulator
    rebuilds it), with the golden |dev_lat| over the window. Returns (x0m
    (n_chunks, 8), x0s (n_chunks, 7), |dev_lat| (n_chunks, chunk_len))."""
    n = d["simU"].shape[0]
    starts = np.arange(n_chunks) * (n // n_chunks)
    if starts[-1] + chunk_len > d["dev_lat"].shape[0]:
        raise ValueError(f"{n_chunks} chunks of {chunk_len} steps do not fit a log of {n} steps")
    x0s = d["CiLX"][starts]
    x0m = np.concatenate([x0s, d["MPC_SimX"][starts, 7][:, None]], axis=1)
    g_dev = np.stack([np.abs(d["dev_lat"][s:s + chunk_len]) for s in starts])
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(x0m), t(x0s), t(g_dev)


def fit_simulation(mpc_cfg: MPCConfig, tp: TireParams, device, dtype, T: float = 10.0):
    """The JAX tools' closed loop on Monteblanco (SimConfig(sim_mode=0, T)):
    the controller of `mpc_cfg` and the plant both on the MPC's vehicle file
    and on `tp`, no disturbances. Returns (sim, sim_cfg, traj path)."""
    from tum_control_tpu_torch.controllers.common import GGTables
    from tum_control_tpu_torch.controllers.nominal import NominalNMPC
    from tum_control_tpu_torch.controllers.snmpc import StochasticNMPC
    from tum_control_tpu_torch.sim.closed_loop import ClosedLoopSim
    from tum_control_tpu_torch.sim.disturbances import disturbance_config
    from tum_control_tpu_torch.track.trajectory import load_ref_trajectory

    sim_cfg = SimConfig(sim_mode=0, T=T)
    vp = load_vehicle_params(DEFAULT_CONFIG_PATH, sim_cfg.veh_params_file_MPC)
    gg = GGTables(*load_gg_table(DEFAULT_CONFIG_PATH, MPCConfig().lookuptable_gg_limits),
                  device=device, dtype=dtype)
    traj_path = os.path.join(sim_cfg.trajectory_path, sim_cfg.ref_traj_file)
    traj = load_ref_trajectory(traj_path, dtype=dtype, device=device)
    cls = StochasticNMPC if mpc_cfg.controller == "snmpc" else NominalNMPC
    ctrl = cls(mpc_cfg, sim_cfg.N, sim_cfg.Ts_MPC, vp, tp, gg, device=device, dtype=dtype)
    nodist = disturbance_config("none", np.zeros(7), enabled=False, dtype=dtype, device=device)
    sim = ClosedLoopSim(controller=ctrl, traj=traj, sim_mode=0, Ts=sim_cfg.Ts_sim_step,
                        Tp=sim_cfg.Tp, N=sim_cfg.N, vp_sim=vp, tp_sim=tp, dist_deriv=nodist,
                        dist_se=nodist)
    return sim, sim_cfg, traj_path


def write_golden(path: str, mpc_cfg: MPCConfig, n_steps: int, tire_file: str, device, dtype,
                 start: int = None):
    """A golden log written by the port: one scenario of `mpc_cfg` over
    n_steps on Monteblanco with `tire_file` on plant and controller, no
    disturbances, saved as `full_logs.npz` at `path` (the layout
    eval/logger.py writes): a known tire set for the tools to recover where
    the ACC24 goldens are missing. From the lap's start (initial_state), or
    from lap point `start` in the state parallel/mesh.py::batched_scenarios
    gives it. Returns the arrays."""
    from tum_control_tpu_torch.api import build_simulation
    from tum_control_tpu_torch.eval.logger import assemble_logs, save_logs
    from tum_control_tpu_torch.parallel.mesh import batched_scenarios

    T = n_steps * 0.02
    sim_cfg = SimConfig(sim_mode=0, T=T, tire_params_file_MPC=tire_file,
                        tire_params_file_simulator=tire_file)
    sim, x0m, x0s, traj, _ = build_simulation(sim_cfg, mpc_cfg, device=device, dtype=dtype)
    if start is None:
        x0m, x0s = x0m[None], x0s[None]
    else:
        x0m, x0s = (x[start:start + 1] for x in batched_scenarios(traj, traj.n_points))
    _, log = sim.run(x0m, x0s, n_steps)
    logs = assemble_logs(log, x0m, x0s, T, scenario=0)
    save_logs(logs, path)
    return logs
