"""Log assembly / evaluation / npz export, log-compatible with the reference
(port of tum_control_tpu/eval/logger.py).

The closed loop returns every per-step slice as a `SimLog` of (B, n, ...)
tensors; this module assembles one scenario's host-side into the reference
Logger's `full_logs.npz` names and shapes (Utils/Logging_Plotting.py:282)
and computes the same evaluation metrics (:231-303: timing stats,
dev_vel/dev_yaw/dev_lat by ego-frame rotation, yaw wrapped to [0, 2pi)).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch


def _wrap_yaw(y):
    return np.mod(y, 2.0 * np.pi)


def _host(a, scenario=None):
    """A tensor or array as a numpy array, at `scenario` of its first axis."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a if scenario is None else a[scenario]


def lon_lat_deviations(ego_yaw, ego_x, ego_y, ref_x, ref_y):
    """Ego-frame rotation of the deviation vector (MPC_sim_utils.py:102-112)."""
    c, s = np.cos(-ego_yaw), np.sin(-ego_yaw)
    dev_long = c * (ref_x - ego_x) - s * (ref_y - ego_y)
    dev_lat = s * (ref_x - ego_x) + c * (ref_y - ego_y)
    return dev_long, dev_lat


def assemble_logs(sim_log, x0_mpc, x0_sim, T: float, step_times=None, scenario=None) -> dict:
    """One scenario's SimLog -> reference-named numpy arrays.

    `sim_log` holds one scenario, every field (n, ...) (a batched log indexed
    at its scenario, or the host buffers of `main.run_main`), with x0_mpc
    (8,) and x0_sim (7,); or, with `scenario` given, the batched (B, n, ...)
    log of `ClosedLoopSim.run` with x0_mpc (B, 8) and x0_sim (B, 7), each
    taken at that scenario. Fields may be tensors on any device or numpy
    arrays.

    `step_times` (seconds, shape (n,) or broadcastable) fills
    simSolverDebug[:, 1], where the reference stores acados' per-solve
    `time_tot` (NMPC_class.py:202-206); the entry points measure chunked
    wall time and merge it here."""
    g = lambda a: _host(a, scenario)
    Nsim = g(sim_log.simU).shape[0]

    MPC_SimX = np.concatenate([g(x0_mpc)[None], g(sim_log.MPC_SimX)], axis=0)
    CiLX = np.concatenate([g(x0_sim)[None], g(sim_log.CiLX)], axis=0)
    DisturbedX = np.concatenate([g(x0_sim)[None], g(sim_log.DisturbedX)], axis=0)
    simREF = g(sim_log.simREF)

    # evaluation post-processing (Logging_Plotting.py:255-264)
    CiLX[:, 2] = _wrap_yaw(CiLX[:, 2])
    MPC_SimX[:, 2] = _wrap_yaw(MPC_SimX[:, 2])
    DisturbedX[:, 2] = _wrap_yaw(DisturbedX[:, 2])
    vel = CiLX[:, 3]
    dev_vel = np.abs(vel[1:] - simREF[:, 3])
    dev_yaw = np.abs(CiLX[1:, 2] - simREF[:, 2])
    dev_long, dev_lat = lon_lat_deviations(
        CiLX[1:, 2], CiLX[1:, 0], CiLX[1:, 1], simREF[:, 0], simREF[:, 1]
    )
    a_lat = CiLX[:, 3] * CiLX[:, 5]

    dbg = g(sim_log.simSolverDebug).copy()
    if step_times is not None:
        dbg[:, 1] = np.broadcast_to(np.asarray(step_times), (Nsim,))

    out = {
        "MPC_SimX": MPC_SimX,
        "CiLX": CiLX,
        "simU": g(sim_log.simU),
        "simREF": simREF,
        "simSolverDebug": dbg,
        "sim_disturbance_derivatives": g(sim_log.dist_deriv),
        "sim_disturbance_state_estimation": g(sim_log.dist_se),
        "a_lat": a_lat,
        "dev_lat": dev_lat,
        "dev_long": dev_long,
        "dev_vel": dev_vel,
        "dev_yaw": dev_yaw,
        "t": np.linspace(0.0, T, Nsim),
        "DisturbedX": DisturbedX,  # extra vs reference npz (harmless)
    }
    # WMPC action trace (valid iff a weights-varying policy ran)
    act = g(sim_log.wmpc_action)
    if (act >= 0).any():
        out["RL_actions"] = act
    return out


def save_logs(logs: dict, filepath: str) -> None:
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    np.savez(filepath, **logs)


def evaluation(
    logs: dict,
    logs_path: str = "Logs/",
    run_name: str = "run",
    save: bool = True,
    make_plots: bool = True,
    wall_time: float = None,
    timestamp: bool = True,
    wmpc_sets=None,
) -> dict:
    """Print run statistics, save full_logs.npz, generate plots (which need
    matplotlib: eval/plots.py raises without it).

    Returns summary scalars (also useful for tests/benchmarks).
    """
    dbg = logs["simSolverDebug"]
    vel = logs["CiLX"][:, 3]
    summary = {
        "avg_speed": float(np.mean(vel)),
        "dev_lat_mean": float(np.mean(np.abs(logs["dev_lat"]))),
        "dev_lat_max": float(np.max(np.abs(logs["dev_lat"]))),
        "dev_vel_mean": float(np.mean(np.abs(logs["dev_vel"]))),
        "dev_yaw_mean": float(np.mean(np.abs(logs["dev_yaw"]))),
        "solver_ok_frac": float(np.mean(dbg[:, 4] == 0)),
        "cost_mean": float(np.mean(dbg[:, 0])),
    }
    if wall_time is not None:
        n = dbg.shape[0]
        print(f"Time needed for simulation: {wall_time}")
        print(f"Average Time needed per iteration: {wall_time / n}")
    print(f"Average speed: {summary['avg_speed']:.3f} m/s")
    print(
        "dev_lat mean/max: {dev_lat_mean:.4f}/{dev_lat_max:.4f} m  "
        "dev_vel mean: {dev_vel_mean:.4f} m/s  solver ok: {solver_ok_frac:.4f}".format(
            **summary
        )
    )

    if save:
        name = run_name
        if timestamp:
            name += datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        run_dir = os.path.join(logs_path, name)
        os.makedirs(run_dir, exist_ok=True)
        # WMPC trace goes to its own file, as in the reference
        # (Logging_Plotting.py:284-287: t, RL_actions, WMPC_sets)
        main_logs = {k: v for k, v in logs.items() if k != "RL_actions"}
        if "RL_actions" in logs:
            wmpc = {"t": logs["t"], "RL_actions": logs["RL_actions"]}
            if wmpc_sets is not None:
                wmpc["WMPC_sets"] = _host(wmpc_sets)
            np.savez(os.path.join(run_dir, "RL_WMPC_logs.npz"), **wmpc)
        save_logs(main_logs, os.path.join(run_dir, "full_logs.npz"))
        if make_plots:
            from tum_control_tpu_torch.eval import plots

            plots.plot_all(logs, run_dir)
    return summary
