"""Offline result plots, mirroring the reference's evaluation figures
(Utils/MPC_sim_utils.py:490-776: plotRes result grid, BoxPlots deviation
boxplots, plotMPCperf solver KPIs, plotTrackSim track heatmap); port of
tum_control_tpu/eval/plots.py.

Host-side matplotlib on assembled log dicts (numpy in, PNG out), in the
TUM palette of utils/colors.py; every figure is saved headless (Agg) into
the run directory. matplotlib is
imported by the drawing functions only, so that the package imports where
it is not installed (as on a machine that runs only the closed loop).
"""
from __future__ import annotations

import os

import numpy as np

from tum_control_tpu_torch.utils.colors import BLACK, PALETTE, TUM_BLUE, TUM_ORANGE


def pyplot(show: bool = False):
    """matplotlib.pyplot, on the headless Agg backend unless `show`; raises
    ImportError when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plots need matplotlib, which is not installed; run without plots "
                          "(main: --no-plots)") from exc
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_results_grid(logs, path):
    """3x3 grid: trajectory, velocity, yaw, controls, accelerations, devs."""
    plt = pyplot()
    t = logs["t"]
    CiLX, REF, U = logs["CiLX"], logs["simREF"], logs["simU"]
    fig, axs = plt.subplots(3, 3, figsize=(16, 10))
    axs[0, 0].plot(REF[:, 0], REF[:, 1], "--", color=BLACK, lw=0.8, label="ref")
    axs[0, 0].plot(CiLX[:, 0], CiLX[:, 1], color=TUM_BLUE, lw=0.8, label="sim")
    axs[0, 0].set_title("trajectory")
    axs[0, 0].legend()
    axs[0, 1].plot(t, REF[:, 3], "--", color=BLACK, label="ref_v")
    axs[0, 1].plot(t, CiLX[1:, 3], color=TUM_BLUE, label="v")
    axs[0, 1].set_title("velocity [m/s]")
    axs[0, 2].plot(t, REF[:, 2], "--", color=BLACK)
    axs[0, 2].plot(t, CiLX[1:, 2], color=TUM_BLUE)
    axs[0, 2].set_title("yaw [rad]")
    axs[1, 0].plot(t, U[:, 0])
    axs[1, 0].set_title("jerk [m/s3]")
    axs[1, 1].plot(t, U[:, 1])
    axs[1, 1].set_title("steering rate [rad/s]")
    axs[1, 2].plot(t, logs["MPC_SimX"][1:, 7])
    axs[1, 2].set_title("acceleration [m/s2]")
    axs[2, 0].plot(t, logs["dev_lat"])
    axs[2, 0].set_title("lateral deviation [m]")
    axs[2, 1].plot(t, logs["dev_vel"])
    axs[2, 1].set_title("velocity deviation [m/s]")
    axs[2, 2].plot(t, logs["a_lat"][1:])
    axs[2, 2].set_title("lateral acceleration [m/s2]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_boxplots(logs, path):
    plt = pyplot()
    fig, axs = plt.subplots(1, 3, figsize=(9, 4))
    for ax, key, title in zip(
        axs, ["dev_vel", "dev_yaw", "dev_lat"], ["vel dev", "yaw dev", "lat dev"]
    ):
        ax.boxplot(np.abs(logs[key]))
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_mpc_perf(logs, path):
    """Solver KPI time series + track-position heatmaps of cost / time /
    QP iterations (the reference's plotMPCperf, MPC_sim_utils.py:666-776)."""
    plt = pyplot()
    t, dbg = logs["t"], logs["simSolverDebug"]
    X = logs["CiLX"][1:]
    fig, axs = plt.subplots(2, 3, figsize=(15, 8))
    axs[0, 0].plot(t, dbg[:, 0])
    axs[0, 0].set_title("cost")
    axs[0, 1].plot(t, dbg[:, 1] * 1e3)
    axs[0, 1].set_title("solve time [ms]")
    axs[0, 2].plot(t, dbg[:, 3], color=TUM_BLUE, label="QP iter")
    axs[0, 2].plot(t, dbg[:, 4], color=TUM_ORANGE, label="status")
    axs[0, 2].set_title("QP iterations / status")
    axs[0, 2].legend()
    for ax, col, title in zip(
        axs[1], [0, 1, 3], ["cost over track", "time over track", "QP iter over track"]
    ):
        sc = ax.scatter(X[:, 0], X[:, 1], c=dbg[:, col], s=3, cmap="plasma")
        fig.colorbar(sc, ax=ax)
        ax.set_aspect("equal")
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_gg_diagram(logs, path, ax_limits=(-4.5, 3.0), ay_limit=5.886):
    """Combined-acceleration scatter inside the gg envelope (the reference's
    live-viz mode-2 gg panel, MPC_sim_utils.py:268-412, and the ACC24 gg
    figures, Papers_Plots/ACC24_SNMPC/generate_gg.py)."""
    plt = pyplot()
    a_lon = logs["MPC_SimX"][1:, 7]
    a_lat = logs["a_lat"][1:]
    v = logs["CiLX"][1:, 3]
    fig, ax = plt.subplots(figsize=(7, 7))
    th = np.linspace(0, 2 * np.pi, 200)
    # circle-shape envelope (combined_acc_limits=2): ellipse ay x (asymmetric ax)
    ax.plot(
        ay_limit * np.cos(th),
        np.where(np.sin(th) >= 0, ax_limits[1], -ax_limits[0]) * np.sin(th),
        "k--",
        lw=1.0,
        label="gg envelope",
    )
    sc = ax.scatter(a_lat, a_lon, c=v, s=4, cmap="viridis")
    fig.colorbar(sc, label="v [m/s]")
    ax.set_xlabel("a_lat [m/s2]")
    ax.set_ylabel("a_lon [m/s2]")
    ax.set_title("gg diagram")
    ax.legend()
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_state_errors(logs, path):
    """Per-state |MPC node-1 prediction - plant| traces (the reference's
    plotSimulatedStateErrors, MPC_sim_utils.py:851-872)."""
    plt = pyplot()
    t = logs["t"]
    pred = logs["MPC_SimX"][1:, :7]
    plant = logs["CiLX"][1:, :7]
    names = ["posx", "posy", "yaw", "vlong", "vlat", "yawrate", "delta_f"]
    fig, axs = plt.subplots(4, 2, figsize=(12, 10), sharex=True)
    for i, (ax, name) in enumerate(zip(axs.ravel(), names)):
        ax.plot(t, np.abs(pred[:, i] - plant[:, i]), lw=0.7)
        ax.set_title(f"|pred - plant| {name}")
    axs.ravel()[-1].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_track_sim(logs, path, track=None):
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(9, 8))
    if track is not None:
        ax.plot(track.center[:, 0], track.center[:, 1], "k--", lw=0.5)
        ax.plot(track.inner[:, 0], track.inner[:, 1], "k", lw=0.8)
        ax.plot(track.outer[:, 0], track.outer[:, 1], "k", lw=0.8)
    sc = ax.scatter(
        logs["CiLX"][1:, 0], logs["CiLX"][1:, 1], c=np.abs(logs["dev_lat"]), s=3, cmap="viridis"
    )
    fig.colorbar(sc, label="|lat dev| [m]")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_disturbances(logs, path):
    plt = pyplot()
    t = logs["t"]
    fig, axs = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    for ax in axs:
        ax.set_prop_cycle(color=PALETTE)
    axs[0].plot(t, logs["sim_disturbance_derivatives"])
    axs[0].set_title("state-derivative disturbances")
    axs[1].plot(t, logs["sim_disturbance_state_estimation"])
    axs[1].set_title("state-estimation noise")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_all(logs, run_dir, track=None):
    plot_results_grid(logs, os.path.join(run_dir, "SimResults.png"))
    plot_boxplots(logs, os.path.join(run_dir, "SimResBoxplots.png"))
    plot_mpc_perf(logs, os.path.join(run_dir, "MPC_performance.png"))
    plot_track_sim(logs, os.path.join(run_dir, "TrackSim.png"), track=track)
    plot_gg_diagram(logs, os.path.join(run_dir, "GGDiagram.png"))
    plot_state_errors(logs, os.path.join(run_dir, "StateErrors.png"))
    if np.any(logs["sim_disturbance_derivatives"]) or np.any(
        logs["sim_disturbance_state_estimation"]
    ):
        plot_disturbances(logs, os.path.join(run_dir, "Disturbances.png"))
