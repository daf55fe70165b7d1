"""Regenerate ACC24-style evaluation artifacts from full_logs.npz runs (port
of scripts/acc24_figures.py):

    python -m tum_control_tpu_torch.scripts.acc24_figures [RUN_DIR ...] [--out OUT_DIR]
        [--device cuda|cpu]

The counterpart of the reference's Papers_Plots/ACC24_SNMPC scripts: from
any run directories holding full_logs.npz (written by the port's `main`,
eval/logger.py, or by the JAX package; the layouts match) it writes the
solver-runtime table solver_time_experiments.csv, SimResBoxplots.png and
gg_diagrams.png, and, independent of the runs, Monteblanco_Layout.png and
Uncertainty_Propagation.png into OUT_DIR (default Logs/acc24_figures).

Only the uncertainty propagation runs the controller: the SNMPC's fanned
initial state (`_fan`) stepped 14 times through its stacked discrete
dynamics (`dyn_step`, plain PyTorch RK4 in both packages: no kernel) at
an uncertainty horizon of 8, on `--device` (cuda by default: without a
card the run raises unless `--device cpu` is given). `propagate` returns
the (15, n_samples + 1, 8) samples and needs no matplotlib; matplotlib is
imported only inside the plotting functions (eval/plots.py::pyplot).
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from tum_control_tpu_torch.config import DEFAULT_TRAJECTORY_PATH
from tum_control_tpu_torch.eval.plots import pyplot

N_STEPS = 14   # propagation steps of the figure
UPH = 8        # its uncertainty propagation horizon
CHANNEL = 5    # yaw rate: the disturbed state with the most visible spread


def load_runs(run_dirs):
    runs = {}
    for d in run_dirs:
        path = os.path.join(d, "full_logs.npz")
        if os.path.exists(path):
            runs[os.path.basename(os.path.normpath(d))] = dict(np.load(path))
    return runs


def runtimes_table(runs, out_path):
    """solver_time_experiments.csv analog (generate_runtimes.py:47-85)."""
    rows = ["run,mean_ms,max_ms,p99_ms,ok_frac"]
    for name, logs in runs.items():
        t = logs["simSolverDebug"][:, 1] * 1e3
        ok = (logs["simSolverDebug"][:, 4] == 0).mean()
        rows.append(
            f"{name},{t.mean():.3f},{t.max():.3f},{np.percentile(t, 99):.3f},{ok:.4f}"
        )
    with open(out_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")


def deviation_boxplots(runs, out_path):
    plt = pyplot()
    fig, axs = plt.subplots(1, 3, figsize=(4 + 2 * len(runs), 4.5))
    names = list(runs)
    for ax, key, title in zip(axs, ["dev_lat", "dev_vel", "dev_yaw"],
                              ["lateral dev [m]", "velocity dev [m/s]", "yaw dev [rad]"]):
        ax.boxplot([np.abs(runs[n][key]) for n in names], tick_labels=names, showfliers=False)
        ax.set_title(title)
        ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def gg_diagrams(runs, out_path):
    plt = pyplot()
    fig, axs = plt.subplots(1, len(runs), figsize=(5 * len(runs), 4.5), squeeze=False)
    for ax, (name, logs) in zip(axs[0], runs.items()):
        ax.scatter(logs["a_lat"][1:], logs["MPC_SimX"][1:, 7], s=1.5, c=logs["t"],
                   cmap="viridis")
        ax.set_title(name)
        ax.set_xlabel("a_lat [m/s2]")
        ax.set_ylabel("a_lon [m/s2]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def track_layout(out_path, track_file="track_monteblanco.json",
                 ref_file="reftraj_monteblanco_edgar.json"):
    """Track layout figure (Monteblanco_Layoutplot.py analog): boundaries and
    the reference line colored by speed, rotated so that the start heading
    is horizontal, with a start marker and a direction arrow."""
    plt = pyplot()
    with open(os.path.join(DEFAULT_TRAJECTORY_PATH, track_file)) as fh:
        trk = json.load(fh)
    with open(os.path.join(DEFAULT_TRAJECTORY_PATH, ref_file)) as fh:
        ref = json.load(fh)

    ang = -float(np.asarray(ref["ref_yaw"])[0]) + np.pi
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])

    def rot(x, y):
        p = R @ np.stack([np.asarray(x), np.asarray(y)])
        return p[0], p[1]

    fig, ax = plt.subplots(figsize=(10, 6))
    for xs, ys in ((trk["X_i"], trk["Y_i"]), (trk["X_o"], trk["Y_o"])):
        ax.plot(*rot(xs, ys), "k-", lw=0.8)
    rx, ry = rot(ref["pos_x"], ref["pos_y"])
    sc = ax.scatter(rx, ry, c=np.asarray(ref["ref_v"]), s=2.0, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="ref. velocity [m/s]")
    ax.plot(rx[0], ry[0], "r*", ms=14, label="start")
    k = min(25, len(rx) - 1)
    ax.annotate("", xy=(rx[k], ry[k]), xytext=(rx[0], ry[0]),
                arrowprops=dict(arrowstyle="-|>", color="r", lw=2))
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def propagate(device=None, dtype=torch.float32):
    """The SNMPC's fan of x0 = [0, 0, 0, 22, 0, 0, 0.04, 0.3] stepped N_STEPS
    times with u = [0, 0.05] through its stacked dynamics at UPH: returns
    numpy (N_STEPS + 1, n_samples + 1, 8) samples (row 0 the nominal copy)
    and the MPCConfig and SimConfig. The JAX dynamics take the stage index
    k; the port's take a node axis, whose first UPH nodes propagate the
    samples and the rest freeze them: step k is node k of a stack of N_STEPS
    copies of the state."""
    from tum_control_tpu_torch.api import build_controller
    from tum_control_tpu_torch.config import MPCConfig, SimConfig

    mpc_cfg = MPCConfig(controller="snmpc", uncertainty_propagation_horizon=UPH)
    sim_cfg = SimConfig()
    ctrl = build_controller(mpc_cfg, sim_cfg, device=device, dtype=dtype)
    dev = ctrl.engine.W.device
    x0 = torch.tensor([[0.0, 0.0, 0.0, 22.0, 0.0, 0.0, 0.04, 0.3]], dtype=dtype, device=dev)
    u = torch.tensor([0.0, 0.05], dtype=dtype, device=dev).expand(N_STEPS, 2)
    xk = ctrl._fan(x0)[0]
    traj = [xk]
    for k in range(N_STEPS):
        xk = ctrl.dyn_step(xk.expand(N_STEPS, xk.shape[0]), u)[k]
        traj.append(xk)
    samples = torch.stack(traj).reshape(N_STEPS + 1, -1, 8)
    return samples.double().cpu().numpy(), mpc_cfg, sim_cfg


def uncertainty_propagation_figure(samples, mpc_cfg, sim_cfg, out_path):
    """SNMPC uncertainty-propagation illustration
    (generate_uncertainty_propagation_plots.py analog) from propagated PCE
    samples (`propagate`): sample spread, PCE mean, the mean + kappa sigma
    chance-constraint surrogate and the UPH freeze on the yaw-rate channel."""
    plt = pyplot()
    n_steps = samples.shape[0] - 1
    t = np.arange(n_steps + 1) * sim_cfg.Ts_MPC
    uph = mpc_cfg.uncertainty_propagation_horizon
    kappa = float(np.sqrt((1 - mpc_cfg.gamma) / mpc_cfg.gamma))

    fig, ax = plt.subplots(figsize=(9, 5))
    for s in range(1, samples.shape[1]):
        ax.plot(t, samples[:, s, CHANNEL], color="0.65", lw=0.8,
                label="PCE samples" if s == 1 else None)
    mean = samples[:, 0, CHANNEL]
    std = samples[:, 1:, CHANNEL].std(axis=1)
    ax.plot(t, mean, "b-", lw=2, label="nominal (PCE mean)")
    ax.fill_between(t, mean - kappa * std, mean + kappa * std, color="b", alpha=0.15,
                    label=r"mean $\pm\,\kappa\sigma$ surrogate")
    ax.axvline(uph * sim_cfg.Ts_MPC, color="r", ls="--",
               label=f"UPH (samples freeze), node {uph}")
    ax.set_xlabel("prediction time [s]")
    ax.set_ylabel("yaw rate [rad/s]")
    ax.legend(loc="best", fontsize=9)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dirs", nargs="*", default=[])
    ap.add_argument("--out", default="Logs/acc24_figures")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None, dtype=torch.float32):
    """Returns dict(out, runs (their names), samples, files written)."""
    from tum_control_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    samples, mpc_cfg, sim_cfg = propagate(device, dtype)
    os.makedirs(args.out, exist_ok=True)
    runs = load_runs(args.run_dirs)
    files = []
    if runs:
        files += ["solver_time_experiments.csv", "SimResBoxplots.png", "gg_diagrams.png"]
        runtimes_table(runs, os.path.join(args.out, files[-3]))
        deviation_boxplots(runs, os.path.join(args.out, files[-2]))
        gg_diagrams(runs, os.path.join(args.out, files[-1]))
    files += ["Monteblanco_Layout.png", "Uncertainty_Propagation.png"]
    track_layout(os.path.join(args.out, files[-2]))
    uncertainty_propagation_figure(samples, mpc_cfg, sim_cfg, os.path.join(args.out, files[-1]))
    print(f"wrote artifacts ({len(runs)} runs) to {args.out}")
    return dict(out=args.out, runs=list(runs), samples=samples, files=files)


if __name__ == "__main__":
    main(sys.argv[1:])
