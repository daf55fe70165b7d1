"""Policy evaluation: full-lap WMPC rollouts + training-history utilities
(port of tum_control_tpu/learn/evaluation.py).

Equivalent of the reference RL_WMPC/evaluation.py: `run_policy` rolls a
trained policy deterministically over a full lap through the WMPC-wrapped
nominal controller (one scenario) and returns reference-format logs;
`TrainingHistory` replaces the TensorBoard scraping (evaluation.py:22-63)
with the PPO trainer's metric history (saved/loaded as npz). The rollouts
run on `device` (cuda unless named); plots need matplotlib.
"""
from __future__ import annotations

import numpy as np
import torch

from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.eval.logger import assemble_logs
from tum_control_tpu_torch.eval.plots import pyplot


def lap_config(track: str, T: float) -> SimConfig:
    """The closed loop of `run_policy`: one lap of `track` for T seconds."""
    return SimConfig(sim_mode=0, T=T, track_file=f"track_{track}.json",
                     ref_traj_file=f"reftraj_{track}_edgar.json")


def run_policy(model_dir: str, track: str = "monteblanco", T: float = 40.0, seed: int = 0,
               sim_cfg=None, mpc_cfg=None, device=None, dtype=torch.float32):
    """Deterministic full-lap rollout of a trained WMPC policy.

    Returns (logs dict, summary dict) in the reference full_logs layout."""
    device = resolve_device(device)
    sim_cfg = sim_cfg or lap_config(track, T)
    mpc_cfg = mpc_cfg or MPCConfig(enable_WMPC=True, WMPC_model=model_dir)
    sim, x0m, x0s, traj, _ = build_simulation(sim_cfg, mpc_cfg, device=device, dtype=dtype)
    _, log = sim.run(x0m[None], x0s[None], sim_cfg.Nsim, key=seed)
    logs = assemble_logs(log, x0m[None], x0s[None], sim_cfg.T, scenario=0)
    summary = {
        "dev_lat_rms": float(np.sqrt(np.mean(logs["dev_lat"] ** 2))),
        "dev_vel_rms": float(np.sqrt(np.mean(logs["dev_vel"] ** 2))),
        "dev_lat_max": float(np.max(np.abs(logs["dev_lat"]))),
        "solver_ok_frac": float(np.mean(logs["simSolverDebug"][:, 4] == 0)),
    }
    return logs, summary


def action_probability_trace(model_dir: str, track: str = "monteblanco", T: float = 40.0,
                             seed: int = 0, plot_path: str = None, device=None,
                             dtype=torch.float32):
    """Policy action-distribution probe over a lap (the reference's
    helpers.get_action_probabilities, helpers.py:88-105, traced through a
    full closed loop): runs the WMPC lap while recording, per control step,
    the softmax action probabilities at the policy's current observation and
    the selected action. Returns numpy (probs (n, n_actions), actions (n,));
    with `plot_path`, saves a probability heatmap + selected-action trace."""
    device = resolve_device(device)
    if plot_path:
        plt = pyplot()  # without matplotlib, raise before the run
    sim_cfg = lap_config(track, T)
    mpc_cfg = MPCConfig(enable_WMPC=True, WMPC_model=model_dir)
    sim, x0m, x0s, traj, _ = build_simulation(sim_cfg, mpc_cfg, device=device, dtype=dtype)
    policy = sim.controller.policy
    n = sim_cfg.Nsim

    carry = sim.init_carry(x0m[None], x0s[None], key=seed)
    zero = torch.zeros_like(carry.x_sim)
    probs, actions, lat = [], [], []
    for _ in range(n):
        carry, log = sim.step(carry, zero, zero)
        probs.append(policy.action_probabilities(carry.extra.obs)[0])
        actions.append(carry.extra.action[0])
        lat.append(log.lat_dev[0])
    probs = torch.stack(probs).detach().cpu().numpy()
    actions = torch.stack(actions).cpu().numpy()

    if plot_path:
        lat = torch.stack(lat).cpu().numpy()
        t = np.arange(n) * 0.02
        fig, axs = plt.subplots(2, 1, figsize=(11, 7), sharex=True,
                                gridspec_kw={"height_ratios": [3, 1]})
        im = axs[0].imshow(
            probs.T, aspect="auto", origin="lower", cmap="viridis",
            extent=[t[0], t[-1], -0.5, probs.shape[1] - 0.5],
        )
        axs[0].plot(t, actions, "r-", lw=0.8, label="selected action")
        axs[0].set_ylabel("action (parameter set index)")
        axs[0].legend(loc="upper right")
        fig.colorbar(im, ax=axs[0], label="P(action | obs)")
        axs[1].plot(t, np.abs(lat), "k-", lw=0.8)
        axs[1].set_ylabel("|lat_dev| [m]")
        axs[1].set_xlabel("t [s]")
        fig.suptitle(f"WMPC policy action probabilities over {track} ({model_dir})")
        fig.tight_layout()
        fig.savefig(plot_path, dpi=110)
        plt.close(fig)
    return probs, actions


class TrainingHistory:
    """Store / reload PPO training metrics (TensorBoard-scrape replacement)."""

    def __init__(self, history=None):
        self.history = history or []

    def save(self, path: str):
        keys = sorted(self.history[0]) if self.history else []
        arrs = {k: np.asarray([h[k] for h in self.history]) for k in keys}
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "TrainingHistory":
        d = np.load(path)
        n = len(d[d.files[0]]) if d.files else 0
        return cls([{k: float(d[k][i]) for k in d.files} for i in range(n)])

    def plot(self, path: str):
        plt = pyplot()
        keys = sorted(self.history[0]) if self.history else []
        fig, axs = plt.subplots(1, max(len(keys), 1), figsize=(5 * max(len(keys), 1), 4))
        if len(keys) == 1:
            axs = [axs]
        for ax, k in zip(np.atleast_1d(axs), keys):
            ax.plot([h[k] for h in self.history])
            ax.set_title(k)
            ax.set_xlabel("update")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
