"""Safe-RL WMPC training on the GPU (the port's counterpart of the root
rl_training.py):

    python -m tum_control_tpu_torch.rl_training [--updates 180] [--n-envs 16]
        [--tracks monteblanco modena] [--out data/wmpc_models/<id>]
        [--device cuda|cpu] [--smoke] [--cont DIR] [--actions data/F.csv]

Trains a PPO policy that periodically selects NMPC cost-weight sets (the
Pareto table data/F.csv) to minimize closed-loop tracking deviations; the
batched closed loops of the env rollouts run on `--device` (cuda by
default: without a card the run raises unless `--device cpu` is given).
Writes policy_weights.npz (final), best_model/ (best by evaluation reward),
evaluations.npz and rl_config.yaml into `--out`.
"""
import argparse
import os
import shutil

import yaml

from tum_control_tpu_torch import config as cfg_mod
from tum_control_tpu_torch.api import build_simulation
from tum_control_tpu_torch.config import MPCConfig, SimConfig
from tum_control_tpu_torch.device import resolve_device
from tum_control_tpu_torch.learn.env import RLEnv, RLEnvConfig
from tum_control_tpu_torch.learn.observation import ObservationConfig
from tum_control_tpu_torch.learn.policy import load_sb3_policy, save_policy_npz
from tum_control_tpu_torch.learn.ppo import EvalCallback, PPOConfig, PPOTrainer
from tum_control_tpu_torch.learn.wmpc import load_param_table
from tum_control_tpu_torch.track.trajectory import load_ref_trajectory, stack_trajectories


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=None,
                    help="PPO updates (default: from total steps)")
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--tracks", nargs="+", default=["monteblanco", "modena"])
    ap.add_argument("--out", default="data/wmpc_models/torch_ppo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--smoke", action="store_true", help="tiny sizes, 2 updates")
    ap.add_argument("--cont", dest="cont", default=None, metavar="DIR",
                    help="continue training from DIR/policy_weights.npz")
    ap.add_argument("--actions", default="data/F.csv", help="Pareto action catalog CSV")
    ap.add_argument("--eval-freq", type=int, default=5,
                    help="updates between EvalCallback evaluations")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    sim_cfg = SimConfig(sim_mode=0)
    sim, *_ = build_simulation(sim_cfg, MPCConfig(), device=device)
    dtype = sim.controller.engine.W.dtype
    stacked = stack_trajectories([
        load_ref_trajectory(os.path.join(sim_cfg.trajectory_path, f"reftraj_{t}_edgar.json"),
                            dtype=dtype, device=device)
        for t in args.tracks
    ])
    actions_path = (args.actions if os.path.isabs(args.actions)
                    else os.path.join(cfg_mod.REPO_ROOT, args.actions))
    table = load_param_table(actions_path)
    print(f"action catalog: {args.actions} ({len(table)} sets)")

    env_cfg = RLEnvConfig(n_mpc_steps=5 if args.smoke else 20)
    env = RLEnv(sim, stacked, table, ObservationConfig(Ts=sim_cfg.Ts), env_cfg)
    ppo_cfg = PPOConfig(
        n_envs=2 if args.smoke else args.n_envs,
        n_steps=4 if args.smoke else 512,
        batch_size=8 if args.smoke else 4096,
        n_epochs=2 if args.smoke else 5,
    )
    trainer = PPOTrainer(env, ppo_cfg, seed=args.seed)
    if args.cont:
        cont_path = os.path.join(args.cont, "policy_weights.npz")
        trainer.policy = load_sb3_policy(cont_path, device=device,
                                         dtype=dtype).requires_grad_(True)
        print(f"continuing from {cont_path}")
    n_updates = args.updates or (
        2 if args.smoke else max(ppo_cfg.total_steps // (ppo_cfg.n_envs * ppo_cfg.n_steps), 1))
    os.makedirs(args.out, exist_ok=True)
    callback = EvalCallback(trainer, args.out, eval_freq=1 if args.smoke else args.eval_freq,
                            n_envs=2 if args.smoke else None, n_steps=4 if args.smoke else None)
    print(f"training: {n_updates} updates x {ppo_cfg.n_envs} envs x {ppo_cfg.n_steps} steps "
          f"on {device}")
    trainer.train(n_updates, seed=args.seed, callback=callback)
    callback.finalize(trainer.policy)

    save_policy_npz(trainer.policy, os.path.join(args.out, "policy_weights.npz"))
    # provenance config; WMPC inference reads actions_file from here
    with open(os.path.join(args.out, "rl_config.yaml"), "w") as fh:
        yaml.safe_dump({
            "actions_file": args.actions,
            "obs_n_anticipation_points": 10,
            "n_obs_stack": 1,
            "n_mpc_steps": env_cfg.n_mpc_steps,
            "tracks": list(args.tracks),
            "updates": int(n_updates),
            "n_envs": int(ppo_cfg.n_envs),
            "seed": int(args.seed),
        }, fh)
    if os.path.exists(os.path.join(args.out, "best_model", "policy_weights.npz")):
        shutil.copy(os.path.join(args.out, "rl_config.yaml"),
                    os.path.join(args.out, "best_model", "rl_config.yaml"))
    print(f"saved final policy to {args.out}/policy_weights.npz; "
          f"best eval reward {callback.best:.4f} -> {args.out}/best_model/")


if __name__ == "__main__":
    main()
