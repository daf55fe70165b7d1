"""PPO for Safe-RL WMPC training, port of tum_control_tpu/learn/ppo.py.

Rollouts step the batched env (each env step runs the batched NMPC closed
loop), then GAE, the clipped surrogate with value and entropy losses, Adam
behind a global-norm clip in optax's operation order (learn/adam.py) with
the reference's exponentially decaying learning rate, minibatched epochs.

Hyperparameter defaults mirror _config/rl_config.yaml (n_steps 512, batch
4096, epochs 5, gamma 0.8, gae_lambda 0.98, clip 0.2, ent_coef 0.006,
vf_coef 0.5, max_grad_norm 0.5, net [128, 256, 128]).

Random draws (actions by the Gumbel-max trick, the minibatch permutation)
come from the trainer's generator on the env's device; the policy's
initial weights from a CPU generator of the same seed.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from tum_control_tpu_torch.learn.adam import adam_init, adam_update, clip_by_global_norm
from tum_control_tpu_torch.learn.policy import init_mlp_policy, save_policy_npz
from tum_control_tpu_torch.sim.closed_loop import make_generator


class PPOConfig(NamedTuple):
    n_envs: int = 16
    n_steps: int = 512
    batch_size: int = 4096
    n_epochs: int = 5
    gamma: float = 0.8
    gae_lambda: float = 0.98
    clip_range: float = 0.2
    ent_coef: float = 0.006
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    lr_init: float = 0.005
    lr_final: float = 0.0001
    lr_decay: float = 0.4          # adaptive_lr_decay (reference helpers.py:88-98)
    total_steps: int = 1_500_000


class EvalCallback:
    """Periodic deterministic evaluation and best-model checkpointing: every
    `eval_freq` updates the current policy is evaluated from the resets of a
    fixed seed; a new best mean reward saves `best_model/policy_weights.npz`
    under `out_dir`, and `evaluations.npz` accumulates the history. Into an
    out dir that holds an `evaluations.npz` (a resumed run) it keeps the
    previous best and history."""

    def __init__(self, trainer, out_dir: str, eval_freq: int = 5, seed: int = 123,
                 n_envs: int = None, n_steps: int = None):
        self.trainer = trainer
        self.out_dir = out_dir
        self.eval_freq = max(1, eval_freq)
        self.seed = seed  # fixed: evaluations are comparable
        self.n_envs, self.n_steps = n_envs, n_steps
        self.best = -np.inf
        self.history = []
        os.makedirs(os.path.join(out_dir, "best_model"), exist_ok=True)
        prev = os.path.join(out_dir, "evaluations.npz")
        if os.path.exists(prev):
            with np.load(prev) as d:
                self.history = list(zip(d["updates"].tolist(), d["mean_reward"].tolist()))
                if self.history:
                    self.best = float(np.max(d["mean_reward"]))
                    print(f"EvalCallback: resuming, previous best {self.best:.4f}")

    def __call__(self, update, policy, metrics):
        if update % self.eval_freq:
            return
        self._evaluate_and_save(update, policy)

    def finalize(self, policy):
        """Evaluate the final policy whatever the eval_freq alignment."""
        last = self.history[-1][0] if self.history else -1
        self._evaluate_and_save(max(last + 1, 0), policy)

    def _evaluate_and_save(self, update, policy):
        r = self.trainer.evaluate(policy, self.seed, self.n_envs, self.n_steps)
        self.history.append((update, r))
        np.savez(os.path.join(self.out_dir, "evaluations.npz"),
                 updates=np.array([h[0] for h in self.history]),
                 mean_reward=np.array([h[1] for h in self.history]))
        marker = ""
        if r > self.best:
            self.best = r
            save_policy_npz(policy, os.path.join(self.out_dir, "best_model", "policy_weights.npz"))
            marker = " (new best, saved)"
        print(f"eval @ update {update}: mean reward {r:.4f}{marker}", flush=True)


class Transition(NamedTuple):
    obs: torch.Tensor     # (..., n_obs)
    action: torch.Tensor  # (...,) int64
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor    # bool


def lr_schedule(cfg: PPOConfig):
    """Reference schedule: lr = init * (final/init)^(progress * k) over the
    run's optimiser steps (helpers.learning_rate_schedule, k =
    adaptive_lr_decay); a function of the update count."""
    n_updates = max(cfg.total_steps // (cfg.n_envs * cfg.n_steps), 1)
    total_opt_steps = n_updates * cfg.n_epochs * max(cfg.n_envs * cfg.n_steps // cfg.batch_size, 1)

    def fn(count):
        progress = torch.clamp(count.to(torch.float64) / total_opt_steps, 0.0, 1.0)
        return cfg.lr_init * (cfg.lr_final / cfg.lr_init) ** (progress * cfg.lr_decay)

    return fn


class PPOTrainer:
    def __init__(self, env, cfg: PPOConfig = PPOConfig(), seed: int = 0):
        self.env = env
        self.cfg = cfg
        self.device, self.dtype = env.device, env.dtype
        self.policy = init_mlp_policy(make_generator(seed, "cpu"), env.n_observations,
                                      env.n_actions, device=self.device, dtype=self.dtype)
        self.key = make_generator(seed, self.device)
        self.opt_state = adam_init(self.policy.parameters())
        self.lr = lr_schedule(cfg)

    # ------------------------------------------------------------------
    def init_envs(self, key: torch.Generator):
        return self.env.reset(self.cfg.n_envs, key)

    def _rollout(self, es, obs):
        cfg, policy = self.cfg, self.policy
        rows = torch.arange(cfg.n_envs, device=self.device)
        steps = []
        for _ in range(cfg.n_steps):
            with torch.no_grad():
                logits = policy.logits(obs)
                u = torch.rand(logits.shape, generator=self.key, device=self.device,
                               dtype=logits.dtype)
                action = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)  # Gumbel-max
                logp = torch.log_softmax(logits, dim=-1)[rows, action]
                value = policy.value(obs)
                es, obs_next, reward, done = self.env.step(es, action)
            steps.append(Transition(obs, action, logp, value, reward, done))
            obs = obs_next
        traj = Transition(*(torch.stack(f) for f in zip(*steps)))   # (n_steps, n_envs, ...)
        with torch.no_grad():
            last_value = policy.value(obs)
        return es, obs, traj, last_value

    def _gae(self, traj: Transition, last_value):
        """(advantages, returns) (n_steps, n_envs) by the reversed GAE
        recursion, nonterminal = 1 - done."""
        cfg = self.cfg
        adv_next, v_next = torch.zeros_like(last_value), last_value
        advs = []
        for t in reversed(range(traj.reward.shape[0])):
            nonterm = 1.0 - traj.done[t].to(traj.value.dtype)
            delta = traj.reward[t] + cfg.gamma * v_next * nonterm - traj.value[t]
            adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
            v_next = traj.value[t]
            advs.append(adv_next)
        advs = torch.stack(advs[::-1])
        return advs, advs + traj.value

    def _loss(self, policy, batch: Transition, adv, ret):
        """(loss, (pg, v_loss, entropy)) of a minibatch; the advantages are
        normalized with the population std (ddof 0, as jnp.std)."""
        cfg = self.cfg
        logits = policy.logits(batch.obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, 1, batch.action[:, None])[:, 0]
        ratio = torch.exp(logp - batch.logp)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1 - cfg.clip_range, 1 + cfg.clip_range)
        pg = -torch.minimum(ratio * adv_n, clipped * adv_n).mean()
        v_loss = torch.mean((policy.value(batch.obs) - ret) ** 2)
        ent = -torch.sum(torch.softmax(logits, dim=-1) * logp_all, dim=1).mean()
        return pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent, (pg, v_loss, ent)

    def _minibatch_update(self, batch: Transition, adv, ret):
        """One clipped Adam step on a minibatch; returns the loss before it."""
        params = list(self.policy.parameters())
        loss, _ = self._loss(self.policy, batch, adv, ret)
        grads = clip_by_global_norm(torch.autograd.grad(loss, params), self.cfg.max_grad_norm)
        updates, self.opt_state = adam_update(grads, self.opt_state, self.lr)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        return loss.detach()

    def _update(self, es, obs):
        cfg = self.cfg
        es, obs, traj, last_value = self._rollout(es, obs)
        advs, rets = self._gae(traj, last_value)
        flat = Transition(*(a.reshape((-1,) + a.shape[2:]) for a in traj))
        advs_f, rets_f = advs.reshape(-1), rets.reshape(-1)
        n = advs_f.shape[0]
        n_mb = max(n // cfg.batch_size, 1)
        epoch_losses = []
        for _ in range(cfg.n_epochs):
            perm = torch.randperm(n, generator=self.key, device=self.device)
            idxs = perm[: n_mb * cfg.batch_size].reshape(n_mb, cfg.batch_size)
            losses = [self._minibatch_update(Transition(*(a[i] for a in flat)), advs_f[i],
                                             rets_f[i]) for i in idxs]
            epoch_losses.append(torch.stack(losses).mean())
        metrics = {
            "loss": torch.stack(epoch_losses).mean(),
            "reward_mean": traj.reward.mean(),
            "episode_done_frac": traj.done.to(traj.reward.dtype).mean(),
        }
        return es, obs, {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, policy, seed: int, n_envs: int = None, n_steps: int = None) -> float:
        """Deterministic-policy evaluation from the resets of a fixed seed:
        mean reward per env step over a fixed horizon."""
        n_envs = n_envs or self.cfg.n_envs
        n_steps = n_steps or min(self.cfg.n_steps, 128)
        es, obs = self.env.reset(n_envs, make_generator(seed, self.device))
        rewards = []
        for _ in range(n_steps):
            es, obs, reward, _ = self.env.step(es, torch.argmax(policy.logits(obs), dim=-1))
            rewards.append(reward)
        return float(torch.stack(rewards).mean())

    def train(self, n_updates: int, seed: int = 1, log_every: int = 1, callback=None):
        """`n_updates` PPO updates from fresh envs (reset draws from `seed`)."""
        es, obs = self.init_envs(make_generator(seed, self.device))
        history = []
        for u in range(n_updates):
            es, obs, m = self._update(es, obs)
            history.append(m)
            if u % log_every == 0:
                print(f"update {u}: {m}", flush=True)
            if callback is not None:
                callback(u, self.policy, m)
        return history
