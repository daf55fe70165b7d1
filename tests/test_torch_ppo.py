"""The port's PPO pieces against the JAX package's on the CPU in float64:
GAE, the clipped-surrogate loss and its gradient on a fixed batch, clipped
Adam minibatch updates and the learning-rate schedule against optax, the
EvalCallback's best-model and resume logic, the policy npz layout both ways
between the packages, and the training entry module at its smoke size.

Both sides compute the same float64 operations (JAX under x64); losses,
gradients and updated parameters are held to 1e-12 relative to their
scale (measured: ~1e-16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tum_control_tpu.learn.policy import (
    init_mlp_policy as j_init, load_sb3_policy as j_load, save_policy_npz as j_save,
)
from tum_control_tpu.learn.ppo import (
    PPOConfig as JPPOConfig, PPOTrainer as JPPOTrainer, Transition as JTransition,
    lr_schedule as j_lr_schedule,
)
from tum_control_tpu_torch.learn.policy import (
    init_mlp_policy, load_sb3_policy, policy_arrays, policy_from_arrays, save_policy_npz,
)
from tum_control_tpu_torch.learn.ppo import (
    EvalCallback, PPOConfig, PPOTrainer, Transition, lr_schedule,
)
from tum_control_tpu_torch.sim.closed_loop import make_generator


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast alone and keeps the
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OBS, ACT, BATCH = 22, 26, 64
RTOL = 1e-12


class _FakeEnv:
    """What the trainers read of an env before a rollout."""
    n_observations, n_actions = OBS, ACT
    device, dtype = torch.device("cpu"), torch.float64


def _trainers(**cfg):
    return JPPOTrainer(_FakeEnv(), JPPOConfig(**cfg)), PPOTrainer(_FakeEnv(), PPOConfig(**cfg))


def _policies(seed=0):
    """A JAX policy and the port's copy of it, through the npz layout."""
    jp = j_init(jax.random.PRNGKey(seed), OBS, ACT)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    tp = policy_from_arrays(_jax_as_arrays(jp), device="cpu",
                            dtype=torch.float64).requires_grad_(True)
    return jp, tp


def _jax_as_arrays(jp):
    """A JAX policy (or its gradient) in the port's npz layout."""
    out = {}
    for prefix, ws, bs in (("policy_net", jp.pi_w, jp.pi_b), ("value_net", jp.vf_w, jp.vf_b)):
        for i, (w, b) in enumerate(zip(ws, bs)):
            out[f"mlp_extractor__{prefix}__{2 * i}__weight"] = np.asarray(w).T
            out[f"mlp_extractor__{prefix}__{2 * i}__bias"] = np.asarray(b)
    out.update(action_net__weight=np.asarray(jp.act_w).T, action_net__bias=np.asarray(jp.act_b),
               value_net__weight=np.asarray(jp.val_w).T, value_net__bias=np.asarray(jp.val_b))
    return out


def _grads_as_arrays(tp, grads):
    names = list(policy_arrays(tp))
    order = [n for prefix in ("policy_net", "value_net") for i in (0, 2, 4)
             for n in (f"mlp_extractor__{prefix}__{i}__weight",
                       f"mlp_extractor__{prefix}__{i}__bias")]
    order += ["action_net__weight", "action_net__bias", "value_net__weight", "value_net__bias"]
    assert sorted(order) == sorted(names)
    return {n: g.detach().numpy() for n, g in zip(order, grads)}


def _batch(rng):
    obs = rng.uniform(-0.5, 1.5, (BATCH, OBS))
    action = rng.integers(0, ACT, BATCH)
    logp = np.log(rng.uniform(0.01, 0.2, BATCH))
    adv = rng.normal(0.3, 1.0, BATCH)
    ret = rng.normal(0.5, 0.3, BATCH)
    jb = JTransition(jnp.asarray(obs), jnp.asarray(action), jnp.asarray(logp), None, None, None)
    t = lambda a: torch.tensor(a)
    tb = Transition(t(obs), t(action), t(logp), None, None, None)
    return jb, tb, (jnp.asarray(adv), jnp.asarray(ret)), (t(adv), t(ret))


def _close(a, b, what):
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale, err_msg=what)


def test_gae_matches_jax():
    jt, tt = _trainers()
    rng = np.random.default_rng(0)
    T, E = 12, 3
    value, reward = rng.normal(0, 1, (T, E)), rng.uniform(0, 1, (T, E))
    done = rng.uniform(0, 1, (T, E)) < 0.2
    last = rng.normal(0, 1, E)
    j_tr = JTransition(None, None, None, jnp.asarray(value), jnp.asarray(reward), jnp.asarray(done))
    t_tr = Transition(None, None, None, torch.tensor(value), torch.tensor(reward),
                      torch.tensor(done))
    adv_j, ret_j = jt._gae(j_tr, jnp.asarray(last))
    adv_t, ret_t = tt._gae(t_tr, torch.tensor(last))
    _close(adv_t.numpy(), np.asarray(adv_j), "advantages")
    _close(ret_t.numpy(), np.asarray(ret_j), "returns")


def test_loss_and_gradient_match_jax():
    jt, tt = _trainers()
    jp, tp = _policies()
    jb, tb, (adv_j, ret_j), (adv_t, ret_t) = _batch(np.random.default_rng(1))
    (l_j, aux_j), g_j = jax.value_and_grad(jt._loss, has_aux=True)(jp, jb, adv_j, ret_j)
    l_t, aux_t = tt._loss(tp, tb, adv_t, ret_t)
    g_t = torch.autograd.grad(l_t, list(tp.parameters()))
    _close(float(l_t), float(l_j), "loss")
    for name, a, b in zip(("pg", "v_loss", "entropy"), aux_t, aux_j):
        _close(float(a), float(b), name)
    gj = _jax_as_arrays(g_j)
    for name, g in _grads_as_arrays(tp, g_t).items():
        _close(g, gj[name], name)


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e3])
def test_clipped_adam_updates_match_optax(max_grad_norm):
    """Three minibatch updates on fresh batches, from count 0 (so the first
    runs at lr_schedule(0)); max_grad_norm 0.5 clips every step, 1e3 none.

    The JAX trainer's optax chain evaluates its schedule at optax's int32
    count, which JAX divides in float32; the reference chain here is the
    same chain with the schedule evaluated at that count as int64, so that
    both learning rates are float64 (test_lr_schedule_matches_jax holds the
    schedules themselves)."""
    cfg = dict(max_grad_norm=max_grad_norm, total_steps=4096, n_envs=2, n_steps=64,
               batch_size=32, n_epochs=2)
    jt, tt = _trainers(**cfg)
    jp, tp = _policies(seed=2)
    tt.policy = tp
    lr_j = j_lr_schedule(JPPOConfig(**cfg))
    tx = optax.chain(optax.clip_by_global_norm(max_grad_norm),
                     optax.adam(lambda count: lr_j(count.astype(jnp.int64))))
    opt = tx.init(jp)
    rng = np.random.default_rng(2)
    clipped = []
    for _ in range(3):
        jb, tb, (adv_j, ret_j), (adv_t, ret_t) = _batch(rng)
        _, g = jax.value_and_grad(jt._loss, has_aux=True)(jp, jb, adv_j, ret_j)
        clipped.append(float(optax.global_norm(g)) > max_grad_norm)
        upd, opt = tx.update(g, opt)
        jp = optax.apply_updates(jp, upd)
        tt._minibatch_update(tb, adv_t, ret_t)
    assert all(clipped) == (max_grad_norm < 1) and any(clipped) == (max_grad_norm < 1)
    assert int(tt.opt_state.count) == 3
    ja = _jax_as_arrays(jp)
    for name, a in policy_arrays(tt.policy).items():
        _close(a, ja[name], name)


def test_lr_schedule_matches_jax():
    cfg = dict(total_steps=10_000, n_envs=4, n_steps=50, batch_size=64, n_epochs=3)
    fj, ft = j_lr_schedule(JPPOConfig(**cfg)), lr_schedule(PPOConfig(**cfg))
    for count in (0, 1, 7, 150, 450, 451, 10_000):
        np.testing.assert_allclose(float(ft(torch.tensor(count))),
                                   float(fj(jnp.asarray(count, jnp.int64))), rtol=1e-14)
    assert float(ft(torch.tensor(0))) == 0.005


def test_eval_callback_saves_best_and_resumes(tmp_path):
    p = [init_mlp_policy(make_generator(s, "cpu"), 4, 3, device="cpu") for s in range(3)]

    class FakeTrainer:
        def __init__(self, rewards):
            self.rewards = iter(rewards)

        def evaluate(self, policy, seed, n_envs=None, n_steps=None):
            assert seed == 123
            return next(self.rewards)

    best_file = tmp_path / "best_model" / "policy_weights.npz"
    cb = EvalCallback(FakeTrainer([0.5, 0.9, 0.7]), str(tmp_path), eval_freq=1)
    cb(0, p[0], {})
    cb(1, p[1], {})   # best (0.9) -> saves p[1]
    cb(2, p[0], {})   # worse -> keeps p[1]
    assert cb.best == 0.9
    best = load_sb3_policy(str(best_file), device="cpu")
    torch.testing.assert_close(best.action_net.weight, p[1].action_net.weight)
    # resume into the same directory: the previous best and history stay
    cb2 = EvalCallback(FakeTrainer([0.8, 0.95]), str(tmp_path), eval_freq=2)
    assert cb2.best == 0.9 and [h[0] for h in cb2.history] == [0, 1, 2]
    cb2(3, p[2], {})  # not an eval update (eval_freq 2)
    cb2(4, p[2], {})  # 0.8 < 0.9: best_model keeps p[1]
    torch.testing.assert_close(load_sb3_policy(str(best_file), device="cpu").action_net.weight,
                               p[1].action_net.weight)
    cb2.finalize(p[2])  # 0.95: new best
    torch.testing.assert_close(load_sb3_policy(str(best_file), device="cpu").action_net.weight,
                               p[2].action_net.weight)
    ev = np.load(str(tmp_path / "evaluations.npz"))
    np.testing.assert_array_equal(ev["updates"], [0, 1, 2, 4, 5])
    np.testing.assert_allclose(ev["mean_reward"], [0.5, 0.9, 0.7, 0.8, 0.95])


def test_policy_npz_loads_in_both_packages(tmp_path):
    """A policy saved by the port loads in the JAX `load_sb3_policy` with
    equal logits, and one saved by the JAX package loads in the port's."""
    obs = np.random.default_rng(4).uniform(-0.5, 1.5, (5, OBS))
    tp = init_mlp_policy(make_generator(7, "cpu"), OBS, ACT, device="cpu", dtype=torch.float64)
    save_policy_npz(tp, str(tmp_path / "port.npz"))
    jq = j_load(str(tmp_path / "port.npz"))
    _close(np.asarray(jq.logits(jnp.asarray(obs))), tp.logits(torch.tensor(obs)).detach().numpy(),
           "port -> jax logits")
    jp = j_init(jax.random.PRNGKey(5), OBS, ACT)
    j_save(jp, str(tmp_path / "jax.npz"))
    tq = load_sb3_policy(str(tmp_path / "jax.npz"), device="cpu", dtype=torch.float64)
    _close(tq.logits(torch.tensor(obs)).numpy(), np.asarray(jp.logits(jnp.asarray(obs))),
           "jax -> port logits")
    probs = tq.action_probabilities(torch.tensor(obs))
    _close(probs.numpy(), np.asarray(jp.action_probabilities(jnp.asarray(obs))), "probabilities")
    # the orthogonal initialization: trunk columns orthonormal x sqrt 2
    w = tp.pi[0].weight.detach().double()   # (128, 22): fan_in 22 < 128, rows orthonormal
    torch.testing.assert_close(w.T @ w, 2.0 * torch.eye(OBS, dtype=torch.float64))
    assert float(tp.pi[0].bias.abs().max()) == 0.0


def test_rl_training_entry_module_smoke(tmp_path):
    """`python -m tum_control_tpu_torch.rl_training --smoke --device cpu`
    runs to its end and writes its artifacts; the trained policy loads in
    the JAX package."""
    from tum_control_tpu_torch import rl_training

    out = tmp_path / "run"
    rl_training.main(["--smoke", "--device", "cpu", "--out", str(out)])
    for f in ("policy_weights.npz", "evaluations.npz", "rl_config.yaml",
              "best_model/policy_weights.npz", "best_model/rl_config.yaml"):
        assert (out / f).exists(), f
    ev = np.load(str(out / "evaluations.npz"))
    assert len(ev["updates"]) == 3 and np.all((ev["mean_reward"] > 0) & (ev["mean_reward"] <= 1))
    assert j_load(str(out / "policy_weights.npz")).act_w.shape == (128, 26)
