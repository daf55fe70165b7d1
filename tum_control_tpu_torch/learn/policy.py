"""Actor-critic MLP policy (SB3 MlpPolicy layout), port of
tum_control_tpu/learn/policy.py:

    obs -> policy_net [128, 256, 128] (tanh) -> action_net logits
        -> value_net trunk of the same widths -> value_net head

`predict` is the deterministic action, the argmax of the logits, as SB3's
categorical policy gives it. The converted checkpoints
(data/wmpc_models/<name>/policy_weights.npz) store PyTorch-layout (out, in)
weights, which `nn.Linear` takes as they are; `save_policy_npz` writes the
same layout, so a policy trained here loads in either package. The
products are plain matmuls (no kernel of the JAX package covers them).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tum_control_tpu_torch.device import resolve_device


def _trunk(dims):
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


class MLPPolicy(nn.Module):
    def __init__(self, obs_dim: int, n_actions: int, hidden=(128, 256, 128)):
        super().__init__()
        dims = (obs_dim, *hidden)
        self.pi = _trunk(dims)
        self.vf = _trunk(dims)
        self.action_net = nn.Linear(hidden[-1], n_actions)
        self.value_net = nn.Linear(hidden[-1], 1)

    @property
    def n_actions(self) -> int:
        return self.action_net.out_features

    @staticmethod
    def _features(layers, obs):
        h = obs
        for layer in layers:
            h = torch.tanh(layer(h))
        return h

    def logits(self, obs):
        """(..., obs_dim) -> (..., n_actions)."""
        return self.action_net(self._features(self.pi, obs))

    def value(self, obs):
        """(..., obs_dim) -> (...,) critic value."""
        return self.value_net(self._features(self.vf, obs))[..., 0]

    def predict(self, obs):
        """Deterministic discrete action (argmax over logits), int64."""
        return torch.argmax(self.logits(obs), dim=-1)

    def action_probabilities(self, obs):
        """Softmax action distribution (..., n_actions)."""
        return torch.softmax(self.logits(obs), dim=-1)


def _orthogonal(gen: torch.Generator, fan_in: int, fan_out: int, scale: float):
    """scale x a (fan_in, fan_out) matrix with orthonormal columns (or rows,
    when fan_in < fan_out): Q of the QR factorization of a normal draw, as
    the JAX package's `init_mlp_policy` makes it."""
    a = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float64)
    if fan_in >= fan_out:
        q = torch.linalg.qr(a)[0]
    else:
        q = torch.linalg.qr(a.T)[0].T
    return scale * q[:fan_in, :fan_out]


def init_mlp_policy(gen: torch.Generator, obs_dim: int, n_actions: int,
                    hidden=(128, 256, 128), device=None, dtype=torch.float32) -> MLPPolicy:
    """A fresh policy for training from scratch: orthogonal weights (gain
    sqrt 2 in the trunks, 0.01 on the action head, 1 on the value head),
    zero biases, drawn from `gen` on the CPU in float64 and then moved to
    `device` (cuda unless named) and `dtype`."""
    device = resolve_device(device)
    policy = MLPPolicy(obs_dim, n_actions, hidden)
    layers = ([(layer, np.sqrt(2)) for layer in policy.pi]
              + [(layer, np.sqrt(2)) for layer in policy.vf]
              + [(policy.action_net, 0.01), (policy.value_net, 1.0)])
    with torch.no_grad():
        for layer, gain in layers:
            w = _orthogonal(gen, layer.in_features, layer.out_features, gain)
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return policy.to(device=device, dtype=dtype)


def policy_arrays(policy: MLPPolicy) -> dict:
    """The converted-SB3 arrays of a policy (weights (out, in), numpy)."""
    arrs = {}
    for prefix, layers in (("policy_net", policy.pi), ("value_net", policy.vf)):
        for i, layer in enumerate(layers):
            arrs[f"mlp_extractor__{prefix}__{2 * i}__weight"] = layer.weight
            arrs[f"mlp_extractor__{prefix}__{2 * i}__bias"] = layer.bias
    for name in ("action_net", "value_net"):
        arrs[f"{name}__weight"] = getattr(policy, name).weight
        arrs[f"{name}__bias"] = getattr(policy, name).bias
    return {k: v.detach().cpu().numpy() for k, v in arrs.items()}


def save_policy_npz(policy: MLPPolicy, npz_path: str):
    """Save in the converted-SB3 npz layout that both packages'
    `load_sb3_policy` read."""
    np.savez(npz_path, **policy_arrays(policy))


def policy_from_arrays(arrs: dict, device=None, dtype=torch.float32) -> MLPPolicy:
    """An MLPPolicy from converted-SB3 arrays: {"mlp_extractor__policy_net__{0,2,4}__weight",
    ..., "action_net__weight", "value_net__bias"}, weights (out, in). Its
    parameters take no gradient (inference); on `device`, cuda unless named."""
    device = resolve_device(device)
    w = lambda k: torch.as_tensor(np.asarray(arrs[k]), dtype=dtype, device=device)
    hidden = tuple(int(np.asarray(arrs[f"mlp_extractor__policy_net__{i}__weight"]).shape[0])
                   for i in (0, 2, 4))
    obs_dim = int(np.asarray(arrs["mlp_extractor__policy_net__0__weight"]).shape[1])
    n_actions = int(np.asarray(arrs["action_net__bias"]).shape[0])
    policy = MLPPolicy(obs_dim, n_actions, hidden).to(device=device, dtype=dtype)
    with torch.no_grad():
        for prefix, layers in (("policy_net", policy.pi), ("value_net", policy.vf)):
            for layer, i in zip(layers, (0, 2, 4)):
                layer.weight.copy_(w(f"mlp_extractor__{prefix}__{i}__weight"))
                layer.bias.copy_(w(f"mlp_extractor__{prefix}__{i}__bias"))
        for name in ("action_net", "value_net"):
            getattr(policy, name).weight.copy_(w(f"{name}__weight"))
            getattr(policy, name).bias.copy_(w(f"{name}__bias"))
    return policy.requires_grad_(False)


def load_sb3_policy(npz_path: str, device=None, dtype=torch.float32) -> MLPPolicy:
    """Load a converted SB3 checkpoint (npz) on `device` (cuda unless named)."""
    with np.load(npz_path) as d:
        return policy_from_arrays(dict(d), device=device, dtype=dtype)
