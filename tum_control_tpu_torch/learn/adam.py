"""Adam in the operation order of optax (`optax.adam`, optionally behind
`optax.clip_by_global_norm`), for the port's PPO, GP fit and acquisition
polish. Functional, so that a caller may keep the old state where an
update is not finite (the GP fit does).

    mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  count += 1
    update = -lr(count_before) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

A schedule is evaluated at the count before its increment, as optax's
`scale_by_schedule` does, so the first update runs at lr(0).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # () int64 updates taken
    mu: list             # first moments, one per parameter
    nu: list             # second moments


def adam_init(params) -> AdamState:
    params = list(params)
    zeros = lambda: [torch.zeros_like(p) for p in params]
    return AdamState(count=torch.zeros((), dtype=torch.int64, device=params[0].device),
                     mu=zeros(), nu=zeros())


def adam_update(grads, state: AdamState, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """(updates, new state) for `grads`; `lr` a float or a schedule of the
    count tensor."""
    count = state.count + 1
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    step = lr(state.count) if callable(lr) else lr
    updates = []
    for m, v in zip(mu, nu):
        c = count.to(m.dtype)
        m_hat = m / (1 - b1**c)
        v_hat = v / (1 - b2**c)
        updates.append(m_hat / (torch.sqrt(v_hat) + eps) * -step)
    return updates, AdamState(count=count, mu=mu, nu=nu)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: each g as it is while the global norm is
    below max_norm, else g / norm * max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]
