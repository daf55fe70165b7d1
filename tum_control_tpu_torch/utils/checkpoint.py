"""Checkpoint / resume for long training sweeps (port of
tum_control_tpu/utils/checkpoint.py, which saves through orbax).

Any tree of tensors, NamedTuples, tuples, lists, dicts, plain numbers and
None (a PPO policy's parameters with its optimizer state, a mid-run
`SimCarry` with its disturbance generator) is saved with `torch.save` as
the flat list of its leaves, written to a temporary file and renamed, so a
checkpoint is complete or absent. `load_pytree` reads it back with
`torch.load(weights_only=True)`, which unpickles no class, and rebuilds the
structure of `like`. A `torch.Generator` is saved as its `get_state()`.
"""
from __future__ import annotations

import os

import torch


def _leaves(tree):
    """The leaves of `tree` in a fixed order (dict keys sorted)."""
    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(like, torch.Generator):
        g = torch.Generator(device=like.device)
        g.set_state(leaves.pop(0))
        return g
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    leaf = leaves.pop(0)
    if isinstance(like, torch.Tensor):
        if not isinstance(leaf, torch.Tensor) or leaf.shape != like.shape:
            raise ValueError(f"checkpoint leaf {getattr(leaf, 'shape', leaf)} does not match "
                             f"a tensor of shape {tuple(like.shape)}")
        return leaf.to(like.device)
    return leaf


def save_pytree(path: str, tree) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_leaves(tree), tmp)
    os.replace(tmp, path)


def load_pytree(path: str, like):
    """Restore a checkpoint with the structure of `like`; each tensor goes to
    the device of its counterpart in `like`."""
    leaves = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    n = len(_leaves(like))
    if len(leaves) != n:
        raise ValueError(f"checkpoint holds {len(leaves)} leaves, `like` has {n}")
    return _rebuild(like, leaves)
