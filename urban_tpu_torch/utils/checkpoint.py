"""Checkpoint files (counterpart of urban_tpu/utils/checkpoint.py).

The reference pickles {model state, best plans, iteration} every
save_model_interval iterations plus reward-stamped best copies (reference:
urban_planning/agents/urban_planning_agent.py:172-194). The pickle pair
keeps that format with every tensor moved to the CPU; the step pair saves
a tree of tensors per step with torch.save (the JAX package's orbax pair).
Both read with full unpickling: read only files this package wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import torch


def to_cpu(tree):
    """`tree` (nested dicts, lists and tuples) with every tensor detached
    and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not hasattr(tree, '_fields'):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def save_pickle_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(to_cpu(payload), f)


def load_pickle_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, 'rb') as f:
        return pickle.load(f)


def step_checkpoint_path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f'step_{step:06d}.pt'))


def save_step_checkpoint(directory: str, step: int, tree) -> str:
    """Save a tree of tensors (a state dict, nested dicts) for `step` on
    the CPU; returns the file's path."""
    path = step_checkpoint_path(directory, step)
    os.makedirs(directory, exist_ok=True)
    torch.save(to_cpu(tree), path)
    return path


def load_step_checkpoint(directory: str, step: int,
                         target: Optional[Any] = None):
    """The tree saved for `step`, on the CPU; with a `target` tree of the
    same structure, each tensor takes the device and dtype of the target's
    tensor at its place (a shape or key that differs raises)."""
    tree = torch.load(step_checkpoint_path(directory, step),
                      map_location='cpu', weights_only=False)
    return tree if target is None else _like(tree, target, '')


def _like(tree, target, where):
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape:
            raise ValueError(f'{where or "root"}: saved '
                             f'{getattr(tree, "shape", type(tree))} does not '
                             f'fit {tuple(target.shape)}')
        return tree.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if set(tree) != set(target):
            raise KeyError(f'{where or "root"}: saved keys {sorted(tree)} '
                           f'!= {sorted(target)}')
        return type(target)((k, _like(tree[k], v, f'{where}/{k}'))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        if len(tree) != len(target):
            raise ValueError(f'{where or "root"}: saved length {len(tree)} '
                             f'!= {len(target)}')
        return type(target)(_like(a, b, f'{where}/{i}')
                            for i, (a, b) in enumerate(zip(tree, target)))
    return tree
