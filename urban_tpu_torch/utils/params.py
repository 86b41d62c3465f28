"""Parameter and schedule utilities (counterpart of urban_tpu/utils/params.py).

Flat parameter views of a module and learning-rate schedules, as the
reference's torch helpers have them (reference:
khrylib/utils/torch.py:83-217). The schedules give the values of the JAX
package's optax schedules at every step.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def get_flat_params(model: nn.Module) -> torch.Tensor:
    """Every parameter of `model`, flattened in registration order into
    one vector (khrylib/utils/torch.py:87-93)."""
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


@torch.no_grad()
def set_flat_params(model: nn.Module, flat: torch.Tensor) -> nn.Module:
    """Fill `model`'s parameters in place from a vector laid out as
    get_flat_params lays it out (khrylib/utils/torch.py:96-104)."""
    params = list(model.parameters())
    if flat.numel() != count_params(model):
        raise ValueError(f'{flat.numel()} values for {count_params(model)} '
                         f'parameters')
    offset = 0
    for p in params:
        n = p.numel()
        p.copy_(flat[offset:offset + n].reshape(p.shape))
        offset += n
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def lr_schedule(kind: str, base_lr: float, total_steps: int,
                warmup_steps: int = 0, end_lr: float = 0.0
                ) -> Callable[[int], float]:
    """Learning rate at a step: 'constant', 'linear' (base_lr to end_lr
    after warmup_steps), 'cosine' (linear warm-up from 0 over
    warmup_steps, then a cosine decay to end_lr at total_steps) or 'step'
    (x0.1 every total_steps // 3). For torch.optim, wrap it as
    ``LambdaLR(opt, lambda s: sched(s) / base_lr)``."""
    if kind == 'constant':
        return lambda step: base_lr
    if kind == 'linear':
        span = max(total_steps - warmup_steps, 1)

        def linear(step):
            t = min(max(step - warmup_steps, 0), span)
            return (base_lr - end_lr) * (1 - t / span) + end_lr
        return linear
    if kind == 'cosine':
        init = 0.0 if warmup_steps else base_lr
        decay = total_steps - warmup_steps
        if decay <= 0:
            raise ValueError(f'cosine schedule needs total_steps > '
                             f'warmup_steps, got {total_steps}, '
                             f'{warmup_steps}')
        alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr

        def cosine(step):
            if step < warmup_steps:
                return (init - base_lr) * (1 - step / warmup_steps) + base_lr
            t = min(step - warmup_steps, decay)
            return base_lr * ((1 - alpha) * 0.5
                              * (1 + math.cos(math.pi * t / decay)) + alpha)
        return cosine
    if kind == 'step':
        every = max(total_steps // 3, 1)
        return lambda step: (base_lr if step <= 0
                             else base_lr * 0.1 ** math.floor(step / every))
    raise ValueError(f'Unknown schedule {kind}')
