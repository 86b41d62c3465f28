"""Masked categorical policy heads (counterpart of
urban_tpu/models/policy.py). Both heads run for every batch row; the stage
one-hot selects which distribution contributes."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

MASK_PAD = -(2.0 ** 32 - 1)


class PolicyHead(nn.Module):
    """Stacked linear head -> per-element logit. Only the first layer has a
    bias, as in the JAX head."""

    def __init__(self, in_dim: int, hidden_size: Sequence[int]):
        super().__init__()
        dims = [in_dim, *hidden_size]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=(i == 0))
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x[..., 0]


def masked_logits(logits, mask):
    return torch.where(mask, logits, MASK_PAD)


def categorical_log_prob(logits, action):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    return -(p * torch.where(p > 0, logp, 0.0)).sum(dim=-1)


def categorical_sample(logits, generator: torch.Generator):
    """Gumbel-max sample along the last axis (the form jax.random.categorical
    uses), with noise drawn from an explicit generator."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
