"""Masked categorical policy heads (counterpart of
urban_tpu/models/policy.py). Both heads run for every batch row; the stage
one-hot selects which distribution contributes."""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

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


class RowShard(NamedTuple):
    """One data-parallel rank's rows of a batch-wide random stream: each
    draw is made at the whole batch's size (`total` rows) from `generator`
    and cut to the rank's rows from `start`, so that the rank takes
    exactly the numbers a one-device run gives those rows, and every
    rank's generator stays in step."""
    generator: torch.Generator
    start: int
    total: int


def uniform(shape, generator: Union[torch.Generator, RowShard], device,
            dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws of `shape` (leading axis: the batch) from a generator,
    or a RowShard's rows of the batch-wide draw."""
    if isinstance(generator, RowShard):
        full = torch.rand((generator.total,) + tuple(shape[1:]),
                          generator=generator.generator, device=device,
                          dtype=dtype)
        return full[generator.start:generator.start + shape[0]]
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def gumbel_scores(logits, generator: Union[torch.Generator, RowShard]):
    """The logits plus Gumbel noise: their argmax is a categorical sample
    (the form jax.random.categorical uses)."""
    u = uniform(logits.shape, generator, logits.device, logits.dtype)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return logits - torch.log(-torch.log(u))


def categorical_sample(logits, generator: Union[torch.Generator, RowShard]):
    """Gumbel-max sample along the last axis, with noise drawn from an
    explicit generator (or a rank's rows of it)."""
    return torch.argmax(gumbel_scores(logits, generator), dim=-1)
