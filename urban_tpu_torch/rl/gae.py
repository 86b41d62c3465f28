"""Generalized Advantage Estimation over a flat step sequence (counterpart
of urban_tpu/rl/gae.py).

A reverse pass where ``mask = 0`` marks episode ends:
  delta_t = r_t + gamma * V_{t+1} * mask_t - V_t
  A_t     = delta_t + gamma * tau * A_{t+1} * mask_t
  returns = V + A
The batched (T, B) form the trainer uses is torchenv/rollout.batched_gae.
"""
from __future__ import annotations

import torch

from urban_tpu_torch.torchenv.rollout import gae_with_masks


def estimate_advantages(rewards: torch.Tensor, masks: torch.Tensor,
                        values: torch.Tensor, gamma: float, tau: float,
                        normalize: bool = False):
    """rewards/masks/values: (T,) or (T, 1). Returns (advantages, returns)
    in the shape of rewards; normalize standardizes the advantages (with
    the population standard deviation)."""
    shape = rewards.shape
    advantages, returns = gae_with_masks(
        rewards.reshape(-1, 1), masks.reshape(-1, 1).to(rewards.dtype),
        values.reshape(-1, 1), gamma, tau)
    if normalize:
        advantages = ((advantages - advantages.mean())
                      / (advantages.std(unbiased=False) + 1e-8))
    return advantages.reshape(shape), returns.reshape(shape)
