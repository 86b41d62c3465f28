"""Generalized Advantage Estimation over a flat step sequence (counterpart
of urban_tpu/rl/gae.py).

A reverse pass where ``mask = 0`` marks episode ends:
  delta_t = r_t + gamma * V_{t+1} * mask_t - V_t
  A_t     = delta_t + gamma * tau * A_{t+1} * mask_t
  returns = V + A
The batched (T, B) form the trainer uses is torchenv/rollout.batched_gae;
the host agent's is estimate_advantages_np, in float64 numpy.
"""
from __future__ import annotations

import numpy as np
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


def estimate_advantages_np(rewards, masks, values, gamma, tau,
                           normalize=False):
    """The same pass in float64 numpy over arrays of any shape (flattened
    in C order); returns float32 (advantages, returns) in the shape of
    rewards."""
    r = np.asarray(rewards, dtype=np.float64).reshape(-1)
    m = np.asarray(masks, dtype=np.float64).reshape(-1)
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    adv = np.zeros_like(r)
    prev_value = 0.0
    prev_adv = 0.0
    for i in range(len(r) - 1, -1, -1):
        delta = r[i] + gamma * prev_value * m[i] - v[i]
        adv[i] = delta + gamma * tau * prev_adv * m[i]
        prev_value = v[i]
        prev_adv = adv[i]
    returns = v + adv
    if normalize:
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return (adv.reshape(np.shape(rewards)).astype(np.float32),
            returns.reshape(np.shape(rewards)).astype(np.float32))
