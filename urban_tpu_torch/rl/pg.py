"""Vanilla policy-gradient (A2C) update (counterpart of urban_tpu/rl/pg.py):
advantage-weighted log-prob on exploration rows, value MSE over all rows,
entropy bonus, with the PPO step's clip and optimizer."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from urban_tpu_torch.rl.ppo import STAT_KEYS, PPOConfig, gradient_step


def a2c_loss(model, obs, actions, returns, advantages, exps, cfg: PPOConfig
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    log_probs, entropy, values = model.log_prob_entropy_value(obs, actions)
    value_loss = torch.mean((values - returns) ** 2)
    w = exps.reshape(-1)
    wsum = torch.clamp_min(w.sum(), 1.0)
    policy_loss = -((log_probs * advantages).reshape(-1) * w).sum() / wsum
    entropy_loss = -(entropy.reshape(-1) * w).sum() / wsum
    loss = policy_loss + cfg.value_pred_coef * value_loss \
        + cfg.entropy_coef * entropy_loss
    stats = dict(zip(STAT_KEYS, (x.detach() for x in (
        loss, value_loss, policy_loss, entropy_loss))))
    return loss, stats


def a2c_update_step(model, optimizer, cfg: PPOConfig, obs, actions, returns,
                    advantages, exps) -> Dict[str, torch.Tensor]:
    """One gradient step, in place on model and optimizer."""
    loss, stats = a2c_loss(model, obs, actions, returns, advantages, exps,
                           cfg)
    gradient_step(model, optimizer, cfg, loss)
    return stats
