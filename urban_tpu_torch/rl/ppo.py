"""Clipped-PPO update (counterpart of urban_tpu/rl/ppo.py).

Clipped surrogate on exploration rows only (``exps`` weights the surrogate
and the entropy; greedy rows still train the value), value MSE weighted by
``valid`` (the episode success weights), entropy bonus, global-norm
gradient clipping, Adam. The loss runs on fixed-size minibatches with the
filters as weights, not boolean indexing, as in the JAX package; where the
JAX package scans over the minibatches of an epoch inside one jit, the
port loops over them in Python.

The clip follows optax.clip_by_global_norm: the gradients are scaled by
max_norm / norm only where norm >= max_norm (torch's clip_grad_norm_
would scale by max_norm / (norm + 1e-6) whenever norm > max_norm).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

STAT_KEYS = ('loss', 'value_loss', 'surr_loss', 'entropy_loss')


class PPOConfig(NamedTuple):
    clip_epsilon: float = 0.2
    value_pred_coef: float = 0.5
    entropy_coef: float = 0.01
    grad_clip: float = 1.0
    lr: float = 4e-4
    eps: float = 1e-5
    weight_decay: float = 0.0


def make_optimizer(params, cfg: PPOConfig) -> torch.optim.Optimizer:
    """Adam (AdamW where weight decay is set) with the config's lr and eps;
    the global-norm clip is applied by gradient_step before each step."""
    params = list(params)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, lr=cfg.lr, eps=cfg.eps,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.Adam(params, lr=cfg.lr, eps=cfg.eps)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm where their global
    norm is >= max_norm (optax's rule, without a host sync). Returns the
    norm before clipping."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def gradient_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  cfg: PPOConfig, loss: torch.Tensor) -> None:
    """Backward of loss, global-norm clip, optimizer step. Every parameter
    takes part in the loss, so each has a gradient (zeros where unused,
    as in JAX) and Adam advances the moments of all of them."""
    optimizer.zero_grad(set_to_none=False)
    loss.backward()
    clip_by_global_norm_([p.grad for p in model.parameters()], cfg.grad_clip)
    optimizer.step()


def ppo_loss(model, obs, actions, returns, advantages, fixed_log_probs,
             exps, cfg: PPOConfig, valid=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked PPO loss on a minibatch. exps (B,) weights the surrogate and
    entropy terms, valid (B,) the value loss (all rows where None); each
    weighted sum is divided by max(weight sum, 1). Returns (loss, stats)
    with the stats detached."""
    log_probs, entropy, values = model.log_prob_entropy_value(obs, actions)
    w = exps.reshape(-1)
    v_w = torch.ones_like(w) if valid is None else valid.reshape(-1)
    ratio = torch.exp(log_probs - fixed_log_probs)
    surr1 = ratio * advantages
    surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                        1.0 + cfg.clip_epsilon) * advantages

    val_num = (v_w * ((values - returns) ** 2).reshape(-1)).sum()
    surr_num = -(torch.minimum(surr1, surr2).reshape(-1) * w).sum()
    ent_num = -(entropy.reshape(-1) * w).sum()
    value_loss = val_num / torch.clamp_min(v_w.sum(), 1.0)
    surr_loss = surr_num / torch.clamp_min(w.sum(), 1.0)
    entropy_loss = ent_num / torch.clamp_min(w.sum(), 1.0)

    loss = surr_loss + cfg.value_pred_coef * value_loss \
        + cfg.entropy_coef * entropy_loss
    stats = dict(zip(STAT_KEYS, (x.detach() for x in (
        loss, value_loss, surr_loss, entropy_loss))))
    return loss, stats


def ppo_update_step(model, optimizer, cfg: PPOConfig, obs, actions, returns,
                    advantages, fixed_log_probs, exps, valid=None
                    ) -> Dict[str, torch.Tensor]:
    """One minibatch gradient step, in place on model and optimizer.
    Returns the loss stats (device tensors)."""
    loss, stats = ppo_loss(model, obs, actions, returns, advantages,
                           fixed_log_probs, exps, cfg, valid)
    gradient_step(model, optimizer, cfg, loss)
    return stats


@torch.no_grad()
def fixed_log_probs_and_values(model, obs, actions):
    """Pre-update log-probs (frozen policy) and values in one trunk pass."""
    log_probs, _, values = model.log_prob_entropy_value(obs, actions)
    return log_probs, values


def ppo_update_epoch(model, optimizer, cfg: PPOConfig, obs, actions,
                     returns, advantages, fixed_log_probs, exps,
                     perm: torch.Tensor, num_mb: int, mb_size: int,
                     valid=None) -> Dict[str, torch.Tensor]:
    """One shuffled epoch of minibatch steps: minibatch i takes the rows
    perm[i * mb_size:(i + 1) * mb_size]. Returns the mean of the
    per-minibatch stats (device tensors; nothing syncs the host)."""
    if valid is None:
        valid = torch.ones_like(exps)
    per_mb = []
    for i in range(num_mb):
        idx = perm[i * mb_size:(i + 1) * mb_size]
        stats = ppo_update_step(
            model, optimizer, cfg, tuple(o[idx] for o in obs), actions[idx],
            returns[idx], advantages[idx], fixed_log_probs[idx], exps[idx],
            valid[idx])
        per_mb.append(torch.stack([stats[k] for k in STAT_KEYS]))
    means = torch.stack(per_mb).mean(dim=0)
    return dict(zip(STAT_KEYS, means))
