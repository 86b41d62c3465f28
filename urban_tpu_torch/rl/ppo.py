"""Clipped-PPO update (counterpart of urban_tpu/rl/ppo.py).

Clipped surrogate on exploration rows only (``exps`` weights the surrogate
and the entropy; greedy rows still train the value), value MSE weighted by
``valid`` (the episode success weights), entropy bonus, global-norm
gradient clipping, Adam. The loss runs on fixed-size minibatches with the
filters as weights, not boolean indexing, as in the JAX package. Where the
JAX package scans over the minibatches of an epoch inside one jit,
``ppo_update_epoch`` loops over them in Python; on the card the trainer
replays one captured minibatch step instead (``rl/update_program.py``),
which the same ``ppo_update_step`` makes. On CUDA parameters the
optimizer is capturable: its step counts and bias corrections stay on the
device, so that a graph can hold the step.

With a process group (data parallelism, urban_tpu_torch.parallel.mesh)
each rank steps on its rows of the minibatch: the loss all-reduces its
weight sums, the gradients are all-reduced, and every rank applies the
same clip and Adam step (the JAX package's shard_map update).

The clip follows optax.clip_by_global_norm: the gradients are scaled by
max_norm / norm only where norm >= max_norm (torch's clip_grad_norm_
would scale by max_norm / (norm + 1e-6) whenever norm > max_norm).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

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
    the global-norm clip is applied by gradient_step before each step.
    Capturable where the parameters are on CUDA (torch refuses it on the
    CPU): the step stays on the device, as a CUDA graph needs."""
    params = list(params)
    capturable = bool(params) and all(p.device.type == 'cuda'
                                      for p in params)
    kw = dict(lr=cfg.lr, eps=cfg.eps, capturable=capturable)
    if cfg.weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> None:
    """optimizer.load_state_dict, keeping the optimizer's own capturable
    setting, which the saved param groups would replace: a checkpoint
    written on the card loads on the CPU and back. Adam's step counts go
    where that setting keeps them (the device where capturable, else the
    CPU)."""
    capturable = [g['capturable'] for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, cap in zip(optimizer.param_groups, capturable):
        group['capturable'] = cap
        for p in group['params']:
            state = optimizer.state.get(p, {})
            if 'step' in state:
                state['step'] = state['step'].to(
                    p.device if cap else 'cpu', torch.float32)


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
                  cfg: PPOConfig, loss: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Backward of loss, the gradients all-reduced (SUM) over a process
    group where one is given, global-norm clip, optimizer step. Every
    parameter takes part in the loss, so each has a gradient (zeros where
    unused, as in JAX) and Adam advances the moments of all of them; a
    loss without a graph (a data-parallel rank without rows) gives zero
    gradients. Returns the global norm before the clip."""
    params = list(model.parameters())
    optimizer.zero_grad(set_to_none=False)
    if loss.requires_grad:
        loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if group is not None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    norm = clip_by_global_norm_(grads, cfg.grad_clip)
    optimizer.step()
    return norm


def ppo_loss(model, obs, actions, returns, advantages, fixed_log_probs,
             exps, cfg: PPOConfig, valid=None, group=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked PPO loss on a minibatch. exps (B,) weights the surrogate and
    entropy terms, valid (B,) the value loss (all rows where None); each
    weighted sum is divided by max(weight sum, 1). Returns (loss, stats)
    with the stats detached.

    With a process group (data parallelism), only the weight sums are
    all-reduced before they divide: the loss is then this rank's exact
    share of the global weighted mean, and the sum of the ranks' gradients
    is the one-device gradient. (All-reducing the numerators as well
    would count every rank's share once per rank.) The stats are
    all-reduced, so they are the global ones. A rank without rows runs no
    forward: its loss is a constant zero, but it takes part in every
    all-reduce."""
    w = exps.reshape(-1)
    v_w = torch.ones_like(w) if valid is None else valid.reshape(-1)
    if w.numel():
        log_probs, entropy, values = model.log_prob_entropy_value(obs,
                                                                  actions)
        ratio = torch.exp(log_probs - fixed_log_probs)
        surr1 = ratio * advantages
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_epsilon,
                            1.0 + cfg.clip_epsilon) * advantages
        val_num = (v_w * ((values - returns) ** 2).reshape(-1)).sum()
        surr_num = -(torch.minimum(surr1, surr2).reshape(-1) * w).sum()
        ent_num = -(entropy.reshape(-1) * w).sum()
    else:
        val_num = surr_num = ent_num = w.new_zeros(())
    sums = torch.stack([w.sum(), v_w.sum()])
    if group is not None:
        dist.all_reduce(sums, group=group)
    wsum, vsum = torch.clamp_min(sums, 1.0)
    value_loss = val_num / vsum
    surr_loss = surr_num / wsum
    entropy_loss = ent_num / wsum

    loss = surr_loss + cfg.value_pred_coef * value_loss \
        + cfg.entropy_coef * entropy_loss
    stats = torch.stack([loss, value_loss, surr_loss, entropy_loss]).detach()
    if group is not None:
        dist.all_reduce(stats, group=group)
    return loss, dict(zip(STAT_KEYS, stats))


def ppo_update_step(model, optimizer, cfg: PPOConfig, obs, actions, returns,
                    advantages, fixed_log_probs, exps, valid=None,
                    group=None) -> Dict[str, torch.Tensor]:
    """One minibatch gradient step, in place on model and optimizer (with
    a process group: on this rank's rows, which may be none). Returns the
    loss stats and grad_norm, the global norm of the (reduced) gradients
    before the clip (device tensors)."""
    loss, stats = ppo_loss(model, obs, actions, returns, advantages,
                           fixed_log_probs, exps, cfg, valid, group)
    return dict(stats, grad_norm=gradient_step(model, optimizer, cfg, loss,
                                               group))


@torch.no_grad()
def fixed_log_probs_and_values(model, obs, actions):
    """Pre-update log-probs (frozen policy) and values in one trunk pass."""
    log_probs, _, values = model.log_prob_entropy_value(obs, actions)
    return log_probs, values


def ppo_update_epoch(model, optimizer, cfg: PPOConfig, obs, actions,
                     returns, advantages, fixed_log_probs, exps,
                     minibatches: Sequence[torch.Tensor], valid=None,
                     group=None) -> Dict[str, torch.Tensor]:
    """One shuffled epoch of minibatch steps, one for each tensor of row
    indices in `minibatches` (a permutation's consecutive slices; with a
    process group, this rank's rows of each). Returns the mean of the
    per-minibatch loss stats (device tensors; nothing syncs the host)."""
    if valid is None:
        valid = torch.ones_like(exps)
    per_mb = []
    for idx in minibatches:
        stats = ppo_update_step(
            model, optimizer, cfg, tuple(o[idx] for o in obs), actions[idx],
            returns[idx], advantages[idx], fixed_log_probs[idx], exps[idx],
            valid[idx], group)
        per_mb.append(torch.stack([stats[k] for k in STAT_KEYS]))
    means = torch.stack(per_mb).mean(dim=0)
    return dict(zip(STAT_KEYS, means))
