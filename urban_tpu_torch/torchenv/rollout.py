"""Batched rollouts, and the per-step advantage and weight passes of the
trainer (counterpart of urban_tpu/jaxenv/rollout.py).

The per-environment step and observation functions are lifted over a
leading environment axis with ``torch.func.vmap``; ``lax.scan`` over time
becomes a Python loop (forward for the rollouts, reverse for GAE and the
success weights), and finished environments auto-reset to the initial
state. Stage-boundary rewards are evaluated only on steps where some
environment finished its land-use stage: one host sync per step
(``if mask.any()``) stands in for the JAX batch-level ``lax.cond``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.func import vmap

from urban_tpu_torch.torchenv.state import FIELD_NAMES, EnvSpec, PlanState
from urban_tpu_torch.torchenv.step import (FAILURE_BIT_NAMES, build_obs,
                                           env_step, land_use_stage_reward)


def make_batch_fns(spec: EnvSpec):
    """Batched observation and step functions (slot-layout actions). The
    step defers stage-boundary rewards to ``apply_stage_rewards``."""
    batch_obs = vmap(lambda s: build_obs(spec, s))
    batch_step = vmap(lambda s, a: env_step(spec, s, a,
                                            compute_rewards=False))
    return batch_obs, batch_step


def apply_stage_rewards(spec: EnvSpec, states: PlanState, reward, info):
    """Land-use stage rewards for the environments that just finished that
    stage, computed only when at least one did (host-synced branch)."""
    lu_fin = info['lu_done'] & ~info['failure']
    if bool(lu_fin.any()):
        lu_r = vmap(lambda s: land_use_stage_reward(spec, s))(states)
    else:
        lu_r = torch.zeros_like(reward)
    reward = torch.where(lu_fin, lu_r, reward)
    states = states.replace(land_use_reward=torch.where(
        lu_fin, lu_r, states.land_use_reward))
    return states, reward


def broadcast_state(state: PlanState, batch: int) -> PlanState:
    return state.map(lambda x: x.expand((batch,) + x.shape).clone())


def reset_done(init_b: PlanState, state: PlanState) -> PlanState:
    """Replace finished environments with the initial state."""
    done = state.done
    return PlanState(*(
        torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), i, s)
        for i, s in ((getattr(init_b, n), getattr(state, n))
                     for n in FIELD_NAMES)))


def failure_histogram(codes: torch.Tensor) -> torch.Tensor:
    """(n_bits,) count of the failure codes that carry bit i, at index i."""
    bits = torch.arange(len(FAILURE_BIT_NAMES), device=codes.device,
                        dtype=torch.int32)[:, None]
    return ((codes.reshape(1, -1) >> bits) & 1).sum(dim=1)


def failure_causes(hist) -> Dict[str, int]:
    """{failure-bit name: count} of the nonzero entries of a histogram."""
    hist = [int(x) for x in hist]
    return {name: hist[bit.bit_length() - 1]
            for bit, name in FAILURE_BIT_NAMES.items()
            if hist[bit.bit_length() - 1]}


def overflow_failures(causes: Dict[str, int]) -> int:
    """Capacity-class failures (slot-table overflow), which must stay rare."""
    return sum(n for name, n in causes.items() if name.endswith('_overflow'))


@torch.no_grad()
def rollout_bench(spec: EnvSpec, model, init_state: PlanState,
                  start_state: PlanState, generator: torch.Generator,
                  num_steps: int):
    """Throughput rollout: no trajectory storage, only episode statistics.
    Returns (final_state, n_episodes, n_failures, success_reward_sum,
    failure-bit histogram), the counters as device tensors."""
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    init_b = broadcast_state(init_state, B)
    use_mean = torch.zeros(B, dtype=torch.bool, device=dev)

    state = start_state
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
    code_hist = torch.zeros(len(FAILURE_BIT_NAMES), dtype=torch.int64,
                            device=dev)
    for _ in range(num_steps):
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        action, _, _ = model.sample_action_logp_value(obs, generator,
                                                      use_mean)
        state, reward, done, info = batch_step(state, action)
        state, reward = apply_stage_rewards(spec, state, reward, info)
        n_eps = n_eps + done.sum()
        n_fail = n_fail + info['failure'].sum()
        code_hist = code_hist + failure_histogram(info['failure_code'])
        reward_sum = reward_sum + torch.where(done & ~info['failure'],
                                              reward, 0.0).sum()
    return state, n_eps, n_fail, reward_sum, code_hist


class Trajectory(NamedTuple):
    obs: Tuple[torch.Tensor, ...]   # each (T, B, ...)
    actions: torch.Tensor           # (T, B, 2) int32
    log_probs: torch.Tensor         # (T, B)
    values: torch.Tensor            # (T, B)
    rewards: torch.Tensor           # (T, B)
    dones: torch.Tensor             # (T, B) bool
    failures: torch.Tensor          # (T, B) bool
    exps: torch.Tensor              # (T, B) exploration indicator, float
    failure_codes: torch.Tensor     # (T, B) int32 FAIL_* bitmask of the step


@torch.no_grad()
def rollout(spec: EnvSpec, model, init_state: PlanState,
            start_state: PlanState, generator: torch.Generator,
            num_steps: int, noise_rate: float = 1.0):
    """Collect (T, B) trajectories with auto-reset, stored on the states'
    device. A row explores (samples its action) where a uniform draw is
    below noise_rate; otherwise it takes the argmax. Returns
    (final_states, Trajectory)."""
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    init_b = broadcast_state(init_state, B)

    def buffer(x):
        return torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                           device=dev)

    state, bufs = start_state, None
    for t in range(num_steps):
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        use_mean = torch.rand(B, generator=generator,
                              device=dev) >= noise_rate
        action, log_prob, value = model.sample_action_logp_value(
            obs, generator, use_mean)
        state, reward, done, info = batch_step(state, action)
        state, reward = apply_stage_rewards(spec, state, reward, info)
        out = (*obs, action, log_prob[..., 0], value[..., 0], reward, done,
               info['failure'], (~use_mean).to(torch.float32),
               info['failure_code'])
        if bufs is None:
            bufs = [buffer(x) for x in out]
        for buf, x in zip(bufs, out):
            buf[t].copy_(x)
    n_obs = len(bufs) - 8
    return state, Trajectory(tuple(bufs[:n_obs]), *bufs[n_obs:])


@torch.no_grad()
def eval_rollout(spec: EnvSpec, model, start_state: PlanState,
                 generator: torch.Generator, num_steps: int):
    """Greedy evaluation episodes: B fresh envs stepped with argmax actions
    and frozen once done (no auto-reset), so the terminal plan states
    survive for scoring. Returns (final_states, total_reward (B,),
    done (B,), failure (B,))."""
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    use_mean = torch.ones(B, dtype=torch.bool, device=dev)
    state = start_state
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        obs = batch_obs(state)
        action, _, _ = model.sample_action_logp_value(obs, generator,
                                                      use_mean)
        nxt, reward, _, info = batch_step(state, action)
        nxt, reward = apply_stage_rewards(spec, nxt, reward, info)
        frozen = state.done
        nxt = PlanState(*(
            torch.where(frozen.reshape((-1,) + (1,) * (new.dim() - 1)),
                        old, new)
            for old, new in ((getattr(state, n), getattr(nxt, n))
                             for n in FIELD_NAMES)))
        total = total + torch.where(frozen, 0.0, reward)
        state = nxt
    return state, total, state.done, state.failure


def episode_success_weights(dones: torch.Tensor,
                            failures: torch.Tensor) -> torch.Tensor:
    """(T, B) weight: 1 for the steps of episodes that ended without
    failure inside the window, else 0 (failed episodes and the truncated
    tail are excluded from training)."""
    success_at_end = (dones & ~failures).to(torch.float32)
    flag = torch.zeros(dones.shape[1], dtype=torch.float32,
                       device=dones.device)
    flags = torch.empty(dones.shape, dtype=torch.float32, device=dones.device)
    for t in range(dones.shape[0] - 1, -1, -1):
        flag = torch.where(dones[t], success_at_end[t], flag)
        flags[t] = flag
    return flags


def normalize_advantages(advantages: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Standardize advantages over the rows that train (weights > 0)."""
    wsum = torch.clamp_min(weights.sum(), 1.0)
    mu = (advantages * weights).sum() / wsum
    var = (((advantages - mu) ** 2) * weights).sum() / wsum
    return (advantages - mu) / torch.sqrt(var + 1e-8)


def batched_gae(rewards: torch.Tensor, dones: torch.Tensor,
                values: torch.Tensor, gamma: float, tau: float):
    """GAE over the (T, B) rollout, episode boundaries cut by dones.
    Returns (advantages, returns)."""
    return gae_with_masks(rewards, 1.0 - dones.to(torch.float32), values,
                          gamma, tau)


def gae_with_masks(rewards: torch.Tensor, masks: torch.Tensor,
                   values: torch.Tensor, gamma: float, tau: float):
    """Reverse GAE pass over the leading (time) axis of (T, B) arrays:
    delta_t = r_t + gamma V_{t+1} m_t - V_t, A_t = delta_t + gamma tau
    A_{t+1} m_t. Returns (advantages, returns)."""
    B = rewards.shape[1]
    prev_value = torch.zeros(B, dtype=values.dtype, device=values.device)
    prev_adv = torch.zeros_like(prev_value)
    advantages = torch.empty_like(values)
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
        prev_adv = delta + gamma * tau * prev_adv * masks[t]
        prev_value = values[t]
        advantages[t] = prev_adv
    return advantages, values + advantages
