"""Batched rollouts (counterpart of urban_tpu/jaxenv/rollout.py).

The per-environment step and observation functions are lifted over a
leading environment axis with ``torch.func.vmap``; ``lax.scan`` over time
becomes a Python loop, and finished environments auto-reset to the initial
state. Stage-boundary rewards are evaluated only on steps where some
environment finished its land-use stage: one host sync per step
(``if mask.any()``) stands in for the JAX batch-level ``lax.cond``.
"""
from __future__ import annotations

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
    n_bits = len(FAILURE_BIT_NAMES)
    bits = torch.arange(n_bits, device=dev, dtype=torch.int32)[:, None]
    use_mean = torch.zeros(B, dtype=torch.bool, device=dev)

    state = start_state
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
    code_hist = torch.zeros(n_bits, dtype=torch.int64, device=dev)
    for _ in range(num_steps):
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        action, _, _ = model.sample_action_logp_value(obs, generator,
                                                      use_mean)
        state, reward, done, info = batch_step(state, action)
        state, reward = apply_stage_rewards(spec, state, reward, info)
        n_eps = n_eps + done.sum()
        n_fail = n_fail + info['failure'].sum()
        code_hist = code_hist + ((info['failure_code'][None, :] >> bits)
                                 & 1).sum(dim=1)
        reward_sum = reward_sum + torch.where(done & ~info['failure'],
                                              reward, 0.0).sum()
    return state, n_eps, n_fail, reward_sum, code_hist
