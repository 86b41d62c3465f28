"""Batched rollouts, and the per-step advantage and weight passes of the
trainer (counterpart of urban_tpu/jaxenv/rollout.py).

The per-environment step and observation functions are lifted over a
leading environment axis with ``torch.func.vmap``. Where JAX jits a
``lax.scan`` of the vmapped step, the rollouts here loop over time in
Python around one ``StepProgram`` (``program.py``): on the card its step
is a captured CUDA graph, replayed once a step; finished environments
auto-reset to the initial state inside it. Stage-boundary rewards run
outside the graph, only on steps where some environment finished a stage
and only for those environments: a host sync per step and stage (``if
mask.any()``) stands in for the JAX batch-level ``lax.cond``. GAE and the
success weights are reverse loops.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.func import vmap

from urban_tpu_torch.torchenv.program import (StepProgram, broadcast_state,
                                              reset_done)
from urban_tpu_torch.torchenv.state import FIELD_NAMES, EnvSpec, PlanState
from urban_tpu_torch.torchenv.step import (FAILURE_BIT_NAMES,
                                           batched_road_network_reward,
                                           build_obs, env_step, feature_alive,
                                           land_use_stage_reward,
                                           packed_edge_ok)


def packed_action_to_slots(spec: EnvSpec, state: PlanState,
                           action: torch.Tensor) -> torch.Tensor:
    """Translate the indices of a packed-layout action (build_obs_packed)
    to slot indices; the rollout's slot-layout actions need no translation."""
    alive = feature_alive(spec, state)
    e_rank = torch.cumsum(packed_edge_ok(spec, state, alive).to(torch.int64),
                          0)
    n_rank = torch.cumsum(alive.to(torch.int64), 0)
    edge_slot = torch.searchsorted(e_rank, (action[0] + 1).reshape(1).long())
    node_slot = torch.searchsorted(n_rank, (action[1] + 1).reshape(1).long())
    return torch.cat([torch.clamp(edge_slot, 0, spec.NE - 1),
                      torch.clamp(node_slot, 0, spec.num_features - 1)]).to(
        torch.int32)


def make_batch_fns(spec: EnvSpec, defer_rewards: bool = True):
    """Batched observation and step functions (slot-layout actions).

    With defer_rewards the step leaves stage-boundary rewards to
    ``apply_stage_rewards``. Without, the step returns them as the JAX
    step with compute_rewards does: the vmapped step is followed by a
    batched pass of the stage rewards (the road-network reward cannot run
    under vmap), which also caches the land-use reward of an env that
    failed on the step that ended its land use."""
    batch_obs = vmap(lambda s: build_obs(spec, s))
    batch_step = vmap(lambda s, a: env_step(spec, s, a,
                                            compute_rewards=False))
    if defer_rewards:
        return batch_obs, batch_step

    def step_with_rewards(states: PlanState, actions: torch.Tensor):
        nxt, reward, done, info = batch_step(states, actions)
        nxt, reward = apply_stage_rewards(spec, nxt, reward, info,
                                          cache_failed=True)
        return nxt, reward, done, dict(info,
                                       land_use_reward=nxt.land_use_reward)
    return batch_obs, step_with_rewards


def _on_finished(fn, states: PlanState, finished: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """fn(states) at the rows where finished, zeros elsewhere. fn runs on
    those rows only: each env's reward depends on its own state alone, and
    most steps finish few envs (this also bounds the reward's memory)."""
    out = torch.zeros_like(like)
    idx = torch.nonzero(finished).squeeze(1)
    out[idx] = fn(states.map(lambda x: x[idx])).to(out.dtype)
    return out


def apply_stage_rewards(spec: EnvSpec, states: PlanState, reward, info,
                        cache_failed: bool = False):
    """Stage-boundary rewards for the environments that just finished a
    stage without failing: the land-use reward (also cached in the state)
    and, where the scenario plans roads, the weighted road-network reward.
    Each is computed when at least one env needs it (a host-synced branch,
    for the JAX code's batch-level lax.cond). With cache_failed the
    land-use reward is also cached for the envs that failed on the step
    that ended their land use (their reward stays FAILURE_REWARD)."""
    fail = info['failure']
    lu_fin = info['lu_done'] & ~fail
    lu_rows = info['lu_done'] if cache_failed else lu_fin
    if bool(lu_rows.any()):
        lu_r = _on_finished(
            vmap(lambda s: land_use_stage_reward(spec, s)), states, lu_rows,
            reward)
        reward = torch.where(lu_fin, lu_r, reward)
        states = states.replace(land_use_reward=torch.where(
            lu_rows, lu_r, states.land_use_reward))
    if spec.road_network_weight > 0 and not spec.skip_road:
        rd_fin = info['rd_done'] & ~fail
        if bool(rd_fin.any()):
            rd_r = _on_finished(
                lambda s: spec.road_network_weight
                * batched_road_network_reward(spec, s), states, rd_fin,
                reward)
            reward = torch.where(rd_fin, rd_r, reward)
    return states, reward


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
                  num_steps: int, record: list = None, eager: bool = False,
                  program: StepProgram = None):
    """Throughput rollout: no trajectory storage, only episode statistics.
    Returns (final_state, n_episodes, n_failures, success_reward_sum,
    failure-bit histogram), the counters as device tensors. With a list
    as `record`, each step appends (action, was_reset, done, failure) to
    it (was_reset: the env restarted from the initial state this step).
    The step is `program` (a 'bench' StepProgram of this batch and
    generator), else a new one: captured on the card unless eager."""
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    program = program or StepProgram(spec, model, init_state, B, 'bench',
                                     generator, eager=eager)
    state = start_state
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
    code_hist = torch.zeros(len(FAILURE_BIT_NAMES), dtype=torch.int64,
                            device=dev)
    for _ in range(num_steps):
        out = program.run(state)
        done, info = out['done'], out['info']
        state, reward = apply_stage_rewards(spec, out['state'],
                                            out['reward'], info)
        if record is not None:
            record.append(tuple(x.clone() for x in (
                out['action'], out['was_reset'], done, info['failure'])))
        n_eps = n_eps + done.sum()
        n_fail = n_fail + info['failure'].sum()
        code_hist = code_hist + failure_histogram(info['failure_code'])
        reward_sum = reward_sum + torch.where(done & ~info['failure'],
                                              reward, 0.0).sum()
    # the step's outputs are the program's buffers: return a copy
    return state.map(torch.clone), n_eps, n_fail, reward_sum, code_hist


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
            num_steps: int, noise_rate: float = 1.0, eager: bool = False,
            program: StepProgram = None):
    """Collect (T, B) trajectories with auto-reset, stored on the states'
    device. A row explores (samples its action) where a uniform draw is
    below noise_rate; otherwise it takes the argmax. `generator` may be a
    data-parallel rank's RowShard of the batch-wide stream. The step is
    `program` (a 'collect' StepProgram of this batch, generator and
    noise_rate), else a new one: captured on the card unless eager.
    Returns (final_states, Trajectory)."""
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    program = program or StepProgram(spec, model, init_state, B, 'collect',
                                     generator, noise_rate, eager=eager)

    def buffer(x):
        return torch.empty((num_steps,) + tuple(x.shape), dtype=x.dtype,
                           device=dev)

    state, bufs = start_state, None
    for t in range(num_steps):
        out = program.run(state)
        info = out['info']
        state, reward = apply_stage_rewards(spec, out['state'],
                                            out['reward'], info)
        row = (*out['obs'], out['action'], out['log_prob'], out['value'],
               reward, out['done'], info['failure'], out['explored'],
               info['failure_code'])
        if bufs is None:
            bufs = [buffer(x) for x in row]
        for buf, x in zip(bufs, row):
            buf[t].copy_(x)
    n_obs = len(bufs) - 8
    return (state.map(torch.clone),
            Trajectory(tuple(bufs[:n_obs]), *bufs[n_obs:]))


@torch.no_grad()
def eval_rollout(spec: EnvSpec, model, start_state: PlanState,
                 generator: torch.Generator, num_steps: int,
                 eager: bool = False, program: StepProgram = None):
    """Greedy evaluation episodes: B fresh envs stepped with argmax actions
    and frozen once done (no auto-reset), so the terminal plan states
    survive for scoring. The freeze follows the stage rewards, outside the
    step: a frozen env's discarded step must not cache a reward into the
    state it keeps. The step is `program` (an 'eval' StepProgram of this
    batch and generator), else a new one: captured on the card unless
    eager. Returns (final_states, total_reward (B,), done (B,), failure
    (B,))."""
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    program = program or StepProgram(spec, model,
                                     start_state.map(lambda x: x[0]), B,
                                     'eval', generator, eager=eager)
    state = start_state
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        out = program.run(state)
        nxt, reward = apply_stage_rewards(spec, out['state'], out['reward'],
                                          out['info'])
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


def normalize_advantages(advantages: torch.Tensor, weights: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Standardize advantages over the rows that train (weights > 0); with
    a process group, over the rows of every rank (each weighted sum is
    all-reduced before it divides)."""
    sums = torch.stack([weights.sum(), (advantages * weights).sum()])
    if group is not None:
        dist.all_reduce(sums, group=group)
    wsum = torch.clamp_min(sums[0], 1.0)
    mu = sums[1] / wsum
    var = (((advantages - mu) ** 2) * weights).sum()
    if group is not None:
        dist.all_reduce(var, group=group)
    return (advantages - mu) / torch.sqrt(var / wsum + 1e-8)


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
