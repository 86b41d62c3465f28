"""Batched HLG rollout throughput of the port: the SGNN policy sampling in
the loop with the batched environment, the same scenario, capacities and
model as the JAX package's root bench.py; and, with --train, one PPO
train_iteration of the HLG trainer.

    python -m urban_tpu_torch.bench --num_envs 256 --num_steps 30 --device cuda
    python -m urban_tpu_torch.bench --train --num_envs 256 --rollout_len 50

prints one JSON line of the statistics. A rate measured on a CPU says
nothing about the card; the result names the device it ran on.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time
from types import SimpleNamespace

import torch

from urban_tpu_torch.host.envs.plan_client import PlanClient
from urban_tpu_torch.host.utils.io import load_yaml
from urban_tpu_torch.models.model import create_model
from urban_tpu_torch.torchenv.rollout import (broadcast_state, failure_causes,
                                              overflow_failures, rollout_bench)
from urban_tpu_torch.torchenv.state import build_env_spec, build_initial_state

# slot capacities of the HLG bench (root bench.py)
BENCH_CAPS = dict(KV=20, NP=256, NS=512, NPT=320, NE=2304)


def load_config(name: str) -> SimpleNamespace:
    """The experiment config fields the slice reads, with the defaults of
    host.utils.config.Config (which also creates run directories;
    this loader writes nothing)."""
    cfg = load_yaml(f'urban_tpu/cfg/**/{name}.yaml')
    return SimpleNamespace(
        objectives_plan=cfg.get('objectives_plan', ''),
        init_plan=cfg.get('init_plan', ''),
        reward_specs=cfg.get('reward_specs', dict()),
        skip_land_use=cfg.get('skip_land_use', False),
        skip_road=cfg.get('skip_road', False),
        road_ratio=cfg.get('road_ratio', 0.7),
        state_encoder_specs=cfg.get('state_encoder_specs', dict()),
        policy_specs=cfg.get('policy_specs', dict()),
        value_specs=cfg.get('value_specs', dict()),
        max_sequence_length=cfg.get('max_sequence_length', 100))


@functools.lru_cache(maxsize=8)
def _scenario(name: str, caps: tuple):
    cfg = load_config(name)
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length,
                          caps=dict(caps))
    return cfg, spec, build_initial_state(spec, plc)


def setup(name: str = 'hlg', caps=None, device='cuda'):
    """(cfg, spec, initial state on `device`: the card unless the caller
    asks for the CPU) for a scenario; the host build runs once per
    process."""
    caps = BENCH_CAPS if caps is None else caps
    cfg, spec, state = _scenario(name, tuple(sorted(caps.items())))
    return cfg, spec, state.map(lambda x: x.to(device))


def make_model(cfg, spec, seed: int = 0, device='cuda'):
    """The SGNN actor-critic at the config's widths, random weights from
    `seed`, graph caps from the env spec, on `device` (the card unless the
    caller asks for the CPU)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(cfg, spec.num_features, spec.NE)
    return model.to(device).eval()


def set_precision_flags() -> None:
    """Full f32 matmuls: TF32 would corrupt integer payloads above 2^10
    carried through float products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_kernels(device) -> None:
    """Build and load the kernel libraries before anything is timed: nvcc
    runs on a library's first use, which is set-up, not a step's or an
    iteration's time."""
    if torch.device(device).type == 'cuda':
        from urban_tpu_torch.ops import segment_ops
        for name in segment_ops.build_libraries():
            segment_ops.load_library(name)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_rollout_bench(num_envs: int = 256, num_steps: int = 30,
                      device='cuda', seed: int = 0) -> dict:
    """One batched HLG rollout of num_envs x num_steps, every env starting
    fresh; returns env steps/s and the episode statistics."""
    set_precision_flags()
    device = torch.device(device)
    build_kernels(device)
    cfg, spec, init_state = setup('hlg', BENCH_CAPS, device)
    model = make_model(cfg, spec, seed, device)
    start = broadcast_state(
        init_state.replace(done=torch.ones_like(init_state.done)), num_envs)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    _sync(device)
    t0 = time.perf_counter()
    _, n_eps, n_fail, r_sum, code_hist = rollout_bench(
        spec, model, init_state, start, gen, num_steps)
    _sync(device)
    dt = time.perf_counter() - t0
    eps, fails = int(n_eps), int(n_fail)
    causes = failure_causes(code_hist.cpu())
    overflow = overflow_failures(causes)
    return {
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        'num_envs': num_envs, 'num_steps': num_steps,
        'seconds': dt, 'env_steps_per_sec': num_envs * num_steps / dt,
        'episodes': eps, 'failures': fails, 'failure_causes': causes,
        'mean_episode_reward': float(r_sum) / max(eps - fails, 1),
        'overflow_failures': overflow,
        'overflow_gate_1pct_pass': overflow <= 0.01 * max(eps, 1),
    }


def make_trainer(num_envs: int = 256, rollout_len: int = 50, device='cuda',
                 seed: int = 0, eval_envs: int = 16, root_dir: str = None):
    """The HLG PPO trainer at the trainer's own capacities; its run logs
    go under root_dir (default: the temp directory)."""
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import Trainer
    set_precision_flags()
    root_dir = root_dir or os.path.join(tempfile.gettempdir(),
                                        'urban_tpu_torch')
    cfg = Config('hlg', seed, tmp=False, root_dir=root_dir)
    return Trainer(cfg, num_envs=num_envs, rollout_len=rollout_len,
                   eval_envs=eval_envs, device=device)


def measure_train_iteration(trainer) -> dict:
    """One train_iteration (collect + update, no eval): its phase times,
    the rates, the kernel launches of the iteration and the peak device
    memory."""
    from urban_tpu_torch.ops import segment_ops
    device = trainer.device
    build_kernels(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    segment_ops.reset_launches()
    st = trainer.train_iteration(0, do_eval=False)
    cfg = trainer.cfg
    n = trainer.num_envs * trainer.rollout_len
    mb_steps = cfg.num_optim_epoch * max(n // min(cfg.mini_batch_size, n), 1)
    overflow = overflow_failures(st.failure_causes)
    return {
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
        'num_envs': trainer.num_envs, 'rollout_len': trainer.rollout_len,
        'num_nodes': trainer.spec.num_features, 'num_edges': trainer.spec.NE,
        't_sample_s': st.sample_time, 't_update_s': st.update_time,
        'train_steps_per_sec': n / (st.sample_time + st.update_time),
        'update_minibatch_steps': mb_steps,
        'update_minibatch_steps_per_sec': mb_steps / st.update_time,
        'episodes': st.episodes, 'failures': st.failures,
        'failure_causes': st.failure_causes,
        'success_frac': st.success_frac,
        'mean_episode_reward': st.mean_episode_reward,
        'losses': st.losses, 'value_mc_rms': trainer.last_value_mc_rms,
        'overflow_failures': overflow,
        'overflow_gate_1pct_pass': overflow <= 0.01 * max(st.episodes, 1),
        'kernel_launches': dict(segment_ops.launches),
        'max_memory_allocated_bytes': (
            torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else None),
    }


def run_train_bench(num_envs: int = 256, rollout_len: int = 50,
                    device='cuda', seed: int = 0) -> dict:
    """One PPO train_iteration of the HLG trainer (no eval)."""
    return measure_train_iteration(make_trainer(num_envs, rollout_len,
                                                device, seed))


@torch.no_grad()
def profile_rollout(num_envs: int = 256, num_steps: int = 3, device='cuda',
                    seed: int = 0) -> dict:
    """Where one rollout step's time goes, on a CUDA device: host-clock
    time of each layer (observation, policy, env step, stage rewards) with
    a synchronize after each, then a torch.profiler trace of the same steps
    for the device's busy share, kernel launches per step and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                                  make_batch_fns, reset_done)
    set_precision_flags()
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('profile_rollout measures a CUDA device')
    build_kernels(device)
    cfg, spec, init_state = setup('hlg', BENCH_CAPS, device)
    model = make_model(cfg, spec, seed, device)
    init_b = broadcast_state(init_state, num_envs)
    state = init_b
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    batch_obs, batch_step = make_batch_fns(spec)
    use_mean = torch.zeros(num_envs, dtype=torch.bool, device=device)

    def step(state, layers=None):
        marks = [time.perf_counter()]

        def mark():
            if layers is not None:
                _sync(device)
                marks.append(time.perf_counter())
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        mark()
        action, _, _ = model.sample_action_logp_value(obs, gen, use_mean)
        mark()
        state, reward, _, info = batch_step(state, action)
        mark()
        state, _ = apply_stage_rewards(spec, state, reward, info)
        mark()
        if layers is not None:
            for name, a, b in zip(('obs', 'policy', 'env_step',
                                   'stage_rewards'), marks, marks[1:]):
                layers[name] = layers.get(name, 0.0) + (b - a)
        return state

    state = step(state)                       # warm-up
    layers = {}
    for _ in range(num_steps):
        state = step(state, layers)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(num_steps):
            state = step(state)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        'device': torch.cuda.get_device_name(device),
        'num_envs': num_envs, 'steps': num_steps,
        'layer_seconds_per_step': {k: v / num_steps
                                   for k, v in layers.items()},
        'profiled_wall_seconds_per_step': wall / num_steps,
        'device_busy_seconds_per_step': busy_us * 1e-6 / num_steps,
        'device_idle_share': 1.0 - busy_us * 1e-6 / wall,
        'kernel_launches_per_step': len(kernels) / num_steps,
        'top_kernels_ms_per_step': {k[:80]: v * 1e-3 / num_steps
                                    for k, v in top},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--num_envs', type=int, default=256)
    ap.add_argument('--num_steps', type=int, default=30)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true',
                    help='per-layer times and a device trace of num_steps '
                    'steps instead of the throughput run')
    ap.add_argument('--train', action='store_true',
                    help='one PPO train_iteration of num_envs x rollout_len '
                    'steps instead of the rollout')
    ap.add_argument('--rollout_len', type=int, default=50)
    a = ap.parse_args()
    if a.train:
        out = run_train_bench(a.num_envs, a.rollout_len, a.device, a.seed)
    else:
        fn = profile_rollout if a.profile else run_rollout_bench
        out = fn(a.num_envs, a.num_steps, a.device, a.seed)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
