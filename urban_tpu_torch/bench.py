"""Batched rollout throughput of the port: the SGNN policy sampling in the
loop with the batched environment, by default the same scenario (HLG),
capacities and model as the JAX package's root bench.py; and, with
--train, one PPO train_iteration of a scenario's trainer (the JAX
trainer's capacities). --cfg names the scenario (hlg, grid, dhm, ...).

    python -m urban_tpu_torch.bench --num_envs 256 --num_steps 30 --device cuda
    python -m urban_tpu_torch.bench --train --num_envs 256 --rollout_len 50
    python -m urban_tpu_torch.bench --train --cfg grid --num_envs 192 \
        --rollout_len 120

prints one JSON line of the statistics. A rate measured on a CPU says
nothing about the card; the result names the device it ran on. After the
rollout (not with --train or --profile) the failing episodes of the same
corpus, and a sample of its successes, are replayed through the host
oracle (tools/replay_failures.py; --skip_replay leaves that out, and
--replay_budget_s bounds it): the result gains failure_replay,
failure_host_confirmed_pct and host_vs_jit_failure_ratio, as root
bench.py's detail block does. An error in the replay fails the run.
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


def default_caps(name: str) -> dict:
    """The rollout bench's capacities: root bench.py's for HLG, the JAX
    trainer's defaults (no caps) for the other scenarios."""
    return BENCH_CAPS if name == 'hlg' else {}


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
        max_sequence_length=cfg.get('max_sequence_length', 100),
        lr=cfg.get('lr', 4e-4), clip_epsilon=cfg.get('clip_epsilon', 0.2),
        gamma=cfg.get('gamma', 0.99), tau=cfg.get('tau', 0.95))


@functools.lru_cache(maxsize=8)
def _scenario(name: str, caps: tuple):
    cfg = load_config(name)
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length,
                          caps=dict(caps))
    return cfg, spec, build_initial_state(spec, plc, device='cpu')


def setup(name: str = 'hlg', caps=None, device='cuda'):
    """(cfg, spec, initial state on `device`: the card unless the caller
    asks for the CPU) for a scenario, at default_caps(name) unless caps
    are given; the host build runs once per process."""
    caps = default_caps(name) if caps is None else caps
    cfg, spec, state = _scenario(name, tuple(sorted(caps.items())))
    return cfg, spec, state.map(lambda x: x.to(device))


def make_model(cfg, spec, seed: int = 0, device='cuda',
               encoder: str = 'sgnn'):
    """The actor-critic (the SGNN unless encoder is 'mlp') at the config's
    widths, random weights from `seed`, graph caps from the env spec, on
    `device` (the card unless the caller asks for the CPU)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = create_model(cfg, spec.num_features, spec.NE, encoder)
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
                      device='cuda', seed: int = 0, name: str = 'hlg') -> dict:
    """One batched rollout of scenario `name`, num_envs x num_steps, every
    env starting fresh; returns env steps/s and the episode statistics."""
    set_precision_flags()
    device = torch.device(device)
    build_kernels(device)
    cfg, spec, init_state = setup(name, device=device)
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
        'cfg': name, 'num_envs': num_envs, 'num_steps': num_steps,
        'seconds': dt, 'env_steps_per_sec': num_envs * num_steps / dt,
        'episodes': eps, 'failures': fails, 'failure_causes': causes,
        'mean_episode_reward': float(r_sum) / max(eps - fails, 1),
        'overflow_failures': overflow,
        'overflow_gate_1pct_pass': overflow <= 0.01 * max(eps, 1),
    }


def run_failure_replay(num_envs: int = 256, num_steps: int = 30,
                       device='cuda', seed: int = 0, name: str = 'hlg',
                       budget_s: float = 300.0, n_success: int = 12) -> dict:
    """The replay keys of root bench.py's detail block for the corpus of
    run_rollout_bench(num_envs, num_steps, device, seed, name): every
    failing episode and n_success successes replayed through the host
    oracle, within budget_s seconds of host time (the same budget and
    sample as root bench.py)."""
    from urban_tpu_torch.tools.replay_failures import run_corpus
    metrics, _, _ = run_corpus(name, B=num_envs, T=num_steps, seed=seed,
                               budget_s=budget_s, n_success=n_success,
                               verbose=False, device=device)
    return {'failure_host_confirmed_pct':
            metrics['failure_host_confirmed_pct'],
            'host_vs_jit_failure_ratio': metrics['host_vs_jit_failure_ratio'],
            'failure_replay': metrics}


def make_trainer(num_envs: int = 256, rollout_len: int = 50, device='cuda',
                 seed: int = 0, eval_envs: int = 16, root_dir: str = None,
                 name: str = 'hlg'):
    """The PPO trainer of scenario `name` at the JAX trainer's own
    capacities; its run logs go under root_dir (default: the temp
    directory)."""
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import Trainer
    set_precision_flags()
    root_dir = root_dir or os.path.join(tempfile.gettempdir(),
                                        'urban_tpu_torch')
    cfg = Config(name, seed, tmp=False, root_dir=root_dir)
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
        'cfg': cfg.id,
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
                    device='cuda', seed: int = 0, name: str = 'hlg') -> dict:
    """One PPO train_iteration of scenario `name`'s trainer (no eval)."""
    return measure_train_iteration(make_trainer(num_envs, rollout_len,
                                                device, seed, name=name))


@torch.no_grad()
def profile_rollout(num_envs: int = 256, num_steps: int = 3, device='cuda',
                    seed: int = 0, name: str = 'hlg', warmup: int = 1) -> dict:
    """Where one rollout step's time goes, on a CUDA device, after `warmup`
    steps from fresh envs (auto-reset as in the rollout; many warm-up steps
    reach the steady state where episodes end and stage rewards run):
    host-clock time of each layer (observation, policy, env step, stage
    rewards) with a synchronize after each, then a torch.profiler trace of
    the same steps for the device's busy share, kernel launches per step
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                                  make_batch_fns, reset_done)
    set_precision_flags()
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('profile_rollout measures a CUDA device')
    build_kernels(device)
    cfg, spec, init_state = setup(name, device=device)
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
            for layer, a, b in zip(('obs', 'policy', 'env_step',
                                    'stage_rewards'), marks, marks[1:]):
                layers[layer] = layers.get(layer, 0.0) + (b - a)
        return state

    for _ in range(warmup):
        state = step(state)
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
        'device': torch.cuda.get_device_name(device), 'cfg': name,
        'num_envs': num_envs, 'warmup_steps': warmup, 'steps': num_steps,
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
    ap.add_argument('--cfg', default='hlg', help='scenario (config id)')
    ap.add_argument('--profile', action='store_true',
                    help='per-layer times and a device trace of num_steps '
                    'steps instead of the throughput run')
    ap.add_argument('--train', action='store_true',
                    help='one PPO train_iteration of num_envs x rollout_len '
                    'steps instead of the rollout')
    ap.add_argument('--rollout_len', type=int, default=50)
    ap.add_argument('--warmup', type=int, default=1,
                    help='--profile: steps before the profiled ones')
    ap.add_argument('--replay_budget_s', type=float, default=float(
        os.environ.get('BENCH_REPLAY_BUDGET_S', 300)),
                    help='host seconds for the failure replay (default: '
                    '$BENCH_REPLAY_BUDGET_S or 300)')
    ap.add_argument('--skip_replay', action='store_true',
                    help='no failure replay after the rollout')
    a = ap.parse_args()
    if a.train:
        out = run_train_bench(a.num_envs, a.rollout_len, a.device, a.seed,
                              a.cfg)
    elif a.profile:
        out = profile_rollout(a.num_envs, a.num_steps, a.device, a.seed,
                              a.cfg, a.warmup)
    else:
        out = run_rollout_bench(a.num_envs, a.num_steps, a.device, a.seed,
                                a.cfg)
        if not a.skip_replay:
            out.update(run_failure_replay(a.num_envs, a.num_steps, a.device,
                                          a.seed, a.cfg, a.replay_budget_s))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
