"""The port's graft entry points: one batched environment and
policy step, and a data-parallel dry run (counterparts of the root
``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``).

    python -m urban_tpu_torch.graft_entry [n] [--device cuda|cpu]

runs ``entry()``'s step once, then ``dryrun_multichip(n)`` (n = 2 by
default): three sample -> GAE -> data-parallel update iterations of the
HLG trainer on n ranks, against the same iterations on one device. Both
run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from urban_tpu_torch import bench
from urban_tpu_torch.models.policy import RowShard
from urban_tpu_torch.parallel.mesh import (Mesh, check_replicated,
                                           make_dp_ppo_update, make_mesh,
                                           replicate, shard_batch, spawn)
from urban_tpu_torch.rl.ppo import PPOConfig, make_optimizer
from urban_tpu_torch.torchenv.program import StepProgram
from urban_tpu_torch.torchenv.rollout import (batched_gae, broadcast_state,
                                              episode_success_weights,
                                              make_batch_fns, rollout)

GATE = 5e-2     # dp=n vs dp=1 loss trajectories: max relative difference


def _setup(num_envs: int, device):
    """(cfg, spec, initial state, model from seed 0, num_envs finished
    states) of the HLG trainer (the JAX trainer's capacities) on
    `device`."""
    if torch.device(device).type == 'cuda':
        bench.set_precision_flags()
    cfg, spec, init_state = bench.setup('hlg', {}, device)
    model = bench.make_model(cfg, spec, seed=0, device=device)
    states = broadcast_state(init_state.replace(
        done=torch.ones_like(init_state.done)), num_envs)
    return cfg, spec, init_state, model, states


def entry(device='cuda'):
    """One batched environment and policy step of the flagship model, B =
    8: the observation, the SGNN policy's action / log-prob / value
    (sample_action_logp_value) and the step. Returns (fn, args); fn(*args)
    gives (reward, done, value)."""
    B = 8
    _, spec, _, model, states = _setup(B, device)
    batch_obs, batch_step = make_batch_fns(spec)
    use_mean = torch.zeros(B, dtype=torch.bool, device=device)

    @torch.no_grad()
    def forward_step(states, generator):
        obs = batch_obs(states)
        action, log_prob, value = model.sample_action_logp_value(
            obs, generator, use_mean)
        next_states, reward, done, info = batch_step(states, action)
        return reward, done, value

    return forward_step, (states,
                          torch.Generator(device=device).manual_seed(0))


def _train_trajectory(mesh: Mesh, B: int, T: int, iters: int):
    """`iters` sample -> GAE -> data-parallel update iterations of B envs x
    T steps, this rank's B / world envs; returns the (loss, grad_norm) of
    each update. The random stream does not depend on the world size, so
    every world computes the same thing partitioned differently."""
    cfg, spec, init_state, model, states = _setup(B, mesh.device)
    states = states.map(lambda x: shard_batch(mesh, x))
    ppo_cfg = PPOConfig(lr=cfg.lr, clip_epsilon=cfg.clip_epsilon)
    optimizer = make_optimizer(model.parameters(), ppo_cfg)
    replicate(mesh, model, optimizer)
    step = make_dp_ppo_update(model, optimizer, ppo_cfg, mesh)
    generator = torch.Generator(device=mesh.device).manual_seed(0)
    if mesh.world_size > 1:
        generator = RowShard(generator, mesh.block(B).start, B)
    program = StepProgram(spec, model, init_state, states.stage.shape[0],
                          'collect', generator)
    losses, gnorms = [], []
    for _ in range(iters):
        states, traj = rollout(spec, model, init_state, states, generator, T,
                               program=program)
        weights = episode_success_weights(traj.dones, traj.failures)
        if not float(mesh.all_reduce(weights.sum())) > 0:
            # T is far below the episode length, so no episode completes
            # and the success filter zeroes every row, which would certify
            # a no-op update: take every sampled row as valid instead
            weights = torch.ones_like(weights)
        advantages, returns = batched_gae(traj.rewards, traj.dones,
                                          traj.values, cfg.gamma, cfg.tau)
        n = traj.rewards.numel()
        stats = step(tuple(o.reshape((n,) + o.shape[2:]) for o in traj.obs),
                     traj.actions.reshape(n, 2), returns.reshape(n, 1),
                     advantages.reshape(n, 1), traj.log_probs.reshape(n, 1),
                     (traj.exps * weights).reshape(n), weights.reshape(n))
        losses.append(float(stats['loss']))
        gnorms.append(float(stats['grad_norm']))
    check_replicated(mesh, model)
    return losses, gnorms


def dryrun_multichip(n_devices: int, device='cuda', timeout=None,
                     rendezvous_dir=None) -> dict:
    """The full training step data parallel over n_devices ranks (spawned;
    on one card they share it through gloo): 2 envs a rank, 3 steps, 3
    iterations, then the same on one device. Every loss must be finite
    and nonzero, every gradient norm nonzero, and the two loss
    trajectories within GATE (the JAX dry run's gate). `timeout` and
    `rendezvous_dir` go to spawn. Prints the table; returns the
    trajectories and the largest relative difference."""
    B, T, iters = 2 * n_devices, 3, 3
    t0 = time.time()
    losses_n, gnorms_n = spawn(_train_trajectory, n_devices, device,
                               args=(B, T, iters), timeout=timeout,
                               rendezvous_dir=rendezvous_dir)[0]
    t1 = time.time()
    losses_1, gnorms_1 = _train_trajectory(make_mesh(1, device), B, T, iters)
    print(f'[timing] dp={n_devices} trajectory {t1 - t0:.1f}s, dp=1 '
          f'trajectory {time.time() - t1:.1f}s')
    print(f'dryrun_multichip({n_devices}): {iters} train iterations of '
          f'{T}x{B} steps each on {device}')
    print('iter |   dp=%d loss |   dp=1 loss | rel diff | dp=%d |grad|'
          % (n_devices, n_devices))
    rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(losses_n, losses_1)]
    for i, (a, b, r, g) in enumerate(zip(losses_n, losses_1, rel, gnorms_n)):
        print(f'{i:4d} | {a:11.6f} | {b:11.6f} | {r:8.2e} | {g:10.4f}')
    for i, (loss, gn) in enumerate(zip(losses_n, gnorms_n)):
        if not (math.isfinite(loss) and loss != 0.0 and gn > 0.0):
            raise AssertionError(f'dp update {i}: loss {loss}, gradient '
                                 f'norm {gn}: the dry run must exercise '
                                 f'real updates, not no-ops')
    if not max(rel) < GATE:
        raise AssertionError(f'dp={n_devices} vs dp=1 loss trajectories '
                             f'diverged (max rel diff {max(rel):.3e})')
    print(f'dp={n_devices} vs dp=1 loss trajectory agreement OK (max rel '
          f'diff {max(rel):.2e})')
    return {'losses': losses_n, 'losses_dp1': losses_1,
            'grad_norms': gnorms_n, 'grad_norms_dp1': gnorms_1,
            'max_rel_diff': max(rel)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n', nargs='?', type=int, default=2,
                    help='Data-parallel ranks of the dry run.')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print('entry forward step OK', [tuple(x.shape) for x in out])
    dryrun_multichip(a.n, a.device)


if __name__ == '__main__':
    main()
