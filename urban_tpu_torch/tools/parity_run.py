"""The learning-parity run: the JAX package's PPO recipe (BASELINE.md,
"PPO training on TPU") through the port's trainer CLI, in chunks.

Runs ``urban_tpu_torch.rl.trainer.main`` with the recipe's flags

    --cfg hlg --num_envs 256 --eval_envs 64 --global_seed 111
    --normalize_advantages --tau 0.95

for iterations [start, --iterations), start being 0 or the iteration after
the ``--resume`` checkpoint's. A resumed chunk restarts the env batch and
the random stream from the seed, as the JAX trainer does. Flags after the
tool's own go to the trainer after the recipe's, and argparse keeps the
last value of a flag, so they override it. Another scenario: its
``--cfg`` and ``--num_envs`` after the tool's flags (Huizhou's round-5
recipe: ``--cfg huizhou --num_envs 192``, 300 iterations). A CPU
rehearsal: ``--device cpu --num_envs 2 --eval_envs 1 --rollout_len 8``.

Grid's two-phase curriculum: ``--cfg grid --num_envs 192
--separate_train`` (the trainer's land use, the freeze of the best greedy
plan, then roads, warm-started from phase 1's best parameters unless
``--no-warm_start_phase2``). ``--iterations`` then counts a phase: phase 1
runs iterations [0, n), phase 2 [n, 2n). A chunk may end in either phase;
a phase-2 ``final.pt`` holds the frozen plan, and its resume re-enters
phase 2 on it (a chunk cut at phase 2's first iteration saves the
warm-started parameters with iteration n - 1).

``--init_params FILE`` starts the run from the parameters of an .npz of a
Flax tree (``results/hlg_jax_init_seed111.npz``: the JAX trainer's initial
draw at the recipe's seed) in place of the port's own draw; all else
starts as a fresh run does (Adam empty, iteration 0, no best plan, the
env batch and the stream from the seed). A resumed chunk takes its
checkpoint's parameters as before. ``--encoder_operands bf16`` goes to the
trainer: the SGNN's gather and segment-mean operands rounded to bf16, as
the JAX encoder's default backend rounds them. ``--bf16_linear_operands``
is this tool's own approximation of the platform JAX's recorded run was
on, a TPU, whose f32 matmuls at the default precision multiply bf16
operands: every ``nn.Linear`` of the process rounds its input, its weight
and, in the backward, its output gradient to bf16 and sums in f32 (the
attention's two einsums are left in f32). Neither the package nor its
other entry points use it.

``--stats`` (JSON lines) gets one record per iteration as it completes
(a chunk cut by a time limit keeps what it ran): its TrainStats
(T_sample, T_update, T_eval, rewards, losses, failure causes, kernel
launches), the trainer's phase, the value-vs-Monte-Carlo RMS, the best
eval so far and the iteration's own peak device memory (allocated and
reserved, the peaks reset as each iteration starts; also a line of the
trainer's log) and,
on a scenario with planning concepts, the seconds the concept reward
took in the collect and in the eval (``concept_reward_s``: each call of
``torchenv.step.concept_reward``, which runs eagerly where an episode's
land use ends, timed between device synchronizations; on that line of
the log too), and on a scenario that plans roads, in its road phase, the
seconds of the road-network reward the same way (``road_reward_s``: each
call of ``batched_road_network_reward`` from the rollout's stage rewards
and from the eval's reward channels); then
one summary record: the flags as given (``argv``, the recipe's first),
the values the trainer ran with (``effective``: cfg, envs, rollout window,
eval envs, seed, encoder and its operands, tau, lr, normalized
advantages, separate_train, warm_start_phase2), the chunk's wall seconds,
its iterations, the phase it ended in, phase 1's best greedy eval
(``phase1``: best_reward and best_iteration from ``phase1_final.pt``,
since the freeze resets the trainer's; None before phase 1 has ended),
the warm start (``warm_start``: tensors copied, of all), the chunk's peak
device memory, and the card's name and power limit (nvidia-smi).

``--deadline SECONDS`` ends a chunk early where the next iteration would
not end in time: before each iteration but its first, if the seconds
since the trainer started plus 1.25 times the last iteration's would pass
the deadline, the chunk stops there and saves ``final.pt`` of the last
iteration it ran, as a chunk whose ``--iterations`` were that one's next
would (the summary's ``stopped_at_deadline``). A call with a time limit
then loses no iteration to it, and the next chunk resumes from
``final.pt``.

    python -m urban_tpu_torch.tools.parity_run --iterations 80 \\
        --root_dir DIR --stats chunk1.jsonl
    python -m urban_tpu_torch.tools.parity_run --iterations 200 \\
        --root_dir DIR --resume DIR/hlg/111/models/final.pt \\
        --stats chunk2.jsonl
    python -m urban_tpu_torch.tools.parity_run --iterations 200 \\
        --root_dir DIR --stats grid1.jsonl --deadline 3400 \\
        --cfg grid --num_envs 192 --separate_train
    python -m urban_tpu_torch.tools.parity_run --iterations 80 \\
        --root_dir DIR --stats armb.jsonl \\
        --init_params results/hlg_jax_init_seed111.npz \\
        --bf16_linear_operands --encoder_operands bf16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from typing import Optional

import torch
import torch.nn.functional as F

from urban_tpu_torch.models.convert import load_flax_npz
from urban_tpu_torch.models.encoder import round_operand
from urban_tpu_torch.rl import trainer as trainer_mod
from urban_tpu_torch.torchenv import rollout as rollout_mod
from urban_tpu_torch.torchenv import step as step_mod

RECIPE = ['--cfg', 'hlg', '--num_envs', '256', '--eval_envs', '64',
          '--global_seed', '111', '--normalize_advantages', '--tau', '0.95']


def card_name_and_power():
    """nvidia-smi's name and power limit of the cards, or None without
    one."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


class Bf16OperandLinear(torch.autograd.Function):
    """x @ w.T + b with bf16-rounded operands summed in f32, forward and
    backward (each of the three matmuls rounds its two operands)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        x16, w16 = round_operand(x, 'bf16'), round_operand(weight, 'bf16')
        ctx.save_for_backward(x16, w16)
        ctx.has_bias = bias is not None
        return F.linear(x16, w16, bias)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g16 = round_operand(g, 'bf16')
        gx = g16 @ w16
        gw = g16.reshape(-1, g16.shape[-1]).T @ x16.reshape(-1,
                                                          x16.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def bf16_linear_forward(self, x):
    return Bf16OperandLinear.apply(x, self.weight, self.bias)


def peak_memory(device) -> dict:
    """The device's peak allocated and reserved bytes since the last
    reset of the peaks."""
    return {'allocated': torch.cuda.max_memory_allocated(device),
            'reserved': torch.cuda.max_memory_reserved(device)}


class ChunkDeadline(Exception):
    """The next iteration would not end before the chunk's deadline."""


class StageRewardTimer:
    """Stands in for a stage reward function: the same reward, and the
    seconds of each call, from a device synchronization before it to one
    after it, added up under the part of the iteration running ('collect'
    while Trainer.collect runs, else 'eval': the update computes no
    reward)."""

    def __init__(self, reward_fn):
        self.reward_fn = reward_fn
        self.part = 'eval'
        self.reset()

    def reset(self):
        self.seconds = {'collect': 0.0, 'eval': 0.0}
        self.calls = {'collect': 0, 'eval': 0}

    def __call__(self, spec, state, *args, **kwargs):
        device = state.poly_alive.device
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = self.reward_fn(spec, state, *args, **kwargs)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.seconds[self.part] += time.perf_counter() - t0
        self.calls[self.part] += 1
        return out


class ConceptTimer(StageRewardTimer):
    """In step.concept_reward's place: the planning-concept term, computed
    where an episode's land use ends."""


def effective_values(trainer) -> dict:
    """What the trainer ran with, read after the CLI's parsing."""
    cfg = trainer.cfg
    return {'cfg': cfg.id, 'num_envs': trainer.num_envs,
            'rollout_len': trainer.rollout_len,
            'eval_envs': trainer.eval_envs, 'seed': cfg.seed,
            'encoder': trainer.encoder,
            'encoder_operands': trainer.encoder_operands,
            'tau': cfg.tau, 'lr': cfg.lr,
            'normalize_advantages': bool(cfg.agent_specs.get(
                'normalize_advantages', False)),
            'separate_train': trainer.separate_train,
            'warm_start_phase2': trainer.warm_start_phase2,
            'device': str(trainer.device)}


def phase1_best(trainer) -> Optional[dict]:
    """The land-use phase's best greedy eval (best_reward, best_iteration)
    from the run's phase1_final.pt, which the freeze's reset leaves as the
    only record of it; None before phase 1 has ended."""
    path = os.path.join(trainer.cfg.model_dir, 'phase1_final.pt')
    if not trainer.separate_train or not os.path.exists(path):
        return None
    ckpt = trainer_mod.read_checkpoint(path)
    return {'best_reward': ckpt['best_reward'],
            'best_iteration': ckpt['best_iteration'],
            'iteration': ckpt['iteration']}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iterations', type=int, required=True,
                    help='The chunk ends before this iteration (with '
                    '--separate_train: the iterations of a phase).')
    ap.add_argument('--root_dir', required=True)
    ap.add_argument('--resume', default='')
    ap.add_argument('--stats', required=True, help='JSON-lines output.')
    ap.add_argument('--init_params', default='',
                    help='An .npz of a Flax parameter tree to start from.')
    ap.add_argument('--bf16_linear_operands', action='store_true',
                    help='Round every nn.Linear\'s operands to bf16 (an '
                    'approximation of a TPU\'s default f32 matmuls).')
    ap.add_argument('--deadline', type=float, default=0.0,
                    help='Seconds from the trainer\'s start: stop the chunk '
                    'before an iteration that would end past them (0: '
                    'none).')
    a, extra = ap.parse_known_args(argv)
    argv = RECIPE + ['--iterations', str(a.iterations),
                     '--root_dir', a.root_dir] + extra
    if a.resume:
        argv += ['--resume', a.resume]

    init_model = trainer_mod.Trainer._init_model
    linear_forward = torch.nn.Linear.forward
    collect = trainer_mod.Trainer.collect
    concept_reward = step_mod.concept_reward
    concept = ConceptTimer(concept_reward)
    road_reward = rollout_mod.batched_road_network_reward
    # in batched_road_network_reward's place where the rollout's stage
    # rewards and the eval's reward channels look it up
    road = StageRewardTimer(road_reward)

    def timed_collect(self):
        concept.part = road.part = 'collect'
        try:
            return collect(self)
        finally:
            concept.part = road.part = 'eval'

    def init_from_file(self):
        init_model(self)
        load_flax_npz(self.model, a.init_params)

    os.makedirs(os.path.dirname(os.path.abspath(a.stats)), exist_ok=True)
    with open(a.stats, 'a') as out:
        train_iteration = trainer_mod.Trainer.train_iteration
        # the chunk's peaks before the iteration running now
        chunk_peak = {'allocated': 0, 'reserved': 0}
        # the trainer, and the seconds its last iteration took
        running = {'trainer': None, 'last_s': 0.0}

        def recorded(self, iteration, do_eval=True):
            running['trainer'] = self
            t_start = time.perf_counter()
            if a.deadline and self.history and (
                    t_start - t0 + 1.25 * running['last_s'] > a.deadline):
                raise ChunkDeadline(iteration)
            cuda = self.device.type == 'cuda'
            if cuda:
                for k, v in peak_memory(self.device).items():
                    chunk_peak[k] = max(chunk_peak[k], v)
                torch.cuda.reset_peak_memory_stats(self.device)
            concept.reset()
            road.reset()
            st = train_iteration(self, iteration, do_eval)
            peak = peak_memory(self.device) if cuda else dict.fromkeys(
                chunk_peak)
            has_concepts = bool(self.spec.concepts)
            has_roads = bool(self.spec.road_network_weight > 0
                             and not self.spec.skip_road)
            line = [str(iteration)]
            if cuda:
                line += [f'peak_allocated_GB {peak["allocated"] / 1e9:.3f}',
                         f'peak_reserved_GB {peak["reserved"] / 1e9:.3f}']
            if has_concepts:
                line.append(f'concept_reward_s collect '
                            f'{concept.seconds["collect"]:.3f} eval '
                            f'{concept.seconds["eval"]:.3f}')
            if has_roads:
                line.append(f'road_reward_s collect '
                            f'{road.seconds["collect"]:.3f} eval '
                            f'{road.seconds["eval"]:.3f}')
            if len(line) > 1:
                self.logger.info('\t'.join(line))
            out.write(json.dumps(dict(
                dataclasses.asdict(st), phase=self.phase,
                value_mc_rms=self.last_value_mc_rms,
                best_reward=self.best_reward,
                best_iteration=self.best_iteration,
                peak_allocated_bytes=peak['allocated'],
                peak_reserved_bytes=peak['reserved'],
                **({'concept_reward_s': dict(concept.seconds),
                    'concept_reward_calls': dict(concept.calls)}
                   if has_concepts else {}),
                **({'road_reward_s': dict(road.seconds),
                    'road_reward_calls': dict(road.calls)}
                   if has_roads else {}))) + '\n')
            out.flush()
            running['last_s'] = time.perf_counter() - t_start
            return st

        trainer_mod.Trainer.train_iteration = recorded
        trainer_mod.Trainer.collect = timed_collect
        step_mod.concept_reward = concept
        rollout_mod.batched_road_network_reward = road
        trainer_mod.batched_road_network_reward = road
        if a.init_params:
            trainer_mod.Trainer._init_model = init_from_file
        if a.bf16_linear_operands:
            torch.nn.Linear.forward = bf16_linear_forward
        t0 = time.perf_counter()
        stopped = False
        try:
            trainer = trainer_mod.main(argv)
        except ChunkDeadline:
            trainer, stopped = running['trainer'], True
            trainer.save_checkpoint(trainer.history[-1].iteration,
                                    tag='final')
        finally:
            trainer_mod.Trainer.train_iteration = train_iteration
            trainer_mod.Trainer.collect = collect
            step_mod.concept_reward = concept_reward
            rollout_mod.batched_road_network_reward = road_reward
            trainer_mod.batched_road_network_reward = road_reward
            trainer_mod.Trainer._init_model = init_model
            torch.nn.Linear.forward = linear_forward
        wall = time.perf_counter() - t0
        cuda = trainer.device.type == 'cuda'
        if cuda:
            for k, v in peak_memory(trainer.device).items():
                chunk_peak[k] = max(chunk_peak[k], v)
        summary = {
            'argv': argv, 'effective': effective_values(trainer),
            'init_params': a.init_params or None,
            'bf16_linear_operands': a.bf16_linear_operands, 'wall_s': wall,
            'iterations': [h.iteration for h in trainer.history],
            'best_reward': trainer.best_reward,
            'best_iteration': trainer.best_iteration,
            'phase': trainer.phase,
            'phase1': phase1_best(trainer),
            'warm_start': (list(trainer.warm_start) if trainer.warm_start
                           else None),
            'stopped_at_deadline': stopped,
            'peak_allocated_bytes': (chunk_peak['allocated'] if cuda
                                     else None),
            'peak_reserved_bytes': (chunk_peak['reserved'] if cuda
                                    else None),
            'card': card_name_and_power() if cuda else None}
        out.write(json.dumps({'summary': summary}) + '\n')
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
