"""The learning-parity run: the JAX package's HLG recipe (BASELINE.md,
"PPO training on TPU") through the port's trainer CLI, in chunks.

Runs ``urban_tpu_torch.rl.trainer.main`` with the recipe's flags

    --cfg hlg --num_envs 256 --eval_envs 64 --global_seed 111
    --normalize_advantages --tau 0.95

for iterations [start, --iterations), start being 0 or the iteration after
the ``--resume`` checkpoint's. A resumed chunk restarts the env batch and
the random stream from the seed, as the JAX trainer does. Flags after the
tool's own go to the trainer after the recipe's (a CPU rehearsal:
``--device cpu --num_envs 2 --eval_envs 1 --rollout_len 8``).

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
launches), the value-vs-Monte-Carlo RMS and the best eval so far; then
one summary record: the chunk's wall seconds, its iterations, the peak
device memory, and the card's name and power limit (nvidia-smi).

    python -m urban_tpu_torch.tools.parity_run --iterations 80 \\
        --root_dir DIR --stats chunk1.jsonl
    python -m urban_tpu_torch.tools.parity_run --iterations 200 \\
        --root_dir DIR --resume DIR/hlg/111/models/final.pt \\
        --stats chunk2.jsonl
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

import torch
import torch.nn.functional as F

from urban_tpu_torch.models.convert import load_flax_npz
from urban_tpu_torch.models.encoder import round_operand
from urban_tpu_torch.rl import trainer as trainer_mod

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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iterations', type=int, required=True,
                    help='The chunk ends before this iteration.')
    ap.add_argument('--root_dir', required=True)
    ap.add_argument('--resume', default='')
    ap.add_argument('--stats', required=True, help='JSON-lines output.')
    ap.add_argument('--init_params', default='',
                    help='An .npz of a Flax parameter tree to start from.')
    ap.add_argument('--bf16_linear_operands', action='store_true',
                    help='Round every nn.Linear\'s operands to bf16 (an '
                    'approximation of a TPU\'s default f32 matmuls).')
    a, extra = ap.parse_known_args(argv)
    argv = RECIPE + ['--iterations', str(a.iterations),
                     '--root_dir', a.root_dir] + extra
    if a.resume:
        argv += ['--resume', a.resume]

    init_model = trainer_mod.Trainer._init_model
    linear_forward = torch.nn.Linear.forward

    def init_from_file(self):
        init_model(self)
        load_flax_npz(self.model, a.init_params)

    os.makedirs(os.path.dirname(os.path.abspath(a.stats)), exist_ok=True)
    with open(a.stats, 'a') as out:
        train_iteration = trainer_mod.Trainer.train_iteration

        def recorded(self, iteration, do_eval=True):
            st = train_iteration(self, iteration, do_eval)
            out.write(json.dumps(dict(dataclasses.asdict(st),
                                      value_mc_rms=self.last_value_mc_rms,
                                      best_reward=self.best_reward,
                                      best_iteration=self.best_iteration))
                      + '\n')
            out.flush()
            return st

        trainer_mod.Trainer.train_iteration = recorded
        if a.init_params:
            trainer_mod.Trainer._init_model = init_from_file
        if a.bf16_linear_operands:
            torch.nn.Linear.forward = bf16_linear_forward
        t0 = time.perf_counter()
        try:
            trainer = trainer_mod.main(argv)
        finally:
            trainer_mod.Trainer.train_iteration = train_iteration
            trainer_mod.Trainer._init_model = init_model
            torch.nn.Linear.forward = linear_forward
        wall = time.perf_counter() - t0
        cuda = trainer.device.type == 'cuda'
        summary = {
            'argv': argv, 'init_params': a.init_params or None,
            'bf16_linear_operands': a.bf16_linear_operands, 'wall_s': wall,
            'iterations': [h.iteration for h in trainer.history],
            'best_reward': trainer.best_reward,
            'best_iteration': trainer.best_iteration,
            'peak_allocated_bytes': (torch.cuda.max_memory_allocated(
                trainer.device) if cuda else None),
            'peak_reserved_bytes': (torch.cuda.max_memory_reserved(
                trainer.device) if cuda else None),
            'card': card_name_and_power() if cuda else None}
        out.write(json.dumps({'summary': summary}) + '\n')
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
