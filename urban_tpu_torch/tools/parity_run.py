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
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iterations', type=int, required=True,
                    help='The chunk ends before this iteration.')
    ap.add_argument('--root_dir', required=True)
    ap.add_argument('--resume', default='')
    ap.add_argument('--stats', required=True, help='JSON-lines output.')
    a, extra = ap.parse_known_args(argv)
    argv = RECIPE + ['--iterations', str(a.iterations),
                     '--root_dir', a.root_dir] + extra
    if a.resume:
        argv += ['--resume', a.resume]

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
        t0 = time.perf_counter()
        try:
            trainer = trainer_mod.main(argv)
        finally:
            trainer_mod.Trainer.train_iteration = train_iteration
        wall = time.perf_counter() - t0
        cuda = trainer.device.type == 'cuda'
        summary = {
            'argv': argv, 'wall_s': wall,
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
