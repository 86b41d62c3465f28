"""Replay a trainer checkpoint's greedy evaluation episode through the host
oracle: is its failure the MDP's or the slot tables'?

Loads the parameters of a checkpoint of the port's trainer
(``rl/trainer.py``: ``final.pt``, ``best.pt``, ``iteration_NNNN.pt``),
plays the trainer's greedy eval episode from the scenario's initial state
(one env, the trainer's caps and window, ``eval_rollout``), and, where
the slot-table env fails, drives a fresh env of the port and the exact
host engine (numpy ``CityEnv``) with the episode's actions up to the
failing step (``tools/replay_failures.replay_one``): ``host_failed`` at
the same step means the exact engine rejects the action too (the MDP's
failure); ``host_survived`` means the slot tables fail an action the
engine takes.

    python -m urban_tpu_torch.tools.greedy_replay --cfg hlg \\
        --ckpt DIR/hlg/111/models/final.pt [--encoder mlp] \\
        [--encoder_operands bf16] [--bf16_linear_operands] \\
        [--global_seed 111] [--device cpu]

prints one JSON object: the episode's reward, done and failure, the
failing step and its failure causes, the actions, and the replay's
verdict. ``--encoder`` names the checkpoint's state encoder (``sgnn``,
the trainer's default, or ``mlp``, the ablation's trunk): the model is
built with it before the checkpoint's parameters are loaded.
``--bf16_linear_operands`` plays the episode with
``tools/parity_run.py``'s bf16 ``nn.Linear`` operands, as a checkpoint of
a run with that flag was trained and evaluated.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.trainer import Trainer, read_checkpoint
from urban_tpu_torch.tools.parity_run import bf16_linear_forward
from urban_tpu_torch.torchenv.rollout import (broadcast_state, eval_rollout,
                                              failure_causes,
                                              failure_histogram)
from urban_tpu_torch.tools.replay_failures import replay_one


def greedy_replay(cfg_name: str, ckpt: str, seed: int = 111,
                  encoder_operands: str = 'f32', device='cuda',
                  bf16_linear_operands: bool = False,
                  encoder: str = 'sgnn') -> dict:
    linear_forward = torch.nn.Linear.forward
    if bf16_linear_operands:
        torch.nn.Linear.forward = bf16_linear_forward
    try:
        return _greedy_replay(cfg_name, ckpt, seed, encoder_operands, device,
                              bf16_linear_operands, encoder)
    finally:
        torch.nn.Linear.forward = linear_forward


def _greedy_replay(cfg_name, ckpt, seed, encoder_operands, device,
                   bf16_linear_operands, encoder) -> dict:
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(Config(cfg_name, seed, root_dir=root), num_envs=1,
                          eval_envs=1, device=device, encoder=encoder,
                          encoder_operands=encoder_operands)
    trainer.model.load_state_dict(read_checkpoint(ckpt)['params'])
    program = trainer.program('eval', 1)
    steps = []
    run = program.run

    def recording(state):
        out = run(state)
        steps.append((out['action'][0].cpu().numpy().copy(),
                      bool(out['info']['failure'][0]),
                      int(out['info']['failure_code'][0]),
                      bool(state.done[0])))
        return out
    program.run = recording
    _, total, done, failure = eval_rollout(
        trainer.spec, trainer.model, broadcast_state(trainer.init_state, 1),
        trainer.generator, trainer.rollout_len, program=program)
    live = [s for s in steps if not s[3]]           # before the freeze
    fail_at = next((k for k, s in enumerate(live) if s[1]), None)
    out = {'checkpoint': ckpt, 'encoder': encoder,
           'encoder_operands': encoder_operands,
           'bf16_linear_operands': bf16_linear_operands,
           'reward': float(total[0]), 'done': bool(done[0]),
           'failure': bool(failure[0]), 'steps': len(live),
           'actions': [s[0].tolist() for s in live], 'fail_step': fail_at}
    if fail_at is not None:
        code = torch.tensor([live[fail_at][2]])
        out['failure_causes'] = failure_causes(
            failure_histogram(code).numpy())
        out['replay'] = replay_one(
            trainer.cfg, trainer.spec, trainer.init_state,
            [np.asarray(s[0]) for s in live[:fail_at + 1]], fail_at,
            device=device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg', default='hlg')
    ap.add_argument('--ckpt', required=True)
    ap.add_argument('--global_seed', type=int, default=111)
    ap.add_argument('--encoder', choices=('sgnn', 'mlp'), default='sgnn')
    ap.add_argument('--encoder_operands', choices=('f32', 'bf16'),
                    default='f32')
    ap.add_argument('--bf16_linear_operands', action='store_true')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    out = greedy_replay(a.cfg, a.ckpt, a.global_seed, a.encoder_operands,
                        a.device, a.bf16_linear_operands, a.encoder)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
