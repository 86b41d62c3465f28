"""PPO training CLI on the host environment (counterpart of
urban_tpu/train.py; reference: urban_planning/train.py:14-88).

    python -m urban_tpu_torch.train --cfg grid --global_seed 111
        [--agent rl-sgnn] [--device cuda|cpu]

Two phases by default on a scenario with land use and roads: land use
with the road stage skipped, then the best plan's land use frozen and
roads trained from the best checkpoint. The policy and its update run on
--device (the card unless asked otherwise); the environment steps on the
host.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.utils.flags import add_bool_flag

DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), 'urban_tpu_torch_runs')


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root_dir', default=DEFAULT_ROOT,
                    help='Root directory for logs/summaries/checkpoints.')
    ap.add_argument('--cfg', required=True,
                    help='Configuration file of rl training.')
    add_bool_flag(ap, 'tmp', False, 'Whether to use temporary storage')
    ap.add_argument('--agent', default='rl-sgnn', choices=('rl-sgnn', 'rl-mlp'),
                    help='Agent type.')
    add_bool_flag(ap, 'separate_train', True,
                  'Whether to separate the training of land use and road '
                  'planning into two phases')
    ap.add_argument('--num_threads', type=int, default=1,
                    help='Sampler threads (the host sampler is one process).')
    ap.add_argument('--global_seed', type=int, required=True,
                    help='Seed for env and weight init.')
    ap.add_argument('--iteration', default='0',
                    help='Start iteration (number or "best"); nonzero '
                    'resumes from a checkpoint.')
    add_bool_flag(ap, 'restore_best_rewards', True,
                  'Restore best rewards on resume (False for finetuning '
                  'with a new reward)')
    ap.add_argument('--max_num_iterations', type=int, default=0,
                    help='Override cfg max_num_iterations when > 0.')
    ap.add_argument('--num_episodes_per_iteration', type=int, default=0,
                    help='Override cfg num_episodes_per_iteration when > 0.')
    ap.add_argument('--device', default='cuda',
                    help='Device of the policy and its update.')
    add_bool_flag(ap, 'tensorboard', False, 'Write TensorBoard scalars')
    return ap.parse_args(argv)


def train_one_iteration(agent: UrbanPlanningAgent, iteration: int) -> None:
    agent.optimize(iteration)
    agent.save_checkpoint(iteration)


def main(argv=None) -> UrbanPlanningAgent:
    """Parse argv (sys.argv when None), train, and return the agent."""
    a = parse_args(argv)
    if a.device.startswith('cuda'):
        from urban_tpu_torch.bench import set_precision_flags
        set_precision_flags()
    cfg = Config(a.cfg, a.global_seed, a.tmp, a.root_dir, a.agent)
    if a.max_num_iterations > 0:
        cfg.max_num_iterations = a.max_num_iterations
    if a.num_episodes_per_iteration > 0:
        cfg.num_episodes_per_iteration = a.num_episodes_per_iteration
    np.random.seed(cfg.seed)

    checkpoint = int(a.iteration) if a.iteration.isnumeric() else a.iteration
    agent = UrbanPlanningAgent(cfg=cfg, num_threads=a.num_threads,
                               training=True, checkpoint=checkpoint,
                               restore_best_rewards=a.restore_best_rewards,
                               device=a.device, tensorboard=a.tensorboard)

    if a.separate_train and not cfg.skip_land_use and not cfg.skip_road:
        agent.freeze_road()
        for iteration in range(agent.start_iteration, cfg.max_num_iterations):
            train_one_iteration(agent, iteration)
        agent.freeze_land_use()
        for iteration in range(cfg.max_num_iterations,
                               2 * cfg.max_num_iterations):
            train_one_iteration(agent, iteration)
    else:
        if cfg.skip_land_use:
            agent.freeze_land_use()
        for iteration in range(agent.start_iteration, cfg.max_num_iterations):
            train_one_iteration(agent, iteration)

    agent.logger.info('training done!')
    if agent.tb_logger:
        agent.tb_logger.close()
    return agent


if __name__ == '__main__':
    main()
