"""Evaluation/inference CLI (counterpart of urban_tpu/eval.py; reference:
urban_planning/eval.py:18-74).

    python -m urban_tpu_torch.eval --cfg grid --global_seed 111
        [--agent rl-sgnn --iteration best] [--device cuda|cpu]

A learned agent plays one greedy episode from a checkpoint of
``urban_tpu_torch.train`` (the same --root_dir, --cfg and --global_seed);
the baselines rule-centralized, rule-decentralized and gsca need none, and
ga reads the gene saved in the run's models/best.p. The plan is saved to
the run's plan/plan.p.
"""
from __future__ import annotations

import argparse
from pprint import pprint

import numpy as np

from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.train import DEFAULT_ROOT
from urban_tpu_torch.utils.flags import add_bool_flag

AGENTS = ('rl-sgnn', 'rl-mlp', 'rule-centralized', 'rule-decentralized',
          'gsca', 'ga')


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root_dir', default=DEFAULT_ROOT,
                    help='Root directory for logs/summaries/checkpoints.')
    ap.add_argument('--cfg', required=True, help='Configuration file.')
    add_bool_flag(ap, 'tmp', False, 'Whether to use temporary storage')
    ap.add_argument('--agent', default='rl-sgnn', choices=AGENTS,
                    help='Agent type.')
    add_bool_flag(ap, 'mean_action', True, 'Whether to use greedy strategy')
    add_bool_flag(ap, 'visualize', False,
                  'Whether to visualize the planning process')
    add_bool_flag(ap, 'only_road', False,
                  'Whether to only visualize road planning')
    add_bool_flag(ap, 'save_video', False,
                  'Whether to save a video of the planning process')
    ap.add_argument('--global_seed', type=int, required=True, help='Seed.')
    ap.add_argument('--iteration', default='0',
                    help='Checkpoint to load (number or "best").')
    ap.add_argument('--device', default='cuda',
                    help='Device of the learned policy.')
    return ap.parse_args(argv)


def main(argv=None):
    """Parse argv (sys.argv when None), evaluate, and return (agent, the
    episode's LoggerRL)."""
    a = parse_args(argv)
    if a.device.startswith('cuda'):
        from urban_tpu_torch.bench import set_precision_flags
        set_precision_flags()
    cfg = Config(a.cfg, a.global_seed, a.tmp, a.root_dir, a.agent)
    np.random.seed(cfg.seed)
    checkpoint = int(a.iteration) if a.iteration.isnumeric() else a.iteration
    agent = UrbanPlanningAgent(cfg=cfg, num_threads=1, training=False,
                               checkpoint=checkpoint,
                               restore_best_rewards=True, device=a.device)
    if a.only_road:
        agent.freeze_land_use()

    if a.agent != 'ga':
        log_eval = agent.infer(num_samples=1, mean_action=a.mean_action,
                               visualize=a.visualize,
                               save_video=a.save_video,
                               only_road=a.only_road)
    else:
        best_solution, _ = agent.load_ga()
        _, plan, log_eval = agent.fitness_ga(
            best_solution, num_samples=1, mean_action=a.mean_action,
            visualize=a.visualize, return_log_eval=True)
        pprint({k: v for k, v in plan.items() if not k.endswith('gdf')},
               indent=4, sort_dicts=False)
        agent.save_plan(log_eval)
    return agent, log_eval


if __name__ == '__main__':
    main()
