"""Experiment configuration (reference: urban_planning/utils/config.py:6-139).

Loads ``urban_tpu/cfg/**/<id>.yaml`` by glob, creates the run directory tree
``root/<cfg>/<seed>/{models,log,tb,plan}``, and exposes every hyperparameter
with the reference's defaults. ``train()``/``finetune()`` implement the
two-phase land-use→road curriculum by mutating the stage-skip flags.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from urban_tpu_torch.host.utils.io import load_yaml


class Config:

    def __init__(self, cfg: str, global_seed: int = 0, tmp: bool = False,
                 root_dir: str = '/tmp/urban_tpu_runs', agent: str = 'rl-sgnn',
                 cfg_dict: Optional[Dict] = None):
        self.id = cfg
        self.seed = global_seed
        if cfg_dict is not None:
            cfg = cfg_dict
        else:
            cfg = load_yaml(f'urban_tpu/cfg/**/{self.id}.yaml')
        self.root_dir = '/tmp/urban_tpu' if tmp else root_dir

        self.cfg_dir = os.path.join(self.root_dir, self.id, str(self.seed))
        self.model_dir = os.path.join(self.cfg_dir, 'models')
        self.log_dir = os.path.join(self.cfg_dir, 'log')
        self.tb_dir = os.path.join(self.cfg_dir, 'tb')
        self.plan_dir = os.path.join(self.cfg_dir, 'plan')
        for d in (self.model_dir, self.log_dir, self.tb_dir, self.plan_dir):
            os.makedirs(d, exist_ok=True)

        self.agent = agent

        # env
        self.objectives_plan = cfg.get('objectives_plan', '')
        self.init_plan = cfg.get('init_plan', '')
        self.env_specs = cfg.get('env_specs', dict())
        self.reward_specs = cfg.get('reward_specs', dict())
        self.obs_specs = cfg.get('obs_specs', dict())

        # agent
        self.agent_specs = cfg.get('agent_specs', dict())

        # training
        self.skip_land_use = cfg.get('skip_land_use', False)
        self.skip_road = cfg.get('skip_road', False)
        self.road_ratio = cfg.get('road_ratio', 0.7)
        self.gamma = cfg.get('gamma', 0.99)
        self.tau = cfg.get('tau', 0.95)
        self.state_encoder_specs = cfg.get('state_encoder_specs', dict())
        self.policy_specs = cfg.get('policy_specs', dict())
        self.value_specs = cfg.get('value_specs', dict())
        self.lr = cfg.get('lr', 4e-4)
        self.weightdecay = cfg.get('weightdecay', 0.0)
        self.eps = cfg.get('eps', 1e-5)
        self.value_pred_coef = cfg.get('value_pred_coef', 0.5)
        self.entropy_coef = cfg.get('entropy_coef', 0.01)
        self.clip_epsilon = cfg.get('clip_epsilon', 0.2)
        self.max_num_iterations = cfg.get('max_num_iterations', 1000)
        self.num_episodes_per_iteration = cfg.get('num_episodes_per_iteration', 1000)
        self.max_sequence_length = cfg.get('max_sequence_length', 100)
        self.original_max_sequence_length = cfg.get('max_sequence_length', 100)
        self.num_optim_epoch = cfg.get('num_optim_epoch', 4)
        self.mini_batch_size = cfg.get('mini_batch_size', 1024)
        self.save_model_interval = cfg.get('save_model_interval', 10)

        # TPU-native extensions (not in the reference): batched-env rollout
        self.rollout_specs = cfg.get('rollout_specs', dict())

    def train(self) -> None:
        """Phase 1: land use only, halved episode length
        (reference config.py:65-69)."""
        self.skip_land_use = False
        self.skip_road = True
        self.max_sequence_length = self.original_max_sequence_length // 2

    def finetune(self) -> None:
        """Phase 2: road only (reference config.py:71-75)."""
        self.skip_land_use = True
        self.skip_road = False
        self.max_sequence_length = self.original_max_sequence_length // 2

    def log(self, logger, tb_logger=None) -> None:
        """Log every hyperparameter (reference config.py:77-139)."""
        for key in ('id', 'seed', 'objectives_plan', 'init_plan', 'env_specs',
                    'reward_specs', 'obs_specs', 'agent_specs', 'skip_land_use',
                    'skip_road', 'road_ratio', 'gamma', 'tau',
                    'state_encoder_specs', 'policy_specs', 'value_specs', 'lr',
                    'weightdecay', 'eps', 'value_pred_coef', 'entropy_coef',
                    'clip_epsilon', 'max_num_iterations',
                    'num_episodes_per_iteration', 'max_sequence_length',
                    'num_optim_epoch', 'mini_batch_size', 'save_model_interval'):
            logger.info(f'{key}: {getattr(self, key)}')
        if tb_logger is not None:
            tb_logger.add_hparams(
                hparam_dict={key: str(getattr(self, key)) for key in (
                    'id', 'seed', 'objectives_plan', 'init_plan',
                    'reward_specs', 'agent_specs', 'skip_land_use', 'skip_road',
                    'road_ratio', 'gamma', 'tau', 'lr', 'clip_epsilon',
                    'max_num_iterations', 'num_episodes_per_iteration',
                    'max_sequence_length', 'num_optim_epoch',
                    'mini_batch_size')},
                metric_dict={'hparam/placeholder': 0.0})
