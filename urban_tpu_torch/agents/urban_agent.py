"""Training/evaluation orchestrator (counterpart of
urban_tpu/agents/urban_agent.py).

Rebuild of the reference UrbanPlanningAgent (reference:
urban_planning/agents/urban_planning_agent.py:23-578) on PyTorch: the exact
host environment (host.envs.city.CityEnv) steps on the host, the
actor-critic (or a heuristic baseline) picks each action, on the device
for the learned policies, and the PPO update runs on the device over the
sampled trajectories. Also the optimizer, loggers, optional TensorBoard,
checkpoints with best-plan payloads, the two-phase land-use -> road
curriculum and the GA evaluation hooks.

The learned policy takes one host sync a step: the host observation goes
to the device, ``select_action_mixed`` draws from a ``torch.Generator``
seeded from the sampler's per-step seed, and the action comes back. On
the card the step replays one captured CUDA graph (``policy_program``:
one copy in, the graph, one copy out), the counterpart of the JAX agent's
jitted select; on the CPU it runs eagerly.
"""
from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from urban_tpu_torch.agents.policy_program import (eager_select,
                                                   graphed_select,
                                                   obs_to_torch)
from urban_tpu_torch.host.envs.city import CityEnv
from urban_tpu_torch.host.models.baseline import (GAPolicy, GSCAPolicy,
                                                  NullModel,
                                                  RuleCentralizedPolicy,
                                                  RuleDecentralizedPolicy)
from urban_tpu_torch.host.rl.sampler import HostSampler, eval_episode
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.host.utils.logger import create_logger
from urban_tpu_torch.host.utils.stats import LoggerRL
from urban_tpu_torch.models.model import (create_mlp_model, create_sgnn_model,
                                          init_like_flax)
from urban_tpu_torch.rl.gae import estimate_advantages_np
from urban_tpu_torch.rl.ppo import (STAT_KEYS, PPOConfig,
                                    fixed_log_probs_and_values,
                                    load_optimizer_state, make_optimizer,
                                    ppo_update_step)
from urban_tpu_torch.utils.checkpoint import to_cpu

def get_eta_str(cur_iter: int, total_iter: int, time_per_iter: float) -> str:
    eta = time_per_iter * (total_iter - cur_iter - 1)
    return str(datetime.timedelta(seconds=round(eta)))


class UrbanPlanningAgent:
    """num_threads is accepted for the reference's API; the host sampler
    is one process. device: where the learned policy and its update run
    (the card unless the caller asks for the CPU). tensorboard: write
    TensorBoard scalars while training (an error where the package is
    missing)."""

    def __init__(self, cfg: Config, num_threads: int = 1,
                 training: bool = True, checkpoint: Union[int, str] = 0,
                 restore_best_rewards: bool = True, device='cuda',
                 tensorboard: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.training = training
        self.tensorboard = tensorboard
        self.loss_iter = 0
        self.noise_rate = 1.0
        self.setup_logger(num_threads)
        self.setup_env()
        self.setup_model()
        self.setup_optimizer()
        if checkpoint != 0:
            self.start_iteration = self.load_checkpoint(checkpoint,
                                                        restore_best_rewards)
        else:
            self.start_iteration = 0
        self.sampler = HostSampler(self.env, self._select_action_fn(),
                                   noise_rate=self.noise_rate,
                                   logger=self.logger, seed=cfg.seed)
        self.reward_offset = 0.0

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def setup_logger(self, num_threads: int) -> None:
        cfg = self.cfg
        self.tb_logger = None
        if self.training and self.tensorboard:
            from torch.utils.tensorboard import SummaryWriter
            self.tb_logger = SummaryWriter(cfg.tb_dir)
        mode = 'train' if self.training else 'eval'
        self.logger = create_logger(os.path.join(cfg.log_dir,
                                                 f'log_{mode}.txt'))
        self.best_rewards = -1000.0
        self.best_plans: list = []
        self.current_rewards = -1000.0
        self.current_plans: list = []
        self.save_best_flag = False
        cfg.log(self.logger, self.tb_logger)

    def setup_env(self) -> None:
        self.env = CityEnv(self.cfg)
        self.numerical_feature_size = self.env.get_numerical_feature_size()
        self.node_dim = self.env.get_node_dim()

    def setup_model(self) -> None:
        cfg = self.cfg
        self.model = None
        if cfg.agent == 'rl-sgnn':
            self.model = create_sgnn_model(cfg)
        elif cfg.agent == 'rl-mlp':
            self.model = create_mlp_model(cfg)
        elif cfg.agent == 'rule-centralized':
            self.policy_net = RuleCentralizedPolicy()
            self.value_net = NullModel()
        elif cfg.agent == 'rule-decentralized':
            self.policy_net = RuleDecentralizedPolicy()
            self.value_net = NullModel()
        elif cfg.agent == 'gsca':
            plc = self.env._plc
            self.policy_net = GSCAPolicy(plc._grid_cols, plc._grid_rows,
                                         plc._cell_edge_length)
            self.value_net = NullModel()
        elif cfg.agent == 'ga':
            self.policy_net = GAPolicy()
            self.value_net = NullModel()
            self.gene: Optional[np.ndarray] = None
        else:
            raise NotImplementedError(cfg.agent)
        if self.model is not None:
            init_like_flax(self.model, torch.Generator().manual_seed(cfg.seed))
            self.model.to(self.device)

    def setup_optimizer(self) -> None:
        cfg = self.cfg
        if self.model is None:
            self.optimizer = None
            return
        self.ppo_cfg = PPOConfig(clip_epsilon=cfg.clip_epsilon,
                                 value_pred_coef=cfg.value_pred_coef,
                                 entropy_coef=cfg.entropy_coef,
                                 grad_clip=1.0, lr=cfg.lr, eps=cfg.eps,
                                 weight_decay=cfg.weightdecay)
        self.optimizer = make_optimizer(self.model.parameters(), self.ppo_cfg)

    def _select_action_fn(self):
        """Policy closure with the HostSampler contract:
        select(obs_batched, seed, mean_action) -> (B, 2) int array; the
        captured program's replay on the card, the eager step on the
        CPU."""
        if self.model is not None:
            if self.device.type == 'cuda':
                return graphed_select(self.model, self.device)
            return eager_select(self.model, self.device)

        policy = self.policy_net

        def select(obs, seed, mean_action):
            single = [np.asarray(o[0]) for o in obs]
            rng = np.random.default_rng(seed)
            if isinstance(policy, GAPolicy):
                action = policy.select_action(single, self.gene, rng,
                                              mean_action)
            else:
                action = policy.select_action(single, rng, mean_action)
            return np.asarray(action)[None]
        return select

    # ------------------------------------------------------------------
    # checkpointing (reference urban_planning_agent.py:153-206)
    # ------------------------------------------------------------------
    def load_checkpoint(self, checkpoint, restore_best_rewards: bool) -> int:
        """Read a checkpoint this agent wrote (torch.save, full
        unpickling: the payload holds the best plans), on whatever device
        it was saved from."""
        cfg = self.cfg
        if isinstance(checkpoint, int):
            cp_path = '%s/iteration_%04d.p' % (cfg.model_dir, checkpoint)
        else:
            cp_path = '%s/%s.p' % (cfg.model_dir, checkpoint)
        self.logger.info('loading model from checkpoint: %s' % cp_path)
        model_cp = torch.load(cp_path, map_location='cpu', weights_only=False)
        if self.model is not None:
            self.model.load_state_dict(model_cp['params'])
        if self.optimizer is not None and model_cp.get('opt_state') is not None:
            load_optimizer_state(self.optimizer, model_cp['opt_state'])
        self.loss_iter = model_cp['loss_iter']
        if restore_best_rewards:
            self.best_rewards = model_cp.get('best_rewards', self.best_rewards)
            self.best_plans = model_cp.get('best_plans', self.best_plans)
        self.current_rewards = model_cp.get('current_rewards',
                                            self.current_rewards)
        self.current_plans = model_cp.get('current_plans', self.current_plans)
        return model_cp['iteration'] + 1

    def save_checkpoint(self, iteration: int) -> None:
        def save(cp_path):
            model_cp = {'params': (None if self.model is None
                                   else to_cpu(self.model.state_dict())),
                        'opt_state': (None if self.optimizer is None
                                      else to_cpu(self.optimizer.state_dict())),
                        'loss_iter': self.loss_iter,
                        'best_rewards': self.best_rewards,
                        'best_plans': self.best_plans,
                        'current_rewards': self.current_rewards,
                        'current_plans': self.current_plans,
                        'iteration': iteration}
            torch.save(model_cp, cp_path)

        cfg = self.cfg
        if cfg.save_model_interval > 0 and \
                (iteration + 1) % cfg.save_model_interval == 0:
            if self.tb_logger:
                self.tb_logger.flush()
            save('{}/iteration_{:04d}.p'.format(cfg.model_dir, iteration + 1))
        if self.save_best_flag:
            if self.tb_logger:
                self.tb_logger.add_scalar('best_reward/best_reward',
                                          self.best_rewards, iteration)
                self.tb_logger.flush()
            self.logger.info(
                f'save best checkpoint with rewards {self.best_rewards:.2f}!')
            save('{}/best.p'.format(cfg.model_dir))
            save('{}/best_reward{:.2f}_iteration_{:04d}.p'.format(
                cfg.model_dir, self.best_rewards, iteration + 1))

    def save_plan(self, log_eval: LoggerRL) -> None:
        cfg = self.cfg
        self.logger.info(f'save plan to file: {cfg.plan_dir}/plan.p')
        with open(f'{cfg.plan_dir}/plan.p', 'wb') as f:
            pickle.dump(log_eval.plans, f)

    # ------------------------------------------------------------------
    # two-phase curriculum (reference urban_planning_agent.py:208-221)
    # ------------------------------------------------------------------
    def freeze_road(self) -> None:
        self.cfg.train()

    def freeze_land_use(self) -> None:
        self.reward_offset = self.best_plans[0]['land_use_reward']
        self.cfg.finetune()
        self.env.freeze_land_use(self.best_plans[0])
        self.load_checkpoint('best', True)

    # ------------------------------------------------------------------
    # optimization loop (reference urban_planning_agent.py:223-371)
    # ------------------------------------------------------------------
    def optimize(self, iteration: int) -> None:
        info = self.optimize_policy(iteration)
        self.log_optimize_policy(iteration, info)

    def optimize_policy(self, iteration: int) -> Dict:
        t0 = time.time()
        num_samples = (self.cfg.num_episodes_per_iteration
                       * self.cfg.max_sequence_length)
        batch, log = self.sampler.sample(num_samples)
        t1 = time.time()
        self.update_params(batch, iteration)
        t2 = time.time()
        log_eval, _, _ = eval_episode(self.env, self.sampler.select_action,
                                      mean_action=True, seed=self.cfg.seed,
                                      logger=self.logger)
        t3 = time.time()
        return {'log': log, 'log_eval': log_eval, 'T_sample': t1 - t0,
                'T_update': t2 - t1, 'T_eval': t3 - t2, 'T_total': t3 - t0}

    @torch.no_grad()
    def fixed_log_probs_and_values(self, obs, actions):
        """The frozen policy's log-probs and values of every row, in
        chunks of mini_batch_size rows (each row's result is its own, so
        the chunks give the whole batch's values; the chunk bounds the
        activations on the device)."""
        n = actions.shape[0]
        mb = min(self.cfg.mini_batch_size, n)
        parts = [fixed_log_probs_and_values(
            self.model, tuple(o[i:i + mb] for o in obs), actions[i:i + mb])
            for i in range(0, n, mb)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def update_params(self, batch, iteration: int) -> None:
        obs = obs_to_torch(batch.states, self.device)
        actions = torch.as_tensor(batch.actions, device=self.device)
        fixed_log_probs, values = self.fixed_log_probs_and_values(obs,
                                                                  actions)
        advantages, returns = estimate_advantages_np(
            batch.rewards, batch.masks, values.cpu().numpy().reshape(-1),
            self.cfg.gamma, self.cfg.tau)
        self.update_policy(batch, fixed_log_probs, returns, advantages,
                           iteration, obs=obs)

    def update_policy(self, batch, fixed_log_probs, returns, advantages,
                      iteration: int, obs=None) -> None:
        """num_optim_epoch epochs of minibatch PPO steps over the batch, in
        the JAX agent's numpy permutation order. obs: batch.states already
        on the device (update_params passes them)."""
        cfg = self.cfg
        dev = self.device
        n = len(batch)
        mb = min(cfg.mini_batch_size, n)
        num_mb = max(n // mb, 1)
        if obs is None:
            obs = obs_to_torch(batch.states, dev)

        def column(x):   # numpy or device rows -> (n, 1) on the device
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=dev).reshape(-1, 1)
        actions = torch.as_tensor(batch.actions, device=dev)
        returns, advantages = column(returns), column(advantages)
        fixed_log_probs = column(fixed_log_probs)
        exps = torch.as_tensor(batch.exps, device=dev)
        rng = np.random.default_rng(cfg.seed + iteration)
        for epoch in range(cfg.num_optim_epoch):
            perm = rng.permutation(n)
            if cfg.agent_specs.get('batch_stage', False):
                stages = batch.states[-1][perm].argmax(axis=1)
                perm = perm[np.argsort(stages, kind='stable')]
            perm_t = torch.as_tensor(perm, device=dev)
            epoch_stats = []
            for i in range(num_mb):
                idx = perm_t[i * mb:(i + 1) * mb]
                stats = ppo_update_step(
                    self.model, self.optimizer, self.ppo_cfg,
                    tuple(o[idx] for o in obs), actions[idx], returns[idx],
                    advantages[idx], fixed_log_probs[idx], exps[idx])
                if self.tb_logger:
                    epoch_stats.append({k: float(stats[k])
                                        for k in STAT_KEYS})
                    for k, v in epoch_stats[-1].items():
                        self.tb_logger.add_scalar(f'loss/{k}', v,
                                                  self.loss_iter)
                self.loss_iter += 1
            if self.tb_logger:
                global_epoch = iteration * cfg.num_optim_epoch + epoch
                for k in STAT_KEYS:
                    self.tb_logger.add_scalar(
                        f'loss/epoch_{k}', sum(s[k] for s in epoch_stats),
                        global_epoch)

    def log_optimize_policy(self, iteration: int, info: Dict) -> None:
        cfg = self.cfg
        log, log_eval = info['log'], info['log_eval']
        log_str = (f'{iteration}\tT_sample {info["T_sample"]:.2f}\t'
                   f'T_update {info["T_update"]:.2f}\t'
                   f'T_eval {info["T_eval"]:.2f}\t'
                   f'ETA {get_eta_str(iteration, cfg.max_num_iterations, info["T_total"])}\t'
                   f'train_R_eps {log.avg_episode_reward + self.reward_offset:.2f}\t'
                   f'eval_R_eps {log_eval.avg_episode_reward + self.reward_offset:.2f}\t'
                   f'{cfg.id}')
        self.logger.info(log_str)
        self.current_rewards = log_eval.avg_episode_reward + self.reward_offset
        self.current_plans = log_eval.plans
        if self.current_rewards > self.best_rewards:
            self.best_rewards = self.current_rewards
            self.best_plans = log_eval.plans
            self.save_best_flag = True
        else:
            self.save_best_flag = False
        if self.tb_logger:
            tb = self.tb_logger
            off = self.reward_offset
            tb.add_scalar('train/train_R_eps_avg',
                          log.avg_episode_reward + off, iteration)
            tb.add_scalar('train/train_R_road_network_eps_avg',
                          log.avg_episode_road_network_reward, iteration)
            tb.add_scalar('train/train_R_life_circle_eps_avg',
                          log.avg_episode_life_circle_reward, iteration)
            tb.add_scalar('train/train_R_greenness_eps_avg',
                          log.avg_episode_greenness_reward, iteration)
            tb.add_scalar('eval/eval_R_eps_avg',
                          log_eval.avg_episode_reward + off, iteration)
            tb.add_scalar('eval/eval_R_road_network_eps_avg',
                          log_eval.avg_episode_road_network_reward, iteration)
            tb.add_scalar('eval/eval_R_life_circle_eps_avg',
                          log_eval.avg_episode_life_circle_reward, iteration)
            tb.add_scalar('eval/eval_R_greenness_eps_avg',
                          log_eval.avg_episode_greenness_reward, iteration)

    # ------------------------------------------------------------------
    # inference / GA (reference urban_planning_agent.py:402-578)
    # ------------------------------------------------------------------
    def eval_agent(self, num_samples: int = 1, mean_action: bool = True,
                   visualize: bool = False) -> LoggerRL:
        t0 = time.time()
        visualize_fn = self._make_visualize_fn() if visualize else None
        log_eval, _, success = eval_episode(
            self.env, self.sampler.select_action, mean_action=mean_action,
            seed=self.cfg.seed, logger=self.logger, visualize_fn=visualize_fn)
        if not success:
            self.logger.info('Plan fails during eval.')
        log_eval.sample_time = time.time() - t0
        return log_eval

    def _make_visualize_fn(self):
        cfg = self.cfg

        def visualize_fn(t, state, next_state):
            if t == 0:
                self.env.visualize(save_fig=True,
                                   path=os.path.join(cfg.plan_dir,
                                                     'step_land_use_0000.svg'),
                                   legend=False, ticks=False, bbox=False)
                return
            if state[-1].argmax() == 0:
                if cfg.skip_road:
                    self.env.build_all_road()
                self.env.visualize(
                    save_fig=True,
                    path=os.path.join(cfg.plan_dir,
                                      f'step_land_use_{t:04d}.svg'),
                    legend=False, ticks=False, bbox=False)
            if next_state[-1].argmax() != 0:
                self.env.visualize_road_and_boundary(
                    save_fig=True,
                    path=os.path.join(cfg.plan_dir, f'step_road_{t:04d}.svg'),
                    legend=False, ticks=False, bbox=False)
            self.env.visualize(
                save_fig=True,
                path=os.path.join(cfg.plan_dir, f'step_all_{t:04d}.svg'),
                legend=False, ticks=False, bbox=False)
        return visualize_fn

    def infer(self, num_samples: int = 1, mean_action: bool = True,
              visualize: bool = False, save_video: bool = False,
              only_road: bool = False) -> LoggerRL:
        t0 = time.time()
        log_eval = self.eval_agent(num_samples, mean_action=mean_action,
                                   visualize=visualize)
        self.logger.info(f'Infer time: {time.time() - t0:.2f}')
        self.save_plan(log_eval)
        if save_video:
            from urban_tpu_torch.host.utils.video import save_video_ffmpeg
            if only_road:
                save_video_ffmpeg(f'{self.cfg.plan_dir}/step_road_%04d.svg',
                                  f'{self.cfg.plan_dir}/plan_road.mp4', fps=10)
            else:
                save_video_ffmpeg(
                    f'{self.cfg.plan_dir}/step_land_use_%04d.svg',
                    f'{self.cfg.plan_dir}/plan_land_use.mp4', fps=10)
            save_video_ffmpeg(f'{self.cfg.plan_dir}/step_all_%04d.svg',
                              f'{self.cfg.plan_dir}/plan_all.mp4', fps=10)
        return log_eval

    def fitness_ga(self, gene, num_samples: int = 1, mean_action: bool = True,
                   visualize: bool = False, return_log_eval: bool = False):
        self.gene = np.asarray(gene)
        log_eval = self.eval_agent(num_samples, mean_action=mean_action,
                                   visualize=visualize)
        plan = log_eval.plans[0] if log_eval.plans else {}
        if return_log_eval:
            return log_eval.avg_episode_reward, plan, log_eval
        return log_eval.avg_episode_reward, plan

    def save_ga(self, best_solution, best_solution_fitness) -> None:
        cfg = self.cfg
        self.logger.info(f'save ga solution to file: {cfg.model_dir}/best.p')
        with open(f'{cfg.model_dir}/best.p', 'wb') as f:
            pickle.dump({'best_solution': np.asarray(best_solution),
                         'best_solution_fitness': best_solution_fitness}, f)

    def load_ga(self):
        cfg = self.cfg
        self.logger.info(f'load ga solution from file: {cfg.model_dir}/best.p')
        with open(f'{cfg.model_dir}/best.p', 'rb') as f:
            solution = pickle.load(f)
        return solution['best_solution'], solution['best_solution_fitness']
