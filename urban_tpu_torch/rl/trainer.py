"""PPO trainer on the batched environment (counterpart of
urban_tpu/rl/train_tpu.py, class TPUTrainer).

One iteration: a batched rollout of num_envs x rollout_len steps with the
trajectory kept on the device (``collect``), the success weights and GAE,
then ``num_optim_epoch`` shuffled epochs of minibatch PPO steps
(``update``: a forward and a backward of the SGNN per minibatch, through
the segment-mean kernel and its backward kernel on a CUDA device), then
greedy evaluation episodes with best-plan tracking (``eval_agent``). The
minibatch permutation comes from ``np.random.default_rng(seed +
iteration)``, as in the JAX trainer, so both take the same minibatches;
the rollout and sampling noise comes from an explicit ``torch.Generator``.

    python -m urban_tpu_torch.rl.trainer --cfg hlg --iterations 1 \
        --num_envs 2 --device cpu

Not in this port yet (ROADMAP.md, queue 1), and refused with
NotImplementedError: the two-phase land-use -> road curriculum
(``--separate_train``, ``freeze_land_use_trainer``,
``transfer_matching_params``), the data-parallel mesh (``--num_devices``
> 1) and the road-network reward channel.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from urban_tpu_torch.host.envs.plan_client import PlanClient
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.host.utils.logger import create_logger
from urban_tpu_torch.models.model import create_model, init_like_flax
from urban_tpu_torch.rl.ppo import PPOConfig, make_optimizer, ppo_update_epoch
from urban_tpu_torch.torchenv.rollout import (batched_gae, broadcast_state,
                                              episode_success_weights,
                                              eval_rollout, failure_causes,
                                              failure_histogram,
                                              normalize_advantages, rollout)
from urban_tpu_torch.torchenv.state import (build_env_spec,
                                            build_initial_state,
                                            plan_state_to_numpy)
from urban_tpu_torch.torchenv.step import (check_supported, greenness_reward,
                                           life_circle_reward)

NOT_PORTED = ('is not ported to urban_tpu_torch yet (ROADMAP.md, queue 1)')


@dataclass
class TrainStats:
    iteration: int
    episodes: int
    failures: int
    mean_episode_reward: float
    success_frac: float
    steps_per_sec: float
    update_time: float
    eval_reward: float = float('nan')
    sample_time: float = float('nan')
    losses: Dict[str, float] = field(default_factory=dict)
    failure_causes: Dict[str, int] = field(default_factory=dict)


@torch.no_grad()
def _reward_channels(spec, states):
    """Per-env raw reward channels (life circle, greenness, road network)
    of batched terminal states. The road channel is zero on scenarios that
    do not plan roads (skip_road, or no road weight)."""
    if not (spec.skip_road or spec.road_network_weight <= 0):
        raise NotImplementedError(f'the road-network reward {NOT_PORTED}')
    life = vmap(lambda s: life_circle_reward(spec, s))(states)
    green = vmap(lambda s: greenness_reward(spec, s))(states)
    return life, green, torch.zeros_like(life)


class Trainer:

    def __init__(self, cfg: Config, num_envs: Optional[int] = None,
                 rollout_len: Optional[int] = None, eval_envs: int = 16,
                 device='cuda', use_tensorboard: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
        # the JAX trainer's spec: default capacities, the config's edge cap
        self.spec = build_env_spec(cfg, self.plc,
                                   max_steps=cfg.max_sequence_length)
        check_supported(self.spec)
        self.init_state = build_initial_state(self.spec, self.plc,
                                              device=self.device)
        self.num_envs = num_envs or cfg.rollout_specs.get('num_envs', 256)
        # the rollout window must cover a full episode: episodes that span
        # the window boundary are excluded from training by the success
        # filter
        self.rollout_len = rollout_len or getattr(
            cfg, 'original_max_sequence_length', cfg.max_sequence_length)
        self.eval_envs = eval_envs
        self.logger = create_logger(os.path.join(cfg.log_dir,
                                                 'log_train_torch.txt'))
        self.tb = None
        if use_tensorboard:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(cfg.tb_dir)
        self.ppo_cfg = PPOConfig(clip_epsilon=cfg.clip_epsilon,
                                 value_pred_coef=cfg.value_pred_coef,
                                 entropy_coef=cfg.entropy_coef,
                                 grad_clip=1.0, lr=cfg.lr, eps=cfg.eps,
                                 weight_decay=cfg.weightdecay)
        self._init_model()
        self._reset_env_batch()
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.best_reward = -1000.0
        self.best_plan_state = None       # plan_state_to_numpy of one env
        self.best_params = None           # state_dict at the best eval
        self.best_iteration = -1
        self.start_iteration = 0
        self.phase = 1
        self.last_value_mc_rms = float('nan')

    def _init_model(self):
        """Build the model, initialized as Flax initializes the JAX one
        (from cfg.seed), and its optimizer around the spec's slot sizes:
        nodes = feature slots, edges = edge slots."""
        cfg = self.cfg
        cfg.state_encoder_specs = dict(cfg.state_encoder_specs)
        cfg.state_encoder_specs['max_num_nodes'] = self.spec.num_features
        cfg.state_encoder_specs['max_num_edges'] = self.spec.NE
        model = create_model(cfg)
        init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.ppo_cfg)

    def _reset_env_batch(self):
        self.env_states = broadcast_state(
            self.init_state.replace(done=torch.ones_like(
                self.init_state.done)), self.num_envs)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def collect(self):
        self.env_states, traj = rollout(
            self.spec, self.model, self.init_state, self.env_states,
            self.generator, self.rollout_len)
        return traj

    def update(self, traj, iteration: int, weights=None):
        """num_optim_epoch shuffled epochs of PPO minibatch steps on the
        trajectory; returns the last epoch's mean loss stats."""
        cfg = self.cfg
        T, B = traj.rewards.shape
        if weights is None:
            weights = episode_success_weights(traj.dones, traj.failures)
        advantages, returns = batched_gae(traj.rewards, traj.dones,
                                          traj.values, cfg.gamma, cfg.tau)
        # value-bootstrap mixing diagnostic: RMS gap between the critic and
        # the Monte-Carlo return (gamma, tau = 1) over the training rows,
        # whatever tau the update trains against
        _, mc_returns = batched_gae(traj.rewards, traj.dones, traj.values,
                                    cfg.gamma, 1.0)
        w = weights.reshape(-1)
        gap = (traj.values - mc_returns).reshape(-1)
        self.last_value_mc_rms = float(torch.sqrt(
            (gap * gap * w).sum() / torch.clamp_min(w.sum(), 1.0)))
        if cfg.agent_specs.get('normalize_advantages', False):
            advantages = normalize_advantages(advantages, weights)
        n = T * B
        flat_obs = tuple(o.reshape((n,) + o.shape[2:]) for o in traj.obs)
        actions = traj.actions.reshape(n, 2)
        returns = returns.reshape(n, 1)
        advantages = advantages.reshape(n, 1)
        fixed_lp = traj.log_probs.reshape(n, 1)
        # success filter x exploration indicator for the surrogate and
        # entropy; the success filter alone for the value loss
        valid = weights.reshape(n)
        exps = (traj.exps * weights).reshape(n)

        mb = min(cfg.mini_batch_size, n)
        num_mb = max(n // mb, 1)
        rng = np.random.default_rng(cfg.seed + iteration)
        for _ in range(cfg.num_optim_epoch):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            stats = ppo_update_epoch(
                self.model, self.optimizer, self.ppo_cfg, flat_obs, actions,
                returns, advantages, fixed_lp, exps, perm, num_mb, mb, valid)
        return stats

    # ------------------------------------------------------------------
    def eval_agent(self, iteration: int):
        """Greedy eval episodes from fresh states; tracks the best plan and
        the parameters that produced it. Returns (mean successful episode
        reward, mean reward channels of the successful episodes)."""
        start = broadcast_state(self.init_state, self.eval_envs)
        final, total_r, done, failure = eval_rollout(
            self.spec, self.model, start, self.generator, self.rollout_len)
        total_r = total_r.cpu().numpy()
        ok = (done & ~failure).cpu().numpy()
        mean_r = float(total_r[ok].mean()) if ok.any() else -1.0
        chans = {}
        for name, x in zip(('life_circle', 'greenness', 'road_network'),
                           _reward_channels(self.spec, final)):
            chans[name] = float(x.cpu().numpy()[ok].mean()) if ok.any() \
                else 0.0
        if ok.any():
            best_i = int(np.flatnonzero(ok)[np.argmax(total_r[ok])])
            if total_r[best_i] > self.best_reward:
                self.best_reward = float(total_r[best_i])
                self.best_plan_state = plan_state_to_numpy(
                    final.map(lambda x: x[best_i]))
                self.best_params = {k: v.detach().cpu().clone() for k, v
                                    in self.model.state_dict().items()}
                self.best_iteration = iteration
        if self.tb is not None:
            self.tb.add_scalar('eval/eval_R_eps_avg', mean_r, iteration)
            for k, v in chans.items():
                self.tb.add_scalar(f'eval/eval_R_{k}_eps_avg', v, iteration)
            self.tb.add_scalar('best_reward/best_reward', self.best_reward,
                               iteration)
        return mean_r, chans

    # ------------------------------------------------------------------
    def train_iteration(self, iteration: int,
                        do_eval: bool = True) -> TrainStats:
        t0 = time.perf_counter()
        traj = self.collect()
        self._sync()
        t1 = time.perf_counter()
        dones = traj.dones.cpu().numpy()
        fails = traj.failures.cpu().numpy()
        rewards = traj.rewards.cpu().numpy()
        causes = failure_causes(failure_histogram(traj.failure_codes).cpu())
        weights_dev = episode_success_weights(traj.dones, traj.failures)
        weights = weights_dev.cpu().numpy()
        term = dones & ~fails
        mean_ep = float(rewards[term].mean()) if term.any() else -1.0
        stats = self.update(traj, iteration, weights=weights_dev)
        losses = {k: float(v) for k, v in stats.items()}
        self._sync()
        t2 = time.perf_counter()
        eval_r = float('nan')
        if do_eval:
            eval_r, _ = self.eval_agent(iteration)
        n_steps = rewards.size
        out = TrainStats(
            iteration=iteration, episodes=int(dones.sum()),
            failures=int(fails.sum()), mean_episode_reward=mean_ep,
            success_frac=float(weights.mean()),
            steps_per_sec=n_steps / max(t1 - t0, 1e-9),
            update_time=t2 - t1, eval_reward=eval_r, sample_time=t1 - t0,
            losses=losses, failure_causes=causes)
        self.logger.info(
            f'{iteration}\tT_sample {t1 - t0:.2f}\tT_update {t2 - t1:.2f}\t'
            f'steps/s {out.steps_per_sec:.0f}\teps {out.episodes}\t'
            f'fail {out.failures}\tR_eps {mean_ep:.3f}\t'
            f'R_eval {eval_r:.3f}\tbest {self.best_reward:.3f}\t'
            f'V_mc_rms {self.last_value_mc_rms:.4f}\t{self.cfg.id}')
        if self.tb is not None:
            self.tb.add_scalar('train/train_R_eps_avg', mean_ep, iteration)
            for k, v in losses.items():
                self.tb.add_scalar(f'loss/{k}', v, iteration)
            self.tb.add_scalar('diag/value_mc_rms', self.last_value_mc_rms,
                               iteration)
        return out

    # ------------------------------------------------------------------
    def save_checkpoint(self, iteration: int, tag: str = None) -> None:
        """torch.save checkpoint with the best-plan payload; best.pt holds
        the parameters snapshotted when the best eval was reached."""
        name = tag or f'iteration_{iteration:04d}'
        common = {'iteration': iteration,
                  'best_reward': self.best_reward,
                  'best_plan_state': self.best_plan_state,
                  'best_params': self.best_params,
                  'best_iteration': self.best_iteration,
                  'phase': self.phase}
        params = {k: v.detach().cpu() for k, v
                  in self.model.state_dict().items()}
        torch.save(dict(common, params=params,
                        opt_state=self.optimizer.state_dict()),
                   os.path.join(self.cfg.model_dir, f'{name}.pt'))
        best_it = (self.best_iteration if self.best_iteration >= 0
                   else iteration)
        torch.save(dict(common, iteration=best_it,
                        saved_at_iteration=iteration,
                        params=(self.best_params if self.best_params
                                is not None else params),
                        opt_state=None),
                   os.path.join(self.cfg.model_dir, 'best.pt'))

    def load_checkpoint(self, path, restore_best_reward: bool = True) -> None:
        """path: a checkpoint file this trainer wrote, or its loaded dict."""
        if isinstance(path, dict):
            ckpt = path
        else:
            # the file holds numpy arrays (the best plan), so it is read
            # with full unpickling: only load checkpoints this trainer wrote
            ckpt = torch.load(path, map_location='cpu', weights_only=False)
        if ckpt.get('phase', 1) != 1:
            raise NotImplementedError(f'two-phase training {NOT_PORTED}')
        self.model.load_state_dict(ckpt['params'])
        if ckpt.get('opt_state') is not None:
            self.optimizer.load_state_dict(ckpt['opt_state'])
        self.start_iteration = ckpt['iteration'] + 1
        self.best_plan_state = ckpt.get('best_plan_state')
        self.best_params = ckpt.get('best_params')
        if restore_best_reward:
            self.best_reward = ckpt['best_reward']
            self.best_iteration = ckpt.get('best_iteration', -1)
        else:
            self.best_reward = -1000.0
            self.best_iteration = -1


def transfer_matching_params(src, dst):
    raise NotImplementedError(f'transfer_matching_params {NOT_PORTED}')


def freeze_land_use_trainer(trainer: Trainer, table, warm_start_params=None):
    raise NotImplementedError(f'freeze_land_use_trainer {NOT_PORTED}')


def run_training(cfg: Config, iterations: int, num_envs: Optional[int],
                 separate_train: bool = False, eval_envs: int = 16,
                 use_tensorboard: bool = False, rollout_len: int = None,
                 resume: str = None, num_devices: int = 0,
                 device='cuda') -> Trainer:
    """Single-phase training loop: iterations x train_iteration, a
    checkpoint every save_model_interval iterations and a final one."""
    if separate_train:
        raise NotImplementedError(f'two-phase training (--separate_train) '
                                  f'{NOT_PORTED}')
    if num_devices not in (0, 1):
        raise NotImplementedError(f'data-parallel training (--num_devices '
                                  f'{num_devices}) {NOT_PORTED}')
    trainer = Trainer(cfg, num_envs=num_envs, rollout_len=rollout_len,
                      eval_envs=eval_envs, device=device,
                      use_tensorboard=use_tensorboard)
    if resume:
        trainer.load_checkpoint(resume)
    for it in range(trainer.start_iteration, iterations):
        trainer.train_iteration(it)
        if (it + 1) % cfg.save_model_interval == 0:
            trainer.save_checkpoint(it)
    trainer.save_checkpoint(iterations - 1, tag='final')
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg', required=True, help='Config id (hlg, ...).')
    ap.add_argument('--global_seed', type=int, default=0)
    ap.add_argument('--num_envs', type=int, default=0,
                    help='Vectorized envs (0 = cfg default).')
    ap.add_argument('--num_devices', type=int, default=0,
                    help='0/1 = one device (more is not ported yet).')
    ap.add_argument('--iterations', type=int, default=10)
    ap.add_argument('--eval_envs', type=int, default=16)
    ap.add_argument('--rollout_len', type=int, default=0,
                    help='Rollout window (0 = episode cap).')
    ap.add_argument('--separate_train', action='store_true',
                    help='Two-phase land-use -> road curriculum (not '
                    'ported yet).')
    ap.add_argument('--tensorboard', action='store_true',
                    help='Write TensorBoard scalars.')
    ap.add_argument('--normalize_advantages', action='store_true',
                    help='Standardize advantages over the training rows.')
    ap.add_argument('--tau', type=float, default=-1.0,
                    help='GAE lambda override (< 0 = cfg value).')
    ap.add_argument('--lr', type=float, default=-1.0,
                    help='Learning-rate override (<= 0 = cfg value).')
    ap.add_argument('--resume', default='',
                    help='Checkpoint path to resume from.')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--root_dir',
                    default=os.path.join(tempfile.gettempdir(),
                                         'urban_tpu_torch'),
                    help='Run directory root (logs, tb, models).')
    a = ap.parse_args(argv)
    cfg = Config(a.cfg, a.global_seed, tmp=False, root_dir=a.root_dir)
    if a.normalize_advantages:
        cfg.agent_specs = dict(cfg.agent_specs, normalize_advantages=True)
    if a.tau >= 0.0:
        cfg.tau = a.tau
    if a.lr > 0.0:
        cfg.lr = a.lr
    if a.device.startswith('cuda'):
        from urban_tpu_torch.bench import set_precision_flags
        set_precision_flags()
    run_training(cfg, a.iterations, a.num_envs or None, a.separate_train,
                 a.eval_envs, a.tensorboard, a.rollout_len or None,
                 a.resume or None, a.num_devices, a.device)


if __name__ == '__main__':
    main()
