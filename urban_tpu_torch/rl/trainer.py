"""PPO trainer on the batched environment (counterpart of
urban_tpu/rl/train_tpu.py, class TPUTrainer).

One iteration: a batched rollout of num_envs x rollout_len steps with the
trajectory kept on the device (``collect``), the success weights and GAE,
then ``num_optim_epoch`` shuffled epochs of minibatch PPO steps
(``update``: a forward and a backward of the SGNN per minibatch, through
the segment-mean kernel and its backward kernel on a CUDA device), then
greedy evaluation episodes with best-plan tracking (``eval_agent``).
Collect and eval each step through a ``StepProgram`` that the trainer
keeps (``program``): on the card a captured CUDA graph of the whole
batched step, replayed once a step. On one device the update's
minibatch steps go through an ``UpdateProgram`` (``update_program``): on
the card a captured CUDA graph of the forward, backward, clip and Adam
step, replayed once a minibatch. ``eager=True`` steps all three eagerly
on the card too. The minibatch permutation comes from
``np.random.default_rng(seed + iteration)``, as in the JAX trainer, so
both take the same minibatches; the rollout and sampling noise comes
from an explicit ``torch.Generator``.

``run_training`` runs one phase, or with ``separate_train`` the two-phase
land-use -> road curriculum: ``iterations`` of land use only (the phase-1
env keeps its BOUNDARY segments), then the best greedy plan is frozen
(``freeze_land_use_trainer``: leftover feasible space becomes small green,
the spec, the initial state and the model are rebuilt around the frozen
plan, and the phase-1 best parameters are carried over where their names
and shapes fit, ``transfer_matching_params``), then ``iterations`` of
roads only. The encoder is the SGNN or the MLP ablation (``--encoder``).

With ``--num_devices N`` > 1 (-1: every visible card) the run is data
parallel (``urban_tpu_torch.parallel.mesh``): N ranks, each stepping its
block of num_envs / N environments, computing the same thing as one
device. The random stream does not depend on N: every draw is made at
the whole batch's size and each rank keeps its rows (``RowShard``). The
update takes the one-device minibatches (the same permutation on every
rank), each rank the rows of its own environments, with the gradients
all-reduced, stepped eagerly: a rank's rows change from minibatch to
minibatch and the all-reduce cannot be captured (the JAX trainer, too,
scans an epoch only without a mesh). Every batch-wide statistic is
reduced over the ranks. The
greedy eval runs whole on every rank, so every rank holds the same best
plan and freezes it alike; rank 0 alone writes logs, TensorBoard and
checkpoints, and after each iteration the ranks' parameters must be
bitwise equal.

    python -m urban_tpu_torch.rl.trainer --cfg hlg --iterations 1 \
        --num_envs 2 --device cpu
    python -m urban_tpu_torch.rl.trainer --cfg hlg --iterations 1 \
        --num_envs 4 --num_devices 2 --rollout_len 3 --device cpu
    python -m urban_tpu_torch.rl.trainer --cfg grid --separate_train \
        --encoder sgnn --iterations 1 --num_envs 2 --rollout_len 60 \
        --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.envs.plan_client import PlanClient
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.host.utils.logger import create_logger
from urban_tpu_torch.models.model import create_model, init_like_flax
from urban_tpu_torch.models.policy import RowShard
from urban_tpu_torch.ops import segment_ops
from urban_tpu_torch.parallel.mesh import (Mesh, check_replicated,
                                           local_minibatch_rows, make_mesh,
                                           replicate, spawn, visible_devices)
from urban_tpu_torch.rl.ppo import (PPOConfig, load_optimizer_state,
                                    make_optimizer, ppo_update_epoch)
from urban_tpu_torch.rl.update_program import UpdateProgram
from urban_tpu_torch.torchenv.program import StepProgram
from urban_tpu_torch.torchenv.rollout import (batched_gae, broadcast_state,
                                              episode_success_weights,
                                              eval_rollout, failure_causes,
                                              failure_histogram,
                                              normalize_advantages, rollout)
from urban_tpu_torch.torchenv.state import (build_env_spec,
                                            build_initial_state,
                                            plan_state_to_numpy,
                                            state_to_table)
from urban_tpu_torch.torchenv.step import (batched_road_network_reward,
                                           greenness_reward,
                                           life_circle_reward)

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
    eval_time: float = float('nan')
    losses: Dict[str, float] = field(default_factory=dict)
    failure_causes: Dict[str, int] = field(default_factory=dict)
    # this rank's kernel launches in each part ('collect', 'update',
    # 'eval'), and its rows in each minibatch step of the update
    kernel_launches: Dict[str, Dict[str, int]] = field(default_factory=dict)
    minibatch_rows: List[int] = field(default_factory=list)


@torch.no_grad()
def _reward_channels(spec, states):
    """Per-env raw reward channels (life circle, greenness, road network)
    of batched terminal states. The road channel is computed only on
    scenarios that plan roads and is zero otherwise: on a skip_road
    scenario the raster face decomposition would cover the full 1-m grid
    (HLG: 2160 x 2040 cells), which must never be built."""
    life = vmap(lambda s: life_circle_reward(spec, s))(states)
    green = vmap(lambda s: greenness_reward(spec, s))(states)
    if spec.skip_road or spec.road_network_weight <= 0:
        road = torch.zeros_like(life)
    else:
        road = batched_road_network_reward(spec, states)
    return life, green, road


def check_divisible(num_envs: int, n_devices: int) -> None:
    if num_envs % n_devices:
        raise ValueError(
            f'num_envs={num_envs} must be divisible by the {n_devices}-device '
            f'dp mesh (environments shard evenly across devices)')


def _quiet_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


class Trainer:

    def __init__(self, cfg: Config, num_envs: Optional[int] = None,
                 rollout_len: Optional[int] = None, eval_envs: int = 16,
                 device='cuda', use_tensorboard: bool = False,
                 keep_boundaries: bool = False, encoder: str = 'sgnn',
                 mesh: Optional[Mesh] = None, eager: bool = False,
                 encoder_operands: str = 'f32'):
        """mesh: this rank's data-parallel mesh (make_mesh); its device
        replaces `device`. Without one the trainer runs on one device.
        eager: collect, eval and update step eagerly on the card instead
        of replaying their captured graphs (the graphs' reference).
        encoder_operands: 'bf16' rounds the SGNN's gather and segment-mean
        operands as the JAX encoder's default backend does (create_model);
        'f32' rounds nothing."""
        self.cfg = cfg
        self.eager = eager
        self.encoder_operands = encoder_operands
        self.mesh = mesh if mesh is not None else make_mesh(1, device)
        self.device = self.mesh.device
        self.encoder = encoder
        self.plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
        # the JAX trainer's spec: default capacities, the config's edge cap;
        # a phase-1 trainer keeps the BOUNDARY segments at land-use end
        self.spec = build_env_spec(cfg, self.plc,
                                   max_steps=cfg.max_sequence_length,
                                   keep_boundaries=keep_boundaries)
        self.init_state = build_initial_state(self.spec, self.plc,
                                              device=self.device)
        self.num_envs = num_envs or cfg.rollout_specs.get('num_envs', 256)
        check_divisible(self.num_envs, self.mesh.world_size)
        # this rank's envs: rows [env_start, env_start + local_envs)
        self.local_envs = self.num_envs // self.mesh.world_size
        self.env_start = self.mesh.rank * self.local_envs
        # the rollout window must cover a full episode: episodes that span
        # the window boundary are excluded from training by the success
        # filter
        self.rollout_len = rollout_len or getattr(
            cfg, 'original_max_sequence_length', cfg.max_sequence_length)
        self.eval_envs = eval_envs
        if self.mesh.is_main:
            self.logger = create_logger(os.path.join(cfg.log_dir,
                                                     'log_train_torch.txt'))
        else:
            self.logger = _quiet_logger(f'{__name__}.rank{self.mesh.rank}')
        self.tb = None
        if use_tensorboard and self.mesh.is_main:
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
        # the step programs of collect and eval (program()) and the update
        # programs (update_program()), which share one graph memory pool on
        # the card: they never replay at the same time
        self.programs: Dict[tuple, object] = {}
        self.graph_pool = None
        self.best_reward = -1000.0
        self.best_plan_state = None       # plan_state_to_numpy of one env
        self.best_params = None           # state_dict at the best eval
        self.best_iteration = -1
        self.start_iteration = 0
        self.phase = 1                    # 2 after freeze_land_use_trainer
        self.frozen_table = None          # the frozen land-use plan
        self.warm_start = None            # (copied, total) into phase 2
        # the curriculum run_training drives (two phases, and whether the
        # road phase starts from the phase-1 best parameters)
        self.separate_train = False
        self.warm_start_phase2 = True
        self.last_value_mc_rms = float('nan')
        self.last_minibatch_rows = []     # this rank's rows, each mb step
        self.last_actions = None          # the last collect's (T, B, 2)
        self.history: List[TrainStats] = []   # every train_iteration's

    def _init_model(self):
        """Build the model, initialized as Flax initializes the JAX one
        (from cfg.seed), and its optimizer around the spec's slot sizes:
        nodes = feature slots, edges = edge slots. Called again by
        freeze_land_use_trainer, whose frozen plan regrows the slot
        table."""
        cfg = self.cfg
        cfg.state_encoder_specs = dict(cfg.state_encoder_specs)
        cfg.state_encoder_specs['max_num_nodes'] = self.spec.num_features
        cfg.state_encoder_specs['max_num_edges'] = self.spec.NE
        model = create_model(cfg, encoder=self.encoder,
                             encoder_operands=self.encoder_operands)
        init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.ppo_cfg)
        replicate(self.mesh, self.model, self.optimizer)

    def _reset_env_batch(self):
        self.env_states = broadcast_state(
            self.init_state.replace(done=torch.ones_like(
                self.init_state.done)), self.local_envs)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def program(self, kind: str, batch: int,
                noise_rate: float = 1.0) -> StepProgram:
        """The step program of `kind` ('collect' or 'eval') at `batch`
        envs, made on first use and kept, keyed on all that its capture
        holds: kind, spec, model, batch and noise_rate. A collect program
        of a data-parallel rank draws its rows of the whole batch's
        stream."""
        key = (kind, self.spec, self.model, batch, noise_rate)
        if key not in self.programs:
            generator = self.generator
            if kind == 'collect' and self.mesh.world_size > 1:
                generator = RowShard(generator, self.env_start,
                                     self.num_envs)
            self.programs[key] = StepProgram(
                self.spec, self.model, self.init_state, batch, kind,
                generator, noise_rate, eager=self.eager, pool=self._pool())
        return self.programs[key]

    def update_program(self, batch: int) -> UpdateProgram:
        """The update program of `batch`-row minibatches, made on first use
        and kept, keyed on all that its capture holds: spec, model,
        optimizer and batch (the optimizer's state, which load_checkpoint
        replaces, drops it there)."""
        key = ('update', self.spec, self.model, self.optimizer, batch)
        if key not in self.programs:
            self.programs[key] = UpdateProgram(
                self.model, self.optimizer, self.ppo_cfg, batch,
                eager=self.eager, pool=self._pool())
        return self.programs[key]

    def _pool(self):
        if self.graph_pool is None and self.device.type == 'cuda':
            self.graph_pool = torch.cuda.graph_pool_handle()
        return self.graph_pool

    def drop_programs(self) -> None:
        """Free the step and update programs and their graph memory
        pool."""
        self.programs.clear()
        self.graph_pool = None

    def collect(self):
        """This rank's (T, local_envs) trajectory; its random draws are its
        rows of the whole batch's."""
        program = self.program('collect', self.local_envs)
        self.env_states, traj = rollout(
            self.spec, self.model, self.init_state, self.env_states,
            program.generator, self.rollout_len, program=program)
        return traj

    def update(self, traj, iteration: int, weights=None):
        """num_optim_epoch shuffled epochs of PPO minibatch steps on the
        trajectory (this rank's rows of each one-device minibatch);
        returns the last epoch's mean loss stats."""
        rows = self.update_rows(traj, weights)
        for minibatches in self.epoch_minibatches(traj.rewards.shape[0],
                                                  iteration):
            stats = self.update_epoch(rows, minibatches)
        return stats

    def update_rows(self, traj, weights=None):
        """The update's rows of the trajectory, flattened (T x B leading):
        the 9 observation tensors, actions, returns, advantages, fixed
        log-probs, exps (the success weights x the exploration indicator,
        for the surrogate and entropy) and valid (the success weights, for
        the value loss). Also sets last_value_mc_rms."""
        cfg, mesh = self.cfg, self.mesh
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
        sums = mesh.all_reduce(torch.stack([(gap * gap * w).sum(), w.sum()]))
        self.last_value_mc_rms = float(torch.sqrt(
            sums[0] / torch.clamp_min(sums[1], 1.0)))
        if cfg.agent_specs.get('normalize_advantages', False):
            advantages = normalize_advantages(advantages, weights,
                                              mesh.group)
        n = T * B
        return (*(o.reshape((n,) + o.shape[2:]) for o in traj.obs),
                traj.actions.reshape(n, 2), returns.reshape(n, 1),
                advantages.reshape(n, 1), traj.log_probs.reshape(n, 1),
                (traj.exps * weights).reshape(n), weights.reshape(n))

    def minibatch_size(self, T: int) -> int:
        """The one-device run's minibatch rows over all num_envs envs."""
        return min(self.cfg.mini_batch_size, T * self.num_envs)

    def epoch_minibatches(self, T: int, iteration: int):
        """Each epoch's minibatches of a T-step window: this rank's rows of
        each one-device minibatch (a permutation from
        np.random.default_rng(seed + iteration), as in the JAX trainer),
        as device index tensors; their row counts go to
        last_minibatch_rows."""
        n_all = T * self.num_envs
        mb = self.minibatch_size(T)
        num_mb = max(n_all // mb, 1)
        rng = np.random.default_rng(self.cfg.seed + iteration)
        self.last_minibatch_rows = []
        epochs = []
        for _ in range(self.cfg.num_optim_epoch):
            rows = local_minibatch_rows(rng.permutation(n_all), num_mb, mb,
                                        self.num_envs, self.mesh)
            counts = [len(r) for r in rows]
            self.last_minibatch_rows += counts
            epochs.append(torch.split(torch.as_tensor(
                np.concatenate(rows), device=self.device), counts))
        return epochs

    def update_epoch(self, rows, minibatches):
        """One epoch of minibatch steps on the update's rows: through the
        update program on one device (every minibatch is full there),
        eagerly under data parallelism. Returns the mean loss stats."""
        if self.mesh.world_size > 1:
            return ppo_update_epoch(self.model, self.optimizer, self.ppo_cfg,
                                    rows[:9], *rows[9:14], minibatches,
                                    rows[14], self.mesh.group)
        return self.update_program(len(minibatches[0])).epoch(
            rows[:9], *rows[9:14], minibatches, rows[14])

    # ------------------------------------------------------------------
    def eval_agent(self, iteration: int):
        """Greedy eval episodes from fresh states; tracks the best plan and
        the parameters that produced it. Returns (mean successful episode
        reward, mean reward channels of the successful episodes)."""
        start = broadcast_state(self.init_state, self.eval_envs)
        final, total_r, done, failure = eval_rollout(
            self.spec, self.model, start, self.generator, self.rollout_len,
            program=self.program('eval', self.eval_envs))
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

    def best_plan_table(self):
        """The best greedy plan as a host GeoTable (for host scoring and
        the land-use freeze), or None before any successful eval."""
        if self.best_plan_state is None:
            return None
        return state_to_table(self.best_plan_state)

    # ------------------------------------------------------------------
    def train_iteration(self, iteration: int,
                        do_eval: bool = True) -> TrainStats:
        """collect, update, eval; the statistics are the whole batch's,
        reduced over the ranks, and the ranks' parameters must come out
        bitwise equal."""
        launches = {}

        def count(part, t_before):
            launches[part] = {k: segment_ops.launches[k] - t_before[k]
                              for k in t_before}
        t0 = time.perf_counter()
        before = dict(segment_ops.launches)
        traj = self.collect()
        self._sync()
        count('collect', before)
        t1 = time.perf_counter()
        self.last_actions = traj.actions.cpu().numpy()
        weights_dev = episode_success_weights(traj.dones, traj.failures)
        term = traj.dones & ~traj.failures
        # episodes, failures, successful episodes and their reward sum,
        # the success weights' sum and count, the failure histogram
        totals = self.mesh.all_reduce(torch.cat([torch.stack([
            traj.dones.sum().double(), traj.failures.sum().double(),
            term.sum().double(),
            torch.where(term, traj.rewards, 0.0).double().sum(),
            weights_dev.double().sum(),
            torch.tensor(weights_dev.numel(), dtype=torch.float64,
                         device=self.device)]),
            failure_histogram(traj.failure_codes).double()])).cpu().numpy()
        episodes, failures, n_term, term_reward, w_sum, w_n = totals[:6]
        causes = failure_causes(totals[6:].astype(np.int64))
        mean_ep = float(term_reward / n_term) if n_term else -1.0
        before = dict(segment_ops.launches)
        stats = self.update(traj, iteration, weights=weights_dev)
        losses = {k: float(v) for k, v in stats.items()}
        self._sync()
        count('update', before)
        t2 = time.perf_counter()
        eval_r = float('nan')
        if do_eval:
            before = dict(segment_ops.launches)
            eval_r, _ = self.eval_agent(iteration)
            count('eval', before)
        t3 = time.perf_counter()
        check_replicated(self.mesh, self.model)
        n_steps = int(w_n)
        out = TrainStats(
            iteration=iteration, episodes=int(episodes),
            failures=int(failures), mean_episode_reward=mean_ep,
            success_frac=float(w_sum / w_n),
            steps_per_sec=n_steps / max(t1 - t0, 1e-9),
            update_time=t2 - t1, eval_reward=eval_r, sample_time=t1 - t0,
            eval_time=t3 - t2,
            losses=losses, failure_causes=causes, kernel_launches=launches,
            minibatch_rows=list(self.last_minibatch_rows))
        self.history.append(out)
        self.logger.info(
            f'{iteration}\tT_sample {t1 - t0:.2f}\tT_update {t2 - t1:.2f}\t'
            f'T_eval {t3 - t2:.2f}\tsteps/s {out.steps_per_sec:.0f}\t'
            f'eps {out.episodes}\t'
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
        the parameters snapshotted when the best eval was reached. Only
        rank 0 writes."""
        if not self.mesh.is_main:
            return
        name = tag or f'iteration_{iteration:04d}'
        common = {'iteration': iteration,
                  'best_reward': self.best_reward,
                  'best_plan_state': self.best_plan_state,
                  'best_params': self.best_params,
                  'best_iteration': self.best_iteration,
                  'phase': self.phase,
                  'frozen_table': self.frozen_table,
                  'warm_start': self.warm_start}
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
        """path: a checkpoint file this trainer wrote, or its loaded dict.
        A phase-2 checkpoint needs a trainer in phase 2: re-enter it with
        freeze_land_use_trainer on the checkpoint's frozen_table first
        (run_training does)."""
        ckpt = path if isinstance(path, dict) else read_checkpoint(path)
        if ckpt.get('phase', 1) != self.phase:
            raise ValueError(f'a phase-{ckpt.get("phase", 1)} checkpoint '
                             f'does not fit a trainer in phase {self.phase}')
        self.model.load_state_dict(ckpt['params'])
        if ckpt.get('opt_state') is not None:
            load_optimizer_state(self.optimizer, ckpt['opt_state'])
            # the update program's capture holds the replaced state tensors
            self.drop_programs()
        replicate(self.mesh, self.model, self.optimizer)
        self.start_iteration = ckpt['iteration'] + 1
        self.warm_start = ckpt.get('warm_start', self.warm_start)
        self.best_plan_state = ckpt.get('best_plan_state')
        self.best_params = ckpt.get('best_params')
        if restore_best_reward:
            self.best_reward = ckpt['best_reward']
            self.best_iteration = ckpt.get('best_iteration', -1)
        else:
            self.best_reward = -1000.0
            self.best_iteration = -1


def read_checkpoint(path) -> dict:
    """A checkpoint file this trainer wrote. It holds numpy arrays (the
    best plan) and a host GeoTable (the frozen plan), so it is read with
    full unpickling: only read checkpoints this trainer wrote."""
    return torch.load(path, map_location='cpu', weights_only=False)


def transfer_matching_params(src, dst):
    """Copy every tensor of the state dict ``src`` into ``dst`` whose name
    exists in both and whose shape and dtype match; returns (new state
    dict, copied, total) tensor counts. This carries the land-use-trained
    trunk into the road phase, whose model is rebuilt around the frozen
    plan's regrown slot table."""
    out, copied = {}, 0
    for name, leaf in dst.items():
        cand = src.get(name)
        if cand is not None and cand.shape == leaf.shape \
                and cand.dtype == leaf.dtype:
            out[name] = cand.detach().to(leaf.device).clone()
            copied += 1
        else:
            out[name] = leaf
    return out, copied, len(dst)


def freeze_land_use_trainer(trainer: Trainer, table,
                            warm_start_params=None) -> Trainer:
    """Switch a trainer to road-only training around a frozen land-use
    plan (a host GeoTable); cfg.finetune() must already have been applied.
    The phase-1 model, optimizer, step programs and env batch are freed
    first, so that the device's peak is phase 2's own. warm_start_params:
    a phase-1 state dict (normally the best-eval one) to carry into the
    rebuilt model where names and shapes fit, under a fresh optimizer."""
    trainer.plc.freeze_land_use(table)
    trainer.plc.unplan_all_land_use()
    trainer.drop_programs()
    trainer.model = trainer.optimizer = None
    trainer.env_states = trainer.init_state = None
    if trainer.device.type == 'cuda':
        torch.cuda.empty_cache()
    cfg = trainer.cfg
    trainer.spec = build_env_spec(cfg, trainer.plc,
                                  max_steps=cfg.max_sequence_length)
    trainer.init_state = build_initial_state(trainer.spec, trainer.plc,
                                             device=trainer.device)
    trainer._init_model()
    trainer.warm_start = None
    if warm_start_params is not None:
        params, copied, total = transfer_matching_params(
            warm_start_params, trainer.model.state_dict())
        trainer.model.load_state_dict(params)
        trainer.optimizer = make_optimizer(trainer.model.parameters(),
                                           trainer.ppo_cfg)
        replicate(trainer.mesh, trainer.model, trainer.optimizer)
        trainer.warm_start = (copied, total)
        trainer.logger.info(f'phase 2 warm start: transferred {copied}/'
                            f'{total} param tensors from phase-1 best')
    trainer._reset_env_batch()
    trainer.best_reward = -1000.0
    trainer.best_plan_state = None
    trainer.best_params = None
    trainer.best_iteration = -1
    trainer.phase = 2
    trainer.frozen_table = table
    return trainer


def run_training(cfg: Config, iterations: int, num_envs: Optional[int],
                 separate_train: bool = False, eval_envs: int = 16,
                 use_tensorboard: bool = False, rollout_len: int = None,
                 resume: str = None, num_devices: int = 0,
                 device='cuda', warm_start_phase2: bool = True,
                 encoder: str = 'sgnn', timeout: Optional[float] = None,
                 encoder_operands: str = 'f32'):
    """Training loop: iterations x train_iteration with a checkpoint every
    save_model_interval iterations and a final one; with separate_train,
    the land-use phase, the freeze of its best plan, then as many
    iterations of the road phase (numbered iterations .. 2 x iterations -
    1). Without a successful phase-1 plan the road phase is skipped, as
    in the JAX trainer. A phase-2 checkpoint resumes in phase 2.

    num_devices: 0 / 1 one device; N > 1 data parallel over N ranks; -1
    every visible card. Returns the Trainer, except where it spawns the N
    ranks itself (no process group is initialized yet): then each rank's
    summary (rank_summary), in rank order. Inside an initialized group of
    N ranks (torchrun) each rank trains in its own process and returns
    its Trainer. `timeout` (seconds) bounds a spawned run."""
    n = visible_devices(device) if num_devices == -1 else max(num_devices, 1)
    if n > 1 and not dist.is_initialized():
        check_divisible(num_envs or cfg.rollout_specs.get('num_envs', 256), n)
        return spawn(_train_rank, n, device, timeout=timeout,
                     rendezvous_dir=cfg.cfg_dir, args=(
                         cfg, iterations, num_envs, separate_train,
                         eval_envs, use_tensorboard, rollout_len, resume,
                         warm_start_phase2, encoder, encoder_operands))
    return _train(make_mesh(n, device), cfg, iterations, num_envs,
                  separate_train, eval_envs, use_tensorboard, rollout_len,
                  resume, warm_start_phase2, encoder, encoder_operands)


def rank_summary(trainer: Trainer) -> dict:
    """What a spawned rank returns: its mesh, every iteration's TrainStats,
    its parameters (on the CPU), the last collect's actions, and its
    device's peak memory (bytes, None on the CPU)."""
    mesh = trainer.mesh
    peak = (torch.cuda.max_memory_allocated(trainer.device)
            if trainer.device.type == 'cuda' else None)
    return {'rank': mesh.rank, 'backend': mesh.backend,
            'device': str(mesh.device),
            'ranks_per_device': mesh.ranks_per_device,
            'history': trainer.history,
            'params': {k: v.detach().cpu() for k, v
                       in trainer.model.state_dict().items()},
            'last_actions': trainer.last_actions, 'peak_bytes': peak}


def _train_rank(mesh: Mesh, *args) -> dict:
    return rank_summary(_train(mesh, *args))


def _train(mesh: Mesh, cfg: Config, iterations: int, num_envs, separate_train,
           eval_envs, use_tensorboard, rollout_len, resume,
           warm_start_phase2, encoder, encoder_operands) -> Trainer:
    """run_training's loop on this rank. Every rank reads a resume
    checkpoint."""
    ckpt = read_checkpoint(resume) if resume else None
    resume_phase = ckpt.get('phase', 1) if ckpt else 1
    if resume_phase == 2 and not separate_train:
        raise ValueError('a phase-2 checkpoint requires separate_train')
    if separate_train:
        cfg.train()
    trainer = Trainer(cfg, num_envs=num_envs, rollout_len=rollout_len,
                      eval_envs=eval_envs, use_tensorboard=use_tensorboard,
                      keep_boundaries=separate_train, encoder=encoder,
                      mesh=mesh, encoder_operands=encoder_operands)
    trainer.separate_train = separate_train
    trainer.warm_start_phase2 = warm_start_phase2
    if mesh.world_size > 1:
        trainer.logger.info(
            f'data parallel: {mesh.world_size} ranks, backend '
            f'{mesh.backend}, {mesh.ranks_per_device} rank(s) per device, '
            f'{trainer.local_envs} envs a rank')
    if ckpt:
        # a phase-2 checkpoint holds the frozen plan and phase-2 shaped
        # parameters: re-enter phase 2 before installing them
        if resume_phase == 2:
            cfg.finetune()
            freeze_land_use_trainer(trainer, ckpt['frozen_table'])
        trainer.load_checkpoint(ckpt)

    def iterate(its):
        for it in its:
            trainer.train_iteration(it)
            if (it + 1) % cfg.save_model_interval == 0:
                trainer.save_checkpoint(it)

    if resume_phase == 1:
        iterate(range(trainer.start_iteration, iterations))
        trainer.save_checkpoint(iterations - 1, tag='phase1_final'
                                if separate_train else 'final')
    if not separate_train:
        return trainer

    if resume_phase == 1:
        table = trainer.best_plan_table()
        if table is None:
            trainer.logger.info('no successful plan found in phase 1; '
                                'skipping road phase')
            return trainer
        # complete the land-use plan as the env's stage transition does:
        # leftover feasible space becomes small green
        table.types[table.alive_mask_of(city_config.FEASIBLE)] = \
            city_config.GREEN_S
        cfg.finetune()
        trainer.logger.info(f'phase 2 (road): frozen best plan '
                            f'reward={trainer.best_reward:.3f}')
        freeze_land_use_trainer(
            trainer, table, warm_start_params=(
                trainer.best_params if warm_start_phase2 else None))
    iterate(range(max(iterations, trainer.start_iteration), 2 * iterations))
    trainer.save_checkpoint(2 * iterations - 1, tag='phase2_final')
    return trainer


def main(argv=None):
    """The CLI; returns run_training's result."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg', required=True, help='Config id (hlg, ...).')
    ap.add_argument('--global_seed', type=int, default=0)
    ap.add_argument('--num_envs', type=int, default=0,
                    help='Vectorized envs (0 = cfg default).')
    ap.add_argument('--num_devices', type=int, default=0,
                    help='Data-parallel ranks: 0/1 = one device, N > 1 = '
                    'shard the envs and all-reduce the gradients over N '
                    'ranks, -1 = every visible card.')
    ap.add_argument('--iterations', type=int, default=10)
    ap.add_argument('--eval_envs', type=int, default=16)
    ap.add_argument('--rollout_len', type=int, default=0,
                    help='Rollout window (0 = episode cap).')
    ap.add_argument('--separate_train', action='store_true',
                    help='Two-phase land-use -> road curriculum.')
    ap.add_argument('--warm_start_phase2',
                    action=argparse.BooleanOptionalAction, default=True,
                    help='Carry the phase-1 best parameters into the road '
                    'phase where their shapes fit.')
    ap.add_argument('--encoder', choices=('sgnn', 'mlp'), default='sgnn',
                    help='State encoder: the SGNN, or the MLP ablation '
                    'without message passing.')
    ap.add_argument('--encoder_operands', choices=('f32', 'bf16'),
                    default='f32',
                    help='bf16: round the SGNN\'s gather and segment-mean '
                    'operands to bf16, as the JAX encoder\'s default '
                    'backend does.')
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
    return run_training(cfg, a.iterations, a.num_envs or None,
                        a.separate_train, a.eval_envs, a.tensorboard,
                        a.rollout_len or None, a.resume or None,
                        a.num_devices, a.device, a.warm_start_phase2,
                        a.encoder, encoder_operands=a.encoder_operands)


if __name__ == '__main__':
    main()
