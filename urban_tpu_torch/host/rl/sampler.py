"""Host trajectory sampler over the exact environment.

Replaces the reference's fork-based multiprocess sampler
(khrylib/rl/agents/agent.py:33-100): with a jitted policy a single process
drives episodes directly; rollout-scale throughput comes from the batched
TPU environment instead (urban_tpu.jaxenv.rollout). Episode semantics match
the reference's success filter: only episodes that do not terminate with a
FAILURE/INTERMEDIATE reward enter the training memory
(urban_planning/agents/urban_planning_agent.py:75-86).
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np

from urban_tpu_torch.host.rl.memory import Memory, TrajBatch, stack_obs
from urban_tpu_torch.host.utils.stats import LoggerRL


class HostSampler:

    def __init__(self, env, select_action: Callable, noise_rate: float = 1.0,
                 logger: Optional[logging.Logger] = None,
                 seed: int = 0) -> None:
        """select_action(obs_batched, rng_seed, mean_action) -> (1,2) array."""
        self.env = env
        self.select_action = select_action
        self.noise_rate = noise_rate
        self.logger = logger or logging.getLogger('sampler')
        self.rng = np.random.default_rng(seed)

    def sample(self, num_samples: int, mean_action: bool = False
               ) -> Tuple[TrajBatch, LoggerRL]:
        memory = Memory()
        logger_rl = LoggerRL()
        while logger_rl.num_steps < num_samples:
            self._sample_episode(memory, logger_rl, mean_action)
        return TrajBatch([memory]), LoggerRL.merge([logger_rl])

    def _sample_episode(self, memory: Memory, logger_rl: LoggerRL,
                        mean_action: bool) -> None:
        env = self.env
        state = env.reset()
        episode_success = False
        last_info = {}
        logger_msgs = []
        memory_msgs = []
        for _ in range(10000):
            use_mean = mean_action or (self.rng.random() > self.noise_rate)
            obs_b = stack_obs([state])
            action = np.asarray(
                self.select_action(obs_b, int(self.rng.integers(2 ** 31)),
                                   use_mean)).reshape(2)
            next_state, reward, done, info = env.step(action, self.logger)
            logger_msgs.append((reward, info))
            mask = 0 if done else 1
            exp = 1 - use_mean
            memory_msgs.append((state, action, mask, next_state, reward, exp))
            if done:
                episode_success = (reward != env.FAILURE_REWARD
                                   and reward != env.INTERMEDIATE_REWARD)
                last_info = info
                break
            state = next_state
        if episode_success:
            logger_rl.start_episode(env)
            for (reward, info), msg in zip(logger_msgs, memory_msgs):
                logger_rl.step(env, reward, info)
                memory.push(*msg)
            logger_rl.end_episode(last_info)


def eval_episode(env, select_action: Callable, mean_action: bool = True,
                 seed: int = 0, logger: Optional[logging.Logger] = None,
                 visualize_fn: Optional[Callable] = None
                 ) -> Tuple[LoggerRL, dict, bool]:
    """Greedy evaluation episode (reference urban_planning_agent.py:402-467)."""
    logger = logger or logging.getLogger('eval')
    rng = np.random.default_rng(seed)
    logger_rl = LoggerRL()
    state = env.reset()
    env.eval()
    if visualize_fn is not None:
        visualize_fn(0, state, state)
    logger_rl.start_episode(env)
    info_plan = {}
    episode_success = False
    for t in range(1, 10000):
        obs_b = stack_obs([state])
        action = np.asarray(select_action(obs_b, int(rng.integers(2 ** 31)),
                                          mean_action)).reshape(2)
        next_state, reward, done, info = env.step(action, logger)
        logger_rl.step(env, reward, info)
        if visualize_fn is not None:
            visualize_fn(t, state, next_state)
        if done:
            episode_success = (reward != env.FAILURE_REWARD
                               and reward != env.INTERMEDIATE_REWARD)
            info_plan = info
            break
        state = next_state
    logger_rl.add_plan(info_plan)
    logger_rl.end_episode(info_plan)
    env.train()
    return LoggerRL.merge([logger_rl]), info_plan, episode_success
