"""Episode statistics aggregation.

StatsLogger (reference: khrylib/utils/stats_logger.py:5-43) and LoggerRL
(reference: khrylib/rl/core/logger_rl.py:6-56): per-channel totals/min/max/avg
with cross-sampler merging, tracking the reward decomposition channels
road_network / life_circle / greenness (+concept) alongside episode reward.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List


class StatsLogger:

    def __init__(self):
        self.total_val = 0.0
        self.min_val = math.inf
        self.max_val = -math.inf
        self.n = 0

    def log(self, val: float) -> None:
        self.total_val += val
        self.min_val = min(self.min_val, val)
        self.max_val = max(self.max_val, val)
        self.n += 1

    def avg(self) -> float:
        return self.total_val / self.n if self.n else 0.0

    def total(self) -> float:
        return self.total_val

    def min(self) -> float:
        return self.min_val

    def max(self) -> float:
        return self.max_val

    @classmethod
    def merge(cls, loggers: List['StatsLogger']) -> 'StatsLogger':
        out = cls()
        out.total_val = sum(x.total_val for x in loggers)
        out.min_val = min(x.min_val for x in loggers)
        out.max_val = max(x.max_val for x in loggers)
        out.n = sum(x.n for x in loggers)
        return out


class LoggerRL:

    STATS_NAMES = ('episode_len', 'reward', 'episode_reward',
                   'road_network', 'life_circle', 'greenness')

    def __init__(self, init_stats_logger: bool = True):
        self.num_steps = 0
        self.num_episodes = 0
        self.sample_time = 0.0
        if init_stats_logger:
            self.stats_loggers = {x: StatsLogger() for x in self.STATS_NAMES}
        self.plans: List[Dict] = []

    def start_episode(self, env=None) -> None:
        self.episode_len = 0
        self.episode_reward = 0.0

    def step(self, env, reward: float, info: Dict) -> None:
        self.episode_len += 1
        self.episode_reward += reward
        self.stats_loggers['reward'].log(reward)

    def end_episode(self, info: Dict) -> None:
        self.num_steps += self.episode_len
        self.num_episodes += 1
        self.stats_loggers['episode_len'].log(self.episode_len)
        self.stats_loggers['episode_reward'].log(self.episode_reward)
        self.stats_loggers['road_network'].log(info.get('road_network', -1.0))
        self.stats_loggers['life_circle'].log(info.get('life_circle', -1.0))
        self.stats_loggers['greenness'].log(info.get('greenness', -1.0))

    def add_plan(self, info_plan: Dict) -> None:
        self.plans.append(info_plan)

    @classmethod
    def merge(cls, logger_list: List['LoggerRL'], **kwargs) -> 'LoggerRL':
        out = cls(init_stats_logger=False, **kwargs)
        out.num_episodes = sum(x.num_episodes for x in logger_list)
        out.num_steps = sum(x.num_steps for x in logger_list)
        out.stats_loggers = {
            name: StatsLogger.merge([x.stats_loggers[name] for x in logger_list])
            for name in cls.STATS_NAMES}
        out.total_reward = out.stats_loggers['reward'].total()
        out.avg_episode_len = out.stats_loggers['episode_len'].avg()
        out.avg_episode_reward = out.stats_loggers['episode_reward'].avg()
        out.max_episode_reward = out.stats_loggers['episode_reward'].max()
        out.min_episode_reward = out.stats_loggers['episode_reward'].min()
        out.avg_episode_road_network_reward = out.stats_loggers['road_network'].avg()
        out.avg_episode_life_circle_reward = out.stats_loggers['life_circle'].avg()
        out.avg_episode_greenness_reward = out.stats_loggers['greenness'].avg()
        out.plans = list(itertools.chain(*[x.plans for x in logger_list]))
        return out
