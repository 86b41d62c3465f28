"""Trajectory storage.

Reference equivalents: Memory (khrylib/utils/memory.py:4-23) and TrajBatch
(khrylib/rl/core/trajbatch.py:4-16). Because this framework's observations
are fixed-size padded arrays (never ragged lists), states stack into one
batched tuple-of-arrays — the property that lets the whole PPO update run as
a single jitted program (the reference needed TrajBatchDisc keeping python
lists, urban_planning/utils/tools.py:4-16).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class Memory:

    def __init__(self):
        self.memory: List[list] = []

    def push(self, *args) -> None:
        self.memory.append(list(args))

    def append(self, other: 'Memory') -> None:
        self.memory += other.memory

    def sample(self):
        return self.memory

    def __len__(self) -> int:
        return len(self.memory)


def stack_obs(obs_list: Sequence[Sequence[np.ndarray]]) -> Tuple[np.ndarray, ...]:
    """Stack a list of observation tuples into one batched tuple."""
    n_fields = len(obs_list[0])
    return tuple(np.stack([o[i] for o in obs_list]) for i in range(n_fields))


class TrajBatch:
    """Batched trajectories with array states."""

    def __init__(self, memory_list: Sequence[Memory]):
        memory = memory_list[0]
        for m in memory_list[1:]:
            memory.append(m)
        rows = memory.sample()
        states, actions, masks, next_states, rewards, exps = zip(*rows)
        self.states = stack_obs(states)
        self.actions = np.stack(actions).astype(np.int32)
        self.masks = np.asarray(masks, dtype=np.float32)
        self.rewards = np.asarray(rewards, dtype=np.float32)
        self.exps = np.asarray(exps, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.actions)
