"""One PPO minibatch step as one captured program: the port's counterpart
of the jitted ``ppo_update_epoch`` of urban_tpu/rl/ppo.py (:98-149), where
jax.jit runs a lax.scan of the minibatch step over an epoch in one
dispatch.

An ``UpdateProgram`` owns static buffers of one minibatch of ``batch``
rows: the 9 observation tensors, the actions, returns, advantages, fixed
log-probs, exploration weights and success weights. Its region is one
``ppo_update_step``: the loss forward (the SGNN's segment means through
the forward kernel), autograd (``SegmentMean.backward`` through the
backward kernel), optax's global-norm clip and the capturable Adam step,
all in place on the model and the optimizer. On CUDA parameters the
region is captured once into a ``torch.cuda.CUDAGraph`` and each later
minibatch replays it. The first minibatch step runs eagerly on a side
stream as the real first step (it also makes the gradients and Adam's
moments, which the capture then holds), so the program takes exactly the
steps of the Python loop (``ppo.ppo_update_epoch``) and leaves the same
parameters and optimizer state. On the CPU, or with ``eager=True``, every
minibatch calls the same function on the same buffers. A capture or a
replay that fails raises; nothing falls back.

Each minibatch's rows are gathered into the buffers outside the graph
(``torch.index_select(..., out=buf)``, one launch a tensor), then the
graph replays, then the step's loss stats and gradient norm are copied
out of its static output. The capture holds the model's parameters, their
gradients and the optimizer's state tensors: loading an optimizer state
(``load_state_dict`` replaces them) or building a new optimizer needs a
new program. Kernel launches are counted in Python
(``segment_ops.launches``): the warm-up step counts as the step it is,
the capture does not, and each replay adds the launches of the capture.

Data parallelism keeps the eager loop: a rank's rows change from
minibatch to minibatch, and a process group's all-reduce cannot be
captured (as in the JAX trainer, which scans an epoch only without a
mesh).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from urban_tpu_torch.ops import segment_ops
from urban_tpu_torch.rl.ppo import STAT_KEYS, PPOConfig, ppo_update_step

# what a minibatch step returns: the loss stats, then the global norm of
# the gradients before the clip
STEP_KEYS = STAT_KEYS + ('grad_norm',)


class UpdateProgram:

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, cfg: PPOConfig,
                 batch: int, eager: bool = False, pool=None):
        """batch: the rows of every minibatch; pool: a graph memory pool
        (torch.cuda.graph_pool_handle()) to share with programs that never
        replay at the same time."""
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.batch = batch
        self.device = next(model.parameters()).device
        self.captures = self.device.type == 'cuda' and not eager
        self.pool = pool
        self.inputs: Optional[List[torch.Tensor]] = None   # static buffers
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        # the (len(STEP_KEYS),) outputs of the last epoch's minibatches
        self.minibatch_stats: List[torch.Tensor] = []
        # a replay's launches; the seconds of the warm-up step, the capture
        # and the instantiation; the bytes the graph's pool reserved
        self.launches = dict.fromkeys(segment_ops.launches, 0)
        self.warmup_seconds = self.capture_seconds = None
        self.instantiate_seconds = None
        self.pool_bytes = None

    def _step(self) -> torch.Tensor:
        """The captured region, on the input buffers."""
        *obs, actions, returns, advantages, fixed_lp, exps, valid = \
            self.inputs
        stats = ppo_update_step(self.model, self.optimizer, self.cfg,
                                tuple(obs), actions, returns, advantages,
                                fixed_lp, exps, valid)
        return torch.stack([stats[k] for k in STEP_KEYS])

    def _capture(self) -> torch.Tensor:
        """The first step eagerly on a side stream (a real step: its
        launches count), then the capture of the next one (not a step: the
        launch counts are put back). Returns the first step's output."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            first = self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0
        # the capture empties the cache too: what it reserves is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(segment_ops.launches)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool):
            self.out = self._step()
        t1 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_seconds = time.perf_counter() - t1
        self.capture_seconds = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: segment_ops.launches[k] - before[k]
                         for k in before}
        segment_ops.launches.update(before)
        self.graph = graph
        return first

    def step(self, sources: Sequence[torch.Tensor],
             rows: torch.Tensor) -> torch.Tensor:
        """One minibatch step on `rows` (batch row indices, on the device)
        of `sources`: the 9 observation tensors, actions, returns,
        advantages, fixed log-probs, exps and valid, rows leading. Returns
        a new (len(STEP_KEYS),) tensor of the step's stats."""
        if rows.shape != (self.batch,):
            raise ValueError(f'a minibatch of this program has {self.batch} '
                             f'rows, not {tuple(rows.shape)}')
        if self.inputs is None:
            self.inputs = [torch.empty((self.batch,) + tuple(s.shape[1:]),
                                       dtype=s.dtype, device=self.device)
                           for s in sources]
        for buf, src in zip(self.inputs, sources, strict=True):
            torch.index_select(src, 0, rows, out=buf)
        if self.graph is not None:
            self.graph.replay()
            for name, n in self.launches.items():
                segment_ops.launches[name] += n
            return self.out.clone()
        if self.captures:
            return self._capture()
        return self._step()

    def epoch(self, obs, actions, returns, advantages, fixed_log_probs, exps,
              minibatches: Sequence[torch.Tensor],
              valid=None) -> Dict[str, torch.Tensor]:
        """ppo.ppo_update_epoch through the program: one step for each
        tensor of `batch` row indices in `minibatches`. Returns the mean
        of the per-minibatch loss stats (device tensors; nothing syncs the
        host) and keeps each step's output in minibatch_stats."""
        if valid is None:
            valid = torch.ones_like(exps)
        sources = (*obs, actions, returns, advantages, fixed_log_probs, exps,
                   valid)
        self.minibatch_stats = [self.step(sources, idx)
                                for idx in minibatches]
        means = torch.stack([s[:len(STAT_KEYS)]
                             for s in self.minibatch_stats]).mean(dim=0)
        return dict(zip(STAT_KEYS, means))
