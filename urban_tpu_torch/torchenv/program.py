"""One step of a batched rollout as one captured program: the port's
counterpart of the compiled program of urban_tpu/jaxenv/rollout.py, where
jax.jit runs a lax.scan of the vmapped step as one dispatch.

A ``StepProgram`` owns the static buffers of one step of B envs: the input
``PlanState``, the initial batch that finished envs reset to, and the
step's outputs. Its region is ``reset_done`` -> ``build_obs`` -> the
policy's ``sample_action_logp_value`` (the SGNN's segment means through
the forward kernel) -> ``env_step``, vmapped over the batch, with the
stage rewards deferred (``make_batch_fns``). On a CUDA state the region is
captured once into a ``torch.cuda.CUDAGraph``, after an eager warm-up on a
side stream, and ``run`` replays it: one launch for the whole step. On a
CPU state, the tests' reference, or with ``eager=True``, ``run`` calls the
same function on the same buffers. A capture or a replay that fails
raises; nothing falls back.

What cannot be captured stays outside, run eagerly by the loops of
``rollout.py`` between replays: ``apply_stage_rewards`` (host-synced
branches, on the finishing rows only) and the copy of the next state into
the input buffers. The outputs are static: the next replay overwrites
them, so whatever a caller keeps across steps is a copy.

The sampling generator (a ``RowShard``'s, for a data-parallel rank) is
registered with the graph, so replay t draws what eager step t draws from
the same generator state and advances it as far. Kernel launches are
counted in Python (``segment_ops.launches``), so each replay adds the
launches that its capture made.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from urban_tpu_torch.models.policy import RowShard, uniform
from urban_tpu_torch.ops import segment_ops
from urban_tpu_torch.torchenv.state import FIELD_NAMES, EnvSpec, PlanState

# bench: sampled actions, auto-reset; collect: explore where a uniform
# draw is below noise_rate (else argmax), auto-reset, the trajectory's
# outputs; eval: argmax actions, no reset; ga: the GA's gene policy
# (rl/ga.py GenePolicy in the model's place) decides, no reset
KINDS = ('bench', 'collect', 'eval', 'ga')
NO_RESET = ('eval', 'ga')


class StepProgram:

    def __init__(self, spec: EnvSpec, model, init_state: PlanState,
                 batch: int, kind: str, generator, noise_rate: float = 1.0,
                 eager: bool = False, pool=None):
        """init_state: one env's initial state (the reset target and the
        buffers' shapes); generator: a torch.Generator on the state's
        device or a RowShard of one; pool: a graph memory pool
        (torch.cuda.graph_pool_handle()) to share with other programs
        that never replay at the same time."""
        from urban_tpu_torch.torchenv.rollout import make_batch_fns
        if kind not in KINDS:
            raise ValueError(f'kind must be one of {KINDS}, not {kind!r}')
        self.spec, self.model, self.kind = spec, model, kind
        self.batch, self.generator, self.noise_rate = (batch, generator,
                                                       noise_rate)
        self.device = init_state.stage.device
        self.batch_obs, self.batch_step = make_batch_fns(spec)
        self.init_b = (None if kind in NO_RESET
                       else broadcast_state(init_state, batch))
        self.state = broadcast_state(init_state, batch)   # input buffers
        self.use_mean = torch.full((batch,), kind == 'eval',
                                   dtype=torch.bool, device=self.device)
        self.out: Optional[Dict] = None
        self.graph = None
        # a replay's launches; the seconds of the warm-up, the capture and
        # the instantiation; the bytes the graph's pool reserved
        self.launches = dict.fromkeys(segment_ops.launches, 0)
        self.warmup_seconds = self.capture_seconds = None
        self.instantiate_seconds = None
        self.pool_bytes = None
        if self.device.type == 'cuda' and not eager:
            self._capture(pool)

    @torch.no_grad()
    def _step(self) -> Dict:
        """The captured region, on the input buffers."""
        state, out = self.state, {}
        if self.kind not in NO_RESET:
            out['was_reset'] = state.done.clone()
            state = reset_done(self.init_b, state)
        obs = self.batch_obs(state)
        use_mean = self.use_mean
        if self.kind == 'collect':
            use_mean = uniform((self.batch,), self.generator,
                               self.device) >= self.noise_rate
        action, log_prob, value = self.model.sample_action_logp_value(
            obs, self.generator, use_mean)
        nxt, reward, done, info = self.batch_step(state, action)
        out.update(state=nxt, reward=reward, done=done, info=info,
                   action=action)
        if self.kind == 'collect':
            out.update(obs=obs, log_prob=log_prob[..., 0],
                       value=value[..., 0],
                       explored=(~use_mean).to(torch.float32))
        return out

    def _capture(self, pool) -> None:
        """Warm up eagerly on a side stream (it builds and loads the kernel
        libraries, and makes the constant tables that the step caches),
        then capture the step. Neither the warm-up nor the capture counts
        as a step: the generator's state and the launch counts are put
        back as they were."""
        dev, gen = self.device, self.generator
        if isinstance(gen, RowShard):
            gen = gen.generator
        gen_state = gen.get_state()
        counts = dict(segment_ops.launches)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0
        gen.set_state(gen_state)
        # the capture empties the cache too: what it reserves is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(gen)
        before = dict(segment_ops.launches)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool):
            self.out = self._step()
        t1 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_seconds = time.perf_counter() - t1
        self.capture_seconds = t1 - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: segment_ops.launches[k] - before[k]
                         for k in before}
        segment_ops.launches.update(counts)
        if not torch.equal(gen.get_state(), gen_state):
            raise RuntimeError('the capture moved the sampling generator')
        self.graph = graph

    def run(self, state: PlanState) -> Dict:
        """One step from `state`: copy it into the input buffers, then
        replay the graph (or call the step). Returns the outputs: a dict
        of state, reward, done, info and action, with was_reset unless
        kind is eval or ga, and obs, log_prob, value and explored for
        collect; static on the card, overwritten by the next run."""
        for name in FIELD_NAMES:
            dst, src = getattr(self.state, name), getattr(state, name)
            if dst is not src:
                dst.copy_(src)
        if self.graph is None:
            self.out = self._step()
            return self.out
        self.graph.replay()
        for name, n in self.launches.items():
            segment_ops.launches[name] += n
        return self.out


def broadcast_state(state: PlanState, batch: int) -> PlanState:
    return state.map(lambda x: x.expand((batch,) + x.shape).clone())


def reset_done(init_b: PlanState, state: PlanState) -> PlanState:
    """Replace finished environments with the initial state."""
    done = state.done
    return PlanState(*(
        torch.where(done.reshape((-1,) + (1,) * (s.dim() - 1)), i, s)
        for i, s in ((getattr(init_b, n), getattr(state, n))
                     for n in FIELD_NAMES)))
