"""The host agent's policy step as one captured program: the port's
counterpart of the jitted ``select_action_mixed`` that the JAX host agent
builds (urban_tpu/agents/urban_agent.py:136-146), one compiled call a
step.

A ``PolicyProgram`` owns static device buffers for one observation of
fixed shapes (the host env pads it to the config's caps) and the
``use_mean`` row, all views of one device byte buffer, and a pinned host
byte buffer of the same layout. Its region is the model's
``select_action_mixed`` on those buffers (the SGNN's two segment means
through the forward kernel), drawing from one ``torch.Generator`` that is
registered with the graph. The region is captured once, after an eager
warm-up on a side stream, into a ``torch.cuda.CUDAGraph``; a step then
packs the observation into the host buffer, makes one host-to-device
copy, reseeds the generator from the sampler's per-step seed, replays
the graph and copies the action back: the draws are those of a fresh
generator seeded alike, which the eager select makes each step. A
program is made for a CUDA model only (on the CPU the agent runs
``eager_select``); a capture or a replay that fails raises, nothing
falls back.

The capture holds the model's parameter tensors, which the agent's
update and ``load_state_dict`` change in place: a new parameter value
needs no new capture. Kernel launches are counted in Python
(``segment_ops.launches``): the warm-up and the capture do not count,
each replay adds the launches of the capture.
"""
from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch

from urban_tpu_torch.ops import segment_ops

# dtypes of the host observation's nine arrays on the device (the SGNN's
# observation layout, models/encoder.py)
OBS_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32,
              torch.bool, torch.bool, torch.bool, torch.bool, torch.float32)
NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}
ALIGN = 16


def obs_to_torch(obs, device) -> tuple:
    """A batched host observation (nine numpy arrays, edges int64) as the
    model's tensors on `device`."""
    return tuple(torch.as_tensor(np.asarray(o), dtype=dt).to(device)
                 for o, dt in zip(obs, OBS_DTYPES))


def eager_select(model, device):
    """The policy step run eagerly: select(obs, seed, mean_action) -> the
    (B, 2) action, the observation copied to `device` and a generator
    made and seeded `seed` each call."""
    dev = torch.device(device)

    @torch.no_grad()
    def select(obs, seed, mean_action):
        obs_t = obs_to_torch(obs, dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        use_mean = torch.full(obs_t[0].shape[:1], bool(mean_action),
                              device=dev)
        return model.select_action_mixed(obs_t, gen, use_mean).cpu().numpy()
    return select


def graphed_select(model, device):
    """The policy step through a PolicyProgram: select(obs, seed,
    mean_action) -> the (B, 2) action, one program for each observation
    shape (made on first use, kept in select.programs)."""
    programs = {}

    def select(obs, seed, mean_action):
        shapes = tuple(np.shape(o) for o in obs)
        if shapes not in programs:
            programs[shapes] = PolicyProgram(model, shapes, device)
        return programs[shapes](obs, seed, mean_action)
    select.programs = programs
    return select


class PolicyProgram:

    def __init__(self, model, shapes: Sequence[Tuple[int, ...]], device):
        """shapes: the nine observation arrays' shapes (batch leading)."""
        self.model = model
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError(f'a PolicyProgram captures on a CUDA device, '
                             f'not {self.device}')
        self.shapes = tuple(tuple(s) for s in shapes)
        batch = self.shapes[0][0]
        layout, offset = [], 0
        for shape, dtype in zip(self.shapes + ((batch,),),
                                OBS_DTYPES + (torch.bool,)):
            nbytes = int(np.prod(shape)) * dtype.itemsize
            layout.append((offset, nbytes, shape, dtype))
            offset += -(-nbytes // ALIGN) * ALIGN
        self.layout = layout
        self.device_bytes = torch.zeros(offset, dtype=torch.uint8,
                                        device=self.device)
        self.host_bytes = torch.zeros(offset, dtype=torch.uint8,
                                      pin_memory=True)
        self.host_view = self.host_bytes.numpy()
        views = [self.device_bytes[o:o + n].view(dt).view(shape)
                 for o, n, shape, dt in layout]
        self.obs, self.use_mean = tuple(views[:9]), views[9]
        self.generator = torch.Generator(device=self.device)
        self.action_host = torch.zeros((batch, 2), dtype=torch.int32,
                                       pin_memory=True)
        self._capture()

    @torch.no_grad()
    def _step(self):
        return self.model.select_action_mixed(self.obs, self.generator,
                                              self.use_mean)

    def _capture(self) -> None:
        """The warm-up, then the capture into self.graph (its output
        self.out, its launches self.launches); neither counts."""
        counts = dict(segment_ops.launches)
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = dict(segment_ops.launches)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self.out = self._step()
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {k: segment_ops.launches[k] - before[k]
                         for k in before}
        segment_ops.launches.update(counts)
        self.graph = graph

    def __call__(self, obs, seed: int, mean_action: bool) -> np.ndarray:
        """The (B, 2) action of the batched host observation `obs` (nine
        numpy arrays): sampled from a generator seeded `seed`, or the
        argmax with mean_action."""
        arrays = tuple(obs) + (np.full(self.shapes[0][:1],
                                       bool(mean_action)),)
        for (o, n, shape, dt), a in zip(self.layout, arrays):
            a = np.ascontiguousarray(a, dtype=NP_DTYPES[dt])
            if a.shape != shape:
                raise ValueError(f'observation of shape {a.shape} where '
                                 f'the program holds {shape}')
            self.host_view[o:o + n] = a.reshape(-1).view(np.uint8)
        self.device_bytes.copy_(self.host_bytes, non_blocking=True)
        self.generator.manual_seed(int(seed))
        self.graph.replay()
        for name, k in self.launches.items():
            segment_ops.launches[name] += k
        self.action_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self.action_host.numpy().copy()
