"""Data parallelism over torch.distributed (counterpart of
urban_tpu/parallel/mesh.py).

The JAX package shards the environments over a 1-D ``dp`` device mesh and
runs the PPO update under ``shard_map`` with psum'd gradients. Here each
rank is a process that steps its own contiguous block of the
environments, and the update all-reduces the gradients (SUM) before every
rank applies the same clip and Adam step; the parameters are replicated.

* ``make_mesh`` describes this process's rank: its world, its device and
  its process group (``None`` for one rank, which then runs no
  collective at all).
* ``spawn`` starts the ranks (the ``spawn`` start method), joins them
  through a rendezvous file and returns each rank's result; a rank that
  fails fails the run with its traceback. On the card, rank r runs on
  ``cuda:(r % device_count)``; the backend is ``nccl`` when every rank has
  a card of its own and ``gloo`` when ranks share one (one card, many
  ranks) or run on the CPU.
* ``shard_batch`` / ``replicate`` / ``make_dp_ppo_update`` mirror the JAX
  functions of the same names; ``check_replicated`` holds the ranks'
  parameters bitwise equal.

Only this package is imported by a spawned rank: neither the tests nor JAX.
"""
from __future__ import annotations

import copy
import datetime
import functools
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from urban_tpu_torch.models.model import init_like_flax
from urban_tpu_torch.rl.ppo import (STAT_KEYS, PPOConfig, make_optimizer,
                                    ppo_update_step)

# seconds a collective (and the rendezvous) may wait for the other ranks
COLLECTIVE_TIMEOUT = 1800.0
JOIN_TIMEOUT = 60.0      # seconds a rank may take to exit after its result
POLL_SECONDS = 1.0


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world."""
    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any]        # the process group; None for one rank
    backend: Optional[str]      # 'nccl', 'gloo'; None for one rank
    ranks_per_device: int

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place (nothing for one rank)."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n rows."""
        if n % self.world_size:
            raise ValueError(f'{n} rows do not split evenly over '
                             f'{self.world_size} ranks')
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def visible_devices(device) -> int:
    """The number of devices a run on `device` can take: the visible cards
    on CUDA, 1 on the CPU (whose ranks share it)."""
    if torch.device(device).type == 'cuda':
        return torch.cuda.device_count()
    return 1


def choose_backend(n_ranks: int, device) -> tuple:
    """(backend, ranks per device) for n_ranks on `device`: nccl where every
    rank has a card of its own, gloo where ranks share a card or run on
    the CPU. Raises ValueError for an impossible request."""
    if n_ranks < 1:
        raise ValueError(f'a data-parallel run needs at least one rank, '
                         f'not {n_ranks}')
    kind = torch.device(device).type
    if kind == 'cpu':
        return 'gloo', n_ranks
    if kind != 'cuda':
        raise ValueError(f'data parallelism runs on cpu or cuda, not {device}')
    count = torch.cuda.device_count()
    if count < 1:
        raise ValueError(f'{n_ranks} ranks on {device}: no CUDA device is '
                         f'visible')
    per_device = math.ceil(n_ranks / count)
    return ('nccl' if per_device == 1 else 'gloo'), per_device


def rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda':
        return torch.device('cuda', rank % torch.cuda.device_count())
    return dev


def make_mesh(n_devices: int = 1, device='cuda') -> Mesh:
    """This process's mesh. One rank needs no process group; n > 1 ranks
    need an initialized one of exactly n ranks (started by ``spawn``, or
    by torchrun)."""
    if n_devices < 1:
        raise ValueError(f'requested a {n_devices}-rank mesh')
    if n_devices == 1:
        return Mesh(0, 1, torch.device(device), None, None, 1)
    if not dist.is_initialized():
        raise ValueError(f'a {n_devices}-rank mesh needs an initialized '
                         f'process group of {n_devices} ranks (spawn(), or '
                         f'torchrun)')
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f'requested a {n_devices}-rank mesh in a world of '
                         f'{world} ranks')
    _, per_device = choose_backend(n_devices, device)
    rank = dist.get_rank()
    return Mesh(rank, world, rank_device(device, rank), dist.group.WORLD,
                dist.get_backend(), per_device)


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, n_ranks, init_method, backend, device, settings, job,
               results):
    """A spawned rank: join the group, run fn(mesh, *args) (`job`, pickled
    by the parent), send (rank, True, pickled result) or (rank, False,
    traceback) to the parent. Both cross as plain pickles, by value:
    multiprocessing's own pickler would share tensors' memory between the
    processes."""
    try:
        fn, args = pickle.loads(job)
        num_threads, tf32_matmul, tf32_cudnn, timeout = settings
        torch.set_num_threads(num_threads)
        torch.backends.cuda.matmul.allow_tf32 = tf32_matmul
        torch.backends.cudnn.allow_tf32 = tf32_cudnn
        dev = rank_device(device, rank)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(make_mesh(n_ranks, device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception:   # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def _collect(procs, results, deadline: Optional[float]) -> dict:
    """Each rank's result, in rank order of arrival; raises at the first
    failed or vanished rank, or at the deadline."""
    got, missing_since = {}, {}
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=POLL_SECONDS)
        except queue_mod.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in got or p.exitcode is None:
                    continue
                # a rank that exited has flushed what it sent; give the
                # pipe one more poll before calling it lost
                if now - missing_since.setdefault(r, now) > POLL_SECONDS:
                    raise RuntimeError(f'rank {r} exited with code '
                                       f'{p.exitcode} without a result')
            if deadline is not None and now > deadline:
                left = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(f'the data-parallel run passed its '
                                   f'deadline with ranks {left} unfinished')
            continue
        if not ok:
            raise RuntimeError(f'rank {rank} failed:\n{payload}')
        got[rank] = pickle.loads(payload)
    return got


def spawn(fn: Callable, n_ranks: int, device='cuda', args: Sequence = (),
          timeout: Optional[float] = None,
          rendezvous_dir: Optional[str] = None) -> List[Any]:
    """Run fn(mesh, *args) on n_ranks new processes (fn and args must
    pickle: fn by its import path) and return the ranks' results in rank
    order. The ranks rendezvous through a fresh file under rendezvous_dir
    (default: a temporary directory). `timeout` (seconds) bounds the whole
    run and every collective; without it a collective may wait
    COLLECTIVE_TIMEOUT. The ranks take this process's thread count and
    matmul precision flags. A failed rank raises RuntimeError with its
    traceback, after every rank has been stopped."""
    backend, per_device = choose_backend(n_ranks, device)
    print(f'data parallel: {n_ranks} ranks on {device}, backend {backend}, '
          f'{per_device} rank(s) per device', flush=True)
    settings = (torch.get_num_threads(),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
                timeout or COLLECTIVE_TIMEOUT)
    ctx = mp.get_context('spawn')
    deadline = None if timeout is None else time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix='rendezvous_',
                                     dir=rendezvous_dir) as tmp:
        init_method = 'file://' + os.path.join(tmp, 'rendezvous')
        results = ctx.Queue()
        job = pickle.dumps((fn, tuple(args)))
        procs = [ctx.Process(target=_rank_main, name=f'dp_rank_{rank}',
                             args=(rank, n_ranks, init_method, backend,
                                   device, settings, job, results))
                 for rank in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            got = _collect(procs, results, deadline)
        except BaseException:
            # the other ranks may wait in a collective for the failed one
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise
        finally:
            for p in procs:
                p.join(JOIN_TIMEOUT)
                if p.is_alive():
                    p.kill()
                    p.join(JOIN_TIMEOUT)
            results.close()
        unclean = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
        if unclean:
            raise RuntimeError(f'ranks did not exit cleanly: {unclean}')
    return [got[r] for r in range(n_ranks)]


# ---------------------------------------------------------------------------
# the data-parallel pieces of the trainer
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous block of the leading (env) axis of a tensor,
    or of every tensor of a tuple."""
    if isinstance(tree, torch.Tensor):
        return tree[mesh.block(tree.shape[0])]
    return tuple(shard_batch(mesh, x) for x in tree)


def _optimizer_tensors(optimizer: torch.optim.Optimizer):
    for group in optimizer.param_groups:
        for p in group['params']:
            state = optimizer.state.get(p, {})
            for key in sorted(state):
                if isinstance(state[key], torch.Tensor):
                    yield state[key]


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Broadcast the parameters, buffers and optimizer state from rank 0,
    in place. Every rank must hold the same optimizer state layout."""
    if mesh.group is None:
        return
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        tensors += list(_optimizer_tensors(optimizer))
    for t in tensors:
        # Adam's step counts live on the CPU, which nccl cannot send
        x = t if t.device == mesh.device else t.to(mesh.device)
        dist.broadcast(x, src=0, group=mesh.group)
        if x is not t:
            t.copy_(x)


@torch.no_grad()
def check_replicated(mesh: Mesh, model: torch.nn.Module) -> None:
    """Raise on every rank unless every rank's parameters are bitwise
    rank 0's (nothing is re-broadcast)."""
    if mesh.group is None:
        return
    mine = torch.cat([p.detach().reshape(-1).view(torch.int32)
                      for p in model.parameters()])
    ref = mine.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    bad = torch.tensor([int(not torch.equal(mine, ref))],
                       device=mesh.device)
    dist.all_reduce(bad, group=mesh.group)
    if int(bad):
        raise RuntimeError(f'the parameters of {int(bad)} rank(s) differ '
                           f'from rank 0\'s')


def make_dp_ppo_update(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, ppo_cfg: PPOConfig,
                       mesh: Mesh) -> Callable:
    """The data-parallel PPO minibatch step (JAX: mesh.py:51-83):
    step(obs, actions, returns, advantages, fixed_log_probs, exps, valid)
    on this rank's rows of the minibatch, which may be none. It is
    ppo_update_step with the mesh's group: the loss all-reduces its
    weight sums, its backward gives this rank's share of the gradient,
    the gradients are all-reduced (SUM), then every rank applies optax's
    global-norm clip and Adam to the same gradients. Returns the global
    loss stats and grad_norm (of the reduced gradients, before the
    clip)."""
    return functools.partial(ppo_update_step, model, optimizer, ppo_cfg,
                             group=mesh.group)


def local_minibatch_rows(perm: np.ndarray, num_mb: int, mb_size: int,
                         num_envs: int, mesh: Mesh) -> List[np.ndarray]:
    """This rank's rows of each minibatch of a one-device run. The
    one-device run flattens its (T, num_envs) trajectory to rows
    t * num_envs + b and takes minibatch i as perm[i * mb_size:(i + 1) *
    mb_size]; global env b belongs to rank b // (num_envs / world), which
    holds it as local env b - rank * (num_envs / world) of its own (T,
    num_envs / world) trajectory. Returns, per minibatch, this rank's
    local row indices in the minibatch's order (possibly none)."""
    local = mesh.block(num_envs)
    k = local.stop - local.start
    idx = perm[:num_mb * mb_size].reshape(num_mb, mb_size)
    t, b = np.divmod(idx, num_envs)
    rows = t * k + b - local.start
    mine = (b >= local.start) & (b < local.stop)
    return [rows[i][mine[i]] for i in range(num_mb)]


def dp_ppo_steps(mesh: Mesh, model: torch.nn.Module, ppo_cfg: PPOConfig,
                 minibatches: Sequence[tuple],
                 owners: Sequence[np.ndarray]):
    """A rank's run of data-parallel PPO steps on given minibatches (the
    CPU tests' rank body), on a copy of `model`. The ranks but rank 0
    first redraw its parameters from a seed of their own, as after
    another seed; replicate then gives every rank rank 0's. Then for each
    minibatch (obs, actions, returns, advantages, fixed_log_probs, exps,
    valid) each rank steps on the rows whose owner is its rank. Returns
    (parameters on the CPU, the stats of each step as floats)."""
    model = copy.deepcopy(model).to(mesh.device)
    if mesh.rank:
        init_like_flax(model, torch.Generator().manual_seed(mesh.rank))
    optimizer = make_optimizer(model.parameters(), ppo_cfg)
    replicate(mesh, model, optimizer)
    step = make_dp_ppo_update(model, optimizer, ppo_cfg, mesh)
    out = []
    for batch, owner in zip(minibatches, owners):
        idx = torch.as_tensor(np.flatnonzero(np.asarray(owner) == mesh.rank),
                              device=mesh.device)
        obs, *rest = batch
        stats = step(tuple(o.to(mesh.device)[idx] for o in obs),
                     *(x.to(mesh.device)[idx] for x in rest))
        out.append({k: float(stats[k]) for k in (*STAT_KEYS, 'grad_norm')})
    check_replicated(mesh, model)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, out
