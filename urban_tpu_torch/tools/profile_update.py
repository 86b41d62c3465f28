"""Where the PPO update's time goes (counterpart of the JAX package's
tools/profile_update.py, which is not imported).

Times, on one trainer (a scenario's trainer at its own capacities, random
weights from a seed):

* two full train iterations (collect + update, no eval): the first makes
  and captures the collect and update programs, the second replays them;
* one epoch of minibatch steps through the update program (graphed on the
  card) and the same epoch stepped eagerly (the Python loop,
  ``ppo.ppo_update_epoch``), on the same rows;
* the epoch's row gather alone (each minibatch's rows into the program's
  buffers);
* one minibatch's loss forward, forward + backward, and the clip + Adam
  step, eagerly;
* on the card, a torch.profiler trace of one graphed and one eager epoch:
  device busy seconds, the idle share, the host's launches and the
  device's kernels a minibatch step, and the kernels that take the most
  device time.

Each time is the least of ``reps`` runs, host clock around work that ends
in a synchronize. Every step it times is a real update step: the model
trains on as it is timed. On the CPU (``--device cpu``: the smoke test) the
profiler part is left out and the device metrics are None; a CPU time says
nothing about the card.

    python -m urban_tpu_torch.tools.profile_update [--cfg hlg] \\
        [--num_envs 256] [--rollout_len 35] [--reps 3]
    python -m urban_tpu_torch.tools.profile_update --device cpu \\
        --num_envs 2 --rollout_len 4 --reps 1
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from urban_tpu_torch import bench
from urban_tpu_torch.rl.ppo import (clip_by_global_norm_, ppo_loss,
                                    ppo_update_epoch)


def _best(fn, device, reps):
    """The least host seconds of `reps` calls of fn(), each ending in a
    synchronize."""
    best = float('inf')
    for _ in range(reps):
        bench._sync(device)
        t0 = time.perf_counter()
        fn()
        bench._sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_update(name: str = 'hlg', num_envs: int = 256,
                   rollout_len: int = 35, device='cuda', seed: int = 0,
                   reps: int = 3) -> dict:
    device = torch.device(device)
    bench.build_kernels(device)
    with tempfile.TemporaryDirectory() as root:
        trainer = bench.make_trainer(num_envs, rollout_len, device, seed,
                                     eval_envs=1, root_dir=root, name=name)
        iterations = []
        for it in range(2):
            st = trainer.train_iteration(it, do_eval=False)
            iterations.append({'t_sample_s': st.sample_time,
                               't_update_s': st.update_time})
        traj = trainer.collect()
        rows = trainer.update_rows(traj)
        T = traj.rewards.shape[0]
        epoch = trainer.epoch_minibatches(T, 2)[0]
        mb = trainer.minibatch_size(T)
        program = trainer.update_program(mb)
        model, optimizer, cfg = trainer.model, trainer.optimizer, \
            trainer.ppo_cfg

        def graphed():
            return program.epoch(rows[:9], *rows[9:14], epoch, rows[14])

        def eager():
            return ppo_update_epoch(model, optimizer, cfg, rows[:9],
                                    *rows[9:14], epoch, rows[14])

        def gather():
            for idx in epoch:
                for buf, src in zip(program.inputs, rows):
                    torch.index_select(src, 0, idx, out=buf)

        batch = tuple(x[epoch[0]] for x in rows)

        def forward():
            return ppo_loss(model, batch[:9], *batch[9:14], cfg, batch[14])

        def forward_backward():
            optimizer.zero_grad(set_to_none=False)
            forward()[0].backward()

        params = list(model.parameters())

        def clip_adam():
            clip_by_global_norm_([p.grad for p in params], cfg.grad_clip)
            optimizer.step()

        out = {
            'device': (torch.cuda.get_device_name(device)
                       if device.type == 'cuda' else 'cpu'),
            'cfg': name, 'num_envs': num_envs, 'rollout_len': rollout_len,
            'num_nodes': trainer.spec.num_features,
            'num_edges': trainer.spec.NE, 'minibatch_rows': mb,
            'minibatches_per_epoch': len(epoch),
            'epochs': trainer.cfg.num_optim_epoch,
            'iterations': iterations,
            'update_graphed': program.graph is not None,
            'update_program': bench.program_stats(program),
            'epoch_graphed_s': _best(graphed, device, reps),
            'epoch_eager_s': _best(eager, device, reps),
            'epoch_row_gather_s': _best(gather, device, reps),
            'minibatch_forward_s': _best(forward, device, reps),
            'minibatch_forward_backward_s': _best(forward_backward, device,
                                                  reps),
            'minibatch_clip_adam_s': _best(clip_adam, device, reps),
            'profile': None}
        if device.type == 'cuda':
            out['profile'] = {
                mode: bench.device_profile(fn, device, len(epoch))
                for mode, fn in (('graphed', graphed), ('eager', eager))}
        out['minibatch_steps_per_sec'] = {
            'graphed': len(epoch) / out['epoch_graphed_s'],
            'eager': len(epoch) / out['epoch_eager_s']}
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg', default='hlg', help='scenario (config id)')
    ap.add_argument('--num_envs', type=int, default=256)
    ap.add_argument('--rollout_len', type=int, default=35)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    a = ap.parse_args(argv)
    out = profile_update(a.cfg, a.num_envs, a.rollout_len, a.device, a.seed,
                         a.reps)
    print(json.dumps(out, default=lambda x: np.asarray(x).tolist()))
    return out


if __name__ == '__main__':
    main()
