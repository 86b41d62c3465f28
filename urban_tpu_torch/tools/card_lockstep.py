"""The port's PPO trainer on the card against the same trainer on the CPU,
across iterations.

Two ``rl.trainer.Trainer``s on a scenario (``--cfg``: HLG at the
trainer's caps, N = 1344 nodes, E = 3000 edges; or the planning-concept
scenario hlg_concept, N = 1344, E = 4000, whose concept term enters the
reward at the land-use stage's end) under the learning-parity recipe's
flags (normalized
advantages, tau 0.95; the config's lr 4e-4, 4 epochs, minibatch 256): one
on the device under test, stepping eagerly (``eager=True``: served noise
cannot enter a captured graph, and the graphs are held to the eager loop
elsewhere), one on the reference device, the CPU. Both start from the
port's initial draw at the seed, made on the CPU (``init_like_flax``) and
copied to the device; the comparison checks the copies are equal bit for
bit. Both take the same sampling noise: uniforms drawn from
``np.random.default_rng(NOISE_SEED)`` and served, draw by draw, through
the port's one draw function (``models.policy.uniform``, also looked up
by ``torchenv/program.py``): for each collect step the exploration draw
(B,), then the land-use head's (B, E) and the road head's (B, N); for
each eval step the two heads'. A served queue that is left over after a
part of an iteration, or runs out, raises.

Each side runs ``iterations`` train iterations (collect -> weights ->
update -> eval) and one more collect, on its own: neither side reads the
other, so the two sides may run one after the other or at once
(``--concurrent``: the reference side in a spawned process). Then
``compare`` holds the device's record to the reference's:

- every action, done, failure and exploration flag equal; an action may
  differ only where the perturbed top-2 gap of its decision (the logits
  plus Gumbel noise of the head of its stage where it explored, the
  logits where it took the argmax) is under TIE_GAP, and each differing
  action is reported with its gap;
- rewards, values and log-probs within rtol 1e-5 / atol 1e-4;
- the loss statistics within 1e-4, the value-vs-Monte-Carlo RMS within
  1e-5;
- every parameter within STEP_ATOL an Adam step, added up over the
  iterations, and Adam's step count equal;
- the episodes and failures equal; the mean episode reward, the success
  fraction, the eval reward and best_reward within rtol 1e-5 / atol 1e-4,
  best_iteration equal.

It reports each parameter group's largest deviation an iteration (the
node encoder, each GCN layer's edge_fc, the attention, the state MLP, the
heads, the value MLP), the kernels' launches on the device in each part,
and the launch plans of the batches that ran.

    python -m urban_tpu_torch.tools.card_lockstep --encoder sgnn
    python -m urban_tpu_torch.tools.card_lockstep --encoder mlp
    python -m urban_tpu_torch.tools.card_lockstep --num_envs 136 \\
        --iterations 1 --concurrent --out lockstep_136.json
    python -m urban_tpu_torch.tools.card_lockstep --cfg hlg_concept \\
        --concurrent
    python -m urban_tpu_torch.tools.card_lockstep --gcn_node_dim 24 \\
        --max_num_edges 40000 --concurrent
    python -m urban_tpu_torch.tools.card_lockstep --device cpu \\
        --num_envs 2 --iterations 1

``--gcn_node_dim`` and ``--max_num_edges`` override the scenario's
``state_encoder_specs`` (the SGNN's width and the edge slots, the
trainer's E), on both sides, as JAX's trainer takes the same overridden
config: at width 24 and 40,000 edge slots HLG's graph takes the forward
kernel's general plan and its runtime-width paths.

Without a card, ``--device cpu`` runs both sides on the CPU, which must
agree bit for bit.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import multiprocessing
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.models import policy
from urban_tpu_torch.ops import segment_ops
from urban_tpu_torch.rl.trainer import Trainer
from urban_tpu_torch.torchenv import program

SEED, NOISE_SEED = 111, 0
NUM_ENVS, ROLLOUT_LEN, EVAL_ENVS, ITERATIONS = 8, 35, 2, 2
STEP_ATOL = 4e-5          # a parameter's bound, an Adam step
RTOL, ATOL = 1e-5, 1e-4   # the env lockstep's float rule
LOSS_TOL = 1e-4           # the loss statistics, rtol and atol
MC_RMS_TOL = 1e-5         # the value-vs-Monte-Carlo RMS, rtol and atol
TIE_GAP = 1e-5            # a top-2 gap this small may tie
TRAJECTORY_INTS = ('actions', 'dones', 'failures', 'exps')
TRAJECTORY_FLOATS = ('rewards', 'values', 'log_probs')
ITERATION_COUNTS = ('episodes', 'failures', 'best_iteration')
ITERATION_FLOATS = ('mean_episode_reward', 'success_frac', 'eval_reward',
                    'best_reward')


def recipe_config(root_dir: str, cfg_id: str = 'hlg',
                  encoder_specs: Optional[dict] = None) -> Config:
    """The scenario's config at SEED under the learning-parity recipe's
    flags, its state_encoder_specs updated with `encoder_specs` (e.g.
    gcn_node_dim, max_num_edges)."""
    cfg = Config(cfg_id, SEED, tmp=False, root_dir=root_dir)
    cfg.agent_specs = dict(cfg.agent_specs, normalize_advantages=True)
    cfg.tau = 0.95
    if encoder_specs:
        cfg.state_encoder_specs = dict(cfg.state_encoder_specs,
                                       **encoder_specs)
    return cfg


def parameter_group(name: str) -> str:
    """The group a parameter's deviation is reported under: each GCN
    layer's edge_fc, the other modules of the state encoder, the heads,
    the value MLP."""
    parts = name.split('.')
    if parts[0] == 'shared_net':
        return '.'.join(parts[1:3] if parts[1] == 'edge_fc' else parts[1:2])
    return parts[0]


class ServedNoise:
    """Stands in for policy.uniform: serves queued draws in order. A draw
    of another shape than the one asked for, a queue that runs out, and
    (check_used) a queue with draws left over raise."""

    def __init__(self):
        self.queue: List[np.ndarray] = []

    def serve(self, draws: List[np.ndarray]) -> None:
        self.check_used('before serving more')
        self.queue = list(draws)

    def check_used(self, where: str) -> None:
        if self.queue:
            raise RuntimeError(f'{where}: {len(self.queue)} served draws '
                               f'left over')

    def __call__(self, shape, generator, device, dtype=torch.float32):
        if not self.queue:
            raise RuntimeError(f'the served noise ran out (asked for '
                               f'{tuple(shape)})')
        u = self.queue.pop(0)
        if tuple(u.shape) != tuple(shape):
            raise RuntimeError(f'a served draw of {u.shape} where '
                               f'{tuple(shape)} was asked for')
        return torch.as_tensor(u, dtype=dtype, device=device)


def collect_draws(rng, steps: int, batch: int, num_edges: int,
                  num_nodes: int) -> List[np.ndarray]:
    """A collect's uniforms in the order it asks for them: each step's
    exploration draw, then the land-use and the road head's."""
    out = []
    for _ in range(steps):
        out += [rng.random((batch,), dtype=np.float32),
                rng.random((batch, num_edges), dtype=np.float32),
                rng.random((batch, num_nodes), dtype=np.float32)]
    return out


def eval_draws(rng, steps: int, batch: int, num_edges: int,
               num_nodes: int) -> List[np.ndarray]:
    """A greedy eval's uniforms: each step's two heads' (drawn, unused)."""
    out = []
    for _ in range(steps):
        out += [rng.random((batch, num_edges), dtype=np.float32),
                rng.random((batch, num_nodes), dtype=np.float32)]
    return out


def _top2_gap(x: torch.Tensor) -> np.ndarray:
    top = torch.topk(x, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


class GapRecorder:
    """Stands in for policy.gumbel_scores: the same scores, and for each
    call the top-2 gap of each row of the scores (the perturbed logits)
    and of the logits themselves."""

    def __init__(self, scores):
        self.scores = scores
        self.calls = []

    def __call__(self, logits, generator):
        out = self.scores(logits, generator)
        with torch.no_grad():
            self.calls.append((_top2_gap(out), _top2_gap(logits)))
        return out


def decision_gaps(calls, stage: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """(T, B) top-2 gap of each collect action's decision from a collect's
    gap records (the land-use head's call, then the road head's, each
    step): the perturbed gap of the head of the row's stage where it
    explored, the logits' gap where it took the argmax; inf where the row
    is in neither stage (its action is 0)."""
    T, B = exps.shape
    gaps = np.full((T, B), np.inf)
    for t in range(T):
        (lu_p, lu_l), (road_p, road_l) = calls[2 * t], calls[2 * t + 1]
        explored = exps[t] > 0
        lu = np.where(explored, lu_p, lu_l)
        road = np.where(explored, road_p, road_l)
        gaps[t] = np.where(stage[t, :, 0] > 0.5, lu,
                           np.where(stage[t, :, 1] > 0.5, road, np.inf))
    return gaps


@contextlib.contextmanager
def served(noise: ServedNoise, recorder: GapRecorder):
    """Within the block the port draws its uniforms from `noise` and its
    Gumbel scores through `recorder`."""
    saved = (policy.uniform, program.uniform, policy.gumbel_scores)
    policy.uniform = program.uniform = noise
    policy.gumbel_scores = recorder
    try:
        yield
    finally:
        policy.uniform, program.uniform, policy.gumbel_scores = saved


def _numpy_params(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def launch_plans(trainer: Trainer) -> dict:
    """The forward plans of the collect's, the update minibatch's and the
    eval's batch and the backward plan, on the trainer's card (None on
    the CPU, which runs the plain versions)."""
    if trainer.device.type != 'cuda' or trainer.encoder != 'sgnn':
        return None
    limits = segment_ops.device_limits(trainer.device)
    n, e = trainer.spec.num_features, trainer.spec.NE
    width = trainer.cfg.state_encoder_specs['gcn_node_dim']
    batches = {'collect': trainer.local_envs,
               'update': trainer.minibatch_size(trainer.rollout_len),
               'eval': trainer.eval_envs}
    return {'limits': limits._asdict(),
            'forward': {part: segment_ops.forward_plan(
                b, n, e, width, limits)._asdict()
                for part, b in batches.items()},
            'backward': segment_ops.backward_plan(n, width,
                                                  limits)._asdict()}


def run_side(device: str, encoder: str = 'sgnn', cfg: str = 'hlg',
             num_envs: int = NUM_ENVS,
             rollout_len: int = ROLLOUT_LEN, eval_envs: int = EVAL_ENVS,
             iterations: int = ITERATIONS,
             threads: Optional[int] = None,
             encoder_specs: Optional[dict] = None) -> dict:
    """One side of the lockstep: an eager trainer on scenario `cfg` (its
    state_encoder_specs updated with `encoder_specs`) on `device` through
    `iterations` train iterations and one more collect on the served
    noise. Returns its record (numpy and plain values only): the initial
    parameters, each collect's trajectory and decision gaps, and each
    iteration's statistics, parameters, Adam steps and launches."""
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == 'cuda':
        from urban_tpu_torch.bench import set_precision_flags
        set_precision_flags()
    with tempfile.TemporaryDirectory() as root_dir:
        trainer = Trainer(recipe_config(root_dir, cfg, encoder_specs),
                          num_envs=num_envs,
                          rollout_len=rollout_len, eval_envs=eval_envs,
                          device=dev, encoder=encoder, eager=True)
        record = _run(trainer, iterations)
    if dev.type == 'cuda':
        # the card side's cached memory goes back to the card before the
        # reference side, minutes longer on the CPU, is waited for
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return record


def _run(trainer: Trainer, iterations: int) -> dict:
    T, B, E, N = (trainer.rollout_len, trainer.num_envs, trainer.spec.NE,
                  trainer.spec.num_features)
    rng = np.random.default_rng(NOISE_SEED)
    noise, recorder = ServedNoise(), GapRecorder(policy.gumbel_scores)
    record = {'device': str(trainer.device), 'encoder': trainer.encoder,
              'sizes': {'cfg': trainer.cfg.id, 'num_envs': B,
                        'rollout_len': T,
                        'eval_envs': trainer.eval_envs, 'nodes': N,
                        'edges': E, 'iterations': iterations},
              'widths': {'gcn_node_dim': trainer.cfg.state_encoder_specs[
                  'gcn_node_dim']},
              'init_params': _numpy_params(trainer.model),
              'plans': launch_plans(trainer),
              'collects': [], 'iterations': []}
    last = []   # the last collect's trajectory
    collect = trainer.collect

    def kept_collect():
        last[:] = [collect()]
        return last[0]
    trainer.collect = kept_collect
    t_start = time.perf_counter()
    with served(noise, recorder):
        for it in range(iterations + 1):
            draws = collect_draws(rng, T, B, E, N)
            if it < iterations:
                draws += eval_draws(rng, T, trainer.eval_envs, E, N)
            noise.serve(draws)
            recorder.calls.clear()
            before = dict(segment_ops.launches)
            if it < iterations:
                st = trainer.train_iteration(it)
            else:
                trainer.collect()
                if trainer.device.type == 'cuda':
                    torch.cuda.synchronize(trainer.device)
            noise.check_used(f'iteration {it}' if it < iterations
                             else 'the last collect')
            traj = last[0]
            kept = {name: getattr(traj, name).cpu().numpy()
                    for name in TRAJECTORY_INTS + TRAJECTORY_FLOATS}
            kept['gaps'] = decision_gaps(recorder.calls[:2 * T],
                                         traj.obs[-1].cpu().numpy(),
                                         kept['exps'])
            record['collects'].append(kept)
            if it == iterations:
                record['last_collect_launches'] = {
                    k: segment_ops.launches[k] - before[k] for k in before}
                break
            record['iterations'].append({
                'episodes': st.episodes, 'failures': st.failures,
                'mean_episode_reward': st.mean_episode_reward,
                'success_frac': st.success_frac,
                'eval_reward': st.eval_reward,
                'best_reward': trainer.best_reward,
                'best_iteration': trainer.best_iteration,
                'losses': dict(st.losses),
                'value_mc_rms': trainer.last_value_mc_rms,
                'adam_steps': sorted({int(s['step']) for s in
                                      trainer.optimizer.state.values()}),
                'params': _numpy_params(trainer.model),
                'launches': st.kernel_launches})
    record['seconds'] = time.perf_counter() - t_start
    return record


def _close(a, b, rtol, atol) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True))


def compare(card: dict, ref: dict) -> dict:
    """The device side's record against the reference side's, by the
    rules of the module docstring. Returns a report: 'ok', the failed
    checks in 'failures', and for each collect and iteration what was
    compared."""
    failures = []
    if (card['sizes'] != ref['sizes'] or card['encoder'] != ref['encoder']
            or card['widths'] != ref['widths']):
        raise ValueError(f'records of other runs: {card["sizes"]} '
                         f'{card["widths"]} {ref["sizes"]} {ref["widths"]}')
    same_init = all(np.array_equal(card['init_params'][k], v)
                    for k, v in ref['init_params'].items())
    if not same_init:
        failures.append('the initial parameters differ')
    collects = []
    for c, (a, b) in enumerate(zip(card['collects'], ref['collects'])):
        where = f'collect {c}'
        bad = np.argwhere((a['actions'] != b['actions']).any(-1))
        differing = [{'step': int(t), 'env': int(e),
                      'gap': float(min(a['gaps'][t, e], b['gaps'][t, e]))}
                     for t, e in bad]
        if any(d['gap'] >= TIE_GAP for d in differing):
            failures.append(f'{where}: actions differ at {differing}')
        row = {'differing_actions': differing,
               'least_gap': float(min(a['gaps'].min(), b['gaps'].min()))}
        for name in TRAJECTORY_INTS[1:]:
            if not np.array_equal(a[name], b[name]):
                failures.append(f'{where}: {name} differ')
        for name in TRAJECTORY_FLOATS:
            row[f'{name}_max_abs_diff'] = float(
                np.abs(a[name] - b[name]).max())
            if not _close(a[name], b[name], RTOL, ATOL):
                failures.append(f'{where}: {name} beyond rtol {RTOL} / '
                                f'atol {ATOL}: {row[name + "_max_abs_diff"]}')
        collects.append(row)
    iterations = []
    for i, (a, b) in enumerate(zip(card['iterations'], ref['iterations'])):
        where = f'iteration {i}'
        for name in ITERATION_COUNTS:
            if a[name] != b[name]:
                failures.append(f'{where}: {name} {a[name]} != {b[name]}')
        for name in ITERATION_FLOATS:
            if not _close(a[name], b[name], RTOL, ATOL):
                failures.append(f'{where}: {name} {a[name]} != {b[name]}')
        loss_diff = {k: abs(float(v) - float(b['losses'][k]))
                     for k, v in a['losses'].items()}
        for k, v in a['losses'].items():
            if not _close(float(v), float(b['losses'][k]), LOSS_TOL,
                          LOSS_TOL):
                failures.append(f'{where}: loss {k} {v} != '
                                f'{b["losses"][k]}')
        if not _close(a['value_mc_rms'], b['value_mc_rms'], MC_RMS_TOL,
                      MC_RMS_TOL):
            failures.append(f'{where}: value_mc_rms {a["value_mc_rms"]} '
                            f'!= {b["value_mc_rms"]}')
        if a['adam_steps'] != b['adam_steps'] or len(a['adam_steps']) != 1:
            failures.append(f'{where}: Adam steps {a["adam_steps"]} != '
                            f'{b["adam_steps"]}')
        bound = max(b['adam_steps']) * STEP_ATOL
        groups: Dict[str, float] = {}
        for k, v in b['params'].items():
            dev = float(np.abs(a['params'][k] - v).max())
            g = parameter_group(k)
            groups[g] = max(groups.get(g, 0.0), dev)
            if not dev <= bound:
                failures.append(f'{where}: parameter {k} off by {dev} > '
                                f'{bound}')
        iterations.append({'adam_steps': b['adam_steps'][0],
                           'parameter_bound': bound,
                           'group_max_abs_diff': groups,
                           'loss_abs_diff': loss_diff,
                           'eval_reward': [a['eval_reward'],
                                           b['eval_reward']],
                           'episodes': a['episodes'],
                           'failures': a['failures'],
                           'launches': a['launches']})
    return {'ok': not failures, 'failures': failures,
            'same_initial_parameters': same_init, 'collects': collects,
            'iterations': iterations,
            'last_collect_launches': card['last_collect_launches'],
            'plans': card['plans'], 'sizes': card['sizes'],
            'widths': card['widths'], 'encoder': card['encoder'],
            'devices': [card['device'], ref['device']],
            'seconds': {'device': card['seconds'],
                        'reference': ref['seconds']}}


def run_sides(device: str = 'cuda', ref_device: str = 'cpu',
              concurrent: bool = False, ref_threads: Optional[int] = None,
              **kwargs):
    """Both sides' records, (device, reference), each run_side(**kwargs).
    With `concurrent`, the reference side runs in a spawned process (with
    `ref_threads` intra-op threads) while this one runs the device side;
    else the reference side first, here."""
    if not concurrent:
        ref = run_side(ref_device, threads=ref_threads, **kwargs)
        return run_side(device, **kwargs), ref
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(1) as pool:
        pending = pool.apply_async(run_side, (ref_device,),
                                   dict(kwargs, threads=ref_threads))
        card = run_side(device, **kwargs)
        return card, pending.get()


def run(device: str = 'cuda', ref_device: str = 'cpu', **kwargs) -> dict:
    """Both sides (run_sides), then compare."""
    return compare(*run_sides(device, ref_device, **kwargs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--encoder', choices=('sgnn', 'mlp'), default='sgnn')
    ap.add_argument('--cfg', default='hlg',
                    help='The scenario (hlg, hlg_concept, ...).')
    ap.add_argument('--num_envs', type=int, default=NUM_ENVS)
    ap.add_argument('--iterations', type=int, default=ITERATIONS)
    ap.add_argument('--device', default='cuda',
                    help='The side under test (the reference is the CPU).')
    ap.add_argument('--concurrent', action='store_true',
                    help='Run the CPU side in a spawned process meanwhile.')
    ap.add_argument('--ref_threads', type=int, default=0,
                    help='Intra-op threads of the CPU side (0: the '
                    'default).')
    ap.add_argument('--gcn_node_dim', type=int, default=0,
                    help='The SGNN\'s width (0: the config\'s).')
    ap.add_argument('--max_num_edges', type=int, default=0,
                    help='The edge slots, the trainer\'s E (0: the '
                    'config\'s).')
    ap.add_argument('--out', default='', help='Write the report (JSON).')
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    specs = {k: v for k, v in (('gcn_node_dim', a.gcn_node_dim),
                               ('max_num_edges', a.max_num_edges)) if v}
    report = run(a.device, concurrent=a.concurrent,
                 ref_threads=a.ref_threads or None, encoder=a.encoder,
                 cfg=a.cfg, num_envs=a.num_envs, iterations=a.iterations,
                 encoder_specs=specs or None)
    report['wall_seconds'] = time.perf_counter() - t0
    for i, it in enumerate(report['iterations']):
        print(json.dumps({'iteration': i, **it}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, 'w') as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in (
        'ok', 'failures', 'encoder', 'sizes', 'widths', 'devices', 'plans',
        'last_collect_launches', 'seconds', 'wall_seconds')}), flush=True)
    if not report['ok']:
        raise SystemExit(1)
    return report


if __name__ == '__main__':
    main()
