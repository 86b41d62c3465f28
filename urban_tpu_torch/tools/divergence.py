"""Host oracle vs the port's batched environment: a lockstep replay
(counterpart of tools/divergence.py).

Replays N seeded episodes in lockstep: each step the host engine
(urban_tpu_torch.host, exact numpy) picks a random valid action, the
slot-table env (torchenv, one env, stepped eagerly with env_step on the
card unless the caller asks for the CPU; each stage reward computed on
the step that ends the stage) takes
the action whose features match it geometrically (tools/matching.py), and
both engines step.
Reports

  * mask-count agreement rate (host vs slot-table action-candidate counts)
  * action representability (the host's action exists in the slot mask)
  * matched steps before the running stats diverge
  * terminal-reward deltas of episodes both engines complete in lockstep

    python -m urban_tpu_torch.tools.divergence [n_seeds] [scenario|all]
        [--device cpu|cuda] [--start_seed 100] [--out_dir DIR]

writes DIVERGENCE_torch.md and DIVERGENCE_torch.json at the repo root
(or --out_dir), with the JAX package's published figures
(DIVERGENCE.json) beside the port's.
With `all`, one process per scenario, all at once.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from urban_tpu_torch.tools.matching import (host_action_identity,
                                            host_road_midpoint,
                                            matching_edge, matching_road)

logger = logging.getLogger('divergence')
logger.addHandler(logging.NullHandler())
logger.propagate = False

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ALL_SCENARIOS = ('hlg', 'dhm', 'grid', 'huizhou', 'hlg_concept',
                 'dhm_concept')
STAGE_ID = {'land_use': 0, 'road': 1, 'done': 2}


def make_config(scenario: str):
    """The host Config of `scenario`, its run directories under the temp
    directory (the replay writes nothing there)."""
    from urban_tpu_torch.host.utils.config import Config
    return Config(scenario, 0, root_dir=os.path.join(tempfile.gettempdir(),
                                                     'urban_tpu_torch'))


@torch.no_grad()
def replay_episode(cfg, seed: int, max_steps: int = 60, device='cuda'):
    """One lockstep episode (land-use AND road stages) on `device` (the
    card unless the caller asks for the CPU); returns a metrics dict."""
    from urban_tpu_torch.host import city_config
    from urban_tpu_torch.host.envs.city import CityEnv
    from urban_tpu_torch.host.envs.plan_client import PlanClient
    from urban_tpu_torch.torchenv import step as ts
    from urban_tpu_torch.torchenv.state import (build_env_spec,
                                                build_initial_state)

    device = torch.device(device)
    env = CityEnv(cfg)
    obs = env.reset()
    plc = env._plc
    plc2 = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = build_env_spec(cfg, plc2, max_steps=cfg.max_sequence_length)
    state = build_initial_state(spec, plc2, device=device)

    def step_fn(s, a):
        return ts.env_step(spec, s, torch.tensor(a, dtype=torch.int32,
                                                     device=device))

    rng = np.random.default_rng(seed)
    m = dict(seed=seed, steps=0, matched_steps=0, mask_agree=0,
             representable=0, road_steps=0, completed_both=False,
             completed_host=False, reward_host=None, reward_jax=None,
             reward_delta=None, diverged_at=None)
    for step in range(max_steps):
        # both engines must agree on the CURRENT stage before acting
        if STAGE_ID[env._stage] != int(state.stage):
            m['diverged_at'] = step
            break
        if env._stage == 'road':
            valid = np.nonzero(obs[7])[0]
            if len(valid) == 0:
                break
            slot_mask = ts.road_mask(spec, state).cpu().numpy()
            m['steps'] += 1
            m['road_steps'] += 1
            if int(slot_mask.sum()) == len(valid):
                m['mask_agree'] += 1
            action = int(rng.choice(valid))
            mid = host_road_midpoint(plc, action)
            slot_action = matching_road(spec, state, slot_mask, mid)
            if slot_action is None:
                m['diverged_at'] = step
                break
            m['representable'] += 1
            obs, r_host, done_host, _ = env.step(
                np.array([0, action], dtype=float), logger)
            state, r_slot, done_slot, info = step_fn(state, [0, slot_action])
        else:
            valid = np.nonzero(obs[6])[0]
            if len(valid) == 0:
                break
            t = ts.pending_land_use_type(spec, state)
            slot_mask = ts.land_use_mask(spec, state, t).cpu().numpy()
            m['steps'] += 1
            if int(slot_mask.sum()) == len(valid):
                m['mask_agree'] += 1

            action = int(rng.choice(valid))
            centroid, inter_xy = host_action_identity(plc, action)
            slot_action, _ = matching_edge(spec, state, centroid, inter_xy, t)
            if slot_action is None:
                m['diverged_at'] = step
                break
            m['representable'] += 1

            obs, r_host, done_host, _ = env.step(
                np.array([action, 0], dtype=float), logger)
            state, r_slot, done_slot, info = step_fn(state, [slot_action, 0])
        # the host env reports geometry failures only through the terminal
        # FAILURE_REWARD (city.py failure_step); both engines failing on
        # the same action is lockstep parity, not divergence
        fail_host = bool(done_host) and \
            float(r_host) == float(env.FAILURE_REWARD)
        if bool(info['failure']) != fail_host:
            m['diverged_at'] = step
            break
        if fail_host:
            m['matched_steps'] += 1
            m['completed_host'] = True
            m['completed_both'] = True
            m['reward_host'] = float(r_host)
            m['reward_jax'] = float(r_slot)
            m['reward_delta'] = abs(float(r_host) - float(r_slot))
            break
        # land-use lockstep: identical plan-count stats every step; road
        # lockstep: identical count of upgraded road segments (road steps
        # mutate segment types, not plan counts)
        if m['road_steps'] > 0:
            n_road_h = int(np.count_nonzero(
                plc._table.existence
                & (plc._table.types == city_config.ROAD)))
            n_road_s = int((state.seg_alive
                            & (state.seg_type == city_config.ROAD)).sum())
            if n_road_h != n_road_s:
                m['diverged_at'] = step
                break
        counts_h = plc.get_plan_ratio_and_count()[1]
        if not np.array_equal(counts_h, state.plan_count.cpu().numpy()):
            m['diverged_at'] = step
            break
        m['matched_steps'] += 1
        if done_host or bool(done_slot):
            m['completed_host'] = bool(done_host)
            if done_host and bool(done_slot):
                m['completed_both'] = True
                m['reward_host'] = float(r_host)
                m['reward_jax'] = float(r_slot)
                m['reward_delta'] = abs(float(r_host) - float(r_slot))
            break
    return m


def run(n_seeds: int = 50, scenario: str = 'hlg', start_seed: int = 100,
        device='cuda'):
    """(summary, per-seed results) of seeds start_seed .. + n_seeds."""
    from urban_tpu_torch.bench import set_precision_flags
    set_precision_flags()
    results = []
    for k in range(n_seeds):
        cfg = make_config(scenario)
        t = time.time()
        results.append(replay_episode(cfg, start_seed + k,
                                      max_steps=cfg.max_sequence_length + 20,
                                      device=device))
        r = results[-1]
        print(f'{scenario} seed {r["seed"]}: steps {r["steps"]} '
              f'(road {r["road_steps"]}) matched {r["matched_steps"]} '
              f'both_done {r["completed_both"]} dR {r["reward_delta"]} '
              f'({time.time() - t:.3f} s)', flush=True)
    return summarize(results, scenario)


def summarize(results, scenario):
    steps = sum(r['steps'] for r in results)
    agree = sum(r['mask_agree'] for r in results)
    rep = sum(r['representable'] for r in results)
    matched = [r['matched_steps'] for r in results]
    both = [r for r in results if r['completed_both']]
    deltas = [r['reward_delta'] for r in both]
    out = {
        'scenario': scenario,
        'episodes': len(results),
        'total_steps': steps,
        'road_steps': sum(r['road_steps'] for r in results),
        'mask_count_agreement_rate': agree / max(steps, 1),
        'action_representable_rate': rep / max(steps, 1),
        'matched_steps_mean': float(np.mean(matched)),
        'matched_steps_min': int(np.min(matched)),
        'full_lockstep_completion_rate': len(both) / max(len(results), 1),
        'terminal_reward_delta_mean': float(np.mean(deltas)) if deltas
        else None,
        'terminal_reward_delta_max': float(np.max(deltas)) if deltas
        else None,
        'divergent_seeds': [r['seed'] for r in results
                            if not r['completed_both']],
    }
    return out, results


def jax_summaries(root: str = REPO_ROOT):
    """{scenario: summary} of the JAX package's published sweep
    (DIVERGENCE.json), empty where the file is absent."""
    path = os.path.join(root, 'DIVERGENCE.json')
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {s['scenario']: s for s in json.load(f)}


def _scenario_section(summary, results):
    lines = [
        '',
        f'## {summary["scenario"]}',
        '',
        f'- episodes: **{summary["episodes"]}**, '
        f'steps: **{summary["total_steps"]}** '
        f'(road-stage steps: {summary["road_steps"]})',
        f'- mask-count agreement rate: '
        f'**{summary["mask_count_agreement_rate"]:.3f}**',
        f'- host-action representable in the slot mask: '
        f'**{summary["action_representable_rate"]:.3f}**',
        f'- matched steps/episode: mean '
        f'**{summary["matched_steps_mean"]:.1f}**, '
        f'min **{summary["matched_steps_min"]}**',
        f'- episodes completing in full lockstep: '
        f'**{summary["full_lockstep_completion_rate"]:.2f}**',
        f'- terminal reward |delta| (lockstep completions): mean '
        f'**{summary["terminal_reward_delta_mean"]}**, max '
        f'**{summary["terminal_reward_delta_max"]}**',
        f'- divergent seeds: {summary["divergent_seeds"] or "none"}',
        '',
        '| seed | steps | road | matched | both done | reward Δ |',
        '|---|---|---|---|---|---|',
    ]
    for r in results:
        d = f'{r["reward_delta"]:.4f}' if r['reward_delta'] is not None \
            else '—'
        lines.append(f'| {r["seed"]} | {r["steps"]} | {r["road_steps"]} '
                     f'| {r["matched_steps"]} | {r["completed_both"]} '
                     f'| {d} |')
    return lines


def write_report(sections, path, device: str = 'cpu'):
    """sections: list of (summary, results) pairs, one per scenario."""
    jax_sum = jax_summaries()
    lines = [
        '# DIVERGENCE_torch — host oracle vs the port\'s batched env '
        '(lockstep replay)',
        '',
        'Generated by `python -m urban_tpu_torch.tools.divergence [n_seeds] '
        f'[scenario|all] --device {device}`. Each seeded episode is',
        'replayed action-for-action in the host oracle',
        '(`urban_tpu_torch/host`) and in one env of the port\'s slot-table',
        'environment (`torchenv.step.env_step`, eager, each stage reward',
        'on the step that ends the stage), matching actions by',
        'block-centroid/intersection geometry for land use and segment',
        'midpoint for roads. The JAX columns are the JAX package\'s published',
        'figures (`DIVERGENCE.json`, round 5, seeds 100-149); the',
        'seed-for-seed check against `tools/divergence.py` run live on the',
        'same seeds is',
        '`tests/test_torch_fidelity.py::test_committed_sweep_matches_jax_live`.',
        '',
        '| scenario | episodes | lockstep | mask agree | representable '
        '| max reward Δ | JAX lockstep | JAX mask agree | JAX max reward Δ |',
        '|---|---|---|---|---|---|---|---|---|',
    ]
    for summary, _ in sections:
        dmax = summary['terminal_reward_delta_max']
        j = jax_sum.get(summary['scenario'])
        jdmax = j and j['terminal_reward_delta_max']
        lines.append(
            f'| {summary["scenario"]} | {summary["episodes"]} '
            f'| {summary["full_lockstep_completion_rate"]:.2f} '
            f'| {summary["mask_count_agreement_rate"]:.3f} '
            f'| {summary["action_representable_rate"]:.3f} '
            f'| {dmax if dmax is None else round(dmax, 4)} '
            + (f'| {j["full_lockstep_completion_rate"]:.2f} '
               f'| {j["mask_count_agreement_rate"]:.3f} '
               f'| {jdmax if jdmax is None else round(jdmax, 4)} |' if j
               else '| — (not in the JAX sweep) | — | — |'))
    for summary, results in sections:
        lines.extend(_scenario_section(summary, results))
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')


def _run_one(args):
    n, scenario, start_seed, device = args
    torch.set_num_threads(1)
    return run(n, scenario, start_seed, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_seeds', nargs='?', type=int, default=50)
    ap.add_argument('scenario', nargs='?', default='hlg',
                    help=f'one of {ALL_SCENARIOS} or all')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--start_seed', type=int, default=100)
    ap.add_argument('--out_dir', default=REPO_ROOT,
                    help='where DIVERGENCE_torch.{md,json} go')
    a = ap.parse_args(argv)
    scenarios = ALL_SCENARIOS if a.scenario == 'all' else (a.scenario,)
    work = [(a.n_seeds, sc, a.start_seed, a.device) for sc in scenarios]
    if len(work) == 1:
        sections = [run(*work[0])]
    else:
        with ProcessPoolExecutor(len(work),
                                 mp_context=get_context('spawn')) as ex:
            sections = list(ex.map(_run_one, work))
    jax_sum = jax_summaries()
    for summary, _ in sections:
        print(json.dumps(summary, indent=2))
    write_report(sections, os.path.join(a.out_dir, 'DIVERGENCE_torch.md'),
                 a.device)
    with open(os.path.join(a.out_dir, 'DIVERGENCE_torch.json'), 'w') as f:
        json.dump([{'summary': s, 'jax_summary': jax_sum.get(s['scenario']),
                    'device': a.device, 'results': r}
                   for s, r in sections], f, indent=1)


if __name__ == '__main__':
    main()
