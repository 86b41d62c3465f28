"""Replay the policy-driven FAILING episodes of the port's bench rollout
through the host oracle (counterpart of tools/replay_failures.py).

The rollout bench (urban_tpu_torch/bench.py) reports episode failures; this
harness decides whether each failure is *fidelity* (the host engine fails
the same action at the same step: the reference's geometry-failure path,
reference city.py:450-457) or an artifact of the slot-table env (capacity
overflow, or a mask admitting an action the host would reject or survive).

Method: rerun the bench rollout (the same model, weights and random
stream), recording the per-step actions; for every failure walk back to
the episode's reset, then drive BOTH a fresh single env of the port and a
fresh host CityEnv with those actions, mapping slot actions to host graph
actions by feature geometry (tools/matching.py).

    python -m urban_tpu_torch.tools.replay_failures [max_episodes]
        [--roomy] [--device cpu|cuda]

prints one classification line per replayed episode and the metrics dict.

As in the JAX harness, the time budget also bounds the success sample:
when the failures alone use it up, no success is replayed, the host's
failure rate given a success is taken as 0 of 1, and the host-vs-env
failure ratio reduces to the confirmed share of the adjudicated failures
(exactly 1.0 when all of them are confirmed), whatever the host would do
on the successes.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

# BENCH_CAPS: the bench's capacities, the default here as in the JAX harness
from urban_tpu_torch.bench import BENCH_CAPS, default_caps  # noqa: F401
from urban_tpu_torch.tools.divergence import make_config
from urban_tpu_torch.tools.matching import (decode_slot_action,
                                            host_land_use_action,
                                            host_road_action)

logger = logging.getLogger('replay_failures')
logger.addHandler(logging.NullHandler())
logger.propagate = False

ROOMY_CAPS = dict(KV=24, NP=320, NS=768, NPT=448, NE=3000)
HOST_FAIL_RESULTS = ('host_failed',)  # host engine fails the same episode
# 'host_raised' = the host engine's own invariant asserts fired: the
# reference converts exactly these into FAILURE_REWARD terminations
# (reference city.py:450-457), so it also counts as host-confirmed
HOST_CONFIRMED_RESULTS = ('host_failed', 'host_raised')


def collect_trajectories(spec, model, init_state, B, T, seed,
                         device='cuda'):
    """The bench's rollout (rollout_bench: every env starting fresh, the
    sampling stream a Generator on `device` seeded with `seed`) with
    per-step recording; returns numpy arrays (actions (T, B, 2),
    was_reset (T, B), done (T, B), failure (T, B)). Runs on `device`: the
    card unless the caller asks for the CPU."""
    from urban_tpu_torch.torchenv.rollout import broadcast_state, rollout_bench
    device = torch.device(device)
    model = model.to(device)
    init_state = init_state.map(lambda x: x.to(device))
    start = broadcast_state(
        init_state.replace(done=torch.ones_like(init_state.done)), B)
    gen = torch.Generator(device=device).manual_seed(seed)
    record = []
    rollout_bench(spec, model, init_state, start, gen, T, record=record)
    return tuple(torch.stack([step[k] for step in record]).cpu().numpy()
                 for k in range(4))


@torch.no_grad()
def replay_one(cfg, spec, init_state, actions, fail_step, device='cuda'):
    """Replay one episode's slot actions through BOTH engines: the port's
    single env steps eagerly on `device` (the card unless the caller asks
    for the CPU). Returns a dict with each engine's outcome."""
    from urban_tpu_torch.host.envs.city import CityEnv
    from urban_tpu_torch.torchenv import step as ts

    device = torch.device(device)
    env = CityEnv(cfg)
    env.reset()
    state = init_state.map(lambda x: x.to(device))

    res = dict(steps=len(actions), fail_step=fail_step, jit_fail_at=None,
               host_result='in_lockstep', host_fail_at=None, mapped=0)
    for k, act in enumerate(actions):
        stage, payload = decode_slot_action(spec, state, act)
        # host action mapping from the live host state
        if stage == 'land_use':
            ha = host_land_use_action(env._plc, env._current_land_use_mask,
                                      *payload)
            host_action = np.array([ha if ha is not None else 0, 0], float)
        else:
            if env._stage == 'land_use':
                res['host_result'] = 'stage_diverged'
                break
            ha = host_road_action(env._plc, env._current_road_mask, payload)
            host_action = np.array([0, ha if ha is not None else 0], float)
        state, _, _, info = ts.env_step(spec, state, torch.tensor(
            np.asarray(act), dtype=torch.int32, device=device))
        slot_failed = bool(info['failure'])
        if slot_failed and res['jit_fail_at'] is None:
            res['jit_fail_at'] = k

        if ha is None:
            # the slot action has no geometric counterpart in the host
            # mask: either the plans drifted apart or the host rejects it
            res['host_result'] = ('host_mask_rejects_final' if slot_failed
                                  else 'unmappable')
            break
        res['mapped'] += 1
        try:
            _, r_host, done_host, _ = env.step(host_action, logger)
        except Exception as err:  # InfeasibleActionError or engine assert
            res['host_result'] = f'host_raised:{type(err).__name__}'
            res['host_fail_at'] = k
            break
        host_failed = bool(done_host) and \
            float(r_host) == float(env.FAILURE_REWARD)
        if host_failed:
            res['host_result'] = 'host_failed'
            res['host_fail_at'] = k
            break
        if slot_failed:
            res['host_result'] = 'host_survived'
            break
    return res


def _episode_start(resets, b, t):
    for tt in range(t, -1, -1):
        if resets[tt, b]:
            return tt
    return 0


def adjudicate(scenario, spec, init_state, acts, resets, dones, fails,
               sample_seed, budget_s=None, max_failures=None, n_success=20,
               verbose=True, device='cuda'):
    """Replay the failures of a recorded corpus (the four arrays of
    collect_trajectories) and a sample of its successes (drawn with
    numpy's default_rng(sample_seed)) through the host oracle; returns
    (metrics, failure outcomes, success outcomes). budget_s bounds the
    host wall clock of both passes; coverage is reported in the output."""
    fail_events = list(zip(*np.nonzero(fails.T)))         # (b, t)
    succ_events = list(zip(*np.nonzero((dones & ~fails).T)))
    if verbose:
        print(f'corpus: {int(dones.sum())} episodes, '
              f'{len(fail_events)} failures', flush=True)

    t_start = time.time()

    def out_of_budget():
        return budget_s is not None and time.time() - t_start > budget_s

    def replay_events(events, limit):
        outcomes = []
        for b, t in events[:limit] if limit else events:
            if out_of_budget():
                break
            t0 = _episode_start(resets, b, t)
            res = replay_one(make_config(scenario), spec, init_state,
                             acts[t0:t + 1, b], fail_step=t - t0,
                             device=device)
            res.update(env=int(b), t=int(t), t0=int(t0))
            res = {k: (int(v) if isinstance(v, np.integer) else v)
                   for k, v in res.items()}
            outcomes.append(res)
            if verbose:
                print(json.dumps(res), flush=True)
        return outcomes

    fail_out = replay_events(fail_events, max_failures)
    # spread the success sample across envs (first-done episodes are
    # correlated in t, not in env index)
    rng = np.random.default_rng(sample_seed)
    succ_sample = [succ_events[i] for i in
                   rng.permutation(len(succ_events))[:n_success]]
    succ_out = replay_events(succ_sample, None)

    def tally(outcomes):
        s = {}
        for r in outcomes:
            s[r['host_result']] = s.get(r['host_result'], 0) + 1
        return s

    n_fail_total = len(fail_events)
    n_fail_rep = len(fail_out)
    confirmed = sum(1 for r in fail_out
                    if r['host_result'] in HOST_CONFIRMED_RESULTS)
    # mapped = the replay stayed geometrically identified end to end; an
    # unmappable episode is indeterminate, not a host-survival
    adjudicated = sum(1 for r in fail_out if r['host_result'] in
                      HOST_CONFIRMED_RESULTS + ('host_survived',))
    succ_host_fail = sum(1 for r in succ_out
                         if r['host_result'] in HOST_CONFIRMED_RESULTS)
    succ_adjudicated = sum(1 for r in succ_out if r['host_result'] in
                           HOST_CONFIRMED_RESULTS + ('in_lockstep',))
    episodes = int(dones.sum())
    jit_fail_rate = n_fail_total / max(episodes, 1)
    # host failure rate under the SAME action sequences, estimated from
    # both conditional branches of the corpus
    p_fail_given_fail = confirmed / max(adjudicated, 1)
    p_fail_given_succ = succ_host_fail / max(succ_adjudicated, 1)
    host_rate = (jit_fail_rate * p_fail_given_fail
                 + (1 - jit_fail_rate) * p_fail_given_succ)
    metrics = {
        'scenario': scenario,
        'episodes': episodes,
        'jit_failures': n_fail_total,
        'jit_failure_rate': round(jit_fail_rate, 4),
        'failures_replayed': n_fail_rep,
        'failure_replay_coverage': round(n_fail_rep / max(n_fail_total, 1),
                                         3),
        'failures_host_confirmed': confirmed,
        'failures_adjudicated': adjudicated,
        'failure_host_confirmed_pct': round(
            100.0 * confirmed / max(adjudicated, 1), 1),
        'failure_outcomes': tally(fail_out),
        'successes_replayed': len(succ_out),
        'success_host_fail': succ_host_fail,
        'success_outcomes': tally(succ_out),
        'host_failure_rate_est': round(host_rate, 4),
        'host_vs_jit_failure_ratio': round(
            host_rate / max(jit_fail_rate, 1e-9), 3),
        'replay_wall_s': round(time.time() - t_start, 1),
    }
    return metrics, fail_out, succ_out


def run_corpus(scenario='hlg', caps=None, B=256, T=30, seed=0,
               budget_s=None, max_failures=None, n_success=20, verbose=True,
               device='cuda'):
    """Replay the bench's failure corpus (and a sample of SUCCESS episodes)
    through the host oracle on `device` (the card unless the caller asks
    for the CPU); returns (metrics, failure outcomes, success outcomes).

    The defaults reproduce urban_tpu_torch.bench's timed rollout exactly
    (the scenario's bench caps, the model from `seed`, the sampling stream
    from seed + 1, every env starting fresh), so the corpus replayed IS the
    corpus the bench reports; the success sample is drawn with seed + 1."""
    from urban_tpu_torch.bench import make_model, set_precision_flags, setup
    set_precision_flags()
    caps = default_caps(scenario) if caps is None else caps
    cfg, spec, init_state = setup(scenario, caps, device=device)
    model = make_model(cfg, spec, seed, device)
    acts, resets, dones, fails = collect_trajectories(
        spec, model, init_state, B, T, seed + 1, device=device)
    return adjudicate(scenario, spec, init_state, acts, resets, dones, fails,
                      seed + 1, budget_s=budget_s, max_failures=max_failures,
                      n_success=n_success, verbose=verbose, device=device)


def run(max_episodes=40, caps=None, B=256, T=30, scenario='hlg',
        device='cuda'):
    metrics, fail_out, _ = run_corpus(scenario, caps=caps, B=B, T=T,
                                      max_failures=max_episodes,
                                      n_success=0, device=device)
    return metrics['failure_outcomes'], fail_out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('max_episodes', nargs='?', type=int, default=None,
                    help='failures to replay (default: all)')
    ap.add_argument('--roomy', action='store_true',
                    help='ROOMY_CAPS instead of the bench caps')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    from urban_tpu_torch.bench import build_kernels
    build_kernels(a.device)
    metrics, _, _ = run_corpus(caps=ROOMY_CAPS if a.roomy else None,
                               max_failures=a.max_episodes, device=a.device)
    print(json.dumps(metrics, indent=2))


if __name__ == '__main__':
    main()
