"""The port's host-oracle divergence harness (urban_tpu_torch/tools/
divergence.py) against the JAX package's tools/divergence.py, imported
live: the same seeded lockstep episodes give the same metrics dicts; and
the port's failure-replay corpus (tools/replay_failures.py
collect_trajectories) is the port bench's rollout."""
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the JAX package's tools/ live at the root

from tools import divergence as jdiv  # noqa: E402
from urban_tpu.utils.config import Config  # noqa: E402
from urban_tpu_torch import bench  # noqa: E402
from urban_tpu_torch.tools import divergence as tdiv  # noqa: E402
from urban_tpu_torch.tools.replay_failures import (  # noqa: E402
    collect_trajectories)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4           # ROADMAP's lockstep tolerance
FLOAT_KEYS = ('reward_jax', 'reward_delta')   # the slot env's f32 reward


def assert_same_metrics(port, ref):
    """Equal dicts: the slot env's reward (and so the delta) within RTOL /
    ATOL, everything else (ints, bools, diverged_at, the host reward)
    exactly."""
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        if k in FLOAT_KEYS and v is not None:
            assert port[k] is not None, k
            np.testing.assert_allclose(port[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            assert port[k] == v, (k, port[k], v)


def replay_both(scenario, seed):
    cfg = Config(scenario, 0, tmp=True)
    ref = jdiv.replay_episode(cfg, seed,
                              max_steps=cfg.max_sequence_length + 20)
    tcfg = tdiv.make_config(scenario)
    port = tdiv.replay_episode(tcfg, seed,
                               max_steps=tcfg.max_sequence_length + 20,
                               device='cpu')
    return port, ref


@pytest.mark.parametrize('seed', [100, 101])
def test_replay_episode_matches_jax_hlg(seed):
    port, ref = replay_both('hlg', seed)
    assert ref['completed_both']   # full episodes, to the stage reward
    assert_same_metrics(port, ref)


@pytest.mark.slow
def test_replay_episode_matches_jax_grid_road_stage():
    port, ref = replay_both('grid', 100)
    assert ref['road_steps'] > 0 and ref['completed_both']
    assert_same_metrics(port, ref)


def _result(seed, steps, road, matched, both, delta, diverged=None):
    return dict(seed=seed, steps=steps, matched_steps=matched,
                mask_agree=steps - 1, representable=steps, road_steps=road,
                completed_both=both, completed_host=both,
                reward_host=1.0 if both else None,
                reward_jax=1.0 + delta if both else None,
                reward_delta=delta if both else None, diverged_at=diverged)


@pytest.mark.parametrize('results', [
    [_result(100, 29, 0, 29, True, 0.07), _result(101, 21, 0, 20, False,
                                                  None, 20),
     _result(102, 97, 51, 97, True, 1e-8)],
    [_result(103, 13, 0, 12, False, None, 12)],   # no lockstep completion
])
def test_summarize_matches_jax(results):
    assert tdiv.summarize(results, 'x') == jdiv.summarize(results, 'x')


def test_all_scenarios_add_dhm_concept():
    assert tdiv.ALL_SCENARIOS == jdiv.ALL_SCENARIOS + ('dhm_concept',)


def test_collect_trajectories_is_the_bench_rollout():
    """The corpus the replay collects is the port bench's rollout at the
    same seeds (model seed, sampling stream seed + 1, every env fresh):
    the same episode and failure totals; was_reset[t] is done[t - 1], all
    True at t = 0."""
    B, T, seed = 3, 30, 0
    stats = bench.run_rollout_bench(B, T, device='cpu', seed=seed)
    cfg, spec, init = bench.setup('hlg', device='cpu')
    model = bench.make_model(cfg, spec, seed, 'cpu')
    acts, resets, dones, fails = collect_trajectories(spec, model, init, B,
                                                      T, seed + 1, 'cpu')
    assert acts.shape == (T, B, 2) and resets.shape == dones.shape == (T, B)
    assert (int(dones.sum()), int(fails.sum())) == (stats['episodes'],
                                                    stats['failures'])
    assert stats['episodes'] > 0
    assert resets[0].all()
    np.testing.assert_array_equal(resets[1:], dones[:-1])


def _sweep(scenario):
    with open(os.path.join(REPO, 'DIVERGENCE_torch.json')) as f:
        for entry in json.load(f):
            if entry['summary']['scenario'] == scenario:
                return entry['results']
    pytest.fail(f'DIVERGENCE_torch.json has no {scenario} sweep')


@pytest.mark.slow
@pytest.mark.parametrize('scenario', tdiv.ALL_SCENARIOS)
def test_committed_sweep_matches_jax_live(scenario):
    """Every seed of the committed sweep (DIVERGENCE_torch.json) against
    JAX's tools/divergence.replay_episode run live on the same seed
    (10-30 s a seed on one CPU core; grid takes longest)."""
    differ = []
    for port in _sweep(scenario):
        cfg = Config(scenario, 0, tmp=True)
        ref = jdiv.replay_episode(cfg, port['seed'],
                                  max_steps=cfg.max_sequence_length + 20)
        try:
            assert_same_metrics(port, ref)
        except AssertionError as err:
            differ.append((port['seed'], str(err)[:300]))
    assert not differ, differ


def test_tools_default_to_the_card(tmp_path):
    """Without a device argument the tools put the slot env (and the
    policy) on the card; without a card they raise rather than quietly
    run on the CPU. The CLIs default to the card too."""
    from urban_tpu_torch.tools import replay_failures as trf
    cfg, spec, init = bench.setup('hlg', device='cpu')
    model = bench.make_model(cfg, spec, 0, 'cpu')
    acts = np.zeros((1, 2), np.int32)
    calls = {
        'replay_episode': lambda: tdiv.replay_episode(
            tdiv.make_config('hlg'), 100, max_steps=1),
        'collect_trajectories': lambda: collect_trajectories(
            spec, model, init, 1, 1, 1),
        'replay_one': lambda: trf.replay_one(tdiv.make_config('hlg'), spec,
                                             init, acts, 0),
        'run_corpus': lambda: trf.run_corpus(B=1, T=1, max_failures=0,
                                             n_success=0, verbose=False),
        'divergence CLI': lambda: tdiv.main(['1', 'hlg', '--out_dir',
                                             str(tmp_path)]),
        'replay_failures CLI': lambda: trf.main(['1']),
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_env_step_rewards_are_the_batched_steps():
    """env_step with compute_rewards (the tools' eager step of one env:
    each stage reward on the step that ends the stage) against the
    batched step with rewards, make_batch_fns(defer_rewards=False), held
    against JAX's in test_torch_rollout.py, on a batch of one: the same
    states, rewards and infos, bit for bit, on a grid state one placement
    from the end of its land use (the land-use reward), one road step
    from the end of its road stage (the road reward) and the initial
    state (no reward)."""
    from test_torch_rollout import _land_use_nearly_done
    from urban_tpu_torch.torchenv import road_fixtures as rf
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv.rollout import make_batch_fns
    from urban_tpu_torch.torchenv.step import (env_step, land_use_mask,
                                               pending_land_use_type,
                                               road_mask)
    _, spec, init = bench.setup('grid', {}, 'cpu')
    _, batch_step = make_batch_fns(spec, defer_rewards=False)
    fields = tstate.plan_state_to_numpy(init)
    counted = [t for t in spec.plan_order
               if spec.required_plan_count[t] > 0]
    rd = rf.road_stage_state(fields, spec.road_ratio, seed=2, frac=0.15)
    rd['road_steps'] = rd['total_road_steps'] - 1
    cases = {'land use ends': _land_use_nearly_done(fields, spec,
                                                    counted[-1]),
             'road stage ends': rd, 'initial': fields}
    for name, d in cases.items():
        s = tstate.plan_state_from_numpy(d, 'cpu')
        if int(s.stage) == 0:
            mask = land_use_mask(spec, s, pending_land_use_type(spec, s))
            a = torch.tensor([int(torch.nonzero(mask)[0]), 0])
        else:
            a = torch.tensor([0, int(torch.nonzero(road_mask(spec, s))[0])])
        a = a.to(torch.int32)
        got = env_step(spec, s, a)
        want = batch_step(s.map(lambda x: x[None]), a[None])
        for n in tstate.FIELD_NAMES:
            assert torch.equal(getattr(got[0], n), getattr(want[0], n)[0]), \
                (name, n)
        assert torch.equal(got[1], want[1][0])
        assert torch.equal(got[2], want[2][0])
        assert got[3].keys() == want[3].keys()
        for k in want[3]:
            assert torch.equal(got[3][k], want[3][k][0]), (name, k)
        if name != 'initial':
            assert bool(got[3]['lu_done'] | got[3]['rd_done'])
            assert float(got[1]) > 0, name


# the one replayed failure of the card's corpus that the host engine
# survives: chip_smoke.py replay_failures_hlg on an NVIDIA H100 (the 64 x
# 30 corpus at the bench caps), env 13, steps 0-8, its slot actions; the
# card's slot env failed step 8 with the slice bit
CARD_SURVIVOR = [[1007, 0], [949, 0], [915, 0], [1098, 0], [837, 0],
                 [1325, 0], [1092, 0], [965, 0], [1136, 0]]


def test_card_survivor_replays_alike_in_jax():
    """The card's host_survived episode replays to the same outcome dict
    through JAX's replay_one and the port's on the CPU (the slot env fails
    step 8, the host engine takes every action), and the port's slot env
    fails there with the slice bit alone, as on the card: the slot-table
    slicer, JAX's as the port's, fails an action the exact engine takes."""
    from tools import replay_failures as jrf
    from urban_tpu.envs.plan_client import PlanClient
    from urban_tpu.jaxenv.state import build_env_spec, build_initial_state
    from urban_tpu_torch.tools import replay_failures as trf
    from urban_tpu_torch.torchenv import step as ts
    acts = np.array(CARD_SURVIVOR, np.int32)
    fail_step = len(acts) - 1
    cfg = Config('hlg', 0, tmp=True)
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length,
                          caps=jrf.BENCH_CAPS)
    ref = jrf.replay_one(Config('hlg', 0, tmp=True), spec,
                         build_initial_state(spec, plc), acts, fail_step)
    _, tspec, tinit = bench.setup('hlg', trf.BENCH_CAPS, 'cpu')
    got = trf.replay_one(tdiv.make_config('hlg'), tspec, tinit, acts,
                         fail_step, device='cpu')
    assert got == ref
    assert got['host_result'] == 'host_survived'
    assert got['jit_fail_at'] == fail_step and got['mapped'] == len(acts)
    state, codes = tinit, []
    for a in acts:
        state, _, _, info = ts.env_step(tspec, state, torch.as_tensor(a))
        codes.append(int(info['failure_code']))
    assert codes == [0] * fail_step + [ts.FAIL_SLICE]
