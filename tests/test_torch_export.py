"""The port's best-plan export (urban_tpu_torch/tools/export_best_plan.py)
against the JAX package's tools/export_best_plan.py, and the trainer's
phase-1 resume that a chunked training run goes through.

The export test steps one HLG env six land-use actions through JAX's
batched step and the port's in lockstep (tests/torch_parity.py), writes
the plan state as a JAX trainer checkpoint (a pickle of
``jax.device_get(state)``) and as a port checkpoint (torch.save of
``plan_state_to_numpy``), and runs each package's tool on its own: the two
GeoJSON files are equal as parsed JSON, types and coordinates exact, and
the host scores they print (the reward and every channel) are the same
text. On Huizhou, the scenario of JAX's round-5 record, the port's env
takes the six actions alone (its lockstep with JAX's env is
tests/test_torch_scenarios.py's, and JAX's compile of the Huizhou step
would cost tier-1 ~45 s) and JAX's tool reads the same arrays as a JAX
plan state."""
import importlib.util
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import build_pair, lockstep
from urban_tpu.jaxenv import state as jstate
from urban_tpu.jaxenv.rollout import broadcast_state as j_broadcast
from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.io.geojson import load_geojson
from urban_tpu_torch.host.utils.config import Config as TConfig
from urban_tpu_torch.rl import trainer as ttrain
from urban_tpu_torch.tools import export_best_plan
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                              broadcast_state, make_batch_fns)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    """The JAX package's tools/export_best_plan.py, imported by path."""
    spec = importlib.util.spec_from_file_location(
        'jax_export_best_plan',
        os.path.join(REPO, 'tools', 'export_best_plan.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['export_best_plan.py'] + argv)
    return jax_tool().main()


def port_steps(spec, state, rng, steps):
    """The port's batched env of one env alone: `steps` land-use actions,
    each drawn with rng from the land-use mask as lockstep draws them."""
    obs_fn, step_fn = make_batch_fns(spec)
    for _ in range(steps):
        action = np.zeros((1, 2), np.int32)
        action[0, 0] = rng.choice(np.nonzero(obs_fn(state)[6][0].numpy())[0])
        state, reward, _, info = step_fn(state, torch.as_tensor(action))
        state, _ = apply_stage_rewards(spec, state, reward, info)
    return state


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """cfg -> (JAX checkpoint path, port checkpoint path) of one env's plan
    of the scenario after six land-use actions (HLG: in lockstep with
    JAX's env; Huizhou: the port's env alone), made once a module."""
    made = {}

    def get(cfg):
        if cfg not in made:
            spec_j, s0_j, spec_t, s0_t = build_pair(cfg)
            rng = np.random.default_rng(3)
            if cfg == 'hlg':
                _, sj, st = lockstep(spec_j, j_broadcast(s0_j, 1), spec_t,
                                     broadcast_state(s0_t, 1), [rng], 6,
                                     where=cfg, with_states=True)
                j_plan = jax.device_get(jax.tree.map(lambda x: x[0], sj))
                t_plan = tstate.plan_state_to_numpy(st.map(lambda x: x[0]))
            else:
                st = port_steps(spec_t, broadcast_state(s0_t, 1), rng, 6)
                t_plan = tstate.plan_state_to_numpy(st.map(lambda x: x[0]))
                j_plan = jstate.PlanState(**t_plan)
            common = {'best_reward': 3.25, 'best_iteration': 7,
                      'iteration': 9}
            d = tmp_path_factory.mktemp(f'export_{cfg}')
            j_path, t_path = str(d / 'tpu_best.p'), str(d / 'best.pt')
            with open(j_path, 'wb') as f:
                pickle.dump(dict(common, best_plan_state=j_plan), f)
            torch.save(dict(common, best_plan_state=t_plan), t_path)
            made[cfg] = j_path, t_path
        return made[cfg]
    return get


@pytest.mark.parametrize('cfg', ['hlg', 'huizhou'])
def test_export_matches_jax_tool(cfg, checkpoints, tmp_path, monkeypatch,
                                 capsys):
    j_ckpt, t_ckpt = checkpoints(cfg)
    j_out, t_out = str(tmp_path / 'jax.geojson'), str(tmp_path /
                                                      'torch.geojson')
    assert run_jax_tool(['--cfg', cfg, '--ckpt', j_ckpt, '--out', j_out],
                        monkeypatch) == 0
    j_printed = capsys.readouterr().out.splitlines()
    assert export_best_plan.main(['--cfg', cfg, '--ckpt', t_ckpt,
                                  '--out', t_out]) == 0
    t_printed = capsys.readouterr().out.splitlines()

    with open(j_out) as f, open(t_out) as g:
        assert json.load(g) == json.load(f)
    # the leftover feasible space was filled: none is left, small green is
    table = load_geojson(t_out)
    types = table.types[table.existence]
    assert not (types == city_config.FEASIBLE).any()
    assert (types == city_config.GREEN_S).any()

    want = 'exported best plan (jit eval reward 3.2500, iteration 7) -> '
    assert j_printed[0] == want + j_out and t_printed[0] == want + t_out
    # the host score: 'reward: ...' and the channels' pprint, as text
    assert t_printed[1:] == j_printed[1:]
    reward = float(t_printed[1].split(': ')[1])
    assert np.isfinite(reward) and reward > 0


def test_no_plan_returns_1_on_both(tmp_path, monkeypatch, capsys):
    j_ckpt, t_ckpt = str(tmp_path / 'tpu_best.p'), str(tmp_path / 'best.pt')
    empty = {'best_plan_state': None, 'best_reward': -1000.0,
             'best_iteration': -1}
    with open(j_ckpt, 'wb') as f:
        pickle.dump(empty, f)
    torch.save(empty, t_ckpt)
    out = str(tmp_path / 'plan.geojson')
    assert run_jax_tool(['--cfg', 'hlg', '--ckpt', j_ckpt, '--out', out],
                        monkeypatch) == 1
    assert export_best_plan.main(['--cfg', 'hlg', '--ckpt', t_ckpt,
                                  '--out', out]) == 1
    printed = capsys.readouterr().out.splitlines()
    assert printed == ['checkpoint has no best_plan_state'] * 2
    assert not os.path.exists(out)


def _state_at_entry(monkeypatch):
    """Patch Trainer.train_iteration to record, on entry, the iteration,
    the parameters, Adam's state, the env batch and the generator state;
    returns the list it appends to."""
    seen = []
    train_iteration = ttrain.Trainer.train_iteration

    def recorded(self, iteration, do_eval=True):
        opt = self.optimizer.state_dict()
        seen.append({
            'iteration': iteration,
            'params': {k: v.clone() for k, v in
                       self.model.state_dict().items()},
            'opt': {i: {k: v.clone() for k, v in s.items()}
                    for i, s in opt['state'].items()},
            'env': tstate.plan_state_to_numpy(self.env_states),
            'generator': self.generator.get_state()})
        return train_iteration(self, iteration, do_eval)

    monkeypatch.setattr(ttrain.Trainer, 'train_iteration', recorded)
    return seen


def _assert_tensors_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tensors_equal(a[k], b[k])
        else:
            assert torch.equal(torch.as_tensor(a[k]),
                               torch.as_tensor(b[k])), k


def test_phase1_resume_runs_the_next_iteration(checkpoints, tmp_path,
                                               monkeypatch):
    """run_training for 2 iterations, then a resume of final.pt with
    iterations=3: the resumed run trains iteration 2 alone; it carries the
    best plan, reward and iteration, and the parameters and Adam's state
    (its step goes on); it restarts the env batch and the random stream
    from the seed, as the JAX trainer's resume does (a fresh trainer, then
    load_checkpoint: urban_tpu/rl/train_tpu.py:116)."""
    seen = _state_at_entry(monkeypatch)

    def run(iterations, resume=None):
        cfg = TConfig('hlg', 111, root_dir=str(tmp_path))
        return ttrain.run_training(cfg, iterations, 2, eval_envs=1,
                                   rollout_len=8, resume=resume,
                                   device='cpu')

    first = run(2)
    assert [s['iteration'] for s in seen] == [0, 1]
    final = os.path.join(first.cfg.model_dir, 'final.pt')
    # a best plan as a long run would hold one (8-step windows end no
    # episode): the resumed run must carry it
    ckpt = ttrain.read_checkpoint(final)
    assert ckpt['iteration'] == 1 and ckpt['best_plan_state'] is None
    with open(checkpoints('hlg')[1], 'rb') as f:
        plan = torch.load(f, weights_only=False)['best_plan_state']
    ckpt.update(best_plan_state=plan, best_reward=3.25, best_iteration=1)
    torch.save(ckpt, final)

    resumed = run(3, resume=final)
    assert [s['iteration'] for s in seen] == [0, 1, 2]
    assert [h.iteration for h in resumed.history] == [2]
    at_resume = seen[2]
    _assert_tensors_equal(at_resume['params'], ckpt['params'])
    _assert_tensors_equal(at_resume['opt'], ckpt['opt_state']['state'])
    steps_an_iteration = 4 * (2 * 8 // 16)   # epochs x minibatches
    assert all(int(s['step']) == 2 * steps_an_iteration
               for s in at_resume['opt'].values())
    assert all(int(s['step']) == 3 * steps_an_iteration
               for s in resumed.optimizer.state_dict()['state'].values())
    # the env batch and the generator start as iteration 0's did
    _assert_tensors_equal(at_resume['env'], seen[0]['env'])
    assert torch.equal(at_resume['generator'], seen[0]['generator'])
    # the best plan, reward and iteration are carried into final.pt
    assert resumed.best_reward == 3.25 and resumed.best_iteration == 1
    out = ttrain.read_checkpoint(os.path.join(resumed.cfg.model_dir,
                                              'final.pt'))
    assert out['iteration'] == 2
    assert (out['best_reward'], out['best_iteration']) == (3.25, 1)
    _assert_tensors_equal(out['best_plan_state'], plan)
