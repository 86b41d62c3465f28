"""The port's host-env PPO agent (urban_tpu_torch.agents.urban_agent) against
the JAX package's UrbanPlanningAgent, and the numpy GAE and the utilities
it brings (urban_tpu_torch.rl.gae.estimate_advantages_np,
urban_tpu_torch.utils.{params,profiling,checkpoint}).

Both agents are built on the grid config cut as tests/test_agent.py cuts
it (one episode an iteration, max_sequence_length 25, minibatch 16), every
width the config's, and the port takes the JAX agent's initial parameters
(models.convert.load_flax_params). The JAX encoder runs its 'scatter'
backend, f32 as the port (the default 'matmul' backend has bf16 operands).

Tolerances:
- greedy episodes: the same action at every step. Where a step could tie,
  the actions may differ only if the port's top-2 logit gap at the first
  differing step is under TIE_GAP (1e-5: logits of f32 sums taken in
  another order); nothing is reseeded. The episode reward and the plan are
  then equal, since the environment is the same numpy code;
- the update: loss statistics within rtol = atol = 1e-4, parameters within
  tests/test_torch_ppo.py's STEP_ATOL (4e-5) per Adam step taken, and the
  same loss_iter;
- the numpy GAE, the checkpoint round trip and the chunked frozen
  log-probs: bit for bit.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.models import encoder as jenc
from urban_tpu.utils.config import Config as JaxConfig
from urban_tpu.utils.io import load_yaml
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.models.convert import load_flax_params, to_flax_params

from torch_parity import assert_same

torch.set_num_threads(1)

TIE_GAP = 1e-5
STAT_TOL = 1e-4
STEP_ATOL = 4e-5      # per Adam step, tests/test_torch_ppo.py
CUT = dict(num_episodes_per_iteration=1, max_sequence_length=25,
           mini_batch_size=16, save_model_interval=1)


@pytest.fixture(scope='module', autouse=True)
def scatter_mode():
    """The JAX encoder's f32 scatter backend for every trace of this
    module (and no program traced under another backend reused)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, 'SCATTER_MODE', 'scatter')
        jax.clear_caches()
        yield
    jax.clear_caches()


def cfg_dict(**over):
    d = load_yaml('urban_tpu/cfg/**/grid.yaml')
    d.update(CUT)
    d.update(over)
    return d


def make_pair(root, agent='rl-sgnn', seed=0, tensorboard=False, **over):
    """(JAX agent, port agent on the CPU) of one config and seed, each in
    its own run directory under root, the port holding the JAX agent's
    parameters."""
    from urban_tpu.agents.urban_agent import UrbanPlanningAgent as JaxAgent
    from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
    j = JaxAgent(JaxConfig('grid', seed, root_dir=os.path.join(root, 'jax'),
                           agent=agent, cfg_dict=cfg_dict(**over)))
    t = UrbanPlanningAgent(Config('grid', seed,
                                  root_dir=os.path.join(root, 'port'),
                                  agent=agent, cfg_dict=cfg_dict(**over)),
                           device='cpu', tensorboard=tensorboard)
    if t.model is not None:
        load_flax_params(t.model, jax.tree.map(np.asarray, j.params))
    return j, t


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def greedy_episode(agent, eval_episode):
    """eval_episode(mean_action=True) through the agent's own policy,
    recording each step's observation and action."""
    steps = []
    select = agent.sampler.select_action

    def recording(obs, seed, mean_action):
        action = np.asarray(select(obs, seed, mean_action))
        steps.append((obs, action.reshape(2)))
        return action
    log, plan, ok = eval_episode(agent.env, recording, mean_action=True,
                                 seed=agent.cfg.seed, logger=agent.logger)
    return steps, log, plan, ok


def top2_gap(model, obs):
    """The gap between the two largest logits of the stage's head."""
    from urban_tpu_torch.agents.urban_agent import obs_to_torch
    with torch.no_grad():
        lu, rd, stage, _ = model(obs_to_torch(obs, 'cpu'))
    logits = lu[0] if float(stage[0, 0]) > 0.5 else rd[0]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def assert_same_greedy_episode(j, t):
    """Both agents' greedy episodes from their current parameters: the
    same actions (up to a tie, see the module docstring), then the same
    reward and plan. Returns the port's plans, or None at a tie."""
    from urban_tpu.rl.sampler import eval_episode as j_eval
    from urban_tpu_torch.host.rl.sampler import eval_episode as t_eval
    j_steps, j_log, j_plan, j_ok = greedy_episode(j, j_eval)
    t_steps, t_log, t_plan, t_ok = greedy_episode(t, t_eval)
    for i, ((obs, ja), (_, ta)) in enumerate(zip(j_steps, t_steps)):
        if not np.array_equal(ja, ta):
            gap = top2_gap(t.model, obs)
            assert gap < TIE_GAP, (f'step {i}: jax {ja} port {ta}, top-2 '
                                   f'gap {gap}')
            return None     # a tie: the episodes part here
    assert len(j_steps) == len(t_steps) > 1
    assert j_ok and t_ok
    assert t_log.avg_episode_reward == j_log.avg_episode_reward
    assert_same(t_plan, j_plan)
    return t_log.plans


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp('agent')))


@pytest.fixture(scope='module')
def land_use_plans(pair):
    j, t = pair
    j.freeze_road()
    t.freeze_road()
    return j, t


def test_greedy_land_use_episode_matches_jax(land_use_plans):
    j, t = land_use_plans
    plans = assert_same_greedy_episode(j, t)
    assert plans is None or plans[0]['land_use_reward'] > 0


def test_greedy_road_episode_matches_jax(land_use_plans):
    """Both agents freeze their greedy land-use plan (saved as the best
    checkpoint, as a phase-1 iteration does) and play the road stage."""
    from urban_tpu.rl.sampler import eval_episode as j_eval
    from urban_tpu_torch.host.rl.sampler import eval_episode as t_eval
    j, t = land_use_plans
    for agent, ev in ((j, j_eval), (t, t_eval)):
        log, _, ok = ev(agent.env, agent.sampler.select_action, seed=0,
                        logger=agent.logger)
        assert ok
        agent.best_rewards = log.avg_episode_reward
        agent.best_plans = log.plans
        agent.save_best_flag = True
        agent.save_checkpoint(0)
        agent.freeze_land_use()
    assert t.reward_offset == j.reward_offset
    assert t.cfg.skip_land_use and not t.cfg.skip_road
    plans = assert_same_greedy_episode(j, t)
    assert plans is None or 0 < plans[0]['road_network'] <= 1


@pytest.fixture(scope='module')
def updated(tmp_path_factory, monkeypatch_module):
    """One land-use TrajBatch sampled by the JAX agent, then update_params
    on both agents, each recording its minibatch loss statistics (the
    port's with TensorBoard on, as the JAX agent's is)."""
    from urban_tpu.agents import urban_agent as jmod
    from urban_tpu_torch.agents import urban_agent as tmod
    j, t = make_pair(str(tmp_path_factory.mktemp('update')),
                     tensorboard=True)
    j.freeze_road()
    t.freeze_road()
    batch, _ = j.sampler.sample(j.cfg.num_episodes_per_iteration
                                * j.cfg.max_sequence_length)
    stats = {'jax': [], 'port': []}
    for mod, key in ((jmod, 'jax'), (tmod, 'port')):
        def recording(*a, _step=mod.ppo_update_step, _key=key, **k):
            out = _step(*a, **k)
            step_stats = out[-1] if _key == 'jax' else out
            stats[_key].append({s: float(v) for s, v in step_stats.items()})
            return out
        monkeypatch_module.setattr(mod, 'ppo_update_step', recording)
    j.update_params(batch, 0)
    t.update_params(batch, 0)
    return j, t, batch, stats


@pytest.fixture(scope='module')
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_update_params_matches_jax(updated):
    j, t, batch, stats = updated
    n = len(batch)
    mb = min(t.cfg.mini_batch_size, n)
    steps = t.cfg.num_optim_epoch * max(n // mb, 1)
    assert n > t.cfg.mini_batch_size      # more than one minibatch an epoch
    assert len(stats['port']) == len(stats['jax']) == steps
    assert t.loss_iter == j.loss_iter == steps
    for i, (a, b) in enumerate(zip(stats['port'], stats['jax'])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=f'step {i} {k}')
    port = _flat(to_flax_params(t.model)['params'])
    ref = _flat(jax.tree.map(np.asarray, j.params)['params'])
    assert set(port) == set(ref)
    moved = 0
    for k in sorted(port):
        np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                   atol=steps * STEP_ATOL, err_msg=k)
        moved += not np.array_equal(port[k], ref[k])
    assert moved > 0
    t.tb_logger.flush()
    assert any(f.startswith('events.out.tfevents')
               for f in os.listdir(t.cfg.tb_dir))


def test_chunked_fixed_log_probs_equal_whole_batch(updated):
    """The agent's frozen log-probs and values, in chunks of
    mini_batch_size rows, equal one call on the whole batch; and match
    the JAX agent's (rtol = atol = 1e-5, tests/test_torch_ppo.py)."""
    from urban_tpu.rl.ppo import fixed_log_probs_and_values as j_fixed
    from urban_tpu_torch.agents.urban_agent import obs_to_torch
    from urban_tpu_torch.rl.ppo import fixed_log_probs_and_values
    j, t, batch, _ = updated
    obs = obs_to_torch(batch.states, 'cpu')
    actions = torch.as_tensor(batch.actions)
    assert len(batch) > t.cfg.mini_batch_size
    lp, v = t.fixed_log_probs_and_values(obs, actions)
    whole_lp, whole_v = fixed_log_probs_and_values(t.model, obs, actions)
    assert torch.equal(lp, whole_lp) and torch.equal(v, whole_v)
    load_flax_params(t.model, jax.tree.map(np.asarray, j.params))
    lp, v = t.fixed_log_probs_and_values(obs, actions)
    jlp, jv = j_fixed(j.model, j.params,
                      tuple(jnp.asarray(s) for s in batch.states),
                      jnp.asarray(batch.actions))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_checkpoint_round_trip(updated):
    """save_checkpoint, then an agent resumed from it: the same
    start_iteration, parameters, optimizer state, loss_iter, best rewards
    and plans."""
    from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
    _, t, _, _ = updated
    t.best_rewards, t.best_plans = 1.25, [{'land_use_reward': 1.25}]
    t.save_best_flag = True
    t.save_checkpoint(0)
    assert os.path.exists(os.path.join(t.cfg.model_dir, 'best.p'))
    back = UrbanPlanningAgent(t.cfg, checkpoint=1, device='cpu')
    assert back.start_iteration == 1
    assert back.loss_iter == t.loss_iter
    assert back.best_rewards == t.best_rewards
    assert back.best_plans == t.best_plans
    a, b = t.model.state_dict(), back.model.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = t.optimizer.state_dict(), back.optimizer.state_dict()
    assert sa['param_groups'] == sb['param_groups']
    assert set(sa['state']) == set(sb['state'])
    for i, s in sa['state'].items():
        assert set(s) == set(sb['state'][i])
        for k, x in s.items():
            assert torch.equal(torch.as_tensor(x),
                               torch.as_tensor(sb['state'][i][k])), (i, k)


@pytest.mark.parametrize('normalize', [False, True])
def test_estimate_advantages_np_bit_identical(normalize):
    from urban_tpu.rl.gae import estimate_advantages_np as j_gae
    from urban_tpu_torch.rl.gae import estimate_advantages_np
    rng = np.random.default_rng(5)
    n = 300
    rewards = rng.normal(size=n).astype(np.float32)
    masks = (rng.random(n) > 0.05).astype(np.float32)
    values = rng.normal(size=n).astype(np.float32)
    for gamma, tau in ((1.0, 0.0), (0.99, 0.95)):
        got = estimate_advantages_np(rewards, masks, values, gamma, tau,
                                     normalize)
        want = j_gae(rewards, masks, values, gamma, tau, normalize)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# utils: the cases of tests/test_utils.py
# ---------------------------------------------------------------------------

def _small_model(seed=0):
    from urban_tpu_torch.models.model import ActorCritic, init_like_flax
    m = ActorCritic(hidden_size=(16, 8), gcn_node_dim=8, num_gcn_layers=2,
                    num_edge_fc_layers=1, num_attention_heads=1,
                    max_num_nodes=40, max_num_edges=96,
                    land_use_hidden=(16, 1), road_hidden=(16, 1),
                    value_hidden=(16, 16, 1))
    return init_like_flax(m, torch.Generator().manual_seed(seed))


def test_flat_params_round_trip():
    """count_params and get_flat_params against the JAX helpers on the
    same parameters, and set_flat_params back."""
    from urban_tpu.utils import params as jparams
    from urban_tpu_torch.utils.params import (count_params, get_flat_params,
                                              set_flat_params)
    m = _small_model()
    tree = to_flax_params(m)
    flat = get_flat_params(m)
    assert count_params(m) == jparams.count_params(tree) == flat.numel()
    j_flat = np.asarray(jparams.get_flat_params(tree))
    # the same values, in registration order here and key order in JAX
    assert np.array_equal(np.sort(flat.numpy()), np.sort(j_flat))
    set_flat_params(m, flat * 2)
    assert torch.equal(get_flat_params(m), flat * 2)
    with pytest.raises(ValueError):
        set_flat_params(m, flat[1:])


@pytest.mark.parametrize('kind', ['constant', 'linear', 'cosine', 'step'])
def test_lr_schedules_match_jax(kind):
    from urban_tpu.utils.params import lr_schedule as j_sched
    from urban_tpu_torch.utils.params import lr_schedule
    for warmup in (0, 10):
        port = lr_schedule(kind, 1e-3, 100, warmup_steps=warmup,
                           end_lr=1e-5)
        ref = j_sched(kind, 1e-3, 100, warmup_steps=warmup, end_lr=1e-5)
        for step in (0, 1, 5, 10, 11, 33, 34, 50, 67, 99, 100, 150):
            assert np.isfinite(port(step))
            # optax evaluates in f32 (jnp), the port in Python floats
            np.testing.assert_allclose(port(step), float(ref(step)),
                                       rtol=1e-5, atol=1e-12,
                                       err_msg=f'{warmup} {step}')
    with pytest.raises(ValueError):
        lr_schedule('nope', 1e-3, 100)


def test_pickle_and_step_checkpoints_round_trip(tmp_path):
    from urban_tpu_torch.utils.checkpoint import (load_pickle_checkpoint,
                                                  load_step_checkpoint,
                                                  save_pickle_checkpoint,
                                                  save_step_checkpoint)
    path = str(tmp_path / 'sub' / 'cp.p')
    save_pickle_checkpoint(path, {'params': {'w': torch.ones(2, 2)},
                                  'iteration': 7, 'plans': [np.arange(3)]})
    loaded = load_pickle_checkpoint(path)
    assert loaded['iteration'] == 7
    assert torch.equal(loaded['params']['w'], torch.ones(2, 2))
    assert np.array_equal(loaded['plans'][0], np.arange(3))

    tree = {'w': torch.arange(6.0).reshape(2, 3), 'step': torch.tensor(3)}
    save_step_checkpoint(str(tmp_path), 5, tree)
    back = load_step_checkpoint(str(tmp_path), 5)
    assert torch.equal(back['w'], tree['w'])
    target = {'w': torch.zeros(2, 3, dtype=torch.float64),
              'step': torch.tensor(0)}
    like = load_step_checkpoint(str(tmp_path), 5, target)
    assert like['w'].dtype == torch.float64
    assert torch.equal(like['w'], tree['w'].double())
    with pytest.raises(ValueError):
        load_step_checkpoint(str(tmp_path), 5, {'w': torch.zeros(3, 2),
                                                'step': torch.tensor(0)})


def test_phase_timer_and_device_trace(tmp_path):
    from urban_tpu.utils.profiling import PhaseTimer as JaxTimer
    from urban_tpu_torch.utils.profiling import PhaseTimer, device_trace
    for cls in (PhaseTimer, JaxTimer):
        timer = cls()
        for name in ('sample', 'update', 'sample'):
            with timer.phase(name):
                pass
        assert list(timer.times) == ['sample', 'update']
        assert timer.log_line().startswith('T_sample ')
        timer.reset()
        assert timer.times == {}
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path), 'update') as prof:
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / 'update.json') > 0
    assert any('update' in e.key for e in prof.key_averages())
