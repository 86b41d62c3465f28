"""The port's PPO trainer loop against the JAX trainer's, across
iterations: urban_tpu.rl.train_tpu.TPUTrainer and
urban_tpu_torch.rl.trainer.Trainer side by side at the trainer's caps,
on HLG (N = 1344 nodes, E = 3000 edges), on the planning-concept
scenario hlg_concept (N = 1344, E = 4000; its concept term, weighted 3,
enters the reward where an episode's land use ends, so the update learns
from it) and on DHM (N = 1408, E = 3000; land use only, road weight 0),
under the learning-parity recipe's flags (--normalize_advantages
--tau 0.95), from the same parameters (the JAX trainer's initial draw,
converted).

Both take the same sampling noise: the JAX trainer's own key chain
(TPUTrainer.collect splits its key, jaxenv/rollout.py splits the step keys
and draws the exploration uniforms, models/model.py splits the policy key
per head, and jax.random.categorical adds -log(-log(u)) Gumbel noise of
uniforms on [tiny, 1)) is drawn here and served, draw by draw, to the
port's one draw function, urban_tpu_torch.models.policy.uniform, wherever
it is looked up. Neither package is edited.

Each trainer then runs its own train_iteration twice (collect -> weights
-> update -> eval) and a third collect (the slow variant, ~160 s here;
the tier-1 variant runs one iteration without its eval, then the second
collect, ~110 s), so the loop itself is held: the
env batch carried from collect to collect (episodes end inside the
35-step window, about 29 steps, and the unfinished ones cross it),
auto-reset, the success weights, GAE's bootstrap at the window's edge,
Adam's state over iterations, the permutation of default_rng(seed +
iteration), the greedy eval and the best-plan tracking.

Checks: every action, done and failure equal (an action may differ only
where the perturbed top-2 gap is under 1e-5, the agent tests' rule; the
test reports the gap of any that differs); rewards, values and log-probs
within the env lockstep's rtol 1e-5 / atol 1e-4; loss stats within 1e-4;
parameters within 4e-5 an Adam step, accumulated over the iterations
(tests/test_torch_trainer.py's bound); Adam's step count equal; the
iteration statistics, the eval reward, best_reward and best_iteration
equal. The JAX encoder runs its 'scatter' backend (f32, the port's
semantics).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from urban_tpu.models import encoder as jenc
from urban_tpu.rl.train_tpu import TPUTrainer
from urban_tpu.utils.config import Config
from urban_tpu_torch.host.utils.config import Config as TorchConfig
from urban_tpu_torch.models import policy
from urban_tpu_torch.models.convert import load_flax_params, to_flax_params
from urban_tpu_torch.rl.trainer import Trainer
from urban_tpu_torch.torchenv import program

torch.set_num_threads(1)

SEED = 111
ENVS, STEPS, EVAL_ENVS = 2, 35, 2
PHASE_STEPS = 60          # the two-phase curriculum's episode cap, a phase
CAPS = {'hlg': (1344, 3000), 'hlg_concept': (1344, 4000),
        'dhm': (1408, 3000)}   # (N, E)
STEP_ATOL = 4e-5          # a parameter's bound, an Adam step
RTOL, ATOL = 1e-5, 1e-4   # the env lockstep's float rule


def _recipe(cfg):
    cfg.agent_specs = dict(cfg.agent_specs, normalize_advantages=True)
    cfg.tau = 0.95
    return cfg


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def jax_collect_noise(key, num_steps, batch, num_edges, num_nodes):
    """The uniforms a TPUTrainer.collect draws from its key `key`, in the
    order the port's collect asks for them: per step, the exploration
    draw (B,), then the land-use head's (B, E) and the road head's
    (B, N) Gumbel uniforms."""
    tiny = float(jnp.finfo(jnp.float32).tiny)
    _, sub = jax.random.split(key)
    draws = []
    for step_rng in jax.random.split(sub, num_steps):
        rng_a, rng_e = jax.random.split(step_rng)
        rng_lu, rng_road = jax.random.split(rng_a)
        draws += [jax.random.uniform(rng_e, (batch,)),
                  jax.random.uniform(rng_lu, (batch, num_edges),
                                     minval=tiny, maxval=1.0),
                  jax.random.uniform(rng_road, (batch, num_nodes),
                                     minval=tiny, maxval=1.0)]
    return [np.asarray(d) for d in draws]


class ServedNoise:
    """Stands in for policy.uniform: serves queued JAX draws in order,
    and a constant where nothing is queued (the greedy eval's heads draw,
    and the draws decide nothing there)."""

    def __init__(self):
        self.queue = []

    def __call__(self, shape, generator, device, dtype=torch.float32):
        if not self.queue:
            return torch.full(tuple(shape), 0.5, device=device, dtype=dtype)
        u = self.queue.pop(0)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return torch.tensor(u, device=device, dtype=dtype)


def _recorded(obj, name, store, before=None):
    orig = getattr(obj, name)

    def call(*args, **kwargs):
        if before is not None:
            before()
        out = orig(*args, **kwargs)
        store.append(out)
        return out
    setattr(obj, name, call)


def _perturbed_gap(model, traj, t, b, draws):
    """The top-2 gap of logits + Gumbel noise of the row (t, b) of a
    collect, on the port's observation, in the head of its stage."""
    obs = tuple(o[t, b:b + 1] for o in traj.obs)
    with torch.no_grad():
        lu, road, stage, _ = model(obs)
    head, u = (lu, draws[3 * t + 1]) if stage[0, 0] > 0.5 else \
        (road, draws[3 * t + 2])
    scores = head[0] - torch.log(-torch.log(torch.as_tensor(u[b])))
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1])


def _compare_collect(tt, j, t, draws, where):
    """The port's trajectory t against JAX's j, step by step."""
    ja, ta = np.asarray(j.actions), t.actions.numpy()
    bad = np.argwhere((ja != ta).any(-1))
    gaps = [(int(s), int(b), _perturbed_gap(tt.model, t, s, b, draws))
            for s, b in bad]
    assert not gaps, f'{where}: actions differ at (step, env, gap) {gaps}'
    for name in ('dones', 'failures'):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=f'{where} {name}')
    np.testing.assert_array_equal(t.exps.numpy(), np.asarray(j.exps))
    for name in ('rewards', 'values', 'log_probs'):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=f'{where} {name}')


def _adam_count(opt_state):
    adam = [x for x in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1, opt_state
    return int(adam[0].count)


# the HLG cases keep the ids they had before the scenario was a parameter
@pytest.mark.parametrize('cfg,iterations,do_eval', [
    pytest.param('hlg', 1, False, id='1-False'),
    pytest.param('hlg', 2, True, marks=pytest.mark.slow, id='2-True'),
    pytest.param('hlg_concept', 1, False, id='hlg_concept-1-False'),
    pytest.param('hlg_concept', 2, True, marks=pytest.mark.slow,
                 id='hlg_concept-2-True'),
    pytest.param('dhm', 1, False, id='dhm-1-False'),
    pytest.param('dhm', 2, True, marks=pytest.mark.slow, id='dhm-2-True')])
def test_trainer_loop_matches_tpu_trainer_across_iterations(
        cfg, iterations, do_eval, tmp_path, monkeypatch):
    run_lockstep(iterations, do_eval, tmp_path, monkeypatch, cfg=cfg)


def run_lockstep(iterations, do_eval, tmp_path, monkeypatch,
                 encoder='sgnn', cfg='hlg'):
    """Both trainers on scenario `cfg` with the state encoder `encoder`
    ('sgnn' or 'mlp') through `iterations` train iterations and the
    collect after them."""
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')
    jt = TPUTrainer(_recipe(Config(cfg, SEED,
                                   root_dir=str(tmp_path / 'jax'))),
                    num_envs=ENVS, rollout_len=STEPS, eval_envs=EVAL_ENVS,
                    encoder=encoder)
    tt = Trainer(_recipe(TorchConfig(cfg, SEED,
                                     root_dir=str(tmp_path / 'torch'))),
                 num_envs=ENVS, rollout_len=STEPS, eval_envs=EVAL_ENVS,
                 device='cpu', encoder=encoder)
    assert (jt.encoder, tt.encoder) == (encoder, encoder)
    assert (tt.spec.num_features, tt.spec.NE) == CAPS[cfg]
    if cfg == 'hlg_concept':
        assert len(tt.spec.concepts) == 3 and tt.spec.concept_weight == 3.0
    load_flax_params(tt.model, jax.tree.map(np.asarray, jt.params))
    ended, crossed = lockstep_loop(jt, tt, iterations, do_eval, monkeypatch)
    # the window ended episodes and carried unfinished ones across it
    assert ended >= ENVS * (iterations + 1) and crossed > 0
    assert jt.best_iteration >= 0 or not do_eval


def lockstep_loop(jt, tt, iterations, do_eval, monkeypatch):
    """JAX's trainer `jt` and the port's `tt`, from the same parameters,
    through `iterations` train iterations and the collect after them, the
    port on JAX's noise, compared after each part. Returns the episodes
    that ended in the collects and those that crossed a window's end."""
    steps = tt.rollout_len
    noise = ServedNoise()
    monkeypatch.setattr(policy, 'uniform', noise)
    monkeypatch.setattr(program, 'uniform', noise)
    keys, j_trajs, t_trajs, j_stats, t_stats = [], [], [], [], []
    _recorded(jt, 'collect', j_trajs, before=lambda: keys.append(jt.rng))
    _recorded(tt, 'collect', t_trajs)
    _recorded(jt, 'update', j_stats)
    _recorded(tt, 'update', t_stats)

    def serve():
        draws = jax_collect_noise(keys[-1], steps, tt.num_envs, tt.spec.NE,
                                  tt.spec.num_features)
        noise.queue = list(draws)
        return draws

    ended = crossed = 0
    for it in range(iterations + 1):
        where = f'iteration {it}'
        if it < iterations:
            j_it = jt.train_iteration(it, do_eval)
            draws = serve()
            t_it = tt.train_iteration(it, do_eval)
        else:                     # the collect after the last iteration
            jt.collect()
            draws = serve()
            tt.collect()
        assert not noise.queue, f'{where}: the port drew less than JAX'
        _compare_collect(tt, j_trajs[-1], t_trajs[-1], draws, where)
        dones = t_trajs[-1].dones.numpy()
        ended += int(dones.sum())
        crossed += int((~dones[-1]).sum())
        if it == iterations:
            break

        for k, v in t_stats[-1].items():
            np.testing.assert_allclose(float(v), float(j_stats[-1][k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f'{where} {k}')
        np.testing.assert_allclose(tt.last_value_mc_rms,
                                   jt.last_value_mc_rms, rtol=1e-5,
                                   atol=1e-5, err_msg=where)
        adam_steps = _adam_count(jt.opt_state)
        assert adam_steps == 4 * (it + 1)       # 4 epochs of 1 minibatch
        assert {int(s['step']) for s in tt.optimizer.state.values()} == \
            {adam_steps}
        a = _flat(to_flax_params(tt.model)['params'])
        b = _flat(jax.tree.map(np.asarray, jt.params)['params'])
        assert set(a) == set(b)
        for k in sorted(a):
            np.testing.assert_allclose(a[k], b[k], rtol=0,
                                       atol=adam_steps * STEP_ATOL,
                                       err_msg=f'{where} {k}')

        assert (t_it.episodes, t_it.failures) == (j_it.episodes,
                                                  j_it.failures), where
        for name in ('mean_episode_reward', 'success_frac', 'eval_reward'
                     )[:3 if do_eval else 2]:
            np.testing.assert_allclose(getattr(t_it, name),
                                       getattr(j_it, name), rtol=RTOL,
                                       atol=ATOL, err_msg=f'{where} {name}')
        np.testing.assert_allclose(tt.best_reward, jt.best_reward,
                                   rtol=RTOL, atol=ATOL, err_msg=where)
        assert tt.best_iteration == jt.best_iteration, where
    return ended, crossed


def test_road_phase_trainer_matches_tpu_trainer(tmp_path, monkeypatch):
    """Grid's road phase (--separate_train): JAX's and the port's phase-1
    trainers (cfg.train(), BOUNDARY segments kept) from JAX's initial
    draw; one land-use plan, the port's greedy episode of that draw (the
    land-use lockstep to a frozen plan, and state_to_table's equality, are
    tests/test_torch_two_phase.py's), made into each package's table from
    the same arrays, its leftover feasible space small green; cfg.finetune()
    and each package's freeze_land_use_trainer on it, warm-started from
    the phase-1 parameters: the same spec, the same tensors copied (JAX's
    transfer_matching_params' counts, the port's warm_start), the same
    parameters after. Then one road-phase train_iteration of 2 envs x the
    phase's 60 steps and the collect after it, on JAX's noise
    (lockstep_loop): the road head's actions, the road rewards in the
    update, Adam's step count. Road episodes end inside the window."""
    from urban_tpu import city_config as jcc
    from urban_tpu.jaxenv import state as jstate
    from urban_tpu.rl import train_tpu
    from urban_tpu_torch.host import city_config as tcc
    from urban_tpu_torch.rl import trainer as ttrain
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv import step as tstep

    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')
    cj = _recipe(Config('grid', SEED, root_dir=str(tmp_path / 'jax')))
    ct = _recipe(TorchConfig('grid', SEED, root_dir=str(tmp_path / 'torch')))
    cj.train()
    ct.train()
    jt = TPUTrainer(cj, num_envs=ENVS, eval_envs=EVAL_ENVS,
                    rollout_len=PHASE_STEPS, keep_boundaries=True)
    tt = Trainer(ct, num_envs=ENVS, eval_envs=EVAL_ENVS,
                 rollout_len=PHASE_STEPS, device='cpu', keep_boundaries=True)
    assert (tt.spec.num_features, tt.spec.NE) == (1408, 3000)
    phase1 = jax.tree.map(np.asarray, jt.params)
    load_flax_params(tt.model, phase1)

    tt.eval_agent(0)              # the port's greedy land-use episode
    plan = tt.best_plan_state
    assert plan is not None and int(plan['stage']) == 2
    table_j = jstate.state_to_table(jstate.PlanState(**plan))
    table_t = tstate.state_to_table(plan)
    table_j.types[table_j.alive_mask_of(jcc.FEASIBLE)] = jcc.GREEN_S
    table_t.types[table_t.alive_mask_of(tcc.FEASIBLE)] = tcc.GREEN_S
    np.testing.assert_array_equal(table_t.types, table_j.types)

    cj.finetune()
    ct.finetune()
    train_tpu.freeze_land_use_trainer(jt, table_j, warm_start_params=phase1)
    ttrain.freeze_land_use_trainer(tt, table_t, warm_start_params={
        k: v.clone() for k, v in tt.model.state_dict().items()})
    assert (jt.phase, tt.phase) == (2, 2)
    assert dataclasses.asdict(tt.spec) == dataclasses.asdict(jt.spec)
    # the frozen plan regrows the slot table (1600-1664 nodes by the plan)
    assert tt.spec.num_features > 1408 and tt.spec.NE == 3000
    assert tt.spec.skip_land_use and not tt.spec.skip_road
    _, copied, total = train_tpu.transfer_matching_params(
        phase1, jax.tree.map(np.asarray, jt.params))
    assert tt.warm_start == (copied, total) == (total, total)
    a = _flat(to_flax_params(tt.model)['params'])
    b = _flat(jax.tree.map(np.asarray, jt.params)['params'])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    budget = int(tt.init_state.total_road_steps)
    assert 0 < budget < PHASE_STEPS
    assert int(tstep.road_mask(tt.spec, tt.init_state).sum()) > 0

    rewards = []
    _recorded(tt, 'collect', rewards)
    ended, crossed = lockstep_loop(jt, tt, 1, False, monkeypatch)
    # each env ended a road episode in each window, none failed, each
    # with its road reward in (0, 1] (the grid's road weight is 1)
    assert ended >= 2 * ENVS and crossed > 0
    for traj in rewards:
        done, fail = traj.dones.numpy(), traj.failures.numpy()
        assert done.sum(0).min() >= 1 and not fail.any()
        final = traj.rewards.numpy()[done]
        assert ((final > 0) & (final <= 1)).all()
