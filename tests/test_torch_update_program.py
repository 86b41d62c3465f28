"""The update program (urban_tpu_torch/rl/update_program.py), the port's
counterpart of the jitted ppo_update_epoch, on the CPU:

* its epochs equal the Python loop they replace (ppo_update_step once a
  minibatch, as ppo.ppo_update_epoch runs it), bit for bit: parameters,
  Adam's state, every minibatch's loss stats and gradient norm, the
  epoch's means;
* on the same inputs and permutations it matches JAX's jitted
  ppo_update_epoch within tests/test_torch_ppo.py's tolerances (stats
  rtol = atol = 1e-4; parameters 4e-5 an Adam step), with the weights
  carried over by models/convert.py;
* after the warm-up, its region (loss forward, backward, clip) runs no op
  that syncs the host or copies host data (test_torch_program.py's
  SYNC_OPS): the condition for capturing it. The optimizer step is left
  out here, where Adam cannot be capturable; the card's capture checks it;
* what it returns shares no memory with its buffers; the trainer keys it
  on the optimizer, and load_checkpoint and freeze_land_use_trainer drop
  it;
* tools/profile_update.py runs end to end at a tiny size.

The card-only test holds the graphs against eager:
    python -m pytest tests/test_torch_update_program.py -m gpu --noconftest
"""
import copy

import numpy as np
import pytest
import torch

from test_torch_program import SYNC_OPS, _OpLog
from urban_tpu_torch.models.model import ActorCritic, NODE_DIM, NUMERICAL_DIM
from urban_tpu_torch.rl import ppo as tppo
from urban_tpu_torch.rl.update_program import STEP_KEYS, UpdateProgram

torch.set_num_threads(1)

SMALL = dict(hidden_size=(16, 8), gcn_node_dim=8, num_gcn_layers=2,
             num_edge_fc_layers=1, num_attention_heads=1, max_num_nodes=40,
             max_num_edges=96, land_use_hidden=(16, 1), road_hidden=(16, 1),
             value_hidden=(16, 16, 1))
ROWS, MB = 12, 4
STEP_ATOL = 4e-5      # per Adam step (tests/test_torch_ppo.py)


def _rows(n=ROWS, seed=0):
    """The update's rows as numpy: the 9 observation arrays, valid actions,
    returns, advantages, exploration and success weights, and a log-prob
    noise that puts some ratios outside the clip."""
    rng = np.random.default_rng(seed)
    N, E = SMALL['max_num_nodes'], SMALL['max_num_edges']
    e0 = rng.integers(0, N // 2, size=(n, E, 1))
    e1 = rng.integers(N // 2, N, size=(n, E, 1))
    edge_mask = rng.random((n, E)) < 0.8
    lu_mask = edge_mask & (rng.random((n, E)) < 0.5)
    lu_mask[:, 0] = edge_mask[:, 0] = True
    rd_mask = rng.random((n, N)) < 0.3
    rd_mask[:, 0] = True
    stage = np.zeros((n, 3), np.float32)
    stage[np.arange(n), rng.integers(0, 2, n)] = 1.0
    obs = (rng.normal(size=(n, NUMERICAL_DIM)).astype(np.float32),
           rng.normal(size=(n, N, NODE_DIM)).astype(np.float32),
           np.concatenate([e0, e1], -1).astype(np.int32),
           rng.normal(size=(n, NODE_DIM)).astype(np.float32),
           rng.random((n, N)) < 0.9, edge_mask, lu_mask, rd_mask, stage)
    actions = np.stack([
        np.array([rng.choice(np.flatnonzero(m)) for m in lu_mask]),
        np.array([rng.choice(np.flatnonzero(m)) for m in rd_mask])],
        -1).astype(np.int32)
    return (obs, actions, rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            (rng.random(n) < 0.7).astype(np.float32),
            (rng.random(n) < 0.8).astype(np.float32),
            (0.3 * rng.normal(size=(n, 1))).astype(np.float32))


def _inputs(model, seed=0):
    """(obs, actions, returns, advantages, fixed log-probs, exps, valid)
    as torch tensors, the fixed log-probs the model's own plus noise."""
    obs, actions, ret, adv, exps, valid, noise = _rows(seed=seed)
    obs = tuple(torch.as_tensor(x) for x in obs)
    actions = torch.as_tensor(actions)
    with torch.no_grad():
        lp = tppo.fixed_log_probs_and_values(model, obs, actions)[0]
    return (obs, actions, torch.as_tensor(ret), torch.as_tensor(adv),
            lp + torch.as_tensor(noise), torch.as_tensor(exps),
            torch.as_tensor(valid))


def _model(seed=0):
    from urban_tpu_torch.models.model import init_like_flax
    return init_like_flax(ActorCritic(**SMALL),
                          torch.Generator().manual_seed(seed))


def _perms(epochs=2):
    rng = np.random.default_rng(0)
    return [torch.as_tensor(rng.permutation(ROWS)).split(MB)
            for _ in range(epochs)]


def _adam_state(optimizer):
    return [v for p in optimizer.param_groups[0]['params']
            for _, v in sorted(optimizer.state[p].items())]


@pytest.mark.parametrize('weight_decay', [0.0, 1e-2])
def test_program_equals_the_python_loop(weight_decay):
    """Two epochs of 3 minibatches of 4 rows through the program and
    through ppo_update_step in a loop, from one model and optimizer."""
    cfg = tppo.PPOConfig(weight_decay=weight_decay)
    ref_model = _model()
    obs, actions, ret, adv, lp, exps, valid = _inputs(ref_model)
    model = copy.deepcopy(ref_model)
    ref_opt = tppo.make_optimizer(ref_model.parameters(), cfg)
    opt = tppo.make_optimizer(model.parameters(), cfg)
    program = UpdateProgram(model, opt, cfg, MB)
    for epoch in _perms():
        want = []
        for idx in epoch:
            s = tppo.ppo_update_step(
                ref_model, ref_opt, cfg, tuple(o[idx] for o in obs),
                actions[idx], ret[idx], adv[idx], lp[idx], exps[idx],
                valid[idx])
            want.append(torch.stack([s[k] for k in STEP_KEYS]))
        means = program.epoch(obs, actions, ret, adv, lp, exps, epoch,
                              valid)
        assert len(program.minibatch_stats) == len(want) == 3
        for a, b in zip(program.minibatch_stats, want):
            assert torch.equal(a, b)
        want_means = torch.stack([w[:4] for w in want]).mean(dim=0)
        assert torch.equal(torch.stack([means[k] for k in tppo.STAT_KEYS]),
                           want_means)
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)
    assert len(_adam_state(opt)) == 3 * len(list(model.parameters()))
    for a, b in zip(_adam_state(opt), _adam_state(ref_opt)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        model.parameters(), _model().parameters()))


def test_program_matches_jax_ppo_update_epoch(monkeypatch):
    """tests/test_torch_ppo.py's epoch test through the program: two
    epochs of 3 shuffled minibatches of 4 rows (6 Adam steps) from the
    same parameters and permutations as JAX's jitted ppo_update_epoch."""
    import jax
    import jax.numpy as jnp
    from urban_tpu.models import encoder as jenc
    from urban_tpu.models.model import ActorCritic as JaxActorCritic
    from urban_tpu.rl import ppo as jppo
    from urban_tpu_torch.models.convert import (load_flax_params,
                                                to_flax_params)
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')
    obs, actions, ret, adv, exps, valid, noise = _rows(seed=6)
    jm = JaxActorCritic(encoder='sgnn', **SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              tuple(jnp.asarray(x) for x in obs))
    tm = ActorCritic(**SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    j_obs = tuple(jnp.asarray(x) for x in obs)
    lp, _, _ = jax.jit(lambda p: jm.apply(
        p, j_obs, jnp.asarray(actions), method='log_prob_entropy_value'))(
        params)
    fixed = np.asarray(lp) + noise
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    opt_j = jppo.make_optimizer(cfg_j)
    j_state = opt_j.init(params)
    program = UpdateProgram(tm, tppo.make_optimizer(tm.parameters(), cfg_t),
                            cfg_t, MB)
    t_in = [torch.as_tensor(x) for x in (actions, ret, adv, fixed, exps)]
    rng = np.random.default_rng(0)
    for _ in range(2):
        perm = rng.permutation(ROWS)
        params, j_state, j_stats = jppo.ppo_update_epoch(
            jm, opt_j, cfg_j, params, j_state, j_obs, jnp.asarray(actions),
            jnp.asarray(ret), jnp.asarray(adv), jnp.asarray(fixed),
            jnp.asarray(exps), jnp.asarray(perm), ROWS // MB, MB,
            jnp.asarray(valid))
        t_stats = program.epoch(tuple(torch.as_tensor(x) for x in obs),
                                *t_in, torch.as_tensor(perm).split(MB),
                                torch.as_tensor(valid))
        for k in tppo.STAT_KEYS:
            np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)

    def flat(tree, prefix=''):
        out = {}
        for k, v in tree.items():
            path = f'{prefix}/{k}' if prefix else k
            out.update(flat(v, path) if isinstance(v, dict)
                       else {path: np.asarray(v)})
        return out
    a = flat(to_flax_params(tm)['params'])
    b = flat(jax.tree.map(np.asarray, params)['params'])
    assert set(a) == set(b)
    for k in sorted(a):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=6 * STEP_ATOL,
                                   err_msg=k)


def test_update_region_has_no_host_sync(monkeypatch):
    """After the first epoch (the warm-up, which makes the gradients and
    Adam's state), a minibatch step's loss forward, backward and clip run
    no op that reads a tensor on the host or copies host data to the
    device. The optimizer step is not run here: Adam is capturable on the
    card only."""
    model = _model()
    obs, actions, ret, adv, lp, exps, valid = _inputs(model)
    cfg = tppo.PPOConfig()
    opt = tppo.make_optimizer(model.parameters(), cfg)
    program = UpdateProgram(model, opt, cfg, MB)
    program.epoch(obs, actions, ret, adv, lp, exps, _perms(1)[0], valid)
    monkeypatch.setattr(opt, 'step', lambda: None)
    log = _OpLog()
    with log:
        out = program._step()
    assert out.shape == (len(STEP_KEYS),)
    # the forward's segment means (the plain version's index_add_), then
    # the backward
    assert {'index_add_', 'tanh_backward'} <= set(log.ops)
    assert len(log.ops) > 300
    assert not [op for op in log.ops if op in SYNC_OPS]


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def test_results_do_not_alias_the_program_buffers():
    """The epoch's means and each minibatch's stats share no memory with
    the program's input buffers or its static output, and stay as they
    were after the program steps on."""
    model = _model()
    inputs = _inputs(model)
    cfg = tppo.PPOConfig()
    program = UpdateProgram(model, tppo.make_optimizer(model.parameters(),
                                                       cfg), cfg, MB)
    first, second = _perms()
    means = program.epoch(*inputs[:6], first, inputs[6])
    kept = list(means.values()) + program.minibatch_stats
    copies = [x.clone() for x in kept]
    program.epoch(*inputs[:6], second, inputs[6])
    held = _storages(program.inputs)
    if program.out is not None:
        held |= _storages([program.out])
    assert not _storages(kept) & held
    for x, y in zip(kept, copies):
        assert torch.equal(x, y)


def test_program_refuses_a_minibatch_of_other_rows():
    model = _model()
    inputs = _inputs(model)
    cfg = tppo.PPOConfig()
    program = UpdateProgram(model, tppo.make_optimizer(model.parameters(),
                                                       cfg), cfg, MB)
    with pytest.raises(ValueError, match='rows'):
        program.epoch(*inputs[:6], [torch.arange(MB + 1)], inputs[6])


def _update_programs(trainer):
    return [v for k, v in trainer.programs.items() if k[0] == 'update']


@pytest.fixture(scope='module')
def grid_trainer(tmp_path_factory):
    """A phase-1 grid trainer (2 envs x 3 steps) after one iteration."""
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import Trainer
    cfg = Config('grid', 0, root_dir=str(tmp_path_factory.mktemp('upd')))
    cfg.train()
    trainer = Trainer(cfg, num_envs=2, rollout_len=3, eval_envs=1,
                      device='cpu', keep_boundaries=True)
    trainer.train_iteration(0, do_eval=False)
    return trainer


def test_trainer_keys_the_update_program(grid_trainer):
    """One update program after an iteration, keyed on spec, model,
    optimizer and minibatch rows, and the same one the next iteration."""
    (program,) = _update_programs(grid_trainer)
    mb = grid_trainer.minibatch_size(grid_trainer.rollout_len)
    assert mb == 6 and program.batch == mb
    assert program.optimizer is grid_trainer.optimizer
    assert program.model is grid_trainer.model
    assert grid_trainer.update_program(mb) is program
    grid_trainer.train_iteration(1, do_eval=False)
    assert _update_programs(grid_trainer) == [program]


def test_load_checkpoint_and_freeze_drop_the_update_program(grid_trainer):
    """load_checkpoint replaces the optimizer's state tensors and
    freeze_land_use_trainer builds a new optimizer (twice with a warm
    start): each drops the program, and the next update builds one on
    the optimizer the trainer then holds."""
    from urban_tpu_torch.rl.trainer import freeze_land_use_trainer
    from urban_tpu_torch.torchenv import state as tstate
    tr = grid_trainer
    (first,) = _update_programs(tr)
    tr.save_checkpoint(0)
    tr.load_checkpoint(f'{tr.cfg.model_dir}/iteration_0000.pt')
    assert not tr.programs
    tr.train_iteration(2, do_eval=False)
    (second,) = _update_programs(tr)
    assert second is not first and second.optimizer is tr.optimizer
    table = tstate.state_to_table(tstate.plan_state_to_numpy(tr.init_state))
    tr.cfg.finetune()
    freeze_land_use_trainer(tr, table, warm_start_params={
        k: v.clone() for k, v in tr.model.state_dict().items()})
    assert not tr.programs
    tr.train_iteration(3, do_eval=False)
    (third,) = _update_programs(tr)
    assert third not in (first, second)
    assert third.optimizer is tr.optimizer and third.model is tr.model


def test_optimizer_state_loads_across_capturable_settings():
    """A capturable optimizer's state (as the card writes it) loads into
    a CPU optimizer, which keeps capturable off and its step counts on
    the CPU, and steps on."""
    cfg = tppo.PPOConfig()
    model = _model()
    inputs = _inputs(model)
    opt = tppo.make_optimizer(model.parameters(), cfg)
    assert not opt.param_groups[0]['capturable']
    UpdateProgram(model, opt, cfg, MB).epoch(*inputs[:6], _perms(1)[0],
                                             inputs[6])
    saved = copy.deepcopy(opt.state_dict())
    for group in saved['param_groups']:
        group['capturable'] = True
    again = tppo.make_optimizer(model.parameters(), cfg)
    tppo.load_optimizer_state(again, saved)
    assert not again.param_groups[0]['capturable']
    steps = [s['step'] for s in again.state.values()]
    assert all(t.device.type == 'cpu' and float(t) == 3.0 for t in steps)
    UpdateProgram(model, again, cfg, MB).epoch(*inputs[:6], _perms(1)[0],
                                               inputs[6])
    assert all(float(s['step']) == 6.0 for s in again.state.values())


def test_profile_update_runs_on_the_cpu():
    """tools/profile_update.py at 2 HLG envs x 4 steps on the CPU: every
    part timed, the device metrics absent."""
    from urban_tpu_torch.tools import profile_update
    out = profile_update.main(['--device', 'cpu', '--num_envs', '2',
                               '--rollout_len', '4', '--reps', '1'])
    assert out['device'] == 'cpu' and out['profile'] is None
    assert out['minibatch_rows'] == 8 and out['minibatches_per_epoch'] == 1
    assert not out['update_graphed']
    for key in ('epoch_graphed_s', 'epoch_eager_s', 'epoch_row_gather_s',
                'minibatch_forward_s', 'minibatch_forward_backward_s',
                'minibatch_clip_adam_s'):
        assert 0 < out[key] < 60, key
    assert len(out['iterations']) == 2


@pytest.mark.gpu
def test_update_and_ga_graphs_against_eager_on_card():
    """On a card: one HLG trajectory (16 envs x 12 steps, every row
    weighted) through the update of a trainer that replays its graph and
    of one that steps eagerly, from one seed: every parameter, Adam's
    state and the loss stats equal, 4 launches of each kernel a replay;
    and the GA's population fitness (16 genes, 12 steps, sampled and
    greedy, two calls: two seeds) through its graph and eagerly: equal
    (skips without a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    from urban_tpu_torch import bench
    from urban_tpu_torch.ops import segment_ops
    from urban_tpu_torch.rl import ga
    dev = torch.device('cuda')
    trainers = {eager: bench.make_trainer(16, 12, dev, seed=0, eval_envs=1,
                                          eager=eager)
                for eager in (False, True)}
    traj = trainers[False].collect()
    ones = torch.ones_like(traj.rewards)
    stats = {e: t.update(traj, 0, weights=ones) for e, t in trainers.items()}
    g, e = trainers[False], trainers[True]
    (program,) = _update_programs(g)
    assert program.graph is not None and not _update_programs(e)[0].graph
    assert program.launches == {'segment_mean': 2,
                                'segment_mean_backward': 2}
    for k in stats[False]:
        assert torch.equal(stats[False][k], stats[True][k]), k
    for a, b in zip(g.model.parameters(), e.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_adam_state(g.optimizer), _adam_state(e.optimizer)):
        assert torch.equal(a, b)
    segment_ops.reset_launches()
    _, spec, init = bench.setup('hlg', {}, dev)
    genes = np.random.default_rng(0).uniform(-5, 5, size=(16, 47))
    for mean_action in (False, True):
        out = {}
        for eager in (False, True):
            fit = ga.make_ga_population_fitness(spec, init, 12, mean_action,
                                                seed=3, device=dev,
                                                eager=eager)
            out[eager] = [fit(genes), fit(genes)]
        for a, b in zip(out[False], out[True]):
            np.testing.assert_array_equal(a, b)
    assert segment_ops.launches == {'segment_mean': 0,
                                    'segment_mean_backward': 0}
