"""The port's data parallelism (urban_tpu_torch.parallel.mesh, the
trainer's --num_devices, graft_entry.dryrun_multichip) on the CPU, with
gloo ranks spawned from the package (each run with its own deadline and
rendezvous file under tmp_path).

- The mesh basics: make_mesh, the backend choice, shard_batch, the rows
  of each rank in a minibatch, and the ValueErrors.
- The dp PPO step on 2 and 4 ranks against JAX's make_dp_ppo_update on
  the conftest's 8-device CPU mesh, on the batch of
  tests/test_multichip.py (exploration rows only in the first half, so
  the ranks hold uneven counts), at the small widths of
  tests/test_torch_ppo.py (its 'scatter' encoder backend, the port's
  semantics). The ranks but rank 0 start from other parameters, which
  replicate must overwrite. Parameters after the step within
  test_torch_ppo's bound for one Adam step (4e-5), stats rtol 1e-4.
- A minibatch in which one rank holds no rows, then one split unevenly:
  the one-device steps, within the same bound a step.
- A rank that fails while the other waits in a collective fails the run
  with its traceback, without a hang.
- run_training with num_devices=2 against num_devices=1 on HLG: the same
  sampled actions, losses rtol 1e-5, the ranks' parameters equal; and
  the rejection of envs that do not split evenly.
- dryrun_multichip(2) on the CPU.
"""
import time

import numpy as np
import jax
import pytest
import torch

from urban_tpu.models import encoder as jenc
from urban_tpu.parallel import mesh as jmesh
from urban_tpu.rl import ppo as jppo
from urban_tpu_torch.models.convert import to_flax_params
from urban_tpu_torch.parallel import mesh as tmesh
from urban_tpu_torch.rl import ppo as tppo

from test_torch_ppo import (STEP_ATOL, _assert_trees_close, _batch,
                            _fixed_lp, _j, _models, _t)
from test_torch_ppo import jax_model  # noqa: F401  (the module fixture)

torch.set_num_threads(1)

DEADLINE = 300.0     # seconds, each spawned run
N_ROWS = 32


@pytest.fixture(autouse=True)
def scatter_mode(monkeypatch):
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')


def _mesh(rank, world):
    return tmesh.Mesh(rank, world, torch.device('cpu'), None, 'gloo', world)


def test_mesh_basics():
    one = tmesh.make_mesh(1, 'cpu')
    assert (one.rank, one.world_size, one.group, one.is_main) == (
        0, 1, None, True)
    assert tmesh.choose_backend(4, 'cpu') == ('gloo', 4)
    for bad in (0, -2):
        with pytest.raises(ValueError):
            tmesh.make_mesh(bad, 'cpu')
        with pytest.raises(ValueError):
            tmesh.choose_backend(bad, 'cpu')
    with pytest.raises(ValueError, match='initialized'):
        tmesh.make_mesh(2, 'cpu')       # no process group here
    x = torch.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(
        tmesh.shard_batch(_mesh(1, 2), (x, x[:, 0]))[1], np.arange(12, 24, 3))
    np.testing.assert_array_equal(tmesh.shard_batch(_mesh(3, 4), x), x[6:])
    with pytest.raises(ValueError, match='evenly'):
        tmesh.shard_batch(_mesh(0, 3), x)
    # each rank's rows of a minibatch are the rows of its envs, in order
    T, B, mb = 5, 6, 7
    perm = np.random.default_rng(0).permutation(T * B)
    rows = [tmesh.local_minibatch_rows(perm, 4, mb, B, _mesh(r, 3))
            for r in range(3)]
    for i in range(4):
        got = sorted(t * B + 2 * r + b for r in range(3)
                     for t, b in zip(*np.divmod(rows[r][i], 2)))
        assert got == sorted(perm[i * mb:(i + 1) * mb])


def _dp_inputs(jax_model):
    """The JAX model and parameters, the port's model holding them, and
    the uneven-exploration batch of N_ROWS rows."""
    obs, actions, returns, adv, _, valid, lp_noise = _batch(B=N_ROWS, seed=9)
    jm, params, tm = _models(jax_model)
    fixed = _fixed_lp(jm, params, obs, actions, lp_noise)
    exps = (np.arange(N_ROWS) < N_ROWS // 2).astype(np.float32)
    valid = np.ones(N_ROWS, np.float32)
    return jm, params, tm, (obs, actions, returns, adv, fixed, exps, valid)


@pytest.mark.parametrize('world', [2, 4])
def test_dp_update_matches_jax_dp_update(jax_model, world, tmp_path):
    jm, params, tm, batch = _dp_inputs(jax_model)
    obs, actions, returns, adv, fixed, exps, valid = batch
    cfg_j, cfg_t = jppo.PPOConfig(lr=1e-2), tppo.PPOConfig(lr=1e-2)
    mesh = jmesh.make_mesh(8)
    opt_j = jppo.make_optimizer(cfg_j)
    j_params, _, j_stats = jmesh.make_dp_ppo_update(jm, opt_j, cfg_j, mesh)(
        jmesh.replicate(mesh, params),
        jmesh.replicate(mesh, opt_j.init(params)),
        jmesh.shard_batch(mesh, _j(obs)),
        *jmesh.shard_batch(mesh, _j((actions, returns, adv, fixed, exps,
                                     valid))))
    owners = np.arange(N_ROWS) // (N_ROWS // world)
    results = tmesh.spawn(
        tmesh.dp_ppo_steps, world, 'cpu',
        args=(tm, cfg_t, [(_t(obs), *_t((actions, returns, adv, fixed, exps,
                                         valid)))], [owners]),
        timeout=DEADLINE, rendezvous_dir=str(tmp_path))
    state, stats = results[0]
    for other, other_stats in results[1:]:
        assert all(torch.equal(state[k], other[k]) for k in state)
        assert other_stats == stats
    tm.load_state_dict(state)
    _assert_trees_close(to_flax_params(tm), jax.device_get(j_params), 0,
                        STEP_ATOL)
    for k in (*tppo.STAT_KEYS, 'grad_norm'):
        np.testing.assert_allclose(stats[0][k], float(j_stats[k]),
                                   rtol=1e-4, err_msg=k)


def test_dp_update_with_an_empty_rank_matches_one_device(jax_model,
                                                         tmp_path):
    _, _, tm, batch = _dp_inputs(jax_model)
    obs, *rest = batch
    cfg = tppo.PPOConfig(lr=1e-2)
    half = N_ROWS // 2
    minibatches = [(_t([o[rows] for o in obs]), *_t([x[rows] for x in rest]))
                   for rows in (slice(0, half), slice(half, None))]
    owners = [np.zeros(half, int),              # rank 1 holds no rows
              (np.arange(half) % 3 == 0).astype(int)]
    one_state, one_stats = tmesh.dp_ppo_steps(
        tmesh.make_mesh(1, 'cpu'), tm, cfg, minibatches,
        [np.zeros(half, int)] * 2)
    assert all(float(s['grad_norm']) > 0 for s in one_stats)
    results = tmesh.spawn(tmesh.dp_ppo_steps, 2, 'cpu',
                          args=(tm, cfg, minibatches, owners),
                          timeout=DEADLINE, rendezvous_dir=str(tmp_path))
    for state, stats in results:
        for k, v in one_state.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0,
                                       atol=2 * STEP_ATOL, err_msg=k)
        for got, want in zip(stats, one_stats):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=k)
    assert all(torch.equal(results[0][0][k], results[1][0][k])
               for k in one_state)


def test_a_failing_rank_fails_the_run(jax_model, tmp_path):
    """Rank 1's rows lie outside the minibatch: it fails in its forward
    while rank 0 waits in the all-reduce of the weight sums. The run
    raises with rank 1's traceback, well before the deadline."""
    _, _, tm, (obs, *rest) = _dp_inputs(jax_model)
    owners = np.r_[np.zeros(N_ROWS, int), np.ones(4, int)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='rank 1 failed(.|\n)*IndexError'):
        tmesh.spawn(tmesh.dp_ppo_steps, 2, 'cpu',
                    args=(tm, tppo.PPOConfig(), [(_t(obs), *_t(rest))],
                          [owners]),
                    timeout=DEADLINE, rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < DEADLINE / 2


def test_run_training_two_ranks_matches_one(tmp_path):
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import run_training
    kw = dict(iterations=1, num_envs=4, rollout_len=3, eval_envs=1,
              device='cpu')
    ranks = run_training(Config('hlg', 0, root_dir=str(tmp_path / 'dp2')),
                         num_devices=2, timeout=DEADLINE, **kw)
    one = run_training(Config('hlg', 0, root_dir=str(tmp_path / 'dp1')),
                       num_devices=1, **kw)
    assert [r['rank'] for r in ranks] == [0, 1]
    assert {r['backend'] for r in ranks} == {'gloo'}
    np.testing.assert_array_equal(
        np.concatenate([r['last_actions'] for r in ranks], axis=1),
        one.last_actions)
    (want,) = one.history
    for r in ranks:
        (st,) = r['history']
        assert st.minibatch_rows == [6] * 4       # 12 rows, 1 mb, 4 epochs
        assert (st.episodes, st.failures, st.success_frac) == (
            want.episodes, want.failures, want.success_frac)
        for k, v in want.losses.items():
            np.testing.assert_allclose(st.losses[k], v, rtol=1e-5, err_msg=k)
        assert all(torch.equal(r['params'][k], ranks[0]['params'][k])
                   for k in r['params'])
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(ranks[0]['params'][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_run_training_rejects_uneven_envs(tmp_path):
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import run_training
    with pytest.raises(ValueError, match='divisible'):
        run_training(Config('hlg', 0, root_dir=str(tmp_path)), 1, 3,
                     eval_envs=0, rollout_len=3, num_devices=2, device='cpu')


def test_dryrun_multichip_on_cpu(tmp_path):
    from urban_tpu_torch.graft_entry import GATE, dryrun_multichip
    out = dryrun_multichip(2, device='cpu', timeout=DEADLINE,
                           rendezvous_dir=str(tmp_path))
    assert out['max_rel_diff'] < GATE
    assert all(g > 0 for g in out['grad_norms'])
