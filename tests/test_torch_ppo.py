"""The port's policy methods, PPO / A2C losses and updates, GAE and success
weights (urban_tpu_torch.models.model, rl.ppo, rl.pg, rl.gae,
torchenv.rollout) against the JAX package's, with the same parameters
(converted with load_flax_params / to_flax_params) and the same inputs,
made with numpy from a seed.

The JAX encoder runs its 'scatter' backend here: f32 and self-loops
counted twice, the port's semantics (the default 'matmul' backend has
bf16 operands, and Pallas in interpret mode has no gradient).

Tolerances:
- forward values (log-probs, entropies, values, losses): rtol = atol = 1e-5,
  f32 sums of a few hundred terms taken in another order;
- gradients: atol 1e-5 + rtol 1e-4, the same sums through the chain rule;
- parameters after Adam steps: Adam's first step moves each parameter by
  lr * g / (|g| + eps), about lr = 4e-4 wherever |g| >> eps = 1e-5, so a
  gradient difference dg moves a parameter by at most lr * dg / eps =
  40 * dg; with dg <= 1e-6 (the gradient tolerance at these sizes) that is
  4e-5 per step, and the bound grows linearly with the steps taken.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.models import encoder as jenc
from urban_tpu.models.model import ActorCritic as JaxActorCritic
from urban_tpu.rl import ppo as jppo
from urban_tpu_torch.models.convert import load_flax_params, to_flax_params
from urban_tpu_torch.models.model import ActorCritic, NODE_DIM, NUMERICAL_DIM
from urban_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

SMALL = dict(hidden_size=(16, 8), gcn_node_dim=8, num_gcn_layers=2,
             num_edge_fc_layers=1, num_attention_heads=1, max_num_nodes=40,
             max_num_edges=96, land_use_hidden=(16, 1), road_hidden=(16, 1),
             value_hidden=(16, 16, 1))
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_ATOL = 4e-5      # per Adam step, see the module docstring


@pytest.fixture(autouse=True)
def scatter_mode(monkeypatch):
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')


def _obs(B=8, seed=0):
    rng = np.random.default_rng(seed)
    N, E = SMALL['max_num_nodes'], SMALL['max_num_edges']
    e0 = rng.integers(0, N // 2, size=(B, E, 1))
    e1 = rng.integers(N // 2, N, size=(B, E, 1))
    edge_mask = rng.random((B, E)) < 0.8
    lu_mask = edge_mask & (rng.random((B, E)) < 0.5)
    lu_mask[:, 0] = edge_mask[:, 0] = True
    rd_mask = rng.random((B, N)) < 0.3
    rd_mask[:, 0] = True
    stage = np.zeros((B, 3), np.float32)
    stage[np.arange(B), rng.integers(0, 2, B)] = 1.0
    return (rng.normal(size=(B, NUMERICAL_DIM)).astype(np.float32),
            rng.normal(size=(B, N, NODE_DIM)).astype(np.float32),
            np.concatenate([e0, e1], -1).astype(np.int32),
            rng.normal(size=(B, NODE_DIM)).astype(np.float32),
            rng.random((B, N)) < 0.9, edge_mask, lu_mask, rd_mask, stage)


def _batch(B=8, seed=0):
    """Observations, valid actions and the loss inputs of a minibatch."""
    rng = np.random.default_rng(seed + 100)
    obs = _obs(B, seed)
    actions = np.stack([
        np.array([rng.choice(np.flatnonzero(m)) for m in obs[6]]),
        np.array([rng.choice(np.flatnonzero(m)) for m in obs[7]])],
        -1).astype(np.int32)
    returns = rng.normal(size=(B, 1)).astype(np.float32)
    advantages = rng.normal(size=(B, 1)).astype(np.float32)
    exps = (rng.random(B) < 0.7).astype(np.float32)
    valid = (rng.random(B) < 0.8).astype(np.float32)
    # log-probs of a slightly different policy: some ratios leave the clip
    lp_noise = (0.3 * rng.normal(size=(B, 1))).astype(np.float32)
    return obs, actions, returns, advantages, exps, valid, lp_noise


@pytest.fixture(scope='module')
def jax_model():
    """The JAX model and its parameters, initialized once per module."""
    jm = JaxActorCritic(encoder='sgnn', **SMALL)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), _j(_obs()))
    return jm, params


def _models(jax_model):
    """The JAX model and parameters, and the port's model holding the
    same parameters."""
    jm, params = jax_model
    tm = ActorCritic(**SMALL)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _t(xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def _grads_tree(tm):
    """The port's gradients as a Flax-shaped tree."""
    g = ActorCritic(**SMALL)
    with torch.no_grad():
        for p, q in zip(g.parameters(), tm.parameters()):
            p.copy_(q.grad)
    return to_flax_params(g)


def _assert_trees_close(port_tree, jax_tree, rtol, atol):
    a = _flat(port_tree['params'])
    b = _flat(jax.tree.map(np.asarray, jax_tree)['params'])
    assert set(a) == set(b)
    for k in sorted(a):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _fixed_lp(jm, params, obs, actions, lp_noise):
    lp, _, _ = jax.jit(functools.partial(
        jm.apply, method='log_prob_entropy_value'))(
        params, _j(obs), jnp.asarray(actions))
    return np.asarray(lp) + lp_noise


def test_to_flax_params_inverts_load_flax_params(jax_model):
    _, params, tm = _models(jax_model)
    _assert_trees_close(to_flax_params(tm), params, 0, 0)


def test_policy_methods_match_jax(jax_model):
    obs, actions, *_ = _batch(seed=1)
    jm, params, tm = _models(jax_model)
    j_lp, j_ent, j_v = jax.jit(functools.partial(
        jm.apply, method='log_prob_entropy_value'))(
        params, _j(obs), jnp.asarray(actions))
    j_value = jax.jit(functools.partial(jm.apply, method='value'))(
        params, _j(obs))
    j_act = jax.jit(functools.partial(
        jm.apply, method='select_action', mean_action=True))(
        params, _j(obs), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        t_lp, t_ent, t_v = tm.log_prob_entropy_value(
            _t(obs), torch.as_tensor(actions))
        t_value = tm.value(_t(obs))
        t_act = tm.select_action(_t(obs), gen, mean_action=True)
        t_mixed = tm.select_action_mixed(_t(obs), gen,
                                         torch.ones(8, dtype=torch.bool))
    for t, j in ((t_lp, j_lp), (t_ent, j_ent), (t_v, j_v), (t_value, j_value)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    np.testing.assert_array_equal(t_mixed.numpy(), np.asarray(j_act))


def test_sampled_actions_respect_masks_and_stage(jax_model):
    obs = _obs(seed=2)
    _, _, tm = _models(jax_model)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        a = tm.select_action(_t(obs), gen).numpy()
    for b in range(8):
        in_lu, in_road = obs[8][b, 0] > 0.5, obs[8][b, 1] > 0.5
        assert obs[6][b, a[b, 0]] if in_lu else a[b, 0] == 0
        assert obs[7][b, a[b, 1]] if in_road else a[b, 1] == 0


def test_ppo_loss_and_grads_match_jax_grad(jax_model):
    obs, actions, returns, adv, exps, valid, lp_noise = _batch(seed=3)
    jm, params, tm = _models(jax_model)
    fixed = _fixed_lp(jm, params, obs, actions, lp_noise)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jppo.ppo_loss(jm, p, _j(obs), jnp.asarray(actions),
                                jnp.asarray(returns), jnp.asarray(adv),
                                jnp.asarray(fixed), jnp.asarray(exps), cfg_j,
                                jnp.asarray(valid)), has_aux=True))(params)
    t_loss, t_stats = tppo.ppo_loss(
        tm, _t(obs), *_t((actions, returns, adv, fixed, exps)), cfg_t,
        torch.as_tensor(valid))
    t_loss.backward()
    for k in tppo.STAT_KEYS:
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_trees_close(_grads_tree(tm), j_grads, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize('norm', ['below_clip', 'above_clip'])
def test_clip_by_global_norm_matches_optax(norm):
    import optax
    rng = np.random.default_rng(4)
    scale = 0.01 if norm == 'below_clip' else 10.0
    grads = [(scale * rng.normal(size=s)).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    j_out, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    t_grads = [torch.as_tensor(g.copy()) for g in grads]
    norm_t = tppo.clip_by_global_norm_(t_grads, 1.0)
    assert (float(norm_t) < 1.0) == (norm == 'below_clip')
    for t, j in zip(t_grads, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=0)


def test_ppo_update_step_matches_jax(jax_model):
    obs, actions, returns, adv, exps, valid, lp_noise = _batch(seed=5)
    jm, params, tm = _models(jax_model)
    fixed = _fixed_lp(jm, params, obs, actions, lp_noise)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    opt_j = jppo.make_optimizer(cfg_j)
    j_params, _, j_stats = jppo.ppo_update_step(
        jm, opt_j, cfg_j, params, opt_j.init(params), _j(obs),
        jnp.asarray(actions), jnp.asarray(returns), jnp.asarray(adv),
        jnp.asarray(fixed), jnp.asarray(exps), jnp.asarray(valid))
    opt_t = tppo.make_optimizer(tm.parameters(), cfg_t)
    t_stats = tppo.ppo_update_step(
        tm, opt_t, cfg_t, _t(obs), *_t((actions, returns, adv, fixed, exps)),
        torch.as_tensor(valid))
    for k in tppo.STAT_KEYS:
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_trees_close(to_flax_params(tm), j_params, 0, STEP_ATOL)


def test_ppo_update_epoch_matches_jax(jax_model):
    """Two epochs of 3 shuffled minibatches of 4 rows (6 Adam steps), from
    the same params and permutations."""
    obs, actions, returns, adv, exps, valid, lp_noise = _batch(B=12, seed=6)
    jm, params, tm = _models(jax_model)
    fixed = _fixed_lp(jm, params, obs, actions, lp_noise)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    opt_j = jppo.make_optimizer(cfg_j)
    opt_t = tppo.make_optimizer(tm.parameters(), cfg_t)
    j_state = opt_j.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        perm = rng.permutation(12)
        params, j_state, j_stats = jppo.ppo_update_epoch(
            jm, opt_j, cfg_j, params, j_state, _j(obs), jnp.asarray(actions),
            jnp.asarray(returns), jnp.asarray(adv), jnp.asarray(fixed),
            jnp.asarray(exps), jnp.asarray(perm), 3, 4, jnp.asarray(valid))
        t_stats = tppo.ppo_update_epoch(
            tm, opt_t, cfg_t, _t(obs),
            *_t((actions, returns, adv, fixed, exps)),
            torch.as_tensor(perm).split(4), torch.as_tensor(valid))
        for k in tppo.STAT_KEYS:
            np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    _assert_trees_close(to_flax_params(tm), params, 0, 6 * STEP_ATOL)


def test_fixed_log_probs_and_values_match_jax(jax_model):
    obs, actions, *_ = _batch(seed=7)
    jm, params, tm = _models(jax_model)
    j_lp, j_v = jppo.fixed_log_probs_and_values(jm, params, _j(obs),
                                                jnp.asarray(actions))
    t_lp, t_v = tppo.fixed_log_probs_and_values(tm, _t(obs),
                                                torch.as_tensor(actions))
    assert not t_lp.requires_grad
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), rtol=RTOL,
                               atol=ATOL)


def test_a2c_update_step_matches_jax(jax_model):
    from urban_tpu.rl import pg as jpg
    from urban_tpu_torch.rl import pg as tpg
    obs, actions, returns, adv, exps, _, _ = _batch(seed=8)
    jm, params, tm = _models(jax_model)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    opt_j = jppo.make_optimizer(cfg_j)
    j_params, _, j_stats = jpg.a2c_update_step(
        jm, opt_j, cfg_j, params, opt_j.init(params), _j(obs),
        jnp.asarray(actions), jnp.asarray(returns), jnp.asarray(adv),
        jnp.asarray(exps))
    opt_t = tppo.make_optimizer(tm.parameters(), cfg_t)
    t_stats = tpg.a2c_update_step(tm, opt_t, cfg_t, _t(obs),
                                  *_t((actions, returns, adv, exps)))
    for k in tppo.STAT_KEYS:
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    _assert_trees_close(to_flax_params(tm), j_params, 0, STEP_ATOL)


def test_adamw_with_weight_decay_matches_optax(jax_model):
    obs, actions, returns, adv, exps, valid, lp_noise = _batch(seed=9)
    jm, params, tm = _models(jax_model)
    fixed = _fixed_lp(jm, params, obs, actions, lp_noise)
    cfg_j = jppo.PPOConfig(weight_decay=0.1)
    cfg_t = tppo.PPOConfig(weight_decay=0.1)
    opt_j = jppo.make_optimizer(cfg_j)
    j_params, _, _ = jppo.ppo_update_step(
        jm, opt_j, cfg_j, params, opt_j.init(params), _j(obs),
        jnp.asarray(actions), jnp.asarray(returns), jnp.asarray(adv),
        jnp.asarray(fixed), jnp.asarray(exps), jnp.asarray(valid))
    opt_t = tppo.make_optimizer(tm.parameters(), cfg_t)
    assert isinstance(opt_t, torch.optim.AdamW)
    tppo.ppo_update_step(tm, opt_t, cfg_t, _t(obs),
                         *_t((actions, returns, adv, fixed, exps)),
                         torch.as_tensor(valid))
    _assert_trees_close(to_flax_params(tm), j_params, 0, STEP_ATOL)


# --------------------------------------------------------------------------
# advantages and weights on random (T, B) arrays
# --------------------------------------------------------------------------

def _episodes(T=12, B=5, seed=0):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.25
    failures = dones & (rng.random((T, B)) < 0.4)
    return rewards, values, dones, failures


@pytest.mark.parametrize('gamma,tau', [(1.0, 0.0), (0.99, 0.95), (1.0, 1.0)])
def test_batched_gae_matches_jax(gamma, tau):
    from urban_tpu.jaxenv.rollout import batched_gae as j_gae
    from urban_tpu_torch.torchenv.rollout import batched_gae
    rewards, values, dones, _ = _episodes(seed=1)
    j_adv, j_ret = j_gae(jnp.asarray(rewards), jnp.asarray(dones),
                         jnp.asarray(values), gamma, tau)
    t_adv, t_ret = batched_gae(*_t((rewards, dones, values)), gamma, tau)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('normalize', [False, True])
def test_estimate_advantages_matches_jax(normalize):
    from urban_tpu.rl.gae import estimate_advantages as j_est
    from urban_tpu_torch.rl.gae import estimate_advantages
    rng = np.random.default_rng(2)
    rewards = rng.normal(size=(20, 1)).astype(np.float32)
    values = rng.normal(size=(20, 1)).astype(np.float32)
    masks = (rng.random((20, 1)) > 0.2).astype(np.float32)
    j_adv, j_ret = j_est(jnp.asarray(rewards), jnp.asarray(masks),
                         jnp.asarray(values), 0.99, 0.95, normalize)
    t_adv, t_ret = estimate_advantages(*_t((rewards, masks, values)), 0.99,
                                       0.95, normalize)
    assert t_adv.shape == (20, 1)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=RTOL,
                               atol=ATOL)


def test_episode_success_weights_and_normalize_match_jax():
    from urban_tpu.jaxenv.rollout import episode_success_weights as j_esw
    from urban_tpu.jaxenv.rollout import normalize_advantages as j_norm
    from urban_tpu_torch.torchenv.rollout import (episode_success_weights,
                                                  normalize_advantages)
    rewards, _, dones, failures = _episodes(seed=3)
    j_w = j_esw(jnp.asarray(dones), jnp.asarray(failures))
    t_w = episode_success_weights(*_t((dones, failures)))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    assert 0 < float(t_w.sum()) < t_w.numel()
    j_n = j_norm(jnp.asarray(rewards), j_w)
    t_n = normalize_advantages(torch.as_tensor(rewards), t_w)
    np.testing.assert_allclose(t_n.numpy(), np.asarray(j_n), rtol=RTOL,
                               atol=ATOL)
