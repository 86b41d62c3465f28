"""The port's SGNN actor-critic (urban_tpu_torch.models) against the JAX
ActorCritic with the same parameters, loaded through load_flax_params.

At a small size the JAX encoder aggregates through the Pallas kernel in
interpret mode (SCATTER_MODE='pallas', f32 on both sides: atol = rtol =
1e-5). At HLG widths it is compared with the JAX default 'matmul' backend,
whose bf16 operands need the 2e-2 of tests/test_pallas_ops.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.models import encoder as jenc
from urban_tpu.models.model import ActorCritic as JaxActorCritic
from urban_tpu.ops.pallas import segment_ops as jseg
from urban_tpu_torch.models.convert import load_flax_params
from urban_tpu_torch.models.model import ActorCritic, NODE_DIM, NUMERICAL_DIM
from urban_tpu_torch.models.policy import MASK_PAD
from urban_tpu_torch.torchenv import geometry as tg

torch.set_num_threads(1)

SMALL = dict(hidden_size=(16, 8), gcn_node_dim=8, num_gcn_layers=2,
             num_edge_fc_layers=1, num_attention_heads=1, max_num_nodes=40,
             max_num_edges=96, land_use_hidden=(16, 1), road_hidden=(16, 1),
             value_hidden=(16, 16, 1))


@pytest.fixture
def pallas_mode(monkeypatch):
    """JAX encoder through the Pallas kernel, interpreted on the CPU."""
    orig = jseg.segment_mean_onehot_pallas
    monkeypatch.setattr(jseg, 'segment_mean_onehot_pallas',
                        lambda *a, **k: orig(*a, **{**k, 'interpret': True}))
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'pallas')


def _small_obs(B=3, seed=0):
    rng = np.random.default_rng(seed)
    N, E = SMALL['max_num_nodes'], SMALL['max_num_edges']
    e0 = rng.integers(0, N // 2, size=(B, E, 1))
    e1 = rng.integers(N // 2, N, size=(B, E, 1))
    edge_mask = rng.random((B, E)) < 0.8
    stage = np.zeros((B, 3), np.float32)
    stage[np.arange(B), rng.integers(0, 2, B)] = 1.0
    return (rng.normal(size=(B, NUMERICAL_DIM)).astype(np.float32),
            rng.normal(size=(B, N, NODE_DIM)).astype(np.float32),
            np.concatenate([e0, e1], -1).astype(np.int32),
            rng.normal(size=(B, NODE_DIM)).astype(np.float32),
            rng.random((B, N)) < 0.9,
            edge_mask,
            edge_mask & (rng.random((B, E)) < 0.5),
            rng.random((B, N)) < 0.3,
            stage)


def _models(widths, obs, seed=0):
    jm = JaxActorCritic(encoder='sgnn', **widths)
    params = jm.init(jax.random.PRNGKey(seed),
                     tuple(jnp.asarray(x) for x in obs))
    tm = ActorCritic(**widths)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm.eval()


def _t(obs):
    return tuple(torch.as_tensor(np.array(x)) for x in obs)


def test_small_forward_matches_jax_pallas(pallas_mode):
    obs = _small_obs()
    jm, params, tm = _models(SMALL, obs)
    jobs = tuple(jnp.asarray(x) for x in obs)
    j_enc = jm.apply(params, jobs, method=lambda m, o: m.shared_net(o))
    j_out = jm.apply(params, jobs)
    with torch.no_grad():
        t_enc = tm.shared_net(_t(obs))
        t_out = tm(_t(obs))
    for k in range(3):          # land-use state, road state, value state
        np.testing.assert_allclose(t_enc[k].numpy(), np.asarray(j_enc[k]),
                                   rtol=1e-5, atol=1e-5)
    for k in (0, 1, 3):         # land-use logits, road logits, value
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-5, atol=1e-5)
    lu_mask, rd_mask = obs[6], obs[7]
    assert np.all(t_out[0].numpy()[~lu_mask] == MASK_PAD)
    assert np.all(t_out[1].numpy()[~rd_mask] == MASK_PAD)


def test_use_mean_picks_jax_argmax(pallas_mode):
    obs = _small_obs(B=4, seed=3)
    jm, params, tm = _models(SMALL, obs, seed=1)
    B = obs[0].shape[0]
    ja, jlp, jv = jm.apply(params, tuple(jnp.asarray(x) for x in obs),
                           jax.random.PRNGKey(0), jnp.ones(B, bool),
                           method='sample_action_logp_value')
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        ta, tlp, tv = tm.sample_action_logp_value(
            _t(obs), gen, torch.ones(B, dtype=torch.bool))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_categorical_helpers_match_jax():
    """masked_logits, categorical_log_prob and categorical_entropy against
    the JAX policy module's, on logits with masked entries (f32 both sides:
    atol = rtol = 1e-5)."""
    from urban_tpu.models import policy as jpol
    from urban_tpu_torch.models import policy as tpol
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 33)).astype(np.float32)
    mask = rng.random((5, 33)) < 0.4
    mask[:, 0] = True
    action = np.array([int(rng.choice(np.nonzero(m)[0])) for m in mask],
                      np.int32)
    jl = jpol.masked_logits(jnp.asarray(logits), jnp.asarray(mask))
    tl = tpol.masked_logits(torch.as_tensor(logits), torch.as_tensor(mask))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(
        tpol.categorical_log_prob(tl, torch.as_tensor(action)).numpy(),
        np.asarray(jpol.categorical_log_prob(jl, jnp.asarray(action))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpol.categorical_entropy(tl).numpy(),
                               np.asarray(jpol.categorical_entropy(jl)),
                               rtol=1e-5, atol=1e-5)


def test_sampling_respects_masks():
    obs = _small_obs(B=4, seed=4)
    _, _, tm = _models(SMALL, obs, seed=2)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        a, lp, _ = tm.sample_action_logp_value(
            _t(obs), gen, torch.zeros(4, dtype=torch.bool))
    for b in range(4):
        if obs[8][b, 0] > 0.5:
            assert obs[6][b, a[b, 0]]
        if obs[8][b, 1] > 0.5:
            assert obs[7][b, a[b, 1]]
    assert torch.isfinite(lp).all()


def test_hlg_widths_on_initial_observation():
    """HLG widths on the HLG initial observation (N=1088 nodes, E=2304
    edge slots) vs the JAX default matmul backend (bf16 operands)."""
    from urban_tpu.envs.plan_client import PlanClient
    from urban_tpu.jaxenv.state import build_env_spec, build_initial_state
    from urban_tpu.jaxenv.step import build_obs
    from urban_tpu.models.model import create_model as jax_create
    from urban_tpu_torch.bench import BENCH_CAPS, load_config
    from urban_tpu_torch.models.model import create_model

    cfg = load_config('hlg')
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length,
                          caps=BENCH_CAPS)
    obs = jax.tree.map(lambda x: np.asarray(x)[None],
                       build_obs(spec, build_initial_state(spec, plc)))
    cfg.state_encoder_specs = dict(cfg.state_encoder_specs,
                                   max_num_nodes=spec.num_features,
                                   max_num_edges=spec.NE)
    jm = jax_create(cfg, 'sgnn')
    params = jm.init(jax.random.PRNGKey(0),
                     tuple(jnp.asarray(x) for x in obs))
    tm = load_flax_params(create_model(cfg), jax.tree.map(np.asarray,
                                                          params)).eval()
    assert tm.shared_net.max_num_nodes == 1088
    j_out = jm.apply(params, tuple(jnp.asarray(x) for x in obs))
    with torch.no_grad():
        t_out = tm(_t(obs))
    lu = obs[6]
    assert lu.any()
    np.testing.assert_allclose(t_out[0].numpy()[lu], np.asarray(j_out[0])[lu],
                               atol=2e-2)
    np.testing.assert_allclose(t_out[3].numpy(), np.asarray(j_out[3]),
                               atol=2e-2)
    assert np.all(t_out[0].numpy()[~lu] == MASK_PAD)


def test_load_flax_params_rejects_missing_and_extra_keys():
    obs = _small_obs()
    _, params, _ = _models(SMALL, obs)
    tree = jax.tree.map(np.asarray, params)
    missing = {'params': {k: v for k, v in tree['params'].items()
                          if k != 'road_head'}}
    with pytest.raises(KeyError):
        load_flax_params(ActorCritic(**SMALL), missing)
    extra = {'params': {**tree['params'],
                        'spare': {'kernel': np.zeros((2, 2), np.float32)}}}
    with pytest.raises(KeyError):
        load_flax_params(ActorCritic(**SMALL), extra)


def test_compensated_cross_near_parallel():
    """Dekker/TwoSum cross of two nearly parallel f32 vectors: the result
    carries the error of one rounding of the exact value, where the plain
    f32 formula loses most of its digits to cancellation; and it equals the
    JAX package's compensated cross bit for bit."""
    from urban_tpu.jaxenv import geometry as jgeo
    rng = np.random.default_rng(0)
    ux = rng.uniform(500, 2000, 64).astype(np.float32)
    uy = rng.uniform(500, 2000, 64).astype(np.float32)
    s = (1 + rng.uniform(-3e-7, 3e-7, 64)).astype(np.float32)
    vx = (ux * s).astype(np.float32)
    vy = uy
    exact = ux.astype(np.float64) * vy - uy.astype(np.float64) * vx
    comp = tg.cross2_compensated(*(torch.as_tensor(a)
                                   for a in (ux, uy, vx, vy))).numpy()
    plain = ux * vy - uy * vx
    ulp = np.spacing(np.abs(exact).astype(np.float32))
    assert np.all(np.abs(comp - exact) <= ulp)
    assert np.max(np.abs(plain - exact) / np.maximum(ulp, 1e-30)) > 100
    jcomp = np.asarray(jax.jit(jgeo.cross2_compensated)(ux, uy, vx, vy))
    np.testing.assert_array_equal(comp, jcomp)


# ---- the MLP encoder (the ablation without message passing) -----------

def _mlp_obs(B=6, seed=7):
    """_small_obs with one-hot land-use columns, a third of them FEASIBLE,
    and all-zero rows for dead nodes (an argmax tie, which picks index 0):
    the edge features then come from either endpoint."""
    from urban_tpu_torch.host import city_config
    obs = list(_small_obs(B, seed))
    rng = np.random.default_rng(seed + 1)
    k = city_config.NUM_TYPES + 1
    N = SMALL['max_num_nodes']
    types = np.where(rng.random((B, N)) < 0.33, city_config.FEASIBLE,
                     rng.integers(0, k, (B, N)))
    onehot = np.eye(k, dtype=np.float32)[types]
    onehot[rng.random((B, N)) < 0.1] = 0.0
    obs[1] = obs[1].copy()
    obs[1][..., :k] = onehot
    return tuple(obs)


def _mlp_models(obs, seed=0):
    jm = JaxActorCritic(encoder='mlp', **SMALL)
    params = jm.init(jax.random.PRNGKey(seed),
                     tuple(jnp.asarray(x) for x in obs))
    tm = ActorCritic(**SMALL, encoder='mlp')
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def test_mlp_encoder_forward_matches_flax():
    """Logits, value and the encoder's outputs against the Flax MLP
    encoder (f32 both sides, no aggregation: atol = rtol = 1e-5)."""
    obs = _mlp_obs()
    jm, params, tm = _mlp_models(obs)
    jobs = tuple(jnp.asarray(x) for x in obs)
    j_enc = jm.apply(params, jobs, method=lambda m, o: m.shared_net(o))
    j_out = jm.apply(params, jobs)
    with torch.no_grad():
        t_enc = tm.shared_net(_t(obs))
        t_out = tm(_t(obs))
    for k in range(3):
        np.testing.assert_allclose(t_enc[k].numpy(), np.asarray(j_enc[k]),
                                   rtol=1e-5, atol=1e-5)
    for k in (0, 1, 3):
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=1e-5, atol=1e-5)
    assert tm.num_gcn_layers == 0 and not hasattr(tm.shared_net, 'edge_fc')


def test_mlp_encoder_ppo_gradients_match_flax():
    """One PPO loss and its parameter gradients against jax.value_and_grad
    of the JAX loss on the same parameters (the tolerances of
    tests/test_torch_ppo.py: values 1e-5, gradients atol 1e-5 + rtol
    1e-4)."""
    from urban_tpu.rl import ppo as jppo
    from urban_tpu_torch.models.convert import to_flax_params
    from urban_tpu_torch.rl import ppo as tppo
    obs = _mlp_obs(B=8, seed=9)
    jm, params, tm = _mlp_models(obs, seed=2)
    rng = np.random.default_rng(10)
    actions = np.stack([
        np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                  for m in obs[6]]),
        np.array([rng.choice(np.flatnonzero(m)) if m.any() else 0
                  for m in obs[7]])], -1).astype(np.int32)
    returns, adv, noise = (rng.normal(size=(8, 1)).astype(np.float32)
                           for _ in range(3))
    exps = (rng.random(8) < 0.7).astype(np.float32)
    valid = (rng.random(8) < 0.8).astype(np.float32)
    jobs = tuple(jnp.asarray(x) for x in obs)
    lp, _, _ = jm.apply(params, jobs, jnp.asarray(actions),
                        method='log_prob_entropy_value')
    fixed = np.asarray(lp) + 0.3 * noise
    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jppo.ppo_loss(jm, p, jobs, *(jnp.asarray(x) for x in (
            actions, returns, adv, fixed, exps)), jppo.PPOConfig(),
            jnp.asarray(valid)), has_aux=True))(params)
    t_loss, t_stats = tppo.ppo_loss(
        tm, _t(obs), *_t((actions, returns, adv, fixed, exps)),
        tppo.PPOConfig(), torch.as_tensor(valid))
    t_loss.backward()
    for k in tppo.STAT_KEYS:
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    g = ActorCritic(**SMALL, encoder='mlp')
    with torch.no_grad():
        for p, q in zip(g.parameters(), tm.parameters()):
            p.copy_(q.grad)
    a = jax.tree_util.tree_flatten_with_path(to_flax_params(g))[0]
    b = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, j_grads))[0])
    assert {k for k, _ in a} == set(b)
    for k, v in a:
        np.testing.assert_allclose(v, b[k], rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(k))
    assert max(float(np.abs(v).max()) for _, v in a) > 1e-3


def test_load_flax_params_rejects_a_wrong_mlp_tree():
    obs = _mlp_obs()
    _, params, _ = _mlp_models(obs)
    tree = jax.tree.map(np.asarray, params)['params']
    shared = dict(tree['shared_net'])
    del shared['node_encoder']
    with pytest.raises(KeyError):
        load_flax_params(ActorCritic(**SMALL, encoder='mlp'),
                         {'params': {**tree, 'shared_net': shared}})
    # the SGNN's tree has edge_fc_* and attention, which the MLP lacks
    _, sgnn_params, _ = _models(SMALL, obs)
    with pytest.raises(KeyError):
        load_flax_params(ActorCritic(**SMALL, encoder='mlp'),
                         jax.tree.map(np.asarray, sgnn_params))
    with pytest.raises(KeyError):
        load_flax_params(ActorCritic(**SMALL), {'params': tree})
