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
