"""The port's SGNN with ``encoder_operands='bf16'`` against the JAX
encoder's default backend (SCATTER_MODE 'matmul': node features rounded
to bf16 before the endpoint gather, edge features rounded to bf16 before
the segment mean, both summed in f32), beside the port's default f32
encoder, on the CPU.

Inputs: the HLG trainer's caps (N = 1344 nodes, E = 3000 edge slots), the
JAX trainer's initial parameters at seed 111
(results/hlg_jax_init_seed111.npz), and 16 real observations: a 2-env x
8-step rollout of the port from HLG's initial state. Measured (this
test, printed with -s), the f32 port / the bf16 option against JAX's
default:
- land-use logits (where legal): mean |diff| 4.8e-4 / 8.1e-8, max 1.8e-3
  / 3.3e-7, 7.4% / 0% of them off by more than 1e-3;
- log-probs of the sampled actions: max 1.1e-3 / 4.8e-7;
- value: max 5.1e-5 / 4.3e-7;
- the PPO loss's gradient: norm 0.39916 / 0.39963 against JAX's 0.39961;
  the norm of the difference 0.30% / 0.15% of JAX's norm.
The option's residual gradient gap sits in the first layers (the node
encoder and the first edge MLP), whose gradients pass the bf16 rounding:
JAX rounds each endpoint's cotangent to bf16 and adds the two in bf16,
the port adds them in f32 and rounds once (one flat gather), so rounding
flips differ there.

Bounds: the option's mean logit gap at least 10x under the f32 port's;
its largest logit, log-prob and value gaps under 1e-5 (f32 noise), with
at most 0.1% of the logits above that (a rare bf16 rounding flip moves a
logit by ~1e-3); its gradient closer to JAX's than the f32 port's, within
2.5e-3 of JAX's norm. With the option off the port computes what it
computed before (the other tests hold that, bit for bit).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import unflatten_dict

from urban_tpu.models import encoder as jenc
from urban_tpu.models.model import create_model as jax_create
from urban_tpu.rl import ppo as jppo
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.models.convert import load_flax_npz, to_flax_params
from urban_tpu_torch.models.model import create_model
from urban_tpu_torch.models.policy import categorical_log_prob
from urban_tpu_torch.rl import ppo as tppo
from urban_tpu_torch.rl.trainer import Trainer
from urban_tpu_torch.torchenv.rollout import rollout

torch.set_num_threads(1)

INIT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'results', 'hlg_jax_init_seed111.npz')
F32_NOISE = 1e-5


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v, np.float64)})
    return out


@pytest.fixture(scope='module')
def gaps(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jenc, 'SCATTER_MODE', 'matmul')
        jax.clear_caches()
        yield _gaps(str(tmp_path_factory.mktemp('operands')))
    jax.clear_caches()


def _gaps(root):
    tt = Trainer(Config('hlg', 111, root_dir=root), num_envs=2,
                 rollout_len=8, eval_envs=1, device='cpu')
    assert (tt.spec.num_features, tt.spec.NE) == (1344, 3000)
    load_flax_npz(tt.model, INIT)
    _, traj = rollout(tt.spec, tt.model, tt.init_state, tt.env_states,
                      torch.Generator().manual_seed(0), 8)
    obs = tuple(o.reshape((-1,) + o.shape[2:]) for o in traj.obs)
    actions = traj.actions.reshape(-1, 2)
    n = actions.shape[0]
    legal = obs[6].numpy()

    params = unflatten_dict(dict(np.load(INIT)), sep='/')
    jm = jax_create(tt.cfg, 'sgnn')
    j_obs = tuple(jnp.asarray(o.numpy()) for o in obs)
    j_lu, _, _, j_value = map(np.array, jax.jit(jm.apply)(params, j_obs))
    j_lp = categorical_log_prob(torch.as_tensor(j_lu), actions[:, 0]).numpy()

    rng = np.random.default_rng(0)
    returns, adv = (rng.normal(size=(n, 1)).astype(np.float32)
                    for _ in range(2))
    ones = np.ones(n, np.float32)
    fixed = j_lp[:, None] + 0.01 * rng.normal(size=(n, 1)).astype(
        np.float32)
    (_, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jppo.ppo_loss(jm, p, j_obs, jnp.asarray(actions.numpy()),
                                jnp.asarray(returns), jnp.asarray(adv),
                                jnp.asarray(fixed), jnp.asarray(ones),
                                jppo.PPOConfig(), jnp.asarray(ones)),
        has_aux=True))(params)
    j_grads = _flat(jax.tree.map(np.asarray, j_grads))
    j_norm = np.sqrt(sum((g ** 2).sum() for g in j_grads.values()))

    out = {}
    for operands in ('f32', 'bf16'):
        model = load_flax_npz(create_model(tt.cfg,
                                           encoder_operands=operands), INIT)
        with torch.no_grad():
            lu, _, _, value = model(obs)
        d = np.abs(lu.numpy()[legal] - j_lu[legal])
        lp = categorical_log_prob(lu, actions[:, 0]).numpy()
        loss, _ = tppo.ppo_loss(model, obs, actions, *(
            torch.as_tensor(x) for x in (returns, adv, fixed, ones)),
            tppo.PPOConfig(), torch.as_tensor(ones))
        loss.backward()
        grads = create_model(tt.cfg)
        with torch.no_grad():
            for p, q in zip(grads.parameters(), model.parameters()):
                p.copy_(q.grad)
        grads = _flat(to_flax_params(grads))
        assert set(grads) == set(j_grads)
        out[operands] = {
            'logit_mean': d.mean(), 'logit_max': d.max(),
            'logit_over_noise': (d > F32_NOISE).mean(),
            'logit_over_1e-3': (d > 1e-3).mean(),
            'log_prob_max': np.abs(lp - j_lp).max(),
            'value_max': np.abs(value.numpy() - j_value).max(),
            'grad_norm': np.sqrt(sum((g ** 2).sum()
                                     for g in grads.values())),
            'grad_diff': np.sqrt(sum(((grads[k] - j_grads[k]) ** 2).sum()
                                     for k in grads)) / j_norm}
    out['jax_grad_norm'] = j_norm
    print(out)
    return out


def test_bf16_operands_logits_and_value_match_jax_default(gaps):
    f32, bf16 = gaps['f32'], gaps['bf16']
    assert bf16['logit_mean'] * 10 <= f32['logit_mean']
    assert bf16['logit_over_noise'] <= 1e-3
    for k in ('logit_max', 'log_prob_max', 'value_max'):
        assert bf16[k] < F32_NOISE, (k, bf16[k])
    # the f32 port's gap is the bf16 operands' size, not noise
    assert f32['logit_over_1e-3'] > 0.01 and f32['log_prob_max'] > 1e-4


def test_bf16_operands_gradient_is_closer_to_jax_default(gaps):
    f32, bf16 = gaps['f32'], gaps['bf16']
    assert bf16['grad_diff'] < f32['grad_diff']
    assert bf16['grad_diff'] < 2.5e-3
    np.testing.assert_allclose(bf16['grad_norm'], gaps['jax_grad_norm'],
                               rtol=1e-4)
