"""The port's PPO trainer update (urban_tpu_torch.rl.trainer.Trainer.update)
against the JAX trainer's (urban_tpu.rl.train_tpu.TPUTrainer.update): the
same small HLG trajectory (2 envs x 4 steps, collected by the port on the
CPU at the trainer's own capacities, N = 1344 nodes, E = 3000 edges), the
same success weights and the same parameters (the JAX trainer's initial
parameters, converted). Both then take the same minibatches: the
permutation of each epoch comes from np.random.default_rng(seed +
iteration).

The JAX encoder runs its 'scatter' backend (f32, the port's semantics).
Tolerances: loss stats rtol = atol = 1e-4 (f32 sums over the graph, taken
in another order); V_mc_rms 1e-5; parameters after the 4 epochs (4 Adam
steps of one 8-row minibatch) 4 x 4e-5: each Adam step turns a gradient
difference dg into a parameter difference of at most lr * dg / eps =
40 * dg, and dg stays below 1e-6 here (tests/test_torch_ppo.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.jaxenv.rollout import Trajectory as JaxTrajectory
from urban_tpu.models import encoder as jenc
from urban_tpu.rl.train_tpu import TPUTrainer
from urban_tpu.utils.config import Config
from urban_tpu_torch.host.utils.config import Config as TorchConfig
from urban_tpu_torch.models.convert import load_flax_params, to_flax_params
from urban_tpu_torch.rl.trainer import Trainer
from urban_tpu_torch.torchenv.rollout import rollout

torch.set_num_threads(1)

STEPS = 4


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def test_trainer_update_matches_tpu_trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(jenc, 'SCATTER_MODE', 'scatter')
    jt = TPUTrainer(Config('hlg', 0, root_dir=str(tmp_path / 'jax')),
                    num_envs=2, rollout_len=STEPS, eval_envs=2)
    tt = Trainer(TorchConfig('hlg', 0, root_dir=str(tmp_path / 'torch')),
                 num_envs=2, rollout_len=STEPS, eval_envs=2, device='cpu')
    assert (tt.spec.num_features, tt.spec.NE) == (jt.spec.num_features,
                                                   jt.spec.NE) == (1344, 3000)
    load_flax_params(tt.model, jax.tree.map(np.asarray, jt.params))
    init = _flat(jax.tree.map(np.asarray, jt.params)['params'])

    gen = torch.Generator().manual_seed(5)
    _, traj = rollout(tt.spec, tt.model, tt.init_state, tt.env_states, gen,
                      STEPS, noise_rate=0.5)
    assert 0 < float(traj.exps.sum()) < traj.exps.numel()
    rng = np.random.default_rng(1)
    weights = (rng.random((STEPS, 2)) < 0.75).astype(np.float32)
    weights[0] = 1.0
    j_traj = JaxTrajectory(*(
        tuple(jnp.asarray(o.numpy()) for o in x) if isinstance(x, tuple)
        else jnp.asarray(x.numpy()) for x in traj[:8]))

    j_stats = jt.update(j_traj, 0, weights=jnp.asarray(weights))
    t_stats = tt.update(traj, 0, weights=torch.as_tensor(weights))

    for k, v in t_stats.items():
        np.testing.assert_allclose(float(v), float(j_stats[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert float(t_stats['value_loss']) > 0
    np.testing.assert_allclose(tt.last_value_mc_rms, jt.last_value_mc_rms,
                               rtol=1e-5, atol=1e-5)
    a = _flat(to_flax_params(tt.model)['params'])
    b = _flat(jax.tree.map(np.asarray, jt.params)['params'])
    assert set(a) == set(b)
    for k in sorted(a):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=4 * 4e-5,
                                   err_msg=k)
    # the update moved the parameters by Adam steps of about lr each
    assert max(np.abs(b[k] - init[k]).max() for k in b) > 1e-3


@pytest.mark.parametrize('option,value', [('separate_train', True),
                                          ('num_devices', 4)])
def test_run_training_refuses_what_is_not_ported(option, value, tmp_path):
    from urban_tpu_torch.rl.trainer import run_training
    cfg = TorchConfig('hlg', 0, root_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        run_training(cfg, 1, 2, device='cpu', **{option: value})
