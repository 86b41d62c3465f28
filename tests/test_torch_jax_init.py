"""results/hlg_jax_init_seed111.npz: the JAX trainer's initial parameters
for the HLG learning-parity recipe (TPUTrainer on hlg at seed 111, the
trainer's caps N = 1344, E = 3000), flattened to numpy under the Flax
tree's paths ('params/shared_net/node_encoder/kernel', ...). The port's
parity tool starts a run from it (``--init_params``), since the card's
machine has no JAX. The file must equal a fresh TPUTrainer's params, and
the port's model must take it whole (no key missing or extra).

Write it again with

    JAX_PLATFORMS=cpu python tests/test_torch_jax_init.py
"""
import os
import sys
import tempfile

import numpy as np
import jax
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from urban_tpu.rl.train_tpu import TPUTrainer                # noqa: E402
from urban_tpu.utils.config import Config                    # noqa: E402
from urban_tpu_torch.host.utils.config import Config as TorchConfig  # noqa
from urban_tpu_torch.models.convert import (load_flax_npz,   # noqa: E402
                                            to_flax_params)
from urban_tpu_torch.rl.trainer import Trainer               # noqa: E402

torch.set_num_threads(1)

SEED = 111
PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'results', f'hlg_jax_init_seed{SEED}.npz')


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def jax_init_params(root_dir) -> dict:
    """TPUTrainer(hlg, seed 111).params, flattened under their paths."""
    jt = TPUTrainer(Config('hlg', SEED, root_dir=str(root_dir)),
                    num_envs=2, eval_envs=1)
    return _flat(jax.tree.map(np.asarray, jt.params))


def _saved():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


def test_file_equals_a_fresh_tpu_trainer_init(tmp_path):
    fresh, saved = jax_init_params(tmp_path), _saved()
    assert set(saved) == set(fresh)
    assert all(k.startswith('params/') for k in saved)
    for k in fresh:
        assert saved[k].dtype == fresh[k].dtype == np.float32, k
        np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_port_model_takes_the_file_whole(tmp_path):
    """load_flax_params raises on a missing or an extra key; every
    parameter of the port's trainer model comes from the file."""
    tt = Trainer(TorchConfig('hlg', SEED, root_dir=str(tmp_path)),
                 num_envs=2, eval_envs=1, device='cpu')
    assert (tt.spec.num_features, tt.spec.NE) == (1344, 3000)
    load_flax_npz(tt.model, PATH)
    back = _flat(to_flax_params(tt.model))
    saved = _saved()
    assert set(back) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(back[k], saved[k], err_msg=k)


if __name__ == '__main__':
    with tempfile.TemporaryDirectory() as d:
        np.savez(PATH, **jax_init_params(d))
    print(PATH)
