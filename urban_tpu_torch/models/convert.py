"""Convert between a Flax ActorCritic parameter tree and the port's
ActorCritic, in both directions.

The tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side). Flax ``Dense.kernel`` is (in, out) and becomes
``nn.Linear.weight`` transposed. Every leaf of the tree must map to one
parameter of the model and every parameter must be filled: a missing or
extra key raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from urban_tpu_torch.models.model import ActorCritic


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _linear_map(model: ActorCritic) -> Dict[str, torch.nn.Linear]:
    """Flax module path -> the torch Linear it becomes. The MLP encoder
    has only the numerical MLP and the node encoder."""
    sn = model.shared_net
    m = {}
    for i, layer in enumerate(sn.mlp.layers):
        m[f'shared_net/MLP_0/Dense_{i}'] = layer
    m['shared_net/node_encoder'] = sn.node_encoder
    if model.encoder == 'sgnn':
        for j, fc in enumerate(sn.edge_fc):
            for i, layer in enumerate(fc.layers):
                m[f'shared_net/edge_fc_{j}/Dense_{i}'] = layer
        att = sn.attention
        for i, layer in enumerate((att.q, att.k, att.v, att.out)):
            m[f'shared_net/attention/Dense_{i}'] = layer
    for head in ('land_use_head', 'road_head'):
        for i, layer in enumerate(getattr(model, head).layers):
            m[f'{head}/Dense_{i}'] = layer
    for i, layer in enumerate(model.value_mlp):
        m[f'value_mlp_{i}'] = layer
    return m


def to_flax_params(model: ActorCritic) -> Dict[str, Dict]:
    """The model's parameters as a Flax tree {'params': {...}} of numpy
    arrays (the inverse of load_flax_params)."""
    tree = {}
    for path, layer in _linear_map(model).items():
        node = tree
        for key in path.split('/'):
            node = node.setdefault(key, {})
        node['kernel'] = layer.weight.detach().cpu().numpy().T.copy()
        if layer.bias is not None:
            node['bias'] = layer.bias.detach().cpu().numpy().copy()
    return {'params': tree}


def load_flax_npz(model: ActorCritic, path) -> ActorCritic:
    """Fill ``model`` in place from an .npz of a Flax parameter tree
    flattened under its paths, and return it."""
    with np.load(path) as f:
        return load_flax_params(model, {k: f[k] for k in f.files})


def load_flax_params(model: ActorCritic, params: Mapping) -> ActorCritic:
    """Fill ``model`` in place from a Flax tree ({'params': {...}} or the
    inner dict), or from its leaves keyed by their '/'-joined paths (an
    .npz of the tree: 'params/shared_net/node_encoder/kernel', ...), and
    return it."""
    flat = {k.removeprefix('params/'): v for k, v in _flatten(params).items()}
    expected = {}
    for path, layer in _linear_map(model).items():
        expected[f'{path}/kernel'] = (layer.weight, True)
        if layer.bias is not None:
            expected[f'{path}/bias'] = (layer.bias, False)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f'parameter tree mismatch: missing {missing}, '
                       f'extra {extra}')
    with torch.no_grad():
        for path, (param, transpose) in expected.items():
            value = torch.tensor(np.array(flat[path]), dtype=param.dtype)
            if transpose:
                value = value.T
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f'{path}: shape {tuple(value.shape)} does '
                                 f'not fit {tuple(param.shape)}')
            param.copy_(value)
    return model
