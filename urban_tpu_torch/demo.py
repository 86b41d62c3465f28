"""Plan inspection demo (counterpart of demo/demo.py; reference:
demo/demo.ipynb).

Load a saved plan, re-score it with the host environment, and optionally
render it:

    python -m urban_tpu_torch.demo --cfg hlg --plan PATH [--render out.svg]
        [--road_weight W]

PATH is a GeoJSON plan (.geojson / .json), a checkpoint of the port's
trainer (torch.save; its best_plan_state is decoded with
torchenv.state.state_to_table), or a pickled GeoTable / {'gdf': ...}
payload (a list of them: the first). A pickle of the JAX package's trainer
holds JAX objects and cannot be read without jax: the demo refuses it.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import zipfile

# modules whose objects a pickle of the JAX package's trainer holds
_JAX_MODULES = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'urban_tpu')


class _HostUnpickler(pickle.Unpickler):
    """Unpickles a plan payload; refuses the JAX package's objects with a
    message that names the cause (they need jax to be rebuilt)."""

    def find_class(self, module, name):
        if module.split('.')[0] in _JAX_MODULES:
            raise SystemExit(
                f'the pickle holds {module}.{name}, an object of the JAX '
                'package (a JAX trainer checkpoint): it cannot be read '
                'without jax. Export its plan to GeoJSON with the JAX '
                'package (tools/export_best_plan.py) and pass that file')
        return super().find_class(module, name)


def load_plan_table(path: str):
    """The plan at `path` as a host GeoTable (see the module docstring for
    the formats)."""
    from urban_tpu_torch.host.io.geojson import load_geojson
    if path.endswith('.geojson') or path.endswith('.json'):
        return load_geojson(path)
    if zipfile.is_zipfile(path):
        import torch
        # the port's trainer checkpoint: numpy arrays and a host GeoTable,
        # so full unpickling (read only checkpoints the port wrote)
        payload = torch.load(path, map_location='cpu', weights_only=False)
    else:
        with open(path, 'rb') as f:
            payload = _HostUnpickler(f).load()
    if isinstance(payload, list):
        payload = payload[0]
    if isinstance(payload, dict) and 'best_plan_state' in payload:
        if payload['best_plan_state'] is None:
            raise SystemExit(
                'checkpoint holds no best plan (best_plan_state=None): no '
                'greedy eval episode succeeded before it was saved')
        from urban_tpu_torch.torchenv.state import state_to_table
        return state_to_table(payload['best_plan_state'])
    return payload['gdf'] if isinstance(payload, dict) else payload


def score_plan(cfg_id: str, table, road_weight: float = 1.0,
               verbose: bool = True, render: str = None):
    """Load `table` into scenario cfg_id's host env, its road-network
    reward weighted by road_weight (run directories under the temp
    directory), and score it; returns CityEnv.score_plan's (reward,
    info). With render, also draws the plan to that SVG path."""
    from urban_tpu_torch.host.envs.city import CityEnv
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.host.utils.io import load_yaml
    cfg_dict = load_yaml(f'urban_tpu/cfg/**/{cfg_id}.yaml')
    cfg_dict.setdefault('reward_specs', {})
    cfg_dict['reward_specs']['road_network_weight'] = road_weight
    env = CityEnv(Config(cfg_id, 0, cfg_dict=cfg_dict, root_dir=os.path.join(
        tempfile.gettempdir(), 'urban_tpu_torch')))
    env.load_plan(table)
    out = env.score_plan(verbose=verbose)
    if render:
        env.visualize(save_fig=True, path=render, legend=True)
        print(f'rendered to {render}')
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--cfg', required=True)
    p.add_argument('--plan', required=True,
                   help='GeoJSON plan, trainer checkpoint or pickled plan '
                   'payload')
    p.add_argument('--render', default=None, help='SVG output path')
    p.add_argument('--road_weight', type=float, default=1.0,
                   help='road-network weight when scoring')
    args = p.parse_args(argv)
    score_plan(args.cfg, load_plan_table(args.plan), args.road_weight,
               render=args.render)


if __name__ == '__main__':
    main()
