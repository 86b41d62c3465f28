"""The port's plan-scoring demo (urban_tpu_torch/demo.py) against the JAX
package's demo/demo.py steps, on the published GeoJSON plans; and the
plans it reads out of the port's trainer checkpoints."""
import os
import pickle

import numpy as np
import pytest
import torch

from urban_tpu.envs.city import CityEnv
from urban_tpu.io.geojson import load_geojson
from urban_tpu.utils.config import Config
from urban_tpu.utils.io import load_yaml
from urban_tpu_torch import demo
from urban_tpu_torch.host.utils.config import Config as TConfig
from urban_tpu_torch.rl.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_demo_score(cfg_id, path, road_weight):
    """demo/demo.py's steps: the config with the road weight set, a
    CityEnv, load_plan, score_plan."""
    cfg_dict = load_yaml(f'urban_tpu/cfg/**/{cfg_id}.yaml')
    cfg_dict.setdefault('reward_specs', {})
    cfg_dict['reward_specs']['road_network_weight'] = road_weight
    env = CityEnv(Config(cfg_id, 0, tmp=True, cfg_dict=cfg_dict))
    env.load_plan(load_geojson(path))
    return env.score_plan(verbose=False)


@pytest.mark.parametrize('cfg_id,road_weight,plan', [
    pytest.param('hlg', 1.0, 'hlg_rl_tpu', id='hlg-1.0'),
    pytest.param('hlg', 0.0, 'hlg_rl_tpu', id='hlg-0.0'),
    pytest.param('grid', 1.0, 'grid_rl_tpu', id='grid-1.0'),
    # JAX's round-5 MLP ablation plan (the port's MLP gate's reference),
    # and the plans the port trained on the card
    pytest.param('hlg', 0.0, 'hlg_mlp_rl_tpu', id='hlg_mlp_rl_tpu'),
    pytest.param('hlg', 0.0, 'hlg_rl_torch', id='hlg_rl_torch'),
    pytest.param('huizhou', 0.0, 'huizhou_rl_torch', id='huizhou_rl_torch'),
    pytest.param('hlg', 0.0, 'hlg_mlp_rl_torch', id='hlg_mlp_rl_torch'),
    pytest.param('hlg', 0.0, 'hlg_sgnn_r5_rl_torch',
                 id='hlg_sgnn_r5_rl_torch'),
    # the planning-concept plans, JAX's and the port's, scored with their
    # concept term (weight 3)
    pytest.param('hlg_concept', 0.0, 'hlg_concept_rl_tpu',
                 id='hlg_concept_rl_tpu'),
    pytest.param('hlg_concept', 0.0, 'hlg_concept_rl_torch',
                 id='hlg_concept_rl_torch'),
    # DHM (land use only): JAX's plan and the port's
    pytest.param('dhm', 0.0, 'dhm_rl_tpu', id='dhm_rl_tpu'),
    pytest.param('dhm', 0.0, 'dhm_rl_torch', id='dhm_rl_torch')])
def test_score_matches_jax_demo(cfg_id, road_weight, plan):
    path = os.path.join(REPO, 'results', f'{plan}.geojson')
    want = jax_demo_score(cfg_id, path, road_weight)
    got = demo.score_plan(cfg_id, demo.load_plan_table(path), road_weight,
                          verbose=False)
    assert got == want   # the reward and every channel of info, exactly


@pytest.mark.parametrize('plan', ['hlg_concept_rl_tpu',
                                  'hlg_concept_rl_torch'])
def test_concept_term_matches_jax_host_scorer(plan):
    """The concept term the port's export tool prints
    (export_best_plan.concept_term) of a committed hlg_concept plan is JAX's
    host scorer's, exactly, and with the score's channels it adds up to the
    reward under the scenario's weights (life circle 4, greenness 1,
    concept 3)."""
    from urban_tpu_torch.tools.export_best_plan import concept_term
    path = os.path.join(REPO, 'results', f'{plan}.geojson')
    env = CityEnv(Config('hlg_concept', 0, tmp=True))
    env.load_plan(load_geojson(path))
    want = env._plc.get_concept_reward()[0]
    table = demo.load_plan_table(path)
    got = concept_term(TConfig('hlg_concept', 0, tmp=True), table)
    assert got == want and 0 < got <= 1
    reward, info = demo.score_plan('hlg_concept', table, 0.0, verbose=False)
    assert reward == pytest.approx(4 * info['life_circle']
                                   + info['greenness'] + 3 * got, abs=1e-12)


def assert_same_table(a, b):
    for k in ('ids', 'types', 'existence', 'rect', 'eqi', 'sc'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert len(a.geoms) == len(b.geoms)
    for ga, gb in zip(a.geoms, b.geoms):
        assert ga.kind == gb.kind
        np.testing.assert_array_equal(ga.coords, gb.coords)


@pytest.fixture(scope='module')
def tr(tmp_path_factory):
    """A tiny HLG trainer on the CPU after one train_iteration: 35 steps
    hold a land-use episode (~29 steps). Seed 1, not 0, for coverage: its
    greedy eval episode succeeds (seed 0's fails), so the trainer has a
    best plan to checkpoint."""
    root = str(tmp_path_factory.mktemp('demo_trainer'))
    tr = Trainer(TConfig('hlg', 1, root_dir=root), num_envs=2,
                 rollout_len=35, eval_envs=1, device='cpu')
    tr.save_checkpoint(0, tag='before_eval')
    tr.train_iteration(0)
    tr.save_checkpoint(0)
    return tr


def test_checkpoint_plan_is_the_trainers_best_plan(tr):
    assert tr.best_plan_state is not None
    for name in ('iteration_0000.pt', 'best.pt'):
        table = demo.load_plan_table(os.path.join(tr.cfg.model_dir, name))
        assert_same_table(table, tr.best_plan_table())
    reward, info = demo.score_plan('hlg', table, verbose=False)
    assert np.isfinite(reward) and set(info) >= {'life_circle', 'greenness'}


def test_checkpoint_without_best_plan_is_refused(tr):
    path = os.path.join(tr.cfg.model_dir, 'before_eval.pt')
    with pytest.raises(SystemExit) as exc:
        demo.load_plan_table(path)
    assert str(exc.value) == (
        'checkpoint holds no best plan (best_plan_state=None): no greedy '
        'eval episode succeeded before it was saved')


def test_pickled_payloads(tr, tmp_path):
    """A pickled GeoTable, a {'gdf': ...} payload and a list of them read
    back as the same table; a pickle of a JAX object is refused with its
    cause."""
    table = tr.best_plan_table()
    for i, payload in enumerate((table, {'gdf': table}, [{'gdf': table}])):
        path = tmp_path / f'plan{i}.p'
        with open(path, 'wb') as f:
            pickle.dump(payload, f)
        assert_same_table(demo.load_plan_table(str(path)), table)
    # the JAX trainer's checkpoint payload: jax.device_get of a PlanState
    import jax
    from urban_tpu.envs.plan_client import PlanClient
    from urban_tpu.jaxenv.state import build_env_spec, build_initial_state
    cfg = Config('hlg', 0, tmp=True)
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    state = jax.device_get(build_initial_state(build_env_spec(cfg, plc),
                                               plc))
    path = tmp_path / 'tpu_best.p'
    with open(path, 'wb') as f:
        pickle.dump({'best_plan_state': state}, f)
    with pytest.raises(SystemExit) as exc:
        demo.load_plan_table(str(path))
    assert str(exc.value).startswith(
        'the pickle holds urban_tpu.jaxenv.state.PlanState, an object of '
        'the JAX package')
    assert 'cannot be read without jax' in str(exc.value)
