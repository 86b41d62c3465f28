"""Two-phase training (land use, freeze, roads) of the port against the
JAX package, on the CPU, in one chain on the grid scenario:

1. phase 1 (cfg.train(), keep_boundaries) in lockstep to the end of the
   land use of one env, at small caps (tests/torch_parity.py: ints and
   bools equal, floats rtol 1e-5 / atol 1e-4): the plan keeps its BOUNDARY
   segments;
2. state_to_table of the final state against JAX's: ids, types, existence
   and coordinates exactly, rect / eqi / sc with NaN equal to NaN;
3. leftover feasible -> GREEN_S, freeze_land_use + unplan_all_land_use +
   cfg.finetune() on each package's own PlanClient: every EnvSpec field
   equal and the initial state equal field by field, with a non-empty
   road mask and a road budget;
4. the road stage of the frozen plan in lockstep to rd_done, each episode
   without failure and with a road reward in (0, 1].

Also transfer_matching_params against JAX's (the same counts and the same
tree through to_flax_params), and the port's trainer on the frozen plan
(tests/test_agent.py::test_tpu_trainer_two_phase_freeze port-side): one
road-only train_iteration, a phase-2 checkpoint and its resume."""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from torch_parity import jax_fields, lockstep
from urban_tpu import city_config as jcc
from urban_tpu.envs.plan_client import PlanClient
from urban_tpu.jaxenv import state as jstate
from urban_tpu.jaxenv.rollout import broadcast_state as j_broadcast
from urban_tpu.utils.config import Config
from urban_tpu_torch.host import city_config as tcc
from urban_tpu_torch.host.envs.plan_client import PlanClient as TPlanClient
from urban_tpu_torch.host.geometry.base import LINE, POINT, POLY
from urban_tpu_torch.host.utils.config import Config as TConfig
from urban_tpu_torch.models.convert import load_flax_params, to_flax_params
from urban_tpu_torch.rl import trainer as ttrain
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv import step as tstep
from urban_tpu_torch.torchenv.rollout import broadcast_state

torch.set_num_threads(1)

# phase 1: room for a whole land-use episode (about 48 steps: 55 parcels,
# 161 segments, 107 intersections and 1734 contiguity edges at its end)
CAPS1 = dict(NP=192, NS=448, NPT=256, NE=3000)
SEED = 0


def _rup(n, m=64):
    return int(-(-n // m) * m)


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    """Phase 1 in lockstep to the end of its land use, then the freeze in
    both packages (steps 1 and 3 of the module docstring)."""
    root = tmp_path_factory.mktemp('two_phase')
    cj = Config('grid', SEED, root_dir=str(root / 'jax'))
    ct = TConfig('grid', SEED, root_dir=str(root / 'torch'))
    cj.train()
    ct.train()
    pj = PlanClient(cj.objectives_plan, cj.init_plan)
    pt = TPlanClient(ct.objectives_plan, ct.init_plan)
    sj = jstate.build_env_spec(cj, pj, max_steps=cj.max_sequence_length,
                               caps=CAPS1, keep_boundaries=True)
    st = tstate.build_env_spec(ct, pt, max_steps=ct.max_sequence_length,
                               caps=CAPS1, keep_boundaries=True)
    steps, fj, ft = lockstep(
        sj, j_broadcast(jstate.build_initial_state(sj, pj), 1), st,
        broadcast_state(tstate.build_initial_state(st, pt, device='cpu'), 1),
        [np.random.default_rng(SEED)], 80, freeze_done=True,
        where='phase 1', with_states=True)
    final_j = jax.tree.map(lambda x: x[0], fj)
    final_t = ft.map(lambda x: x[0])
    table_j = jstate.state_to_table(final_j)
    table_t = tstate.state_to_table(final_t)
    out = dict(cfg_j=cj, cfg_t=ct, steps=[np.stack(x) for x in zip(*steps)],
               final_j=final_j, final_t=final_t, table_j=table_j.copy(),
               table_t=table_t.copy())
    # step 3: the freeze, each package on its own plan
    table_j.types[table_j.alive_mask_of(jcc.FEASIBLE)] = jcc.GREEN_S
    table_t.types[table_t.alive_mask_of(tcc.FEASIBLE)] = tcc.GREEN_S
    for plc, table in ((pj, table_j), (pt, table_t)):
        plc.freeze_land_use(table)
        plc.unplan_all_land_use()
    cj.finetune()
    ct.finetune()
    out.update(plc_j=pj, plc_t=pt, frozen_t=table_t.copy(),
               spec_j=jstate.build_env_spec(cj, pj,
                                            max_steps=cj.max_sequence_length),
               spec_t=tstate.build_env_spec(ct, pt,
                                            max_steps=ct.max_sequence_length))
    return out


def test_phase1_keeps_boundaries_to_land_use_end(chain):
    reward, done, failure, lu_done, rd_done = chain['steps']
    assert lu_done[-1, 0] and done[-1, 0] and not failure.any()
    assert lu_done.sum() == 1 and not rd_done.any() and reward[-1, 0] > 0
    for fields in (jax_fields(chain['final_j']),
                   tstate.plan_state_to_numpy(chain['final_t'])):
        assert int(fields['stage']) == 2
        boundary = fields['seg_alive'] & (fields['seg_type']
                                          == tcc.BOUNDARY)
        assert boundary.sum() > 0


def test_state_to_table_matches_jax(chain):
    want = chain['table_j']
    got_state = chain['table_t']
    got_dict = tstate.state_to_table(
        tstate.plan_state_to_numpy(chain['final_t']))
    for got in (got_state, got_dict):
        assert len(got) == len(want) > 0
        for k in ('ids', 'types', 'existence', 'rect', 'eqi', 'sc'):
            # NaN equals NaN here: segments and points have no shape metrics
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        for a, b in zip(got.geoms, want.geoms):
            assert a.kind == b.kind
            np.testing.assert_array_equal(a.coords, b.coords)


def test_freeze_matches_jax(chain):
    spec_j, spec_t = chain['spec_j'], chain['spec_t']
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    assert spec_t.skip_land_use and not spec_t.skip_road
    s_j = jstate.build_initial_state(spec_j, chain['plc_j'])
    s_t = tstate.build_initial_state(spec_t, chain['plc_t'], device='cpu')
    want, got = jax_fields(s_j), tstate.plan_state_to_numpy(s_t)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got['stage']) == 1 and int(got['total_road_steps']) > 0
    assert int(tstep.road_mask(spec_t, s_t).sum()) > 0


def test_phase2_road_lockstep(chain):
    """The frozen plan's road stage at caps that hold the frozen plan (a
    road step adds no feature)."""
    table = chain['frozen_t']
    kinds = np.array([g.kind for g in table.geoms])
    n_seg = sum(len(g.coords) - 1 for g in table.geoms if g.kind == LINE)
    caps = dict(NP=_rup(int((kinds == POLY).sum())), NS=_rup(n_seg),
                NPT=_rup(int((kinds == POINT).sum())), NE=3000)
    cj, ct = chain['cfg_j'], chain['cfg_t']
    sj = jstate.build_env_spec(cj, chain['plc_j'],
                               max_steps=cj.max_sequence_length, caps=caps)
    st = tstate.build_env_spec(ct, chain['plc_t'],
                               max_steps=ct.max_sequence_length, caps=caps)
    s0j = jstate.build_initial_state(sj, chain['plc_j'])
    budget = int(s0j.total_road_steps)
    steps = lockstep(sj, j_broadcast(s0j, 1), st,
                     broadcast_state(tstate.build_initial_state(
                         st, chain['plc_t'], device='cpu'), 1),
                     [np.random.default_rng(1)], budget + 2,
                     freeze_done=True, where='phase 2')
    reward, done, failure, lu_done, rd_done = (np.stack(x)
                                               for x in zip(*steps))
    assert not lu_done.any() and not failure.any()
    assert (rd_done.sum(0) == 1).all()
    np.testing.assert_array_equal(rd_done.argmax(0) + 1, budget)
    final = reward[rd_done]
    assert ((final > 0) & (final <= 1)).all()


# ---- transfer_matching_params -------------------------------------------

WIDTHS = dict(hidden_size=(16, 8), gcn_node_dim=8, num_gcn_layers=2,
              num_edge_fc_layers=1, num_attention_heads=1,
              land_use_hidden=(16, 1), road_hidden=(16, 1),
              value_hidden=(16, 16, 1))


def _jax_and_port(encoder, nodes, edges, seed, **widths):
    """A JAX model's initial parameters, and a port model of the same
    widths holding them (load_flax_params)."""
    from types import SimpleNamespace
    from urban_tpu.models.model import ActorCritic as JaxActorCritic
    from urban_tpu.models.model import dummy_obs
    from urban_tpu_torch.models.model import ActorCritic
    w = dict(WIDTHS, **widths, max_num_nodes=nodes, max_num_edges=edges)
    jm = JaxActorCritic(encoder=encoder, **w)
    cfg = SimpleNamespace(state_encoder_specs=dict(max_num_nodes=nodes,
                                                   max_num_edges=edges))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), dummy_obs(cfg)))
    return params, load_flax_params(ActorCritic(**w, encoder=encoder),
                                    params)


@pytest.mark.parametrize('encoder,widths', [
    ('sgnn', {}), ('mlp', {}), ('sgnn', dict(value_hidden=(16, 8, 1))),
    ('sgnn', dict(gcn_node_dim=4))])
def test_transfer_matching_params_matches_jax(encoder, widths):
    """From a phase-1-sized model into a phase-2-sized one (another graph,
    so the same parameter shapes: everything transfers), and into models
    of other widths (a part transfers). Both sides start from the same
    parameters and must end with the same tree."""
    from urban_tpu.rl.train_tpu import transfer_matching_params as j_transfer
    src_j, src_t = _jax_and_port(encoder, 80, 160, 0)
    dst_j, dst_t = _jax_and_port(encoder, 120, 200, 1, **widths)
    out_j, copied_j, total_j = j_transfer(src_j, dst_j)
    out_t, copied_t, total_t = ttrain.transfer_matching_params(
        src_t.state_dict(), dst_t.state_dict())
    assert (copied_t, total_t) == (copied_j, total_j)
    assert 0 < copied_t <= total_t and (copied_t == total_t) == (not widths)
    dst_t.load_state_dict(out_t)
    got = dict(jax.tree_util.tree_flatten_with_path(
        to_flax_params(dst_t))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(out_j)[0])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v,
                                      err_msg=jax.tree_util.keystr(k))


# ---- the port's trainer on the frozen plan ------------------------------

@pytest.fixture(scope='module')
def phase2_trainer(chain, tmp_path_factory):
    """A grid trainer in phase 1 (keep_boundaries), frozen on the chain's
    plan with a warm start from its own parameters, after one road-only
    train_iteration of 2 envs x 16 steps."""
    cfg = TConfig('grid', SEED,
                  root_dir=str(tmp_path_factory.mktemp('trainer')))
    cfg.train()
    tr = ttrain.Trainer(cfg, num_envs=2, rollout_len=16, eval_envs=2,
                        device='cpu', keep_boundaries=True)
    assert tr.spec.keep_boundaries and tr.phase == 1
    phase1_nodes = tr.spec.num_features
    warm = {k: v.clone() for k, v in tr.model.state_dict().items()}
    cfg.finetune()
    ttrain.freeze_land_use_trainer(tr, chain['frozen_t'].copy(),
                                   warm_start_params=warm)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    stats = tr.train_iteration(0, do_eval=False)
    return dict(trainer=tr, stats=stats, warm=warm, before=before,
                phase1_nodes=phase1_nodes)


def test_freeze_land_use_trainer_plays_the_road_stage(chain, phase2_trainer):
    tr, stats = phase2_trainer['trainer'], phase2_trainer['stats']
    assert tr.phase == 2 and tr.frozen_table is not None
    # the spec of the freeze; as in the JAX trainer, its max_num_nodes (read
    # by the packed observation only) is the phase-1 model's node count
    assert dataclasses.asdict(tr.spec) == dict(
        dataclasses.asdict(chain['spec_t']),
        max_num_nodes=phase2_trainer['phase1_nodes'])
    assert int(tstep.road_mask(tr.spec, tr.init_state).sum()) > 0
    assert int(tr.init_state.total_road_steps) > 0
    assert stats.failures < 2 * 16      # the road stage is playable
    # the model was rebuilt on the regrown slot table
    assert tr.spec.num_features != phase2_trainer['phase1_nodes']
    assert tr.cfg.state_encoder_specs['max_num_nodes'] == \
        tr.spec.num_features == tr.model.shared_net.max_num_nodes
    # every phase-1 tensor fits (the widths do not depend on the graph)
    assert tr.warm_start == (len(phase2_trainer['warm']),) * 2
    assert all(torch.equal(phase2_trainer['before'][k], v)
               for k, v in phase2_trainer['warm'].items())


def test_phase2_checkpoint_resumes_in_phase_2(phase2_trainer, tmp_path):
    tr = phase2_trainer['trainer']
    tr.save_checkpoint(1, tag='phase2_final')
    path = os.path.join(tr.cfg.model_dir, 'phase2_final.pt')
    ckpt = ttrain.read_checkpoint(path)
    assert ckpt['phase'] == 2 and ckpt['frozen_table'] is not None
    # a phase-1 trainer refuses it; run_training re-enters phase 2 first
    with pytest.raises(ValueError):
        ttrain.Trainer(TConfig('grid', SEED, root_dir=str(tmp_path)),
                       num_envs=2, rollout_len=16,
                       device='cpu').load_checkpoint(ckpt)
    with pytest.raises(ValueError, match='separate_train'):
        ttrain.run_training(TConfig('grid', SEED, root_dir=str(tmp_path)),
                            1, 2, rollout_len=16, resume=path, device='cpu')
    again = ttrain.run_training(
        TConfig('grid', SEED, root_dir=str(tmp_path)), 1, 2,
        separate_train=True, eval_envs=2, rollout_len=16, resume=path,
        device='cpu')
    assert again.phase == 2 and again.start_iteration == 2
    assert dataclasses.asdict(again.spec) == dataclasses.asdict(tr.spec)
    sd, sd2 = tr.model.state_dict(), again.model.state_dict()
    assert sd.keys() == sd2.keys()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    np.testing.assert_array_equal(again.frozen_table.types,
                                  tr.frozen_table.types)


@pytest.mark.slow
def test_cli_separate_train_runs_both_phases(tmp_path):
    """python -m urban_tpu_torch.rl.trainer --cfg grid --separate_train on
    the CPU: one iteration of each phase, 2 envs x 60 steps (a land-use
    episode takes about 48 steps, a road one at most 60)."""
    ttrain.main(['--cfg', 'grid', '--separate_train', '--iterations', '1',
                 '--num_envs', '2', '--eval_envs', '1', '--rollout_len',
                 '60', '--device', 'cpu', '--root_dir', str(tmp_path)])
    model_dir = os.path.join(str(tmp_path), 'grid', '0', 'models')
    phase1 = ttrain.read_checkpoint(os.path.join(model_dir,
                                                 'phase1_final.pt'))
    phase2 = ttrain.read_checkpoint(os.path.join(model_dir,
                                                 'phase2_final.pt'))
    assert phase1['phase'] == 1 and phase1['best_reward'] > 0
    assert phase2['phase'] == 2 and phase2['iteration'] == 1
    assert len(phase2['frozen_table']) > 0
