"""The card-vs-CPU trainer lockstep (urban_tpu_torch/tools/card_lockstep.py)
with both sides on the CPU: the SGNN trainer on HLG at the trainer's caps,
2 envs x 35 steps, one iteration (collect -> weights -> update -> eval) and
one more collect, each side on the served noise. Two CPU sides agree bit
for bit, on HLG and, through the tool's --cfg, on the planning-concept
scenario hlg_concept (E = 4000 edges, the concept term in the reward), on
DHM (N = 1408 nodes, land use only), and in grid's road phase (phase 2:
both sides frozen on one plan); a side saved with --save runs against the
CPU later from its own initial parameters; the comparison reports a 1e-3
nudge of one edge_fc weight on one side, in that layer's group alone; a
served-noise queue that runs out, or is left over, raises."""
import json

import numpy as np
import pytest
import torch

from urban_tpu_torch.rl import trainer as trainer_mod
from urban_tpu_torch.tools import card_lockstep as cl

torch.set_num_threads(1)

SIZES = dict(encoder='sgnn', num_envs=2, rollout_len=35, eval_envs=2,
             iterations=1)
NUDGED = 'shared_net.edge_fc.0.layers.0.weight'


@pytest.fixture(scope='module')
def sides():
    """(device side, reference side), both on the CPU, run at once."""
    return cl.run_sides('cpu', 'cpu', concurrent=True, ref_threads=1,
                        **SIZES)


def test_two_cpu_sides_agree_bit_for_bit(sides):
    a, b = sides
    report = cl.compare(a, b)
    assert report['ok'], report['failures']
    assert report['same_initial_parameters']
    assert len(a['collects']) == 2 and len(a['iterations']) == 1
    for ca, cb in zip(a['collects'], b['collects']):
        for name in cl.TRAJECTORY_INTS + cl.TRAJECTORY_FLOATS + ('gaps',):
            assert np.array_equal(ca[name], cb[name]), name
    ia, ib = a['iterations'][0], b['iterations'][0]
    assert ia['losses'] == ib['losses']
    assert all(np.array_equal(v, ib['params'][k])
               for k, v in ia['params'].items())
    (it,) = report['iterations']
    assert set(it['group_max_abs_diff']) == {
        'node_encoder', 'edge_fc.0', 'edge_fc.1', 'attention', 'mlp',
        'land_use_head', 'road_head', 'value_mlp'}
    assert not any(it['group_max_abs_diff'].values())
    # 70 rows: one minibatch an epoch, 4 epochs; the plain versions run on
    # the CPU, so no part launches a kernel
    assert it['adam_steps'] == 4
    assert not any(n for part in it['launches'].values()
                   for n in part.values())
    # the window ended episodes, so the update had rows to learn from
    assert it['episodes'] >= 2 and ia['success_frac'] > 0
    assert np.isfinite(a['collects'][0]['gaps']).any()


def test_two_cpu_sides_agree_bit_for_bit_on_concept(tmp_path):
    cli_sides_agree(tmp_path, 'hlg_concept', nodes=1344, edges=4000)


@pytest.mark.parametrize('cfg,nodes,edges', [('dhm', 1408, 3000)],
                         ids=['dhm'])
def test_two_cpu_sides_agree_bit_for_bit_on_scenario(cfg, nodes, edges,
                                                     tmp_path):
    cli_sides_agree(tmp_path, cfg, nodes=nodes, edges=edges)


def cli_sides_agree(tmp_path, cfg, nodes, edges):
    """The tool's command line with --cfg `cfg`, both sides on the CPU at
    once: the report it writes says the sides agree bit for bit."""
    out = tmp_path / 'report.json'
    report = cl.main(['--cfg', cfg, '--device', 'cpu',
                      '--num_envs', '2', '--iterations', '1',
                      '--concurrent', '--ref_threads', '1',
                      '--out', str(out)])
    assert report['ok'], report['failures']
    assert json.loads(out.read_text())['ok']
    assert report['sizes'] == dict(cfg=cfg, num_envs=2, rollout_len=35,
                                   eval_envs=2, nodes=nodes, edges=edges,
                                   iterations=1)
    assert report['same_initial_parameters']
    for c in report['collects']:
        assert not c['differing_actions']
        assert not any(v for k, v in c.items() if k.endswith('_abs_diff'))
    (it,) = report['iterations']
    assert it['adam_steps'] == 4 and it['episodes'] >= 2
    assert not any(it['group_max_abs_diff'].values())
    assert not any(it['loss_abs_diff'].values())
    assert it['eval_reward'][0] == it['eval_reward'][1]


def test_comparison_reports_a_nudged_edge_fc_weight(sides):
    a, b = sides
    nudged = dict(a, iterations=[dict(a['iterations'][0], params={
        k: v.copy() for k, v in a['iterations'][0]['params'].items()})])
    nudged['iterations'][0]['params'][NUDGED][0, 0] += 1e-3
    report = cl.compare(nudged, b)
    assert not report['ok']
    assert [f for f in report['failures'] if NUDGED in f] == \
        report['failures']
    groups = report['iterations'][0]['group_max_abs_diff']
    assert groups['edge_fc.0'] == pytest.approx(1e-3, rel=1e-3)
    assert not any(v for g, v in groups.items() if g != 'edge_fc.0')


@pytest.mark.parametrize('change', ['short', 'long'])
def test_served_noise_must_be_used_up(change, monkeypatch):
    """A one-step collect whose served draws are one short runs out, one
    over is left over: both raise."""
    draws = cl.collect_draws

    def changed(*args):
        out = draws(*args)
        return out[:-1] if change == 'short' else out + out[-1:]
    monkeypatch.setattr(cl, 'collect_draws', changed)
    match = 'ran out' if change == 'short' else 'left over'
    with pytest.raises(RuntimeError, match=match):
        cl.run_side('cpu', num_envs=1, rollout_len=1, eval_envs=1,
                    iterations=0)


def test_served_noise_checks_each_draw():
    noise = cl.ServedNoise()
    noise.serve([np.zeros((2, 3), np.float32)])
    with pytest.raises(RuntimeError, match='asked for'):
        noise((2, 4), None, 'cpu')
    noise.serve([np.full((2,), 0.25, np.float32)])
    with pytest.raises(RuntimeError, match='left over'):
        noise.serve([])
    assert torch.equal(noise((2,), None, 'cpu'), torch.full((2,), 0.25))
    noise.check_used('done')
    with pytest.raises(RuntimeError, match='ran out'):
        noise((2,), None, 'cpu')


def test_encoder_specs_reach_both_sides():
    """The tool's --gcn_node_dim / --max_num_edges override HLG's
    state_encoder_specs on both sides (the wide config chip_smoke.py
    holds on the card: width 24, 40,000 edge slots); two CPU sides of a
    one-step collect agree bit for bit, and a record of another width is
    refused. The full wide lockstep (8 x 35, two iterations) takes
    minutes a side on the CPU, so only the card runs it
    (chip_smoke.py's trainer_card_vs_cpu_wide)."""
    specs = {'gcn_node_dim': 24, 'max_num_edges': 40000}
    a, b = cl.run_sides('cpu', 'cpu', num_envs=1, rollout_len=1,
                        eval_envs=1, iterations=0, encoder_specs=specs)
    report = cl.compare(a, b)
    assert report['ok'], report['failures']
    assert report['sizes']['edges'] == 40000
    assert report['widths'] == {'gcn_node_dim': 24}
    assert a['init_params']['shared_net.node_encoder.weight'].shape[0] == 24
    assert np.array_equal(a['collects'][0]['actions'],
                          b['collects'][0]['actions'])
    narrow = cl.run_side('cpu', num_envs=1, rollout_len=1, eval_envs=1,
                         iterations=0, encoder_specs={
                             'max_num_edges': 40000})
    with pytest.raises(ValueError):
        cl.compare(a, narrow)


def test_two_cpu_sides_agree_bit_for_bit_on_the_road_phase():
    """The tool with phase 2 on grid, both sides on the CPU at once: each
    freezes a phase-1 trainer on the one plan that frozen_plan makes (the
    seed's greedy land-use episode; its road budget is 44 steps, so a
    45-step window ends a road episode in each env) with the same warm
    start, then one iteration and a collect of the road phase. The report
    says the sides agree bit for bit, the warm start copied every tensor,
    no road episode failed and the greedy road episode's reward is in
    (0, 1]."""
    report = cl.run('cpu', 'cpu', concurrent=True, ref_threads=1,
                    cfg='grid', phase=2, num_envs=2, rollout_len=45,
                    iterations=1)
    assert report['ok'], report['failures']
    assert report['phase'] == 2
    assert report['sizes'] == dict(cfg='grid', num_envs=2, rollout_len=45,
                                   eval_envs=2, nodes=1600, edges=3000,
                                   iterations=1)
    assert report['same_initial_parameters']
    assert tuple(report['warm_start']) == (30, 30)
    for c in report['collects']:
        assert not c['differing_actions']
        assert not any(v for k, v in c.items() if k.endswith('_abs_diff'))
    (it,) = report['iterations']
    assert it['adam_steps'] == 4 and it['episodes'] >= 2
    assert it['failures'] == 0
    assert not any(it['group_max_abs_diff'].values())
    assert not any(it['loss_abs_diff'].values())
    assert it['eval_reward'][0] == it['eval_reward'][1]
    assert 0 < it['eval_reward'][0] <= 1


def test_a_saved_side_runs_against_the_cpu_later(tmp_path):
    """--save runs one side alone and pickles its record with its
    arguments; --against runs the CPU side of it later (on another machine
    where a run's CPU side outlasts the card's call) and compares: a
    one-collect HLG run at one env, both sides on the CPU, bit for bit."""
    path = str(tmp_path / 'side.pkl')
    record = cl.main(['--device', 'cpu', '--num_envs', '1', '--iterations',
                      '0', '--save', path])
    assert record['sizes']['num_envs'] == 1 and not record['iterations']
    report = cl.main(['--against', path, '--ref_threads', '1'])
    assert report['ok'], report['failures']
    assert report['devices'] == ['cpu', 'cpu'] and report['phase'] == 1
    (c,) = report['collects']
    assert not c['differing_actions']
    assert not any(v for k, v in c.items() if k.endswith('_abs_diff'))


def test_against_starts_from_the_saved_initial_parameters(tmp_path,
                                                         monkeypatch):
    """--against runs its side from the saved side's initial parameters,
    not from its own draw at the seed, which another torch version may
    make otherwise (here: the reference side's draw at another seed); the
    one-collect HLG run at one env still agrees bit for bit."""
    path = str(tmp_path / 'side.pkl')
    cl.main(['--device', 'cpu', '--num_envs', '1', '--iterations', '0',
             '--save', path])
    draw = trainer_mod.init_like_flax
    monkeypatch.setattr(trainer_mod, 'init_like_flax', lambda model, _: draw(
        model, torch.Generator().manual_seed(cl.SEED + 1)))
    report = cl.main(['--against', path, '--ref_threads', '1'])
    assert report['ok'], report['failures']
    assert report['same_initial_parameters']
    (c,) = report['collects']
    assert not c['differing_actions']
    assert not any(v for k, v in c.items() if k.endswith('_abs_diff'))
