"""The port's CLIs on the host environment (urban_tpu_torch.train and
urban_tpu_torch.eval) on the CPU: the four baselines and a GA gene scored
by the port's eval against the JAX agent's evaluation of the same agent
(the same numpy policy and environment: the same plan and reward, exactly),
and a two-phase train followed by an eval of its best checkpoint.
"""
import os

import numpy as np
import pytest
import torch

from urban_tpu.utils.config import Config as JaxConfig

from torch_parity import assert_same

torch.set_num_threads(1)

SEED = 0


def jax_eval(root, agent, gene=None):
    """What urban_tpu.eval runs for `agent`: infer's greedy episode, or for
    ga the episode of the gene (LoggerRL)."""
    from urban_tpu.agents.urban_agent import UrbanPlanningAgent as JaxAgent
    j = JaxAgent(JaxConfig('grid', SEED, root_dir=root, agent=agent),
                 training=False)
    if gene is None:
        return j.eval_agent(1, mean_action=True)
    j.save_ga(gene, 0.0)
    best, _ = j.load_ga()
    return j.fitness_ga(best, return_log_eval=True)[2]


@pytest.mark.parametrize('agent', ['rule-centralized', 'rule-decentralized',
                                   'gsca', 'ga'])
def test_eval_baseline_matches_jax(agent, tmp_path):
    from urban_tpu_torch import eval as port_eval
    from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
    from urban_tpu_torch.host.utils.config import Config
    gene = None
    if agent == 'ga':
        cfg = Config('grid', SEED, root_dir=str(tmp_path / 'port'),
                     agent='ga')
        ga = UrbanPlanningAgent(cfg, training=False, device='cpu')
        gene = np.random.default_rng(3).normal(size=2 * ga.node_dim + 1)
        ga.save_ga(gene, 0.0)
    want = jax_eval(str(tmp_path / 'jax'), agent, gene)
    _, got = port_eval.main(['--cfg', 'grid', '--global_seed', str(SEED),
                             '--agent', agent, '--device', 'cpu',
                             '--root_dir', str(tmp_path / 'port')])
    assert len(got.plans) == len(want.plans) == 1
    assert got.num_steps == want.num_steps > 1
    assert got.avg_episode_reward == want.avg_episode_reward
    assert_same(got.plans[0], want.plans[0])
    assert os.path.exists(tmp_path / 'port' / 'grid' / str(SEED) / 'plan'
                          / 'plan.p')


def test_train_then_eval_cli_on_cpu(tmp_path):
    """Two-phase training of one iteration a phase, one episode an
    iteration, then eval from its best checkpoint: phase 2 ran on the
    frozen plan, the best checkpoint holds the trained parameters, and
    the greedy eval from it gives a finite plan reward."""
    from urban_tpu_torch import eval as port_eval
    from urban_tpu_torch import train as port_train
    root = str(tmp_path)
    common = ['--cfg', 'grid', '--global_seed', str(SEED), '--device', 'cpu',
              '--root_dir', root]
    agent = port_train.main(common + ['--max_num_iterations', '1',
                                      '--num_episodes_per_iteration', '1'])
    assert agent.cfg.skip_land_use and not agent.cfg.skip_road   # phase 2
    assert agent.reward_offset > 0
    assert agent.loss_iter > 0 and agent.best_rewards > -1000.0
    models = os.listdir(agent.cfg.model_dir)
    assert 'best.p' in models
    best = torch.load(os.path.join(agent.cfg.model_dir, 'best.p'),
                      weights_only=False)
    assert set(best) == {'params', 'opt_state', 'loss_iter', 'best_rewards',
                         'best_plans', 'current_rewards', 'current_plans',
                         'iteration'}
    assert best['best_rewards'] == agent.best_rewards
    assert best['iteration'] in (0, 1)

    ev, log = port_eval.main(common + ['--iteration', 'best'])
    params = ev.model.state_dict()
    assert all(torch.equal(params[k], v) for k, v in best['params'].items())
    assert np.isfinite(log.avg_episode_reward) and log.num_steps > 1


def test_cli_flags_parse_as_absl():
    from urban_tpu_torch import eval as port_eval
    from urban_tpu_torch import train as port_train
    base = ['--cfg', 'grid', '--global_seed', '1']
    a = port_train.parse_args(base)
    assert (a.separate_train, a.restore_best_rewards, a.tmp, a.tensorboard,
            a.device, a.agent, a.iteration) == (True, True, False, False,
                                                'cuda', 'rl-sgnn', '0')
    assert not port_train.parse_args(base + ['--noseparate_train']) \
        .separate_train
    assert not port_train.parse_args(base + ['--separate_train=false']) \
        .separate_train
    assert port_train.parse_args(base + ['--tmp']).tmp
    e = port_eval.parse_args(base + ['--nomean_action', '--agent', 'gsca'])
    assert (e.mean_action, e.agent, e.device) == (False, 'gsca', 'cuda')
    with pytest.raises(SystemExit):
        port_train.parse_args(base + ['--agent', 'gsca'])
