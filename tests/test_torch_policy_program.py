"""The host agent's policy step as a program
(urban_tpu_torch.agents.policy_program): the PolicyProgram's packed
buffers (one byte buffer in, the action out) against the eager select,
bit for bit, on the grid host env's observations (N = 1000 nodes, E =
3000 edge slots, the config's caps) of a sampled and a greedy episode,
land use and roads; the agent's choice of path (the eager select on the
CPU, where the caller asked for it). A program is made on a card only:
its graph against the eager select, before and after the parameters
change in place, is `test_graph_against_eager_on_card` (skips without a
CUDA device) and chip_smoke.py's host_agent_grid, over 500 steps.

    python -m pytest tests/test_torch_policy_program.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

from urban_tpu_torch.agents.policy_program import (PolicyProgram,
                                                   eager_select,
                                                   graphed_select)
from urban_tpu_torch.bench import load_config
from urban_tpu_torch.host.envs.city import CityEnv
from urban_tpu_torch.host.rl.sampler import eval_episode
from urban_tpu_torch.models.model import create_sgnn_model, init_like_flax
from urban_tpu_torch.ops import segment_ops

torch.set_num_threads(1)


def _trace(device):
    """(obs, seed, mean_action) of a sampled then a greedy grid episode
    (the road stage played after the sampled land use), from the eager
    select of a model at the config's caps on `device`, and that
    model."""
    cfg = load_config('grid')
    model = create_sgnn_model(cfg)
    init_like_flax(model, torch.Generator().manual_seed(3))
    model.to(device)
    env = CityEnv(cfg)
    select, steps = eager_select(model, device), []

    def recording(obs, seed, mean_action):
        a = select(obs, seed, mean_action)
        steps.append((obs, seed, mean_action, a))
        return a
    for mean in (False, True):
        eval_episode(env, recording, mean_action=mean, seed=5)
    return model, steps


def _stages(steps):
    return {int(np.argmax(obs[-1][0])) for obs, *_ in steps}


def test_program_is_made_on_a_card_only():
    with pytest.raises(ValueError, match='CUDA'):
        PolicyProgram(None, [(1, 4)] * 9, 'cpu')


def test_agent_keeps_the_eager_select_on_the_cpu(tmp_path):
    from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
    from urban_tpu_torch.host.utils.config import Config
    agent = UrbanPlanningAgent(Config('grid', 0, root_dir=str(tmp_path)),
                               device='cpu')
    assert not hasattr(agent.sampler.select_action, 'programs')


@pytest.mark.gpu
def test_graph_against_eager_on_card():
    """On a card: the graphed select against the eager select, bit for
    bit, over a sampled and a greedy episode; one program, captured once;
    each replay counts the 2 forward launches its capture made. Then
    other parameters loaded in place (load_state_dict, as a checkpoint or
    an update writes them): the same program's replays equal the eager
    select again, and some actions move."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    model, steps = _trace(torch.device('cuda'))
    select = graphed_select(model, torch.device('cuda'))
    segment_ops.reset_launches()
    for i, (obs, seed, mean, a) in enumerate(steps):
        np.testing.assert_array_equal(select(obs, seed, mean), a,
                                      err_msg=f'step {i}')
    (program,) = select.programs.values()
    assert isinstance(program, PolicyProgram) and program.graph is not None
    assert program.device_bytes.numel() % 16 == 0
    assert program.launches['segment_mean'] == 2
    assert segment_ops.launches['segment_mean'] == 2 * len(steps)
    with pytest.raises(ValueError, match='shape'):
        program(tuple(o[..., :1] for o in steps[0][0]), 0, True)
    # new parameter values, written in place: the same graph follows them
    other = create_sgnn_model(load_config('grid'))
    init_like_flax(other, torch.Generator().manual_seed(4))
    model.load_state_dict(other.state_dict())
    eager, moved = eager_select(model, torch.device('cuda')), 0
    for i, (obs, seed, mean, a) in enumerate(steps):
        b = eager(obs, seed, mean)
        np.testing.assert_array_equal(select(obs, seed, mean), b,
                                      err_msg=f'step {i}, new parameters')
        moved += not np.array_equal(a, b)
    assert moved and list(select.programs.values()) == [program]
