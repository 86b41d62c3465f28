"""urban_tpu_torch.tools.greedy_replay, and the failing greedy episode of
the learning-parity arm B's final checkpoint (PERF.md, the parity arms).

results/hlg_armb_final_greedy_replay.json is the tool's output on that
checkpoint with the arm's flags (--encoder_operands bf16
--bf16_linear_operands; trained on the card, the checkpoint itself is not
kept): the greedy episode's slot actions and the step where the
slot-table env fails it. Here its actions go through JAX's env
(urban_tpu.jaxenv.step.env_step) and the port's, one env each at the HLG
trainer's caps: both fail at that step and only there, with the same
failure code (piece_new_pt), and the exact host engine rejects the same
action at the same step (tools/replay_failures.replay_one: host_failed):
the MDP's failure, not the port's. Then the tool on a fresh trainer's
checkpoint: its greedy episode is the trainer's own eval (the same
reward), and it succeeds.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from urban_tpu.jaxenv.step import env_step as j_env_step
from urban_tpu_torch.bench import load_config
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.trainer import Trainer
from urban_tpu_torch.tools.greedy_replay import greedy_replay
from urban_tpu_torch.tools.replay_failures import replay_one
from urban_tpu_torch.torchenv.step import FAIL_PIECE_NEW_PT
from urban_tpu_torch.torchenv.step import env_step as t_env_step

from torch_parity import build_pair

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'results', 'hlg_armb_final_greedy_replay.json')


def test_recorded_greedy_failure_is_the_mdps():
    with open(FIXTURE) as f:
        rec = json.load(f)
    actions, k = rec['actions'], rec['fail_step']
    assert k == len(actions) - 1 and rec['failure'] and rec['reward'] == -1
    assert rec['encoder_operands'] == 'bf16' and rec['bf16_linear_operands']
    spec_j, sj, spec_t, st = build_pair('hlg')
    assert (spec_t.num_features, spec_t.NE) == (1344, 3000)
    step_j = jax.jit(j_env_step, static_argnums=0)
    init_t = st
    for i, a in enumerate(actions):
        sj, _, _, ij = step_j(spec_j, sj, jnp.asarray(a, jnp.int32))
        st, _, _, it = t_env_step(spec_t, st, torch.tensor(a,
                                                           dtype=torch.int32))
        assert bool(ij['failure']) == bool(it['failure']) == (i == k), i
        assert int(ij['failure_code']) == int(it['failure_code']), i
    assert int(it['failure_code']) & FAIL_PIECE_NEW_PT
    replay = replay_one(load_config('hlg'), spec_t, init_t,
                        [np.asarray(a) for a in actions], k, device='cpu')
    assert replay == dict(rec['replay'], host_result='host_failed',
                          host_fail_at=k, jit_fail_at=k)


def test_tool_replays_the_trainers_greedy_eval(tmp_path):
    tt = Trainer(Config('hlg', 111, root_dir=str(tmp_path)), num_envs=1,
                 eval_envs=1, device='cpu')
    tt.save_checkpoint(0, tag='init')
    out = greedy_replay('hlg', str(tmp_path / 'hlg' / '111' / 'models'
                                   / 'init.pt'), device='cpu')
    reward, _ = tt.eval_agent(0)
    assert out['reward'] == reward and not out['failure']
    assert out['fail_step'] is None and 'replay' not in out
    assert len(out['actions']) == out['steps'] > 20
