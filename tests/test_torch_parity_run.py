"""The learning-parity tool (urban_tpu_torch/tools/parity_run.py) in CPU
rehearsals at a tiny batch, one iteration: Huizhou's round-5 recipe, and
HLG's round-5 SGNN-vs-MLP ablation (--encoder mlp). The summary names what
the trainer ran (the flags after the recipe's override it), and the
iteration's record carries the ended and failed episodes, the failure
causes and the launches. The MLP rehearsal's final checkpoint then goes
through tools/greedy_replay.py --encoder mlp. The tool's timer of the
concept reward (the planning-concept scenario's run) leaves the stage
reward as it was and counts each call under the part running."""
import json
import math
import os

import pytest
import torch

from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.trainer import Trainer, read_checkpoint
from urban_tpu_torch.tools import greedy_replay, parity_run

torch.set_num_threads(1)

# case -> (the flags after the tool's own, cfg, encoder)
REHEARSALS = {
    'huizhou': (['--cfg', 'huizhou'], 'huizhou', 'sgnn'),
    'hlg_mlp': (['--cfg', 'hlg', '--encoder', 'mlp'], 'hlg', 'mlp'),
}


@pytest.fixture(scope='module')
def rehearsal(request, tmp_path_factory):
    """The tool at 2 envs x 8 steps, 1 eval env, one iteration on the CPU:
    (case, summary, stats file, root directory)."""
    flags, _, _ = REHEARSALS[request.param]
    tmp_path = tmp_path_factory.mktemp(request.param)
    stats = tmp_path / f'{request.param}.jsonl'
    root = tmp_path / 'run'
    summary = parity_run.main([
        '--iterations', '1', '--root_dir', str(root), '--stats', str(stats),
        *flags, '--num_envs', '2', '--eval_envs', '1', '--rollout_len', '8',
        '--device', 'cpu'])
    return request.param, summary, stats, root


@pytest.mark.parametrize('rehearsal', list(REHEARSALS), indirect=True)
def test_huizhou_rehearsal_names_what_ran(rehearsal):
    case, summary, stats, root = rehearsal
    _, cfg, encoder = REHEARSALS[case]

    # the flags as given hold the recipe's HLG batch first; the trainer ran
    # the overrides
    assert summary['argv'][:4] == ['--cfg', 'hlg', '--num_envs', '256']
    assert summary['effective'] == {
        'cfg': cfg, 'num_envs': 2, 'rollout_len': 8, 'eval_envs': 1,
        'seed': 111, 'encoder': encoder, 'encoder_operands': 'f32',
        'tau': 0.95, 'lr': 4e-4, 'normalize_advantages': True,
        'device': 'cpu'}
    assert summary['iterations'] == [0] and summary['card'] is None

    *iterations, last = [json.loads(line)
                         for line in stats.read_text().splitlines()]
    assert last == {'summary': summary}
    (it,) = iterations
    assert it['iteration'] == 0
    assert isinstance(it['episodes'], int) and isinstance(it['failures'], int)
    assert 0 <= it['failures'] <= it['episodes']
    # each failed episode sets at least one cause's bit
    assert sum(it['failure_causes'].values()) >= it['failures']
    assert all(math.isfinite(v) for v in it['losses'].values())
    # the CPU runs the kernels' plain versions: no launch, in every part
    assert it['kernel_launches'] == {
        part: {'segment_mean': 0, 'segment_mean_backward': 0}
        for part in ('collect', 'update', 'eval')}
    # 2 envs x 8 steps: one minibatch of 16 rows an epoch, 4 epochs
    assert it['minibatch_rows'] == [16] * 4
    assert os.path.exists(root / cfg / '111' / 'models' / 'final.pt')


def test_concept_timer_keeps_the_stage_reward(monkeypatch):
    """parity_run.ConceptTimer in torchenv.step.concept_reward's place,
    called as the collect calls it (the land-use stage reward, vmapped
    over a batch of hlg_concept states): the same reward, bit for bit, one
    call counted under 'collect', none under 'eval'."""
    from torch.func import vmap

    from urban_tpu_torch.bench import load_config
    from urban_tpu_torch.host.envs.plan_client import PlanClient
    from urban_tpu_torch.torchenv import state as tstate
    from urban_tpu_torch.torchenv import step
    from urban_tpu_torch.torchenv.program import broadcast_state
    cfg = load_config('hlg_concept')
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = tstate.build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length)
    states = broadcast_state(tstate.build_initial_state(spec, plc,
                                                        device='cpu'), 2)
    assert len(spec.concepts) == 3

    def stage_reward():
        return vmap(lambda s: step.land_use_stage_reward(spec, s))(states)
    want = stage_reward()
    timer = parity_run.ConceptTimer(step.concept_reward)
    monkeypatch.setattr(step, 'concept_reward', timer)
    timer.part = 'collect'
    got = stage_reward()
    assert torch.equal(got, want) and got.shape == (2,)
    assert timer.calls == {'collect': 1, 'eval': 0}
    assert timer.seconds['collect'] > 0 and timer.seconds['eval'] == 0
    timer.reset()
    assert timer.calls == {'collect': 0, 'eval': 0}


def test_deadline_stops_the_chunk_and_saves_final(tmp_path):
    """--deadline passed before the second iteration: the chunk runs
    iteration 0 alone, saves final.pt of it and says it stopped; the next
    chunk resumes from that final.pt at iteration 1."""
    stats, root = tmp_path / 'stats.jsonl', tmp_path / 'run'
    flags = ['--root_dir', str(root), '--stats', str(stats), '--cfg',
             'hlg', '--num_envs', '2', '--eval_envs', '1', '--rollout_len',
             '8', '--device', 'cpu']
    first = parity_run.main(['--iterations', '3', '--deadline', '1e-3',
                             *flags])
    assert first['iterations'] == [0] and first['stopped_at_deadline']
    final = str(root / 'hlg' / '111' / 'models' / 'final.pt')
    assert read_checkpoint(final)['iteration'] == 0
    second = parity_run.main(['--iterations', '2', '--resume', final,
                              *flags])
    assert second['iterations'] == [1]
    assert not second['stopped_at_deadline']
    lines = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [line.get('iteration') for line in lines] == [0, None, 1, None]


@pytest.mark.parametrize('rehearsal', ['hlg_mlp'], indirect=True)
def test_greedy_replay_takes_the_mlp(rehearsal, tmp_path):
    """tools/greedy_replay.py --encoder mlp plays the MLP checkpoint's
    greedy episode: the trainer's own greedy eval of those parameters at
    its default window (the same reward). Built as an SGNN, the model
    refuses the MLP's state dict."""
    _, _, _, root = rehearsal
    ckpt = str(root / 'hlg' / '111' / 'models' / 'final.pt')
    out = greedy_replay.main(['--cfg', 'hlg', '--ckpt', ckpt, '--encoder',
                              'mlp', '--device', 'cpu'])
    tt = Trainer(Config('hlg', 111, root_dir=str(tmp_path)), num_envs=1,
                 eval_envs=1, device='cpu', encoder='mlp')
    tt.model.load_state_dict(read_checkpoint(ckpt)['params'])
    reward, _ = tt.eval_agent(0)
    assert out['encoder'] == 'mlp' and out['reward'] == reward
    assert len(out['actions']) == out['steps'] > 0
    if out['failure']:
        assert out['fail_step'] == out['steps'] - 1
        assert out['replay']['host_result'] in ('host_failed',
                                                'host_survived')
    else:
        assert out['fail_step'] is None and 'replay' not in out
    with pytest.raises(RuntimeError):
        greedy_replay.greedy_replay('hlg', ckpt, device='cpu')
