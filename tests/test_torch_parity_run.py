"""The learning-parity tool (urban_tpu_torch/tools/parity_run.py) in CPU
rehearsals at a tiny batch, one iteration: Huizhou's round-5 recipe, and
HLG's round-5 SGNN-vs-MLP ablation (--encoder mlp). The summary names what
the trainer ran (the flags after the recipe's override it), and the
iteration's record carries the ended and failed episodes, the failure
causes and the launches. The MLP rehearsal's final checkpoint then goes
through tools/greedy_replay.py --encoder mlp."""
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
