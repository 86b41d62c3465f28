"""The learning-parity tool (urban_tpu_torch/tools/parity_run.py) on a
scenario other than HLG: a CPU rehearsal of Huizhou's round-5 recipe at a
tiny batch, one iteration. The summary names what the trainer ran (the
flags after the recipe's override it), and the iteration's record carries
the ended and failed episodes, the failure causes and the launches."""
import json
import math
import os

import torch

from urban_tpu_torch.tools import parity_run

torch.set_num_threads(1)


def test_huizhou_rehearsal_names_what_ran(tmp_path):
    stats = tmp_path / 'huizhou.jsonl'
    root = tmp_path / 'run'
    summary = parity_run.main([
        '--iterations', '1', '--root_dir', str(root), '--stats', str(stats),
        '--cfg', 'huizhou', '--num_envs', '2', '--eval_envs', '1',
        '--rollout_len', '8', '--device', 'cpu'])

    # the flags as given hold the recipe's HLG batch first; the trainer ran
    # the overrides
    assert summary['argv'][:4] == ['--cfg', 'hlg', '--num_envs', '256']
    assert summary['effective'] == {
        'cfg': 'huizhou', 'num_envs': 2, 'rollout_len': 8, 'eval_envs': 1,
        'seed': 111, 'encoder': 'sgnn', 'encoder_operands': 'f32',
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
    assert os.path.exists(root / 'huizhou' / '111' / 'models' / 'final.pt')
