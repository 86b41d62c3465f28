"""The port's batched HLG rollout and one PPO train_iteration of its
trainer on the CPU, in a fresh interpreter: the test process has jax
loaded (conftest.py), so only a subprocess can show that urban_tpu_torch
runs without importing jax, flax or optax. Also: the bench helpers put
their results on the card unless asked for the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, math, os, sys
import torch
torch.set_num_threads(1)
from urban_tpu_torch.bench import run_rollout_bench
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.trainer import Trainer
r = run_rollout_bench(num_envs=2, num_steps=5, device='cpu', seed=3)

root = sys.argv[1]
tr = Trainer(Config('hlg', 0, root_dir=root), num_envs=2, rollout_len=6,
             eval_envs=2, device='cpu')
st = tr.train_iteration(0)
tr.save_checkpoint(0)
# a trainer from another seed takes the checkpoint's state exactly
tr2 = Trainer(Config('hlg', 1, root_dir=root), num_envs=2, rollout_len=6,
              eval_envs=2, device='cpu')
tr2.load_checkpoint(os.path.join(tr.cfg.model_dir, 'iteration_0000.pt'))
sd, sd2 = tr.model.state_dict(), tr2.model.state_dict()
o, o2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
same = (sd.keys() == sd2.keys()
        and all(torch.equal(sd[k], sd2[k]) for k in sd)
        and o['state'].keys() == o2['state'].keys()
        and all(torch.equal(o['state'][i][k], o2['state'][i][k])
                for i in o['state'] for k in o['state'][i]))
train = {'losses': st.losses, 'steps': tr.num_envs * tr.rollout_len,
         'sample_time': st.sample_time, 'update_time': st.update_time,
         'value_mc_rms': tr.last_value_mc_rms,
         'checkpoint_round_trip': bool(same),
         'optimizer_steps': len(o['state']),
         'start_iteration': tr2.start_iteration}
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))
print(json.dumps({'stats': r, 'train': train, 'loaded': loaded}))
'''


def _finite(x):
    return isinstance(x, float) and x == x and abs(x) != float('inf')


def test_cpu_rollout_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', SCRIPT, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['loaded'] == []
    r = out['stats']
    assert r['device'] == 'cpu'
    assert r['num_envs'] * r['num_steps'] == 10
    assert 0 <= r['failures'] <= r['episodes']
    for key in ('env_steps_per_sec', 'mean_episode_reward', 'seconds'):
        assert _finite(r[key]), key
    assert r['overflow_gate_1pct_pass'] in (True, False)
    t = out['train']
    assert t['steps'] == 12
    assert sorted(t['losses']) == ['entropy_loss', 'loss', 'surr_loss',
                                   'value_loss']
    for key in ('sample_time', 'update_time', 'value_mc_rms'):
        assert _finite(t[key]), key
    assert all(_finite(v) for v in t['losses'].values()), t['losses']
    assert t['checkpoint_round_trip']
    assert t['optimizer_steps'] > 0 and t['start_iteration'] == 1


def test_bench_helpers_default_to_the_card():
    """bench.setup and bench.make_model without a device put the state and
    the model on the card; without a card they raise rather than quietly
    give a CPU run."""
    from urban_tpu_torch import bench
    cfg, spec, _ = bench.setup('hlg', {}, 'cpu')
    calls = {'setup': lambda: bench.setup('hlg', {})[2].done,
             'make_model': lambda: next(bench.make_model(cfg,
                                                         spec).parameters())}
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == 'cuda', name
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
