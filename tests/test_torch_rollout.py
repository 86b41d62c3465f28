"""The port's batched HLG rollout on the CPU, in a fresh interpreter: the
test process has jax loaded (conftest.py), so only a subprocess can show
that urban_tpu_torch runs without importing jax, flax or optax."""
import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, math, sys
import torch
torch.set_num_threads(1)
from urban_tpu_torch.bench import run_rollout_bench
r = run_rollout_bench(num_envs=2, num_steps=5, device='cpu', seed=3)
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))
print(json.dumps({'stats': r, 'loaded': loaded}))
'''


def test_cpu_rollout_without_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = REPO
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['loaded'] == []
    r = out['stats']
    assert r['device'] == 'cpu'
    assert r['num_envs'] * r['num_steps'] == 10
    assert 0 <= r['failures'] <= r['episodes']
    for key in ('env_steps_per_sec', 'mean_episode_reward', 'seconds'):
        assert isinstance(r[key], float) and r[key] == r[key] \
            and abs(r[key]) != float('inf'), key
    assert r['overflow_gate_1pct_pass'] in (True, False)
