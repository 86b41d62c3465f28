"""The port's copy of urban_tpu's numpy host tier (urban_tpu_torch.host)
against the originals, and the rule that the port imports nothing of
urban_tpu or jax.

Each copied module must be its original with the imports pointed at the
copy and, in the two modules that find the repo root from their own path,
one directory more counted up; anything else is drift. One function is
left out of one copy: ``ga_logits_jax``, the last function of
``models/baseline.py``, which imports jax in its body (the GA path's
batched scoring, ported as ``urban_tpu_torch.models.baseline.ga_logits``).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ['city_config.py', 'envs/plan_client.py', 'envs/plan_table.py',
          'geometry/base.py', 'geometry/graph.py', 'geometry/metrics.py',
          'geometry/native.py', 'geometry/ops.py', 'geometry/slicer.py',
          'io/geojson.py', 'io/refpickle.py', 'io/scenario.py', 'io/wkb.py',
          'utils/config.py', 'utils/io.py', 'utils/logger.py',
          'envs/city.py', 'envs/observation.py', 'envs/render.py',
          'models/baseline.py', 'rl/memory.py', 'rl/sampler.py',
          'utils/stats.py', 'utils/video.py']
# the root-finding lines, original -> copy
ROOT_LINES = {
    'utils/io.py': (
        'PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath('
        '__file__)))\nREPO_ROOT = os.path.dirname(PACKAGE_ROOT)\n',
        'REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname('
        'os.path.dirname(\n    os.path.abspath(__file__)))))\n'),
    'geometry/native.py': (
        "_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(\n"
        "    os.path.dirname(os.path.abspath(__file__)))), 'native')",
        "_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname("
        "os.path.dirname(\n    os.path.dirname(os.path.abspath(__file__)))))"
        ", 'native')"),
}
# copies that end before their original does: path -> the original's text
# from which the copy leaves the rest out
LEFT_OUT_TAIL = {'models/baseline.py': '\n\n\ndef ga_logits_jax('}


def _read(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return f.read()


@pytest.mark.parametrize('path', COPIED)
def test_host_copy_matches_original(path):
    want = _read('urban_tpu', path)
    want = want.replace('from urban_tpu import ',
                        'from urban_tpu_torch.host import ')
    want = want.replace('from urban_tpu.', 'from urban_tpu_torch.host.')
    if path in ROOT_LINES:
        old, new = ROOT_LINES[path]
        assert old in want
        want = want.replace(old, new)
    if path in LEFT_OUT_TAIL:
        tail = want.index(LEFT_OUT_TAIL[path])
        rest = want[tail:]   # one function: no other def or class after it
        assert rest.count('\ndef ') == 1 and '\nclass ' not in rest
        assert 'jax' not in want[:tail]
        want = want[:tail] + '\n'
    assert _read('urban_tpu_torch', 'host', path) == want


def test_port_imports_nothing_of_urban_tpu_or_jax():
    """Every module of the port, imported in a fresh interpreter, leaves no
    module of urban_tpu or jax behind."""
    mods = sorted(
        'urban_tpu_torch.' + os.path.relpath(os.path.join(d, f), os.path.join(
            ROOT, 'urban_tpu_torch'))[:-3].replace(os.sep, '.')
        for d, _, files in os.walk(os.path.join(ROOT, 'urban_tpu_torch'))
        for f in files if f.endswith('.py') and f != '__init__.py')
    code = ('import sys\n' + ''.join(f'import {m}\n' for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('urban_tpu', 'jax', 'jaxlib', 'flax', 'optax'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
