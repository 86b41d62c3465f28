"""The port's failure adjudication (urban_tpu_torch/tools/
replay_failures.py run_corpus) against the JAX package's
tools/replay_failures.py run_corpus, imported live, on the same corpus:
both sides' collect_trajectories are monkeypatched to return the same
arrays, and both replay its failures and a sample of its successes
through their engines and the host oracle. The metrics (but the wall
clock) and the outcome dicts are equal.

The corpus is the port's bench rollout at B = 4, T = 30 (the bench caps,
the bench's default seed 0), collected on the CPU: it holds 3 failing and
2 successful episodes, so both branches of the replay run."""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the JAX package's tools/ live at the root

from tools import replay_failures as jrf  # noqa: E402
from urban_tpu_torch import bench  # noqa: E402
from urban_tpu_torch.tools import replay_failures as trf  # noqa: E402

torch.set_num_threads(1)

B, T, SEED = 4, 30, 0
SAMPLE_SEED = SEED + 1   # the port draws its success sample with seed + 1


@pytest.fixture(scope='module')
def corpus():
    cfg, spec, init = bench.setup('hlg', device='cpu')
    model = bench.make_model(cfg, spec, SEED, 'cpu')
    arrays = trf.collect_trajectories(spec, model, init, B, T, SEED + 1,
                                      'cpu')
    _, _, dones, fails = arrays
    assert fails.sum() >= 2 and (dones & ~fails).sum() >= 2
    return arrays


def test_adjudication_matches_jax(corpus, monkeypatch):
    monkeypatch.setattr(jrf, 'collect_trajectories', lambda *a, **k: corpus)
    monkeypatch.setattr(trf, 'collect_trajectories', lambda *a, **k: corpus)
    kw = dict(B=B, T=T, max_failures=2, n_success=1, verbose=False)
    ref, ref_fail, ref_succ = jrf.run_corpus(key_seed=SAMPLE_SEED, **kw)
    got, fail_out, succ_out = trf.run_corpus('hlg', seed=SEED, device='cpu',
                                             **kw)
    assert got.pop('replay_wall_s') >= 0
    ref.pop('replay_wall_s')
    assert got == ref
    assert (fail_out, succ_out) == (ref_fail, ref_succ)
    assert (ref['failures_replayed'], ref['successes_replayed']) == (2, 1)
