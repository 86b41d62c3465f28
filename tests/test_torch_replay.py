"""The port's failure replay (urban_tpu_torch/tools/replay_failures.py)
against the JAX package's tools/replay_failures.py, imported live: the
same slot-action sequences replay to the same outcome dicts, and the
success budget behaves alike (tests/test_torch_adjudication.py holds the
adjudication).

The corpus is JAX's own: collect_trajectories at B = 4, T = 30 and the
bench caps, with the JAX harness's default key (key_seed 2). That key is
chosen for coverage, not to avoid a result: its corpus holds a failing
episode and successful ones, so both branches of the replay run."""
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the JAX package's tools/ live at the root

from tools import replay_failures as jrf  # noqa: E402
from urban_tpu_torch import bench  # noqa: E402
from urban_tpu_torch.tools import divergence as tdiv  # noqa: E402
from urban_tpu_torch.tools import replay_failures as trf  # noqa: E402

torch.set_num_threads(1)

B, T, KEY_SEED = 4, 30, 2
# the port's run_corpus draws its success sample with seed + 1
PORT_SEED = KEY_SEED - 1


@pytest.fixture(scope='module')
def jax_corpus():
    """(the corpus's four arrays, JAX's run_corpus result on it with one
    failure and one success replayed)."""
    orig, kept = jrf.collect_trajectories, {}

    def keep(*a, **k):
        kept['arrays'] = orig(*a, **k)
        return kept['arrays']
    jrf.collect_trajectories = keep
    try:
        out = jrf.run_corpus(B=B, T=T, key_seed=KEY_SEED, max_failures=1,
                             n_success=1, verbose=False)
    finally:
        jrf.collect_trajectories = orig
    acts, resets, dones, fails = kept['arrays']
    assert fails.any() and (dones & ~fails).any()
    return kept['arrays'], out


def port_run_corpus(monkeypatch, arrays, **kw):
    """The port's run_corpus with its collect returning `arrays`."""
    monkeypatch.setattr(trf, 'collect_trajectories', lambda *a, **k: arrays)
    return trf.run_corpus('hlg', B=B, T=T, seed=PORT_SEED, verbose=False,
                          device='cpu', **kw)


def test_replay_one_matches_jax(jax_corpus):
    """One failing and one successful episode's slot actions, replayed by
    the port's replay_one, give JAX's outcome dicts."""
    (acts, _, _, _), (_, fail_out, succ_out) = jax_corpus
    _, spec, init = bench.setup('hlg', jrf.BENCH_CAPS, 'cpu')
    assert len(fail_out) == len(succ_out) == 1
    for ref in fail_out + succ_out:
        ref = dict(ref)
        b, t, t0 = ref.pop('env'), ref.pop('t'), ref.pop('t0')
        got = trf.replay_one(tdiv.make_config('hlg'), spec, init,
                             acts[t0:t + 1, b], fail_step=t - t0,
                             device='cpu')
        assert got == ref
    assert fail_out[0]['jit_fail_at'] is not None
    assert succ_out[0]['host_result'] == 'in_lockstep'


def test_zero_budget_replays_no_success_on_either_side(jax_corpus,
                                                       monkeypatch):
    """The reference's budget also bounds the success sample: with
    budget_s=0 no success is replayed (nor a failure), on both sides. The
    port keeps this as parity."""
    arrays, _ = jax_corpus
    monkeypatch.setattr(jrf, 'collect_trajectories', lambda *a, **k: arrays)
    ref, _, _ = jrf.run_corpus(B=B, T=T, key_seed=KEY_SEED, budget_s=0,
                               n_success=1, verbose=False)
    got, _, _ = port_run_corpus(monkeypatch, arrays, budget_s=0, n_success=1)
    assert ref['successes_replayed'] == got['successes_replayed'] == 0
    assert ref['failures_replayed'] == got['failures_replayed'] == 0
    ref.pop('replay_wall_s')
    got.pop('replay_wall_s')
    assert got == ref
