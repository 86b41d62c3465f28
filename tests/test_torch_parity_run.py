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
        'separate_train': False, 'warm_start_phase2': True,
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


# grid's two-phase curriculum at 2 envs x the phase's 60 steps, one eval
# env, seed 0, whose greedy land-use eval succeeds at iteration 0 on the
# CPU (so that the freeze has a plan)
TWO_PHASE = ['--cfg', 'grid', '--separate_train', '--global_seed', '0',
             '--num_envs', '2', '--eval_envs', '1', '--rollout_len', '60',
             '--device', 'cpu']


def _two_phase_chunk(root, stats, iterations, *flags):
    return parity_run.main(['--iterations', str(iterations), '--root_dir',
                            str(root), '--stats', str(stats), *flags,
                            *TWO_PHASE])


def _check_resumed_road_phase(models, resumed, entries, cut):
    """The chunk resumed from a phase-2 final.pt of iteration `cut`: it
    starts at cut + 1 on the checkpoint's parameters (the warm start's,
    where the cut was at phase 2's first iteration), in phase 2, and its
    summary carries phase 1's best and the warm start."""
    assert resumed['iterations'][0] == cut + 1
    assert resumed['phase'] == 2 and resumed['warm_start'] == [30, 30]
    phase1 = read_checkpoint(os.path.join(models, 'phase1_final.pt'))
    assert resumed['phase1'] == {'best_reward': phase1['best_reward'],
                                 'best_iteration': phase1['best_iteration'],
                                 'iteration': phase1['iteration']}
    assert phase1['best_reward'] > 0 and phase1['phase'] == 1
    iteration, params = entries[0]
    assert iteration == cut + 1
    return phase1, params


def _entry_params(monkeypatch):
    """Record (iteration, parameters) at each train_iteration's entry."""
    seen = []
    train_iteration = Trainer.train_iteration

    def recorded(self, iteration, do_eval=True):
        seen.append((iteration, {k: v.clone() for k, v in
                                 self.model.state_dict().items()}))
        return train_iteration(self, iteration, do_eval)
    monkeypatch.setattr(Trainer, 'train_iteration', recorded)
    return seen


def test_two_phase_rehearsal_resumes_across_the_freeze(tmp_path,
                                                       monkeypatch):
    """--separate_train with --iterations 1 (a phase): the chunk runs phase
    1's iteration 0, freezes its best plan with the warm start, and its
    --deadline cuts it at phase 2's first iteration, which saves final.pt
    in phase 2 with iteration 0 and the warm-started parameters (phase
    1's best, every tensor copied). The next chunk resumes there: phase 2,
    iteration 1, on those parameters; each line names its phase and the
    road phase's line times its road reward."""
    stats, root = tmp_path / 'stats.jsonl', tmp_path / 'run'
    models = os.path.join(str(root), 'grid', '0', 'models')
    first = _two_phase_chunk(root, stats, 1, '--deadline', '1e-3')
    assert first['iterations'] == [0] and first['stopped_at_deadline']
    assert first['phase'] == 2 and first['warm_start'] == [30, 30]
    assert first['effective']['separate_train']
    assert first['effective']['warm_start_phase2']
    final = read_checkpoint(os.path.join(models, 'final.pt'))
    assert final['phase'] == 2 and final['iteration'] == 0
    assert final['frozen_table'] is not None
    assert tuple(final['warm_start']) == (30, 30)

    entries = _entry_params(monkeypatch)
    second = _two_phase_chunk(root, stats, 1, '--resume',
                              os.path.join(models, 'final.pt'))
    assert second['iterations'] == [1] and not second['stopped_at_deadline']
    phase1, params = _check_resumed_road_phase(models, second, entries, 0)
    assert first['phase1'] == second['phase1']
    for k, v in phase1['best_params'].items():
        assert torch.equal(params[k], v), k
        assert torch.equal(final['params'][k], v), k

    lines = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [(x.get('iteration'), x.get('phase')) for x in lines] == [
        (0, 1), (None, None), (1, 2), (None, None)]
    road = lines[2]
    assert 'road_reward_s' not in lines[0]
    assert road['road_reward_calls']['collect'] >= 1
    assert road['road_reward_calls']['eval'] >= 1
    assert road['episodes'] >= 1


@pytest.mark.slow
def test_two_phase_deadline_in_phase_1_then_across_the_freeze(tmp_path,
                                                              monkeypatch):
    """--iterations 2 a phase in three chunks: the first cut by its
    deadline in phase 1 (iteration 0 alone, final.pt in phase 1); the
    second resumes it (iteration 1), freezes and is cut at phase 2's
    first iteration; the third runs phase 2's iterations 2 and 3 on the
    warm-started parameters. ~4 min on the CPU."""
    stats, root = tmp_path / 'stats.jsonl', tmp_path / 'run'
    models = os.path.join(str(root), 'grid', '0', 'models')
    final = os.path.join(models, 'final.pt')
    first = _two_phase_chunk(root, stats, 2, '--deadline', '1e-3')
    assert first['iterations'] == [0] and first['phase'] == 1
    assert first['phase1'] is None and first['warm_start'] is None
    assert read_checkpoint(final)['phase'] == 1
    second = _two_phase_chunk(root, stats, 2, '--deadline', '1e-3',
                              '--resume', final)
    assert second['iterations'] == [1] and second['phase'] == 2
    assert read_checkpoint(final)['iteration'] == 1
    entries = _entry_params(monkeypatch)
    third = _two_phase_chunk(root, stats, 2, '--resume', final)
    assert third['iterations'] == [2, 3]
    phase1, params = _check_resumed_road_phase(models, third, entries, 1)
    for k, v in phase1['best_params'].items():
        assert torch.equal(params[k], v), k
    lines = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [x.get('phase') for x in lines if 'iteration' in x] == \
        [1, 1, 2, 2]
    assert os.path.exists(os.path.join(models, 'phase2_final.pt'))
