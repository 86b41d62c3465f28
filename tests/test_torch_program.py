"""The step program (urban_tpu_torch/torchenv/program.py), the port's
counterpart of the JAX rollout's single compiled program, on the CPU:

* the three rollouts rebuilt on it (rollout_bench, rollout,
  eval_rollout) give the bits of the eager loops they replaced, which
  this file keeps as the reference: HLG at 4 envs x 12 steps, and grid at
  2 envs that end their land use and their road stage, so that the stage
  rewards run between program steps;
* the actions a program run took, fed through JAX's batched step and
  stage rewards with the same auto-reset, give the port's observations,
  rewards, dones and final states (ints and bools equal, floats rtol 1e-5
  / atol 1e-4, PERF.md section 2's lockstep limits);
* what the rollouts return and record shares no memory with a program's
  buffers, which the next step overwrites;
* the trainer keys its programs on everything a capture holds;
* the captured region makes no host sync and copies nothing from the
  host, so that a CUDA graph can hold it.

The card-only test holds the captured graph against the eager loop:
    python -m pytest tests/test_torch_program.py -m gpu --noconftest
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from urban_tpu_torch import bench
from urban_tpu_torch.models.policy import uniform
from urban_tpu_torch.ops import segment_ops
from urban_tpu_torch.torchenv import road_fixtures as rf
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv.program import StepProgram
from urban_tpu_torch.torchenv.rollout import (FAILURE_BIT_NAMES,
                                              apply_stage_rewards,
                                              broadcast_state, eval_rollout,
                                              failure_histogram,
                                              make_batch_fns, reset_done,
                                              rollout, rollout_bench)
from urban_tpu_torch.torchenv.state import FIELD_NAMES, PlanState

torch.set_num_threads(1)

GRID_CAPS = dict(NP=128, NS=256, NPT=160, NE=1024)
HLG_ENVS, HLG_STEPS, GRID_STEPS = 4, 12, 6


# ---------------------------------------------------------------------------
# the eager loops that the step program replaced, as the reference
# ---------------------------------------------------------------------------

@torch.no_grad()
def ref_rollout_bench(spec, model, init_state, start_state, generator,
                      num_steps, record):
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    init_b = broadcast_state(init_state, B)
    use_mean = torch.zeros(B, dtype=torch.bool, device=dev)
    state = start_state
    n_eps = torch.zeros((), dtype=torch.int64, device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
    code_hist = torch.zeros(len(FAILURE_BIT_NAMES), dtype=torch.int64,
                            device=dev)
    for _ in range(num_steps):
        was_reset = state.done
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        action, _, _ = model.sample_action_logp_value(obs, generator,
                                                      use_mean)
        state, reward, done, info = batch_step(state, action)
        state, reward = apply_stage_rewards(spec, state, reward, info)
        record.append((action, was_reset, done, info['failure']))
        n_eps = n_eps + done.sum()
        n_fail = n_fail + info['failure'].sum()
        code_hist = code_hist + failure_histogram(info['failure_code'])
        reward_sum = reward_sum + torch.where(done & ~info['failure'],
                                              reward, 0.0).sum()
    return state, n_eps, n_fail, reward_sum, code_hist


@torch.no_grad()
def ref_rollout(spec, model, init_state, start_state, generator, num_steps,
                noise_rate):
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    init_b = broadcast_state(init_state, B)
    state, rows = start_state, []
    for _ in range(num_steps):
        state = reset_done(init_b, state)
        obs = batch_obs(state)
        use_mean = uniform((B,), generator, dev) >= noise_rate
        action, log_prob, value = model.sample_action_logp_value(
            obs, generator, use_mean)
        state, reward, done, info = batch_step(state, action)
        state, reward = apply_stage_rewards(spec, state, reward, info)
        rows.append((*obs, action, log_prob[..., 0], value[..., 0], reward,
                     done, info['failure'], (~use_mean).to(torch.float32),
                     info['failure_code']))
    return state, [torch.stack(x) for x in zip(*rows)]


@torch.no_grad()
def ref_eval_rollout(spec, model, start_state, generator, num_steps):
    batch_obs, batch_step = make_batch_fns(spec)
    B = start_state.stage.shape[0]
    dev = start_state.stage.device
    use_mean = torch.ones(B, dtype=torch.bool, device=dev)
    state = start_state
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        obs = batch_obs(state)
        action, _, _ = model.sample_action_logp_value(obs, generator,
                                                      use_mean)
        nxt, reward, _, info = batch_step(state, action)
        nxt, reward = apply_stage_rewards(spec, nxt, reward, info)
        frozen = state.done
        nxt = PlanState(*(
            torch.where(frozen.reshape((-1,) + (1,) * (new.dim() - 1)),
                        old, new)
            for old, new in ((getattr(state, n), getattr(nxt, n))
                             for n in FIELD_NAMES)))
        total = total + torch.where(frozen, 0.0, reward)
        state = nxt
    return state, total, state.done, state.failure


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def _fields(state):
    return [getattr(state, n) for n in FIELD_NAMES]


def _grid_start(spec, init):
    """Two grid envs: one placement from the end of its land use (every
    requirement met but one parcel; every other block given a seeded land
    use, so that the stage reward has something to score), and one in its
    road stage with a budget of a few roads
    (road_fixtures.road_stage_state)."""
    fields = tstate.plan_state_to_numpy(init)
    lu = {k: np.array(v) for k, v in fields.items()}
    blocks = np.nonzero(lu['poly_alive'])[0][::2]
    lu['poly_type'][blocks] = np.random.default_rng(0).choice(
        spec.plan_order, len(blocks))
    lu['plan_area'] = (np.asarray(spec.required_plan_ratio, np.float32)
                       * spec.community_area).astype(np.float32)
    lu['plan_count'] = np.asarray(spec.required_plan_count, np.int32).copy()
    counted = [t for t in spec.plan_order
               if spec.required_plan_count[t] > 0]
    lu['plan_count'][counted[-1]] -= 1
    rd = rf.road_stage_state(fields, spec.road_ratio, seed=2, frac=0.15)
    return tstate.plan_state_from_numpy(
        {k: np.stack([lu[k], rd[k]]) for k in fields}, 'cpu')


SCENARIOS = {}


def scenario(name):
    """(spec, initial state, model, start states, steps) on the CPU: HLG
    at the bench caps, every env starting fresh; grid at small caps from
    _grid_start."""
    if name not in SCENARIOS:
        if name == 'hlg':
            cfg, spec, init = bench.setup('hlg', None, 'cpu')
            start = broadcast_state(
                init.replace(done=torch.ones_like(init.done)), HLG_ENVS)
            steps = HLG_STEPS
        else:
            cfg, spec, init = bench.setup('grid', GRID_CAPS, 'cpu')
            start, steps = _grid_start(spec, init), GRID_STEPS
        model = bench.make_model(cfg, spec, 0, 'cpu')
        SCENARIOS[name] = (spec, init, model, start, steps)
    return SCENARIOS[name]


def run(name, kind, reference=False, program=None):
    """One rollout of `kind` on scenario `name` from a seeded generator,
    through the rollout functions (or the reference loops). Returns
    (final state fields, the other outputs flattened, the generator's
    state after)."""
    spec, init, model, start, steps = scenario(name)
    gen = torch.Generator().manual_seed(7)
    if kind == 'bench':
        record = []
        fn = ref_rollout_bench if reference else rollout_bench
        kw = {} if reference else {'program': program}
        out = fn(spec, model, init, start, gen, steps, record=record, **kw)
        rest = list(out[1:]) + [x for step in record for x in step]
    elif kind == 'collect':
        if reference:
            out = ref_rollout(spec, model, init, start, gen, steps, 0.5)
            rest = out[1]
        else:
            out = rollout(spec, model, init, start, gen, steps,
                          noise_rate=0.5, program=program)
            rest = list(out[1].obs) + list(out[1][1:])
    else:
        fresh = broadcast_state(init, start.stage.shape[0])
        if name == 'grid':
            fresh = start.replace(done=torch.zeros_like(start.done))
        if reference:
            out = ref_eval_rollout(spec, model, fresh, gen, steps)
        else:
            out = eval_rollout(spec, model, fresh, gen, steps,
                               program=program)
        rest = list(out[1:])
    return _fields(out[0]), rest, gen.get_state()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['bench', 'collect', 'eval'])
@pytest.mark.parametrize('name', ['hlg', 'grid'])
def test_program_rollouts_equal_the_eager_loops(name, kind):
    """The rollout rebuilt on the step program against the loop it
    replaced: the final state, every recorded or stored output (actions,
    trajectory, counters, the failure histogram, totals) and the
    generator's state after, bit for bit."""
    got = run(name, kind)
    want = run(name, kind, reference=True)
    for a, b in zip(got[:2], want[:2]):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), (name, kind, i)
    assert torch.equal(got[2], want[2])


def test_grid_window_runs_the_stage_rewards(monkeypatch):
    """The grid window above ends a land use and road stages without
    failure, so that apply_stage_rewards scores both kinds of stage end
    between program steps."""
    spec, init, model, start, steps = scenario('grid')
    seen = []

    def spy(spec_, states, reward, info):
        seen.append({k: info[k].clone() for k in ('lu_done', 'rd_done',
                                                  'failure')})
        return apply_stage_rewards(spec_, states, reward, info)
    import urban_tpu_torch.torchenv.rollout as rollout_mod
    monkeypatch.setattr(rollout_mod, 'apply_stage_rewards', spy)
    _, n_eps, n_fail, r_sum, _ = rollout_bench(
        spec, model, init, start, torch.Generator().manual_seed(7), steps)
    ok = [~s['failure'] for s in seen]
    assert any((s['lu_done'] & o).any() for s, o in zip(seen, ok))
    assert sum(int((s['rd_done'] & o).sum()) for s, o in zip(seen, ok)) >= 2
    assert int(n_eps) >= 2 and int(n_fail) == 0 and float(r_sum) > 0


@pytest.mark.parametrize('name', ['hlg', 'grid'])
def test_program_actions_step_jax_to_the_same_states(name):
    """The actions of a program-based collect, fed through JAX's batched
    step and stage rewards (tests/torch_parity.py's scenario pair) with
    the same auto-reset: each step's observation graph and masks, reward,
    done, failure and failure code, and the final states, agree. On grid
    the stage rewards and the auto-reset run inside the window."""
    import jax
    import jax.numpy as jnp
    from torch_parity import (ATOL, RTOL, assert_state_close, build_pair,
                              jax_state, j_apply, j_make)
    spec_t, init_t, model, start, steps = scenario(name)
    caps = bench.BENCH_CAPS if name == 'hlg' else GRID_CAPS
    spec_j, init_j, _, _ = build_pair(name, caps)
    final, traj = rollout(spec_t, model, init_t, start,
                          torch.Generator().manual_seed(7), steps,
                          noise_rate=0.5)
    j_obs_fn, j_step_fn = j_make(spec_j)
    init_b = jax.tree.map(lambda x: jnp.broadcast_to(
        x, (start.stage.shape[0],) + x.shape), init_j)

    @jax.jit
    def j_step(s, a):
        s = jax.tree.map(lambda i, x: jnp.where(
            s.done.reshape((-1,) + (1,) * (x.ndim - 1)), i, x), init_b, s)
        obs = j_obs_fn(s)
        n, r, d, info = j_step_fn(s, a)
        n, r = j_apply(spec_j, n, r, info)
        return obs, n, r, d, info

    sj = jax_state(tstate.plan_state_to_numpy(start))
    for t in range(steps):
        obs, sj, r, d, info = j_step(sj, jnp.asarray(traj.actions[t].numpy()))
        for k in (2, 4, 5, 6, 7, 8):
            np.testing.assert_array_equal(traj.obs[k][t].numpy(),
                                          np.asarray(obs[k]),
                                          err_msg=f'{name} step {t} obs[{k}]')
        np.testing.assert_allclose(traj.rewards[t].numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f'{name} step {t}')
        for got, want in ((traj.dones, d), (traj.failures, info['failure']),
                          (traj.failure_codes, info['failure_code'])):
            np.testing.assert_array_equal(got[t].numpy(), np.asarray(want),
                                          err_msg=f'{name} step {t}')
    assert_state_close({k: np.asarray(getattr(sj, k))
                        for k in sj.__dataclass_fields__}, final,
                       f'{name} final')
    if name == 'grid':   # both envs end their stages: rewards and resets
        assert traj.dones.any(), 'no episode ended in the window'


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


@pytest.mark.parametrize('kind', ['bench', 'collect', 'eval'])
def test_results_do_not_alias_the_program_buffers(kind):
    """What the rollouts return (final states, trajectory, totals) and
    record shares no memory with the program's input buffers or its
    outputs, and stays as it was after the program steps on."""
    spec, init, model, start, _ = scenario('hlg')
    B = start.stage.shape[0]
    program = StepProgram(spec, model, init, B, kind,
                          torch.Generator().manual_seed(7), noise_rate=0.5)
    state_b, rest_b, _ = run('hlg', kind, program=program)
    kept = [x.clone() for x in state_b + rest_b]
    held = _storages(_fields(program.state))
    run('hlg', kind, program=program)     # the program steps on
    held |= _storages(_fields(program.out['state']))
    held |= _storages(x for x in program.out.values()
                      if isinstance(x, torch.Tensor))
    assert not _storages(state_b + rest_b) & held
    for x, y in zip(state_b + rest_b, kept):
        assert torch.equal(x, y)


@pytest.fixture(scope='module')
def trainer(tmp_path_factory):
    from urban_tpu_torch.host.utils.config import Config
    from urban_tpu_torch.rl.trainer import Trainer
    root = str(tmp_path_factory.mktemp('program_cache'))
    return Trainer(Config('hlg', 0, root_dir=root), num_envs=2,
                   rollout_len=3, eval_envs=2, device='cpu')


@pytest.mark.parametrize('change', ['kind', 'batch', 'noise_rate', 'spec',
                                    'model'])
def test_trainer_programs_key_on_what_a_capture_holds(trainer, change):
    """Trainer.program returns the program it made for the same kind,
    spec, model, batch and noise_rate, and a new one when any of them
    changes; drop_programs frees them all."""
    trainer.drop_programs()
    spec, model = trainer.spec, trainer.model
    first = trainer.program('collect', 2)
    assert trainer.program('collect', 2) is first
    args = {'kind': ('eval', 2), 'batch': ('collect', 3),
            'noise_rate': ('collect', 2, 0.5)}.get(change, ('collect', 2))
    try:
        if change == 'spec':   # an equal spec is the same key
            trainer.spec = copy.deepcopy(spec)
            assert trainer.program(*args) is first
            trainer.spec = dataclasses.replace(
                spec, road_network_weight=spec.road_network_weight + 1.0)
        elif change == 'model':
            trainer.model = copy.deepcopy(model)
        other = trainer.program(*args)
    finally:
        trainer.spec, trainer.model = spec, model
    assert other is not first
    assert (other.kind, other.batch, other.noise_rate) == (
        args[0], args[1], args[2] if len(args) > 2 else 1.0)
    assert trainer.program('collect', 2) is first
    trainer.drop_programs()
    assert trainer.program('collect', 2) is not first


# the dispatcher ops that sync the host with the device or copy host data
# onto it: a tensor read as a Python value, nonzero (a data-dependent
# shape), and torch.tensor of host values (lift_fresh)
SYNC_OPS = ('_local_scalar_dense', 'item', 'is_nonzero', 'nonzero',
            'lift_fresh', 'masked_select', 'unique')


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__.split('.')[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('kind', ['bench', 'collect', 'eval'])
def test_captured_region_has_no_host_sync(kind):
    """After one step (the warm-up, which makes the cached constant
    tables), the step region runs no op that reads a tensor on the host or
    copies host data to the device: the condition for capturing it."""
    spec, init, model, start, _ = scenario('hlg')
    program = StepProgram(spec, model, init, 2, kind,
                          torch.Generator().manual_seed(7), noise_rate=0.5)
    program.run(broadcast_state(init.replace(
        done=torch.ones_like(init.done)), 2))
    log = _OpLog()
    with log:
        program._step()
    assert len(log.ops) > 1000
    assert not [op for op in log.ops if op in SYNC_OPS]


@pytest.mark.gpu
def test_graph_against_eager_on_card():
    """On a card: the HLG rollout bench (16 envs x 12 steps), collect and
    eval through the captured graph against the same program stepped
    eagerly, from one seed: every recorded action, the counters, the
    trajectories, the final states and the generator state equal; each
    replay counts the 2 forward launches its capture made (skips without
    a CUDA device; chip_smoke.py runs it at 256 envs x 30 steps)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    bench.set_precision_flags()
    dev = torch.device('cuda')
    cfg, spec, init = bench.setup('hlg', None, dev)
    model = bench.make_model(cfg, spec, 0, dev)
    B, T = 16, 12
    start = broadcast_state(init.replace(done=torch.ones_like(init.done)), B)
    results = []
    for eager in (True, False):
        gen = torch.Generator(device=dev).manual_seed(7)
        record = []
        segment_ops.reset_launches()
        out = rollout_bench(spec, model, init, start, gen, T, record=record,
                            eager=eager)
        launches = dict(segment_ops.launches)
        final, traj = rollout(spec, model, init, start, gen, T,
                              noise_rate=0.5, eager=eager)
        ev = eval_rollout(spec, model, broadcast_state(init, B), gen, T,
                          eager=eager)
        results.append(_fields(out[0]) + list(out[1:])
                       + [x for step in record for x in step]
                       + _fields(final) + list(traj.obs) + list(traj[1:])
                       + _fields(ev[0]) + list(ev[1:]) + [gen.get_state()])
        assert launches == {'segment_mean': 2 * T,
                            'segment_mean_backward': 0}
    for i, (a, b) in enumerate(zip(*results)):
        assert torch.equal(a.cpu(), b.cpu()), i
