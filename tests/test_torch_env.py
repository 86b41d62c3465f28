"""The port's batched environment (urban_tpu_torch.torchenv) against the JAX
environment, HLG scenario at the bench capacities.

The lockstep test feeds both packages the same actions, drawn with numpy
from the JAX land-use mask, through the batched step (make_batch_fns +
apply_stage_rewards, the JAX side under jax.jit), auto-resetting finished
episodes as the rollout does. Each step: observation masks and edges, every
int and bool PlanState field, the failure code and done flags are equal;
float fields and rewards agree within rtol=1e-5, atol=1e-4 (f32 sums taken
in another order; coordinates themselves come out bit for bit, since the
port rounds the reference's fused multiply-adds the same way)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.envs.plan_client import PlanClient
from urban_tpu.jaxenv import state as jstate
from urban_tpu.jaxenv import step as jstep
from urban_tpu.jaxenv.rollout import (apply_stage_rewards as j_apply,
                                      broadcast_state as j_broadcast,
                                      make_batch_fns as j_make)
from urban_tpu_torch.bench import BENCH_CAPS, load_config
from urban_tpu_torch.torchenv import geometry as tg
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv import step as tstep
from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                              broadcast_state, make_batch_fns,
                                              reset_done)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope='module')
def hlg():
    cfg = load_config('hlg')
    plc_j = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec_j = jstate.build_env_spec(cfg, plc_j,
                                   max_steps=cfg.max_sequence_length,
                                   caps=BENCH_CAPS)
    s0_j = jstate.build_initial_state(spec_j, plc_j)
    plc_t = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec_t = tstate.build_env_spec(cfg, plc_t,
                                   max_steps=cfg.max_sequence_length,
                                   caps=BENCH_CAPS)
    s0_t = tstate.build_initial_state(spec_t, plc_t)
    return spec_j, s0_j, spec_t, s0_t


def _jax_fields(state):
    return {k: np.asarray(getattr(state, k))
            for k in state.__dataclass_fields__}


def _assert_state_equal(j_fields, t_state, where=''):
    t_fields = tstate.plan_state_to_numpy(t_state)
    assert set(j_fields) == set(t_fields)
    for k, a in j_fields.items():
        b = t_fields[k]
        assert a.shape == b.shape, (where, k)
        if a.dtype.kind == 'f':
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f'{where} {k}')
        else:
            np.testing.assert_array_equal(b, a, err_msg=f'{where} {k}')


def _assert_obs_equal(oj, ot, where=''):
    for k, (a, b) in enumerate(zip(oj, ot)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == 'f':
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f'{where} obs[{k}]')
        else:
            np.testing.assert_array_equal(b, a, err_msg=f'{where} obs[{k}]')


def test_initial_state_matches_jax(hlg):
    spec_j, s0_j, spec_t, s0_t = hlg
    assert spec_t.num_features == spec_j.num_features == 1088
    for f in ('NP', 'KV', 'NS', 'NPT', 'NE', 'plan_order', 'skip_road',
              'road_network_weight', 'concepts'):
        assert getattr(spec_t, f) == getattr(spec_j, f), f
    j = _jax_fields(s0_j)
    t = tstate.plan_state_to_numpy(s0_t)
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_state_converter_round_trip(hlg):
    _, s0_j, _, s0_t = hlg
    back = tstate.plan_state_from_numpy(_jax_fields(s0_j), 'cpu')
    for name in tstate.FIELD_NAMES:
        assert torch.equal(getattr(back, name), getattr(s0_t, name)), name


def test_build_obs_matches_jax(hlg):
    spec_j, s0_j, spec_t, s0_t = hlg
    _assert_obs_equal(jstep.build_obs(spec_j, s0_j),
                      tstep.build_obs(spec_t, s0_t), 'initial')


def test_lockstep_batched_step(hlg):
    spec_j, s0_j, spec_t, s0_t = hlg
    B, T = 2, 12
    j_obs_fn, j_step_fn = j_make(spec_j)

    @jax.jit
    def j_step(s, a):
        n, r, d, info = j_step_fn(s, a)
        n, r = j_apply(spec_j, n, r, info)
        return n, r, d, info

    j_obs = jax.jit(j_obs_fn)
    j_lu_reward = jax.jit(jax.vmap(
        lambda s: jstep.land_use_stage_reward(spec_j, s)))
    t_obs, t_step = make_batch_fns(spec_t)
    t_lu_reward = torch.func.vmap(
        lambda s: tstep.land_use_stage_reward(spec_t, s))

    sj, st = j_broadcast(s0_j, B), broadcast_state(s0_t, B)
    init_j, init_t = j_broadcast(s0_j, B), broadcast_state(s0_t, B)
    rng = np.random.default_rng(0)
    n_lu_steps = 0
    for i in range(T):
        oj, ot = j_obs(sj), t_obs(st)
        _assert_obs_equal(oj, ot, f'step {i}')
        lu, stage = np.asarray(oj[6]), np.asarray(oj[8]).argmax(-1)
        acts = np.zeros((B, 2), np.int32)
        for b in range(B):
            if stage[b] == 0 and lu[b].any():
                acts[b, 0] = rng.choice(np.nonzero(lu[b])[0])
                n_lu_steps += 1
        nj, rj, dj, ij = j_step(sj, jnp.asarray(acts))
        nt, rt, dt, it = t_step(st, torch.as_tensor(acts))
        nt, rt = apply_stage_rewards(spec_t, nt, rt, it)
        j_fields = _jax_fields(nj)
        _assert_state_equal(j_fields, nt, f'step {i}')
        np.testing.assert_array_equal(it['failure_code'].numpy(),
                                      np.asarray(ij['failure_code']))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RTOL,
                                   atol=ATOL)
        # the stage reward on this step's state, converted from JAX's
        np.testing.assert_allclose(
            t_lu_reward(tstate.plan_state_from_numpy(j_fields, 'cpu')).numpy(),
            np.asarray(j_lu_reward(nj)), rtol=RTOL, atol=ATOL)
        done = np.asarray(dj)
        sj = jax.tree.map(
            lambda i0, x: jnp.where(jnp.asarray(done).reshape(
                (-1,) + (1,) * (x.ndim - 1)), i0, x), init_j, nj)
        st = reset_done(init_t, nt)
    assert n_lu_steps >= B * (T - 2)


def test_stage_reward_matches_jax_on_filled_plan(hlg):
    """Life-circle + greenness at a plan with residential, service and
    green parcels (the initial plan has none, so the reward would be 0)."""
    spec_j, s0_j, spec_t, _ = hlg
    fields = _jax_fields(s0_j)
    alive = np.nonzero(fields['poly_alive'])[0]
    rng = np.random.default_rng(1)
    types = fields['poly_type'].copy()
    types[alive] = rng.choice([4, 4, 4, 5, 6, 7, 8, 9, 10, 12], len(alive))
    fields['poly_type'] = types
    jr = float(jstep.land_use_stage_reward(
        spec_j, s0_j.replace(poly_type=jnp.asarray(types))))
    tr = float(tstep.land_use_stage_reward(
        spec_t, tstate.plan_state_from_numpy(fields, 'cpu')))
    assert jr > 0
    np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=ATOL)


def test_unported_rewards_raise(hlg):
    _, _, spec_t, s0_t = hlg
    road = spec_t.__class__(**{**spec_t.__dict__, 'skip_road': False,
                               'road_network_weight': 1.0})
    concept = spec_t.__class__(**{**spec_t.__dict__, 'concept_weight': 1.0,
                                  'concepts': ((0.0, 1.0, 1.0, 1.0, 1.0,
                                                10.0, 16.0),)})
    a = torch.zeros(2, dtype=torch.int32)
    for spec in (road, concept):
        with pytest.raises(NotImplementedError):
            tstep.env_step(spec, s0_t, a)
        with pytest.raises(NotImplementedError):
            tstep.land_use_stage_reward(spec, s0_t)


def test_jax_index_semantics():
    x = torch.arange(5) * 10
    assert tg.take(x, torch.tensor(-1)).item() == 40     # wraps
    assert tg.take(x, torch.tensor(9)).item() == 40      # clamps
    assert tg.set_at(x, torch.tensor(7), -1).tolist() == x.tolist()  # dropped
    placed = tg.onehot_place(torch.tensor([1., 2., 3.]),
                             torch.tensor([0, 5, -1]),
                             torch.tensor([True, True, True]), 3)
    assert placed.tolist() == [1.0, 0.0, 0.0]
    slots, ovf = tstep.free_slots(
        torch.tensor([True, False, True, False, False]), 2)
    assert slots.tolist() == [1, 3] and not bool(ovf)
    slots, ovf = tstep.free_slots(
        torch.tensor([True, False, True, False, False]), 4)
    assert slots.tolist() == [1, 3, 4, 5] and bool(ovf)


@pytest.mark.slow
def test_lockstep_full_episodes_seeds_100_109(hlg):
    """One env per seed 100-109, stepped in lockstep until every env has
    finished its first episode (HLG episodes take ~29 steps)."""
    spec_j, s0_j, spec_t, s0_t = hlg
    seeds = list(range(100, 110))
    B = len(seeds)
    j_obs_fn, j_step_fn = j_make(spec_j)

    @jax.jit
    def j_step(s, a):
        n, r, d, info = j_step_fn(s, a)
        n, r = j_apply(spec_j, n, r, info)
        return n, r, d, info

    j_obs = jax.jit(j_obs_fn)
    t_obs, t_step = make_batch_fns(spec_t)
    sj, st = j_broadcast(s0_j, B), broadcast_state(s0_t, B)
    rngs = [np.random.default_rng(s) for s in seeds]
    finished = np.zeros(B, bool)
    for i in range(60):
        oj, ot = j_obs(sj), t_obs(st)
        _assert_obs_equal(oj, ot, f'step {i}')
        lu, stage = np.asarray(oj[6]), np.asarray(oj[8]).argmax(-1)
        acts = np.zeros((B, 2), np.int32)
        for b in range(B):
            if stage[b] == 0 and lu[b].any():
                acts[b, 0] = rngs[b].choice(np.nonzero(lu[b])[0])
        nj, rj, dj, ij = j_step(sj, jnp.asarray(acts))
        nt, rt, dt, it = t_step(st, torch.as_tensor(acts))
        nt, rt = apply_stage_rewards(spec_t, nt, rt, it)
        _assert_state_equal(_jax_fields(nj), nt, f'step {i}')
        np.testing.assert_array_equal(it['failure_code'].numpy(),
                                      np.asarray(ij['failure_code']))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RTOL,
                                   atol=ATOL)
        # envs finished before this step stay frozen at their terminal state
        frozen = finished.copy()
        finished |= np.asarray(dj)
        if finished.all():
            break
        fj, ft = jnp.asarray(frozen), torch.as_tensor(frozen)
        sj = jax.tree.map(lambda old, new: jnp.where(
            fj.reshape((-1,) + (1,) * (new.ndim - 1)), old, new), sj, nj)
        st = tstate.PlanState(*(
            torch.where(ft.reshape((-1,) + (1,) * (getattr(nt, n).dim() - 1)),
                        getattr(st, n), getattr(nt, n))
            for n in tstate.FIELD_NAMES))
    assert finished.all()
