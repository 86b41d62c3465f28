"""Shared helpers of the port-vs-JAX environment tests (not a test module):
building a scenario in both packages, converting states, and stepping a
batch of envs in lockstep through each package's batched step
(make_batch_fns + apply_stage_rewards, the JAX side under jax.jit)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from urban_tpu.envs.plan_client import PlanClient
from urban_tpu.jaxenv import state as jstate
from urban_tpu.jaxenv.rollout import (apply_stage_rewards as j_apply,
                                      broadcast_state as j_broadcast,
                                      make_batch_fns as j_make)
from urban_tpu_torch.bench import load_config
from urban_tpu_torch.host.envs.plan_client import (
    PlanClient as TorchPlanClient)
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                              broadcast_state, make_batch_fns)

RTOL, ATOL = 1e-5, 1e-4


def build_pair(name, caps=None):
    """(spec_j, state_j, spec_t, state_t) of scenario `name` at caps (the
    JAX trainer's defaults when None), the port's state on the CPU."""
    cfg = load_config(name)
    plc_j = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec_j = jstate.build_env_spec(cfg, plc_j,
                                   max_steps=cfg.max_sequence_length,
                                   caps=caps)
    plc_t = TorchPlanClient(cfg.objectives_plan, cfg.init_plan)
    spec_t = tstate.build_env_spec(cfg, plc_t,
                                   max_steps=cfg.max_sequence_length,
                                   caps=caps)
    return (spec_j, jstate.build_initial_state(spec_j, plc_j), spec_t,
            tstate.build_initial_state(spec_t, plc_t, device='cpu'))


def jax_fields(state):
    return {k: np.asarray(getattr(state, k))
            for k in state.__dataclass_fields__}


def jax_state(fields):
    """A JAX PlanState from numpy arrays under its field names."""
    return jstate.PlanState(**{k: jnp.asarray(v) for k, v in fields.items()})


def assert_state_close(j_fields, t_state, where=''):
    """Int and bool fields equal, floats within RTOL / ATOL."""
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


def lockstep(spec_j, sj, spec_t, st, rngs, steps, freeze_done=False,
             where='', defer_rewards=True, with_states=False):
    """Step the batched states sj (JAX) and st (port) in lockstep for up to
    `steps` steps with the same actions: env b draws, with rngs[b], a
    land-use action from the JAX land-use mask in stage 0 and a road
    action from the JAX road mask in stage 1. Each step the observation's
    edges and masks, every state field, the failure code, done and the
    reward agree (RTOL / ATOL for floats). With freeze_done, finished envs
    keep their terminal state and the loop ends when all have finished.
    With defer_rewards False, both packages step through
    make_batch_fns(spec, defer_rewards=False), whose steps return the stage
    rewards themselves, and the info's cached land-use reward must agree
    too. Returns the per-step (reward, done, failure, lu_done, rd_done),
    numpy arrays from the JAX side; with with_states, also the last
    batched states of each package (JAX, port)."""
    j_obs_fn, j_step_fn = j_make(spec_j, defer_rewards=defer_rewards)

    @jax.jit
    def j_step(s, a):
        n, r, d, info = j_step_fn(s, a)
        if defer_rewards:
            n, r = j_apply(spec_j, n, r, info)
        return n, r, d, info

    j_obs = jax.jit(j_obs_fn)
    t_obs, t_step = make_batch_fns(spec_t, defer_rewards=defer_rewards)
    B = len(rngs)
    finished = np.zeros(B, bool)
    out = []
    for i in range(steps):
        oj, ot = j_obs(sj), t_obs(st)
        for k in (2, 4, 5, 6, 7, 8):
            np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]),
                                          err_msg=f'{where} step {i} obs[{k}]')
        lu, rd = np.asarray(oj[6]), np.asarray(oj[7])
        stage = np.asarray(oj[8]).argmax(-1)
        acts = np.zeros((B, 2), np.int32)
        for b in range(B):
            if finished[b]:
                continue
            if stage[b] == 0 and lu[b].any():
                acts[b, 0] = rngs[b].choice(np.nonzero(lu[b])[0])
            elif stage[b] == 1 and rd[b].any():
                acts[b, 1] = rngs[b].choice(np.nonzero(rd[b])[0])
        nj, rj, dj, ij = j_step(sj, jnp.asarray(acts))
        nt, rt, dt, it = t_step(st, torch.as_tensor(acts))
        if defer_rewards:
            nt, rt = apply_stage_rewards(spec_t, nt, rt, it)
        else:
            np.testing.assert_allclose(
                it['land_use_reward'].numpy(),
                np.asarray(ij['land_use_reward']), rtol=RTOL, atol=ATOL,
                err_msg=f'{where} step {i} info land_use_reward')
        assert_state_close(jax_fields(nj), nt, f'{where} step {i}')
        np.testing.assert_array_equal(it['failure_code'].numpy(),
                                      np.asarray(ij['failure_code']),
                                      err_msg=f'{where} step {i}')
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RTOL,
                                   atol=ATOL, err_msg=f'{where} step {i}')
        live = ~finished
        out.append(tuple(np.where(live, np.asarray(x), False if
                                  np.asarray(x).dtype == bool else 0.0)
                         for x in (rj, dj, ij['failure'], ij['lu_done'],
                                   ij['rd_done'])))
        if not freeze_done:
            sj, st = nj, nt
            continue
        frozen = finished.copy()
        finished |= np.asarray(dj)
        fj, ft = jnp.asarray(frozen), torch.as_tensor(frozen)
        sj = jax.tree.map(lambda old, new: jnp.where(
            fj.reshape((-1,) + (1,) * (new.ndim - 1)), old, new), sj, nj)
        st = tstate.PlanState(*(
            torch.where(ft.reshape((-1,) + (1,) * (getattr(nt, n).dim() - 1)),
                        getattr(st, n), getattr(nt, n))
            for n in tstate.FIELD_NAMES))
        if finished.all():
            break
    return (out, sj, st) if with_states else out


def check_scenario(name, caps, steps=8, B=2):
    """Scenario `name` at caps: spec and initial state equal in both
    packages, then `steps` lockstep steps of B envs from the initial
    state."""
    spec_j, s0_j, spec_t, s0_t = build_pair(name, caps)
    for f in ('NP', 'KV', 'NS', 'NPT', 'NE', 'plan_order', 'skip_road',
              'concept_weight', 'concepts', 'grid_cols', 'grid_rows'):
        assert getattr(spec_t, f) == getattr(spec_j, f), f
    j0, t0 = jax_fields(s0_j), tstate.plan_state_to_numpy(s0_t)
    for k in j0:
        np.testing.assert_array_equal(t0[k], j0[k], err_msg=k)
    rngs = [np.random.default_rng(b) for b in range(B)]
    lockstep(spec_j, j_broadcast(s0_j, B), spec_t,
             broadcast_state(s0_t, B), rngs, steps, where=name)
    return spec_j, s0_j, spec_t, s0_t
