"""The port's concept reward against the JAX one on hlg_concept and
dhm_concept (3 center/axis concepts each), and their lockstep.

concept_reward and land_use_stage_reward (which adds 3 x concept to 4 x
life circle + greenness) on the initial plan and on seeded plans with
random land uses on the alive polygons, per env and vmapped over a batch
as apply_stage_rewards calls it, within rtol 1e-5 / atol 1e-4. Then 2
envs x 8 steps of each scenario in lockstep (tests/torch_parity.py)."""
import numpy as np
import jax
import pytest
import torch

from torch_parity import (ATOL, RTOL, build_pair, check_scenario, jax_fields,
                          jax_state)
from urban_tpu.jaxenv import step as jstep
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv import step as tstep

torch.set_num_threads(1)

CAPS = dict(NP=128, NS=384, NPT=224)
LAND_USES = [4, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12]


def filled_plans(s0_j, n):
    """The initial plan and n seeded plans whose alive polygons take
    random land uses, as dicts of JAX field arrays."""
    fields = jax_fields(s0_j)
    alive = np.nonzero(fields['poly_alive'])[0]
    out = [fields]
    for seed in range(n):
        rng = np.random.default_rng(seed)
        f = dict(fields, poly_type=fields['poly_type'].copy())
        f['poly_type'][alive] = rng.choice(LAND_USES, len(alive))
        out.append(f)
    return out


@pytest.mark.parametrize('name', ['hlg_concept', 'dhm_concept'])
def test_concept_reward_matches_jax(name):
    spec_j, s0_j, spec_t, _ = build_pair(name, CAPS)
    assert len(spec_t.concepts) == 3 and spec_t.concept_weight == 3.0
    assert {c[0] for c in spec_t.concepts} == {0.0, 1.0}   # centers, axes
    plans = filled_plans(s0_j, 4)
    concept_j = jax.jit(lambda s: jstep.concept_reward(spec_j, s))
    stage_j = jax.jit(jax.vmap(
        lambda s: jstep.land_use_stage_reward(spec_j, s)))
    values = []
    for k, f in enumerate(plans):
        want = float(concept_j(jax_state(f)))
        got = float(tstep.concept_reward(
            spec_t, tstate.plan_state_from_numpy(f, 'cpu')))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f'plan {k}')
        values.append(want)
    assert len(set(np.round(values, 4))) > 1 and max(values) > 0
    batch = {k: np.stack([f[k] for f in plans]) for k in plans[0]}
    want = np.asarray(stage_j(jax_state(batch)))
    got = torch.func.vmap(lambda s: tstep.land_use_stage_reward(spec_t, s))(
        tstate.plan_state_from_numpy(batch, 'cpu')).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['hlg_concept', 'dhm_concept'])
def test_concept_scenario_lockstep(name):
    check_scenario(name, CAPS)
