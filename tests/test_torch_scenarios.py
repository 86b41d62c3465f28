"""The port's batched environment against the JAX environment on the
land-use-only scenarios dhm and huizhou (life circle and greenness), and
the reference-layout observation build_obs_packed with its action
translation packed_action_to_slots.

For each scenario: the spec and the initial state agree exactly, then 2
envs step 8 times in lockstep through make_batch_fns + apply_stage_rewards
with the same actions, drawn with numpy from the JAX land-use mask (the
JAX side under jax.jit), as tests/test_torch_env.py does for HLG. Int and
bool fields, failure codes and done flags are equal; floats and rewards
agree within rtol 1e-5 / atol 1e-4. Capacities are cut to what 8 steps can
use (NP=128, NS=384, NPT=224), so that each case stays short on one
thread. hlg_concept and dhm_concept are in tests/test_torch_concept.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parity import ATOL, RTOL, build_pair, check_scenario, jax_fields
from urban_tpu.jaxenv import step as jstep
from urban_tpu.jaxenv.rollout import packed_action_to_slots as j_slots
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv import step as tstep
from urban_tpu_torch.torchenv.rollout import packed_action_to_slots

torch.set_num_threads(1)

CAPS = dict(NP=128, NS=384, NPT=224)


@pytest.mark.parametrize('name', ['dhm', 'huizhou'])
def test_scenario_lockstep(name):
    check_scenario(name, CAPS)


def _packed_states(spec_j, s0_j):
    """The initial state and the state after 3 land-use steps (JAX)."""
    step = jax.jit(lambda s, a: jstep.env_step(spec_j, s, a))
    obs = jax.jit(lambda s: jstep.build_obs(spec_j, s))
    rng = np.random.default_rng(3)
    out, s = [s0_j], s0_j
    for _ in range(3):
        lu = np.asarray(obs(s)[6])
        s = step(s, jnp.asarray([rng.choice(np.nonzero(lu)[0]), 0],
                                dtype=jnp.int32))[0]
    return out + [s]


def test_build_obs_packed_and_action_translation():
    """build_obs_packed equal to the JAX one on HLG (capacities cut so that
    max_num_nodes fits the feature slots) before and after land-use
    steps, and packed_action_to_slots maps packed indices as the JAX one
    does, masked actions and the padding included."""
    spec_j, s0_j, spec_t, _ = build_pair('hlg', dict(NP=256, NS=512,
                                                     NPT=320))
    assert spec_t.max_num_nodes <= spec_t.num_features
    obs_j = jax.jit(lambda s: jstep.build_obs_packed(spec_j, s))
    slots_j = jax.jit(lambda s, a: j_slots(spec_j, s, a))
    for k, sj in enumerate(_packed_states(spec_j, s0_j)):
        st = tstate.plan_state_from_numpy(jax_fields(sj), 'cpu')
        oj, ot = obs_j(sj), tstep.build_obs_packed(spec_t, st)
        for i, (a, b) in enumerate(zip(oj, ot)):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (k, i)
            if a.dtype.kind == 'f':
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                           err_msg=f'state {k} obs[{i}]')
            else:
                np.testing.assert_array_equal(b, a,
                                              err_msg=f'state {k} obs[{i}]')
        lu = np.asarray(oj[6])
        n_nodes = int(np.asarray(oj[4]).sum())
        picks = list(np.nonzero(lu)[0][:6]) + [0, spec_t.max_num_edges - 1]
        for e in picks:
            for n in (0, n_nodes - 1, n_nodes, spec_t.max_num_nodes - 1):
                a = np.array([e, n], np.int32)
                np.testing.assert_array_equal(
                    packed_action_to_slots(spec_t, st,
                                           torch.as_tensor(a)).numpy(),
                    np.asarray(slots_j(sj, jnp.asarray(a))))
