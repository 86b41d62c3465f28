"""The port's road-network reward (urban_tpu_torch.torchenv.step) against
the JAX one, on the grid scenario (capacities cut to NP=128, NS=256,
NPT=160: the 240 x 240 raster of the face decomposition is the
scenario's own).

- _components_min_label: labels exactly equal, by both methods (boolean
  squaring, the card's default; propagation, the CPU's), on random graphs
  and on a 100-segment chain.
- _large_block_count: exactly equal on the initial plan (40 roads, no
  boundary), seeded subsets of its roads turned into boundaries, a
  serpentine corridor (several sweeps) and 1-3 diagonal roads (the
  diagonal branch), per env and batched.
- road_network_reward and batched_road_network_reward on those states and
  on a seeded batch of random networks: rtol 1e-5 / atol 1e-6.
- the trainer's reward channels on those states, as the JAX trainer's.
"""
import numpy as np
import jax
import pytest
import torch

from torch_parity import build_pair, jax_fields, jax_state
from urban_tpu.jaxenv import step as jstep
from urban_tpu.rl import train_tpu
from urban_tpu_torch.rl import trainer as ttrainer
from urban_tpu_torch.torchenv import road_fixtures as rf
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv import step as tstep

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CAPS = dict(NP=128, NS=256, NPT=160, NE=1024)


@pytest.fixture(scope='module')
def grid():
    spec_j, s0_j, spec_t, _ = build_pair('grid', CAPS)
    states = rf.reward_states(jax_fields(s0_j))
    names = list(states)
    batch = {k: np.stack([states[n][k] for n in names])
             for k in states[names[0]]}
    return spec_j, spec_t, names, batch


def _is_road(seg_alive, seg_type):
    return seg_alive & (seg_type == 2)


@pytest.mark.parametrize('method', ['squaring', 'propagation'])
def test_components_min_label_matches_jax(method):
    rng = np.random.default_rng(0)
    B, n = 6, 160
    adj = rng.random((B, n, n)) < 1.5 / n
    adj = adj | adj.transpose(0, 2, 1)
    active = rng.random((B, n)) < 0.8
    # a 100-segment chain in shuffled slots: 99 propagation hops apart
    perm = rng.permutation(n)[:100]
    chain = np.zeros((n, n), bool)
    chain[perm[:-1], perm[1:]] = chain[perm[1:], perm[:-1]] = True
    adj[0], active[0] = chain, np.isin(np.arange(n), perm)
    want = np.asarray(jax.jit(jax.vmap(jstep._components_min_label))(
        adj, active))
    got = tstep._components_min_label(torch.as_tensor(adj),
                                      torch.as_tensor(active), method)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0][perm] == perm.min()).all()
    assert len(np.unique(want[1:][active[1:]])) > B


def test_large_block_count_matches_jax(grid):
    spec_j, spec_t, names, batch = grid
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jstep._large_block_count(
            spec_j, s, _is_road(s.seg_alive, s.seg_type))))(jax_state(batch)))
    st = tstate.plan_state_from_numpy(batch, 'cpu')
    is_road = _is_road(st.seg_alive, st.seg_type)
    got = tstep._large_block_count(spec_t, st.seg, is_road)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, name in enumerate(names):      # alone, as a batch of one
        one = tstep._large_block_count(spec_t, st.seg[i:i + 1],
                                       is_road[i:i + 1])
        assert int(one[0]) == want[i], name
    by_name = dict(zip(names, want.tolist()))
    assert by_name['initial'] == 0 and by_name['serpentine'] == 1
    assert by_name['diagonal_1'] == 2 and max(by_name.values()) >= 1


def test_road_network_reward_matches_jax(grid):
    spec_j, spec_t, names, batch = grid
    rng_batch = rf.random_road_states(
        {k: v[0] for k, v in batch.items()}, seed=5, batch=6)
    reward_j = jax.jit(jax.vmap(lambda s: jstep.road_network_reward(spec_j,
                                                                    s)))
    for what, b in (('named', batch), ('random', rng_batch)):
        want = np.asarray(reward_j(jax_state(b)))
        st = tstate.plan_state_from_numpy(b, 'cpu')
        got, counts = tstep.batched_road_network_reward(spec_t, st,
                                                        with_counts=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
        assert len(np.unique(np.round(want, 5))) > 2, what
        assert counts['components'].min() >= 1
        for i in range(len(want)):
            one = tstep.road_network_reward(spec_t, st.map(lambda x: x[i]))
            np.testing.assert_allclose(float(one), want[i], rtol=RTOL,
                                       atol=ATOL, err_msg=f'{what} {i}')
    with pytest.raises(RuntimeError, match='vmap'):
        torch.func.vmap(lambda s: tstep.road_network_reward(spec_t, s))(st)


def test_reward_channels_match_jax_trainer(grid):
    spec_j, spec_t, _, batch = grid
    want = train_tpu._reward_channels(spec_j, jax_state(batch))
    got = ttrainer._reward_channels(
        spec_t, tstate.plan_state_from_numpy(batch, 'cpu'))
    for name, a, b in zip(('life_circle', 'greenness', 'road'), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(np.asarray(want[2]).min()) > 0
