"""The port's road stage against the JAX one, in lockstep (grid scenario).

A grid state at the start of its road stage: seeded roads of the initial
plan turned into boundaries, stage 1, the road budget floor(boundaries x
0.8) (torchenv/road_fixtures.road_stage_state); one such state per env.
Both packages step 2 envs through make_batch_fns + apply_stage_rewards
with the same road actions, drawn with numpy from the JAX road mask, until
both finish (rd_done): every int and bool field equal, floats and rewards
within rtol 1e-5 / atol 1e-4 (tests/torch_parity.py), and each episode
ends without failure with its road reward in (0, 1].

The slow test runs full two-stage grid episodes (land use, then roads) at
the JAX trainer's capacities, one env per seed 100-104."""
import numpy as np
import pytest
import torch

from torch_parity import build_pair, jax_fields, jax_state, lockstep
from urban_tpu.jaxenv.rollout import broadcast_state as j_broadcast
from urban_tpu_torch.torchenv import road_fixtures as rf
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv.rollout import broadcast_state

torch.set_num_threads(1)

CAPS = dict(NP=128, NS=256, NPT=160, NE=1024)


def test_road_stage_lockstep():
    spec_j, s0_j, spec_t, _ = build_pair('grid', CAPS)
    init = jax_fields(s0_j)
    states = [rf.road_stage_state(init, spec_t.road_ratio, seed)
              for seed in (0, 1)]
    batch = {k: np.stack([s[k] for s in states]) for k in init}
    budget = batch['total_road_steps']
    assert (budget >= 5).all() and budget[0] != budget[1]
    rngs = [np.random.default_rng(b) for b in range(2)]
    steps = lockstep(spec_j, jax_state(batch), spec_t,
                     tstate.plan_state_from_numpy(batch, 'cpu'), rngs,
                     int(budget.max()) + 2, freeze_done=True, where='road')
    reward, done, failure, _, rd_done = (np.stack(x) for x in zip(*steps))
    assert rd_done.any(0).all() and not failure.any()
    final = reward[rd_done]
    assert final.shape == (2,) and ((final > 0) & (final <= 1)).all()
    # each env finished at its own budget
    np.testing.assert_array_equal(rd_done.argmax(0) + 1, budget)


@pytest.mark.slow
def test_grid_two_stage_lockstep_seeds_100_104():
    """One env per seed 100-104 from the initial grid plan, at the JAX
    trainer's capacities (NP=640, NS=1280, NPT=768), stepped until every
    env has finished its first episode (about 46 land-use and 55 road
    steps)."""
    spec_j, s0_j, spec_t, s0_t = build_pair('grid')
    seeds = list(range(100, 105))
    B = len(seeds)
    rngs = [np.random.default_rng(s) for s in seeds]
    steps = lockstep(spec_j, j_broadcast(s0_j, B), spec_t,
                     broadcast_state(s0_t, B), rngs, 160, freeze_done=True,
                     where='grid')
    reward, done, failure, lu_done, rd_done = (np.stack(x)
                                               for x in zip(*steps))
    assert done.any(0).all()
    print('grid two-stage lockstep: steps', len(steps), 'lu_done at',
          lu_done.argmax(0).tolist(), 'rd_done', rd_done.any(0).tolist(),
          'failed', failure.any(0).tolist(), 'road rewards',
          reward[rd_done].tolist())
