"""The port's GA path (urban_tpu_torch.models.baseline.ga_logits,
rl.ga.GA / make_ga_population_fitness, train_ga, host.io.geojson) against
the JAX package's on the CPU.

- ga_logits against ga_logits_jax on the slot-layout observations of HLG
  (land use) and grid (land use, and the start of its road stage), for a
  population of seeded genes: atol 1e-5 (f32 sums of ~16 products of
  genes up to 5 and features up to ~1, in another order);
- GA.run with the same fitness function gives the JAX GA's populations
  exactly (both are numpy on one seed);
- the greedy population fitness on HLG, 45 steps (as
  tests/test_ga_vmap.py): within 1e-5 of JAX's (f32 episode rewards);
- the train_ga CLI on the CPU: one generation of 4, its GeoJSON export
  read back;
- the population's rollout through its step program (kind 'ga', the
  counterpart of JAX's jitted run_population), with the generator
  reseeded between two populations, against the eager loop it replaced
  (kept here): the final states, the fitness accumulators and the
  generator's state, bit for bit; its region runs no op that syncs the
  host (tests/test_torch_program.py's SYNC_OPS), greedy and sampled.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.models.baseline import ga_logits_jax
from urban_tpu.rl import ga as jga
from urban_tpu_torch import bench
from urban_tpu_torch.models.baseline import ga_logits
from urban_tpu_torch.rl import ga as tga
from urban_tpu_torch.torchenv import road_fixtures
from urban_tpu_torch.torchenv import state as tstate
from urban_tpu_torch.torchenv.program import StepProgram
from urban_tpu_torch.torchenv.rollout import (apply_stage_rewards,
                                              broadcast_state, eval_rollout,
                                              make_batch_fns)
from urban_tpu_torch.torchenv.state import FIELD_NAMES, PlanState

torch.set_num_threads(1)

ATOL = 1e-5
GENES = 47


def _obs(name, stage):
    """Slot-layout observations of 3 envs of `name` at the JAX trainer's
    capacities: the initial state, or (road) seeded starts of the road
    stage."""
    _, spec, init = bench.setup(name, {}, 'cpu')
    if stage == 'land_use':
        states = broadcast_state(init, 3)
    else:
        init_np = tstate.plan_state_to_numpy(init)
        rows = [road_fixtures.road_stage_state(init_np, spec.road_ratio, s)
                for s in range(3)]
        states = tstate.plan_state_from_numpy(
            {k: np.stack([r[k] for r in rows]) for k in init_np}, 'cpu')
    return make_batch_fns(spec)[0](states)


@pytest.mark.parametrize('name,stage', [('hlg', 'land_use'),
                                        ('grid', 'land_use'),
                                        ('grid', 'road')])
def test_ga_logits_match_jax(name, stage):
    obs = _obs(name, stage)
    mask = obs[6] if stage == 'land_use' else obs[7]
    assert bool(mask.any(dim=-1).all())
    genes = np.random.default_rng(3).uniform(-5, 5, size=(3, GENES))
    lu, rd = ga_logits(obs, torch.as_tensor(genes, dtype=torch.float32))
    for p in range(3):
        j_lu, j_rd = ga_logits_jax(
            tuple(jnp.asarray(o[p].numpy()) for o in obs),
            jnp.asarray(genes[p], dtype=jnp.float32))
        np.testing.assert_allclose(lu[p].numpy(), np.asarray(j_lu), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(rd[p].numpy(), np.asarray(j_rd), rtol=0,
                                   atol=ATOL)
        head = lu[p] if stage == 'land_use' else rd[p]
        j_head = j_lu if stage == 'land_use' else j_rd
        assert int(torch.argmax(torch.where(mask[p], head, -torch.inf))) \
            == int(jnp.argmax(jnp.where(jnp.asarray(mask[p].numpy()),
                                        j_head, -jnp.inf)))


def test_ga_run_matches_jax():
    def fitness(pop):
        return -((np.asarray(pop) - 1.0) ** 2).sum(axis=1)

    runs = {}
    for name, mod in (('jax', jga), ('port', tga)):
        seen = []
        ga = mod.GA(mod.GAConfig(num_generations=6, sol_per_pop=7,
                                 num_genes=9, seed=5),
                    fitness_func=None, population_fitness_func=fitness,
                    on_generation=lambda g: seen.append(g.population.copy()))
        ga.run()
        runs[name] = (seen, ga.best_solutions_fitness, ga.best_solution())
    (s_j, f_j, b_j), (s_t, f_t, b_t) = runs['jax'], runs['port']
    assert len(s_t) == len(s_j) == 6
    for a, b in zip(s_t, s_j):
        np.testing.assert_array_equal(a, b)
    assert f_t == f_j
    np.testing.assert_array_equal(b_t[0], b_j[0])
    assert b_t[1:] == b_j[1:]


def test_ga_population_fitness_matches_jax(tmp_path):
    """Three greedy genes on HLG for 45 steps."""
    from urban_tpu.envs.plan_client import PlanClient as JPlanClient
    from urban_tpu.jaxenv.state import (build_env_spec as j_spec,
                                        build_initial_state as j_init)
    from urban_tpu.utils.config import Config as JConfig
    from urban_tpu_torch.host.envs.plan_client import PlanClient
    from urban_tpu_torch.host.utils.config import Config
    genes = np.random.default_rng(0).uniform(-5, 5, size=(3, GENES))
    jcfg = JConfig('hlg', 111, root_dir=str(tmp_path / 'jax'), agent='ga')
    jplc = JPlanClient(jcfg.objectives_plan, jcfg.init_plan)
    jspec = j_spec(jcfg, jplc, max_steps=jcfg.max_sequence_length)
    want = jga.make_ga_population_fitness(
        jspec, j_init(jspec, jplc), num_steps=45, mean_action=True,
        seed=111)(genes)
    cfg = Config('hlg', 111, root_dir=str(tmp_path / 'port'), agent='ga')
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    spec = tstate.build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length)
    got = tga.make_ga_population_fitness(
        spec, tstate.build_initial_state(spec, plc, device='cpu'),
        num_steps=45, mean_action=True, seed=111, device='cpu')(genes)
    assert got.shape == (3,) and got.dtype == np.float32
    assert (got > 0).any()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_train_ga_cli_exports_geojson(tmp_path):
    """Seed 0: at the README's seed 111 the best of 4 random genes plays a
    greedy host episode that fails (in the JAX agent too), and a failed
    episode has no plan to export."""
    from urban_tpu_torch import train_ga
    from urban_tpu_torch.host.io.geojson import load_geojson
    path = str(tmp_path / 'plan.geojson')
    agent, ga, plan = train_ga.main([
        '--cfg', 'hlg', '--global_seed', '0', '--num_generations', '1',
        '--sol_per_pop', '4', '--device', 'cpu', '--root_dir',
        str(tmp_path), '--export_geojson', path])
    assert ga.generations_completed == 1
    assert ga.population.shape == (4, 2 * agent.node_dim + 1)
    assert np.isfinite(ga.best_solutions_fitness).all()
    best, fitness = agent.load_ga()
    np.testing.assert_array_equal(best, ga.best_solution()[0])
    assert 'gdf' in plan
    table = load_geojson(path)
    want = plan['gdf']
    assert len(table) == len(want) > 0
    np.testing.assert_array_equal(table.ids, want.ids)
    np.testing.assert_array_equal(table.types, want.types)
    np.testing.assert_array_equal(table.existence, want.existence)
    for a, b in zip(table.geoms, want.geoms):
        assert a.kind == b.kind
        np.testing.assert_allclose(a.coords, b.coords, rtol=0, atol=1e-9)
    assert os.path.exists(os.path.join(agent.cfg.model_dir, 'best.p'))


PROGRAM_GENES, PROGRAM_STEPS = 3, 12


@torch.no_grad()
def ref_population_rollout(spec, init_state, genes, num_steps, mean_action,
                           generator):
    """The eager loop of make_ga_population_fitness before the step
    program: (final state, fitness accumulator)."""
    batch_obs, batch_step = make_batch_fns(spec)
    P = genes.shape[0]
    state = broadcast_state(init_state, P)
    acc = torch.zeros(P, dtype=torch.float32)
    for _ in range(num_steps):
        obs = batch_obs(state)
        lu_logits, rd_logits = ga_logits(obs, genes)
        lu_l = torch.where(obs[6], lu_logits, -torch.inf)
        rd_l = torch.where(obs[7], rd_logits, -torch.inf)
        if mean_action:
            lu, rd = torch.argmax(lu_l, dim=-1), torch.argmax(rd_l, dim=-1)
        else:
            lu = tga.categorical_sample(lu_l, generator)
            rd = tga.categorical_sample(rd_l, generator)
        action = torch.stack([lu, rd], dim=-1).to(torch.int32)
        nxt, reward, _, info = batch_step(state, action)
        nxt, reward = apply_stage_rewards(spec, nxt, reward, info)
        frozen = state.done
        state = PlanState(*(
            torch.where(frozen.reshape((-1,) + (1,) * (new.dim() - 1)),
                        old, new)
            for old, new in ((getattr(state, n), getattr(nxt, n))
                             for n in FIELD_NAMES)))
        acc = acc + torch.where(frozen, 0.0, reward)
    return state, acc


def _ga_program(mean_action, generator):
    _, spec, init = bench.setup('hlg', {}, 'cpu')
    genes = torch.zeros(PROGRAM_GENES, GENES)
    return spec, init, StepProgram(spec, tga.GenePolicy(genes, mean_action),
                                   init, PROGRAM_GENES, 'ga', generator)


@pytest.mark.parametrize('mean_action', [True, False])
def test_ga_program_rollout_equals_the_eager_loop(mean_action):
    """Two populations through one 'ga' program and one generator,
    reseeded before each (as population_fitness reseeds it), against the
    eager loop with a new generator of the same seed."""
    gen = torch.Generator()
    spec, init, program = _ga_program(mean_action, gen)
    for seed in (5, 6):
        genes = torch.as_tensor(np.random.default_rng(seed).uniform(
            -5, 5, size=(PROGRAM_GENES, GENES)), dtype=torch.float32)
        program.model.genes.copy_(genes)
        gen.manual_seed(seed)
        final, total, _, _ = eval_rollout(
            spec, program.model, broadcast_state(init, PROGRAM_GENES), gen,
            PROGRAM_STEPS, program=program)
        ref_gen = torch.Generator().manual_seed(seed)
        ref_final, ref_total = ref_population_rollout(
            spec, init, genes, PROGRAM_STEPS, mean_action, ref_gen)
        assert torch.equal(total, ref_total)
        start = broadcast_state(init, PROGRAM_GENES)
        assert sum(not torch.equal(getattr(final, n), getattr(start, n))
                   for n in FIELD_NAMES) > 5       # the plans moved
        for n in FIELD_NAMES:
            assert torch.equal(getattr(final, n), getattr(ref_final, n)), n
        assert torch.equal(gen.get_state(), ref_gen.get_state())


@pytest.mark.parametrize('mean_action', [True, False])
def test_ga_program_region_has_no_host_sync(mean_action):
    """After one step (the warm-up), the 'ga' region (build_obs,
    ga_logits with its static distances, the masked argmax or sample,
    env_step) runs no op that reads a tensor on the host or copies host
    data to the device."""
    from test_torch_program import SYNC_OPS, _OpLog
    gen = torch.Generator().manual_seed(0)
    spec, init, program = _ga_program(mean_action, gen)
    program.model.genes.copy_(torch.as_tensor(
        np.random.default_rng(1).uniform(-5, 5, size=(PROGRAM_GENES, GENES)),
        dtype=torch.float32))
    program.run(broadcast_state(init, PROGRAM_GENES))
    log = _OpLog()
    with log:
        out = program._step()
    assert out['action'].shape == (PROGRAM_GENES, 2)
    assert len(log.ops) > 1000
    assert not [op for op in log.ops if op in SYNC_OPS]
