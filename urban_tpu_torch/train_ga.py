"""Genetic-algorithm training CLI (counterpart of urban_tpu/train_ga.py;
reference: urban_planning/train_ga.py:17-102).

    python -m urban_tpu_torch.train_ga --cfg hlg --global_seed 111
        [--num_generations 100 --sol_per_pop 20] [--export_geojson plan.json]
        [--device cuda|cpu]

The GA searches the genes of the linear GAPolicy. With --tpu_env (the
default; the name is the JAX package's) a whole population is scored at
once on the batched environment on --device (the card unless asked
otherwise), one env per gene; without it, or with --visualize or
--only_road, each gene plays one episode of the host environment. The
best gene is saved to the run's models/best.p and its greedy plan played
on the host environment, and with --export_geojson written as GeoJSON.
"""
from __future__ import annotations

import argparse
from pprint import pprint

import numpy as np

from urban_tpu_torch.agents.urban_agent import UrbanPlanningAgent
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.ga import GA, GAConfig
from urban_tpu_torch.train import DEFAULT_ROOT
from urban_tpu_torch.utils.flags import add_bool_flag


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root_dir', default=DEFAULT_ROOT, help='Root directory.')
    ap.add_argument('--cfg', required=True, help='Configuration file.')
    add_bool_flag(ap, 'tmp', False, 'Whether to use temporary storage')
    add_bool_flag(ap, 'mean_action', True, 'Whether to use greedy strategy')
    add_bool_flag(ap, 'visualize', False, 'Visualize the planning process')
    add_bool_flag(ap, 'only_road', False, 'Only road planning')
    ap.add_argument('--global_seed', type=int, required=True, help='Seed.')
    ap.add_argument('--sol_per_pop', type=int, default=20,
                    help='Solutions per population.')
    ap.add_argument('--num_generations', type=int, default=100,
                    help='Number of generations.')
    ap.add_argument('--num_parents_mating', type=int, default=2,
                    help='Parents for mating.')
    ap.add_argument('--init_range_low', type=int, default=-5,
                    help='Gene init low.')
    ap.add_argument('--init_range_high', type=int, default=5,
                    help='Gene init high.')
    ap.add_argument('--mutation_percent_genes', type=int, default=10,
                    help='Mutation percentage.')
    add_bool_flag(ap, 'tpu_env', True,
                  'Score the whole population at once on the batched '
                  'environment on --device (else one host episode a gene)')
    ap.add_argument('--export_geojson', default='',
                    help='Also export the best solution\'s greedy plan to '
                    'this GeoJSON path.')
    ap.add_argument('--device', default='cuda',
                    help='Device of the batched population fitness.')
    return ap.parse_args(argv)


def main(argv=None):
    """Parse argv (sys.argv when None), run the GA, save and play its best
    gene; returns (agent, ga, the best gene's greedy plan)."""
    a = parse_args(argv)
    cfg = Config(a.cfg, a.global_seed, a.tmp, a.root_dir, 'ga')
    np.random.seed(cfg.seed)
    agent = UrbanPlanningAgent(cfg=cfg, num_threads=1, training=False,
                               checkpoint=0, restore_best_rewards=True,
                               device=a.device)
    if a.only_road:
        agent.freeze_land_use()

    def fitness_func(solution):
        fitness, _ = agent.fitness_ga(solution, num_samples=1,
                                      mean_action=False,
                                      visualize=a.visualize)
        return fitness

    population_fitness = None
    if a.tpu_env and not a.visualize and not a.only_road:
        from urban_tpu_torch.host.envs.plan_client import PlanClient
        from urban_tpu_torch.rl.ga import make_ga_population_fitness
        from urban_tpu_torch.torchenv.state import (build_env_spec,
                                                    build_initial_state)
        if a.device.startswith('cuda'):
            from urban_tpu_torch.bench import set_precision_flags
            set_precision_flags()
        plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
        spec = build_env_spec(cfg, plc, max_steps=cfg.max_sequence_length)
        population_fitness = make_ga_population_fitness(
            spec, build_initial_state(spec, plc, device=a.device),
            num_steps=getattr(cfg, 'original_max_sequence_length',
                              cfg.max_sequence_length),
            mean_action=False, seed=cfg.seed, device=a.device)

    def report_func(instance):
        print(f'Generation: {instance.generations_completed}')
        print(f'Best Fitness: {instance.best_solutions_fitness[-1]: .4f}')
        avg = (sum(instance.last_generation_fitness)
               / len(instance.last_generation_fitness))
        print(f'Last Generation Average Fitness: {avg: .4f}')
        print()

    ga = GA(GAConfig(num_generations=a.num_generations,
                     num_parents_mating=a.num_parents_mating,
                     sol_per_pop=a.sol_per_pop,
                     num_genes=2 * agent.node_dim + 1,
                     init_range_low=a.init_range_low,
                     init_range_high=a.init_range_high,
                     keep_parents=1,
                     mutation_percent_genes=a.mutation_percent_genes,
                     saturate_generations=10,
                     seed=cfg.seed),
            fitness_func, on_generation=report_func,
            population_fitness_func=population_fitness)
    ga.run()

    best_solution, best_fitness, _ = ga.best_solution()
    print(f'Parameters of the best solution : {best_solution}')
    print(f'Fitness value of the best solution = {best_fitness}')
    agent.save_ga(best_solution, best_fitness)

    _, plan = agent.fitness_ga(best_solution, num_samples=1,
                               visualize=a.visualize)
    pprint({k: v for k, v in plan.items() if not k.endswith('gdf')},
           indent=4, sort_dicts=False)
    if a.export_geojson and 'gdf' in plan:
        from urban_tpu_torch.host.io.geojson import save_geojson
        save_geojson(plan['gdf'], a.export_geojson)
        print(f'exported best greedy plan to {a.export_geojson}')
    return agent, ga, plan


if __name__ == '__main__':
    main()
