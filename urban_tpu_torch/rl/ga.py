"""Minimal genetic-algorithm optimizer (counterpart of urban_tpu/rl/ga.py).

Drop-in replacement for the pygad configuration the reference uses
(reference: urban_planning/train_ga.py:69-85): steady-state selection,
single-point crossover, random per-gene mutation, keep-parents elitism, and
a saturate-N stop criterion. Fitness evaluation is delegated to a callable
(greedy env episodes); ``make_ga_population_fitness`` evaluates a whole
population at once on the batched environment (one env per gene), through
a captured step program on the card. ``GA`` and ``GAConfig`` are the JAX
package's, which are pure numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from urban_tpu_torch.models.baseline import ga_logits
from urban_tpu_torch.models.policy import categorical_sample
from urban_tpu_torch.torchenv.program import StepProgram
from urban_tpu_torch.torchenv.rollout import broadcast_state, eval_rollout


@dataclass
class GAConfig:
    num_generations: int = 100
    num_parents_mating: int = 2
    sol_per_pop: int = 20
    num_genes: int = 10
    init_range_low: float = -5.0
    init_range_high: float = 5.0
    keep_parents: int = 1
    mutation_percent_genes: float = 10.0
    mutation_range: Tuple[float, float] = (-1.0, 1.0)
    saturate_generations: int = 10
    seed: int = 0


class GA:

    def __init__(self, cfg: GAConfig, fitness_func: Callable[[np.ndarray], float],
                 on_generation: Optional[Callable] = None,
                 population_fitness_func: Optional[Callable] = None):
        """population_fitness_func, when given, evaluates the WHOLE
        population in one call ((P, G) -> (P,)): the batched-env
        evaluator (make_ga_population_fitness) plugs in here."""
        self.cfg = cfg
        self.fitness_func = fitness_func
        self.population_fitness_func = population_fitness_func
        self.on_generation = on_generation
        self.rng = np.random.default_rng(cfg.seed)
        self.population = self.rng.uniform(
            cfg.init_range_low, cfg.init_range_high,
            size=(cfg.sol_per_pop, cfg.num_genes))
        self.best_solutions_fitness: List[float] = []
        self.last_generation_fitness: Optional[np.ndarray] = None
        self.generations_completed = 0

    def _evaluate(self) -> np.ndarray:
        if self.population_fitness_func is not None:
            return np.asarray(self.population_fitness_func(self.population))
        return np.array([self.fitness_func(sol) for sol in self.population])

    def run(self) -> None:
        cfg = self.cfg
        fitness = self._evaluate()
        for gen in range(cfg.num_generations):
            order = np.argsort(fitness)[::-1]
            parents = self.population[order[:max(cfg.num_parents_mating, 2)]]
            # children by single-point crossover + mutation
            num_children = cfg.sol_per_pop - cfg.keep_parents
            children = np.empty((num_children, cfg.num_genes))
            for i in range(num_children):
                pa, pb = parents[i % len(parents)], \
                    parents[(i + 1) % len(parents)]
                cut = int(self.rng.integers(1, cfg.num_genes))
                child = np.concatenate([pa[:cut], pb[cut:]])
                n_mut = max(1, int(round(cfg.num_genes
                                         * cfg.mutation_percent_genes / 100)))
                idx = self.rng.choice(cfg.num_genes, size=n_mut, replace=False)
                child[idx] += self.rng.uniform(*cfg.mutation_range, size=n_mut)
                children[i] = child
            elite = self.population[order[:cfg.keep_parents]]
            self.population = np.vstack([elite, children])
            fitness = self._evaluate()
            self.last_generation_fitness = fitness
            self.best_solutions_fitness.append(float(fitness.max()))
            self.generations_completed = gen + 1
            if self.on_generation is not None:
                self.on_generation(self)
            # saturate stop: no improvement for N generations
            s = cfg.saturate_generations
            if len(self.best_solutions_fitness) > s and \
                    self.best_solutions_fitness[-1] <= \
                    self.best_solutions_fitness[-1 - s]:
                break

    def best_solution(self):
        fitness = self.last_generation_fitness
        if fitness is None:
            fitness = self._evaluate()
        idx = int(np.argmax(fitness))
        return self.population[idx], float(fitness[idx]), idx


class GenePolicy:
    """The GA's linear gene policy (models.baseline.ga_logits) in the place
    of a step program's model: env p is scored by row p of `genes` (P, G),
    a static buffer the caller copies each population into, and takes the
    argmax of its masked logits (mean_action) or a sample of them from
    the step's generator (land use first, then the road). The program's
    use_mean is not read: mean_action decides."""

    def __init__(self, genes: torch.Tensor, mean_action: bool):
        self.genes, self.mean_action = genes, mean_action

    def sample_action_logp_value(self, obs, generator, use_mean):
        lu_logits, rd_logits = ga_logits(obs, self.genes)
        lu_l = torch.where(obs[6], lu_logits, -torch.inf)
        rd_l = torch.where(obs[7], rd_logits, -torch.inf)
        if self.mean_action:
            lu, rd = torch.argmax(lu_l, dim=-1), torch.argmax(rd_l, dim=-1)
        else:
            lu = categorical_sample(lu_l, generator)
            rd = categorical_sample(rd_l, generator)
        return torch.stack([lu, rd], dim=-1).to(torch.int32), None, None


def make_ga_population_fitness(spec, init_state, num_steps: int,
                               mean_action: bool = False, seed: int = 0,
                               device='cuda', eager: bool = False):
    """Whole-population fitness on the batched environment, on `device`
    (the card unless the caller asks for the CPU): env i is driven by gene
    i's linear policy (GenePolicy) for num_steps steps and frozen once
    done, with the stage rewards applied as the rollout applies them (the
    loop of eval_rollout); the fitness is the episode's reward, -1.0 for
    an unfinished or failed episode. With mean_action the actions are the
    argmax; otherwise they are sampled, from one torch.Generator reseeded
    seed + (the call's number) before each call. The step is a 'ga'
    StepProgram, one for each population size, made on first use: on the
    card a captured CUDA graph of build_obs, ga_logits, the masked argmax
    or sample and env_step (the counterpart of JAX's jitted
    run_population), replayed once a step; the stage rewards and the
    freeze run eagerly between replays. eager=True steps it eagerly on the
    card too. Returns population (P, G) -> fitness (P,) as numpy."""
    device = torch.device(device)
    init_state = init_state.map(lambda x: x.to(device))
    generator = torch.Generator(device=device)
    programs = {}
    calls = [seed]

    @torch.no_grad()
    def population_fitness(population: np.ndarray) -> np.ndarray:
        calls[0] += 1
        generator.manual_seed(calls[0])
        genes = torch.as_tensor(np.asarray(population), dtype=torch.float32,
                                device=device)
        P = genes.shape[0]
        if genes.shape not in programs:
            programs[genes.shape] = StepProgram(
                spec, GenePolicy(torch.zeros_like(genes), mean_action),
                init_state, P, 'ga', generator, eager=eager)
        program = programs[genes.shape]
        program.model.genes.copy_(genes)
        _, total, done, failure = eval_rollout(
            spec, program.model, broadcast_state(init_state, P), generator,
            num_steps, program=program)
        return torch.where(done & ~failure, total, -1.0).cpu().numpy()

    population_fitness.programs = programs
    return population_fitness
