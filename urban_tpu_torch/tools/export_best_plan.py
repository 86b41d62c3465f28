"""Export a trainer checkpoint's best plan to GeoJSON and re-score it with
the exact host engine (counterpart of the JAX package's
tools/export_best_plan.py, which is not imported).

Reads a checkpoint of the port's trainer (``best.pt``, ``final.pt``,
``iteration_NNNN.pt``: ``rl.trainer.Trainer.save_checkpoint``), decodes
its best greedy eval plan (``best_plan_state``) into a host GeoTable,
completes the leftover feasible space to small green as the env's stage
transition does (reference: plan_client.fill_leftover), saves the GeoJSON
in the published results/ format, and re-scores the filled plan in the
host ``CityEnv`` with the scenario's own reward weights (the published
scorer). The score of the filled plan is the number the JAX package's
tool gives; ``demo`` on the same checkpoint scores the plan unfilled.
Where the scenario weights a planning-concept term (hlg_concept,
dhm_concept), a last line gives that term unweighted, ``concept: x``,
which the score's channels do not list. A road-phase checkpoint of the
two-phase curriculum (``phase`` 2: its plan is the frozen land use with
the roads the greedy eval built) ends with ``road: x (jit y)``: the host's
road-network term beside the checkpoint's best greedy eval, which in the
road phase is the road reward alone, divided by its weight.

    python -m urban_tpu_torch.tools.export_best_plan --cfg hlg \\
        --ckpt DIR/hlg/111/models/best.pt --out results/hlg_rl_torch.geojson
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.envs.city import CityEnv
from urban_tpu_torch.host.envs.plan_client import PlanClient
from urban_tpu_torch.host.io.geojson import save_geojson
from urban_tpu_torch.host.utils.config import Config
from urban_tpu_torch.rl.trainer import read_checkpoint
from urban_tpu_torch.torchenv.state import state_to_table


def concept_term(cfg: Config, table) -> float:
    """The plan's planning-concept term, unweighted, as the host engine
    computes it inside the land-use reward (score_plan's info does not
    list it)."""
    plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
    plc.load_plan(table)
    return plc.get_concept_reward()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cfg', required=True)
    ap.add_argument('--ckpt', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--global_seed', type=int, default=111)
    args = ap.parse_args(argv)

    ckpt = read_checkpoint(args.ckpt)
    state = ckpt.get('best_plan_state')
    if state is None:
        print('checkpoint has no best_plan_state')
        return 1
    table = state_to_table(state)
    leftover = table.alive_mask_of(city_config.FEASIBLE)
    table.types[leftover] = city_config.GREEN_S
    save_geojson(table, args.out)
    print(f'exported best plan (jit eval reward '
          f"{ckpt.get('best_reward'):.4f}, iteration "
          f"{ckpt.get('best_iteration')}) -> {args.out}")

    cfg = Config(args.cfg, args.global_seed, root_dir=os.path.join(
        tempfile.gettempdir(), 'urban_tpu_torch'))
    env = CityEnv(cfg)
    env.load_plan(table)
    _, info = env.score_plan(verbose=True)
    if cfg.reward_specs.get('concept_weight', 0.0) > 0:
        print(f'concept: {concept_term(cfg, table)}')
    if ckpt.get('phase', 1) == 2:
        weight = cfg.reward_specs.get('road_network_weight', 1.0)
        print(f"road: {info['road_network']} "
              f"(jit {ckpt['best_reward'] / weight})")
    return 0


if __name__ == '__main__':
    sys.exit(main())
