"""Scenario bundles: objectives + initial plan in framework-native formats.

A scenario consists of
  * an objectives YAML (community grid shape, land uses to plan, ratio/count
    targets, area/edge-length constraints — same schema as the reference's
    ``objectives_*.yaml``, e.g. reference urban_planning/cfg/test_data/real/
    hlg/objectives_hlg.yaml:1-60), and
  * an initial plan stored as ``.npz`` arrays (feature types, existence,
    ragged geometry coordinate buffers) plus optional planning-concept
    entries and the rule-constraints flag — the decoded equivalent of the
    reference's pickled GeoDataFrame ``init_plan_*.pickle``.

``tools/import_scenarios.py`` converts the reference pickles into this format
once; the framework itself never depends on geopandas.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from urban_tpu_torch.host.geometry.base import Geometry
from urban_tpu_torch.host.io.refpickle import PlanTable
from urban_tpu_torch.host.utils.io import load_yaml, resolve_path


def plan_table_to_arrays(table: PlanTable) -> Dict[str, np.ndarray]:
    kinds = np.array([g.kind for g in table.geoms], dtype=np.int8)
    counts = np.array([len(g.coords) for g in table.geoms], dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    coords = (np.concatenate([g.coords for g in table.geoms], axis=0)
              if table.geoms else np.zeros((0, 2)))
    return {
        'ids': table.ids.astype(np.int64),
        'types': table.types.astype(np.int32),
        'existence': table.existence.astype(bool),
        'geom_kinds': kinds,
        'geom_offsets': offsets,
        'geom_coords': coords.astype(np.float64),
    }


def plan_table_from_arrays(arrays) -> PlanTable:
    kinds = arrays['geom_kinds']
    offsets = arrays['geom_offsets']
    coords = arrays['geom_coords']
    geoms = [Geometry(int(kinds[i]), coords[offsets[i]:offsets[i + 1]])
             for i in range(len(kinds))]
    return PlanTable(ids=np.asarray(arrays['ids'], dtype=np.int64),
                     types=np.asarray(arrays['types'], dtype=np.int32),
                     existence=np.asarray(arrays['existence'], dtype=bool),
                     geoms=geoms)


def save_init_plan(path: str, table: PlanTable, concept: List[Dict],
                   rule_constraints: bool) -> None:
    arrays = plan_table_to_arrays(table)
    concept_json = json.dumps([
        {**{k: v for k, v in c.items() if k != 'geometry'},
         'geometry_kind': c['geometry'].kind,
         'geometry_coords': c['geometry'].coords.tolist()}
        for c in concept])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, concept=np.array(concept_json),
                        rule_constraints=np.array(bool(rule_constraints)),
                        **arrays)


def load_init_plan(path: str):
    with np.load(path, allow_pickle=False) as data:
        table = plan_table_from_arrays(data)
        concept_raw = json.loads(str(data['concept']))
        rule_constraints = bool(data['rule_constraints'])
    concept = []
    for c in concept_raw:
        entry = {k: v for k, v in c.items()
                 if k not in ('geometry_kind', 'geometry_coords')}
        entry['geometry'] = Geometry(int(c['geometry_kind']),
                                     np.asarray(c['geometry_coords']))
        concept.append(entry)
    return table, concept, rule_constraints


@dataclass
class Scenario:
    objectives: Dict
    plan: PlanTable
    concept: List[Dict] = field(default_factory=list)
    rule_constraints: bool = False


def load_scenario(objectives_plan: str, init_plan: str) -> Scenario:
    """Load a scenario by bare names, glob-resolved under urban_tpu/cfg/**
    (same addressing convention as reference plan_client.py:45-48)."""
    objectives = load_yaml(f'urban_tpu/cfg/**/{objectives_plan}.yaml')
    npz_path = resolve_path(f'urban_tpu/cfg/**/{init_plan}.npz')
    table, concept, rule_constraints = load_init_plan(npz_path)
    return Scenario(objectives=objectives, plan=table, concept=concept,
                    rule_constraints=rule_constraints)
