"""Observation construction: fixed-size padded graph observations.

Rebuild of the reference ObservationExtractor (reference:
urban_planning/envs/observation_extractor.py:9-228). The observation is a
9-element list of numpy arrays:

  [numerical, nodes, edges, current_node, node_mask, edge_mask,
   land_use_mask, road_mask, stage_onehot]

Node features: one-hot type (NUM_TYPES+1) ⊕ centroid xy ⊕ area/length/width/
height ⊕ rect/eqi/sc, all affinely scaled to [-1, 1]. Everything is padded to
(max_num_nodes, max_num_edges) with boolean masks; padded edges index the
sentinel node max_num_nodes-1. This fixed-size layout is exactly what lets
rollouts batch on TPU.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from urban_tpu_torch.host import city_config


class ObservationExtractor:

    def __init__(self, plc, max_num_nodes: int, max_num_edges: int,
                 max_num_stages: int) -> None:
        self._plc = plc
        self._max_num_nodes = max_num_nodes
        self._max_num_edges = max_num_edges
        self._max_num_stages = max_num_stages
        self._max_area = plc.get_common_max_area()
        self._max_edge_length = plc.get_common_max_edge_length()
        self._get_obs_static()

    def _get_obs_static(self) -> None:
        required_ratio, required_count = self._plc.get_requirements()
        self.max_required_plan_count = required_count.max()
        normalized_count = required_count / self.max_required_plan_count
        self._obs_static = np.concatenate([required_ratio, normalized_count])

    def _get_obs_numerical(self) -> np.ndarray:
        plan_ratio, plan_count = self._plc.get_plan_ratio_and_count()
        normalized_count = plan_count / self.max_required_plan_count
        return np.concatenate([self._obs_static, plan_ratio, normalized_count],
                              dtype=np.float32)

    def _pad_mask(self, mask: np.ndarray, max_num: int, name: str) -> np.ndarray:
        pad = max_num - mask.size
        if pad < 0:
            raise ValueError(f'The number of {name} exceeds the maximum limit.')
        return np.pad(mask, (0, pad), mode='constant', constant_values=False)

    def _pad_nodes(self, nodes: np.ndarray) -> np.ndarray:
        pad = self._max_num_nodes - nodes.shape[0]
        if pad < 0:
            raise ValueError('The number of nodes exceeds the maximum limit.')
        return np.pad(nodes, ((0, pad), (0, 0)), mode='constant')

    def _pad_edges(self, edges: np.ndarray) -> np.ndarray:
        pad = self._max_num_edges - edges.shape[0]
        if pad < 0:
            raise ValueError('The number of edges exceeds the maximum limit.')
        return np.pad(edges, ((0, pad), (0, 0)), mode='constant',
                      constant_values=self._max_num_nodes - 1)

    def _get_obs_graph(self):
        (node_type, node_coordinates, node_area, node_length, node_width,
         node_height, node_domain, edges) = self._plc.get_graph_features()
        one_hot = np.eye(city_config.NUM_TYPES + 1)[node_type]
        node_coordinates = 2 * node_coordinates - 1
        node_area = 2 * node_area[:, None] / self._max_area - 1
        node_length = 2 * node_length[:, None] / self._max_edge_length - 1
        node_width = 2 * node_width[:, None] / self._max_edge_length - 1
        node_height = 2 * node_height[:, None] / self._max_edge_length - 1
        node_domain = 2 * node_domain - 1
        obs_nodes = np.concatenate(
            [one_hot, node_coordinates, node_area, node_length, node_width,
             node_height, node_domain], axis=-1, dtype=np.float32)
        node_mask = self._pad_mask(np.full(obs_nodes.shape[0], True),
                                   self._max_num_nodes, 'nodes')
        edge_mask = self._pad_mask(np.full(edges.shape[0], True),
                                   self._max_num_edges, 'edges')
        obs_nodes = self._pad_nodes(obs_nodes)
        obs_edges = self._pad_edges(edges).astype(np.int64)
        return obs_nodes, obs_edges, node_mask, edge_mask

    def _get_obs_current_node(self, land_use: Dict) -> np.ndarray:
        one_hot = np.eye(city_config.NUM_TYPES + 1)[land_use['type']]
        coords = 2 * np.array([land_use['x'], land_use['y']]) - 1
        scalars = np.array([
            2 * land_use['area'] / self._max_area - 1,
            2 * land_use['length'] / self._max_edge_length - 1,
            2 * land_use['width'] / self._max_edge_length - 1,
            2 * land_use['height'] / self._max_edge_length - 1])
        domain = np.array([2 * land_use['rect'] - 1,
                           2 * land_use['eqi'] - 1,
                           2 * land_use['sc'] - 1])
        return np.concatenate([one_hot, coords, scalars, domain],
                              dtype=np.float32)

    def _get_obs_stage(self, stage: int) -> np.ndarray:
        return np.eye(self._max_num_stages, dtype=np.float32)[stage]

    def get_numerical_feature_size(self) -> int:
        return self._obs_static.size * 2

    def get_node_dim(self, land_use: Dict) -> int:
        return self._get_obs_current_node(land_use).size

    def get_obs(self, land_use: Dict, land_use_mask: np.ndarray,
                road_mask: np.ndarray, stage: int) -> List[np.ndarray]:
        obs_numerical = self._get_obs_numerical()
        obs_nodes, obs_edges, node_mask, edge_mask = self._get_obs_graph()
        obs_current_node = self._get_obs_current_node(land_use)
        obs_land_use_mask = self._pad_mask(land_use_mask, self._max_num_edges,
                                           'edges')
        obs_road_mask = self._pad_mask(road_mask, self._max_num_nodes, 'nodes')
        obs_stage = self._get_obs_stage(stage)
        return [obs_numerical, obs_nodes, obs_edges, obs_current_node,
                node_mask, edge_mask, obs_land_use_mask, obs_road_mask,
                obs_stage]
