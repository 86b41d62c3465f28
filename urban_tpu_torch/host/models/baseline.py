"""Heuristic and search baselines (reference:
urban_planning/models/baseline.py:5-246).

Numpy implementations of the four non-RL agents, operating on the same
padded observation lists the environment emits:

  * RuleCentralizedPolicy  — place closest to the community center; build the
    longest boundary segments into roads.
  * RuleDecentralizedPolicy — place farthest from same-type land uses
    (random fallback when none exist yet).
  * GSCAPolicy — geometric set-coverage: maximize the number of residential
    zones within 500 m that lack the current service.
  * GAPolicy — linear scoring of edge/node features by a gene vector
    (2 * node_dim + 1 genes), used by the genetic-algorithm trainer.

All follow the same contract as the learned policy: ``select_action(obs,
rng, mean_action)`` returning an action pair [land_use_edge, road_node].
Masked logits use the same large negative padding as the learned heads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from urban_tpu_torch.host import city_config

MASK_PAD = -(2.0 ** 32 - 1)

_XY = slice(city_config.NUM_TYPES + 1, city_config.NUM_TYPES + 3)
_LENGTH_COL = city_config.NUM_TYPES + 4


def _masked_choice(logits: np.ndarray, mask: np.ndarray, rng, mean_action: bool):
    masked = np.where(mask, logits, MASK_PAD)
    if mean_action:
        return int(np.argmax(masked))
    z = masked - masked.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(masked), p=p))


def _road_action(obs, rng, mean_action: bool) -> int:
    """Longest-segment road heuristic shared by every baseline
    (reference baseline.py:46-59)."""
    nodes, node_mask, road_mask = obs[1], obs[4], obs[7]
    length = nodes[:, _LENGTH_COL].astype(np.float64)
    logits = np.where(node_mask, length, length.min() - 1)
    return _masked_choice(logits, road_mask, rng, mean_action)


class NullModel:
    """Placeholder value model for heuristic agents (reference
    baseline.py:5-18)."""

    def __call__(self, obs):
        batch = 1 if not isinstance(obs, list) or not isinstance(obs[0], list) \
            else len(obs)
        return np.zeros((batch, 1), dtype=np.float32)


class RuleCentralizedPolicy:
    """Closest-to-center placement (reference baseline.py:21-60)."""

    def select_action(self, obs, rng=None, mean_action: bool = True):
        rng = rng or np.random.default_rng()
        actions = np.zeros(2)
        stage = obs[-1]
        if stage.argmax() == 0:
            nodes, edges, edge_mask, lu_mask = obs[1], obs[2], obs[5], obs[6]
            xy = nodes[:, _XY]
            exy = 0.5 * (xy[edges[:, 0]] + xy[edges[:, 1]])
            dist = np.linalg.norm(exy, axis=1)
            logits = -np.where(edge_mask, dist, dist.max() + 1)
            actions[0] = _masked_choice(logits, lu_mask, rng, mean_action)
        else:
            actions[1] = _road_action(obs, rng, mean_action)
        return actions


class RuleDecentralizedPolicy:
    """Farthest-from-same-type placement (reference baseline.py:63-115)."""

    def select_action(self, obs, rng=None, mean_action: bool = True):
        rng = rng or np.random.default_rng()
        actions = np.zeros(2)
        stage = obs[-1]
        if stage.argmax() == 0:
            nodes, edges, cur, edge_mask, lu_mask = \
                obs[1], obs[2], obs[3], obs[5], obs[6]
            xy = nodes[:, _XY]
            exy = 0.5 * (xy[edges[:, 0]] + xy[edges[:, 1]])
            cur_type = int(np.argmax(cur[:city_config.NUM_TYPES + 1]))
            same = nodes[:, cur_type] == 1
            if same.any():
                sxy = xy[same]
                d = np.linalg.norm(exy[:, None, :] - sxy[None, :, :], axis=2)
                d = d.mean(axis=1)
                logits = np.where(edge_mask, d, d.min() - 1)
                actions[0] = _masked_choice(logits, lu_mask, rng, mean_action)
            else:
                valid = np.nonzero(lu_mask)[0]
                if len(valid) > 0:
                    actions[0] = int(rng.choice(valid))
        else:
            actions[1] = _road_action(obs, rng, mean_action)
        return actions


class GSCAPolicy:
    """Geometric set-coverage placement (reference baseline.py:118-188)."""

    def __init__(self, grid_cols: int, grid_rows: int, cell_edge_length: float):
        self.grid_cols = grid_cols
        self.grid_rows = grid_rows
        self.cell_edge_length = cell_edge_length

    def select_action(self, obs, rng=None, mean_action: bool = True):
        rng = rng or np.random.default_rng()
        actions = np.zeros(2)
        stage = obs[-1]
        if stage.argmax() != 0:
            actions[1] = _road_action(obs, rng, mean_action)
            return actions
        nodes, edges, cur, edge_mask, lu_mask = \
            obs[1], obs[2], obs[3], obs[5], obs[6]
        # de-normalize [-1,1] coordinates back to grid units
        xy = (nodes[:, _XY] + 1) / 2 * np.array([self.grid_cols, self.grid_rows])
        exy = 0.5 * (xy[edges[:, 0]] + xy[edges[:, 1]])
        cur_type = int(np.argmax(cur[:city_config.NUM_TYPES + 1]))
        if cur_type in (city_config.HOSPITAL_L, city_config.HOSPITAL_S):
            same = (nodes[:, city_config.HOSPITAL_L]
                    + nodes[:, city_config.HOSPITAL_S]) >= 1
        else:
            same = nodes[:, cur_type] == 1
        residential = nodes[:, city_config.RESIDENTIAL] == 1
        res_xy = xy[residential]
        if same.any() and residential.any():
            sxy = xy[same]
            d = np.linalg.norm(res_xy[:, None, :] - sxy[None, :, :], axis=2)
            service_less = d.min(axis=1) * self.cell_edge_length > 500
            target_xy = res_xy[service_less] if service_less.any() else res_xy
        else:
            target_xy = res_xy
        if len(target_xy) == 0:
            valid = np.nonzero(lu_mask)[0]
            actions[0] = int(valid[0]) if len(valid) else 0
            return actions
        d = np.linalg.norm(exy[:, None, :] - target_xy[None, :, :], axis=2)
        served = (d * self.cell_edge_length < 500).sum(axis=1).astype(np.float64)
        logits = np.where(edge_mask, served, served.min() - 1)
        actions[0] = _masked_choice(logits, lu_mask, rng, mean_action)
        return actions


class GAPolicy:
    """Gene-scored linear policy (reference baseline.py:191-246).

    The gene vector has 2*node_dim + 1 entries: the first node_dim+1 score
    edge features (including a same-type-distance extra), the rest score node
    features for the road stage."""

    def select_action(self, obs, gene, rng=None, mean_action: bool = True):
        rng = rng or np.random.default_rng()
        gene = np.asarray(gene, dtype=np.float64)
        num_genes = len(gene)
        actions = np.zeros(2)
        stage = obs[-1]
        if stage.argmax() == 0:
            nodes, edges, cur, edge_mask, lu_mask = \
                obs[1], obs[2], obs[3], obs[5], obs[6]
            ef = 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])
            xy = nodes[:, _XY]
            exy = 0.5 * (xy[edges[:, 0]] + xy[edges[:, 1]])
            cur_type = int(np.argmax(cur[:city_config.NUM_TYPES + 1]))
            same = nodes[:, cur_type] == 1
            if same.any():
                sxy = xy[same]
                d = np.linalg.norm(exy[:, None, :] - sxy[None, :, :], axis=2)
                dist_same = d.mean(axis=1)
            else:
                dist_same = np.zeros(len(exy))
            ef = np.concatenate([ef, dist_same[:, None]], axis=1)
            logits = ef @ gene[:num_genes // 2 + 1]
            logits = np.where(edge_mask, logits, logits.min() - 1)
            actions[0] = _masked_choice(logits, lu_mask, rng, mean_action)
        else:
            nodes, node_mask, road_mask = obs[1], obs[4], obs[7]
            logits = nodes @ gene[num_genes // 2 + 1:]
            logits = np.where(node_mask, logits, logits.min() - 1)
            actions[1] = _masked_choice(logits, road_mask, rng, mean_action)
        return actions
