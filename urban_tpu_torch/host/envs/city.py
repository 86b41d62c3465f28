"""Two-stage episodic urban-planning environment.

Rebuild of the reference CityEnv (reference: urban_planning/envs/city.py:
116-641): a land_use stage (place parcels until ratio/count targets are met),
a road stage (upgrade boundary segments to roads under a step budget), and a
done stage. Geometry failures become FAILURE_REWARD terminal steps instead of
crashes; infeasible actions raise InfeasibleActionError.

This host environment is the exact oracle; the batched TPU environment in
urban_tpu.jaxenv implements the same MDP on fixed-size buffers.
"""
from __future__ import annotations

import copy
import logging
import math
from functools import partial
from typing import Callable, Dict, List, Tuple

import numpy as np

from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.envs.observation import ObservationExtractor
from urban_tpu_torch.host.envs.plan_client import PlanClient


class InfeasibleActionError(ValueError):
    """An infeasible action was passed to the env (reference city.py:19-35)."""

    def __init__(self, action, mask):
        super().__init__(self, action, mask)
        self.action = action
        self.mask = mask

    def __str__(self):
        return 'action {} is not permitted by the current feasibility ' \
               'mask {}'.format(self.action, self.mask)


def reward_info_function(plc: PlanClient, name: str,
                         road_network_weight: float = 1.0,
                         life_circle_weight: float = 1.0,
                         greenness_weight: float = 1.0,
                         concept_weight: float = 0.0,
                         weight_by_area: bool = False) -> Tuple[float, Dict]:
    """Stage-dispatched weighted reward (reference city.py:38-113)."""
    if name == 'intermediate':
        return CityEnv.INTERMEDIATE_REWARD, {
            'road_network': -1.0, 'life_circle': -1.0,
            'greenness': -1.0, 'concept': -1.0}
    if name == 'road':
        proxy_reward = 0.0
        road_network = -1.0
        road_network_info: Dict = {}
        if road_network_weight > 0.0:
            road_network, road_network_info = plc.get_road_network_reward()
            proxy_reward += road_network_weight * road_network
        return proxy_reward, {
            'road_network': road_network, 'life_circle': -1.0,
            'greenness': -1.0, 'concept': -1.0,
            'road_network_info': road_network_info}
    if name == 'land_use':
        proxy_reward = 0.0
        life_circle = greenness = concept = -1.0
        life_circle_info: Dict = {}
        concept_info: Dict = {}
        if life_circle_weight > 0.0:
            life_circle, life_circle_info = plc.get_life_circle_reward(
                weight_by_area=weight_by_area)
            proxy_reward += life_circle_weight * life_circle
        if greenness_weight > 0.0:
            greenness = plc.get_greenness_reward()
            proxy_reward += greenness_weight * greenness
        if concept_weight > 0.0:
            concept, concept_info = plc.get_concept_reward()
            proxy_reward += concept_weight * concept
        return proxy_reward, {
            'road_network': -1.0, 'life_circle': life_circle,
            'greenness': greenness, 'concept': concept,
            'life_circle_info': life_circle_info,
            'concept_info': concept_info}
    raise ValueError(f'unknown reward channel {name!r}')


class CityEnv:
    """Environment for urban planning (reference city.py:116)."""

    FAILURE_REWARD = -1.0
    INTERMEDIATE_REWARD = 0.0

    def __init__(self, cfg, is_eval: bool = False,
                 reward_info_fn: Callable = reward_info_function):
        self.cfg = cfg
        self._is_eval = is_eval
        self._frozen = False
        self._action_history: List = []
        self._plc = PlanClient(cfg.objectives_plan, cfg.init_plan)
        self._reward_info_fn = partial(
            reward_info_fn,
            road_network_weight=cfg.reward_specs.get('road_network_weight', 1.0),
            life_circle_weight=cfg.reward_specs.get('life_circle_weight', 1.0),
            greenness_weight=cfg.reward_specs.get('greenness_weight', 1.0),
            concept_weight=cfg.reward_specs.get('concept_weight', 0.0),
            weight_by_area=cfg.reward_specs.get('weight_by_area', False))
        self._all_stages = ['land_use', 'road', 'done']
        self._set_stage()
        self._done = False
        self._set_cached_reward_info()
        self._observation_extractor = ObservationExtractor(
            self._plc,
            cfg.state_encoder_specs['max_num_nodes'],
            cfg.state_encoder_specs['max_num_edges'],
            len(self._all_stages))

    # ------------------------------------------------------------------
    # stage machinery (reference city.py:148-202, 389-406)
    # ------------------------------------------------------------------
    def _set_stage(self) -> None:
        self._land_use_steps = 0
        self._road_steps = 0
        if not self.cfg.skip_land_use:
            self._stage = 'land_use'
            self._land_use_done = False
            self._road_done = False
        elif not self.cfg.skip_road:
            self._stage = 'road'
            self._land_use_done = True
            self._road_done = False
        else:
            raise ValueError('scenario skips both the land_use and road '
                             'stages; nothing to plan')

    def _compute_total_road_steps(self) -> None:
        if self._stage == 'road' and self._road_steps == 0:
            self._total_road_steps = math.floor(
                np.count_nonzero(self._current_road_mask) * self.cfg.road_ratio)
        else:
            raise ValueError(f'no road budget to compute in stage {self._stage!r}')

    def _set_cached_reward_info(self) -> None:
        if not self._frozen:
            self._cached_life_circle_reward = -1.0
            self._cached_greenness_reward = -1.0
            self._cached_concept_reward = -1.0
            self._cached_life_circle_info: Dict = {}
            self._cached_concept_info: Dict = {}
            self._cached_land_use_reward = -1.0
            self._cached_land_use_gdf = self.snapshot_land_use()

    def freeze_land_use(self, info: Dict) -> None:
        """Freeze the land-use phase result for road-only finetuning
        (reference city.py:189-202)."""
        land_use_gdf = info['land_use_gdf']
        self._plc.freeze_land_use(land_use_gdf)
        self._cached_land_use_gdf = land_use_gdf
        self._cached_land_use_reward = info['land_use_reward']
        self._cached_life_circle_reward = info['life_circle']
        self._cached_greenness_reward = info['greenness']
        self._cached_concept_reward = info['concept']
        self._cached_life_circle_info = info.get('life_circle_info', {})
        self._cached_concept_info = info.get('concept_info', {})
        self._frozen = True

    def get_reward_info(self) -> Tuple[float, Dict]:
        """Stage-aware reward dispatch (reference city.py:204-234)."""
        if self.cfg.skip_road:
            if self._stage == 'land_use':
                return self._reward_info_fn(self._plc, 'intermediate')
            if self._stage == 'done':
                return self._reward_info_fn(self._plc, 'land_use')
            raise ValueError(f'reward undefined for stage {self._stage!r}')
        if self.cfg.skip_land_use:
            if self._stage == 'road':
                return self._reward_info_fn(self._plc, 'intermediate')
            if self._stage == 'done':
                return self._reward_info_fn(self._plc, 'road')
            raise ValueError(f'reward undefined for stage {self._stage!r}')
        if self._stage == 'land_use' or (self._stage == 'road'
                                         and self._road_steps > 0):
            return self._reward_info_fn(self._plc, 'intermediate')
        if self._stage == 'road' and self._road_steps == 0:
            return self._reward_info_fn(self._plc, 'land_use')
        if self._stage == 'done':
            return self._reward_info_fn(self._plc, 'road')
        raise ValueError(f'reward undefined for stage {self._stage!r}')

    def _get_all_reward_info(self) -> Tuple[float, Dict]:
        """Full scoring for loaded plans (reference city.py:236-250)."""
        land_use_reward, land_use_info = self._reward_info_fn(self._plc, 'land_use')
        road_reward, road_info = self._reward_info_fn(self._plc, 'road')
        reward = land_use_reward + road_reward
        info = {
            'road_network': road_info['road_network'],
            'life_circle': land_use_info['life_circle'],
            'greenness': land_use_info['greenness'],
            'road_network_info': road_info['road_network_info'],
            'life_circle_info': land_use_info['life_circle_info'],
        }
        return reward, info

    def eval(self) -> None:
        self._is_eval = True

    def train(self) -> None:
        self._is_eval = False

    # ------------------------------------------------------------------
    # observation plumbing (reference city.py:264-350)
    # ------------------------------------------------------------------
    def get_numerical_feature_size(self) -> int:
        return self._observation_extractor.get_numerical_feature_size()

    def get_node_dim(self) -> int:
        return self._observation_extractor.get_node_dim(self._get_dummy_land_use())

    @staticmethod
    def _get_dummy_land_use() -> Dict:
        return {'type': city_config.FEASIBLE, 'x': 0.5, 'y': 0.5,
                'area': 0.0, 'length': 0.0, 'width': 0.0, 'height': 0.0,
                'rect': 0.5, 'eqi': 0.5, 'sc': 0.5}

    def _get_land_use_and_mask(self) -> Tuple[Dict, np.ndarray]:
        if self._stage != 'land_use':
            land_use = self._get_dummy_land_use()
            mask = np.zeros(self.cfg.state_encoder_specs['max_num_edges'],
                            dtype=bool)
        else:
            land_use, mask = self._plc.get_current_land_use_and_mask()
        return land_use, mask

    def _get_road_mask(self) -> np.ndarray:
        if self._stage == 'land_use':
            return np.zeros(self.cfg.state_encoder_specs['max_num_nodes'],
                            dtype=bool)
        return self._plc.get_current_road_mask()

    def _get_stage_obs(self) -> int:
        return self._all_stages.index(self._stage)

    def _get_obs(self) -> List[np.ndarray]:
        return self._observation_extractor.get_obs(
            self._current_land_use, self._current_land_use_mask,
            self._current_road_mask, self._get_stage_obs())

    # ------------------------------------------------------------------
    # plan mutation passthroughs (reference city.py:352-387)
    # ------------------------------------------------------------------
    def place_land_use(self, land_use: Dict, action: int) -> None:
        self._plc.place_land_use(land_use, action)

    def build_road(self, action: int) -> None:
        self._plc.build_road(action)

    def fill_leftover(self) -> None:
        self._plc.fill_leftover()

    def snapshot_land_use(self):
        return self._plc.snapshot()

    def build_all_road(self) -> None:
        self._plc.build_all_road()

    def transition_stage(self) -> None:
        if self._stage == 'land_use':
            self._land_use_done = True
            if not self.cfg.skip_road:
                self._stage = 'road'
            else:
                self._road_done = True
                self._done = True
                self._stage = 'done'
        elif self._stage == 'road':
            self._road_done = True
            self._done = True
            self._stage = 'done'
        else:
            raise ValueError(f'Unknown stage: {self._stage}')

    def failure_step(self, logging_str: str, logger: logging.Logger):
        """Convert a geometry/feasibility failure into a terminal step
        (reference city.py:408-418)."""
        logger.info('{}: {}'.format(logging_str, self._action_history))
        info = {'road_network': -1.0, 'life_circle': -1.0, 'greenness': -1.0}
        return self._get_obs(), self.FAILURE_REWARD, True, info

    # ------------------------------------------------------------------
    # step / reset (reference city.py:420-540)
    # ------------------------------------------------------------------
    def step(self, action: np.ndarray, logger: logging.Logger
             ) -> Tuple[List, float, bool, Dict]:
        if self._done:
            raise RuntimeError('step() called on a finished episode; call reset() first')

        if self._stage == 'land_use':
            land_use = self._current_land_use
            a = int(action[0])
            self._action_history.append((land_use, a))
            if not self._current_land_use_mask[a]:
                raise InfeasibleActionError(a, self._current_land_use_mask)
            try:
                self.place_land_use(land_use, a)
            except Exception as err:
                logger.error(err)
                return self.failure_step(
                    'geometry failure while mutating the plan; action history', logger)
            self._land_use_steps += 1
            if self._plc.is_land_use_done():
                self.fill_leftover()
                self._cached_land_use_gdf = self.snapshot_land_use()
                self.transition_stage()
            reward, info = self.get_reward_info()
            self._current_land_use, self._current_land_use_mask = \
                self._get_land_use_and_mask()
            if not self._land_use_done and not np.any(self._current_land_use_mask):
                return self.failure_step(
                    'plan reached a dead state with no feasible action; action history', logger)
            self._current_road_mask = self._get_road_mask()
            if self._stage != 'land_use':
                self._cached_land_use_reward = reward
                if self._stage == 'road':
                    if not np.any(self._current_road_mask):
                        return self.failure_step(
                            'plan reached a dead state with no feasible action; action history', logger)
                    self._cached_life_circle_reward = info['life_circle']
                    self._cached_greenness_reward = info['greenness']
                    self._cached_concept_reward = info['concept']
                    self._cached_life_circle_info = info.get('life_circle_info', {})
                    self._cached_concept_info = info.get('concept_info', {})
                    self._compute_total_road_steps()
        elif self._stage == 'road':
            a = int(action[1])
            self._action_history.append(('road', a))
            if not self._current_road_mask[a]:
                raise InfeasibleActionError(a, self._current_road_mask)
            try:
                self.build_road(a)
            except Exception as err:
                logger.error(err)
                return self.failure_step(
                    'geometry failure while mutating the plan; action history', logger)
            self._road_steps += 1
            if self._road_steps >= self._total_road_steps:
                self.transition_stage()
            reward, info = self.get_reward_info()
            self._current_land_use, self._current_land_use_mask = \
                self._get_land_use_and_mask()
            self._current_road_mask = self._get_road_mask()
        else:
            raise ValueError(f'Cannot step in stage: {self._stage}.')

        if self._done:
            info['land_use_reward'] = self._cached_land_use_reward
            if not self.cfg.skip_road:
                info['life_circle'] = self._cached_life_circle_reward
                info['greenness'] = self._cached_greenness_reward
                info['concept'] = self._cached_concept_reward
                info['life_circle_info'] = self._cached_life_circle_info
                info['concept_info'] = self._cached_concept_info
            else:
                self.build_all_road()
            if self._is_eval:
                info['gdf'] = self._plc.get_table()
                info['land_use_gdf'] = self._cached_land_use_gdf

        return self._get_obs(), reward, self._done, info

    def reset(self) -> List[np.ndarray]:
        self._plc.unplan_all_land_use()
        self._action_history = []
        self._set_stage()
        self._done = False
        self._set_cached_reward_info()
        self._current_land_use, self._current_land_use_mask = \
            self._get_land_use_and_mask()
        self._current_road_mask = self._get_road_mask()
        if self.cfg.skip_land_use:
            self._compute_total_road_steps()
        return self._get_obs()

    # ------------------------------------------------------------------
    # plan IO / scoring / visualization (reference city.py:542-641)
    # ------------------------------------------------------------------
    def load_plan(self, table) -> None:
        self._plc.load_plan(table)

    def score_plan(self, verbose: bool = True) -> Tuple[float, Dict]:
        reward, info = self._get_all_reward_info()
        if verbose:
            from pprint import pprint
            print(f'reward: {reward}')
            pprint(info, indent=4, sort_dicts=False)
        return reward, info

    def get_init_plan(self) -> Dict:
        return self._plc.get_init_plan()

    @staticmethod
    def filter_land_use_road(table):
        keep = (table.existence
                & (table.types != city_config.OUTSIDE)
                & (table.types != city_config.BOUNDARY)
                & (table.types != city_config.INTERSECTION))
        out = table.copy()
        out.existence = keep
        return out

    @staticmethod
    def filter_road_boundary(table):
        keep = (table.existence
                & ((table.types == city_config.ROAD)
                   | (table.types == city_config.BOUNDARY)))
        out = table.copy()
        out.existence = keep
        return out

    def visualize(self, save_fig: bool = False, path: str = None,
                  legend: bool = True, ticks: bool = True,
                  bbox: bool = True) -> None:
        from urban_tpu_torch.host.envs.render import plot_table
        plot_table(self.filter_land_use_road(self._plc.get_table()),
                   save_fig=save_fig, path=path, legend=legend,
                   ticks=ticks, bbox=bbox)

    def visualize_road_and_boundary(self, save_fig: bool = False,
                                    path: str = None, legend: bool = True,
                                    ticks: bool = True, bbox: bool = True) -> None:
        from urban_tpu_torch.host.envs.render import plot_table
        plot_table(self.filter_road_boundary(self._plc.get_table()),
                   save_fig=save_fig, path=path, legend=legend,
                   ticks=ticks, bbox=bbox)
