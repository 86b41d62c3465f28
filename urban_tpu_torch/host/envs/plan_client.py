"""Plan-state engine: owns the plan, enforces rules, computes rewards.

Host (exact) rebuild of the reference's PlanClient (reference:
urban_planning/envs/plan_client.py:22-1062) on this framework's GeoTable and
geometry kernel instead of GeoDataFrame/GEOS/libpysal/momepy/networkx:

  * objectives/constraints from the scenario YAML; plan ratio/count stats
  * contiguity graph over plan features (vectorized segment-distance matrix)
  * action masks: (feasible block, intersection) graph edges for land use,
    boundary nodes for roads; school/hospital adjacency rule filter
  * land-use placement: slicing via urban_tpu.geometry.slicer, simplify/snap,
    new intersections and boundary bookkeeping, remaining-feasible re-add
  * road building (boundary -> road type flip)
  * rewards: road network, 15-minute life circle, greenness, planning concept
    (all exact except greenness, which rasterizes the residential region at
    GREEN_RASTER points — converged to <3.3e-4 of the reference's GEOS
    buffer-area value on every pinned plan; bound in docs/GREENNESS.md)

The jitted TPU environment (urban_tpu.jaxenv) mirrors the same semantics on
fixed-size buffers; this class is its oracle and serves evaluation, plan
scoring, and import/export.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.geometry import graph as ggraph
from urban_tpu_torch.host.geometry import ops
from urban_tpu_torch.host.geometry.base import Geometry, LINE, POINT, POLY
from urban_tpu_torch.host.geometry.slicer import SliceError, slice_polygon
from urban_tpu_torch.host.envs.plan_table import GeoTable
from urban_tpu_torch.host.io.scenario import Scenario, load_scenario


def set_land_use_array_from_dict(arr: np.ndarray, d: Dict, id_map) -> None:
    """Fill a per-type array from a {land_use_name: value} dict
    (reference: khrylib/utils/transfer.py:5-14)."""
    for land_use, value in d.items():
        arr[id_map[land_use]] = value


class PlanClient:
    """Plan-state engine (see module docstring)."""

    PLAN_ORDER = np.array([
        city_config.HOSPITAL_L,
        city_config.SCHOOL,
        city_config.HOSPITAL_S,
        city_config.RECREATION,
        city_config.RESIDENTIAL,
        city_config.GREEN_L,
        city_config.OFFICE,
        city_config.BUSINESS,
        city_config.GREEN_S], dtype=np.int32)
    EPSILON = 1e-4
    DEG_TOL = 1.0
    SNAP_EPSILON = 1.0
    CONTIG_TOL = 1e-6
    # raster resolution (cells along the longer community axis) for the
    # greenness buffer-coverage computation; the reference computes this with
    # GEOS round buffers (plan_client.py:954-967), we rasterize instead
    GREEN_RASTER = 512

    def __init__(self, objectives_plan: str, init_plan: str,
                 scenario: Optional[Scenario] = None) -> None:
        if scenario is None:
            scenario = load_scenario(objectives_plan, init_plan)
        self.objectives = scenario.objectives
        self._init_table = GeoTable.from_plan_table(scenario.plan)
        self._concept = scenario.concept
        self._rule_constraints = scenario.rule_constraints
        self.init_objectives()
        self.init_constraints()
        self.restore_plan()

    # ------------------------------------------------------------------
    # objectives & constraints (reference plan_client.py:53-125)
    # ------------------------------------------------------------------
    def init_objectives(self) -> None:
        objectives = self.objectives
        self._grid_cols = objectives['community']['grid_cols']
        self._grid_rows = objectives['community']['grid_rows']
        self._cell_edge_length = objectives['community']['cell_edge_length']
        self._cell_area = self._cell_edge_length ** 2

        land_use_types = objectives['objectives']['land_use']
        land_use_to_plan = np.array(
            [city_config.LAND_USE_ID_MAP[lu] for lu in land_use_types],
            dtype=np.int32)
        if objectives['objectives'].get('custom_planning_order', False):
            self._plan_order = land_use_to_plan
        else:
            self._plan_order = self.PLAN_ORDER[
                np.isin(self.PLAN_ORDER, land_use_to_plan)]

        self._required_plan_ratio = np.zeros(city_config.NUM_TYPES, dtype=np.float32)
        set_land_use_array_from_dict(self._required_plan_ratio,
                                     objectives['objectives']['ratio'],
                                     city_config.LAND_USE_ID_MAP)
        self._required_plan_count = np.zeros(city_config.NUM_TYPES, dtype=np.int32)
        set_land_use_array_from_dict(self._required_plan_count,
                                     objectives['objectives']['count'],
                                     city_config.LAND_USE_ID_MAP)

    def init_constraints(self) -> None:
        constraints = self.objectives['constraints']
        self._required_max_area = np.zeros(city_config.NUM_TYPES, dtype=np.float32)
        set_land_use_array_from_dict(self._required_max_area,
                                     constraints['max_area'],
                                     city_config.LAND_USE_ID_MAP)
        self._required_min_area = np.zeros(city_config.NUM_TYPES, dtype=np.float32)
        set_land_use_array_from_dict(self._required_min_area,
                                     constraints['min_area'],
                                     city_config.LAND_USE_ID_MAP)
        self._required_max_edge_length = np.zeros(city_config.NUM_TYPES,
                                                  dtype=np.float32)
        set_land_use_array_from_dict(self._required_max_edge_length,
                                     constraints['max_edge_length'],
                                     city_config.LAND_USE_ID_MAP)
        self._required_min_edge_length = np.zeros(city_config.NUM_TYPES,
                                                  dtype=np.float32)
        set_land_use_array_from_dict(self._required_min_edge_length,
                                     constraints['min_edge_length'],
                                     city_config.LAND_USE_ID_MAP)
        # common bounds over planned land uses (plan_client.py:110-117)
        self._common_max_area = self._required_max_area[self._plan_order].max()
        self._common_min_area = self._required_min_area[self._plan_order].min()
        self._common_max_edge_length = \
            self._required_max_edge_length[self._plan_order].max()
        self._common_min_edge_length = \
            self._required_min_edge_length[self._plan_order].min()
        self._min_edge_grid = round(self._common_min_edge_length / self._cell_edge_length)
        self._max_edge_grid = round(self._common_max_edge_length / self._cell_edge_length)

    def get_common_max_area(self) -> float:
        return float(self._common_max_area)

    def get_common_max_edge_length(self) -> float:
        return float(self._common_max_edge_length)

    # ------------------------------------------------------------------
    # plan lifecycle (reference plan_client.py:133-248)
    # ------------------------------------------------------------------
    def restore_plan(self) -> None:
        self._table = self._init_table.copy()
        self._init_stats()
        self._init_counter()
        self._graph_version = -1
        self._table_version = 0

    def load_plan(self, table: GeoTable) -> None:
        """Load an externally produced plan (for scoring/inspection)."""
        self._table = table.copy()
        self._bump()

    def get_init_plan(self) -> Dict:
        return {'table': self._init_table, 'concept': self._concept,
                'rule_constraints': self._rule_constraints}

    def unplan_all_land_use(self) -> None:
        self._table = self._init_table.copy()
        self._compute_stats()
        self._init_counter()
        self._bump()

    def freeze_land_use(self, table: GeoTable) -> None:
        """Make the given (land-use-complete) plan the new initial plan
        (two-phase training, reference plan_client.py:216-222)."""
        self._init_table = table.copy()

    def fill_leftover(self) -> None:
        """Remaining feasible space becomes small green (plan_client.py:224-227).

        Like the reference, this flips types without touching the running
        stats (land-use planning is already done at this point)."""
        mask = self._table.alive_mask_of(city_config.FEASIBLE)
        self._table.types[mask] = city_config.GREEN_S
        self._bump()

    def snapshot(self) -> GeoTable:
        return self._table.copy()

    def build_all_road(self) -> None:
        mask = self._table.alive_mask_of(city_config.BOUNDARY)
        self._table.types[mask] = city_config.ROAD
        self._bump()

    def is_land_use_done(self) -> bool:
        ratio_ok = ((self._plan_ratio - self._required_plan_ratio)
                    >= -self.EPSILON)[self._plan_order].all()
        count_ok = (self._plan_count >= self._required_plan_count)[self._plan_order].all()
        return bool(ratio_ok and count_ok)

    def get_table(self) -> GeoTable:
        return self._table

    # alias for reference-API familiarity
    get_gdf = get_table

    def _bump(self) -> None:
        self._table_version += 1

    def _init_counter(self) -> None:
        self._action_id = int(self._table.ids.max())

    def _counter(self) -> int:
        self._action_id += 1
        return self._action_id

    # ------------------------------------------------------------------
    # stats (reference plan_client.py:163-198)
    # ------------------------------------------------------------------
    def _init_stats(self) -> None:
        total_area = self._table.total_area(*city_config.LAND_USE_ID) * self._cell_area
        outside = self._table.total_area(city_config.OUTSIDE) * self._cell_area
        self._community_area = total_area - outside
        self._required_plan_area = self._community_area * self._required_plan_ratio
        self._plan_area = np.zeros(city_config.NUM_TYPES, dtype=np.float64)
        self._plan_ratio = np.zeros(city_config.NUM_TYPES, dtype=np.float64)
        self._plan_count = np.zeros(city_config.NUM_TYPES, dtype=np.int32)
        self._compute_stats()

    def _compute_stats(self) -> None:
        for land_use in city_config.LAND_USE_ID:
            area = self._table.total_area(land_use) * self._cell_area
            self._plan_area[land_use] = area
            self._plan_ratio[land_use] = area / self._community_area
            self._plan_count[land_use] = self._table.count(land_use)

    def _update_stats(self, land_use_type: int, land_use_area: float) -> None:
        self._plan_count[land_use_type] += 1
        self._plan_area[land_use_type] += land_use_area
        self._plan_ratio[land_use_type] = \
            self._plan_area[land_use_type] / self._community_area
        self._plan_area[city_config.FEASIBLE] -= land_use_area
        self._plan_ratio[city_config.FEASIBLE] = \
            self._plan_area[city_config.FEASIBLE] / self._community_area

    def get_requirements(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._required_plan_ratio, self._required_plan_count

    def get_plan_ratio_and_count(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self._plan_ratio.astype(np.float32),
                self._plan_count.astype(np.int32))

    # ------------------------------------------------------------------
    # contiguity graph (reference plan_client.py:250-263)
    # ------------------------------------------------------------------
    def _feature_segments(self, rows: np.ndarray):
        """Decompose features into segments tagged with their feature index."""
        segs = []
        owner = []
        for k, row in enumerate(rows):
            g = self._table.geoms[row]
            if g.kind == POINT:
                segs.append(np.stack([g.coords[0], g.coords[0]]))
                owner.append(k)
            elif g.kind == LINE:
                for i in range(len(g.coords) - 1):
                    segs.append(g.coords[i:i + 2])
                    owner.append(k)
            else:
                c = g.coords
                for i in range(len(c)):
                    segs.append(np.stack([c[i], c[(i + 1) % len(c)]]))
                    owner.append(k)
        return np.asarray(segs), np.asarray(owner, dtype=np.int64)

    def _get_current_graph(self) -> None:
        """Rebuild the alive-feature view and its contiguity edges.

        Uses the native grid-hash kernel (native/contiguity.cpp) when
        available; otherwise the vectorized numpy distance matrix."""
        if self._graph_version == self._table_version:
            return
        rows = self._table.alive_rows()
        n = len(rows)
        segs, owner = self._feature_segments(rows)
        from urban_tpu_torch.host.geometry import native
        pairs = native.contiguity_pairs(segs, owner, n, self.CONTIG_TOL) \
            if native.available() else None
        if pairs is not None:
            order = np.lexsort((pairs[:, 1], pairs[:, 0]))
            self._current_edges = pairs[order].astype(np.int64)
        else:
            dmat = ops.segment_distance_matrix(segs, segs)
            touch = dmat <= self.CONTIG_TOL
            adj = np.zeros((n, n), dtype=bool)
            np.logical_or.at(adj, (owner[:, None], owner[None, :]), touch)
            iu, ju = np.nonzero(np.triu(adj, k=1))
            self._current_edges = np.stack([iu, ju], axis=1) if len(iu) \
                else np.zeros((0, 2), dtype=np.int64)
        self._current_rows = rows
        self._graph_version = self._table_version

    def _get_current_gdf_and_graph(self):
        self._get_current_graph()
        return self._current_rows, self._current_edges

    # ------------------------------------------------------------------
    # masks (reference plan_client.py:265-359)
    # ------------------------------------------------------------------
    def _filter_block_by_rule(self, rows: np.ndarray,
                              feasible_rows: np.ndarray,
                              land_use_type: int) -> np.ndarray:
        """School/hospital adjacency filter (plan_client.py:265-287)."""
        if land_use_type == city_config.SCHOOL:
            avoid_types = (city_config.HOSPITAL_L,)
        elif land_use_type == city_config.HOSPITAL_S:
            avoid_types = (city_config.SCHOOL, city_config.HOSPITAL_L,
                           city_config.HOSPITAL_S)
        else:
            return feasible_rows
        avoid_geoms = [self._table.geoms[r] for r in rows
                       if self._table.types[r] in avoid_types]
        if not avoid_geoms:
            return feasible_rows
        keep = []
        for r in feasible_rows:
            g = self._table.geoms[r]
            if not any(ops.geometries_intersect(g, ag, tol=self.CONTIG_TOL)
                       for ag in avoid_geoms):
                keep.append(r)
        return np.asarray(keep, dtype=feasible_rows.dtype)

    def _get_graph_edge_mask(self, land_use_type: int) -> np.ndarray:
        """Mask of graph edges joining a large-enough feasible block with an
        intersection (plan_client.py:289-322)."""
        rows, edges = self._get_current_gdf_and_graph()
        types = self._table.types[rows]
        kinds = np.array([self._table.geoms[r].kind for r in rows])
        areas = np.array([self._table.geoms[r].area for r in rows])
        feasible = (types == city_config.FEASIBLE) & \
                   (areas * self._cell_area >=
                    self._required_min_area[land_use_type])
        feasible_rows = rows[feasible]
        if self._rule_constraints:
            feasible_rows = self._filter_block_by_rule(rows, feasible_rows,
                                                       land_use_type)
        feasible_pos = np.isin(rows, feasible_rows)
        inter_pos = kinds == POINT
        if len(edges) == 0:
            return np.zeros(0, dtype=bool)
        e0, e1 = edges[:, 0], edges[:, 1]
        mask = (feasible_pos[e0] & inter_pos[e1]) | \
               (feasible_pos[e1] & inter_pos[e0])
        return mask

    def get_current_land_use_and_mask(self) -> Tuple[Dict, np.ndarray]:
        """Next land use to place + its action mask (plan_client.py:324-346)."""
        remaining_area = (self._required_plan_area - self._plan_area)[self._plan_order]
        remaining_count = (self._required_plan_count - self._plan_count)[self._plan_order]
        pending = self._plan_order[
            np.logical_or(remaining_area > self.EPSILON, remaining_count > 0)]
        land_use_type = int(pending[0])
        mask = self._get_graph_edge_mask(land_use_type)
        land_use = {
            'type': land_use_type,
            'x': 0.5, 'y': 0.5,
            'area': float(self._required_max_area[land_use_type]),
            'length': float(4 * self._required_max_edge_length[land_use_type]),
            'width': float(self._required_max_edge_length[land_use_type]),
            'height': float(self._required_max_edge_length[land_use_type]),
            'rect': 1.0, 'eqi': 1.0, 'sc': 1.0,
        }
        return land_use, mask

    def get_current_road_mask(self) -> np.ndarray:
        """Boundary-node mask for the road stage (plan_client.py:348-359)."""
        rows, _ = self._get_current_gdf_and_graph()
        return self._table.types[rows] == city_config.BOUNDARY

    # ------------------------------------------------------------------
    # land-use placement (reference plan_client.py:361-733)
    # ------------------------------------------------------------------
    def _alive_intersections(self) -> np.ndarray:
        rows = self._table.alive_rows()
        pts = [self._table.geoms[r].coords[0] for r in rows
               if self._table.geoms[r].kind == POINT]
        return np.asarray(pts) if pts else np.zeros((0, 2))

    def _slice_polygon(self, polygon: Geometry, intersection: np.ndarray,
                       land_use_type: int) -> Geometry:
        """Slice a parcel for land_use_type (plan_client.py:404-443)."""
        search_max_length = (self._required_max_edge_length[land_use_type]
                             + self._common_min_edge_length)
        return slice_polygon(
            polygon, intersection, self._alive_intersections(),
            cell_edge_length=self._cell_edge_length,
            min_edge_length=float(self._required_min_edge_length[land_use_type]),
            max_edge_length=float(self._required_max_edge_length[land_use_type]),
            search_max_length=float(search_max_length),
            search_max_area=float(self._required_max_area[land_use_type]),
            search_min_area=float(self._required_min_area[land_use_type]),
            epsilon=self.EPSILON, deg_tol=self.DEG_TOL)

    def _simplify_snap_polygon(self, polygon: Geometry):
        """Simplify + snap a new parcel to existing intersections; find which
        of its vertices are new (plan_client.py:473-512)."""
        snap_tol = self.SNAP_EPSILON / self._cell_edge_length
        ring = polygon.canonicalize().coords
        ring = ops.simplify_ring_dp(ring, snap_tol)
        ring = ops.simplify_ring_by_distance(ring, self.EPSILON)
        existing = self._alive_intersections()
        geom = ops.snap_geometry(Geometry(POLY, ring), existing, snap_tol)
        if not geom.is_poly or geom.area <= 0:
            raise SliceError('Land_use polygon is not a polygon after '
                             'simplify and snap.')
        verts = geom.coords
        if len(existing):
            d = np.linalg.norm(verts[:, None, :] - existing[None, :, :], axis=-1)
            is_new = d.min(axis=1) > 1e-9
        else:
            is_new = np.ones(len(verts), dtype=bool)
        new_intersections = [verts[i] for i in range(len(verts)) if is_new[i]]
        return geom, verts, new_intersections

    def _add_new_intersections(self, land_use_polygon: Geometry,
                               intersections: np.ndarray,
                               new_intersections: List[np.ndarray]) -> None:
        """Insert new intersection points, splitting any line they fall on
        (plan_client.py:514-558)."""
        if len(new_intersections) == len(intersections):
            raise SliceError(
                'All new intersections without any old intersections!')
        for new_pt in new_intersections:
            self._table.append(self._counter(), city_config.INTERSECTION,
                               Geometry(POINT, new_pt[None, :]))
            rows = self._table.alive_rows()
            line_rows = [r for r in rows if self._table.geoms[r].kind == LINE]
            hits = []
            for r in line_rows:
                g = self._table.geoms[r]
                d = ops.point_segment_distance(new_pt, g.coords[:-1],
                                               g.coords[1:]).min()
                if d < self.EPSILON:
                    # a hit at an endpoint is not a split
                    if (np.linalg.norm(g.coords[0] - new_pt) > self.EPSILON
                            and np.linalg.norm(g.coords[-1] - new_pt) > self.EPSILON):
                        hits.append(r)
            if len(hits) > 1:
                raise SliceError('New intersection is located at more than 1 '
                                 'existing roads or boundaries.')
            if len(hits) == 1:
                r = hits[0]
                g = self._table.geoms[r]
                ftype = int(self._table.types[r])
                self._table.append(self._counter(), ftype,
                                   Geometry(LINE, np.stack([g.coords[0], new_pt])))
                self._table.append(self._counter(), ftype,
                                   Geometry(LINE, np.stack([g.coords[-1], new_pt])))
                self._table.kill(r)
            # snap all alive geometries onto the new intersection
            for r in self._table.alive_rows():
                g = self._table.geoms[r]
                if g.kind == POINT:
                    continue
                self._table.geoms[r] = ops.snap_geometry(
                    g, new_pt[None, :], self.EPSILON)
        self._bump()

    def _add_new_boundaries(self, land_use_polygon: Geometry) -> None:
        """Add the parcel's boundary edges not already covered by existing
        lines (plan_client.py:560-588)."""
        rows = self._table.alive_rows()
        line_segs = []
        for r in rows:
            g = self._table.geoms[r]
            if g.kind == LINE:
                for i in range(len(g.coords) - 1):
                    line_segs.append((g.coords[i], g.coords[i + 1]))
        ring = land_use_polygon.coords
        for i in range(len(ring)):
            a, b = ring[i], ring[(i + 1) % len(ring)]
            pieces = _subtract_collinear(a, b, line_segs, self.EPSILON)
            for pa, pb in pieces:
                self._table.append(self._counter(), city_config.BOUNDARY,
                                   Geometry(LINE, np.stack([pa, pb])))
        self._bump()

    def _add_land_use_polygon(self, land_use_polygon: Geometry,
                              land_use_type: int) -> None:
        self._table.append(self._counter(), land_use_type, land_use_polygon,
                           with_metrics=True)
        self._bump()

    def _update_gdf(self, land_use_polygon: Geometry, land_use_type: int,
                    build_boundary: bool = True) -> Geometry:
        """Simplify/snap a new polygon and insert it with its intersections
        and boundaries (plan_client.py:623-652)."""
        geom, verts, new_intersections = self._simplify_snap_polygon(land_use_polygon)
        if not build_boundary:
            if len(new_intersections) > 0:
                raise SliceError('Update polygon without building boundaries '
                                 'creates new points.')
            self._add_land_use_polygon(geom, land_use_type)
            return geom
        self._add_new_intersections(geom, verts, new_intersections)
        self._add_new_boundaries(geom)
        self._add_land_use_polygon(geom, land_use_type)
        return geom

    def _add_remaining_feasible_blocks(self, remaining: List[Geometry]) -> None:
        """Re-add leftover feasible pieces (plan_client.py:445-471)."""
        for piece in remaining:
            self._update_gdf(piece, city_config.FEASIBLE, build_boundary=False)

    def _use_whole_feasible(self, feasible_polygon: Geometry,
                            land_use_type: int) -> Geometry:
        return self._update_gdf(feasible_polygon, land_use_type,
                                build_boundary=False)

    def _get_chosen_feasible_block_and_intersection(self, action: int):
        rows, edges = self._current_rows, self._current_edges
        i, j = edges[action]
        ri, rj = rows[i], rows[j]
        if self._table.types[ri] == city_config.FEASIBLE:
            return ri, rj
        return rj, ri

    def _place_land_use(self, land_use_type: int, feasible_row: int,
                        intersection_row: int) -> Tuple[float, int]:
        """Core placement (plan_client.py:681-719)."""
        actual_type = land_use_type
        feasible_polygon = self._table.geoms[feasible_row]
        if feasible_polygon.area * self._cell_area <= \
                self._required_max_area[land_use_type]:
            land_use_polygon = self._use_whole_feasible(feasible_polygon,
                                                        land_use_type)
        else:
            intersection = self._table.geoms[intersection_row].coords[0]
            land_use_polygon = self._slice_polygon(feasible_polygon,
                                                   intersection, land_use_type)
            if land_use_polygon.area < self.EPSILON:
                raise SliceError('The area of sliced land_use_polygon is near 0.')
            if (feasible_polygon.area - land_use_polygon.area) * self._cell_area \
                    <= self._common_min_area:
                land_use_polygon = self._use_whole_feasible(feasible_polygon,
                                                            land_use_type)
            else:
                remaining = _difference_pieces(feasible_polygon, land_use_polygon)
                if land_use_polygon.area * self._cell_area < \
                        self._required_min_area[land_use_type]:
                    land_use_polygon = self._update_gdf(land_use_polygon,
                                                        city_config.GREEN_S)
                    actual_type = city_config.GREEN_S
                else:
                    land_use_polygon = self._update_gdf(land_use_polygon,
                                                        land_use_type)
                self._add_remaining_feasible_blocks(remaining)
        self._table.kill(feasible_row)
        self._bump()
        return land_use_polygon.area * self._cell_area, actual_type

    def place_land_use(self, land_use: Dict, action: int) -> None:
        """Place the pending land use at the chosen graph edge
        (plan_client.py:721-733)."""
        feasible_row, intersection_row = \
            self._get_chosen_feasible_block_and_intersection(action)
        area, actual_type = self._place_land_use(land_use['type'],
                                                 feasible_row, intersection_row)
        self._update_stats(actual_type, area)

    # ------------------------------------------------------------------
    # roads (reference plan_client.py:735-759)
    # ------------------------------------------------------------------
    def build_road(self, action: int) -> None:
        row = self._current_rows[action]
        if self._table.types[row] != city_config.BOUNDARY:
            raise SliceError('The build road action is not boundary node.')
        self._table.types[row] = city_config.ROAD
        self._bump()

    # ------------------------------------------------------------------
    # observation features (reference plan_client.py:798-825)
    # ------------------------------------------------------------------
    def get_graph_features(self):
        rows, edges = self._get_current_gdf_and_graph()
        n = len(rows)
        node_type = self._table.types[rows].astype(np.int32)
        coords = np.zeros((n, 2))
        area = np.zeros(n, dtype=np.float32)
        length = np.zeros(n, dtype=np.float32)
        width = np.zeros(n, dtype=np.float32)
        height = np.zeros(n, dtype=np.float32)
        domain = np.zeros((n, 3))
        for k, r in enumerate(rows):
            g = self._table.geoms[r]
            c = g.centroid
            coords[k] = (c[0] / self._grid_cols, c[1] / self._grid_rows)
            area[k] = g.area * self._cell_area
            length[k] = g.length * self._cell_edge_length
            x0, y0, x1, y1 = g.bounds
            width[k] = (x1 - x0) * self._cell_edge_length
            height[k] = (y1 - y0) * self._cell_edge_length
            domain[k] = [_nan_to(self._table.rect[r], 0.5),
                         _nan_to(self._table.eqi[r], 0.5),
                         _nan_to(self._table.sc[r], 0.5)]
        return (node_type, coords, area, length, width, height, domain,
                edges.astype(np.int64))

    # ------------------------------------------------------------------
    # rewards (reference plan_client.py:777-1062)
    # ------------------------------------------------------------------
    def _road_segments(self, types: Tuple[int, ...]) -> List[np.ndarray]:
        rows = self._table.alive_rows()
        return [self._table.geoms[r].coords for r in rows
                if self._table.types[r] in types
                and self._table.geoms[r].kind == LINE]

    def get_road_network_reward(self) -> Tuple[float, Dict]:
        """Road-network quality (plan_client.py:833-887)."""
        road_lines = self._road_segments((city_config.ROAD,))
        # primal graph: one edge per road line between its endpoints
        nodes, edges, _ = ggraph.segment_graph(
            [np.stack([line[0], line[-1]]) for line in road_lines])
        n_comp = ggraph.connected_components(len(nodes), edges) if nodes else 1
        connectivity_reward = 1.0 / max(n_comp, 1)

        road_total_km = sum(Geometry(LINE, line).length for line in road_lines) \
            * self._cell_edge_length / 1000.0
        community_km2 = self._community_area / 1e6
        density = road_total_km / community_km2 if community_km2 > 0 else 0.0
        density_reward = density / 10.0

        deg = ggraph.node_degrees(len(nodes), edges)
        num_dead_end = int(np.count_nonzero(deg == 1))
        dead_end_penalty = 1.0 / (num_dead_end + 1)

        merged_lengths = np.asarray(ggraph.merge_false_nodes(road_lines))
        merged_m = merged_lengths * self._cell_edge_length
        short_road_penalty = 1.0 / (int((merged_m < 100).sum()) + 1)
        long_road_penalty = 1.0 / (int((merged_m > 600).sum()) + 1)

        blocks = ggraph.polygonize(road_lines)
        num_large = 0
        for b in blocks:
            w = (b[:, 0].max() - b[:, 0].min()) * self._cell_edge_length
            h = (b[:, 1].max() - b[:, 1].min()) * self._cell_edge_length
            if w > 800 or h > 800:
                num_large += 1
        road_distance_penalty = 1.0 / (num_large + 1)

        reward = (connectivity_reward + density_reward + dead_end_penalty
                  + short_road_penalty + long_road_penalty
                  + road_distance_penalty) / 6.0
        info = {'connectivity_reward': connectivity_reward,
                'density_reward': density_reward,
                'dead_end_penalty': dead_end_penalty,
                'short_road_penalty': short_road_penalty,
                'long_road_penalty': long_road_penalty,
                'road_distance_penalty': road_distance_penalty}
        return reward, info

    def get_life_circle_reward(self, weight_by_area: bool = False
                               ) -> Tuple[float, Dict]:
        """15-minute life-circle service coverage (plan_client.py:889-952)."""
        rows = self._table.alive_rows()
        types = self._table.types[rows]
        res_rows = rows[types == city_config.RESIDENTIAL]
        if len(res_rows) == 0:
            return 0.0, dict()
        res_centroids = np.stack([self._table.geoms[r].centroid for r in res_rows])
        res_area = np.array([self._table.geoms[r].area for r in res_rows])

        num_service = 0
        min_dists = []
        pairwise = []
        service_area = 0.0
        for service in city_config.PUBLIC_SERVICES_ID:
            svc = service if isinstance(service, tuple) else (service,)
            svc_rows = rows[np.isin(types, svc)]
            if len(svc_rows) == 0:
                continue
            svc_centroids = np.stack([self._table.geoms[r].centroid
                                      for r in svc_rows])
            d = np.linalg.norm(res_centroids[:, None, :]
                               - svc_centroids[None, :, :], axis=-1)
            min_dists.append(d.min(axis=1))
            num_service += 1
            service_area += sum(self._table.geoms[r].area
                                for r in svc_rows) * self._cell_area
            if len(svc_rows) > 1:
                pd = np.linalg.norm(svc_centroids[:, None, :]
                                    - svc_centroids[None, :, :], axis=-1)
                pairwise.append(float(pd[pd > 0].mean()))

        if num_service == 0:
            return 0.0, dict()
        dist = np.column_stack(min_dists) * self._cell_edge_length
        life_15 = (dist <= 1000).sum(axis=1) / num_service
        life_10 = (dist <= 500).sum(axis=1) / num_service
        life_5 = (dist <= 300).sum(axis=1) / num_service
        if weight_by_area:
            efficiency = float(np.average(life_10, weights=res_area))
        else:
            efficiency = float(life_10.mean())
        reference_distance = math.sqrt(self._grid_cols ** 2 + self._grid_rows ** 2)
        decentral = (float(np.mean(pairwise)) / reference_distance
                     if pairwise else 0.0)
        utility = service_area / self._community_area
        reward = efficiency + 0.05 * decentral
        info = {'life_circle_15min': float(life_15.mean()),
                'life_circle_10min': float(life_10.mean()),
                'life_circle_5min': float(life_5.mean()),
                'life_circle_10min_area': float(np.average(life_10,
                                                           weights=res_area)),
                'decentralization_reward': decentral,
                'utility': utility}
        per_service = (dist <= 500).sum(axis=0) / dist.shape[0]
        svc_idx = 0
        for service, name in zip(city_config.PUBLIC_SERVICES_ID,
                                 city_config.PUBLIC_SERVICES):
            svc = service if isinstance(service, tuple) else (service,)
            if np.isin(types, svc).any():
                info[name] = float(per_service[svc_idx])
                svc_idx += 1
        return reward, info

    def get_greenness_reward(self) -> float:
        """Share of residential area within 300 m of large green space
        (plan_client.py:954-967). Computed on a raster (the reference uses
        GEOS round buffers; rasterization converges to the same value and is
        the same formulation used on the TPU path)."""
        rows = self._table.alive_rows()
        types = self._table.types[rows]
        green_rows = [r for r in rows[np.isin(types, city_config.GREEN_ID)]
                      if self._table.geoms[r].area * self._cell_area
                      >= city_config.GREEN_AREA_THRESHOLD]
        res_rows = rows[types == city_config.RESIDENTIAL]
        if len(res_rows) == 0:
            return 0.0
        radius = 300.0 / self._cell_edge_length
        res_mask, cell_xy = self._rasterize_rows(res_rows)
        if not res_mask.any():
            return 0.0
        if not green_rows:
            return 0.0
        covered = np.zeros_like(res_mask)
        pts = cell_xy[res_mask]
        near = np.zeros(len(pts), dtype=bool)
        for r in green_rows:
            g = self._table.geoms[r]
            todo = ~near
            if not todo.any():
                break
            near[todo] |= _points_within_ring_distance(pts[todo], g.coords, radius)
        return float(near.sum() / res_mask.sum())

    def _rasterize_rows(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Raster mask over the community for the union of given polygons."""
        res = self.GREEN_RASTER
        nx = res
        ny = max(1, int(round(res * self._grid_rows / self._grid_cols)))
        xs = (np.arange(nx) + 0.5) * self._grid_cols / nx
        ys = (np.arange(ny) + 0.5) * self._grid_rows / ny
        gx, gy = np.meshgrid(xs, ys, indexing='ij')
        pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
        mask = np.zeros(len(pts), dtype=bool)
        for r in rows:
            g = self._table.geoms[r]
            todo = ~mask
            if not todo.any():
                break
            mask[todo] |= _points_in_ring(pts[todo], g.coords)
        return mask, pts

    def get_concept_reward(self) -> Tuple[float, Dict]:
        """Planning-concept adherence (plan_client.py:969-1062)."""
        if len(self._concept) == 0:
            raise ValueError('The concept list is empty.')
        rows = self._table.alive_rows()
        poly_rows = [r for r in rows if self._table.geoms[r].kind == POLY]
        reward = 0.0
        info: Dict = {}
        for i, concept in enumerate(self._concept):
            if concept['type'] == 'center':
                r, ci = self._center_concept(poly_rows, concept)
                info[f'{i}_center'] = ci
            elif concept['type'] == 'axis':
                r, ci = self._axis_concept(poly_rows, concept)
                info[f'{i}_axis'] = ci
            else:
                raise ValueError(
                    f'The concept type {concept["type"]} is not supported.')
            reward += r
        return reward / len(self._concept), info

    def _center_concept(self, poly_rows, concept):
        center = concept['geometry'].coords[0]
        radius = concept['distance'] / self._cell_edge_length
        related = set(int(t) for t in concept['land_use'])
        in_circle = [r for r in poly_rows
                     if ops.point_ring_distance(center,
                                                self._table.geoms[r].coords)
                     <= radius]
        if not in_circle:
            return 0.0, {'center': tuple(center),
                         'distance_threshold': concept['distance'],
                         'related_land_use': sorted(related),
                         'related_land_use_ratio': 0.0}
        n_related = sum(1 for r in in_circle
                        if int(self._table.types[r]) in related)
        ratio = n_related / len(in_circle)
        info = {'center': tuple(center),
                'distance_threshold': concept['distance'],
                'related_land_use': sorted(related),
                'related_land_use_ratio': ratio}
        return ratio, info

    def _axis_concept(self, poly_rows, concept):
        axis = concept['geometry']
        band = concept['distance'] / self._cell_edge_length
        related = set(int(t) for t in concept['land_use'])
        a, b = axis.coords[0], axis.coords[-1]
        in_band = []
        for r in poly_rows:
            ring = self._table.geoms[r].coords
            d = ops.point_segment_distance(ring, a[None], b[None]).min()
            if d <= band or ops.point_in_ring(0.5 * (a + b), ring) >= 0:
                in_band.append(r)
        related_rows = [r for r in in_band
                        if int(self._table.types[r]) in related]
        base_info = {'axis': [tuple(c) for c in axis.coords],
                     'distance_threshold': concept['distance'],
                     'related_land_use': sorted(related)}
        if not related_rows:
            return 0.0, {**base_info, 'related_land_use_ratio': 0.0,
                         'related_land_use_type': 0.0,
                         'related_land_use_expand': 0.0}
        ratio = len(related_rows) / len(in_band)
        n_types = len({int(self._table.types[r]) for r in related_rows})
        type_ratio = n_types / len(related)
        ab = b - a
        denom = float(np.dot(ab, ab))
        projections = []
        for r in related_rows:
            c = self._table.geoms[r].centroid
            t = float(np.dot(c - a, ab)) / denom if denom > 0 else 0.0
            projections.append(min(max(t, 0.0), 1.0))
        expand = max(projections) - min(projections)
        reward = (ratio + type_ratio + expand) / 3.0
        return reward, {**base_info, 'related_land_use_ratio': ratio,
                        'related_land_use_type': type_ratio,
                        'related_land_use_expand': expand}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _nan_to(v: float, default: float) -> float:
    return default if (v is None or math.isnan(v)) else float(v)


def _points_in_ring(pts: np.ndarray, ring: np.ndarray) -> np.ndarray:
    """Vectorized crossing-number point-in-polygon for many points."""
    # bbox prefilter: rasters sweep the whole community while polygons are
    # small, so the O(pts x edges) crossing test only runs on candidates
    lo, hi = ring.min(axis=0), ring.max(axis=0)
    box = np.all((pts >= lo) & (pts <= hi), axis=1)
    if not box.all():
        out = np.zeros(len(pts), dtype=bool)
        if box.any():
            out[box] = _points_in_ring(pts[box], ring)
        return out
    x, y = pts[:, 0], pts[:, 1]
    a = ring
    b = np.roll(ring, -1, axis=0)
    ax, ay = a[:, 0][None, :], a[:, 1][None, :]
    bx, by = b[:, 0][None, :], b[:, 1][None, :]
    yy = y[:, None]
    xx = x[:, None]
    cond = (ay > yy) != (by > yy)
    with np.errstate(divide='ignore', invalid='ignore'):
        xin = ax + (yy - ay) * (bx - ax) / (by - ay)
    crossings = np.count_nonzero(cond & (xx < xin), axis=1)
    return crossings % 2 == 1


def _points_within_ring_distance(pts: np.ndarray, ring: np.ndarray,
                                 radius: float) -> np.ndarray:
    """True for points within `radius` of the polygon (inside counts)."""
    # bbox-expanded prefilter (identical result, avoids the O(pts x edges)
    # distance matrix on raster-scale point sets)
    lo, hi = ring.min(axis=0) - radius, ring.max(axis=0) + radius
    box = np.all((pts >= lo) & (pts <= hi), axis=1)
    if not box.all():
        out = np.zeros(len(pts), dtype=bool)
        if box.any():
            out[box] = _points_within_ring_distance(pts[box], ring, radius)
        return out
    a = ring
    b = np.roll(ring, -1, axis=0)
    d = ops.point_segment_distance(pts[:, None, :], a[None], b[None]).min(axis=1)
    inside = _points_in_ring(pts, ring)
    return inside | (d <= radius)


def _subtract_collinear(a: np.ndarray, b: np.ndarray, segments, tol: float):
    """Remove from segment a-b the parts covered by collinear existing
    segments; return the leftover sub-segments (new boundaries)."""
    ab = b - a
    length = float(np.linalg.norm(ab))
    if length < tol:
        return []
    u = ab / length
    covered = []
    for (p, q) in segments:
        # both endpoints close to the line through a-b, and overlapping range
        dp = abs(u[0] * (p - a)[1] - u[1] * (p - a)[0])
        dq = abs(u[0] * (q - a)[1] - u[1] * (q - a)[0])
        if dp > tol or dq > tol:
            continue
        tp = float(np.dot(p - a, u))
        tq = float(np.dot(q - a, u))
        lo, hi = sorted((tp, tq))
        lo = max(lo, 0.0)
        hi = min(hi, length)
        if hi - lo > tol:
            covered.append((lo, hi))
    covered.sort()
    pieces = []
    cursor = 0.0
    for lo, hi in covered:
        if lo - cursor > tol:
            pieces.append((a + u * cursor, a + u * lo))
        cursor = max(cursor, hi)
    if length - cursor > tol:
        pieces.append((a + u * cursor, a + u * length))
    return pieces


def _difference_pieces(feasible: Geometry, land_use: Geometry) -> List[Geometry]:
    """Remaining feasible pieces = feasible \\ land_use.

    The parcel is a clipped convex cutter; its convex hull acts as the cutter
    for an exact convex difference. Raises when the leftover is degenerate
    (reference plan_client.py:460-471)."""
    cutter = ops.convex_hull(land_use.coords)
    pieces = ops.difference_convex(feasible.coords, cutter, min_area=1e-9)
    out = [Geometry(POLY, ops.ensure_ccw(p)) for p in pieces]
    remaining_area = sum(p.area for p in out)
    if remaining_area <= 0 and not land_use.almost_equals(feasible, tol=1e-6):
        if abs(feasible.area - land_use.area) > 1e-6:
            raise SliceError('The area of remaining feasible region is 0, but '
                             'land_use does not equal feasible.')
    return out
