"""Fixed-buffer plan state for the batched environment (counterpart of
urban_tpu/jaxenv/state.py).

The plan lives in preallocated slot tables with alive masks:

  * polygons:   (NP, KV, 2) vertex rings + count/type/alive + shape metrics
  * segments:   (NS, 2, 2) road/boundary segments + type/alive
  * points:     (NPT, 2) road intersections + alive
  * contiguity: (NE, 2) global-feature-index pairs + alive
    (global index: poly i -> i, seg j -> NP+j, point k -> NP+NS+k)

Coordinates are stored with a trailing (…, 2) axis; the JAX state stores
them flat for the TPU's (8, 128) tiling, and ``plan_state_from_numpy`` /
``plan_state_to_numpy`` map between the two. Initial states are built on
the host from a scenario bundle with the exact host engine.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace as dc_replace
from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from urban_tpu_torch.host import city_config
from urban_tpu_torch.host.envs.plan_client import PlanClient
from urban_tpu_torch.host.geometry.base import LINE, POINT, POLY


@dataclass(frozen=True)
class PlanState:
    # polygons
    poly_ring: torch.Tensor     # (NP, KV, 2) f32
    poly_nvert: torch.Tensor    # (NP,) i32
    poly_type: torch.Tensor     # (NP,) i32
    poly_alive: torch.Tensor    # (NP,) bool
    poly_rect: torch.Tensor     # (NP,) f32
    poly_eqi: torch.Tensor      # (NP,) f32
    poly_sc: torch.Tensor       # (NP,) f32
    # segments
    seg: torch.Tensor           # (NS, 2, 2) f32
    seg_type: torch.Tensor      # (NS,) i32
    seg_alive: torch.Tensor     # (NS,) bool
    # points
    pt: torch.Tensor            # (NPT, 2) f32
    pt_alive: torch.Tensor      # (NPT,) bool
    # cached polygon features:
    # rows = [area, cx, cy, perimeter, minx, miny, maxx, maxy] (grid units)
    poly_feat: torch.Tensor     # (8, NP) f32
    # contiguity edges
    edge: torch.Tensor          # (NE, 2) i32 global feature indices
    edge_alive: torch.Tensor    # (NE,) bool
    # feature-to-intersection incidence: I[f, p] = feature f touches point p
    incidence: torch.Tensor     # (NF, NPT) bool
    # running stats (areas in m^2)
    plan_area: torch.Tensor     # (NUM_TYPES,) f32
    plan_count: torch.Tensor    # (NUM_TYPES,) i32
    # stage machine
    stage: torch.Tensor         # () i32: 0 land_use, 1 road, 2 done
    land_use_steps: torch.Tensor  # () i32
    road_steps: torch.Tensor    # () i32
    total_road_steps: torch.Tensor  # () i32
    done: torch.Tensor          # () bool
    failure: torch.Tensor       # () bool
    land_use_reward: torch.Tensor  # () f32 cached at stage boundary

    def replace(self, **kw) -> 'PlanState':
        return dc_replace(self, **kw)

    def map(self, fn) -> 'PlanState':
        return PlanState(*(fn(getattr(self, f.name)) for f in fields(self)))


FIELD_NAMES = tuple(f.name for f in fields(PlanState))

# canonical dtype of every field (the JAX state's dtypes)
_I32 = ('poly_nvert', 'poly_type', 'seg_type', 'edge', 'plan_count', 'stage',
        'land_use_steps', 'road_steps', 'total_road_steps')
_BOOL = ('poly_alive', 'seg_alive', 'pt_alive', 'edge_alive', 'incidence',
         'done', 'failure')
FIELD_DTYPES = {n: (torch.int32 if n in _I32 else
                    torch.bool if n in _BOOL else torch.float32)
                for n in FIELD_NAMES}

# JAX field with flat coordinates -> port field: the JAX field's last axis
# holds (x, y) pairs, which the port keeps as a trailing axis of 2
_FLAT_FIELDS = {'poly_ring_flat': 'poly_ring', 'seg_flat': 'seg',
                'pt_flat': 'pt'}

pytree.register_pytree_node(
    PlanState,
    lambda s: ([getattr(s, n) for n in FIELD_NAMES], None),
    lambda children, _: PlanState(*children))


def canonical(state: PlanState) -> PlanState:
    """Cast every field to its canonical dtype."""
    return PlanState(*(getattr(state, n).to(FIELD_DTYPES[n])
                       for n in FIELD_NAMES))


def plan_state_from_numpy(d: Dict[str, np.ndarray], device) -> PlanState:
    """Port state from a dict of numpy arrays keyed by the JAX PlanState
    field names (flat coordinate layout). Works batched or not."""
    out = {}
    for name, arr in d.items():
        arr = np.asarray(arr)
        if name in _FLAT_FIELDS:
            arr = arr.reshape(arr.shape[:-1] + (arr.shape[-1] // 2, 2))
            name = _FLAT_FIELDS[name]
        if name not in FIELD_DTYPES:
            raise KeyError(f'unknown PlanState field {name!r}')
        out[name] = torch.as_tensor(np.array(arr), device=device).to(FIELD_DTYPES[name])
    missing = set(FIELD_NAMES) - set(out)
    if missing:
        raise KeyError(f'missing PlanState fields {sorted(missing)}')
    return PlanState(**out)


def plan_state_to_numpy(state: PlanState) -> Dict[str, np.ndarray]:
    """Inverse of plan_state_from_numpy: JAX field names, flat layout."""
    out = {}
    inv = {port: jax_name for jax_name, port in _FLAT_FIELDS.items()}
    for name in FIELD_NAMES:
        arr = getattr(state, name).detach().cpu().numpy()
        if name in inv:
            arr = arr.reshape(arr.shape[:-2] + (arr.shape[-2] * 2,))
            name = inv[name]
        out[name] = arr
    return out


@dataclass(frozen=True)
class EnvSpec:
    """Static scenario + capacity configuration."""
    # capacities
    NP: int
    KV: int
    NS: int
    NPT: int
    NE: int
    max_num_nodes: int
    max_num_edges: int
    # community
    grid_cols: float
    grid_rows: float
    cell_edge_length: float
    community_area: float
    # objectives
    plan_order: Tuple[int, ...]
    required_plan_ratio: Tuple[float, ...]
    required_plan_count: Tuple[int, ...]
    required_max_area: Tuple[float, ...]
    required_min_area: Tuple[float, ...]
    required_max_edge_length: Tuple[float, ...]
    required_min_edge_length: Tuple[float, ...]
    common_max_area: float
    common_min_area: float
    common_max_edge_length: float
    common_min_edge_length: float
    rule_constraints: bool
    # stage config
    skip_land_use: bool
    skip_road: bool
    road_ratio: float
    # reward weights
    road_network_weight: float
    life_circle_weight: float
    greenness_weight: float
    concept_weight: float
    weight_by_area: bool
    # concepts: ((kind, cx, cy, ex, ey, distance, land_use_bitmask), ...)
    concepts: Tuple[Tuple[float, ...], ...] = ()
    # two-phase training: keep BOUNDARY segments at land-use completion
    keep_boundaries: bool = False

    @property
    def num_features(self) -> int:
        return self.NP + self.NS + self.NPT


def _default_caps(n_poly: int, n_seg: int, n_pt: int,
                  max_steps: int) -> Dict[str, int]:
    """Slot capacities: initial features plus worst-case growth.

    Each land-use step adds <= 1 parcel + 4 remaining pieces, <= 6 new
    intersections, and <= 2 splits + ring-edge boundaries."""
    def rup(x, m=64):
        return int(np.ceil(x / m) * m)
    return dict(
        NP=rup(n_poly + 5 * max_steps),
        NS=rup(n_seg + 10 * max_steps),
        NPT=rup(n_pt + 6 * max_steps),
    )


def build_env_spec(cfg, plc: PlanClient, max_steps: int = 60,
                   caps: Dict[str, int] | None = None,
                   keep_boundaries: bool = False) -> EnvSpec:
    """Derive the static spec from a config + host PlanClient."""
    table = plc._init_table
    kinds = np.array([g.kind for g in table.geoms])
    n_poly = int((kinds == POLY).sum())
    n_seg = int((kinds == LINE).sum())
    n_pt = int((kinds == POINT).sum())
    c = _default_caps(n_poly, n_seg, n_pt, max_steps)
    if caps:
        c.update(caps)
    kv = caps.get('KV', 24) if caps else 24
    ne = caps.get('NE', cfg.state_encoder_specs['max_num_edges']) if caps \
        else cfg.state_encoder_specs['max_num_edges']

    concepts = []
    for concept in plc._concept:
        g = concept['geometry'].coords
        cx, cy = g[0]
        ex, ey = g[-1]
        kind = 0.0 if concept['type'] == 'center' else 1.0
        bitmask = 0
        for t in concept['land_use']:
            bitmask |= 1 << int(t)
        concepts.append((kind, float(cx), float(cy), float(ex), float(ey),
                         float(concept['distance']), float(bitmask)))

    return EnvSpec(
        NP=c['NP'], KV=kv, NS=c['NS'], NPT=c['NPT'], NE=ne,
        max_num_nodes=cfg.state_encoder_specs['max_num_nodes'],
        max_num_edges=cfg.state_encoder_specs['max_num_edges'],
        grid_cols=float(plc._grid_cols), grid_rows=float(plc._grid_rows),
        cell_edge_length=float(plc._cell_edge_length),
        community_area=float(plc._community_area),
        plan_order=tuple(int(x) for x in plc._plan_order),
        required_plan_ratio=tuple(float(x) for x in plc._required_plan_ratio),
        required_plan_count=tuple(int(x) for x in plc._required_plan_count),
        required_max_area=tuple(float(x) for x in plc._required_max_area),
        required_min_area=tuple(float(x) for x in plc._required_min_area),
        required_max_edge_length=tuple(
            float(x) for x in plc._required_max_edge_length),
        required_min_edge_length=tuple(
            float(x) for x in plc._required_min_edge_length),
        common_max_area=float(plc._common_max_area),
        common_min_area=float(plc._common_min_area),
        common_max_edge_length=float(plc._common_max_edge_length),
        common_min_edge_length=float(plc._common_min_edge_length),
        rule_constraints=bool(plc._rule_constraints),
        skip_land_use=bool(cfg.skip_land_use),
        skip_road=bool(cfg.skip_road),
        keep_boundaries=bool(keep_boundaries),
        road_ratio=float(cfg.road_ratio),
        road_network_weight=float(cfg.reward_specs.get('road_network_weight', 1.0)),
        life_circle_weight=float(cfg.reward_specs.get('life_circle_weight', 1.0)),
        greenness_weight=float(cfg.reward_specs.get('greenness_weight', 1.0)),
        concept_weight=float(cfg.reward_specs.get('concept_weight', 0.0)),
        weight_by_area=bool(cfg.reward_specs.get('weight_by_area', False)),
        concepts=tuple(concepts),
    )


def build_initial_state(spec: EnvSpec, plc: PlanClient,
                        device='cpu') -> PlanState:
    """Pack the scenario's initial plan into slot buffers (host side, then
    moved to ``device``)."""
    table = plc._init_table
    NP, KV, NS, NPT, NE = spec.NP, spec.KV, spec.NS, spec.NPT, spec.NE

    poly_ring = np.zeros((NP, KV, 2), dtype=np.float32)
    poly_nvert = np.zeros(NP, dtype=np.int32)
    poly_type = np.zeros(NP, dtype=np.int32)
    poly_alive = np.zeros(NP, dtype=bool)
    poly_rect = np.full(NP, 0.5, dtype=np.float32)
    poly_eqi = np.full(NP, 0.5, dtype=np.float32)
    poly_sc = np.full(NP, 0.5, dtype=np.float32)
    seg = np.zeros((NS, 2, 2), dtype=np.float32)
    seg_type = np.zeros(NS, dtype=np.int32)
    seg_alive = np.zeros(NS, dtype=bool)
    pt = np.zeros((NPT, 2), dtype=np.float32)
    pt_alive = np.zeros(NPT, dtype=bool)

    row_to_slot = {}
    ip = is_ = ipt = 0
    for row in range(len(table)):
        if not table.existence[row]:
            continue
        g = table.geoms[row]
        if g.kind == POLY:
            ring = g.canonicalize().coords
            if len(ring) > KV:
                raise ValueError(f'Polygon with {len(ring)} verts exceeds '
                                 f'KV={KV}.')
            poly_ring[ip, :len(ring)] = ring
            poly_nvert[ip] = len(ring)
            poly_type[ip] = table.types[row]
            poly_alive[ip] = True
            if not np.isnan(table.rect[row]):
                poly_rect[ip] = table.rect[row]
                poly_eqi[ip] = table.eqi[row]
                poly_sc[ip] = table.sc[row]
            row_to_slot[row] = ip
            ip += 1
        elif g.kind == LINE:
            # multi-coord lines become one slot per sub-segment
            for i in range(len(g.coords) - 1):
                seg[is_] = g.coords[i:i + 2]
                seg_type[is_] = table.types[row]
                seg_alive[is_] = True
                if i == 0:
                    row_to_slot[row] = NP + is_
                is_ += 1
        else:
            pt[ipt] = g.coords[0]
            pt_alive[ipt] = True
            row_to_slot[row] = NP + NS + ipt
            ipt += 1
    if ip > NP or is_ > NS or ipt > NPT:
        raise ValueError('Initial plan exceeds slot capacities.')

    # feature-point incidence (exact host geometry)
    from urban_tpu_torch.host.geometry import ops as gops
    from urban_tpu_torch.host.geometry.base import Geometry
    incidence = np.zeros((spec.num_features, NPT), dtype=bool)
    pt_geoms = [(k, Geometry(POINT, pt[k][None, :]))
                for k in range(NPT) if pt_alive[k]]
    for row in range(len(table)):
        if not table.existence[row]:
            continue
        g = table.geoms[row]
        if g.kind == LINE:
            # multi-coord lines occupy several seg slots; per-sub-segment
            base = row_to_slot[row] - NP
            for i in range(len(g.coords) - 1):
                a, b = g.coords[i], g.coords[i + 1]
                for k, pg in pt_geoms:
                    p = pg.coords[0]
                    if gops.point_segment_distance(p, a[None], b[None])[0] \
                            <= 1e-6:
                        incidence[NP + base + i, k] = True
        else:
            slot = row_to_slot[row]
            for k, pg in pt_geoms:
                if gops.geometries_intersect(g, pg, tol=1e-6):
                    incidence[slot, k] = True
    for k in range(NPT):
        if pt_alive[k]:
            incidence[NP + NS + k, k] = True

    # initial contiguity from the host engine (exact oracle)
    plc.unplan_all_land_use()
    rows, edges = plc._get_current_gdf_and_graph()
    edge_arr = np.full((NE, 2), spec.num_features - 1, dtype=np.int32)
    edge_alive = np.zeros(NE, dtype=bool)
    k = 0
    for (i, j) in edges:
        ri, rj = int(rows[i]), int(rows[j])
        if ri in row_to_slot and rj in row_to_slot:
            if k >= NE:
                raise ValueError('Initial contiguity exceeds NE.')
            edge_arr[k] = (row_to_slot[ri], row_to_slot[rj])
            edge_alive[k] = True
            k += 1

    plan_area = np.array(plc._plan_area, dtype=np.float32)
    plan_count = np.array(plc._plan_count, dtype=np.int32)

    # cached polygon features
    poly_feat = np.zeros((8, NP), dtype=np.float32)
    for i in range(NP):
        if not poly_alive[i]:
            continue
        g = Geometry(POLY, poly_ring[i, :poly_nvert[i]])
        cx, cy = g.centroid
        x0, y0, x1, y1 = g.bounds
        poly_feat[:, i] = [g.area, cx, cy, g.perimeter, x0, y0, x1, y1]

    # road-only configs start in the road stage with the budget fixed at
    # reset (reference city.py:538-539)
    if spec.skip_land_use:
        n_boundary = int(((seg_type == city_config.BOUNDARY)
                          & seg_alive).sum())
        total_road_steps = int(np.floor(n_boundary * spec.road_ratio))
    else:
        total_road_steps = 0

    host = dict(
        poly_ring=poly_ring, poly_nvert=poly_nvert, poly_type=poly_type,
        poly_alive=poly_alive, poly_rect=poly_rect, poly_eqi=poly_eqi,
        poly_sc=poly_sc, seg=seg, seg_type=seg_type, seg_alive=seg_alive,
        pt=pt, pt_alive=pt_alive, poly_feat=poly_feat, edge=edge_arr,
        edge_alive=edge_alive, incidence=incidence, plan_area=plan_area,
        plan_count=plan_count,
        stage=np.int32(1 if spec.skip_land_use else 0),
        land_use_steps=np.int32(0), road_steps=np.int32(0),
        total_road_steps=np.int32(total_road_steps), done=np.bool_(False),
        failure=np.bool_(False), land_use_reward=np.float32(-1.0))
    return PlanState(**{n: torch.as_tensor(host[n], device=device)
                        .to(FIELD_DTYPES[n]) for n in FIELD_NAMES})
