"""Environment step for the batched environment (counterpart of
urban_tpu/jaxenv/step.py).

Implements the reference MDP as a function of fixed-size buffers for ONE
environment; the rollout lifts it over the environment batch with
``torch.func.vmap`` (torchenv/rollout.py), and the JAX code's inner
``jax.vmap``s over candidates and pieces are inner ``torch.func.vmap``s.

  * action masks recomputed from the contiguity table each step
  * land-use placement: whole-feasible shortcut, the branch-complete
    slicing tree (torchenv/slicer.py), convex clip for the parcel, arc
    pieces for the remaining feasible pieces, vertex snapping,
    new-intersection allocation with segment splitting, boundary
    bookkeeping, incremental contiguity updates
  * road building as a segment type flip under the road-step budget
  * failure semantics as a FAIL_* bitmask driving FAILURE_REWARD termination
  * stage-boundary rewards: life circle, greenness and concepts at the end
    of the land-use stage, the road-network reward at the end of the road
    stage. The road-network reward is batched, not vmapped (its raster
    face decomposition sweeps to a fixpoint with a host sync a sweep):
    ``batched_road_network_reward`` takes a leading env axis
  * the reference-layout observation ``build_obs_packed``

DEVIATIONS from the exact host engine (the oracle in urban_tpu/envs) are
those listed in urban_tpu/jaxenv/step.py, and they hold for this port as
they stand there (it computes what the JAX step computes):
  * multi-piece clip results stay as one bridged ring (area-preserving;
    the host keeps separate feasible pieces)
  * greenness uses polygon-sample coverage instead of the host's
    rasterized buffer coverage
  * shape metrics use ring-edge-direction rectangles instead of the exact
    minimum rotated rectangle (equal for convex parcels; MRR ties may pick
    a different, equally minimal rectangle)
  * the road-network large-block penalty counts faces with a raster
    decomposition on the scenario grid instead of exact polygonize (equal
    for grid-aligned road networks; over MAX_DIAG diagonal roads in one
    plan it under-blocks)
  * f32 arithmetic (with compensated/Dekker products on the sensitive
    predicates) vs the host's f64: borderline orientation / area-threshold
    / DP-keep decisions can flip on near-degenerate inputs
  * dedupe_ring compacts consecutive near-duplicates against the immediate
    predecessor, not the host's last-kept vertex
Between this port and the JAX step, the fused multiply-adds that XLA
forms are rounded the same way (see torchenv/geometry.py), but f32 sums
are taken in another order, so float fields agree to rounding and a
near-degenerate decision can in principle flip between the two.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
from torch.func import vmap

from urban_tpu_torch.host import city_config
from urban_tpu_torch.torchenv import geometry as jg
from urban_tpu_torch.torchenv import slicer as jsl
from urban_tpu_torch.torchenv.state import (FIELD_NAMES, EnvSpec, PlanState,
                                            canonical)

EPS = 1e-4
MERGE_TOL = 1e-6
DEDUPE_TOL = 1e-3  # raw-crossing dedupe: above f32 ulp at coords <= 4096
MAX_NEW_PTS = 8
FAILURE_REWARD = -1.0

FAIL_SLICE = 1 << 0           # cutter failed / no interior piece
FAIL_SNAP_PARCEL = 1 << 1     # parcel degenerate after simplify+snap
FAIL_REMAINDER = 1 << 2       # remaining-piece decomposition lost area
FAIL_WHOLE_NEW_PT = 1 << 3    # whole-block placement created points
FAIL_ALL_NEW_PTS = 1 << 4     # parcel touches no existing intersection
FAIL_PT_OVERFLOW = 1 << 5     # [capacity] new-intersection slots exhausted
FAIL_NB_OVERFLOW = 1 << 6     # [capacity] neighbor-snap buffer exhausted
FAIL_MULTI_SEG_HIT = 1 << 7   # new point on >1 existing segment
FAIL_SEG_OVERFLOW = 1 << 8    # [capacity] segment-split slots exhausted
FAIL_GAP_OVERFLOW = 1 << 9    # [capacity] boundary-gap slots exhausted
FAIL_PIECE_SNAP = 1 << 10     # remaining piece degenerate after snap
FAIL_PIECE_NEW_PT = 1 << 11   # remaining piece would need a new point
FAIL_POLY_OVERFLOW = 1 << 12  # [capacity] polygon slots exhausted
FAIL_CONTIGUITY = 1 << 13     # [capacity] incidence/edge-table overflow
FAIL_NO_MOVES = 1 << 14       # dead state: no feasible land-use action
FAIL_ROAD = 1 << 15           # road-step failure
FAIL_NO_ROAD_MOVES = 1 << 16  # dead state: no boundary left to upgrade

FAILURE_BIT_NAMES = {
    FAIL_SLICE: 'slice', FAIL_SNAP_PARCEL: 'snap_parcel',
    FAIL_REMAINDER: 'remainder', FAIL_WHOLE_NEW_PT: 'whole_new_pt',
    FAIL_ALL_NEW_PTS: 'all_new_pts', FAIL_PT_OVERFLOW: 'pt_overflow',
    FAIL_NB_OVERFLOW: 'nb_overflow', FAIL_MULTI_SEG_HIT: 'multi_seg_hit',
    FAIL_SEG_OVERFLOW: 'seg_overflow', FAIL_GAP_OVERFLOW: 'gap_overflow',
    FAIL_PIECE_SNAP: 'piece_snap', FAIL_PIECE_NEW_PT: 'piece_new_pt',
    FAIL_POLY_OVERFLOW: 'poly_overflow', FAIL_CONTIGUITY: 'contiguity',
    FAIL_NO_MOVES: 'no_moves', FAIL_ROAD: 'road',
    FAIL_NO_ROAD_MOVES: 'no_road_moves',
}


def _bit(bit: int, cond: torch.Tensor) -> torch.Tensor:
    return cond.to(torch.int32) * bit


# ---------------------------------------------------------------------------
# spec-derived constant tensors
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _consts_cached(spec: EnvSpec, device: torch.device):
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return {
        'plan_order': torch.tensor(spec.plan_order, **i64),
        'req_ratio': torch.tensor(spec.required_plan_ratio, **f32),
        'req_count': torch.tensor(spec.required_plan_count, **i64),
        'max_area': torch.tensor(spec.required_max_area, **f32),
        'min_area': torch.tensor(spec.required_min_area, **f32),
        'max_edge': torch.tensor(spec.required_max_edge_length, **f32),
        'min_edge': torch.tensor(spec.required_min_edge_length, **f32),
    }


def _consts(spec: EnvSpec, state: PlanState):
    return _consts_cached(spec, state.poly_alive.device)


def ring_feat8(ring, nv):
    """[area, cx, cy, perimeter, minx, miny, maxx, maxy] for one ring."""
    c = jg.ring_centroid(ring, nv)
    b = jg.ring_bounds(ring, nv)
    return torch.stack([jg.ring_area(ring, nv), c[0], c[1],
                        jg.ring_perimeter(ring, nv), b[0], b[1], b[2], b[3]])


def pending_land_use_type(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """First plan-order land use with unmet area ratio or count."""
    c = _consts(spec, state)
    order = c['plan_order']
    req_area = spec.community_area * c['req_ratio'][order]
    rem_area = req_area - state.plan_area[order]
    rem_count = c['req_count'][order] - state.plan_count[order]
    pending = (rem_area > EPS) | (rem_count > 0)
    return order[torch.argmax(pending.to(torch.uint8))]


def is_land_use_done(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    c = _consts(spec, state)
    order = c['plan_order']
    ratio = state.plan_area / spec.community_area
    ratio_ok = ((ratio - c['req_ratio'])[order] >= -EPS).all()
    count_ok = (state.plan_count >= c['req_count'])[order].all()
    return ratio_ok & count_ok


# ---------------------------------------------------------------------------
# feature views and masks
# ---------------------------------------------------------------------------

def feature_alive(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    return torch.cat([state.poly_alive, state.seg_alive, state.pt_alive])


def feature_types(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    return torch.cat([
        state.poly_type.to(torch.int64), state.seg_type.to(torch.int64),
        torch.full((spec.NPT,), city_config.INTERSECTION, dtype=torch.int64,
                   device=state.poly_type.device)])


def endpoint_lookup(edges: torch.Tensor, tables: torch.Tensor):
    """Per-edge endpoint lookups of per-feature bool tables: edges (NE, 2),
    tables (K, NF) -> (v0, v1), each (K, NE) bool. An endpoint outside
    [0, NF) reads False (the JAX one-hot contraction's semantics)."""
    n_f = tables.shape[-1]
    e = edges.long()
    valid = (e >= 0) & (e < n_f)
    ec = e.clamp(0, n_f - 1)
    v0 = tables[:, ec[:, 0]] & valid[None, :, 0]
    v1 = tables[:, ec[:, 1]] & valid[None, :, 1]
    return v0, v1


def eligible_land_use_polys(spec: EnvSpec, state: PlanState,
                            land_use_t: torch.Tensor) -> torch.Tensor:
    """(NP,) polys on which land_use_t may be placed."""
    c = _consts(spec, state)
    poly_areas = state.poly_feat[0] * spec.cell_edge_length ** 2
    eligible = state.poly_alive & \
        (state.poly_type == city_config.FEASIBLE) & \
        (poly_areas >= c['min_area'][land_use_t])
    if spec.rule_constraints:
        eligible = eligible & ~_rule_excluded(spec, state, land_use_t)
    return eligible


def land_use_mask(spec: EnvSpec, state: PlanState,
                  land_use_t: torch.Tensor) -> torch.Tensor:
    """(NE,) mask of contiguity edges joining an eligible feasible block
    with an intersection."""
    dev = state.poly_alive.device
    eligible_poly = eligible_land_use_polys(spec, state, land_use_t)
    ok = torch.cat([eligible_poly,
                    torch.zeros(spec.NS + spec.NPT, dtype=torch.bool,
                                device=dev)])
    is_pt = torch.cat([torch.zeros(spec.NP + spec.NS, dtype=torch.bool,
                                   device=dev), state.pt_alive])
    v0, v1 = endpoint_lookup(state.edge, torch.stack([ok, is_pt]))
    return state.edge_alive & ((v0[0] & v1[1]) | (v1[0] & v0[1]))


def _rule_excluded(spec: EnvSpec, state: PlanState,
                   land_use_t: torch.Tensor) -> torch.Tensor:
    """Feasible polys adjacent (through a shared intersection) to a
    school/hospital per the rule filter."""
    types = feature_types(spec, state)
    is_school = land_use_t == city_config.SCHOOL
    is_hs = land_use_t == city_config.HOSPITAL_S
    avoid = torch.where(
        is_school, types == city_config.HOSPITAL_L,
        torch.where(is_hs,
                    (types == city_config.SCHOOL)
                    | (types == city_config.HOSPITAL_L)
                    | (types == city_config.HOSPITAL_S),
                    torch.zeros_like(types, dtype=torch.bool)))
    avoid = avoid & feature_alive(spec, state)
    avoid_pts = (state.incidence & avoid[:, None]).any(dim=0)
    return (state.incidence[:spec.NP] & avoid_pts[None, :]).any(dim=1)


def road_mask(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """(NF,) node mask of boundary segments."""
    dev = state.poly_alive.device
    seg_ok = state.seg_alive & (state.seg_type == city_config.BOUNDARY)
    return torch.cat([torch.zeros(spec.NP, dtype=torch.bool, device=dev),
                      seg_ok,
                      torch.zeros(spec.NPT, dtype=torch.bool, device=dev)])


def _lu_params(spec: EnvSpec, c, land_use_t, like):
    """Per-type scalar constraints for the slicer."""
    scalar = dict(dtype=torch.float32, device=like.device)
    return jsl.LuParams(
        cell=torch.tensor(spec.cell_edge_length, **scalar),
        min_edge=c['min_edge'][land_use_t],
        max_edge=c['max_edge'][land_use_t],
        search_max_length=c['max_edge'][land_use_t]
        + spec.common_min_edge_length,
        search_max_area=c['max_area'][land_use_t],
        search_min_area=c['min_area'][land_use_t],
        common_min_edge=torch.tensor(spec.common_min_edge_length, **scalar))


# ---------------------------------------------------------------------------
# shape metrics
# ---------------------------------------------------------------------------

def ring_shape_metrics(ring, nv):
    """(rect, eqi, sc) with the min rotated rectangle approximated over
    ring-edge directions (exact for convex rings)."""
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    area = jg.ring_area(ring, nv)
    perim = jg.ring_perimeter(ring, nv)
    d = jg.ring_next(ring, nv) - ring
    nd = torch.clamp_min(jg.norm(d, keepdim=True), 1e-9)
    u = d / nd
    v = torch.stack([-u[:, 1], u[:, 0]], dim=-1)
    pu = jg.dot2(ring[:, None, :], u[None, :, :])     # (KV pts, KV dirs)
    pv = jg.dot2(ring[:, None, :], v[None, :, :])
    big_m = torch.where(m[:, None], 0.0, jg.BIG)
    w = (pu + (-big_m)).amax(0) - (pu + big_m).amin(0)
    h = (pv + (-big_m)).amax(0) - (pv + big_m).amin(0)
    rect_area = torch.where(m, w * h, jg.BIG)
    mrr_area = torch.clamp_min(rect_area.amin(), 1e-9)
    i = torch.argmin(rect_area)
    mrr_perim = 2.0 * (w[i] + h[i])
    rect = area / mrr_area
    eqi = jg.sqrt(area / mrr_area) * (mrr_perim / torch.clamp_min(perim, 1e-9))
    sc = (4.0 * jg.sqrt(area) / torch.clamp_min(perim, 1e-9)) ** 2
    ok = (area > 1e-9) & (perim > 1e-9)
    return (torch.where(ok, rect, 0.5), torch.where(ok, eqi, 0.5),
            torch.where(ok, sc, 0.5))


# ---------------------------------------------------------------------------
# slot allocation, snapping
# ---------------------------------------------------------------------------

def free_slots(alive: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first k free slots (== len(alive) beyond the free
    count). Returns (slots (k,), overflow)."""
    free = ~alive
    n_free = free.sum()
    n = alive.shape[0]
    slots = jg.rank_compact(free, jg.arange(n, alive), k)
    slots = torch.where(jg.arange(k, alive) < n_free, slots, n)
    return slots, n_free < k


def snap_ring_to_points(ring, nv, pts, pt_alive, tol):
    """Move ring vertices onto the nearest existing intersection within tol."""
    d = jg.norm(ring[:, None, :] - pts[None, :, :])
    d = torch.where(pt_alive[None, :], d, jg.BIG)
    nearest = torch.argmin(d, dim=1)
    dmin = d.amin(dim=1)
    return torch.where((dmin <= tol)[:, None], pts[nearest], ring)


def distance_simplify_ring(ring, nv, tol):
    """Drop vertices closer than tol to their predecessor; rings that would
    fall below 3 vertices pass through unchanged."""
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    keep = m & (jg.norm(ring - jg.ring_prev(ring, nv)) >= tol)
    nk = keep.sum()
    ok = nk >= 3
    counts = keep.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    out = jg.onehot_place(ring, offsets, keep, kv)
    return torch.where(ok, out, ring), torch.where(ok, nk, nv)


def simplify_snap_poly(ring, nv, pts, pt_alive, snap_tol):
    """Mirror of the host PlanClient._simplify_snap_polygon: dedupe, DP
    simplify at the snap tolerance in the canonical frame, distance-simplify
    at EPS, snap onto intersections, insert on-edge intersections, dedupe.
    Returns (ring, nvert, fail)."""
    r, n = jg.dedupe_ring(ring, nv, DEDUPE_TOL)
    r, n = jg.canonicalize_ring(r, n)
    r, n = jg.dp_simplify_ring(r, n, snap_tol)
    r, n = distance_simplify_ring(r, n, EPS)
    r = snap_ring_to_points(r, n, pts, pt_alive, snap_tol)
    r, n, ovf = jg.insert_points_on_ring(r, n, pts, pt_alive, snap_tol)
    r, n = jg.dedupe_ring(r, n)
    fail = ovf | (n < 3) | (jg.ring_area(r, n) <= 0)
    return r, n, fail


MAX_COV = 16          # collinear covering segments considered per parcel edge
GAPS_PER_EDGE = 3     # uncovered sub-segments emitted per parcel edge


def collinear_boundary_gaps(parcel_r, parcel_n, seg, seg_alive):
    """Uncovered sub-segments of each parcel edge (host _subtract_collinear):
    (gap_a, gap_b, gap_ok, overflow) with (KV, G, 2) endpoints per edge."""
    kv = parcel_r.shape[0]
    m = jg.ring_mask(parcel_n, kv)
    a = parcel_r
    b = jg.ring_next(parcel_r, parcel_n)
    ab = b - a
    L = jg.norm(ab)
    valid_e = m & (L > EPS)
    u = ab / torch.clamp_min(L, 1e-9)[:, None]
    rel_p = seg[None, :, 0, :] - a[:, None, :]            # (KV, NS, 2)
    rel_q = seg[None, :, 1, :] - a[:, None, :]
    dp = torch.abs(jg.cross(u[:, None, 0], u[:, None, 1],
                            rel_p[..., 0], rel_p[..., 1]))
    dq = torch.abs(jg.cross(u[:, None, 0], u[:, None, 1],
                            rel_q[..., 0], rel_q[..., 1]))
    tp = jg.dot2(rel_p, u[:, None, :])
    tq = jg.dot2(rel_q, u[:, None, :])
    Lc = L[:, None]
    lo = torch.minimum(torch.clamp_min(torch.minimum(tp, tq), 0.0), Lc)
    hi = torch.minimum(torch.clamp_min(torch.maximum(tp, tq), 0.0), Lc)
    cov = (seg_alive[None, :] & valid_e[:, None] & (dp <= EPS) & (dq <= EPS)
           & (hi - lo > EPS))
    ncov = cov.sum(dim=1)
    overflow = (valid_e & (ncov > MAX_COV)).any()

    lohi = vmap(lambda f, v: jg.rank_compact(f, v, MAX_COV))(
        cov, torch.stack([lo, hi], dim=-1))                # (KV, C, 2)
    cval = jg.arange(MAX_COV, seg)[None, :] < ncov[:, None]
    LO = torch.where(cval, lohi[..., 0], jg.BIG)
    HI = torch.where(cval, lohi[..., 1], -jg.BIG)

    # candidate gap starts: 0 and every interval end
    starts = torch.cat([torch.zeros(kv, 1, device=seg.device), HI], dim=1)
    sval = torch.cat([valid_e[:, None], cval], dim=1)
    covered = (cval[:, None, :]
               & (LO[:, None, :] <= starts[:, :, None] + EPS)
               & (HI[:, None, :] >= starts[:, :, None] + EPS)).any(dim=2)
    ncand = starts.shape[1]
    ar_c = jg.arange(ncand, seg)
    dup = (sval[:, None, :]
           & (torch.abs(starts[:, None, :] - starts[:, :, None]) <= EPS)
           & (ar_c[None, None, :] < ar_c[None, :, None])).any(dim=2)
    nxt_lo = torch.where(cval[:, None, :]
                         & (LO[:, None, :] > starts[:, :, None] + EPS),
                         LO[:, None, :], jg.BIG).amin(dim=2)
    ends = torch.minimum(nxt_lo, Lc)
    gap_ok = (sval & ~covered & ~dup & (starts <= Lc - EPS)
              & (ends - starts > EPS))
    overflow = overflow | (gap_ok.sum(dim=1) > GAPS_PER_EDGE).any()
    vals = torch.stack([starts, ends], dim=-1)
    g = vmap(lambda f, v: jg.rank_compact(f, v, GAPS_PER_EDGE))(gap_ok, vals)
    gn = gap_ok.sum(dim=1)
    gvalid = jg.arange(GAPS_PER_EDGE, seg)[None, :] < gn[:, None]
    gap_a = jg.fma(u[:, None, :], g[..., 0:1], a[:, None, :])
    gap_b = jg.fma(u[:, None, :], g[..., 1:2], a[:, None, :])
    return gap_a, gap_b, gvalid, overflow


# ---------------------------------------------------------------------------
# land-use placement
# ---------------------------------------------------------------------------

MAX_NEW_SEGS = 8
N_NEW_POLY = 5  # 1 parcel + up to 4 remaining wedges


def apply_land_use(spec: EnvSpec, state: PlanState, a: torch.Tensor):
    """Place the pending land use at contiguity edge `a`: slice the block,
    register the parcel's intersections/boundaries, re-add the remaining
    feasible pieces. Returns (next_state, failure_bits)."""
    c = _consts(spec, state)
    dev = state.poly_alive.device
    cell = spec.cell_edge_length
    cell_area = cell * cell
    snap_tol = 1.0 / cell  # SNAP_EPSILON=1 m in grid units
    assert snap_tol > 10 * DEDUPE_TOL, (
        f'snap_tol {snap_tol} must dominate DEDUPE_TOL {DEDUPE_TOL}')
    NP, NS, NPT = spec.NP, spec.NS, spec.NPT

    t = pending_land_use_type(spec, state)
    e = jg.take(state.edge, a).long()
    e0_is_poly = e[0] < NP
    p = torch.where(e0_is_poly, e[0], e[1])
    q = e[0] + e[1] - p - NP - NS
    ring = jg.take(state.poly_ring, p)
    nv = jg.take(state.poly_nvert, p)
    X = jg.take(state.pt, q)
    kvp = ring.shape[0]

    block_area = jg.take(state.poly_feat[0], p)
    block_area_m = block_area * cell_area
    whole_first = block_area_m <= c['max_area'][t]

    # ---- slice: branch-complete cutter + largest connected piece ---------
    lp = _lu_params(spec, c, t, state.poly_alive)
    S, snv, cut, slice_fail = jsl.compute_cutter(ring, nv, X, state.pt,
                                                 state.pt_alive, lp)
    cut4, nh4 = jg.convex_hull_masked(
        cut, torch.ones(4, dtype=torch.bool, device=dev))
    in_r, in_n, ovf_in = jg.arc_pieces(S, snv, cut4, nh4, keep_inside=True)
    in_area = vmap(jg.ring_area)(in_r, in_n)
    imax = torch.argmax(in_area)
    parcel0 = in_r[imax]
    parcel_n0 = in_n[imax]
    parcel_area0 = in_area[imax]
    slice_fail = slice_fail | ovf_in | (parcel_area0 < EPS)
    parcel_area_m0 = parcel_area0 * cell_area

    sliver = (block_area_m - parcel_area_m0) <= spec.common_min_area
    use_whole = whole_first | ((~slice_fail) & sliver)
    fail = _bit(FAIL_SLICE, (~whole_first) & slice_fail)
    # GREEN_S downgrade uses the pre-snap parcel area
    actual_t = torch.where((~use_whole) & (parcel_area_m0 < c['min_area'][t]),
                           city_config.GREEN_S, t)

    # ---- simplify + snap the stored parcel ------------------------------
    par_in = torch.where(use_whole, ring, parcel0)
    par_nin = torch.where(use_whole, nv, parcel_n0)
    parcel_r, parcel_n, pfail = simplify_snap_poly(
        par_in, par_nin, state.pt, state.pt_alive, snap_tol)
    fail = fail | _bit(FAIL_SNAP_PARCEL, pfail)
    parcel_area_m = jg.ring_area(parcel_r, parcel_n) * cell_area

    # ---- remaining pieces: ring minus convex_hull(raw parcel) -----------
    hull_p, nh_p = jg.convex_hull_masked(parcel0,
                                         jg.ring_mask(parcel_n0, kvp))
    out_r, out_n, ovf_out = jg.arc_pieces(ring, nv, hull_p, nh_p,
                                          keep_inside=False)
    out_area = vmap(jg.ring_area)(out_r, out_n)
    piece_valid = (out_area > 1e-9) & (out_n >= 3) & ~use_whole
    rem_area = torch.where(piece_valid, out_area, 0.0).sum()
    fail = fail | _bit(FAIL_REMAINDER,
                       (~use_whole) & ~slice_fail
                       & (ovf_out
                          | ((rem_area <= 0)
                             & (torch.abs(block_area - parcel_area0) > 1e-6))))

    # ---- new intersections: parcel vertices only -------------------------
    vmask_parcel = jg.ring_mask(parcel_n, kvp)
    d_pts = jg.norm(parcel_r[:, None, :] - state.pt[None, :, :])
    d_pts = torch.where(state.pt_alive[None, :], d_pts, jg.BIG)
    cand_new = vmask_parcel & (d_pts.amin(dim=1) > MERGE_TOL)
    dcc = jg.norm(parcel_r[:, None, :] - parcel_r[None, :, :])
    ar_kv = jg.arange(kvp, ring)
    earlier = ar_kv[None, :] < ar_kv[:, None]
    dup = ((dcc <= MERGE_TOL) & earlier & cand_new[None, :]).any(dim=1)
    is_new = cand_new & ~dup
    fail = fail | _bit(FAIL_WHOLE_NEW_PT, use_whole & is_new.any())
    fail = fail | _bit(FAIL_ALL_NEW_PTS,
                       (~use_whole) & (parcel_n > 0)
                       & (is_new.sum() >= parcel_n))
    is_new = is_new & ~use_whole
    cand = parcel_r
    n_new = is_new.sum()
    fail = fail | _bit(FAIL_PT_OVERFLOW, n_new > MAX_NEW_PTS)

    pt_slots, pt_ovf = free_slots(state.pt_alive, MAX_NEW_PTS)
    fail = fail | _bit(FAIL_PT_OVERFLOW, pt_ovf & (n_new > 0))
    new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    scatter_idx = torch.where(
        is_new, pt_slots[torch.clamp(new_rank, 0, MAX_NEW_PTS - 1)], NPT)
    pt = jg.onehot_update(state.pt, cand, scatter_idx, is_new)
    pt_alive = state.pt_alive | jg.onehot_mask(scatter_idx, is_new, NPT)

    new_pts = jg.onehot_place(cand, new_rank, is_new, MAX_NEW_PTS)
    pt_valid = jg.arange(MAX_NEW_PTS, ring) < n_new

    # ---- snap neighbor polygons onto the new intersections ---------------
    MAX_NB = MAX_NEW_PTS
    ar_np = jg.arange(NP, ring)
    nb_alive = state.poly_alive & (ar_np != p)
    poly_next = vmap(jg.ring_next)(state.poly_ring, state.poly_nvert)
    d_nb = jg.point_segment_distance(
        new_pts[None, None, :, :],                     # (1, 1, P, 2)
        state.poly_ring[:, :, None, :],                # (NP, KV, 1, 2)
        poly_next[:, :, None, :])
    kvp_m = ar_kv[None, :] < state.poly_nvert[:, None]
    touched = nb_alive & (kvp_m[:, :, None] & pt_valid[None, None, :]
                          & (d_nb <= EPS)).flatten(1).any(dim=1)
    n_touch = touched.sum()
    fail = fail | _bit(FAIL_NB_OVERFLOW, n_touch > MAX_NB)
    nb_idx = jg.rank_compact(touched, ar_np, MAX_NB)
    nb_ok = jg.arange(MAX_NB, ring) < n_touch
    nb_rows = torch.clamp(nb_idx, 0, NP - 1)
    sub_ring = state.poly_ring[nb_rows]
    sub_nv = state.poly_nvert[nb_rows]
    ins_ring, ins_nv, ins_ovf = vmap(
        lambda r, n: jg.insert_points_on_ring(r, n, new_pts, pt_valid, EPS,
                                              max_insert=MAX_NEW_PTS))(
            sub_ring, sub_nv)
    fail = fail | _bit(FAIL_NB_OVERFLOW, (nb_ok & ins_ovf).any())
    base_ring = jg.onehot_update(
        state.poly_ring.reshape(NP, kvp * 2),
        ins_ring.reshape(MAX_NB, kvp * 2), nb_idx, nb_ok).reshape(NP, kvp, 2)
    base_nvert = jg.onehot_update(state.poly_nvert, ins_nv, nb_idx, nb_ok)

    # ---- split segments at new intersections ---------------------------
    MAX_HIT_SEGS = MAX_NEW_PTS
    PIECES_PER_SEG = 3
    seg = state.seg
    seg_type = state.seg_type
    seg_alive = state.seg_alive

    d_hit = jg.point_segment_distance(new_pts[:, None, :], seg[None, :, 0],
                                      seg[None, :, 1])       # (P, NS)
    interior = (jg.norm(seg[None, :, 0] - new_pts[:, None]) > EPS) & \
        (jg.norm(seg[None, :, 1] - new_pts[:, None]) > EPS)
    hits = seg_alive[None, :] & (d_hit < EPS) & interior & pt_valid[:, None]
    fail = fail | _bit(FAIL_MULTI_SEG_HIT, (hits.sum(dim=1) > 1).any())
    seg_has = hits.any(dim=0)
    n_hit_segs = seg_has.sum()
    fail = fail | _bit(FAIL_SEG_OVERFLOW, n_hit_segs > MAX_HIT_SEGS)

    hit_idx = jg.rank_compact(seg_has, jg.arange(NS, ring), MAX_HIT_SEGS)
    hit_valid = jg.arange(MAX_HIT_SEGS, ring) < n_hit_segs
    hit_c = torch.clamp(hit_idx, 0, NS - 1)
    hit_a = seg[hit_c, 0]                                     # (H, 2)
    hit_b = seg[hit_c, 1]
    ab = hit_b - hit_a
    denom = torch.clamp_min(jg.dot2(ab, ab), 1e-12)
    tt = jg.dot2(new_pts[None, :, :] - hit_a[:, None, :], ab[:, None, :]) \
        / denom[:, None]
    on_this = hits[:, hit_c].transpose(0, 1)                  # (H, P)
    tt = torch.where(on_this, tt, jg.BIG)
    cnt = on_this.sum(dim=1)
    fail = fail | _bit(FAIL_SEG_OVERFLOW,
                       (hit_valid & (cnt + 1 > PIECES_PER_SEG)).any())
    t_sorted, order = torch.sort(tt, dim=1, stable=True)
    pts_sorted = new_pts[order]                               # (H, P, 2)

    # piece endpoints: [a, p_1..p_cnt, b]; piece k spans (e_k, e_{k+1})
    starts = torch.cat([hit_a[:, None, :],
                        pts_sorted[:, :PIECES_PER_SEG - 1, :]], dim=1)
    valid_pt = t_sorted < jg.BIG / 2
    next_is_pt = valid_pt[:, :PIECES_PER_SEG - 1]
    ends = torch.where(next_is_pt[..., None],
                       pts_sorted[:, :PIECES_PER_SEG - 1, :],
                       hit_b[:, None, :])
    ends = torch.cat([ends, hit_b[:, None, :]], dim=1)
    piece_valid_s = (jg.arange(PIECES_PER_SEG, ring)[None, :]
                     <= cnt[:, None]) & hit_valid[:, None]    # (H, K)
    new_seg_coords = torch.stack([starts, ends], dim=2)       # (H, K, 2, 2)
    new_seg_types = seg_type[hit_c][:, None].expand(MAX_HIT_SEGS,
                                                    PIECES_PER_SEG)

    # kill parents, allocate and write pieces
    kill_mask = jg.onehot_mask(hit_idx, hit_valid, NS)
    seg_alive = seg_alive & ~kill_mask
    flat_valid = piece_valid_s.reshape(-1)
    n_pieces = flat_valid.sum()
    n_split = MAX_HIT_SEGS * PIECES_PER_SEG
    slots, seg_ovf = free_slots(seg_alive, n_split)
    fail = fail | _bit(FAIL_SEG_OVERFLOW,
                       seg_ovf & (n_pieces > (~seg_alive).sum()))
    rankp = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    widx = torch.where(flat_valid, slots[torch.clamp(rankp, 0, n_split - 1)],
                       NS)
    seg = jg.onehot_update(seg.reshape(NS, 4), new_seg_coords.reshape(-1, 4),
                           widx, flat_valid).reshape(NS, 2, 2)
    seg_type = jg.onehot_update(seg_type, new_seg_types.reshape(-1), widx,
                                flat_valid)
    seg_alive = seg_alive | jg.onehot_mask(widx, flat_valid, NS)
    split_slots = torch.where(jg.arange(n_split, ring) < n_pieces, slots, NS)
    killed_slots = torch.where(hit_valid, hit_idx, NS)

    # ---- new boundaries: uncovered collinear leftovers per parcel edge --
    gap_a, gap_b, gvalid, gap_ovf = collinear_boundary_gaps(
        parcel_r, parcel_n, seg, seg_alive)
    gflat = (gvalid & ~use_whole).reshape(-1)
    n_need = gflat.sum()
    fail = fail | _bit(FAIL_GAP_OVERFLOW,
                       (gap_ovf & ~use_whole) | (n_need > MAX_NEW_SEGS))
    b_slots, b_ovf = free_slots(seg_alive, MAX_NEW_SEGS)
    fail = fail | _bit(FAIL_GAP_OVERFLOW, b_ovf & (n_need > 0))
    need_rank = torch.cumsum(gflat.to(torch.int64), 0) - 1
    bidx = torch.where(gflat,
                       b_slots[torch.clamp(need_rank, 0, MAX_NEW_SEGS - 1)],
                       NS)
    new_b = torch.cat([gap_a.reshape(-1, 2), gap_b.reshape(-1, 2)], dim=1)
    seg = jg.onehot_update(seg.reshape(NS, 4), new_b, bidx,
                           gflat).reshape(NS, 2, 2)
    bset = jg.onehot_mask(bidx, gflat, NS)
    seg_type = torch.where(bset, city_config.BOUNDARY, seg_type)
    seg_alive = seg_alive | bset

    # ---- simplify + snap the remaining pieces (no new points allowed) ----
    pieces_r, pieces_n, piece_pfail = vmap(
        lambda r, n: simplify_snap_poly(r, n, pt, pt_alive, snap_tol))(
            out_r, out_n)
    fail = fail | _bit(FAIL_PIECE_SNAP, (piece_valid & piece_pfail).any())
    d_piece = jg.norm(pieces_r[:, :, None, :] - pt[None, None, :, :])
    d_piece = torch.where(pt_alive[None, None, :], d_piece, jg.BIG)
    piece_vm = ar_kv[None, :] < pieces_n[:, None]
    piece_has_new = (piece_vm & (d_piece.amin(dim=2) > MERGE_TOL)).any(dim=1)
    fail = fail | _bit(FAIL_PIECE_NEW_PT,
                       (piece_valid & piece_has_new).any())

    # ---- write polygons -------------------------------------------------
    poly_alive = jg.set_at(state.poly_alive, p, False)
    poly_slots, poly_ovf = free_slots(poly_alive, N_NEW_POLY)
    fail = fail | _bit(FAIL_POLY_OVERFLOW, poly_ovf)
    parcel_slot = poly_slots[0]
    piece_slots = poly_slots[1:]

    poly_ring = jg.set_at(base_ring, parcel_slot, parcel_r)
    poly_nvert = jg.set_at(base_nvert, parcel_slot,
                           parcel_n.to(base_nvert.dtype))
    poly_type = jg.set_at(state.poly_type, parcel_slot,
                          actual_t.to(state.poly_type.dtype))
    poly_alive = jg.set_at(poly_alive, parcel_slot, True)
    rect, eqi, sc = ring_shape_metrics(parcel_r, parcel_n)
    poly_rect = jg.set_at(state.poly_rect, parcel_slot, rect)
    poly_eqi = jg.set_at(state.poly_eqi, parcel_slot, eqi)
    poly_sc = jg.set_at(state.poly_sc, parcel_slot, sc)

    parcel_col = (ar_np == parcel_slot)[None, :]
    poly_feat = torch.where(parcel_col, ring_feat8(parcel_r, parcel_n)[:, None],
                            state.poly_feat)
    piece_feats = vmap(ring_feat8)(pieces_r, pieces_n)      # (4, 8)
    pidx = torch.where(piece_valid, piece_slots, NP)
    poly_feat = jg.onehot_update(poly_feat.transpose(0, 1), piece_feats, pidx,
                                 piece_valid).transpose(0, 1)
    poly_ring = jg.onehot_update(
        poly_ring.reshape(NP, kvp * 2),
        pieces_r.reshape(pieces_r.shape[0], kvp * 2), pidx,
        piece_valid).reshape(NP, kvp, 2)
    poly_nvert = jg.onehot_update(poly_nvert, pieces_n, pidx, piece_valid)
    pset = jg.onehot_mask(pidx, piece_valid, NP)
    poly_type = torch.where(pset, city_config.FEASIBLE, poly_type)
    poly_alive = poly_alive | pset
    prect, peqi, psc = vmap(ring_shape_metrics)(pieces_r, pieces_n)
    poly_rect = jg.onehot_update(poly_rect, prect, pidx, piece_valid)
    poly_eqi = jg.onehot_update(poly_eqi, peqi, pidx, piece_valid)
    poly_sc = jg.onehot_update(poly_sc, psc, pidx, piece_valid)

    # ---- stats ----------------------------------------------------------
    types_ar = jg.arange(state.plan_area.shape[0], ring)
    plan_area = torch.where(types_ar == actual_t,
                            state.plan_area + parcel_area_m, state.plan_area)
    plan_area = torch.where(types_ar == city_config.FEASIBLE,
                            plan_area + (-parcel_area_m), plan_area)
    plan_count = torch.where(types_ar == actual_t, state.plan_count + 1,
                             state.plan_count)

    interim = state.replace(
        poly_ring=poly_ring, poly_nvert=poly_nvert, poly_type=poly_type,
        poly_alive=poly_alive, poly_rect=poly_rect, poly_eqi=poly_eqi,
        poly_sc=poly_sc, seg=seg, seg_type=seg_type, seg_alive=seg_alive,
        pt=pt, pt_alive=pt_alive, poly_feat=poly_feat, plan_area=plan_area,
        plan_count=plan_count, land_use_steps=state.land_use_steps + 1)

    # ---- contiguity update ---------------------------------------------
    # new features by kind: parcel + valid pieces (polys), new points,
    # split halves + new boundaries (segments); invalid entries are -1
    new_poly_ids = torch.cat([parcel_slot.reshape(1),
                              torch.where(piece_valid, piece_slots, -1)])
    new_pt_ids = torch.where(jg.arange(MAX_NEW_PTS, ring) < n_new,
                             pt_slots + NP + NS, -1)
    new_seg_ids = torch.cat([
        torch.where(split_slots < NS, split_slots + NP, -1),
        torch.where(jg.arange(MAX_NEW_SEGS, ring) < n_need, b_slots + NP, -1)])
    killed_feats = torch.cat([
        p.reshape(1), torch.where(killed_slots < NS, killed_slots + NP, -1)])
    interim = update_contiguity(spec, interim, new_poly_ids, new_pt_ids,
                                new_seg_ids, killed_feats)
    fail = fail | _bit(FAIL_CONTIGUITY, interim.failure)

    next_state = interim.replace(failure=torch.zeros_like(state.failure))
    return next_state, fail


# ---------------------------------------------------------------------------
# incremental contiguity
# ---------------------------------------------------------------------------

MAX_NEW_EDGES = 192


def update_contiguity(spec: EnvSpec, state: PlanState,
                      new_poly_ids: torch.Tensor, new_pt_ids: torch.Tensor,
                      new_seg_ids: torch.Tensor,
                      killed_ids: torch.Tensor) -> PlanState:
    """Maintain the feature-point incidence matrix and the contiguity edge
    table after a placement: every feature contact passes through a
    registered intersection, so contiguity(A, B) == any(I[A] & I[B]),
    computed as one f32 matmul over the incidence rows of the new features.
    New features arrive as kind-specific global-id groups (-1 = invalid)."""
    NP, NS, NPT = spec.NP, spec.NS, spec.NPT
    sentinel = spec.num_features
    like = state.poly_nvert
    kvalid = killed_ids >= 0
    e_hit = ((state.edge.long()[:, :, None] == killed_ids[None, None, :])
             & kvalid[None, None, :]).flatten(1).any(dim=1)
    edge_alive = state.edge_alive & ~e_hit

    killed_mask = jg.onehot_mask(killed_ids, kvalid, sentinel)
    incidence = state.incidence & ~killed_mask[:, None]

    new_ids = torch.cat([new_poly_ids, new_pt_ids, new_seg_ids])
    n_new = new_ids.shape[0]

    # rows for new features: a feature touches point p when p lies on one of
    # its segments (a point feature touches coincident points)
    tol = 10 * MERGE_TOL
    poly_c = torch.clamp(new_poly_ids, 0, NP - 1)
    p_segs, p_m = vmap(jg.ring_segments)(state.poly_ring[poly_c],
                                         state.poly_nvert[poly_c])
    d_poly = jg.point_segment_distance(
        state.pt[None, None, :, :], p_segs[:, :, None, 0, :],
        p_segs[:, :, None, 1, :])                        # (n_poly, KV, NPT)
    d_poly = torch.where(p_m[:, :, None], d_poly, jg.BIG)
    rows_poly = d_poly.amin(dim=1) <= tol

    new_pt_xy = state.pt[torch.clamp(new_pt_ids - NP - NS, 0, NPT - 1)]
    rows_pt = jg.norm(new_pt_xy[:, None, :] - state.pt[None, :, :]) <= tol

    s_seg = state.seg[torch.clamp(new_seg_ids - NP, 0, NS - 1)]
    d_seg = jg.point_segment_distance(
        state.pt[None, :, :], s_seg[:, None, 0, :], s_seg[:, None, 1, :])
    rows_seg = d_seg <= tol

    rows = torch.cat([rows_poly, rows_pt, rows_seg]) & state.pt_alive[None, :]
    incidence = jg.onehot_update(incidence, rows, new_ids, new_ids >= 0)

    # columns for new points against OLD alive polygons
    is_new_pt = new_pt_ids >= 0
    poly_segs, poly_m = vmap(jg.ring_segments)(state.poly_ring,
                                               state.poly_nvert)
    poly_m = poly_m & state.poly_alive[:, None]
    d_cols = jg.point_segment_distance(
        new_pt_xy[:, None, None, :], poly_segs[None, :, :, 0, :],
        poly_segs[None, :, :, 1, :])                     # (n_pts, NP, KV)
    d_cols = torch.where(poly_m[None, :, :], d_cols, jg.BIG)
    on_poly = (d_cols.amin(dim=2) <= tol) & is_new_pt[:, None]
    col_idx = torch.where(is_new_pt, new_pt_ids - NP - NS, NPT)
    col_onehot = (col_idx[:, None] == jg.arange(NPT, like)[None, :]) & \
        is_new_pt[:, None]                               # (n_pts, NPT)
    add_cols = (on_poly[:, :, None] & col_onehot[:, None, :]).any(dim=0)
    incidence = torch.cat([incidence[:NP] | add_cols, incidence[NP:]])

    # ---- contiguity via incidence matmul --------------------------------
    alive = feature_alive(spec, state)
    rows_now = rows & (new_ids >= 0)[:, None]
    touch = (rows_now.to(torch.float32)
             @ incidence.to(torch.float32).transpose(0, 1)) > 0.5
    touch = touch & alive[None, :] & (new_ids[:, None] >= 0)
    # drop self pairs and duplicate new-new pairs (keep earlier-rank target)
    ar_new = jg.arange(n_new, like)
    tgt_rank = jg.onehot_place(ar_new + 1, new_ids, new_ids >= 0,
                               sentinel) - 1
    feat_ids = jg.arange(sentinel, like)
    touch = touch & (feat_ids[None, :] != new_ids[:, None])
    touch = touch & ((tgt_rank[None, :] < 0)
                     | (tgt_rank[None, :] < ar_new[:, None]))

    # ---- compact new edges and write into free slots --------------------
    DEG_POLY, DEG_OTHER = 64, 24
    row_counts = touch.sum(dim=1)
    deg_cap = torch.cat([
        torch.full((N_NEW_POLY,), DEG_POLY, device=like.device),
        torch.full((n_new - N_NEW_POLY,), DEG_OTHER, device=like.device)])
    overflow = (row_counts > deg_cap).any()
    neigh_p = vmap(lambda row: jg.rank_compact(row, feat_ids, DEG_POLY))(
        touch[:N_NEW_POLY])
    neigh_o = vmap(lambda row: jg.rank_compact(row, feat_ids, DEG_OTHER))(
        touch[N_NEW_POLY:])
    valid_p = (jg.arange(DEG_POLY, like)[None, :]
               < row_counts[:N_NEW_POLY, None]).reshape(-1)
    valid_o = (jg.arange(DEG_OTHER, like)[None, :]
               < row_counts[N_NEW_POLY:, None]).reshape(-1)

    flat = torch.cat([valid_p, valid_o])
    n_edges_new = flat.sum()
    overflow = overflow | (n_edges_new > MAX_NEW_EDGES)
    src = torch.cat([
        new_ids[:N_NEW_POLY, None].expand(-1, DEG_POLY).reshape(-1),
        new_ids[N_NEW_POLY:, None].expand(-1, DEG_OTHER).reshape(-1)])
    tgt = torch.cat([neigh_p.reshape(-1), neigh_o.reshape(-1)])
    coded = src * (sentinel + 1) + tgt
    pairs_coded = jg.rank_compact(flat, coded, MAX_NEW_EDGES)
    pairs = torch.stack([torch.div(pairs_coded, sentinel + 1,
                                   rounding_mode='floor'),
                         torch.remainder(pairs_coded, sentinel + 1)], dim=1)
    pair_valid = jg.arange(MAX_NEW_EDGES, like) < n_edges_new

    slots, slot_ovf = free_slots(edge_alive, MAX_NEW_EDGES)
    overflow = overflow | (slot_ovf & (n_edges_new >= MAX_NEW_EDGES))
    n_free = (~edge_alive).sum()
    overflow = overflow | (n_edges_new > n_free)
    write = pair_valid & (slots < spec.NE)
    new_vals = jg.onehot_place(pairs, slots, write, spec.NE)
    hit = jg.onehot_mask(slots, write, spec.NE)
    edge = torch.where(hit[:, None], new_vals.to(state.edge.dtype), state.edge)
    edge_alive = edge_alive | hit
    return state.replace(edge=edge, edge_alive=edge_alive,
                         incidence=incidence,
                         failure=state.failure | overflow)


# ---------------------------------------------------------------------------
# road stage
# ---------------------------------------------------------------------------

def apply_road(spec: EnvSpec, state: PlanState, a: torch.Tensor):
    """Flip the chosen boundary segment to a road."""
    s = torch.clamp(a.long() - spec.NP, 0, spec.NS - 1)
    valid = (a >= spec.NP) & (a < spec.NP + spec.NS) & state.seg_alive[s] & \
        (state.seg_type[s] == city_config.BOUNDARY)
    new_t = torch.where(valid, city_config.ROAD, state.seg_type[s])
    seg_type = jg.set_at(state.seg_type, s, new_t.to(state.seg_type.dtype))
    return state.replace(seg_type=seg_type,
                         road_steps=state.road_steps + 1), ~valid


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

def _isin(types, group):
    out = types == group[0]
    for g in group[1:]:
        out = out | (types == g)
    return out


def life_circle_reward(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """Service coverage + decentralization (plan_client.py:889-952)."""
    cell = spec.cell_edge_length
    cents = state.poly_feat[1:3].transpose(0, 1)
    areas = state.poly_feat[0]
    alive = state.poly_alive
    types = state.poly_type
    is_res = alive & (types == city_config.RESIDENTIAL)
    any_res = is_res.any()

    groups = [(city_config.BUSINESS,), (city_config.OFFICE,),
              (city_config.SCHOOL,),
              (city_config.HOSPITAL_L, city_config.HOSPITAL_S),
              (city_config.RECREATION,)]
    dist = jg.norm(cents[:, None, :] - cents[None, :, :])
    life10_acc = torch.zeros_like(areas)
    n_service = torch.zeros_like(areas[0])
    pair_acc = torch.zeros_like(areas[0])
    pair_cnt = torch.zeros_like(areas[0])
    for g in groups:
        member = alive & _isin(types, g)
        has = member.any()
        dmin = torch.where(member[None, :], dist, jg.BIG).amin(dim=1)
        within = (dmin * cell <= 500.0) & is_res
        life10_acc = life10_acc + torch.where(has, within.to(torch.float32),
                                              0.0)
        n_service = n_service + has.to(torch.float32)
        n_mem = member.sum()
        pd = torch.where(member[:, None] & member[None, :], dist, 0.0)
        n_pairs = n_mem * (n_mem - 1)
        avg_pd = torch.where(n_pairs > 0,
                             pd.sum() / torch.clamp_min(n_pairs, 1), 0.0)
        pair_acc = pair_acc + torch.where(n_mem > 1, avg_pd, 0.0)
        pair_cnt = pair_cnt + (n_mem > 1).to(torch.float32)

    life10 = life10_acc / torch.clamp_min(n_service, 1.0)
    if spec.weight_by_area:
        w = torch.where(is_res, areas, 0.0)
        efficiency = (life10 * w).sum() / torch.clamp_min(w.sum(), 1e-9)
    else:
        efficiency = torch.where(is_res, life10, 0.0).sum() / \
            torch.clamp_min(is_res.sum(), 1)
    ref_dist = jg.sqrt(torch.tensor(spec.grid_cols ** 2
                                    + spec.grid_rows ** 2,
                                    dtype=torch.float32,
                                    device=areas.device))
    decentral = torch.where(pair_cnt > 0,
                            pair_acc / torch.clamp_min(pair_cnt, 1.0),
                            0.0) / ref_dist
    reward = efficiency + 0.05 * decentral
    return torch.where(any_res & (n_service > 0), reward, 0.0)


MAX_RES_POLYS = 96
MAX_GREEN_POLYS = 24


def greenness_reward(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """Sample-point approximation of green 300 m buffer coverage over
    residential area, over the first MAX_RES_POLYS residential and
    MAX_GREEN_POLYS qualifying green polygons."""
    cell = spec.cell_edge_length
    cell_area = cell * cell
    areas = state.poly_feat[0]
    alive = state.poly_alive
    types = state.poly_type
    like = state.poly_nvert
    is_green = alive & _isin(types, city_config.GREEN_ID) & \
        (areas * cell_area >= city_config.GREEN_AREA_THRESHOLD)
    is_res = alive & (types == city_config.RESIDENTIAL)
    radius = 300.0 / cell

    ar_np = jg.arange(spec.NP, like)
    res_idx = jg.rank_compact(is_res, ar_np, MAX_RES_POLYS)
    res_valid = jg.arange(MAX_RES_POLYS, like) < is_res.sum()
    green_idx = jg.rank_compact(is_green, ar_np, MAX_GREEN_POLYS)
    green_valid = jg.arange(MAX_GREEN_POLYS, like) < is_green.sum()

    res_ring = state.poly_ring[res_idx]
    res_nv = state.poly_nvert[res_idx]
    cents = state.poly_feat[1:3].transpose(0, 1)[res_idx]
    # sample points per residential poly: vertices + centroid
    samples = torch.cat([res_ring, cents[:, None, :]], dim=1)
    vm = jg.arange(spec.KV, like)[None, :] < res_nv[:, None]
    smask = torch.cat([vm, torch.ones_like(vm[:, :1])], dim=1) \
        & res_valid[:, None]

    gsegs, gmask = vmap(jg.ring_segments)(state.poly_ring[green_idx],
                                          state.poly_nvert[green_idx])
    gmask = gmask & green_valid[:, None]
    gs = gsegs.reshape(-1, 2, 2)
    d = jg.point_segment_distance(samples.reshape(-1, 2)[:, None, :],
                                  gs[None, :, 0, :], gs[None, :, 1, :])
    d = torch.where(gmask.reshape(-1)[None, :], d, jg.BIG)
    covered = (d.amin(dim=1) <= radius).reshape(MAX_RES_POLYS, spec.KV + 1)
    frac = (covered & smask).sum(dim=1) / \
        torch.clamp_min(smask.sum(dim=1), 1)
    w = torch.where(res_valid, areas[res_idx], 0.0)
    reward = (frac * w).sum() / torch.clamp_min(w.sum(), 1e-9)
    return torch.where(is_res.any() & is_green.any(), reward, 0.0)


def concept_reward(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """Center/axis planning-concept adherence: per concept, the share of
    the polygons near it (within its distance, or containing its center /
    axis midpoint) whose land use the concept asks for; an axis also scores
    the variety of those land uses and their spread along it."""
    if not spec.concepts:
        return torch.zeros_like(state.land_use_reward)
    dev = state.poly_alive.device
    f32 = dict(dtype=torch.float32, device=dev)
    cell = spec.cell_edge_length
    alive = state.poly_alive
    types = state.poly_type.long()
    cents = state.poly_feat[1:3].transpose(0, 1)
    segs, smask = vmap(jg.ring_segments)(state.poly_ring, state.poly_nvert)
    total = torch.zeros_like(state.land_use_reward)
    for (kind, cx, cy, ex, ey, distance, bitmask) in spec.concepts:
        a = torch.tensor([cx, cy], **f32)
        b = torch.tensor([ex, ey], **f32)
        band = distance / cell
        if kind == 0.0:
            d = jg.point_segment_distance(a[None, None, :], segs[:, :, 0, :],
                                          segs[:, :, 1, :])
            probe = a
        else:
            d = torch.minimum(
                jg.point_segment_distance(segs[:, :, 0, :], a[None, None, :],
                                          b[None, None, :]),
                jg.point_segment_distance(segs[:, :, 1, :], a[None, None, :],
                                          b[None, None, :]))
            probe = 0.5 * (a + b)
        inside = vmap(lambda r, n: jg.point_in_ring(probe, r, n))(
            state.poly_ring, state.poly_nvert)
        dmin = torch.where(smask, d, jg.BIG).amin(dim=1)
        in_region = alive & ((dmin <= band) | inside)
        # (1 << clip(type, 0, 30)) & bitmask > 0, as a table over types
        mask_int = int(bitmask)
        related_tbl = torch.tensor([(mask_int >> t) & 1 == 1
                                    for t in range(31)], device=dev)
        related = in_region & related_tbl[types.clamp(0, 30)]
        n_in = in_region.sum()
        n_rel = related.sum()
        ratio = torch.where(n_in > 0, n_rel / torch.clamp_min(n_in, 1), 0.0)
        if kind == 0.0:
            total = total + ratio
            continue
        n_related_types = bin(mask_int).count('1')
        # the land uses present among the related polygons (the JAX code's
        # scatter-max, as a one-hot compare that vmaps on every torch)
        present = ((types[:, None] == jg.arange(city_config.NUM_TYPES,
                                                types)[None, :])
                   & related[:, None]).any(dim=0)
        type_div = present.sum() / max(n_related_types, 1)
        ab = b - a
        denom = torch.clamp_min((ab * ab).sum(), 1e-9)
        tproj = torch.clamp(jg.dot2(cents - a, ab[None, :]) / denom, 0.0, 1.0)
        tmax = torch.where(related, tproj, -jg.BIG).amax()
        tmin = torch.where(related, tproj, jg.BIG).amin()
        expand = torch.where(n_rel > 0, tmax - tmin, 0.0)
        total = total + torch.where(n_rel > 0,
                                    (ratio + type_div + expand) / 3.0, 0.0)
    return total / len(spec.concepts)


def land_use_stage_reward(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """Weighted land-use reward at the stage boundary."""
    r = torch.zeros_like(state.land_use_reward)
    if spec.life_circle_weight > 0:
        r = r + spec.life_circle_weight * life_circle_reward(spec, state)
    if spec.greenness_weight > 0:
        r = r + spec.greenness_weight * greenness_reward(spec, state)
    if spec.concept_weight > 0 and spec.concepts:
        r = r + spec.concept_weight * concept_reward(spec, state)
    return r


# ---------------------------------------------------------------------------
# road-network reward (batched: every function takes a leading env axis B)
# ---------------------------------------------------------------------------

ROAD_CHUNK = 8        # envs per pass of the (2NS, 2NS) endpoint tensors
MAX_DIAG = 128        # non-axis-aligned roads tested per env (the JAX cap)
DIAG_CHUNK = 4        # envs per pass of the (walks, diagonals) tensors
_WALK_EPS = 4.8828125e-4   # 2**-11: walk lines clear of slice-point rationals


def _reach_squaring(r: torch.Tensor) -> torch.Tensor:
    """Transitive closure of (B, n, n) bool reachability by ceil(log2 n)
    boolean matrix squarings (the JAX code's method). On the card the
    product runs in bf16: 0/1 inputs are exact in bf16 and every partial
    sum is of non-negative terms, so a positive sum stays >= 1 in any
    accumulation precision (allow_bf16_reduced_precision_reduction
    included) and '> 0.5' is exact."""
    dt = torch.bfloat16 if r.is_cuda else torch.float32
    iters = max(int(math.ceil(math.log2(max(r.shape[-1], 2)))), 1)
    for _ in range(iters):
        rf = r.to(dt)
        r = r | (torch.bmm(rf, rf) > 0.5)
    return r


def _min_label_propagation(r: torch.Tensor, active: torch.Tensor):
    """Component-minimum labels of the (B, n, n) bool graph r by min-label
    propagation with pointer jumping, repeated until no label changes (one
    host sync per round). Every label is a member of its node's component
    at every round, and a round changes nothing only when each component
    carries one label, which is then its minimum member."""
    n = r.shape[-1]
    ar = jg.arange(n, r)
    lab = torch.where(active, ar, n)
    while True:
        new = torch.minimum(
            lab, torch.where(r, lab[:, None, :], n).amin(dim=-1))
        jumped = torch.gather(new, 1, new.clamp(max=n - 1))
        new = torch.where(new < n, torch.minimum(new, jumped), n)
        if torch.equal(new, lab):
            return lab
        lab = new


def _components_min_label(adj: torch.Tensor, active: torch.Tensor,
                          method: str = None) -> torch.Tensor:
    """Connected-component labels (minimum member index) of the batched
    undirected graphs adj (B, n, n) over the active nodes (B, n); inactive
    nodes get n. The labels are unique, so any exact method gives the
    JAX code's: 'squaring' (its boolean matrix squaring; the default on
    the card, a fixed number of tensor-core products and no host sync) or
    'propagation' (the default on the CPU, O(n^2) a round instead of
    O(n^3) a squaring)."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    r = (adj & active[:, :, None] & active[:, None, :]) \
        | (eye & active[:, :, None])
    method = method or ('squaring' if adj.is_cuda else 'propagation')
    if method == 'propagation':
        return _min_label_propagation(r, active)
    r = _reach_squaring(r)
    labels = torch.where(r, jg.arange(n, r), n).amin(dim=-1)
    return torch.where(active, labels, n)


def _bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, m, k) @ (B, k, n) of 0/1 values, > 0.5: integer sums below 2**24
    of 0/1 terms, exact in f32 whether or not TF32 is allowed."""
    return torch.bmm(a.to(torch.float32), b.to(torch.float32)) > 0.5


def _seg_scan_min(v, start, dim: int, reverse: bool):
    """Segmented directional inclusive min-scan along dim: at each cell,
    the minimum over the cells since the last segment start (start ==
    True) at or before it. The JAX code's associative_scan with the
    operator (x, y) -> (y.start ? y.v : min(x.v, y.v), x.start | y.start),
    as a log-step (Hillis–Steele) doubling; min is exact and idempotent,
    so the result is the JAX scan's bit for bit."""
    if reverse:
        v, start = v.flip(dim), start.flip(dim)
    n = v.shape[dim]
    d = 1
    while d < n:
        v_hi, f_hi = v.narrow(dim, d, n - d), start.narrow(dim, d, n - d)
        v_lo, f_lo = v.narrow(dim, 0, n - d), start.narrow(dim, 0, n - d)
        v = torch.cat([v.narrow(dim, 0, d),
                       torch.where(f_hi, v_hi, torch.minimum(v_lo, v_hi))],
                      dim)
        start = torch.cat([start.narrow(dim, 0, d), f_hi | f_lo], dim)
        d *= 2
    return v.flip(dim) if reverse else v


def _flood_min(vals, gates, max_sweeps: int):
    """Sweep the four directional segmented min-scans to a fixpoint, batched:
    sweeps repeat until no env changes (one host sync a sweep), with the
    JAX while_loop's backstop of max_sweeps. A sweep leaves an env at its
    fixpoint unchanged, so each env gets exactly its own fixpoint.
    gates = can-receive-from-(left, right, up, down), each (B, RC, CC)."""
    g_l, g_r, g_u, g_d = (~g for g in gates)

    def sweep(v):
        v = _seg_scan_min(v, g_l, 2, False)
        v = _seg_scan_min(v, g_r, 2, True)
        v = _seg_scan_min(v, g_u, 1, False)
        return _seg_scan_min(v, g_d, 1, True)

    v = sweep(vals)
    for _ in range(max_sweeps):
        v2 = sweep(v)
        if torch.equal(v2, v):
            break
        v = v2
    return v


def _diag_blocks(seg, diag, n_diag, xwalk, ywalk):
    """Walks blocked by non-axis-aligned roads, for envs with at least one:
    (block_r (B, RC, CC-1), block_d (B, RC-1, CC)) of the proper crossings
    between each walk and the env's first MAX_DIAG diagonal roads (the JAX
    cap: a network with more would under-block, as there)."""
    B, NS = diag.shape
    RC, CC = ywalk.shape[0], xwalk.shape[0]
    block_r = torch.zeros(B, RC, CC - 1, dtype=torch.bool, device=seg.device)
    block_d = torch.zeros(B, RC - 1, CC, dtype=torch.bool, device=seg.device)
    cxg, cyg = torch.meshgrid(xwalk, ywalk, indexing='xy')
    centers = torch.stack([cxg, cyg], dim=-1)               # (RC, CC, 2)
    walks = ((centers[:, :-1].reshape(-1, 2), centers[:, 1:].reshape(-1, 2)),
             (centers[:-1].reshape(-1, 2), centers[1:].reshape(-1, 2)))
    idx = torch.nonzero(n_diag > 0).squeeze(1)
    for chunk in idx.split(DIAG_CHUNK):
        # entries beyond an env's diagonal count are masked out, so the
        # buffer is cut to the chunk's largest count (at most MAX_DIAG)
        k = min(int(n_diag[chunk].max()), MAX_DIAG)
        packed = vmap(lambda f, v: jg.rank_compact(f, v, MAX_DIAG))(
            diag[chunk], seg[chunk].reshape(-1, NS, 4))[:, :k]
        dvalid = jg.arange(k, seg)[None, :] < n_diag[chunk][:, None]
        da = packed[:, None, :, 0:2]
        db = packed[:, None, :, 2:4]
        out = []
        for p1, p2 in walks:
            hit = jg.segments_cross(p1[None, :, None, :], p2[None, :, None, :],
                                    da, db)
            out.append((hit & dvalid[:, None, :]).any(dim=-1))
        block_r[chunk] = out[0].reshape(-1, RC, CC - 1)
        block_d[chunk] = out[1].reshape(-1, RC - 1, CC)
    return block_r, block_d


def _large_block_count(spec: EnvSpec, seg: torch.Tensor,
                       is_road: torch.Tensor) -> torch.Tensor:
    """(B,) faces of the road network with a bounding box over 800 m, by
    the JAX code's raster face decomposition on the scenario grid.

    Cell centers are face samples; two 4-adjacent centers share a face iff
    the walk between them crosses no road properly (dangling tails do not
    separate faces, as in polygonize). Components touching the raster
    border are the outer region. Walk lines sit _WALK_EPS off the
    half-integers, so that a chain node of a collinear road never lies on
    one. Axis-aligned roads block walks through row-mask x column-mask
    products; other roads through the general proper-crossing test
    (_diag_blocks). seg: (B, NS, 2, 2); is_road: (B, NS)."""
    CC = int(spec.grid_cols)
    RC = int(spec.grid_rows)
    cell = spec.cell_edge_length
    dev = seg.device
    B = seg.shape[0]
    ax, ay = seg[..., 0, 0], seg[..., 0, 1]
    bx, by = seg[..., 1, 0], seg[..., 1, 1]
    adx, ady = torch.abs(bx - ax), torch.abs(by - ay)
    vert = (adx <= 1e-6) & (ady > 1e-6)
    horiz = (ady <= 1e-6) & (adx > 1e-6)
    diag = is_road & ~vert & ~horiz & (ady + adx > 1e-6)

    f32 = dict(dtype=torch.float32, device=dev)
    ywalk = torch.arange(RC, **f32) + 0.5 + _WALK_EPS    # horizontal lines
    xwalk = torch.arange(CC, **f32) + 0.5 + _WALK_EPS    # vertical lines

    # vertical roads x rightward walks
    ylo, yhi = torch.minimum(ay, by), torch.maximum(ay, by)
    row_v = (ylo[:, None, :] < ywalk[None, :, None]) \
        & (ywalk[None, :, None] < yhi[:, None, :]) \
        & (vert & is_road)[:, None, :]                    # (B, RC, NS)
    col_v = (ax[:, :, None] > xwalk[None, None, :-1]) \
        & (ax[:, :, None] < (xwalk[:-1] + 1.0)[None, None, :])  # (B, NS, CC-1)
    block_r = _bool_matmul(row_v, col_v)                  # (B, RC, CC-1)

    # horizontal roads x downward walks
    xlo, xhi = torch.minimum(ax, bx), torch.maximum(ax, bx)
    col_h = (xlo[:, None, :] < xwalk[None, :, None]) \
        & (xwalk[None, :, None] < xhi[:, None, :]) \
        & (horiz & is_road)[:, None, :]                   # (B, CC, NS)
    row_h = (ay[:, :, None] > ywalk[None, None, :-1]) \
        & (ay[:, :, None] < (ywalk[:-1] + 1.0)[None, None, :])  # (B, NS, RC-1)
    block_d = _bool_matmul(col_h, row_h).transpose(1, 2)  # (B, RC-1, CC)

    # the JAX code's cond(n_diag > 0): the diagonal branch leaves an env
    # without diagonal roads as it was, so it runs for the envs with some
    n_diag = diag.sum(dim=1)
    if bool((n_diag > 0).any()):
        br, bd = _diag_blocks(seg, diag, n_diag, xwalk, ywalk)
        block_r, block_d = block_r | br, block_d | bd

    F = torch.nn.functional
    pass_r = F.pad(~block_r, (0, 1), value=False)
    pass_l = F.pad(~block_r, (1, 0), value=False)
    pass_d = F.pad(~block_d, (0, 0, 0, 1), value=False)
    pass_u = F.pad(~block_d, (0, 0, 1, 0), value=False)

    big = RC * CC
    ids = torch.arange(big, device=dev).reshape(1, RC, CC).expand(B, RC, CC)
    labels = _flood_min(ids, (pass_l, pass_r, pass_u, pass_d), big)

    # per-face extents: min/max coordinates flooded within equal labels.
    # The four floods run as one min-flood of (x, y, -x, -y): each has the
    # same gates, and a fixpoint does not depend on what floods beside it
    lr = F.pad(labels[:, :, 1:], (0, 1), value=big)
    ll = F.pad(labels[:, :, :-1], (1, 0), value=big)
    ld = F.pad(labels[:, 1:], (0, 0, 0, 1), value=big)
    lu = F.pad(labels[:, :-1], (0, 0, 1, 0), value=big)
    gates = tuple(g.repeat(4, 1, 1) for g in (
        pass_l & (ll == labels), pass_r & (lr == labels),
        pass_u & (lu == labels), pass_d & (ld == labels)))
    gx = torch.arange(CC, **f32)[None, :].expand(RC, CC)
    gy = torch.arange(RC, **f32)[:, None].expand(RC, CC)
    coords = torch.stack([gx, gy, -gx, -gy])[:, None].expand(4, B, RC, CC)
    ext = _flood_min(coords.reshape(4 * B, RC, CC), gates,
                     big).reshape(4, B, RC, CC)
    minx, miny, maxx, maxy = ext[0], ext[1], -ext[2], -ext[3]

    is_repr = labels == ids
    touches_border = (minx == 0) | (miny == 0) | (maxx == CC - 1) | \
        (maxy == RC - 1)
    # face width/height: cell spans + the bounding road on each side
    w_m = (maxx - minx + 1.0) * cell
    h_m = (maxy - miny + 1.0) * cell
    large = is_repr & ~touches_border & ((w_m > 800.0) | (h_m > 800.0))
    return large.sum(dim=(1, 2))


def _endpoint_pairs(seg: torch.Tensor, valid_e: torch.Tensor):
    """(B, 2NS, 2NS) bool: road endpoints i, j with norm(end_i - end_j) <=
    MERGE_TOL, rounded as the reference rounds it. The exact norm is taken
    only where both coordinate differences are within 2 MERGE_TOL: beyond
    that the norm exceeds MERGE_TOL whatever the rounding, so the result
    is the reference's without its (2NS, 2NS, 2) tensor."""
    end = seg.reshape(seg.shape[0], -1, 2)
    dx = end[:, :, None, 0] - end[:, None, :, 0]
    dy = end[:, :, None, 1] - end[:, None, :, 1]
    near = (torch.abs(dx) <= 2 * MERGE_TOL) \
        & (torch.abs(dy) <= 2 * MERGE_TOL) \
        & valid_e[:, :, None] & valid_e[:, None, :]
    b, i, j = torch.nonzero(near, as_tuple=True)
    d = torch.stack([dx[b, i, j], dy[b, i, j]], dim=-1)
    pair = torch.zeros_like(near)
    pair[b, i, j] = jg.norm(d) <= MERGE_TOL
    return pair


def _road_network_reward_chunk(spec: EnvSpec, seg, seg_alive, seg_type):
    NS = spec.NS
    cell = spec.cell_edge_length
    B = seg.shape[0]
    ar = jg.arange(NS, seg)
    is_road = seg_alive & (seg_type == city_config.ROAD)
    valid_e = torch.repeat_interleave(is_road, 2, dim=1)
    pair = _endpoint_pairs(seg, valid_e)

    # segment-touch adjacency (any endpoint coincidence)
    adj = pair.reshape(B, NS, 2, NS, 2).any(dim=4).any(dim=2)
    labels = _components_min_label(adj, is_road)
    n_comp = (is_road & (labels == ar)).sum(dim=1)
    connectivity = 1.0 / torch.clamp_min(n_comp, 1)

    lengths = jg.norm(seg[:, :, 1] - seg[:, :, 0])
    road_len = torch.where(is_road, lengths, 0.0)
    road_km = road_len.sum(dim=1) * cell / 1000.0
    density = road_km / (spec.community_area / 1e6)
    density_reward = density / 10.0

    deg = pair.sum(dim=2)                            # endpoint multiplicity
    num_dead = (valid_e & (deg == 1)).sum(dim=1)
    dead_end_penalty = 1.0 / (num_dead + 1.0)

    # false-node merging: segments sharing a degree-2 node form one road
    deg2 = deg == 2
    chain_pair = pair & deg2[:, :, None] & deg2[:, None, :]
    chain_adj = chain_pair.reshape(B, NS, 2, NS, 2).any(dim=4).any(dim=2) \
        & ~torch.eye(NS, dtype=torch.bool, device=seg.device)
    chain_labels = _components_min_label(chain_adj, is_road)
    # merged length of each chain at its label: the JAX code's f32 one-hot
    # product, as a masked sum (no matmul, so no TF32 question)
    onehot = (chain_labels[:, :, None] == ar) & is_road[:, :, None]
    merged_len = torch.where(onehot, road_len[:, :, None], 0.0).sum(dim=1)
    is_repr = is_road & (chain_labels == ar)
    merged_m = merged_len * cell
    num_short = (is_repr & (merged_m < 100.0)).sum(dim=1)
    num_long = (is_repr & (merged_m > 600.0)).sum(dim=1)
    short_penalty = 1.0 / (num_short + 1.0)
    long_penalty = 1.0 / (num_long + 1.0)

    num_large = _large_block_count(spec, seg, is_road)
    block_penalty = 1.0 / (num_large + 1.0)

    reward = (connectivity + density_reward + dead_end_penalty
              + short_penalty + long_penalty + block_penalty) / 6.0
    counts = {'components': n_comp, 'dead_ends': num_dead,
              'short': num_short, 'long': num_long, 'large_blocks': num_large}
    return reward, counts


def batched_road_network_reward(spec: EnvSpec, states: PlanState,
                                with_counts: bool = False):
    """Road-network quality of a batch of states (leading env axis B):
    connectivity by connected components of the segment-touch graph,
    road density, dead ends, short/long penalties on false-node-merged
    roads (degree-2 chains) and the large-block penalty of the raster face
    decomposition, each term the JAX road_network_reward's. Not vmappable
    (its fixpoint loops sync the host); ROAD_CHUNK envs a pass bound the
    memory. With with_counts, also the integer terms by name, (B,) each."""
    if torch._C._functorch.is_batchedtensor(states.seg):
        raise RuntimeError('batched_road_network_reward takes a batch of '
                           'states and cannot run under vmap')
    rewards, counts = [], []
    for i in range(0, states.seg.shape[0], ROAD_CHUNK):
        s = slice(i, i + ROAD_CHUNK)
        r, c = _road_network_reward_chunk(spec, states.seg[s],
                                          states.seg_alive[s],
                                          states.seg_type[s])
        rewards.append(r)
        counts.append(c)
    reward = torch.cat(rewards)
    if not with_counts:
        return reward
    return reward, {k: torch.cat([c[k] for c in counts]) for k in counts[0]}


def road_network_reward(spec: EnvSpec, state: PlanState) -> torch.Tensor:
    """The road-network reward of one state: the batched form on a batch
    of one. Under vmap it raises; the rollout calls the batched form."""
    return batched_road_network_reward(
        spec, state.map(lambda x: x[None]))[0]


# ---------------------------------------------------------------------------
# observation
# ---------------------------------------------------------------------------

def _one_hot(idx, n):
    """jax.nn.one_hot: an out-of-range index gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _node_features(spec: EnvSpec, state: PlanState):
    """Per-slot node feature matrix (NF, 23)."""
    dev = state.poly_alive.device
    cell = spec.cell_edge_length
    cell_area = cell * cell
    types = feature_types(spec, state)

    cents_p = state.poly_feat[1:3].transpose(0, 1)
    areas_p = state.poly_feat[0]
    perim_p = state.poly_feat[3]
    bounds_p = state.poly_feat[4:8].transpose(0, 1)

    s0, s1 = state.seg[:, 0], state.seg[:, 1]
    seg_mid = 0.5 * (s0 + s1)
    seg_len = jg.norm(s1 - s0)
    seg_lo = torch.minimum(s0, s1)
    seg_hi = torch.maximum(s0, s1)

    z_s = torch.zeros(spec.NS, device=dev)
    z_p = torch.zeros(spec.NPT, device=dev)
    half_s = torch.full((spec.NS,), 0.5, device=dev)
    half_p = torch.full((spec.NPT,), 0.5, device=dev)
    cents = torch.cat([cents_p, seg_mid, state.pt])
    areas = torch.cat([areas_p, z_s, z_p]) * cell_area
    lengths = torch.cat([perim_p, seg_len, z_p]) * cell
    widths = torch.cat([bounds_p[:, 2] - bounds_p[:, 0],
                        seg_hi[:, 0] - seg_lo[:, 0], z_p]) * cell
    heights = torch.cat([bounds_p[:, 3] - bounds_p[:, 1],
                         seg_hi[:, 1] - seg_lo[:, 1], z_p]) * cell
    rect = torch.cat([state.poly_rect, half_s, half_p])
    eqi = torch.cat([state.poly_eqi, half_s, half_p])
    sc = torch.cat([state.poly_sc, half_s, half_p])

    one_hot = _one_hot(types, city_config.NUM_TYPES + 1)
    xy = cents / torch.tensor([spec.grid_cols, spec.grid_rows], device=dev)
    return torch.cat([
        one_hot, 2 * xy - 1,
        (2 * areas / spec.common_max_area - 1)[:, None],
        (2 * lengths / spec.common_max_edge_length - 1)[:, None],
        (2 * widths / spec.common_max_edge_length - 1)[:, None],
        (2 * heights / spec.common_max_edge_length - 1)[:, None],
        (2 * rect - 1)[:, None], (2 * eqi - 1)[:, None],
        (2 * sc - 1)[:, None]], dim=-1).to(torch.float32)


def _numerical_and_current(spec: EnvSpec, state: PlanState):
    c = _consts(spec, state)
    dev = state.poly_alive.device
    req_ratio = c['req_ratio']
    req_count = c['req_count'].to(torch.float32)
    max_count = torch.clamp_min(req_count.amax(), 1.0)
    ratio = state.plan_area / spec.community_area
    numerical = torch.cat([
        req_ratio, req_count / max_count, ratio,
        state.plan_count.to(torch.float32) / max_count])

    t = pending_land_use_type(spec, state)
    in_lu = state.stage == 0
    n_oh = city_config.NUM_TYPES + 1
    cur = torch.cat([
        _one_hot(t, n_oh),
        torch.zeros(2, device=dev),
        torch.stack([2 * c['max_area'][t] / spec.common_max_area - 1,
                     2 * 4 * c['max_edge'][t] / spec.common_max_edge_length - 1,
                     2 * c['max_edge'][t] / spec.common_max_edge_length - 1,
                     2 * c['max_edge'][t] / spec.common_max_edge_length - 1]),
        torch.ones(3, device=dev)])
    dummy = torch.cat([
        _one_hot(torch.tensor(city_config.FEASIBLE, device=dev), n_oh),
        torch.tensor([0.0, 0.0, -1.0, -1.0, -1.0, -1.0, 0.0, 0.0, 0.0],
                     device=dev)])
    cur = torch.where(in_lu, cur, dummy)
    stage_oh = _one_hot(state.stage.long(), 3)
    return numerical, cur, stage_oh, t


def build_obs(spec: EnvSpec, state: PlanState):
    """Slot-layout observation: node i IS feature slot i, edge e IS edge
    slot e; dead slots are masked out (action indices are slot indices)."""
    alive = feature_alive(spec, state)
    feats = _node_features(spec, state)
    nodes = torch.where(alive[:, None], feats, 0.0)
    pad_node = spec.num_features - 1
    # INVARIANT: edge_alive implies both endpoints alive
    e_ok = state.edge_alive
    edges = torch.where(e_ok[:, None], state.edge, pad_node).to(torch.int32)
    numerical, cur, stage_oh, t = _numerical_and_current(spec, state)
    in_lu = state.stage == 0
    in_rd = state.stage == 1
    lu_mask = land_use_mask(spec, state, t) & e_ok & in_lu
    rd_mask = road_mask(spec, state) & alive & in_rd
    return (numerical, nodes, edges, cur, alive, e_ok, lu_mask, rd_mask,
            stage_oh)


def packed_edge_ok(spec: EnvSpec, state: PlanState, alive: torch.Tensor):
    """(NE,) alive edges whose two endpoints are alive features."""
    v0, v1 = endpoint_lookup(state.edge, alive[None, :])
    return state.edge_alive & v0[0] & v1[0]


def build_obs_packed(spec: EnvSpec, state: PlanState):
    """Reference-layout observation: alive features packed to the front and
    padded to (max_num_nodes, max_num_edges), the layout of the host
    ObservationExtractor (for host-parity checks and plan export; the
    rollout uses the slot layout of build_obs)."""
    alive = feature_alive(spec, state)
    feats = _node_features(spec, state)
    mnn, mne = spec.max_num_nodes, spec.max_num_edges

    n_alive = alive.sum()
    perm = torch.argsort((~alive).to(torch.int8), stable=True)
    node_mask = jg.arange(mnn, alive) < n_alive
    gather_idx = perm[:mnn]
    nodes = torch.where(node_mask[:, None], feats[gather_idx], 0.0)

    pad_node = mnn - 1
    packed_lookup = torch.where(alive, torch.cumsum(alive.to(torch.int64), 0)
                                - 1, pad_node)
    rd_mask = node_mask & road_mask(spec, state)[gather_idx]

    e_ok = packed_edge_ok(spec, state, alive)
    n_edges = e_ok.sum()
    eperm = torch.argsort((~e_ok).to(torch.int8), stable=True)[:mne]
    edge_mask = jg.arange(mne, alive) < n_edges
    remapped = jg.take(packed_lookup, state.edge.reshape(-1)).reshape(
        state.edge.shape).to(torch.int32)
    edges = torch.where(edge_mask[:, None], remapped[eperm], pad_node).to(
        torch.int32)

    numerical, cur, stage_oh, t = _numerical_and_current(spec, state)
    in_lu = state.stage == 0
    in_rd = state.stage == 1
    lu_mask_slots = land_use_mask(spec, state, t) & e_ok
    lu_mask = edge_mask & lu_mask_slots[eperm] & in_lu
    rd_mask = rd_mask & in_rd
    return (numerical, nodes, edges, cur, node_mask, edge_mask, lu_mask,
            rd_mask, stage_oh)


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def env_step(spec: EnvSpec, state: PlanState, action: torch.Tensor,
             compute_rewards: bool = True):
    """One transition. action: (2,) int [land_use edge slot index, road
    node slot index]. Returns (next_state, reward, done, info).

    With compute_rewards (one env, eagerly) the stage-boundary reward is
    computed on the step that ends the stage; with compute_rewards=False
    (the vmapped step) it is left to the caller (rollout.apply_stage_rewards
    evaluates it only for steps where some episode finished)."""
    in_lu = state.stage == 0
    in_rd = state.stage == 1

    lu_next, lu_bits = apply_land_use(spec, state, action[0])
    rd_next, rd_fail = apply_road(spec, state, action[1])

    lu_next, rd_next = canonical(lu_next), canonical(rd_next)
    nxt = PlanState(*(torch.where(in_lu, getattr(lu_next, n),
                                  getattr(rd_next, n)) for n in FIELD_NAMES))
    fail_bits = torch.where(in_lu, lu_bits, _bit(FAIL_ROAD, rd_fail))

    # land-use completion -> fill leftover, transition
    lu_done = is_land_use_done(spec, nxt) & in_lu
    leftover = nxt.poly_alive & (nxt.poly_type == city_config.FEASIBLE)
    poly_type = torch.where(lu_done & leftover, city_config.GREEN_S,
                            nxt.poly_type)
    boundary_cnt = (nxt.seg_alive
                    & (nxt.seg_type == city_config.BOUNDARY)).sum()
    total_road = torch.floor(boundary_cnt * spec.road_ratio).to(torch.int32)

    if spec.skip_road:
        # build_all_road + done (suppressed with keep_boundaries)
        if spec.keep_boundaries:
            seg_type = nxt.seg_type
        else:
            seg_type = torch.where(lu_done & nxt.seg_alive
                                   & (nxt.seg_type == city_config.BOUNDARY),
                                   city_config.ROAD, nxt.seg_type)
        stage = torch.where(lu_done, 2, nxt.stage)
        total_road_steps = nxt.total_road_steps
    else:
        seg_type = nxt.seg_type
        stage = torch.where(lu_done, 1, nxt.stage)
        total_road_steps = torch.where(lu_done, total_road,
                                       nxt.total_road_steps)

    # road completion
    rd_done = in_rd & (nxt.road_steps >= nxt.total_road_steps)
    stage = torch.where(rd_done, 2, stage)

    nxt = nxt.replace(poly_type=poly_type, seg_type=seg_type, stage=stage,
                      total_road_steps=total_road_steps)

    # failure / dead-state checks
    t_next = pending_land_use_type(spec, nxt)
    no_moves = (stage == 0) & \
        ~eligible_land_use_polys(spec, nxt, t_next).any()
    no_road_moves = (stage == 1) & ~(
        nxt.seg_alive & (nxt.seg_type == city_config.BOUNDARY)).any()
    fail_bits = fail_bits | _bit(FAIL_NO_MOVES, no_moves) \
        | _bit(FAIL_NO_ROAD_MOVES, no_road_moves)
    fail = fail_bits != 0

    # rewards at stage boundaries, each evaluated only on the step that
    # needs it (host-synced branches: one env, never under vmap)
    lu_reward_val = torch.zeros_like(nxt.land_use_reward)
    road_reward_val = torch.zeros_like(nxt.land_use_reward)
    if compute_rewards:
        if bool(lu_done):
            lu_reward_val = land_use_stage_reward(spec, nxt)
        if spec.road_network_weight > 0 and not spec.skip_road \
                and bool(rd_done & ~fail):
            road_reward_val = spec.road_network_weight * \
                road_network_reward(spec, nxt)

    land_use_reward = torch.where(lu_done, lu_reward_val, nxt.land_use_reward)
    reward = torch.where(lu_done, lu_reward_val, 0.0)
    reward = torch.where(rd_done, road_reward_val, reward)

    done = (lu_done & spec.skip_road) | rd_done | fail
    reward = torch.where(fail, FAILURE_REWARD, reward)

    nxt = canonical(nxt.replace(done=done, failure=fail,
                                land_use_reward=land_use_reward))
    info = {'land_use_reward': land_use_reward,
            'failure': fail, 'failure_code': fail_bits.to(torch.int32),
            'lu_done': lu_done, 'rd_done': rd_done}
    return nxt, reward, done, info
