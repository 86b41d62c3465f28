"""Land-parcel slicing decision tree (counterpart of
urban_tpu/jaxenv/slicer.py, itself the branch-complete masked mirror of the
host oracle urban_tpu/geometry/slicer.py).

Every branch of the tree is evaluated as fixed-shape compute and selected
with ``torch.where`` along the host's exact decision conditions; the
symmetric two-lane subtrees run under ``torch.func.vmap`` as the JAX code
runs them under ``jax.vmap``. Functions take one environment's ring; the
environment batch is an outer ``vmap`` (torchenv/rollout.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from urban_tpu_torch.torchenv import geometry as jg

EPS = 1e-4          # PlanClient.EPSILON
DEG_TOL = 1.0       # PlanClient.DEG_TOL
THRES_DEG_U = 150.0
THRES_DEG_RT = 60.0
MAX_SCALE = 3
MRR_REL_TOL = 1e-5  # keep in sync with geometry/ops.py MRR_REL_TOL


class LuParams(NamedTuple):
    """Per-land-use scalar constraints (meters) + cell size."""
    cell: torch.Tensor
    min_edge: torch.Tensor
    max_edge: torch.Tensor
    search_max_length: torch.Tensor   # max_edge + common_min_edge_length
    search_max_area: torch.Tensor     # required_max_area
    search_min_area: torch.Tensor     # required_min_area
    common_min_edge: torch.Tensor


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def abs_angle_deg(v1, v2):
    """|signed angle| between two vectors in degrees (host get_angles_deg)."""
    dot = jg.fma(v1[0], v2[0], v1[1] * v2[1])
    det = jg.cross(v1[0], v1[1], v2[0], v2[1])
    return torch.rad2deg(jg.atan2(torch.abs(det), dot))


def is_hv(a, b):
    """Axis-aligned within EPS (host check_horizontal_vertical)."""
    d = torch.abs(b - a)
    return torch.minimum(d[0], d[1]) < EPS


def envelope_of(pts):
    """(N, 2) stacked points -> CCW axis-aligned rect (4, 2)."""
    lo = pts.amin(0)
    hi = pts.amax(0)
    return torch.stack([lo, torch.stack([hi[0], lo[1]]), hi,
                        torch.stack([lo[0], hi[1]])])


def mrr_of(pts):
    """Minimum rotated rectangle of a small point set, (4, 2) CCW, with the
    host's canonical-angle tie-break among equal-area orientations."""
    n = pts.shape[0]
    hull, nh = jg.convex_hull_masked(
        pts, torch.ones(n, dtype=torch.bool, device=pts.device))
    mh = jg.ring_mask(nh, n)
    d = jg.ring_next(hull, nh) - hull
    nd = jg.norm(d)
    ok = mh & (nd > 1e-9)
    u = d / torch.clamp_min(nd, 1e-9)[:, None]
    v = torch.stack([-u[:, 1], u[:, 0]], dim=-1)
    px = jg.dot2(hull[:, None, :], u[None, :, :])            # (N, M)
    py = jg.dot2(hull[:, None, :], v[None, :, :])
    px = torch.where(mh[:, None], px, px[0][None, :])
    py = torch.where(mh[:, None], py, py[0][None, :])
    w = px.amax(0) - px.amin(0)
    h = py.amax(0) - py.amin(0)
    area = torch.where(ok, w * h, jg.BIG)
    amin = area.amin()
    flip = (u[:, 1] < 0) | ((u[:, 1] == 0) & (u[:, 0] < 0))
    uc = torch.where(flip[:, None], -u, u)
    theta = jg.atan2(uc[:, 1], uc[:, 0])
    tied = ok & (area <= amin * (1.0 + MRR_REL_TOL))
    k = torch.argmin(torch.where(tied, theta, jg.BIG))
    any_ok = ok.any()
    uk = torch.where(any_ok, u[k],
                     jg.const((1.0, 0.0), torch.float32, pts.device))
    vk = torch.stack([-uk[1], uk[0]])
    pu = torch.where(mh, jg.dot2(hull, uk[None, :]), jg.BIG)
    pv = torch.where(mh, jg.dot2(hull, vk[None, :]), jg.BIG)
    x0, x1 = pu.amin(), torch.where(mh, pu, -jg.BIG).amax()
    y0, y1 = pv.amin(), torch.where(mh, pv, -jg.BIG).amax()
    return torch.stack([jg.fma(uk, x0, vk * y0), jg.fma(uk, x1, vk * y0),
                        jg.fma(uk, x1, vk * y1), jg.fma(uk, x0, vk * y1)])


def interval_concave(ring, nv, p_c, p_1, p_2):
    """True when the interior angle p_1—p_c—p_2 is concave (host
    check_interval_angle), as an exact interior-cone sector test at the ring
    vertex p_c (the host's 1e-4 inward probe is below the f32 ULP here)."""
    p_t = 0.5 * (p_1 + p_2)
    d = p_t - p_c
    degen = jg.norm(d) < 1e-9
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    vd = torch.where(m, jg.norm(ring - p_c), jg.BIG)
    vi = torch.argmin(vd)
    found = vd[vi] <= EPS
    nxt_idx = jg.ring_roll_indices(nv, kv)
    ar = jg.arange(kv, ring)
    prv_idx = torch.where(ar == 0, torch.clamp_min(nv - 1, 0), ar - 1)
    rv = ring[vi]
    eo = jg.take(ring, nxt_idx[vi]) - rv      # outgoing boundary ray
    av = jg.take(ring, prv_idx[vi]) - rv      # ray back to the previous vertex
    c1 = jg.cross(eo[0], eo[1], d[0], d[1])
    c2 = jg.cross(d[0], d[1], av[0], av[1])
    cs = jg.cross(eo[0], eo[1], av[0], av[1])
    inside = torch.where(cs >= 0, (c1 > 0) & (c2 > 0), (c1 > 0) | (c2 > 0))
    inside = inside & found
    angle = abs_angle_deg(p_1 - p_c, p_2 - p_c)
    return degen | ~inside | (angle > THRES_DEG_U - EPS)


def slice_edge_end(X, E, pts, pt_alive, lp: LuParams, min_m, max_m, search_m):
    """Prefix endpoint of edge X->E per host slice_edge. Returns (P, whole)."""
    L = jg.norm(E - X)
    whole = L * lp.cell <= search_m
    d_seg = jg.point_segment_distance(pts, X[None], E[None])
    on_edge = pt_alive & (d_seg < EPS)
    d_x = jg.norm(pts - X)
    feas = on_edge & (d_x * lp.cell >= min_m) & (d_x * lp.cell <= max_m)
    any_feas = feas.any()
    far = torch.argmax(torch.where(feas, d_x, -1.0))
    P_cand = pts[far]
    P_sub = jg.fma((E - X) / torch.clamp_min(L, 1e-9),
                   torch.minimum(max_m / lp.cell, L), X)
    P = torch.where(whole, E, torch.where(any_feas, P_cand, P_sub))
    return P, whole


def rectify(edge_len_grid, lp: LuParams):
    """Host rectify_slice_edge_length: (search, min, max) in meters."""
    el = torch.clamp_min(edge_len_grid * lp.cell, 1e-9)
    rmin = torch.maximum(lp.min_edge, lp.search_min_area / el)
    rmax = torch.maximum(rmin, torch.minimum(lp.max_edge,
                                             lp.search_max_area / el))
    rs = rmax + lp.common_min_edge
    return rs, rmin, rmax


def other_endpoint_at(ring, nv, p_c, exclude):
    """Far endpoint of the boundary edge at ring vertex p_c that does NOT
    contain `exclude`; ALL ring edges are scanned, as the host does.
    Returns (point, ok); ok=False mirrors the host SliceError."""
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    vd = torch.where(m, jg.norm(ring - p_c), jg.BIG)
    vi = torch.argmin(vd)
    found = vd[vi] <= EPS
    nxt_idx = jg.ring_roll_indices(nv, kv)
    a = ring
    b = ring[nxt_idx]
    d_pc = jg.point_segment_distance(p_c, a, b)
    d_ex = jg.point_segment_distance(exclude, a, b)
    cand = m & (d_pc <= EPS * 10 + 1e-9) & (d_ex >= EPS)
    count = cand.sum()
    ei = torch.argmax(cand.to(torch.uint8))
    pa, pb = a[ei], b[ei]
    far = torch.where(jg.norm(pa - p_c) >= jg.norm(pb - p_c), pa, pb)
    return far, found & (count == 1)


# ---------------------------------------------------------------------------
# leaf cut constructors
# ---------------------------------------------------------------------------

def _scale_reflect(p, p_c, seg_a, seg_b, target, thres_dis, bounded):
    """Host reflection loop: scale p away from p_c (up to 3 doublings) until
    the foot of p on segment (seg_a, seg_b) reaches `target`."""
    ab = seg_b - seg_a
    denom = torch.clamp_min(jg.dot2(ab, ab), 1e-12)
    cur = p
    for _ in range(MAX_SCALE):
        t = torch.clamp(jg.dot2(cur - seg_a, ab) / denom, 0.0, 1.0)
        foot = jg.fma(t, ab, seg_a)
        dist = jg.norm(foot - target)
        go = EPS < dist
        if bounded:
            go = go & (dist < thres_dis)
        cur = torch.where(go, cur + (cur - p_c), cur)
    return cur


def u_shape_cut(p_c_1, p_c_2, p_1, p_2, lp: LuParams):
    """Host slice_from_u_shape for edges edge_c=(p_c_1,p_c_2),
    edge_1=(p_c_1,p_1), edge_2=(p_c_2,p_2)."""
    c_hv = is_hv(p_c_1, p_c_2)
    e1_hv = is_hv(p_c_1, p_1)
    e2_hv = is_hv(p_c_2, p_2)
    pts6 = torch.stack([p_c_1, p_c_2, p_c_1, p_1, p_c_2, p_2])
    env6 = envelope_of(pts6)
    mrr6 = mrr_of(pts6)

    ang_1 = abs_angle_deg(p_2 - p_c_2, p_c_1 - p_c_2)   # e1_hv case
    p2s = _scale_reflect(p_2, p_c_2, p_c_1, p_1, p_1, 0.0, bounded=False)
    env_ref1 = envelope_of(torch.stack([p_c_1, p_c_2, p_c_1, p_1, p_c_2, p2s]))
    cut_ref1 = torch.where(ang_1 > THRES_DEG_U, env6, env_ref1)

    ang_2 = abs_angle_deg(p_1 - p_c_1, p_c_2 - p_c_1)   # e2_hv case
    p1s = _scale_reflect(p_1, p_c_1, p_c_2, p_2, p_2, 0.0, bounded=False)
    env_ref2 = envelope_of(torch.stack([p_c_1, p_c_2, p_c_2, p_2, p_c_1, p1s]))
    cut_ref2 = torch.where(ang_2 > THRES_DEG_U, env6, env_ref2)

    refine = c_hv & (e1_hv != e2_hv)
    cut_ref = torch.where(e1_hv, cut_ref1, cut_ref2)
    none_hv = ~c_hv & ~e1_hv & ~e2_hv
    return torch.where(none_hv, mrr6, torch.where(refine, cut_ref, env6))


def angle_cut(p_c, p_1, p_2):
    """Host slice_from_angle for edges (p_c,p_1), (p_c,p_2)."""
    hv = is_hv(p_c, p_1) | is_hv(p_c, p_2)
    env = envelope_of(torch.stack([p_c, p_1, p_2]))
    p_t = p_2 + p_1 - p_c
    mrr = mrr_of(torch.stack([p_c, p_1, p_t, p_2]))
    return torch.where(hv, env, mrr)


def rect_tri_cut(p_c, p_1, p_2, thres_dis, lp: LuParams):
    """Host slice_from_angle_rect_tri; thres_dis in grid units."""
    e1_hv = is_hv(p_c, p_1)
    e2_hv = is_hv(p_c, p_2)
    env = envelope_of(torch.stack([p_c, p_1, p_2]))
    ang = abs_angle_deg(p_1 - p_c, p_2 - p_c)
    p2s = _scale_reflect(p_2, p_c, p_c, p_1, p_1, thres_dis, bounded=True)
    p1s = _scale_reflect(p_1, p_c, p_c, p_2, p_2, thres_dis, bounded=True)
    env_s1 = envelope_of(torch.stack([p_c, p_1, p2s]))
    env_s2 = envelope_of(torch.stack([p_c, p1s, p_2]))
    one_hv = torch.where(ang > THRES_DEG_RT, env,
                         torch.where(e1_hv, env_s1, env_s2))
    p_t = p_2 + p_1 - p_c
    mrr = mrr_of(torch.stack([p_c, p_1, p_t, p_2]))
    return torch.where(e1_hv & e2_hv, env,
                       torch.where(e1_hv != e2_hv, one_hv, mrr))


def _count_outside_arcs(ring, nv, quad):
    """Number of pieces `ring difference quad` splits into, by counting
    boundary entries into the convex quad (Liang-Barsky per ring segment)."""
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    a = ring
    b = jg.ring_next(ring, nv)
    qa = quad
    qd = torch.roll(quad, -1, 0) - qa
    nrm = torch.stack([-qd[:, 1], qd[:, 0]], dim=-1)        # inward (CCW)
    nrm = nrm / torch.clamp_min(jg.norm(nrm, keepdim=True), 1e-12)
    s_a = jg.dot2(a[:, None, :] - qa[None], nrm[None])       # (KV, 4)
    s_b = jg.dot2(b[:, None, :] - qa[None], nrm[None])
    TOL = 1e-3
    ds = s_b - s_a
    safe = torch.where(torch.abs(ds) > 1e-9, ds, 1e-9)
    t_cross = -s_a / safe
    lo_p = torch.where(ds > 1e-9, t_cross, -jg.BIG)
    hi_p = torch.where(ds < -1e-9, t_cross, jg.BIG)
    parallel_out = (torch.abs(ds) <= 1e-9) & (s_a < -TOL)
    lo_p = torch.where(parallel_out, jg.BIG, lo_p)
    t0 = torch.clamp_min(lo_p.amax(dim=1), 0.0)
    t1 = torch.clamp_max(hi_p.amin(dim=1), 1.0)
    nonempty = t0 <= t1 + 1e-9
    start_outside = s_a.amin(dim=1) < -TOL
    entries = (m & nonempty & start_outside).sum()
    all_inside = (~m | (s_a.amin(dim=1) >= -TOL)).all()
    return torch.where(entries >= 1, entries,
                       torch.where(all_inside, 0, 1))


def part_edge_cut(ring, nv, a, b, max_buffer_m, thres_dis_m, lp: LuParams):
    """Host slice_from_part_edge: deep rectangle when the deep probe splits
    the remainder into >= 2 pieces, else shallow."""
    mid = 0.5 * (a + b)
    d = b - a
    segs, segm = jg.ring_segments(ring, nv)
    ds = torch.where(segm, jg.point_segment_distance(mid, segs[:, 0],
                                                     segs[:, 1]), jg.BIG)
    si = torch.argmin(ds)
    tdir = segs[si, 1] - segs[si, 0]
    hp = jg.dot2(d, tdir)
    sign = torch.where(hp >= 0, 1.0, -1.0)
    deep = jg.oriented_rect(a, b, sign * (max_buffer_m + thres_dis_m)
                            / lp.cell)
    shallow = jg.oriented_rect(a, b, sign * max_buffer_m / lp.cell)
    n_pieces = _count_outside_arcs(ring, nv, deep)
    return torch.where(n_pieces >= 2, deep, shallow)


# ---------------------------------------------------------------------------
# tree nodes
# ---------------------------------------------------------------------------

def l_shape_cut(ring, nv, p_c, p_1, p_2, e2_a, e2_b, pts, pt_alive,
                lp: LuParams):
    """Host slice_from_l_shape: edge_1=(p_c,p_1) is a whole boundary edge,
    edge_2=(e2_a,e2_b) with far point p_2. Returns (quad, fail)."""
    p_3, ok3 = other_endpoint_at(ring, nv, p_1, p_c)
    concave = interval_concave(ring, nv, p_1, p_c, p_3)

    cut_a = angle_cut(p_c, p_1, p_2)
    four = jg.const(4, torch.int64, ring.device)
    area_m = jg.ring_area(cut_a, four) * lp.cell ** 2
    ang = abs_angle_deg(p_1 - p_c, p_2 - p_c)
    thres = lp.search_max_length - lp.max_edge
    cut_pe = part_edge_cut(ring, nv, e2_a, e2_b, lp.max_edge, thres, lp)
    use_pe = (area_m < lp.search_min_area) & (torch.abs(ang - 90.0) < EPS)
    cut_concave = torch.where(use_pe, cut_pe, cut_a)

    rs, rmin, rmax = rectify(jg.norm(p_1 - p_c), lp)
    P3, _ = slice_edge_end(p_1, p_3, pts, pt_alive, lp, rmin, rmax, rs)
    cut_convex = u_shape_cut(p_c, p_1, p_2, P3, lp)
    # the host raises from get_the_other_edge before the concave check
    return torch.where(concave, cut_concave, cut_convex), ~ok3


def half_edge_cut(ring, nv, he_a, he_b, p_c, p_1, pts, pt_alive,
                  lp: LuParams):
    """Host slice_from_half_edge: half_edge=(he_a,he_b), corner p_c,
    intersection p_1. Returns (quad, fail)."""
    p_2, ok2 = other_endpoint_at(ring, nv, p_c, p_1)
    concave = interval_concave(ring, nv, p_c, p_1, p_2)

    el_m = torch.clamp_min(jg.norm(he_b - he_a), 1e-9) * lp.cell
    max_buf = torch.maximum(lp.max_edge, lp.search_max_area / el_m)
    thres = lp.search_max_length - lp.max_edge
    cut_cc = part_edge_cut(ring, nv, he_a, he_b, max_buf, thres, lp)

    rs, rmin, rmax = rectify(jg.norm(he_b - he_a), lp)
    P2, whole2 = slice_edge_end(p_c, p_2, pts, pt_alive, lp, rmin, rmax, rs)
    thres_grid = lp.common_min_edge / lp.cell
    cut_rt = rect_tri_cut(p_c, p_1, P2, thres_grid, lp)
    cut_l, fl = l_shape_cut(ring, nv, p_c, p_2, p_1, he_a, he_b, pts,
                            pt_alive, lp)
    cut_cv = torch.where(whole2, cut_l, cut_rt)
    fail_cv = whole2 & fl
    return (torch.where(concave, cut_cc, cut_cv),
            ~ok2 | (~concave & fail_cv))


def half_or_part_cut(ring, nv, X, E, pts, pt_alive, lp: LuParams):
    """Host slice_polygon_from_half_or_part_edge for edge (X, E) with
    intersection X and corner E. Returns (quad, fail)."""
    P, whole = slice_edge_end(X, E, pts, pt_alive, lp, lp.min_edge,
                              lp.max_edge, lp.search_max_length)
    el_m = torch.clamp_min(jg.norm(P - X), 1e-9) * lp.cell
    max_buf = torch.maximum(lp.max_edge, lp.search_max_area / el_m)
    thres = lp.search_max_length - lp.max_edge
    cut_pe = part_edge_cut(ring, nv, X, P, max_buf, thres, lp)
    cut_he, fhe = half_edge_cut(ring, nv, X, E, E, X, pts, pt_alive, lp)
    return torch.where(whole, cut_he, cut_pe), whole & fhe


def whole_edge_cut(ring, nv, pc1, pc2, pts, pt_alive, lp: LuParams):
    """Host slice_from_whole_edge for boundary edge (pc1, pc2); the two
    endpoint-symmetric subtrees run as one 2-lane vmap. Returns
    (quad, fail)."""
    PC = torch.stack([pc1, pc2])
    PCo = torch.stack([pc2, pc1])
    P12, OK12 = vmap(other_endpoint_at, in_dims=(None, None, 0, 0))(
        ring, nv, PC, PCo)
    ok1, ok2 = OK12[0], OK12[1]
    CC = vmap(interval_concave, in_dims=(None, None, 0, 0, 0))(
        ring, nv, PC, P12, PCo)
    cc1, cc2 = CC[0], CC[1]

    el = jg.norm(pc2 - pc1)
    el_m = torch.clamp_min(el, 1e-9) * lp.cell
    max_buf = torch.maximum(lp.max_edge, lp.search_max_area / el_m)
    thres = lp.search_max_length - lp.max_edge
    cut_pp = part_edge_cut(ring, nv, pc1, pc2, max_buf, thres, lp)

    rs, rmin, rmax = rectify(el, lp)
    S12, W12 = vmap(slice_edge_end,
                    in_dims=(0, 0, None, None, None, None, None, None))(
        PC, P12, pts, pt_alive, lp, rmin, rmax, rs)
    w1, w2 = W12[0], W12[1]
    cut_uu = u_shape_cut(pc1, pc2, S12[0], S12[1], lp)

    CA = vmap(angle_cut)(PC, PCo, S12)
    CL, FL = vmap(l_shape_cut,
                  in_dims=(None, None, 0, 0, 0, 0, 0, None, None, None))(
        ring, nv, PC, P12, PCo, PC, PCo, pts, pt_alive, lp)
    cut_cv1 = torch.where(w1, CL[0], CA[0])
    fail_cv1 = w1 & FL[0]
    cut_cv2 = torch.where(w2, CL[1], CA[1])
    fail_cv2 = w2 & FL[1]

    cut = torch.where(cc1 & cc2, cut_pp,
                      torch.where(~cc1 & ~cc2, cut_uu,
                                  torch.where(~cc1, cut_cv1, cut_cv2)))
    # the host resolves both other-edges up front: ok1/ok2 gate every branch
    mixed = ~(cc1 & cc2) & ~(~cc1 & ~cc2)
    fail = ~ok1 | ~ok2 | (mixed & torch.where(~cc1, fail_cv1, fail_cv2))
    return cut, fail


def corner_convex_cut(ring, nv, X, p_1, p_2, pts, pt_alive, lp: LuParams):
    """Convex-corner branch of host slice_polygon_from_corner (rect-tri /
    the two L-shapes), with the symmetric lanes vmapped. Returns
    (quad, fail)."""
    P = torch.stack([p_1, p_2])
    S12, W12 = vmap(slice_edge_end,
                    in_dims=(None, 0, None, None, None, None, None, None))(
        X, P, pts, pt_alive, lp, lp.min_edge, lp.max_edge,
        lp.search_max_length)
    s1, s2 = S12[0], S12[1]
    w1, w2 = W12[0], W12[1]
    thres_grid = lp.common_min_edge / lp.cell
    cut_rt = rect_tri_cut(X, s1, s2, thres_grid, lp)
    Sswap = torch.stack([s2, s1])
    CL, FL = vmap(l_shape_cut,
                  in_dims=(None, None, None, 0, 0, None, 0, None, None, None))(
        ring, nv, X, P, Sswap, X, Sswap, pts, pt_alive, lp)
    cut_cv = torch.where(~w1 & ~w2, cut_rt, torch.where(w1, CL[0], CL[1]))
    fail_cv = ~(~w1 & ~w2) & torch.where(w1, FL[0], FL[1])
    return cut_cv, fail_cv


# ---------------------------------------------------------------------------
# ring simplification + entry
# ---------------------------------------------------------------------------

def simplify_by_angle(ring, nv, deg_tol: float = DEG_TOL):
    """Drop vertices whose turn angle is below deg_tol (returns the
    original ring when fewer than 3 vertices survive)."""
    kv = ring.shape[0]
    m = jg.ring_mask(nv, kv)
    nxt = jg.ring_next(ring, nv)
    prv = jg.ring_prev(ring, nv)
    v_in = ring - prv
    v_out = nxt - ring
    dot = jg.dot2(v_in, v_out)
    det = jg.cross(v_in[:, 0], v_in[:, 1], v_out[:, 0], v_out[:, 1])
    ang = torch.rad2deg(jg.atan2(torch.abs(det), dot))
    keep = m & (ang > deg_tol)
    n_keep = keep.sum()
    keep = torch.where(n_keep >= 3, keep, m)
    counts = keep.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    out = jg.onehot_place(ring, offsets, keep, kv)
    return out, torch.where(n_keep >= 3, n_keep, nv)


def compute_cutter(ring, nv, X, pts, pt_alive, lp: LuParams):
    """Slice-cut construction for one block + chosen intersection, through
    the host's canonical frame, angle simplification and the full decision
    tree. Returns (simplified_ring, simplified_nv, quad, fail)."""
    ring, nv = jg.canonicalize_ring(ring, nv)
    S, snv = simplify_by_angle(ring, nv)
    kv = S.shape[0]
    m = jg.ring_mask(snv, kv)
    vdist = torch.where(m, jg.norm(S - X), jg.BIG)
    vi = torch.argmin(vdist)
    is_corner = vdist[vi] <= EPS

    nxt_idx = jg.ring_roll_indices(snv, kv)
    ar = jg.arange(kv, S)
    prv_idx = torch.where(ar == 0, torch.clamp_min(snv - 1, 0), ar - 1)

    # corner: (p_1, p_2) = (next, prev) when the corner is vertex 0, else
    # (prev, next) — the host's touching-edge order
    at0 = vi == 0
    s_nxt = jg.take(S, nxt_idx[vi])
    s_prv = jg.take(S, prv_idx[vi])
    p_1c = torch.where(at0, s_nxt, s_prv)
    p_2c = torch.where(at0, s_prv, s_nxt)
    concave0 = interval_concave(S, snv, X, p_1c, p_2c)
    cut_cv, fail_cv = corner_convex_cut(S, snv, X, p_1c, p_2c, pts,
                                        pt_alive, lp)
    use1 = jg.norm(p_1c - X) >= jg.norm(p_2c - X)
    E_cc = torch.where(use1, p_1c, p_2c)

    # mid-edge: nearest boundary edge, host near-two-edges failure
    segs, segmask = jg.ring_segments(S, snv)
    edist = torch.where(segmask,
                        jg.point_segment_distance(X, segs[:, 0], segs[:, 1]),
                        jg.BIG)
    dmin = edist.amin()
    near = edist < dmin + EPS
    fail_two = near.sum() > 1
    ei = torch.argmax(near.to(torch.uint8))
    A = S[ei]
    B = jg.take(S, nxt_idx[ei])
    short = jg.norm(B - A) * lp.cell <= lp.search_max_length
    cut_we, fwe = whole_edge_cut(S, snv, A, B, pts, pt_alive, lp)
    use_A = jg.norm(A - X) >= jg.norm(B - X)
    E_we = torch.where(use_A, A, B)

    # the concave-corner and long-edge subtrees: one 2-lane vmap
    CH, FH = vmap(half_or_part_cut,
                  in_dims=(None, None, None, 0, None, None, None))(
        S, snv, X, torch.stack([E_cc, E_we]), pts, pt_alive, lp)

    cut_c = torch.where(concave0, CH[0], cut_cv)
    fail_c = torch.where(concave0, FH[0], fail_cv)
    cut_e = torch.where(short, cut_we, CH[1])
    fail_e = torch.where(short, fwe, FH[1])

    cut = torch.where(is_corner, cut_c, cut_e)
    fail = torch.where(is_corner, fail_c, fail_e | fail_two)
    return S, snv, cut, fail
