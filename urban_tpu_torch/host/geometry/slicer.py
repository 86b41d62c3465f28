"""Land-parcel slicing engine (host exact version).

Re-implements the reference's slicing decision tree — the "physics" of the
land_use stage — on this framework's geometry kernel. Given a feasible block
polygon and a chosen road intersection on its boundary, carve out a new parcel
whose edge lengths/areas respect the land-use constraints.

Structure mirrors the reference decision tree (khrylib/utils/shapely.py:9-785,
cited per function), but operates on raw numpy rings/segments instead of GEOS
objects. Every cutter the tree produces is convex (axis envelope, minimum
rotated rectangle, or single-sided segment buffer), so the final
"intersect with the block, keep the largest piece" step is exact convex
clipping.

A jittable fixed-buffer version of the dominant paths lives in
urban_tpu.jaxenv; this module is its differential-testing oracle.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from urban_tpu_torch.host.geometry import ops
from urban_tpu_torch.host.geometry.base import Geometry, POLY

Edge = Tuple[np.ndarray, np.ndarray]


class SliceError(ValueError):
    """Raised when the geometry engine cannot produce a valid parcel.

    The environment converts these into FAILURE_REWARD episode terminations
    (reference: urban_planning/envs/city.py:450-457)."""


def _pt(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(2)


def _dist(a, b) -> float:
    return float(np.linalg.norm(_pt(a) - _pt(b)))


def _boundary_edges(ring: np.ndarray) -> List[Edge]:
    """Boundary edges of a ring (reference shapely.py:9-27)."""
    return [(ring[i], ring[(i + 1) % len(ring)]) for i in range(len(ring))]


def _edge_length(edge: Edge) -> float:
    return _dist(edge[0], edge[1])


def check_horizontal_vertical(edge: Edge, epsilon: float) -> bool:
    """True if the edge is axis-aligned within epsilon
    (reference shapely.py:98-107)."""
    a, b = edge
    return min(abs(b[0] - a[0]), abs(b[1] - a[1])) < epsilon


def check_interval_angle(ring: np.ndarray, p_c, p_1, p_2,
                         epsilon: float, deg_thres: float = 150.0) -> str:
    """Classify the interior angle p_1—p_c—p_2 as convex or concave
    (reference shapely.py:110-124): probe a tiny segment from p_c toward the
    chord midpoint; if it leaves the polygon, or the angle is wide, concave."""
    p_c, p_1, p_2 = _pt(p_c), _pt(p_1), _pt(p_2)
    p_t = 0.5 * (p_1 + p_2)
    d = p_t - p_c
    nd = np.linalg.norm(d)
    if nd < ops.EPS:
        return 'concave'
    probe = p_c + d / nd * min(epsilon, nd)
    if ops.point_in_ring(probe, ring, tol=ops.EPS) == 1:
        angle = abs(ops.get_angles_deg(p_1 - p_c, p_2 - p_c))
        if angle > deg_thres - epsilon:
            return 'concave'
        return 'convex'
    return 'concave'


def get_the_other_edge(boundary: Sequence[Edge], p_c, p_1, epsilon: float) -> Edge:
    """The boundary edge at p_c other than p_c—p_1
    (reference shapely.py:127-148)."""
    p_c, p_1 = _pt(p_c), _pt(p_1)
    found = []
    for a, b in boundary:
        if float(ops.point_segment_distance(p_c, a[None], b[None])[0]) <= ops.EPS * 10 + 1e-9:
            if float(ops.point_segment_distance(p_1, a[None], b[None])[0]) >= epsilon:
                found.append((a, b))
    if len(found) != 1:
        raise SliceError(
            f'The number of the other edge from {p_c} is {len(found)}, not 1.')
    return found[0]


def rectify_slice_edge_length(search_max_length: float, min_edge_length: float,
                              max_edge_length: float, search_max_area: float,
                              search_min_area: float, cell_edge_length: float,
                              edge: Edge) -> Tuple[float, float, float]:
    """Adjust edge-length targets so area constraints stay satisfiable
    (reference shapely.py:151-177)."""
    common_min_edge_length = search_max_length - max_edge_length
    el = _edge_length(edge) * cell_edge_length
    rectified_min = max(min_edge_length, search_min_area / max(el, ops.EPS))
    rectified_max = max(rectified_min, min(max_edge_length, search_max_area / max(el, ops.EPS)))
    rectified_search = rectified_max + common_min_edge_length
    return rectified_search, rectified_min, rectified_max


def slice_edge(edge: Edge, point, all_intersections: np.ndarray, epsilon: float,
               cell_edge_length: float, min_edge_length: float,
               max_edge_length: float, search_max_length: float
               ) -> Tuple[Edge, bool]:
    """Take a prefix of `edge` from `point`, preferring to end at an existing
    intersection (reference shapely.py:180-200)."""
    point = _pt(point)
    a, b = _pt(edge[0]), _pt(edge[1])
    if _edge_length(edge) * cell_edge_length <= search_max_length:
        return edge, True
    if len(all_intersections) > 0:
        on_edge = ops.point_segment_distance(all_intersections, a[None], b[None]) < epsilon
        candidates = all_intersections[on_edge]
    else:
        candidates = np.zeros((0, 2))
    if len(candidates) > 0:
        d = np.linalg.norm(candidates - point, axis=1)
        feas = (d * cell_edge_length >= min_edge_length) & \
               (d * cell_edge_length <= max_edge_length)
        feas_pts = candidates[feas]
        if len(feas_pts) > 0:
            far = feas_pts[np.argmax(np.linalg.norm(feas_pts - point, axis=1))]
            return (point, far), False
    end = ops.substring_point(a, b, max_edge_length / cell_edge_length)
    return (a, end), False


def _envelope_of(*geoms) -> np.ndarray:
    pts = np.vstack([np.atleast_2d(np.asarray(g, dtype=np.float64)) for g in geoms])
    return ops.envelope(pts)


def _mrr_of(*geoms) -> np.ndarray:
    pts = np.vstack([np.atleast_2d(np.asarray(g, dtype=np.float64)) for g in geoms])
    return ops.min_rotated_rect(pts)


def _other_endpoint(edge: Edge, p, epsilon: float = 1e-9) -> np.ndarray:
    """MultiPoint(edge.coords).difference(p) for a 2-point edge."""
    p = _pt(p)
    a, b = _pt(edge[0]), _pt(edge[1])
    return b if _dist(a, p) <= _dist(b, p) else a


def slice_from_u_shape(edge_c: Edge, edge_1: Edge, edge_2: Edge,
                       epsilon: float, thres_deg: float = 150.0) -> np.ndarray:
    """Cut spanning three U-shaped edges (reference shapely.py:203-257)."""
    c_hv = check_horizontal_vertical(edge_c, epsilon)
    e1_hv = check_horizontal_vertical(edge_1, epsilon)
    e2_hv = check_horizontal_vertical(edge_2, epsilon)
    pts_all = (edge_c[0], edge_c[1], edge_1[0], edge_1[1], edge_2[0], edge_2[1])
    if not c_hv and not e1_hv and not e2_hv:
        return _mrr_of(*pts_all)
    if (c_hv and e1_hv and not e2_hv) or (c_hv and not e1_hv and e2_hv):
        p_c_1 = _shared_point(edge_c, edge_1)
        p_c_2 = _shared_point(edge_c, edge_2)
        p_1 = _other_endpoint(edge_1, p_c_1)
        p_2 = _other_endpoint(edge_2, p_c_2)
        if e1_hv:
            angle = abs(ops.get_angles_deg(p_2 - p_c_2, p_c_1 - p_c_2))
            if angle > thres_deg:
                return _envelope_of(*pts_all)
            foot = ops.nearest_point_on_segment(p_2, edge_1[0], edge_1[1])
            scale_count = 0
            while epsilon < _dist(foot, p_1) and scale_count < 3:
                p_2 = p_2 + (p_2 - p_c_2)
                foot = ops.nearest_point_on_segment(p_2, edge_1[0], edge_1[1])
                scale_count += 1
            return _envelope_of(edge_c[0], edge_c[1], edge_1[0], edge_1[1], p_c_2, p_2)
        else:
            angle = abs(ops.get_angles_deg(p_1 - p_c_1, p_c_2 - p_c_1))
            if angle > thres_deg:
                return _envelope_of(*pts_all)
            foot = ops.nearest_point_on_segment(p_1, edge_2[0], edge_2[1])
            scale_count = 0
            while epsilon < _dist(foot, p_2) and scale_count < 3:
                p_1 = p_1 + (p_1 - p_c_1)
                foot = ops.nearest_point_on_segment(p_1, edge_2[0], edge_2[1])
                scale_count += 1
            return _envelope_of(edge_c[0], edge_c[1], edge_2[0], edge_2[1], p_c_1, p_1)
    return _envelope_of(*pts_all)


def _shared_point(e1: Edge, e2: Edge, tol: float = 1e-7) -> np.ndarray:
    """Common endpoint of two touching edges (edge_c.intersection(edge_i))."""
    for p in (e1[0], e1[1]):
        for q in (e2[0], e2[1]):
            if _dist(p, q) <= tol:
                return _pt(p)
    # fall back: endpoint of e2 lying on e1
    for q in (e2[0], e2[1]):
        if float(ops.point_segment_distance(_pt(q), _pt(e1[0])[None], _pt(e1[1])[None])[0]) <= tol:
            return _pt(q)
    raise SliceError('U-shape edges do not touch.')


def slice_from_angle(edge_1: Edge, edge_2: Edge, p_c, p_1, p_2,
                     epsilon: float) -> np.ndarray:
    """Cut from two edges meeting at a corner (reference shapely.py:260-286)."""
    p_c, p_1, p_2 = _pt(p_c), _pt(p_1), _pt(p_2)
    if check_horizontal_vertical(edge_1, epsilon) or \
            check_horizontal_vertical(edge_2, epsilon):
        return _envelope_of(p_c, p_1, p_2)
    p_t = p_2 + p_1 - p_c
    return _mrr_of(p_c, p_1, p_t, p_2)


def slice_from_angle_rect_tri(edge_1: Edge, edge_2: Edge, p_c, p_1, p_2,
                              epsilon: float, thres_dis: float,
                              thres_deg: float = 60.0) -> np.ndarray:
    """Corner cut that may shrink to a triangle-ish envelope
    (reference shapely.py:289-340)."""
    p_c, p_1, p_2 = _pt(p_c), _pt(p_1), _pt(p_2)
    e1_hv = check_horizontal_vertical(edge_1, epsilon)
    e2_hv = check_horizontal_vertical(edge_2, epsilon)
    if e1_hv and e2_hv:
        return _envelope_of(p_c, p_1, p_2)
    if e1_hv or e2_hv:
        angle = abs(ops.get_angles_deg(p_1 - p_c, p_2 - p_c))
        if angle > thres_deg:
            return _envelope_of(p_c, p_1, p_2)
        if e1_hv:
            foot = ops.nearest_point_on_segment(p_2, edge_1[0], edge_1[1])
            scale_count = 0
            while epsilon < _dist(foot, p_1) < thres_dis and scale_count < 3:
                p_2 = p_2 + (p_2 - p_c)
                foot = ops.nearest_point_on_segment(p_2, edge_1[0], edge_1[1])
                scale_count += 1
        else:
            foot = ops.nearest_point_on_segment(p_1, edge_2[0], edge_2[1])
            scale_count = 0
            while epsilon < _dist(foot, p_2) < thres_dis and scale_count < 3:
                p_1 = p_1 + (p_1 - p_c)
                foot = ops.nearest_point_on_segment(p_1, edge_2[0], edge_2[1])
                scale_count += 1
        return _envelope_of(p_c, p_1, p_2)
    p_t = p_2 + p_1 - p_c
    return _mrr_of(p_c, p_1, p_t, p_2)


def slice_from_part_edge(ring: np.ndarray, edge: Edge, epsilon: float,
                         cell_edge_length: float, max_edge_length: float,
                         thres_dis: float) -> np.ndarray:
    """Sweep a rectangle from an edge into the block interior
    (reference shapely.py:343-383)."""
    a, b = _pt(edge[0]), _pt(edge[1])
    temp_ring = ops.snap_geometry(Geometry(POLY, ring), np.vstack([a, b]),
                                  epsilon).coords
    left_probe = ops.single_sided_buffer(a, b, epsilon)
    right_probe = ops.single_sided_buffer(a, b, -epsilon)
    left_area = sum(ops.ring_area(p) for p in
                    ops.clip_polygon_convex(temp_ring, left_probe))
    right_area = sum(ops.ring_area(p) for p in
                     ops.clip_polygon_convex(temp_ring, right_probe))
    if left_area > right_area:
        sign = 1.0
    elif left_area < right_area:
        sign = -1.0
    else:
        raise SliceError('Left and right side both not within polygon.')
    probe = ops.single_sided_buffer(
        a, b, sign * (max_edge_length + thres_dis) / cell_edge_length)
    remaining = ops.difference_convex(temp_ring, probe)
    if len(remaining) <= 1:
        return ops.single_sided_buffer(a, b, sign * max_edge_length / cell_edge_length)
    return probe


def slice_from_l_shape(ring: np.ndarray, boundary: Sequence[Edge],
                       edge_1: Edge, edge_2: Edge, p_c, p_1, p_2,
                       all_intersections: np.ndarray, epsilon: float,
                       cell_edge_length: float, min_edge_length: float,
                       max_edge_length: float, search_max_length: float,
                       search_max_area: float, search_min_area: float) -> np.ndarray:
    """Cut from an L of two edges (reference shapely.py:386-443)."""
    p_c, p_1, p_2 = _pt(p_c), _pt(p_1), _pt(p_2)
    edge_3 = get_the_other_edge(boundary, p_1, p_c, epsilon)
    p_3 = _other_endpoint(edge_3, p_1)
    if check_interval_angle(ring, p_1, p_c, p_3, epsilon) == 'concave':
        cut = slice_from_angle(edge_1, edge_2, p_c, p_1, p_2, epsilon)
        area = ops.ring_area(cut) * cell_edge_length ** 2
        angle = abs(ops.get_angles_deg(p_1 - p_c, p_2 - p_c))
        if area < search_min_area and abs(angle - 90.0) < epsilon:
            thres_dis = search_max_length - max_edge_length
            cut = slice_from_part_edge(ring, edge_2, epsilon, cell_edge_length,
                                       max_edge_length, thres_dis)
        return cut
    rs, rmin, rmax = rectify_slice_edge_length(
        search_max_length, min_edge_length, max_edge_length,
        search_max_area, search_min_area, cell_edge_length, edge_1)
    slice_edge_3, _ = slice_edge((p_1, p_3), p_1, all_intersections, epsilon,
                                 cell_edge_length, rmin, rmax, rs)
    return slice_from_u_shape(edge_1, edge_2, slice_edge_3, epsilon)


def slice_from_half_edge(ring: np.ndarray, boundary: Sequence[Edge],
                         half_edge: Edge, p_c, p_1,
                         all_intersections: np.ndarray, epsilon: float,
                         cell_edge_length: float, min_edge_length: float,
                         max_edge_length: float, search_max_length: float,
                         search_max_area: float, search_min_area: float) -> np.ndarray:
    """Cut when the chosen edge is one whole boundary edge from a corner
    (reference shapely.py:446-503)."""
    p_c, p_1 = _pt(p_c), _pt(p_1)
    edge_2 = get_the_other_edge(boundary, p_c, p_1, epsilon)
    p_2 = _other_endpoint(edge_2, p_c)
    if check_interval_angle(ring, p_c, p_1, p_2, epsilon) == 'concave':
        el = _edge_length(half_edge) * cell_edge_length
        max_buffer = max(max_edge_length, search_max_area / max(el, ops.EPS))
        thres_dis = search_max_length - max_edge_length
        return slice_from_part_edge(ring, half_edge, epsilon, cell_edge_length,
                                    max_buffer, thres_dis)
    rs, rmin, rmax = rectify_slice_edge_length(
        search_max_length, min_edge_length, max_edge_length,
        search_max_area, search_min_area, cell_edge_length, half_edge)
    slice_edge_2, whole = slice_edge((p_c, p_2), p_c, all_intersections, epsilon,
                                     cell_edge_length, rmin, rmax, rs)
    if not whole:
        common_min = search_max_length - max_edge_length
        thres_distance = common_min / cell_edge_length
        return slice_from_angle_rect_tri(
            half_edge, slice_edge_2, p_c, p_1, _pt(slice_edge_2[1]),
            epsilon, thres_distance)
    return slice_from_l_shape(ring, boundary, slice_edge_2, half_edge,
                              p_c, p_2, p_1, all_intersections, epsilon,
                              cell_edge_length, min_edge_length, max_edge_length,
                              search_max_length, search_max_area, search_min_area)


def slice_polygon_from_half_or_part_edge(
        ring: np.ndarray, boundary: Sequence[Edge], edge: Edge, intersection,
        corner, all_intersections: np.ndarray, epsilon: float,
        cell_edge_length: float, min_edge_length: float, max_edge_length: float,
        search_max_length: float, search_max_area: float,
        search_min_area: float) -> np.ndarray:
    """Reference shapely.py:506-550."""
    sliced, whole = slice_edge(edge, intersection, all_intersections, epsilon,
                               cell_edge_length, min_edge_length,
                               max_edge_length, search_max_length)
    if whole:
        return slice_from_half_edge(ring, boundary, sliced, corner,
                                    intersection, all_intersections, epsilon,
                                    cell_edge_length, min_edge_length,
                                    max_edge_length, search_max_length,
                                    search_max_area, search_min_area)
    el = _edge_length(sliced) * cell_edge_length
    max_buffer = max(max_edge_length, search_max_area / max(el, ops.EPS))
    thres_dis = search_max_length - max_edge_length
    return slice_from_part_edge(ring, sliced, epsilon, cell_edge_length,
                                max_buffer, thres_dis)


def slice_from_whole_edge(ring: np.ndarray, boundary: Sequence[Edge], edge: Edge,
                          all_intersections: np.ndarray, epsilon: float,
                          cell_edge_length: float, min_edge_length: float,
                          max_edge_length: float, search_max_length: float,
                          search_max_area: float, search_min_area: float
                          ) -> np.ndarray:
    """Cut from one entire boundary edge (reference shapely.py:553-630)."""
    p_c_1 = _pt(edge[0])
    p_c_2 = _pt(edge[1])
    edge_1 = get_the_other_edge(boundary, p_c_1, p_c_2, epsilon)
    p_1 = _other_endpoint(edge_1, p_c_1)
    edge_2 = get_the_other_edge(boundary, p_c_2, p_c_1, epsilon)
    p_2 = _other_endpoint(edge_2, p_c_2)
    angle_1 = check_interval_angle(ring, p_c_1, p_1, p_c_2, epsilon)
    angle_2 = check_interval_angle(ring, p_c_2, p_2, p_c_1, epsilon)
    if angle_1 == 'concave' and angle_2 == 'concave':
        el = _edge_length(edge) * cell_edge_length
        max_buffer = max(max_edge_length, search_max_area / max(el, ops.EPS))
        thres_dis = search_max_length - max_edge_length
        return slice_from_part_edge(ring, edge, epsilon, cell_edge_length,
                                    max_buffer, thres_dis)
    rs, rmin, rmax = rectify_slice_edge_length(
        search_max_length, min_edge_length, max_edge_length,
        search_max_area, search_min_area, cell_edge_length, edge)
    if angle_1 == 'convex' and angle_2 == 'convex':
        s1, _ = slice_edge((p_c_1, p_1), p_c_1, all_intersections, epsilon,
                           cell_edge_length, rmin, rmax, rs)
        s2, _ = slice_edge((p_c_2, p_2), p_c_2, all_intersections, epsilon,
                           cell_edge_length, rmin, rmax, rs)
        return slice_from_u_shape(edge, s1, s2, epsilon)
    if angle_1 == 'convex':
        s1, whole = slice_edge((p_c_1, p_1), p_c_1, all_intersections, epsilon,
                               cell_edge_length, rmin, rmax, rs)
        if not whole:
            return slice_from_angle((p_c_1, p_c_2), s1, p_c_1, p_c_2,
                                    _pt(s1[1]), epsilon)
        return slice_from_l_shape(ring, boundary, s1, (p_c_1, p_c_2), p_c_1,
                                  p_1, p_c_2, all_intersections, epsilon,
                                  cell_edge_length, min_edge_length,
                                  max_edge_length, search_max_length,
                                  search_max_area, search_min_area)
    s2, whole = slice_edge((p_c_2, p_2), p_c_2, all_intersections, epsilon,
                           cell_edge_length, rmin, rmax, rs)
    if not whole:
        return slice_from_angle((p_c_2, p_c_1), s2, p_c_2, p_c_1,
                                _pt(s2[1]), epsilon)
    return slice_from_l_shape(ring, boundary, s2, (p_c_2, p_c_1), p_c_2,
                              p_2, p_c_1, all_intersections, epsilon,
                              cell_edge_length, min_edge_length,
                              max_edge_length, search_max_length,
                              search_max_area, search_min_area)


def slice_polygon_from_edge(ring: np.ndarray, boundary: Sequence[Edge],
                            edge: Edge, intersection,
                            all_intersections: np.ndarray, distance: float,
                            epsilon: float, cell_edge_length: float,
                            min_edge_length: float, max_edge_length: float,
                            search_max_length: float, search_max_area: float,
                            search_min_area: float) -> np.ndarray:
    """Entry: intersection lies in the middle of a boundary edge
    (reference shapely.py:633-686)."""
    intersection = _pt(intersection)
    if _edge_length(edge) * cell_edge_length <= search_max_length:
        return slice_from_whole_edge(ring, boundary, edge, all_intersections,
                                     epsilon, cell_edge_length, min_edge_length,
                                     max_edge_length, search_max_length,
                                     search_max_area, search_min_area)
    snapped = ops.snap_geometry(Geometry(POLY, ring), intersection[None, :],
                                distance + epsilon)
    ring = snapped.coords
    boundary = _boundary_edges(ring)
    edge_1 = (intersection, _pt(edge[0]))
    edge_2 = (intersection, _pt(edge[1]))
    if _edge_length(edge_1) >= _edge_length(edge_2):
        return slice_polygon_from_half_or_part_edge(
            ring, boundary, edge_1, intersection, _pt(edge[0]),
            all_intersections, epsilon, cell_edge_length, min_edge_length,
            max_edge_length, search_max_length, search_max_area, search_min_area)
    return slice_polygon_from_half_or_part_edge(
        ring, boundary, edge_2, intersection, _pt(edge[1]),
        all_intersections, epsilon, cell_edge_length, min_edge_length,
        max_edge_length, search_max_length, search_max_area, search_min_area)


def slice_polygon_from_corner(ring: np.ndarray, boundary: Sequence[Edge],
                              corner, edge_1: Edge, p_1, edge_2: Edge, p_2,
                              all_intersections: np.ndarray, epsilon: float,
                              cell_edge_length: float, min_edge_length: float,
                              max_edge_length: float, search_max_length: float,
                              search_max_area: float, search_min_area: float
                              ) -> np.ndarray:
    """Entry: intersection sits at a polygon corner
    (reference shapely.py:689-759)."""
    corner, p_1, p_2 = _pt(corner), _pt(p_1), _pt(p_2)
    if check_interval_angle(ring, corner, p_1, p_2, epsilon) == 'convex':
        s1, whole1 = slice_edge(edge_1, corner, all_intersections, epsilon,
                                cell_edge_length, min_edge_length,
                                max_edge_length, search_max_length)
        s2, whole2 = slice_edge(edge_2, corner, all_intersections, epsilon,
                                cell_edge_length, min_edge_length,
                                max_edge_length, search_max_length)
        if not whole1 and not whole2:
            common_min = search_max_length - max_edge_length
            thres_distance = common_min / cell_edge_length
            return slice_from_angle_rect_tri(s1, s2, corner, _pt(s1[1]),
                                             _pt(s2[1]), epsilon, thres_distance)
        if whole1:
            return slice_from_l_shape(ring, boundary, s1, s2, corner, p_1,
                                      _pt(s2[1]), all_intersections, epsilon,
                                      cell_edge_length, min_edge_length,
                                      max_edge_length, search_max_length,
                                      search_max_area, search_min_area)
        return slice_from_l_shape(ring, boundary, s2, s1, corner, p_2,
                                  _pt(s1[1]), all_intersections, epsilon,
                                  cell_edge_length, min_edge_length,
                                  max_edge_length, search_max_length,
                                  search_max_area, search_min_area)
    if _edge_length(edge_1) >= _edge_length(edge_2):
        return slice_polygon_from_half_or_part_edge(
            ring, boundary, edge_1, corner, p_1, all_intersections, epsilon,
            cell_edge_length, min_edge_length, max_edge_length,
            search_max_length, search_max_area, search_min_area)
    return slice_polygon_from_half_or_part_edge(
        ring, boundary, edge_2, corner, p_2, all_intersections, epsilon,
        cell_edge_length, min_edge_length, max_edge_length,
        search_max_length, search_max_area, search_min_area)


def get_intersection_polygon_with_maximum_area(cutter: np.ndarray,
                                               ring: np.ndarray) -> Geometry:
    """Intersect the convex cutter with the block; keep the largest piece
    (reference shapely.py:762-785)."""
    pieces = ops.clip_polygon_convex(ring, cutter)
    if not pieces:
        raise SliceError('Sliced polygon is not a polygon.')
    best = max(pieces, key=ops.ring_area)
    return Geometry(POLY, ops.ensure_ccw(best))


# ---------------------------------------------------------------------------
# top-level entry, mirroring PlanClient._simplify_polygon/_slice_polygon
# ---------------------------------------------------------------------------

def simplify_and_classify(polygon: Geometry, intersection, epsilon: float,
                          deg_tol: float = 1.0):
    """Simplify the block and classify the chosen intersection as edge/corner
    (reference: urban_planning/envs/plan_client.py:361-402)."""
    intersection = _pt(intersection)
    ring = ops.simplify_ring_by_angle(polygon.canonicalize().coords, deg_tol)
    boundary = _boundary_edges(ring)
    vert_dist = np.linalg.norm(ring - intersection, axis=1)
    if vert_dist.min() > epsilon:
        a = np.asarray([e[0] for e in boundary])
        b = np.asarray([e[1] for e in boundary])
        d = ops.point_segment_distance(intersection, a, b)
        distance = float(d.min())
        near = d < distance + epsilon
        if int(near.sum()) > 1:
            raise SliceError('Intersection within edge is near two edges.')
        idx = int(np.argmax(near))
        return ring, boundary, 'edge', [boundary[idx]], distance
    # corner case
    a = np.asarray([e[0] for e in boundary])
    b = np.asarray([e[1] for e in boundary])
    d = ops.point_segment_distance(intersection, a, b)
    touching = [boundary[i] for i in range(len(boundary)) if d[i] <= ops.EPS * 10]
    if len(touching) != 2:
        raise SliceError('The corner intersection must intersect with two edges.')
    return ring, boundary, 'corner', touching, 0.0


def slice_polygon(polygon: Geometry, intersection, all_intersections: np.ndarray,
                  cell_edge_length: float, min_edge_length: float,
                  max_edge_length: float, search_max_length: float,
                  search_max_area: float, search_min_area: float,
                  epsilon: float = 1e-4, deg_tol: float = 1.0) -> Geometry:
    """Slice a parcel for one land use out of a feasible block
    (reference: urban_planning/envs/plan_client.py:404-443)."""
    intersection = _pt(intersection)
    ring, boundary, relation, edges, distance = simplify_and_classify(
        polygon, intersection, epsilon, deg_tol)
    if relation == 'edge':
        edge = edges[0]
        cutter = slice_polygon_from_edge(
            ring, boundary, edge, intersection, all_intersections, distance,
            epsilon, cell_edge_length, min_edge_length, max_edge_length,
            search_max_length, search_max_area, search_min_area)
    else:
        e1, e2 = edges
        p_1 = _other_endpoint(e1, intersection)
        p_2 = _other_endpoint(e2, intersection)
        cutter = slice_polygon_from_corner(
            ring, boundary, intersection, (intersection, p_1), p_1,
            (intersection, p_2), p_2, all_intersections, epsilon,
            cell_edge_length, min_edge_length, max_edge_length,
            search_max_length, search_max_area, search_min_area)
    return get_intersection_polygon_with_maximum_area(cutter, ring)
