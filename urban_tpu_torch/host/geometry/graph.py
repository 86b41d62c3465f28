"""Planar-graph utilities for road-network analysis.

Replaces the networkx/momepy graph machinery the reference uses for the road
reward (reference: urban_planning/envs/plan_client.py:777-887):

  * ``segment_graph``: quantized-endpoint node graph of road segments
    (momepy.gdf_to_nx, primal)
  * ``connected_components`` / node degrees
  * ``merge_false_nodes``: chain-merge degree-2 nodes (momepy.remove_false_nodes)
  * ``polygonize``: faces of the planar subdivision induced by segments
    (shapely.ops.polygonize) — used for block-size penalties
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

Coord = Tuple[float, float]


def _key(p, decimals: int = 6) -> Coord:
    return (round(float(p[0]), decimals), round(float(p[1]), decimals))


def segment_graph(segments: Sequence[np.ndarray]):
    """Build node/edge lists from 2-point (or polyline) segments.

    Returns (nodes: list of coords, edges: list of (i, j, length), adj)."""
    node_id: Dict[Coord, int] = {}
    nodes: List[Coord] = []
    edges: List[Tuple[int, int, float]] = []
    adj: Dict[int, List[int]] = defaultdict(list)

    def nid(p) -> int:
        k = _key(p)
        if k not in node_id:
            node_id[k] = len(nodes)
            nodes.append(k)
        return node_id[k]

    for seg in segments:
        seg = np.asarray(seg, dtype=np.float64)
        for i in range(len(seg) - 1):
            a, b = nid(seg[i]), nid(seg[i + 1])
            if a == b:
                continue
            length = float(np.linalg.norm(seg[i + 1] - seg[i]))
            eidx = len(edges)
            edges.append((a, b, length))
            adj[a].append(eidx)
            adj[b].append(eidx)
    return nodes, edges, adj


def connected_components(num_nodes: int, edges: Sequence[Tuple[int, int, float]]) -> int:
    """Number of connected components (union-find)."""
    parent = list(range(num_nodes))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    return len({find(i) for i in range(num_nodes)})


def node_degrees(num_nodes: int, edges: Sequence[Tuple[int, int, float]]) -> np.ndarray:
    deg = np.zeros(num_nodes, dtype=np.int32)
    for a, b, _ in edges:
        deg[a] += 1
        deg[b] += 1
    return deg


def merge_false_nodes(segments: Sequence[np.ndarray]) -> List[float]:
    """Merge chains through degree-2 nodes; return merged segment lengths.

    Mirrors momepy.remove_false_nodes as used for the short/long road
    penalties (reference: plan_client.py:858-864): consecutive road pieces
    that meet at a degree-2 intersection count as one road."""
    nodes, edges, adj = segment_graph(segments)
    deg = node_degrees(len(nodes), edges)
    visited = [False] * len(edges)
    lengths: List[float] = []

    def other(eidx: int, n: int) -> int:
        a, b, _ = edges[eidx]
        return b if a == n else a

    # walk chains starting from non-degree-2 endpoints
    for start in range(len(nodes)):
        if deg[start] == 2:
            continue
        for eidx in adj[start]:
            if visited[eidx]:
                continue
            total = 0.0
            cur_edge = eidx
            cur_node = start
            while True:
                visited[cur_edge] = True
                total += edges[cur_edge][2]
                nxt = other(cur_edge, cur_node)
                if deg[nxt] != 2:
                    break
                nxt_edges = [e for e in adj[nxt] if not visited[e]]
                if not nxt_edges:
                    break
                cur_edge = nxt_edges[0]
                cur_node = nxt
            lengths.append(total)
    # pure cycles of degree-2 nodes
    for eidx in range(len(edges)):
        if visited[eidx]:
            continue
        total = 0.0
        cur_edge = eidx
        cur_node = edges[eidx][0]
        while not visited[cur_edge]:
            visited[cur_edge] = True
            total += edges[cur_edge][2]
            nxt = other(cur_edge, cur_node)
            nxt_edges = [e for e in adj[nxt] if not visited[e]]
            if not nxt_edges:
                break
            cur_edge = nxt_edges[0]
            cur_node = nxt
        lengths.append(total)
    return lengths


def polygonize(segments: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Extract the bounded faces of the planar subdivision induced by segments.

    Standard angular-sweep face tracing on the planar graph: every undirected
    edge becomes two half-edges; from each unused half-edge, repeatedly take
    the most-clockwise outgoing half-edge at the head. CCW cycles (positive
    area) are the bounded faces (shapely.ops.polygonize equivalent, used for
    the large-block road penalty, reference plan_client.py:866-875)."""
    nodes, edges, adj = segment_graph(segments)
    nodes_arr = np.asarray(nodes, dtype=np.float64)

    # directed half-edges
    half: List[Tuple[int, int]] = []
    for a, b, _ in edges:
        half.append((a, b))
        half.append((b, a))

    out_edges: Dict[int, List[int]] = defaultdict(list)
    for h, (a, b) in enumerate(half):
        out_edges[a].append(h)

    def angle(h: int) -> float:
        a, b = half[h]
        d = nodes_arr[b] - nodes_arr[a]
        return float(np.arctan2(d[1], d[0]))

    for n in out_edges:
        out_edges[n].sort(key=angle)

    def next_half_edge(h: int) -> int:
        a, b = half[h]
        rev_angle = angle(h ^ 1)  # angle of b->a
        candidates = out_edges[b]
        # first outgoing edge strictly clockwise from the reversed edge
        angles = [angle(c) for c in candidates]
        idx = None
        best = None
        for c, ang in zip(candidates, angles):
            delta = (rev_angle - ang) % (2 * np.pi)
            if delta < 1e-12:
                delta = 2 * np.pi
            if best is None or delta < best:
                best = delta
                idx = c
        return idx

    used = [False] * len(half)
    faces: List[np.ndarray] = []
    for h0 in range(len(half)):
        if used[h0]:
            continue
        cycle = []
        h = h0
        while not used[h]:
            used[h] = True
            cycle.append(half[h][0])
            h = next_half_edge(h)
            if h is None:
                cycle = []
                break
        if len(cycle) >= 3:
            ring = nodes_arr[cycle]
            x, y = ring[:, 0], ring[:, 1]
            signed = 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
            if signed > 1e-9:
                faces.append(ring)
    return faces
