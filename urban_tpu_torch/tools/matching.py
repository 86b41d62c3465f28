"""How an action of the host oracle maps to a slot action of the batched
environment, and back, by feature geometry: a land-use action by its
feasible block's centroid and its intersection's coordinates, a road
action by its segment's midpoint (counterpart of the helpers of
tests/test_lockstep_episode.py, tools/divergence.py and
tools/replay_failures.py). Features match within TOL grid units; where
several do, the first index wins."""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from urban_tpu_torch.host import city_config
from urban_tpu_torch.torchenv import geometry as tg
from urban_tpu_torch.torchenv.step import land_use_mask

TOL = 2.0   # grid units


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def host_action_identity(plc, action):
    """(feasible block centroid, intersection xy) of host land-use action
    `action` (an edge of the host's current graph)."""
    rows, edges = plc._get_current_gdf_and_graph()
    i, j = edges[action]
    ri, rj = rows[i], rows[j]
    if plc._table.types[ri] != city_config.FEASIBLE:
        ri, rj = rj, ri
    return (plc._table.geoms[ri].centroid, plc._table.geoms[rj].coords[0])


def matching_edge(spec, state, centroid, inter_xy, t):
    """(slot edge, centroid error): the land-use mask's edge (for land use
    t) that joins the alive polygon nearest `centroid` with the alive
    intersection nearest `inter_xy`; the edge is None where the mask has
    no such edge."""
    cents = _np(vmap(tg.ring_centroid)(state.poly_ring, state.poly_nvert))
    alive = _np(state.poly_alive)
    d = np.linalg.norm(cents - centroid, axis=1)
    d[~alive] = 1e30
    pm = int(np.argmin(d))
    centroid_err = float(d[pm])
    dq = np.linalg.norm(_np(state.pt) - inter_xy, axis=1)
    dq[~_np(state.pt_alive)] = 1e30
    qm = int(np.argmin(dq))
    want = {pm, spec.NP + spec.NS + qm}
    edges = _np(state.edge)
    mask = _np(land_use_mask(spec, state, t))
    for e in np.nonzero(mask)[0]:
        if set(edges[e].tolist()) == want:
            return int(e), centroid_err
    return None, centroid_err


def host_road_midpoint(plc, action):
    """Midpoint of the boundary segment of host road action `action`."""
    rows, _ = plc._get_current_gdf_and_graph()
    g = plc._table.geoms[rows[action]]
    return 0.5 * (np.asarray(g.coords[0]) + np.asarray(g.coords[-1]))


def matching_road(spec, state, slot_mask, mid, tol=TOL):
    """Road action (node slot) of `slot_mask` whose segment midpoint is
    nearest `mid`, within tol; None where none is."""
    segs = _np(state.seg)
    mids = 0.5 * (segs[:, 0] + segs[:, 1])
    best, best_d = None, tol
    for i in np.nonzero(slot_mask)[0]:
        s = int(i) - spec.NP
        d = float(np.linalg.norm(mids[s] - mid))
        if d < best_d:
            best, best_d = int(i), d
    return best


def decode_slot_action(spec, state, action):
    """(stage, payload) of slot action `action` (2,) in the current state:
    land use -> (block centroid, intersection xy); road -> the segment's
    midpoint."""
    stage = int(state.stage)
    if stage == 0:
        e = _np(state.edge[int(action[0])])
        p = int(e[0] if e[0] < spec.NP else e[1])
        q = int((e[1] if e[0] < spec.NP else e[0]) - spec.NP - spec.NS)
        cent = _np(tg.ring_centroid(state.poly_ring[p], state.poly_nvert[p]))
        return 'land_use', (cent, _np(state.pt[q]))
    seg = _np(state.seg[int(action[1]) - spec.NP])
    return 'road', 0.5 * (seg[0] + seg[1])


def host_land_use_action(plc, mask, cent, ptxy, tol=TOL):
    """The host graph edge of `mask` whose feasible block centroid and
    intersection match (cent, ptxy) nearest, within tol; None where none
    does (the inverse of matching_edge)."""
    rows, edges = plc._get_current_gdf_and_graph()
    best, best_d = None, tol
    for a in np.nonzero(mask)[0]:
        i, j = edges[a]
        ri, rj = rows[i], rows[j]
        if plc._table.types[ri] != city_config.FEASIBLE:
            ri, rj = rj, ri
        d = (np.linalg.norm(plc._table.geoms[ri].centroid - cent)
             + np.linalg.norm(plc._table.geoms[rj].coords[0] - ptxy))
        if d < best_d:
            best, best_d = int(a), d
    return best


def host_road_action(plc, mask, mid, tol=TOL):
    """The host road action of `mask` whose segment midpoint is nearest
    `mid`, within tol; None where none is."""
    rows, _ = plc._get_current_gdf_and_graph()
    best, best_d = None, tol
    for a in np.nonzero(mask)[0]:
        g = plc._table.geoms[rows[a]]
        m = 0.5 * (np.asarray(g.coords[0]) + np.asarray(g.coords[-1]))
        d = np.linalg.norm(m - mid)
        if d < best_d:
            best, best_d = int(a), d
    return best
