"""GeoJSON import/export of plans.

The reference publishes its final plans as GeoJSON FeatureCollections with
properties id/type/existence/rect/eqi/sc (reference: results/hlg.geojson,
results/dhm.geojson); this module round-trips that format against GeoTable so
published plans can be loaded, re-scored (env.load_plan + score_plan), and
our plans exported in the same shape.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np

from urban_tpu_torch.host.envs.plan_table import GeoTable
from urban_tpu_torch.host.geometry.base import Geometry, LINE, POINT, POLY


def _geom_to_geojson(g: Geometry) -> dict:
    if g.kind == POINT:
        return {'type': 'Point', 'coordinates': list(g.coords[0])}
    if g.kind == LINE:
        return {'type': 'LineString',
                'coordinates': [list(c) for c in g.coords]}
    ring = [list(c) for c in g.coords] + [list(g.coords[0])]
    return {'type': 'Polygon', 'coordinates': [ring]}


def _geom_from_geojson(d: dict) -> Geometry:
    t = d['type']
    if t == 'Point':
        return Geometry(POINT, np.asarray(d['coordinates'])[None, :])
    if t == 'LineString':
        return Geometry(LINE, np.asarray(d['coordinates']))
    if t == 'Polygon':
        rings = d['coordinates']
        if len(rings) > 1:
            raise ValueError('Polygons with holes are not supported.')
        return Geometry.polygon(np.asarray(rings[0]))
    raise ValueError(f'Unsupported GeoJSON geometry {t}.')


def table_to_geojson(table: GeoTable) -> dict:
    features = []
    for i in range(len(table)):
        def val(x):
            return None if (x is None or math.isnan(x)) else float(x)
        features.append({
            'type': 'Feature',
            'properties': {'id': int(table.ids[i]),
                           'type': int(table.types[i]),
                           'existence': bool(table.existence[i]),
                           'rect': val(table.rect[i]),
                           'eqi': val(table.eqi[i]),
                           'sc': val(table.sc[i])},
            'geometry': _geom_to_geojson(table.geoms[i]),
        })
    return {'type': 'FeatureCollection', 'features': features}


def table_from_geojson(d: dict) -> GeoTable:
    feats = d['features']
    n = len(feats)
    ids = np.zeros(n, dtype=np.int64)
    types = np.zeros(n, dtype=np.int32)
    existence = np.zeros(n, dtype=bool)
    rect = np.full(n, np.nan)
    eqi = np.full(n, np.nan)
    sc = np.full(n, np.nan)
    geoms = []
    for i, f in enumerate(feats):
        p = f['properties']
        ids[i] = p['id']
        types[i] = p['type']
        existence[i] = p['existence']
        for arr, key in ((rect, 'rect'), (eqi, 'eqi'), (sc, 'sc')):
            if p.get(key) is not None:
                arr[i] = p[key]
        geoms.append(_geom_from_geojson(f['geometry']))
    return GeoTable(ids, types, existence, geoms, rect, eqi, sc)


def save_geojson(table: GeoTable, path: str) -> None:
    with open(path, 'w') as f:
        json.dump(table_to_geojson(table), f)


def load_geojson(path: str) -> GeoTable:
    with open(path) as f:
        return table_from_geojson(json.load(f))
