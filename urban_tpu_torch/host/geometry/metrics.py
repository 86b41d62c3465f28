"""Shape metrics for plan features.

Implements the three momepy metrics the reference attaches to every polygon as
"domain knowledge" node features (reference: urban_planning/envs/
plan_client.py:127-131, 600-602):

  * rectangularity          = area / area(minimum rotated rectangle)
  * equivalent rectangular index
                            = sqrt(area / mrr_area) * (mrr_perimeter / perimeter)
  * square compactness      = (4 * sqrt(area) / perimeter)^2
"""
from __future__ import annotations

import math

import numpy as np

from urban_tpu_torch.host.geometry import ops
from urban_tpu_torch.host.geometry.base import Geometry


def _ring_perimeter(ring: np.ndarray) -> float:
    d = np.diff(np.vstack([ring, ring[:1]]), axis=0)
    return float(np.sqrt((d ** 2).sum(axis=1)).sum())


def shape_metrics(geom: Geometry) -> tuple:
    """Return (rectangularity, equivalent_rectangular_index, square_compactness).

    Non-polygons get NaN (the reference leaves NaN for lines/points and later
    fills 0.5, plan_client.py:794)."""
    if not geom.is_poly:
        return (math.nan, math.nan, math.nan)
    area = geom.area
    perimeter = geom.perimeter
    if area <= 0 or perimeter <= 0:
        return (math.nan, math.nan, math.nan)
    mrr = ops.min_rotated_rect(geom.coords)
    mrr_area = ops.ring_area(mrr)
    mrr_perimeter = _ring_perimeter(mrr)
    if mrr_area <= 0:
        return (math.nan, math.nan, math.nan)
    rect = area / mrr_area
    eqi = math.sqrt(area / mrr_area) * (mrr_perimeter / perimeter)
    sc = (4.0 * math.sqrt(area) / perimeter) ** 2
    return (rect, eqi, sc)
