"""Lightweight 2-D geometry value types.

This framework runs in environments without shapely/GEOS, so it carries its own
minimal geometry types: numpy coordinate buffers with a `kind` tag. These are
the host-side (exact) representation; the jitted TPU environment uses padded
array buffers instead (see urban_tpu.jaxenv).

Conventions:
  * Polygon exterior rings are stored OPEN (no repeated closing vertex),
    oriented counter-clockwise (positive signed area), starting at the
    lexicographically smallest vertex. `canonicalize` enforces this, which
    plays the role of shapely's `normalize()` in the reference pipeline
    (reference: urban_planning/envs/plan_client.py:377,485).
  * Interior rings (holes) are not supported: the reference's plan geometry
    never produces them (parcels are sliced from block boundaries).
"""
from __future__ import annotations

import numpy as np

POINT = 0
LINE = 1
POLY = 2

_KIND_NAMES = {POINT: 'Point', LINE: 'LineString', POLY: 'Polygon'}


class Geometry:
    """A point, polyline, or polygon backed by an (N, 2) float64 array."""

    __slots__ = ('kind', 'coords')

    def __init__(self, kind: int, coords) -> None:
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, 2)
        if kind == POINT and coords.shape[0] != 1:
            raise ValueError('Point must have exactly one coordinate.')
        if kind == LINE and coords.shape[0] < 2:
            raise ValueError('LineString needs at least two coordinates.')
        if kind == POLY and coords.shape[0] < 3:
            raise ValueError('Polygon needs at least three vertices.')
        self.kind = kind
        self.coords = coords

    # -- constructors -------------------------------------------------------
    @staticmethod
    def point(x: float, y: float) -> 'Geometry':
        return Geometry(POINT, [[x, y]])

    @staticmethod
    def line(coords) -> 'Geometry':
        return Geometry(LINE, coords)

    @staticmethod
    def polygon(ring) -> 'Geometry':
        ring = np.asarray(ring, dtype=np.float64).reshape(-1, 2)
        if ring.shape[0] >= 2 and np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        return Geometry(POLY, ring)

    # -- basic measures -----------------------------------------------------
    @property
    def is_point(self) -> bool:
        return self.kind == POINT

    @property
    def is_line(self) -> bool:
        return self.kind == LINE

    @property
    def is_poly(self) -> bool:
        return self.kind == POLY

    def signed_area(self) -> float:
        if self.kind != POLY:
            return 0.0
        x, y = self.coords[:, 0], self.coords[:, 1]
        return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

    @property
    def area(self) -> float:
        return abs(self.signed_area())

    @property
    def length(self) -> float:
        if self.kind == POINT:
            return 0.0
        if self.kind == LINE:
            d = np.diff(self.coords, axis=0)
            return float(np.sqrt((d ** 2).sum(axis=1)).sum())
        ring = np.vstack([self.coords, self.coords[:1]])
        d = np.diff(ring, axis=0)
        return float(np.sqrt((d ** 2).sum(axis=1)).sum())

    @property
    def perimeter(self) -> float:
        return self.length

    @property
    def bounds(self) -> tuple:
        mn = self.coords.min(axis=0)
        mx = self.coords.max(axis=0)
        return (float(mn[0]), float(mn[1]), float(mx[0]), float(mx[1]))

    @property
    def centroid(self) -> np.ndarray:
        """Area centroid for polygons, length centroid for lines, the point itself."""
        c = self.coords
        if self.kind == POINT:
            return c[0].copy()
        if self.kind == LINE:
            seg = np.diff(c, axis=0)
            seg_len = np.sqrt((seg ** 2).sum(axis=1))
            total = seg_len.sum()
            if total <= 0:
                return c.mean(axis=0)
            mid = 0.5 * (c[:-1] + c[1:])
            return (mid * seg_len[:, None]).sum(axis=0) / total
        x, y = c[:, 0], c[:, 1]
        x1, y1 = np.roll(x, -1), np.roll(y, -1)
        cross = x * y1 - x1 * y
        a = cross.sum() / 2.0
        if abs(a) < 1e-12:
            return c.mean(axis=0)
        cx = ((x + x1) * cross).sum() / (6.0 * a)
        cy = ((y + y1) * cross).sum() / (6.0 * a)
        return np.array([cx, cy])

    # -- canonical form -----------------------------------------------------
    def canonicalize(self) -> 'Geometry':
        """Return a canonical-form copy (CCW ring, canonical start vertex)."""
        if self.kind != POLY:
            return self
        ring = self.coords
        if self.signed_area() < 0:
            ring = ring[::-1]
        start = np.lexsort((ring[:, 1], ring[:, 0]))[0]
        ring = np.roll(ring, -start, axis=0)
        return Geometry(POLY, ring)

    def ring_edges(self) -> np.ndarray:
        """Polygon boundary edges as an (N, 2, 2) array of segments."""
        if self.kind != POLY:
            raise ValueError('ring_edges only defined for polygons')
        c = self.coords
        return np.stack([c, np.roll(c, -1, axis=0)], axis=1)

    def __repr__(self) -> str:
        return f'{_KIND_NAMES[self.kind]}({self.coords.shape[0]} pts)'

    def __eq__(self, other) -> bool:
        if not isinstance(other, Geometry) or self.kind != other.kind:
            return False
        return self.coords.shape == other.coords.shape and np.allclose(
            self.coords, other.coords)

    def almost_equals(self, other: 'Geometry', tol: float = 1e-6) -> bool:
        if self.kind != other.kind:
            return False
        a = self.canonicalize().coords if self.kind == POLY else self.coords
        b = other.canonicalize().coords if other.kind == POLY else other.coords
        return a.shape == b.shape and bool(np.all(np.abs(a - b) <= tol))
