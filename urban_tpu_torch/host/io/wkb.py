"""Minimal Well-Known-Binary (WKB) codec.

Parses the geometry payloads stored inside the reference scenario pickles
(geopandas GeometryArray serializes to WKB) without requiring shapely/GEOS.
Supports the geometry types that actually occur in the scenario data:
Point, LineString, Polygon, and their Multi* containers.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from urban_tpu_torch.host.geometry.base import Geometry, POINT, LINE, POLY

_POINT = 1
_LINESTRING = 2
_POLYGON = 3
_MULTIPOINT = 4
_MULTILINESTRING = 5
_MULTIPOLYGON = 6
_COLLECTION = 7

_Z_FLAG = 0x80000000
_ISO_Z = 1000


def _read_header(buf: bytes, off: int) -> Tuple[str, int, bool, int]:
    byte_order = buf[off]
    endian = '<' if byte_order == 1 else '>'
    (gtype,) = struct.unpack_from(endian + 'I', buf, off + 1)
    has_z = bool(gtype & _Z_FLAG) or (_ISO_Z <= (gtype & 0xFFFF) < 2 * _ISO_Z)
    gtype = (gtype & ~_Z_FLAG) % _ISO_Z
    return endian, gtype, has_z, off + 5


def _read_coords(buf: bytes, off: int, n: int, endian: str, has_z: bool):
    dims = 3 if has_z else 2
    arr = np.frombuffer(buf, dtype=np.dtype(endian + 'f8'), count=n * dims, offset=off)
    arr = arr.reshape(n, dims)[:, :2]
    return np.ascontiguousarray(arr, dtype=np.float64), off + n * dims * 8


def _parse_one(buf: bytes, off: int):
    """Parse one geometry starting at `off`; returns (list_of_Geometry, new_off).

    Multi* geometries are flattened into their parts.
    """
    endian, gtype, has_z, off = _read_header(buf, off)
    if gtype == _POINT:
        coords, off = _read_coords(buf, off, 1, endian, has_z)
        if np.all(np.isnan(coords)):
            return [], off  # empty point
        return [Geometry(POINT, coords)], off
    if gtype == _LINESTRING:
        (n,) = struct.unpack_from(endian + 'I', buf, off)
        coords, off = _read_coords(buf, off + 4, n, endian, has_z)
        if n == 0:
            return [], off
        return [Geometry(LINE, coords)], off
    if gtype == _POLYGON:
        (nrings,) = struct.unpack_from(endian + 'I', buf, off)
        off += 4
        rings = []
        for _ in range(nrings):
            (n,) = struct.unpack_from(endian + 'I', buf, off)
            coords, off = _read_coords(buf, off + 4, n, endian, has_z)
            rings.append(coords)
        if not rings:
            return [], off
        if len(rings) > 1:
            raise ValueError('Polygons with interior rings are not supported.')
        return [Geometry.polygon(rings[0])], off
    if gtype in (_MULTIPOINT, _MULTILINESTRING, _MULTIPOLYGON, _COLLECTION):
        (n,) = struct.unpack_from(endian + 'I', buf, off)
        off += 4
        out: List[Geometry] = []
        for _ in range(n):
            parts, off = _parse_one(buf, off)
            out.extend(parts)
        return out, off
    raise ValueError(f'Unsupported WKB geometry type {gtype}.')


def loads(buf: bytes) -> Geometry:
    """Parse a WKB buffer holding a single (non-multi) geometry."""
    parts, _ = _parse_one(buf, 0)
    if len(parts) != 1:
        raise ValueError(f'Expected a single geometry, got {len(parts)} parts.')
    return parts[0]


def loads_multi(buf: bytes) -> List[Geometry]:
    """Parse a WKB buffer, flattening Multi* containers into parts."""
    parts, _ = _parse_one(buf, 0)
    return parts


def dumps(geom: Geometry) -> bytes:
    """Serialize a Geometry to little-endian WKB."""
    if geom.kind == POINT:
        return struct.pack('<bI2d', 1, _POINT, *geom.coords[0])
    if geom.kind == LINE:
        n = geom.coords.shape[0]
        return struct.pack('<bII', 1, _LINESTRING, n) + geom.coords.astype('<f8').tobytes()
    ring = np.vstack([geom.coords, geom.coords[:1]])
    n = ring.shape[0]
    return (struct.pack('<bIII', 1, _POLYGON, 1, n)
            + ring.astype('<f8').tobytes())
