"""Loader for reference scenario pickles without geopandas/shapely installed.

The reference ships initial plans as pickled dicts
``{'gdf': GeoDataFrame, 'concept': [...], 'rule_constraints': bool}``
(schema: reference misc/init_plan.py:96-99, plan_client.py:139-143). Those
pickles reference geopandas/pandas/shapely classes that are not available in
this environment, so this module unpickles them with stub classes that capture
the raw constructor/``__setstate__`` payloads, then reassembles plain
column arrays and decodes geometry from the embedded WKB.

The result is a :class:`PlanTable` — the framework's replacement for the
reference's GeoDataFrame plan state.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from urban_tpu_torch.host.geometry.base import Geometry
from urban_tpu_torch.host.io import wkb


class _Stub:
    def __init__(self, *args, **kwargs):
        self._newargs = args
        self._state = None

    def __setstate__(self, state):
        self._state = state


class _RefUnpickler(pickle.Unpickler):
    """Unpickler that stubs out third-party classes and captures payloads.

    Only an explicit whitelist of callables resolves to the real thing —
    reference pickles are untrusted input, and passing through all of
    builtins/numpy would hand a crafted pickle builtins.eval/exec via the
    REDUCE opcode. Everything else becomes an inert _Stub subclass."""

    _SHAPELY_PREFIX = 'shapely.geometry'

    _ALLOWED = {
        ('builtins', 'list'), ('builtins', 'dict'), ('builtins', 'set'),
        ('builtins', 'tuple'), ('builtins', 'frozenset'),
        ('builtins', 'bytearray'), ('builtins', 'complex'),
        ('builtins', 'slice'), ('builtins', 'range'),
        ('numpy', 'ndarray'), ('numpy', 'dtype'),
        ('numpy', 'bool_'), ('numpy', 'int8'), ('numpy', 'int16'),
        ('numpy', 'int32'), ('numpy', 'int64'), ('numpy', 'uint8'),
        ('numpy', 'uint16'), ('numpy', 'uint32'), ('numpy', 'uint64'),
        ('numpy', 'float16'), ('numpy', 'float32'), ('numpy', 'float64'),
        ('numpy.core.multiarray', '_reconstruct'),
        ('numpy.core.multiarray', 'scalar'),
        ('numpy._core.multiarray', '_reconstruct'),
        ('numpy._core.multiarray', 'scalar'),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        key = f'{module}.{name}'
        if key == 'pandas._libs.internals._unpickle_block':
            def unpickle_block(values, placement, ndim):
                stub = _Stub()
                stub._reduced = ('block', (values, placement, ndim))
                return stub
            return unpickle_block
        if key == 'pandas.core.indexes.base._new_Index':
            def new_index(cls, d):
                stub = _Stub()
                stub._reduced = ('index', (cls, d))
                return stub
            return new_index
        return type(name, (_Stub,), {'_stub_key': key})


@dataclass
class PlanTable:
    """Columnar plan state: one row per plan feature.

    Mirrors the reference GeoDataFrame columns id/type/existence/geometry
    (reference misc/init_plan.py:46-52)."""

    ids: np.ndarray                    # int64 feature ids (the gdf index)
    types: np.ndarray                  # int32 land-use / feature type
    existence: np.ndarray              # bool
    geoms: List[Geometry]              # parsed geometry per row

    def __len__(self) -> int:
        return len(self.ids)

    def copy(self) -> 'PlanTable':
        return PlanTable(self.ids.copy(), self.types.copy(), self.existence.copy(),
                         list(self.geoms))


@dataclass
class RawScenario:
    """Initial plan payload decoded from a reference pickle."""

    plan: PlanTable
    concept: List[Dict] = field(default_factory=list)
    rule_constraints: bool = False


def _decode_stub_geometry(obj) -> Optional[Geometry]:
    """Decode a stubbed shapely geometry (its state is raw WKB bytes)."""
    state = getattr(obj, '_state', None)
    if isinstance(state, (bytes, bytearray)):
        return wkb.loads(bytes(state))
    args = getattr(obj, '_newargs', None)
    if args and isinstance(args[0], (bytes, bytearray)):
        return wkb.loads(bytes(args[0]))
    raise ValueError(f'Cannot decode geometry stub {type(obj).__name__}.')


def _index_values(index_stub) -> np.ndarray:
    kind, (cls, payload) = index_stub._reduced
    assert kind == 'index'
    return np.asarray(payload['data'])


def _decode_gdf(gdf_stub) -> PlanTable:
    state = gdf_stub._state
    mgr = state['_mgr']
    blocks, axes = mgr._newargs
    columns = _index_values(axes[0])
    ids = np.asarray(_index_values(axes[1]), dtype=np.int64)
    ncols = len(columns)
    nrows = len(ids)

    col_data: Dict[str, object] = {}
    for block in blocks:
        values, placement, ndim = block._reduced[1]
        if isinstance(placement, slice):
            col_idx = list(range(*placement.indices(ncols)))
        else:
            col_idx = list(np.asarray(placement).ravel())
        if isinstance(values, np.ndarray):
            for local, ci in enumerate(col_idx):
                col_data[str(columns[ci])] = values[local]
        else:
            # GeometryArray stub: state = (object ndarray of WKB bytes, crs)
            geom_state = values._state
            wkb_arr = geom_state[0] if isinstance(geom_state, tuple) else geom_state
            geoms = [wkb.loads(bytes(b)) if b is not None else None for b in wkb_arr]
            for ci in col_idx:
                col_data[str(columns[ci])] = geoms

    types = np.asarray(col_data['type'], dtype=np.int32).reshape(nrows)
    existence = np.asarray(col_data['existence'], dtype=bool).reshape(nrows)
    geoms = list(col_data['geometry'])
    assert len(geoms) == nrows
    return PlanTable(ids=ids, types=types, existence=existence, geoms=geoms)


def _decode_concept(concept_raw) -> List[Dict]:
    concept = []
    for entry in concept_raw:
        decoded = dict(entry)
        decoded['geometry'] = _decode_stub_geometry(entry['geometry'])
        concept.append(decoded)
    return concept


def load_reference_plan(path: str) -> RawScenario:
    """Load a reference ``init_plan_*.pickle`` into plain arrays."""
    with open(path, 'rb') as f:
        obj = _RefUnpickler(f).load()
    plan = _decode_gdf(obj['gdf'])
    concept = _decode_concept(obj.get('concept', []))
    rule_constraints = bool(obj.get('rule_constraints', False))
    return RawScenario(plan=plan, concept=concept, rule_constraints=rule_constraints)
