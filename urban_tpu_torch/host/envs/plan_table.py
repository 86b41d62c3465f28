"""Columnar plan state with per-feature shape metrics.

GeoTable is the framework's replacement for the reference's GeoDataFrame plan
state (columns id/type/existence/geometry/rect/eqi/sc, reference:
urban_planning/envs/plan_client.py:127-131, misc/init_plan.py:46-52), backed
by numpy column arrays and a parallel list of Geometry objects. Rows are
append-only; removal flips ``existence`` (exactly like the reference).
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np

from urban_tpu_torch.host.geometry.base import Geometry, POINT, LINE, POLY
from urban_tpu_torch.host.geometry.metrics import shape_metrics
from urban_tpu_torch.host.io.refpickle import PlanTable


class GeoTable:

    __slots__ = ('ids', 'types', 'existence', 'geoms', 'rect', 'eqi', 'sc')

    def __init__(self, ids, types, existence, geoms,
                 rect=None, eqi=None, sc=None):
        n = len(ids)
        self.ids = np.asarray(ids, dtype=np.int64)
        self.types = np.asarray(types, dtype=np.int32)
        self.existence = np.asarray(existence, dtype=bool)
        self.geoms: List[Geometry] = list(geoms)
        self.rect = np.full(n, np.nan) if rect is None else np.asarray(rect, dtype=np.float64)
        self.eqi = np.full(n, np.nan) if eqi is None else np.asarray(eqi, dtype=np.float64)
        self.sc = np.full(n, np.nan) if sc is None else np.asarray(sc, dtype=np.float64)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_plan_table(cls, table: PlanTable) -> 'GeoTable':
        out = cls(table.ids, table.types, table.existence, table.geoms)
        out.compute_domain_features()
        return out

    def copy(self) -> 'GeoTable':
        return GeoTable(self.ids.copy(), self.types.copy(), self.existence.copy(),
                        list(self.geoms), self.rect.copy(), self.eqi.copy(),
                        self.sc.copy())

    def __len__(self) -> int:
        return len(self.ids)

    # -- mutation -----------------------------------------------------------
    def append(self, feature_id: int, ftype: int, geom: Geometry,
               with_metrics: bool = False) -> int:
        """Append a row; returns its positional index."""
        self.ids = np.append(self.ids, np.int64(feature_id))
        self.types = np.append(self.types, np.int32(ftype))
        self.existence = np.append(self.existence, True)
        self.geoms.append(geom)
        if with_metrics and geom.is_poly:
            rect, eqi, sc = shape_metrics(geom)
        else:
            rect = eqi = sc = math.nan
        self.rect = np.append(self.rect, rect)
        self.eqi = np.append(self.eqi, eqi)
        self.sc = np.append(self.sc, sc)
        return len(self.ids) - 1

    def kill(self, row: int) -> None:
        self.existence[row] = False

    def compute_domain_features(self) -> None:
        """(Re)compute rect/eqi/sc for every polygon row
        (reference: plan_client.py:127-131)."""
        for i, g in enumerate(self.geoms):
            if g.is_poly:
                self.rect[i], self.eqi[i], self.sc[i] = shape_metrics(g)
            else:
                self.rect[i] = self.eqi[i] = self.sc[i] = math.nan

    # -- lookup -------------------------------------------------------------
    def row_of_id(self, feature_id: int) -> int:
        rows = np.nonzero(self.ids == feature_id)[0]
        if len(rows) == 0:
            raise KeyError(f'No feature with id {feature_id}.')
        return int(rows[-1])

    def alive_rows(self) -> np.ndarray:
        return np.nonzero(self.existence)[0]

    def kinds(self) -> np.ndarray:
        return np.array([g.kind for g in self.geoms], dtype=np.int8)

    # -- derived quantities over alive rows ---------------------------------
    def alive_mask_of(self, *types: int) -> np.ndarray:
        m = np.isin(self.types, list(types)) & self.existence
        return m

    def total_area(self, *types: int) -> float:
        rows = np.nonzero(self.alive_mask_of(*types))[0]
        return float(sum(self.geoms[i].area for i in rows))

    def count(self, *types: int) -> int:
        return int(self.alive_mask_of(*types).sum())

    def to_plan_table(self) -> PlanTable:
        return PlanTable(ids=self.ids.copy(), types=self.types.copy(),
                         existence=self.existence.copy(), geoms=list(self.geoms))
